"""Host-side data of the eval path: full-resolution keys and provenance
(`fullres`) and the numpy target generators (`targets`)."""

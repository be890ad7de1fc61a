"""Marker types that the collate function keeps per sample (own copy of
nicr_mtsa_tpu/data/_types.py)."""


class CollateIgnoredDict(dict):
    """A dict the collate function keeps as a per-sample list."""


class PreprocessingParameterDict(CollateIgnoredDict):
    """Provenance parameters of one applied preprocessor."""


class AppliedPreprocessingMeta(list):
    """The ordered list of applied-preprocessor parameter dicts."""


class OrientationDict(CollateIgnoredDict):
    """{instance_id: orientation_rad} of one sample (instance ids are
    ragged across samples)."""

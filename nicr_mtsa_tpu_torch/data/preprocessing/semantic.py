"""Semantic label remapping (own copy of
nicr_mtsa_tpu/data/preprocessing/semantic.py): the listed class ids of
`sample['semantic']` become `new_label` in place, and the provenance
records how many pixels of each listed class present were remapped."""
from typing import Any, Dict, Tuple

import numpy as np

from .base import PreprocessingBase
from .utils import _keys_available


class SemanticClassMapper(PreprocessingBase):
    """Map the classes `classes_to_map` to `new_label`."""

    def __init__(self, classes_to_map: Tuple[int, ...], new_label: int = 0,
                 multiscale_processing: bool = True,
                 disable_stats: bool = False) -> None:
        self._source_classes = np.asarray(classes_to_map)
        self._target_label = new_label
        self._with_stats = not disable_stats
        super().__init__(
            fixed_parameters=dict(
                semantic_classes_to_map=self._source_classes,
                new_label=new_label, disable_stats=disable_stats),
            multiscale_processing=multiscale_processing)

    def _count_mapped(self, semantic: np.ndarray) -> Dict[int, int]:
        """Pixels of each listed class, for the classes present."""
        stats = {}
        for class_id in self._source_classes:
            n = int(np.count_nonzero(semantic == class_id))
            if n:
                stats[class_id] = n
        return stats

    def _preprocess(self, sample: dict, **kwargs
                    ) -> Tuple[dict, Dict[str, Any]]:
        if not _keys_available(sample, ('semantic',)):
            return sample, {}
        semantic = sample['semantic']
        dynamic = ({'mapped_pixels': self._count_mapped(semantic)}
                   if self._with_stats else {})
        semantic[np.isin(semantic, self._source_classes)] = \
            self._target_label
        return sample, dynamic

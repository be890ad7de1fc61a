"""Dense biternion orientation targets (own copy of
nicr_mtsa_tpu/data/preprocessing/orientation.py), on
data/targets.orientation_targets: a (cos, sin) image and a foreground
mask for every annotated instance whose majority class estimates an
orientation, and the dict of the orientations encoded."""
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from .._types import OrientationDict
from ..targets import orientation_targets
from .base import PreprocessingBase
from .utils import _keys_available


class OrientationTargetGenerator(PreprocessingBase):
    def __init__(self,
                 semantic_classes_estimate_orientation: Optional[
                     Sequence[bool]] = None,
                 multiscale_processing: bool = True) -> None:
        self._estimate = semantic_classes_estimate_orientation
        super().__init__(
            fixed_parameters={'semantic_classes': None if self._estimate
                              is None else np.flatnonzero(self._estimate)},
            multiscale_processing=multiscale_processing)

    def _preprocess(self, sample: dict, **kwargs
                    ) -> Tuple[dict, Dict[str, Any]]:
        if not _keys_available(sample, ('instance', 'orientations',
                                        'semantic')):
            return sample, {}
        targets = orientation_targets(sample['instance'], sample['semantic'],
                                      sample['orientations'], self._estimate)
        sample.update(targets.arrays)
        sample['orientations_present'] = OrientationDict(targets.present)
        return sample, {}

"""The last host-side step before the device (counterpart of
nicr_mtsa_tpu/data/preprocessing/device.py): depth gets its channel
axis (H, W) -> (H, W, 1), uint16 becomes int32 and uint32 int64
(exact ids on the device), and every array is made contiguous. The
layout stays channels last: the move to the device (`move_batch_to_
device`, the feeder) turns 4-D batch arrays NCHW."""
from typing import Any, Dict, Tuple

import numpy as np

from .base import PreprocessingBase
from .utils import _get_relevant_tensor_keys

# the 1-D entries that may reach the device
_VECTOR_KEYS = ('dense_visual_embedding_lut', 'image_embedding',
                'panoptic_segment_table', 'panoptic_segment_table_fullres',
                'panoptic_gt_angle_table', 'panoptic_gt_angle_table_valid')


class ToDeviceArrays(PreprocessingBase):
    def __init__(self, multiscale_processing: bool = True) -> None:
        super().__init__(multiscale_processing=multiscale_processing)

    def _preprocess(self, sample: dict, **kwargs
                    ) -> Tuple[dict, Dict[str, Any]]:
        for key in _get_relevant_tensor_keys(sample):
            value = sample[key]
            if value.ndim == 2:
                if key == 'depth':
                    value = value[..., np.newaxis]
            elif value.ndim not in (1, 3) or (value.ndim == 1
                                              and key not in _VECTOR_KEYS):
                raise ValueError(f"Cannot handle entry '{key}' with shape "
                                 f"'{value.shape}'")
            if value.dtype == np.uint16:
                value = value.astype('int32')
            if value.dtype == np.uint32:
                value = value.astype('int64')
            sample[key] = np.ascontiguousarray(value)
        return sample, {}

"""Key helpers of the preprocessors (own copy of
nicr_mtsa_tpu/data/preprocessing/utils.py)."""
from typing import Optional, Tuple, Union

import numpy as np

from .base import PreprocessingBase
from .clone import DEFAULT_CLONE_KEY


class KeyCleaner(PreprocessingBase):
    """Delete the `keys_to_clean` entries (and those of the
    sub-samples)."""

    def __init__(self, keys_to_clean: Tuple[str, ...],
                 multiscale_processing: bool = True, **kwargs) -> None:
        self._keys_to_clean = (keys_to_clean
                               if keys_to_clean is not None else [])
        super().__init__(
            fixed_parameters={'keys_to_clean': self._keys_to_clean},
            multiscale_processing=multiscale_processing)

    def _preprocess(self, sample, **kwargs):
        for key in self._keys_to_clean:
            sample.pop(key, None)
        return sample, {}


def _keys_available(sample: dict, keys) -> bool:
    return all(key in sample for key in keys)


def _get_input_shape(sample: dict):
    if 'rgb' in sample:
        h, w, _ = sample['rgb'].shape
    else:
        h, w = sample['depth'].shape[:2]
    return h, w


def _get_relevant_tensor_keys(
    sample: dict,
    keys_to_ignore: Union[Tuple[str, ...], None] = (DEFAULT_CLONE_KEY,),
    min_n_dim: Optional[int] = None,
):
    keys = []
    for key, value in sample.items():
        if keys_to_ignore is not None and key in keys_to_ignore:
            continue
        if not isinstance(value, np.ndarray):
            continue
        if min_n_dim is not None and value.ndim < min_n_dim:
            continue
        keys.append(key)
    return keys


def _get_relevant_spatial_keys(
    sample: dict,
    keys_to_ignore: Union[Tuple[str, ...], None] = (DEFAULT_CLONE_KEY,),
):
    return _get_relevant_tensor_keys(sample, keys_to_ignore, min_n_dim=2)

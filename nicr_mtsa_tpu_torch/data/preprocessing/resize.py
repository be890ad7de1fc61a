"""Resize, pad and the valid region (own copy of
nicr_mtsa_tpu/data/preprocessing/resize.py), on the native library
(native.py):

- nearest resize is an index gather (src = floor(dst * in / out), the
  cv2.INTER_NEAREST mapping), exact for any dtype;
- bilinear resize (`rgb` only, uint8) has half-pixel centres and edge
  clamping (cv2.INTER_LINEAR);
- `Resize` records `valid_region_slice_y/x` in the provenance, which
  postprocessing crops before the full-resolution resize.

The full-resolution readers (`get_fullres*`,
`get_valid_region_slices*`) live in data/fullres.py."""
from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np

from ... import native
from ..fullres import FULLRES_SUFFIX
from .base import PreprocessingBase
from .clone import FlatCloneEntries
from .utils import _get_input_shape, _get_relevant_spatial_keys


class FullResCloner(FlatCloneEntries):
    """Copies of the chosen entries under `<key>_fullres` before any
    resize (the eval path scores predictions against them)."""

    def __init__(self, keys_to_keep_fullres: Optional[Iterable[str]] = None,
                 ignore_missing_keys: bool = True) -> None:
        super().__init__(keys_to_clone=keys_to_keep_fullres,
                         key_suffix=FULLRES_SUFFIX, key_prefix='',
                         ignore_missing_keys=ignore_missing_keys)


def resize_image_nearest(value: np.ndarray, height: int,
                         width: int) -> np.ndarray:
    """Nearest resize of (H, W, ...), any dtype; a copy when the size
    is already right."""
    if value.shape[:2] == (height, width):
        return value.copy()
    return native.nearest_resize(value, height, width)


def resize_image_bilinear(value: np.ndarray, height: int,
                          width: int) -> np.ndarray:
    """Bilinear resize of uint8 (H, W[, C]); a copy when the size is
    already right."""
    if value.shape[:2] == (height, width):
        return value.copy()
    return native.bilinear_resize_u8(value, height, width)


def _resizable_keys(sample: dict,
                    keys_to_ignore: Optional[Iterable[str]]) -> list:
    """Spatial keys minus explicit ignores and *_fullres copies."""
    skip = list(keys_to_ignore or [])
    skip += [k for k in sample if k.endswith(FULLRES_SUFFIX)]
    return _get_relevant_spatial_keys(sample, keys_to_ignore=skip)


def resize(sample: dict, height: int, width: int,
           keys_to_ignore: Optional[Iterable[str]] = None) -> dict:
    """Every spatial entry resized: bilinear for `rgb`, nearest for the
    rest (depth, masks, labels)."""
    for key in _resizable_keys(sample, keys_to_ignore):
        kernel = resize_image_bilinear if key == 'rgb' \
            else resize_image_nearest
        sample[key] = kernel(sample[key], height, width)
    return sample


_PAD_MODES = {
    'zero': {'mode': 'constant', 'constant_values': 0},
    'reflect': {'mode': 'reflect'},
}


def pad(sample: dict, padding_top: int, padding_bottom: int,
        padding_left: int, padding_right: int, padding_mode: str = 'zero',
        keys_to_ignore: Optional[Iterable[str]] = None) -> dict:
    spatial = ((padding_top, padding_bottom), (padding_left, padding_right))
    np_kwargs = _PAD_MODES[padding_mode]
    for key in _resizable_keys(sample, keys_to_ignore):
        value = sample[key]
        if value.ndim not in (2, 3):
            raise ValueError(f"pad: entry '{key}' has shape {value.shape}, "
                             f"not (H, W[, C])")
        widths = spatial if value.ndim == 2 else (*spatial, (0, 0))
        sample[key] = np.pad(value, widths, **np_kwargs)
    return sample


class Resize(PreprocessingBase):
    """Every spatial entry to a fixed (height, width), with
    `keep_aspect_ratio` by a fitting resize and centred padding; the
    valid-region slices go into the provenance."""

    def __init__(self, height: int, width: int,
                 keys_to_ignore: Optional[Iterable[str]] = None,
                 keep_aspect_ratio: bool = False,
                 padding_mode: str = 'zero') -> None:
        if padding_mode not in _PAD_MODES:
            raise ValueError(f"unknown padding_mode: '{padding_mode}'")
        self._target_hw = (height, width)
        self._keep_aspect_ratio = keep_aspect_ratio
        self._padding_mode = padding_mode
        self._keys_to_ignore = keys_to_ignore
        super().__init__(
            multiscale_processing=False,
            fixed_parameters=dict(keys_to_ignore=keys_to_ignore,
                                  keep_aspect_ratio=keep_aspect_ratio,
                                  padding_mode=padding_mode))

    def _fit(self, orig_h: int, orig_w: int):
        """Content size and centred (top, bottom, left, right) padding."""
        th, tw = self._target_hw
        if not self._keep_aspect_ratio:
            return (th, tw), (0, 0, 0, 0)
        scale = min(th / orig_h, tw / orig_w)
        fit_h, fit_w = int(round(scale * orig_h)), int(round(scale * orig_w))
        slack_h, slack_w = th - fit_h, tw - fit_w
        return (fit_h, fit_w), (slack_h // 2, slack_h - slack_h // 2,
                                slack_w // 2, slack_w - slack_w // 2)

    def _preprocess(self, sample: dict, **kwargs
                    ) -> Tuple[dict, Dict[str, Any]]:
        orig_h, orig_w = _get_input_shape(sample)
        (fit_h, fit_w), (top, bottom, left, right) = self._fit(orig_h, orig_w)
        sample = resize(sample, height=fit_h, width=fit_w,
                        keys_to_ignore=self._keys_to_ignore)
        sample = pad(sample, padding_top=top, padding_bottom=bottom,
                     padding_left=left, padding_right=right,
                     padding_mode=self._padding_mode,
                     keys_to_ignore=self._keys_to_ignore)
        dynamic = dict(old_height=orig_h, old_width=orig_w)
        dynamic['new_height'], dynamic['new_width'] = self._target_hw
        dynamic['valid_region_slice_y'] = slice(top, top + fit_h)
        dynamic['valid_region_slice_x'] = slice(left, left + fit_w)
        return sample, dynamic

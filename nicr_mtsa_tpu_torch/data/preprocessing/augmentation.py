"""Augmentations of the training preprocessing (own copy of
nicr_mtsa_tpu/data/preprocessing/augmentation.py): horizontal flip,
random crop and HSV jitter, numpy in, numpy out.

Every draw comes from the `rng` (a `numpy.random.RandomState`) the
caller passes through `Compose(...)(sample, rng=rng)`; a transform
called without one raises. The draws are those of the JAX package's
classes on the global `np.random` stream, in the same order, so
`RandomState(s)` gives the JAX package's augmentation after
`np.random.seed(s)`. The HSV jitter runs on the native library
(`native.hsv_jitter_u8`; its plain version is
`native.hsv_jitter_u8_reference`)."""
from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np

from ... import native
from .base import PreprocessingBase, need_rng
from .resize import resize
from .utils import _get_input_shape, _get_relevant_spatial_keys


class RandomHorizontalFlip(PreprocessingBase):
    """Mirror every spatial entry with probability `p`, and the
    orientations as (2 pi - a) mod 2 pi; must run before
    `OrientationTargetGenerator`."""

    def __init__(self, p: float,
                 keys_to_ignore: Optional[Iterable[str]] = None) -> None:
        self._p = p
        self._keys_to_ignore = keys_to_ignore
        super().__init__(fixed_parameters={'p': self._p},
                         multiscale_processing=False)

    def _preprocess(self, sample: dict, rng=None, **kwargs
                    ) -> Tuple[dict, Dict[str, Any]]:
        if 'orientations_present' in sample:
            raise RuntimeError("Do not apply `RandomHorizontalFlip` after "
                               "`OrientationTargetGenerator`.")
        do_flip = need_rng(rng, 'RandomHorizontalFlip').uniform() <= self._p
        if do_flip:
            for key in _get_relevant_spatial_keys(
                    sample, keys_to_ignore=self._keys_to_ignore):
                sample[key] = np.flip(sample[key], axis=1)
            for id_, angle in sample.get('orientations', {}).items():
                sample['orientations'][id_] = \
                    (2 * np.pi - angle) % (2 * np.pi)
        return sample, {'was_flipped': do_flip}


class RandomCrop(PreprocessingBase):
    """A random (crop_height, crop_width) window of every spatial entry;
    a sample not larger than the window in an axis is first upscaled
    (to int(edge * scale + 0.5))."""

    def __init__(self, crop_height: int, crop_width: int,
                 keys_to_ignore: Optional[Iterable[str]] = None) -> None:
        self._crop_height = crop_height
        self._crop_width = crop_width
        self._keys_to_ignore = keys_to_ignore
        super().__init__(
            fixed_parameters={'crop_height': crop_height,
                              'crop_width': crop_width,
                              'keys_to_ignore': keys_to_ignore},
            multiscale_processing=False)

    def _preprocess(self, sample: dict, rng=None, **kwargs
                    ) -> Tuple[dict, Dict[str, Any]]:
        rng = need_rng(rng, 'RandomCrop')
        h, w = _get_input_shape(sample)
        scale = 1.0
        if h <= self._crop_height:
            scale = max(self._crop_height / h, scale)
        if w <= self._crop_width:
            scale = max(self._crop_width / w, scale)
        if scale > 1.0:
            h, w = int(h * scale + 0.5), int(w * scale + 0.5)
            sample = resize(sample, height=h, width=w,
                            keys_to_ignore=self._keys_to_ignore)
        y0 = rng.randint(0, h - self._crop_height) \
            if h - self._crop_height > 0 else 0
        x0 = rng.randint(0, w - self._crop_width) \
            if w - self._crop_width > 0 else 0
        slice_y = slice(y0, y0 + self._crop_height)
        slice_x = slice(x0, x0 + self._crop_width)
        for key in _get_relevant_spatial_keys(
                sample, keys_to_ignore=self._keys_to_ignore):
            sample[key] = sample[key][slice_y, slice_x, ...]
        return sample, {'was_resized': scale != 1.0, 'resize_height': h,
                        'resize_width': w, 'crop_slice_y': slice_y,
                        'crop_slice_x': slice_x}


class RandomHSVJitter(PreprocessingBase):
    """Additive jitter of uint8 `rgb` in OpenCV's uint8 HSV space by
    offsets drawn from the jitter limits (hue wraps modulo 180,
    saturation and value clip)."""

    def __init__(self, hue_jitter: float, saturation_jitter: float,
                 value_jitter: float) -> None:
        self._hue_limits = [int(-hue_jitter * (360 / 2)),
                            int(hue_jitter * (360 / 2))]
        self._saturation_limits = [int(-saturation_jitter * 255),
                                   int(saturation_jitter * 255)]
        self._value_limits = [int(-value_jitter * 255),
                              int(value_jitter * 255)]
        super().__init__(
            fixed_parameters={'hue_limits': self._hue_limits,
                              'saturation_limits': self._saturation_limits,
                              'value_limits': self._value_limits},
            multiscale_processing=False)

    def _preprocess(self, sample: dict, rng=None, **kwargs
                    ) -> Tuple[dict, Dict[str, Any]]:
        if 'rgb' not in sample:
            return sample, {}
        rng = need_rng(rng, 'RandomHSVJitter')
        img = sample['rgb']
        if img.dtype != np.uint8:
            raise TypeError(f'RandomHSVJitter takes uint8 rgb, got '
                            f'{img.dtype}')
        h = rng.randint(*self._hue_limits)
        s = rng.randint(*self._saturation_limits)
        v = rng.randint(*self._value_limits)
        sample['rgb'] = native.hsv_jitter_u8(img, h, s, v)
        return sample, {'applied_hue_offset': h,
                        'applied_saturation_offset': s,
                        'applied_value_offset': v}

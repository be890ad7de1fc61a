"""Input normalisation of RGB and depth (own copy of
nicr_mtsa_tpu/data/preprocessing/normalize.py). RGB takes the ImageNet
channel statistics scaled to [0, 255] inputs, on the native library;
depth takes dataset statistics (`NormalizeDepth`) or a per-sample
min/max rescale (`ScaleDepth`). Raw depth marks holes with a sentinel
value, which is restored after the transform."""
from typing import Any, Dict, Tuple

import numpy as np

from ... import native
from .base import PreprocessingBase

# ImageNet statistics scaled for uint8 [0, 255] inputs
RGB_MEAN = np.float32(255) * np.array((0.485, 0.456, 0.406), 'float32')
RGB_STD = np.float32(255) * np.array((0.229, 0.224, 0.225), 'float32')


def normalize(value, mean, std, dtype: str = 'float32',
              inplace: bool = False):
    """(value - mean) / std with channel statistics broadcast over H, W,
    in `dtype` (a copy unless `inplace` and no conversion)."""
    needs_cast = value.dtype != dtype
    work = value.astype(dtype, copy=True) if needs_cast else (
        value if inplace else value.copy())
    work -= mean[np.newaxis, np.newaxis, ...]
    work /= std[np.newaxis, np.newaxis, ...]
    return work


class _DepthHolePreserving(PreprocessingBase):
    """Base of the depth transforms that keep sentinel holes."""

    def __init__(self, raw_depth: bool, invalid_depth_value: float,
                 output_dtype: str, fixed_parameters: Dict[str, Any],
                 multiscale_processing: bool) -> None:
        self._raw_depth = raw_depth
        self._invalid_depth_value = invalid_depth_value
        self._output_dtype = output_dtype
        fixed_parameters.update(raw_depth=raw_depth,
                                invalid_depth_value=invalid_depth_value,
                                output_dtype=output_dtype)
        super().__init__(fixed_parameters=fixed_parameters,
                         multiscale_processing=multiscale_processing)

    def _transform_depth(self, depth: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def _preprocess(self, sample: dict, **kwargs
                    ) -> Tuple[dict, Dict[str, Any]]:
        depth = sample['depth']
        holes = (depth == self._invalid_depth_value) if self._raw_depth \
            else None
        depth = self._transform_depth(depth)
        if holes is not None:
            depth[holes] = self._invalid_depth_value
        sample['depth'] = depth
        return sample, {}


class NormalizeRGB(PreprocessingBase):
    """ImageNet-statistics normalisation of the uint8 RGB image to f32,
    on the native library."""

    def __init__(self, multiscale_processing: bool = False) -> None:
        super().__init__(
            fixed_parameters=dict(rgb_mean=RGB_MEAN.tolist(),
                                  rgb_std=RGB_STD.tolist(),
                                  output_dtype='float32'),
            multiscale_processing=multiscale_processing)

    def _preprocess(self, sample: dict, **kwargs
                    ) -> Tuple[dict, Dict[str, Any]]:
        sample['rgb'] = native.normalize_u8(sample['rgb'], RGB_MEAN, RGB_STD)
        return sample, {}


class NormalizeDepth(_DepthHolePreserving):
    """Dataset mean/std normalisation of the depth image."""

    def __init__(self, depth_mean: float, depth_std: float,
                 raw_depth: bool = False, invalid_depth_value: float = 0.0,
                 output_dtype: str = 'float32',
                 multiscale_processing: bool = False) -> None:
        if depth_std == 0.0:
            raise ValueError('depth_std must be non-zero')
        self._depth_mean = np.array(depth_mean, dtype=output_dtype)
        self._depth_std = np.array(depth_std, dtype=output_dtype)
        super().__init__(
            raw_depth, invalid_depth_value, output_dtype,
            dict(depth_mean=self._depth_mean.tolist(),
                 depth_std=self._depth_std.tolist()),
            multiscale_processing)

    def _transform_depth(self, depth: np.ndarray) -> np.ndarray:
        return normalize(depth, self._depth_mean, self._depth_std,
                         dtype=self._output_dtype)


class ScaleDepth(_DepthHolePreserving):
    """Per-sample min/max rescale of depth to [new_min, new_max]."""

    def __init__(self, new_min: float = 0.0, new_max: float = 1.0,
                 raw_depth: bool = False, invalid_depth_value: float = 0.0,
                 output_dtype: str = 'float32',
                 multiscale_processing: bool = False) -> None:
        self._out_range = (new_min, new_max)
        super().__init__(raw_depth, invalid_depth_value, output_dtype,
                         dict(new_min=new_min, new_max=new_max),
                         multiscale_processing)

    def _transform_depth(self, depth: np.ndarray) -> np.ndarray:
        if depth.dtype != self._output_dtype:
            depth = depth.astype(self._output_dtype, copy=True)
        lo, hi = self._out_range
        unit = (depth - depth.min()) / (depth.max() - depth.min())
        return unit * (hi - lo) + lo

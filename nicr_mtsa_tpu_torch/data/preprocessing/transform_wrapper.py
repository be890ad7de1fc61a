"""Joint spatial transform of a sample (own copy of
nicr_mtsa_tpu/data/preprocessing/transform_wrapper.py): every spatial
entry (an array of two or more dimensions) is stacked channel-wise in
float32, one user callable maps the numpy (H, W, C) stack to (H', W',
C), so a random transform moves every modality and label alike, and
the stack is split back with each entry's dtype restored (integers and
booleans rounded). A final five- or ten-crop adds a leading crop axis
to every spatial entry; the collate, `ToDeviceArrays` and the eval step
take no such axis (neither do the JAX package's).

Only geometry-preserving or nearest-gather transforms keep labels
intact: the float detour is exact for integers below 2^24."""
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from .base import PreprocessingBase
from .utils import _get_relevant_spatial_keys


def five_crop(stack: np.ndarray, crop_h: int, crop_w: int) -> np.ndarray:
    """(H, W, C) -> (5, crop_h, crop_w, C): the four corners, then the
    centre."""
    h, w = stack.shape[:2]
    if crop_h > h or crop_w > w:
        raise ValueError(f'a {crop_h} x {crop_w} crop of a {h} x {w} '
                         f'image')
    cy, cx = (h - crop_h) // 2, (w - crop_w) // 2
    return np.stack([stack[:crop_h, :crop_w], stack[:crop_h, w - crop_w:],
                     stack[h - crop_h:, :crop_w],
                     stack[h - crop_h:, w - crop_w:],
                     stack[cy:cy + crop_h, cx:cx + crop_w]])


def ten_crop(stack: np.ndarray, crop_h: int, crop_w: int) -> np.ndarray:
    """The five crops of the image, then those of its horizontal flip:
    (10, crop_h, crop_w, C)."""
    return np.concatenate([five_crop(stack, crop_h, crop_w),
                           five_crop(stack[:, ::-1], crop_h, crop_w)])


class TransformWrapper(PreprocessingBase):
    def __init__(self, transform: Callable[[np.ndarray], np.ndarray],
                 final_crop: Optional[Tuple[str, int, int]] = None,
                 keys_to_ignore: Optional[Tuple[str, ...]] = None) -> None:
        """`transform` maps a float32 (H, W, C) numpy stack to (H', W',
        C); `final_crop` = ('five' | 'ten', crop_h, crop_w) ends with
        that multi-crop."""
        self._transform = transform
        self._final_crop = final_crop
        self._keys_to_ignore = keys_to_ignore
        super().__init__(fixed_parameters={'final_crop': final_crop},
                         multiscale_processing=False)

    def _preprocess(self, sample: dict, **kwargs
                    ) -> Tuple[dict, Dict[str, Any]]:
        keys = _get_relevant_spatial_keys(
            sample, keys_to_ignore=self._keys_to_ignore)
        parts: List[np.ndarray] = []
        layout = []                    # (key, channels, dtype, ndim)
        for key in keys:
            value = sample[key]
            arr = value[..., None] if value.ndim == 2 else value
            layout.append((key, arr.shape[-1], value.dtype, value.ndim))
            parts.append(arr.astype(np.float32))
        stack = np.asarray(self._transform(np.concatenate(parts, axis=-1)))
        if self._final_crop is not None:
            kind, ch, cw = self._final_crop
            stack = (five_crop if kind == 'five' else ten_crop)(stack, ch,
                                                                cw)
        offset = 0
        for key, n_ch, dtype, ndim in layout:
            part = stack[..., offset:offset + n_ch]
            offset += n_ch
            if ndim == 2:
                part = part[..., 0]
            if np.issubdtype(dtype, np.integer) or dtype == bool:
                part = np.round(part)
            sample[key] = part.astype(dtype)
        return sample, {}

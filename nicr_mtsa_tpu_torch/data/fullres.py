"""Full-resolution keys and the Resize provenance of samples and
batches (own copy of the readers in
nicr_mtsa_tpu/data/preprocessing/resize.py:29-71).

The eval path compares predictions with ground truth at the original
resolution: `<key>_fullres` entries hold it, and the provenance meta
`_applied_preprocessing` records the valid region that the Resize
step kept, which postprocessing crops before resizing to full
resolution. Host samples and batches hold numpy arrays, channels last
((H, W), (H, W, C), (B, H, W), (B, H, W, C)); the port's device
batches hold tensors: maps (B, H, W) and dense images (B, C, H, W)."""
from typing import Any, Tuple

import numpy as np

APPLIED_PREPROCESSING_KEY = '_applied_preprocessing'
FULLRES_SUFFIX = '_fullres'


def get_fullres_key(key: str) -> str:
    return key + FULLRES_SUFFIX


def get_fullres(batch: dict, key: str) -> Any:
    return batch.get(get_fullres_key(key), None)


def get_fullres_shape(batch: dict, key: str) -> Tuple[int, int]:
    """(H, W) of the full-resolution `key` (else of rgb or depth)."""
    for k in (key, 'rgb', 'depth'):
        t = get_fullres(batch, k)
        if t is None:
            continue
        if not isinstance(t, np.ndarray):
            return tuple(t.shape[1:3] if t.ndim == 3 else t.shape[2:4])
        if t.ndim == 2:
            return tuple(t.shape)
        if t.ndim == 3:
            # HWC or NHW: channels are few (<= 4)
            return tuple(t.shape[:2] if t.shape[-1] <= 4 else t.shape[1:3])
        return tuple(t.shape[1:3])
    raise ValueError(f'Unable to get fullres shape for `{key}`.')


def _resize_entries(batch: dict):
    meta = batch.get(APPLIED_PREPROCESSING_KEY, ())
    # all samples of a batch share the original resolution: the first
    # sample's entries stand for the batch
    entries = meta[0] if (len(meta) and isinstance(meta[0], list)) else meta
    return [e for e in entries if e.get('type', None) == 'Resize']


def has_valid_region(batch: dict) -> bool:
    """Whether the batch records a Resize, i.e. has full-resolution
    outputs to produce."""
    return bool(_resize_entries(batch))


def get_valid_region_slices(batch: dict) -> Tuple[slice, slice]:
    entries = _resize_entries(batch)
    if not entries:
        raise ValueError('Unable to get valid region slices.')
    return (entries[0]['valid_region_slice_y'],
            entries[0]['valid_region_slice_x'])


def get_valid_region_slices_and_fullres_shape(batch: dict, key: str):
    return get_valid_region_slices(batch), get_fullres_shape(batch, key)


def resize_provenance(height: int, width: int) -> dict:
    """The static batch entry of a plain Resize whose valid region is
    the whole (height, width) working image."""
    return {APPLIED_PREPROCESSING_KEY: [[{
        'type': 'Resize', 'valid_region_slice_y': slice(0, height),
        'valid_region_slice_x': slice(0, width)}]]}


def nearest_indices(n_src: int, n_dst: int) -> np.ndarray:
    """Source index of each destination index of a nearest resize:
    floor(i * src / dst), the cv2.INTER_NEAREST mapping of the host
    preprocessing (resize.py:88-91)."""
    idx = np.floor(np.arange(n_dst) * (n_src / n_dst)).astype(np.int64)
    return np.clip(idx, 0, n_src - 1)

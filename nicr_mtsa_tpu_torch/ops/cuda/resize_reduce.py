"""Crop + half-pixel bilinear resize + first argmax / max-softmax score
(counterpart of nicr_mtsa_tpu/ops/pallas/resize_reduce.py
`crop_resize_argmax_score`): the full-resolution semantic idx/score of
working-resolution logits, without the resized logits ever existing.

On the card the work is done by csrc/resize_reduce.cu; on CPU tensors
the wrapper runs the plain version, `crop_resize_argmax_score_reference`
= semantic_score_idx(resize_bilinear(crop(x).float(), h, w)). Both use
the host tap tables of models/upsampling.py `two_tap_params` and the
same rounding steps, so their argmax is bit-identical. Inputs are
NCHW with any strides; the kernel's strip, band and ring geometry is
`rr_plan`."""
import ctypes
import functools
from typing import Callable, Dict, NamedTuple, Tuple

import numpy as np
import torch

from ...models.upsampling import resize_bilinear, two_tap_params
from ..reduce import semantic_score_idx
from ._build import check, is_cuda_tensor, load_library, refuse_grad

_FUNCS = {torch.float32: 'resize_reduce_f32',
          torch.bfloat16: 'resize_reduce_bf16'}
_TABLES: Dict[Tuple, Tuple[torch.Tensor, ...]] = {}
MAX_SMEM = 227 * 1024            # dynamic shared memory a block can take
# (strip_w, group_rows) in the order tried: a pixel a thread, the
# widest strip first (measured at the eval call: 256 x 1 beat 128 x 2,
# 64 x 4 and 32 x 8), then narrower strips and fewer rows where the
# ring does not fit
STRIP_GROUPS = ((256, 1), (128, 2), (64, 4), (32, 8)) + tuple(
    (w, g) for w in (32, 16, 8, 4, 2, 1) for g in (4, 2, 1))


class RrPlan(NamedTuple):
    """The kernel's geometry: block (strip, band, image) computes output
    columns [strip strip_w, + strip_w) and rows [band band_groups
    group_rows, + band_groups group_rows), group_rows rows at a time;
    crop row r of the strip sits in ring slot r % ring_rows of
    slot_elems values (all classes of the strip's input columns)."""
    strip_w: int
    group_rows: int
    band_groups: int
    ring_rows: int
    slot_elems: int
    strips: int
    bands: int
    smem: int


def rr_plan(B: int, C: int, in_h: int, out_h: int, in_w: int, out_w: int,
            elt: int, n_sm: int,
            blocks_per_sm: Callable[[int], int]) -> RrPlan:
    """The geometry for B images of C classes, `elt` bytes a value:
    - the first (strip_w, group_rows) of STRIP_GROUPS with a strip
      narrower than twice out_w whose ring fits MAX_SMEM: a slot holds
      the widest strip's input columns, and the ring every two
      consecutive groups' crop rows (a group computes while the next
      one's rows arrive);
    - bands: as many as keep B x strips x bands blocks within one wave
      of `blocks_per_sm(smem)` blocks on each of `n_sm` SMs."""
    lo_h, hi_h, _, _ = two_tap_params(in_h, out_h)
    lo_w, hi_w, _, _ = two_tap_params(in_w, out_w)
    per16 = 16 // elt
    fits = [sg for sg in STRIP_GROUPS if sg[0] < 2 * out_w]
    for strip_w, group in fits:
        first = np.arange(0, out_w, strip_w)
        last = np.minimum(first + strip_w, out_w) - 1
        slot = int((hi_w[last] - lo_w[first] + 1).max()) * C
        slot = -(-slot // per16) * per16
        start = np.arange(0, out_h, group)
        end = np.minimum(start + 2 * group, out_h) - 1
        ring = int((hi_h[end] - lo_h[start] + 1).max())
        smem = ring * slot * elt
        if smem <= MAX_SMEM:
            break
    else:
        raise ValueError(f'crop_resize_argmax_score: {C} classes of a '
                         f'{in_h} x {in_w} -> {out_h} x {out_w} resize '
                         f'do not fit the kernel\'s shared memory')
    strips = len(first)
    groups = -(-out_h // group)
    wave = n_sm * max(1, blocks_per_sm(smem))
    bands = max(1, min(groups, wave // (B * strips)))
    band_groups = -(-groups // bands)
    return RrPlan(strip_w, group, band_groups, ring, slot, strips,
                  -(-groups // band_groups), smem)


def _crop_box(shape, crop_slices):
    """(y0, x0, in_h, in_w) of unit-step crop slices of (.., H, W)."""
    H, W = shape[-2:]
    y0, y1, ys = crop_slices[0].indices(H)
    x0, x1, xs = crop_slices[1].indices(W)
    if ys != 1 or xs != 1 or y1 <= y0 or x1 <= x0:
        raise ValueError(f'crop_resize_argmax_score needs non-empty '
                         f'unit-step crop slices, got {crop_slices}')
    return y0, x0, y1 - y0, x1 - x0


def crop_resize_argmax_score_reference(x, crop_slices, out_h: int,
                                       out_w: int):
    """Plain PyTorch version: (idx int32, score f32), (B, out_h, out_w)."""
    y0, x0, in_h, in_w = _crop_box(x.shape, crop_slices)
    cropped = x[:, :, y0:y0 + in_h, x0:x0 + in_w].float()
    return semantic_score_idx(resize_bilinear(cropped, out_h, out_w), dim=1)


def _tables(in_h, out_h, in_w, out_w, device):
    """Device copies of the tap tables, made once per shape/device (a
    copy per call would synchronise the host with the card), outside
    inference mode (a cache must not hold a step's inference tensors)."""
    key = (in_h, out_h, in_w, out_w, str(device))
    if key not in _TABLES:
        ts = []
        with torch.inference_mode(False):
            for n, m in ((in_h, out_h), (in_w, out_w)):
                lo, hi, w0, w1 = two_tap_params(n, m)
                ts += [torch.from_numpy(lo).to(device, torch.int32),
                       torch.from_numpy(hi).to(device, torch.int32),
                       torch.from_numpy(w0).to(device),
                       torch.from_numpy(w1).to(device)]
        _TABLES[key] = tuple(ts)
    return _TABLES[key]


@functools.lru_cache(maxsize=None)
def _fn(dtype):
    lib = load_library('resize_reduce')
    fn = getattr(lib, _FUNCS[dtype])
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 \
        + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    occ = getattr(lib, _FUNCS[dtype] + '_blocks_per_sm')
    occ.restype, occ.argtypes = ctypes.c_int, [ctypes.c_int, ctypes.c_int]
    return fn, occ


@functools.lru_cache(maxsize=256)
def _plan(B, C, in_h, out_h, in_w, out_w, dtype, device_index):
    _, occ = _fn(dtype)
    n_sm = torch.cuda.get_device_properties(
        device_index).multi_processor_count

    def blocks_per_sm(smem):
        with torch.cuda.device(device_index):
            per_sm = occ(C, smem)
        if per_sm <= 0:
            raise RuntimeError(f'crop_resize_argmax_score: no occupancy '
                               f'for {smem} bytes of shared memory '
                               f'({per_sm})')
        return per_sm

    elt = torch.empty((), dtype=dtype).element_size()
    return rr_plan(B, C, in_h, out_h, in_w, out_w, elt, n_sm,
                   blocks_per_sm)


def _launch(x, crop_slices, out_h: int, out_w: int):
    if x.dim() != 4 or x.dtype not in _FUNCS:
        raise ValueError(f'crop_resize_argmax_score takes (B, C, H, W) '
                         f'float32/bfloat16 logits, got {tuple(x.shape)} '
                         f'{x.dtype}')
    y0, x0, in_h, in_w = _crop_box(x.shape, crop_slices)
    tables = _tables(in_h, out_h, in_w, out_w, x.device)
    B, C = x.shape[:2]
    plan = _plan(B, C, in_h, out_h, in_w, out_w, x.dtype, x.device.index)
    fn, _ = _fn(x.dtype)
    idx = torch.empty((B, out_h, out_w), dtype=torch.int32, device=x.device)
    score = torch.empty((B, out_h, out_w), dtype=torch.float32,
                        device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), *[t.data_ptr() for t in tables],
                 idx.data_ptr(), score.data_ptr(), B, C, out_h, out_w,
                 y0, x0, *x.stride(), plan.strip_w, plan.group_rows,
                 plan.band_groups, plan.ring_rows, plan.slot_elems,
                 plan.strips, plan.bands, stream)
    check(err, 'crop_resize_argmax_score')
    crop_resize_argmax_score.launches += 1
    return idx, score


def crop_resize_argmax_score(x, crop_slices, out_h: int, out_w: int):
    """(first-argmax idx int32, max-softmax score f32), both
    (B, out_h, out_w), of NCHW logits x cropped to `crop_slices`
    ((slice_y, slice_x), unit steps) and bilinearly resized. CUDA
    tensors go to the kernel; CPU tensors to the plain version."""
    if not is_cuda_tensor(x):
        return crop_resize_argmax_score_reference(x, crop_slices, out_h,
                                                  out_w)
    refuse_grad('crop_resize_argmax_score', x)
    return _launch(x, crop_slices, out_h, out_w)


crop_resize_argmax_score.launches = 0

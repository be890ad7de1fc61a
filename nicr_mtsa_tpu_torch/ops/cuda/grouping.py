"""Offset-vote grouping: for each pixel the nearest valid centre to
pixel + offset (counterpart of nicr_mtsa_tpu/ops/pallas/
grouping_kernel.py `group_pixels_pallas`).

Two entries of one kernel (csrc/grouping.cu), each with its plain
version and its launch counter:
- `group_pixels_offsets`, the pipeline's (ops/grouping.py
  `group_pixels`): the offset map (B, 2, H, W) in its own dtype and
  strides, the mask's bytes, the centres as NMS gives them; loc
  formation, the mask and the distance threshold happen in the kernel,
  so a call is one launch;
- `group_pixels_kernel`, the TPU kernel's interface: loc (B, P) planes.
On CPU tensors the wrappers run the plain versions, which follow the
XLA branch of nicr_mtsa_tpu/ops/grouping.py with the kernel's
semantics: invalid centres at +3.4e38, the first minimum wins, arg = -1
(id 0) and min_d2 = 3.4e38 where nothing won. Both compute
d2 = fma(dy, dy, dx * dx), the form XLA gives the TPU kernel's
`dy * dy + dx * dx`, so min_d2 matches it bit for bit."""
import ctypes
import functools

import numpy as np
import torch

from ..reduce import first_argmin
from ._build import check, is_cuda_tensor, load_library, refuse_grad

BIG = 3.4e38
TILE = 128 * 8          # pixels a tile of csrc/grouping.cu (a block's step)
_OFFSET_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def fma_f32(a, b, c):
    """a * b + c for f32 tensors with ONE rounding (a fused multiply-
    add), emulated exactly: the f64 product of two f32 values is exact,
    the f64 sum is rounded to odd (TwoSum error, then the odd
    neighbour), and round-to-odd in 53 bits followed by one rounding to
    24 bits equals the correctly rounded result."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, float('inf'), float('-inf'))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def group_pixels_reference(loc_y, loc_x, centers_yx, centers_valid,
                           foreground):
    """Plain PyTorch version: (ids (B, P) int32 in [0, K], min_d2 (B, P)
    f32)."""
    B, P = loc_y.shape
    K = centers_yx.shape[1]
    big = torch.tensor(BIG, dtype=torch.float32, device=loc_y.device)
    if K == 0:
        return (torch.zeros((B, P), dtype=torch.int32, device=loc_y.device),
                big.expand(B, P).clone())
    c = centers_yx.float()
    cy = torch.where(centers_valid, c[..., 0], big)
    cx = torch.where(centers_valid, c[..., 1], big)
    dy = loc_y.float()[:, :, None] - cy[:, None, :]
    dx = loc_x.float()[:, :, None] - cx[:, None, :]
    d2 = fma_f32(dy, dy, dx * dx)                          # (B, P, K)
    mn = d2.amin(dim=-1)
    won = mn < big
    arg = torch.where(won, first_argmin(d2, -1), -1)
    ids = torch.where(foreground, arg + 1, 0).to(torch.int32)
    return ids, torch.where(won, mn, big)


def threshold_squared(threshold) -> float:
    """The distance threshold squared, as the f32 value min_d2 is
    compared with (None: no threshold)."""
    return None if threshold is None else float(
        np.float32(float(threshold) ** 2))


def group_pixels_offsets_reference(offset, centers_yx, centers_valid,
                                   foreground, threshold=None):
    """Plain PyTorch version of the pipeline entry: (ids (B, H, W) int32,
    min_d2 (B, H, W) f32, 3.4e38 at background pixels)."""
    B, _, H, W = offset.shape
    dev = offset.device
    yy = torch.arange(H, dtype=torch.float32, device=dev).view(1, H, 1)
    xx = torch.arange(W, dtype=torch.float32, device=dev).view(1, 1, W)
    loc_y = (yy + offset[:, 0].float()).reshape(B, H * W)
    loc_x = (xx + offset[:, 1].float()).reshape(B, H * W)
    fg = foreground.reshape(B, H * W)
    ids, min_d2 = group_pixels_reference(loc_y, loc_x, centers_yx,
                                         centers_valid, fg)
    min_d2 = torch.where(fg, min_d2, BIG)
    thr2 = threshold_squared(threshold)
    if thr2 is not None:
        ids = torch.where(
            min_d2 <= torch.tensor(thr2, dtype=torch.float32, device=dev),
            ids, 0)
    return ids.reshape(B, H, W), min_d2.reshape(B, H, W)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = load_library('grouping')
    loc = lib.group_pixels_f32
    loc.restype = ctypes.c_int
    loc.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] \
        + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    off = lib.group_pixels_offsets
    off.restype = ctypes.c_int
    off.argtypes = [ctypes.c_void_p, ctypes.c_int] \
        + [ctypes.c_longlong] * 4 + [ctypes.c_void_p] \
        + [ctypes.c_longlong] * 3 + [ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_void_p] \
        + [ctypes.c_int] * 4 + [ctypes.c_float] + [ctypes.c_void_p] * 3
    occ = lib.group_pixels_blocks_per_sm
    occ.restype = ctypes.c_int
    occ.argtypes = [ctypes.c_int] * 2
    return loc, off, occ


def blocks_per_sm(loc: bool, K: int) -> int:
    """Resident blocks an SM at K centres of the loc entry's instance or
    of the pipeline entry's (bf16 offsets, int32 centres)."""
    n = _lib()[2](int(loc), K)
    if n <= 0:
        raise RuntimeError(f'group_pixels: no occupancy at K={K} ({n})')
    return n


def _centres(centers_yx, centers_valid, dev):
    """The centres in f32 or int32 (flag) and the validity bytes, both
    contiguous on `dev` (no launch for what NMS gives)."""
    ctr = centers_yx.to(dev)
    if ctr.dtype not in (torch.float32, torch.int32):
        ctr = ctr.float()
    valid = centers_valid.to(dev)
    valid = (valid.view(torch.uint8) if valid.dtype == torch.bool
             else valid.to(torch.uint8))
    return ctr.contiguous(), int(ctr.dtype == torch.int32), valid.contiguous()


def _mask_bytes(foreground, dev):
    fg = foreground.to(dev)
    return fg.view(torch.uint8) if fg.dtype == torch.bool \
        else fg.to(torch.uint8)


def _launch(loc_y, loc_x, centers_yx, centers_valid, foreground):
    B, P = loc_y.shape
    K = centers_yx.shape[1]
    if loc_y.dtype != torch.float32 or loc_x.dtype != torch.float32 \
            or foreground.shape != (B, P) \
            or centers_valid.shape != (B, K) \
            or tuple(centers_yx.shape) != (B, K, 2):
        raise ValueError('group_pixels: loc_y/loc_x (B, P) float32, '
                         'centers_yx (B, K, 2), centers_valid (B, K), '
                         'foreground (B, P)')
    fn = _lib()[0]
    dev = loc_y.device
    loc_y = loc_y.contiguous()
    loc_x = loc_x.contiguous()
    ctr, ctr_i32, valid = _centres(centers_yx, centers_valid, dev)
    fg = _mask_bytes(foreground, dev).contiguous()
    ids = torch.empty((B, P), dtype=torch.int32, device=dev)
    min_d2 = torch.empty((B, P), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(loc_y.data_ptr(), loc_x.data_ptr(), ctr.data_ptr(), ctr_i32,
                 valid.data_ptr(), fg.data_ptr(), ids.data_ptr(),
                 min_d2.data_ptr(), B, P, K, stream)
    check(err, 'group_pixels')
    group_pixels_kernel.launches += 1
    return ids, min_d2


def group_pixels_kernel(loc_y, loc_x, centers_yx, centers_valid,
                        foreground):
    """(ids (B, P) int32, min_d2 (B, P) f32) for loc (B, P) f32 and K
    centres (B, K, 2) with a (B, K) validity mask. CUDA tensors go to
    the kernel; CPU tensors to the plain version."""
    if not is_cuda_tensor(loc_y):
        return group_pixels_reference(loc_y, loc_x, centers_yx,
                                      centers_valid, foreground)
    refuse_grad('group_pixels_kernel', loc_y, loc_x, centers_yx)
    return _launch(loc_y, loc_x, centers_yx, centers_valid, foreground)


group_pixels_kernel.launches = 0


def _launch_offsets(offset, centers_yx, centers_valid, foreground,
                    threshold, return_min_d2):
    B, two, H, W = offset.shape
    K = centers_yx.shape[1]
    if two != 2 or offset.dtype not in _OFFSET_DTYPES \
            or tuple(foreground.shape) != (B, H, W) \
            or tuple(centers_valid.shape) != (B, K) \
            or tuple(centers_yx.shape) != (B, K, 2):
        raise ValueError('group_pixels_offsets: offset (B, 2, H, W) '
                         'float32/bfloat16, centers_yx (B, K, 2), '
                         'centers_valid (B, K), foreground (B, H, W)')
    fn = _lib()[1]
    dev = offset.device
    ctr, ctr_i32, valid = _centres(centers_yx, centers_valid, dev)
    fg = _mask_bytes(foreground, dev)
    thr2 = threshold_squared(threshold)
    ids = torch.empty((B, H, W), dtype=torch.int32, device=dev)
    min_d2 = (torch.empty((B, H, W), dtype=torch.float32, device=dev)
              if return_min_d2 else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(offset.data_ptr(), _OFFSET_DTYPES[offset.dtype],
                 *offset.stride(), fg.data_ptr(), *fg.stride(),
                 ctr.data_ptr(), ctr_i32, valid.data_ptr(), B, H, W, K,
                 -1.0 if thr2 is None else thr2, ids.data_ptr(),
                 None if min_d2 is None else min_d2.data_ptr(), stream)
    check(err, 'group_pixels_offsets')
    group_pixels_offsets.launches += 1
    return ids, min_d2


def group_pixels_offsets(offset, centers_yx, centers_valid, foreground,
                         threshold=None, return_min_d2=False):
    """(ids (B, H, W) int32, min_d2 (B, H, W) f32 or None) for
    unnormalised offsets (B, 2, H, W) f32/bf16 with any strides, K
    centres (B, K, 2) (int32 or f32) with a (B, K) validity mask, a
    (B, H, W) foreground mask and an optional distance threshold (ids
    0 where min_d2 > threshold^2); min_d2 only if `return_min_d2`
    (3.4e38 at background pixels). CUDA tensors go to the kernel; CPU
    tensors to the plain version."""
    if not is_cuda_tensor(offset):
        ids, min_d2 = group_pixels_offsets_reference(
            offset, centers_yx, centers_valid, foreground, threshold)
        return ids, min_d2 if return_min_d2 else None
    refuse_grad('group_pixels_offsets', offset, centers_yx)
    return _launch_offsets(offset, centers_yx, centers_valid, foreground,
                           threshold, return_min_d2)


group_pixels_offsets.launches = 0

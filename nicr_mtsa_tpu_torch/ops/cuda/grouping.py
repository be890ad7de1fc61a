"""Offset-vote grouping: for each pixel the nearest valid centre to
pixel + offset (counterpart of nicr_mtsa_tpu/ops/pallas/
grouping_kernel.py `group_pixels_pallas`).

On the card the work is done by csrc/grouping.cu; on CPU tensors the
wrapper runs the plain version, `group_pixels_reference`, which
follows the XLA branch of nicr_mtsa_tpu/ops/grouping.py with the
kernel's semantics: invalid centres at +3.4e38, the first minimum
wins, arg = -1 (id 0) and min_d2 = 3.4e38 where nothing won. Both
compute d2 = fma(dy, dy, dx * dx), the form XLA gives the TPU
kernel's `dy * dy + dx * dx`, so min_d2 matches it bit for bit."""
import ctypes

import torch

from ..reduce import first_argmin
from ._build import check, is_cuda_tensor, load_library, refuse_grad

BIG = 3.4e38


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
    lib = load_library('grouping')
    fn = lib.group_pixels_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    dev = loc_y.device
    loc_y = loc_y.contiguous()
    loc_x = loc_x.contiguous()
    ctr = centers_yx.to(device=dev, dtype=torch.float32).contiguous()
    valid = centers_valid.to(device=dev, dtype=torch.uint8).contiguous()
    fg = foreground.to(device=dev, dtype=torch.uint8).contiguous()
    ids = torch.empty((B, P), dtype=torch.int32, device=dev)
    min_d2 = torch.empty((B, P), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(loc_y.data_ptr(), loc_x.data_ptr(), ctr.data_ptr(),
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

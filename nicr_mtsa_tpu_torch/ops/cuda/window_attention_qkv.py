"""Shifted-window attention read straight from the packed qkv tensor
(counterpart of nicr_mtsa_tpu/ops/pallas/window_attention.py
`fused_window_attention_qkv`, the serving path of the Swin backbone's
'pallas-qkv' backend): the q/k/v slicing, the v2 per-head cosine
normalisation in f32 and the logit scale happen inside the kernel, so
the qkv product feeds it directly. Serving only: there is no gradient.

On the card the work is done by csrc/window_attention_qkv.cu; on CPU
tensors the wrapper runs the plain version,
`window_attention_qkv_reference` (window_attention.py
`attention_from_qkv`, shared with the sub-block's plain version). The
shift mask follows `shift_region_ids` on the (nWh, nWw) window grid
`grid_hw`, windows in image-major, then row-major grid order."""
import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from ._build import check, is_cuda_tensor, load_library, refuse_grad
from .window_attention import HEAD_DIM, attention_from_qkv

_FUNCS = {torch.float32: 'window_attention_qkv_f32',
          torch.bfloat16: 'window_attention_qkv_bf16'}


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    fn = getattr(load_library('window_attention_qkv'), name)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 \
        + [ctypes.c_float, ctypes.c_void_p]
    return fn


# the plain version (see `window_attention_qkv`)
window_attention_qkv_reference = attention_from_qkv


def _launch(qkv, bias, n_heads, grid_hw, shift, v2_scale):
    Bw, N, C3 = qkv.shape
    C, ws = C3 // 3, math.isqrt(N)
    if qkv.dtype not in _FUNCS or ws * ws != N or N > 64 \
            or C3 != 3 * n_heads * HEAD_DIM:
        raise ValueError(f'window_attention_qkv takes (Bw, N <= 64 square, '
                         f'3C = 96 * n_heads) float32/bfloat16 qkv, got '
                         f'{tuple(qkv.shape)} {qkv.dtype} with {n_heads} '
                         f'heads')
    if tuple(bias.shape) != (n_heads, N, N):
        raise ValueError(f'window_attention_qkv: bias must be '
                         f'({n_heads}, {N}, {N}), got {tuple(bias.shape)}')
    nWh, nWw = grid_hw
    sh, sw = shift if shift is not None else (0, 0)
    if (sh or sw) and Bw % (nWh * nWw):
        raise ValueError(f'window_attention_qkv: {Bw} windows are not whole '
                         f'images of a {nWh} x {nWw} window grid')
    fn = _entry(_FUNCS[qkv.dtype])
    dev = qkv.device
    qkv = qkv.contiguous()
    if qkv.data_ptr() % 16:             # the kernel loads 16-byte vectors
        qkv = qkv.clone()
    bias = bias.to(device=dev, dtype=torch.float32).contiguous()
    scale = (None if v2_scale is None else
             v2_scale.to(device=dev, dtype=torch.float32).contiguous())
    out = torch.empty((Bw, N, C), dtype=qkv.dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(qkv.data_ptr(), bias.data_ptr(),
                 None if scale is None else scale.data_ptr(), out.data_ptr(),
                 Bw, N, C, n_heads, ws, nWh, nWw, sh, sw,
                 float(HEAD_DIM) ** -0.5, stream)
    check(err, 'window_attention_qkv')
    window_attention_qkv.launches += 1
    return out


def window_attention_qkv(qkv, bias, n_heads: int,
                         grid_hw: Tuple[int, int] = (1, 1),
                         shift: Optional[Tuple[int, int]] = None,
                         v2_scale=None):
    """Attention of windows from their packed qkv (Bw, N, 3C), the last
    axis (3, h, d) with d = 32 (v2: the k bias already zeroed): per head
    softmax(q k^T x scale + bias + shift mask) v, with bias (h, N, N)
    additive query-major, `shift` None for an unshifted block else
    (shift_h, shift_w) on the window grid `grid_hw` of the padded image,
    `v2_scale` (h,) f32 logit scales for v2 cosine attention (q and k
    normalised per head) or None (v1: d^-0.5). Returns (Bw, N, C) in
    qkv's dtype. CUDA tensors go to the kernel; CPU tensors to the plain
    version."""
    if not is_cuda_tensor(qkv):
        return window_attention_qkv_reference(qkv, bias, n_heads, grid_hw,
                                              shift, v2_scale)
    refuse_grad('window_attention_qkv', qkv, bias, v2_scale)
    return _launch(qkv, bias, n_heads, tuple(grid_hw), shift, v2_scale)


window_attention_qkv.launches = 0

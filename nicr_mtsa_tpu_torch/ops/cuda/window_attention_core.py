"""Window-attention core with its flash-style backward, the training
path of the Swin blocks (counterpart of nicr_mtsa_tpu/ops/pallas/
window_attention.py `fused_window_attention` and its custom VJP).

For windows q, k, v (Bw, N <= 64, C = 32 h), q already scaled, each head
computes softmax(q k^T + bias + shift mask) v with f32 logits and
softmax, the probabilities rounded to the input dtype before the product
with v, the output in the input dtype; the forward also gives the f32
logsumexp (Bw, h, N). The backward recomputes the logits from it and
rounds where the TPU kernel does (`window_attention_core_backward_
reference` spells the formulas out). bias is (h, N, N) f32 query-major;
the shift mask (-100 between shift regions) follows `shift_region_ids`
on the (nWh, nWw) window grid `grid_hw`, windows in image-major, then
row-major grid order.

Three kernels of csrc/window_attention_core.cu, each with its own launch
counter:
- `window_attention_core_forward` -> (out, lse);
- `window_attention_core_backward` -> (dq, dk, dv, dbias), which
  launches the backward kernel (per-block dbias partial sums over fixed
  window ranges) and then
- `dbias_reduce`, the sum of the partials in a fixed order, so two runs
  give the same dbias bits.
On CPU tensors each runs its plain version. `window_attention_core` is
the differentiable entry (a `torch.autograd.Function` over the first
two); the bias gradient flows on by autograd, the mask has none."""
import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from ...utils.dtypes import upcast
from ._build import check, is_cuda_tensor, load_library, refuse_grad
from .window_attention import HEAD_DIM, shift_attn_mask

_SUFFIX = {torch.float32: 'f32', torch.bfloat16: 'bf16'}
# (window range, head) blocks of the backward that run at once: 3 on
# each of an H100's 132 SMs (the bf16 kernel's launch bounds). A
# constant, not an occupancy query, so a shape always gets the same
# ranges and the same dbias summation order.
BWD_SLOTS = 3 * 132


def bwd_partition(Bw: int, h: int) -> Tuple[int, int]:
    """(windows a block `wpb`, blocks a head `G`) of the backward: head
    j's windows in G contiguous ranges [g wpb, (g + 1) wpb), as short as
    keep all G h blocks within BWD_SLOTS (one wave). A function of the
    shape alone: it fixes the dbias partials (G, h, N, N) and their
    summation order."""
    wpb = -(-Bw // max(1, BWD_SLOTS // h))
    return wpb, -(-Bw // wpb)


def _heads(t, h: int):
    """(Bw, N, C) -> (Bw, h, N, d) view."""
    Bw, N, C = t.shape
    return t.view(Bw, N, h, C // h).transpose(1, 2)


def _merge_heads(t):
    """(Bw, h, N, d) -> (Bw, N, h d)."""
    Bw, h, N, d = t.shape
    return t.transpose(1, 2).reshape(Bw, N, h * d)


def _logits(q, k, bias, grid_hw, shift):
    """(Bw, h, N, N) f32: q k^T + bias, + the shift mask."""
    Bw, N, _ = q.shape
    h = bias.shape[0]
    logits = (upcast(_heads(q, h)) @ upcast(_heads(k, h)).transpose(-1, -2)
              + upcast(bias)[None])
    if shift is not None:
        mask = shift_attn_mask(grid_hw, math.isqrt(N), shift, q.device)
        nW = mask.shape[0]
        logits = (logits.view(Bw // nW, nW, h, N, N)
                  + mask[None, :, None]).view(Bw, h, N, N)
    return logits


def window_attention_core_reference(q, k, v, bias, grid_hw=(1, 1),
                                    shift: Optional[Tuple[int, int]] = None):
    """Plain PyTorch forward: (out (Bw, N, C) in q's dtype, lse (Bw, h,
    N) f32)."""
    h, dt = bias.shape[0], q.dtype
    logits = _logits(q, k, bias, grid_hw, shift)
    mx = logits.amax(-1, keepdim=True)
    e = torch.exp(logits - mx)
    s = e.sum(-1, keepdim=True)
    p = (e / s).to(dt)
    out = (upcast(p) @ upcast(_heads(v, h))).to(dt)
    return _merge_heads(out), (mx + torch.log(s))[..., 0]


def window_attention_core_backward_reference(q, k, v, bias, dout, lse,
                                             grid_hw=(1, 1), shift=None):
    """Plain PyTorch backward, step by step at the TPU kernel's rounding
    points: (dq, dk, dv in q's dtype, dbias (h, N, N) f32)."""
    h, dt = bias.shape[0], q.dtype
    qh, kh, vh = (upcast(_heads(t, h)) for t in (q, k, v))
    do = upcast(_heads(dout.to(dt), h))
    p32 = torch.exp(_logits(q, k, bias, grid_hw, shift) - lse[..., None])
    p = upcast(p32.to(dt))
    dv = p.transpose(-1, -2) @ do
    dp = do @ vh.transpose(-1, -2)
    delta = (p32 * dp).sum(-1, keepdim=True)
    ds = p32 * (dp - delta)
    dsc = upcast(ds.to(dt))
    dq = dsc @ kh
    dk = dsc.transpose(-1, -2) @ qh
    return (_merge_heads(dq.to(dt)), _merge_heads(dk.to(dt)),
            _merge_heads(dv.to(dt)), ds.sum(0))


def dbias_reduce_reference(partials):
    """Plain version of the dbias reduction: the sum over the leading
    axis of (G, h, N, N) f32 partials, in order 0 .. G-1."""
    out = partials[0].clone()
    for part in partials[1:]:
        out += part
    return out


def _check(q, k, v, bias, shift):
    Bw, N, C = q.shape
    h = bias.shape[0]
    ws = math.isqrt(N)
    if (q.dtype not in _SUFFIX or N > 64 or ws * ws != N
            or C != h * HEAD_DIM):
        raise ValueError(f'window_attention_core takes (Bw, N <= 64 square, '
                         f'C = 32 h) float32/bfloat16 q, k, v, got '
                         f'{tuple(q.shape)} {q.dtype} with {h} heads')
    if k.shape != q.shape or v.shape != q.shape or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError('window_attention_core: q, k and v must share '
                         'shape and dtype')
    if tuple(bias.shape) != (h, N, N):
        raise ValueError(f'window_attention_core: bias must be ({h}, {N}, '
                         f'{N}), got {tuple(bias.shape)}')
    return Bw, N, C, h, ws


def _aligned(t):
    """Contiguous with a 16-byte aligned start (the kernels' vector
    loads)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _grid(grid_hw, shift):
    sh, sw = shift if shift is not None else (0, 0)
    return int(grid_hw[0]), int(grid_hw[1]), int(sh), int(sw)


@functools.lru_cache(maxsize=None)
def _entry(name: str, n_ptrs: int, n_ints: int):
    fn = getattr(load_library('window_attention_core'), name)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints \
        + [ctypes.c_void_p]
    return fn


def _forward_launch(q, k, v, bias, grid_hw, shift):
    Bw, N, C, h, ws = _check(q, k, v, bias, shift)
    nWh, nWw, sh, sw = _grid(grid_hw, shift)
    if (sh or sw) and Bw % (nWh * nWw):
        raise ValueError(f'window_attention_core: {Bw} windows are not '
                         f'whole images of a {nWh} x {nWw} window grid')
    fn = _entry(f'wac_forward_{_SUFFIX[q.dtype]}', 6, 9)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    bias = bias.to(device=q.device, dtype=torch.float32).contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((Bw, h, N), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                 out.data_ptr(), lse.data_ptr(), Bw, N, C, h, ws, nWh, nWw,
                 sh, sw, stream)
    check(err, 'window_attention_core_forward')
    window_attention_core_forward.launches += 1
    return out, lse


def window_attention_core_forward(q, k, v, bias, grid_hw=(1, 1),
                                  shift: Optional[Tuple[int, int]] = None):
    """(out (Bw, N, C) in q's dtype, lse (Bw, h, N) f32) of windows q, k,
    v (q scaled), bias (h, N, N), `shift` None or (shift_h, shift_w) on
    the window grid `grid_hw`. CUDA tensors go to the kernel (no
    gradient: see `window_attention_core`); CPU tensors to the plain
    version."""
    if not is_cuda_tensor(q):
        return window_attention_core_reference(q, k, v, bias, grid_hw, shift)
    refuse_grad('window_attention_core_forward', q, k, v, bias)
    return _forward_launch(q, k, v, bias, grid_hw, shift)


window_attention_core_forward.launches = 0


def _backward_launch(q, k, v, bias, dout, lse, grid_hw, shift):
    Bw, N, C, h, ws = _check(q, k, v, bias, shift)
    nWh, nWw, sh, sw = _grid(grid_hw, shift)
    if tuple(lse.shape) != (Bw, h, N) or dout.shape != q.shape:
        raise ValueError('window_attention_core_backward: dout must be '
                         f'{tuple(q.shape)} and lse ({Bw}, {h}, {N})')
    fn = _entry(f'wac_backward_{_SUFFIX[q.dtype]}', 10, 10)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    dout = _aligned(dout.to(q.dtype))
    lse = lse.float().contiguous()
    bias = bias.to(device=q.device, dtype=torch.float32).contiguous()
    wpb, n_groups = bwd_partition(Bw, h)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    partials = torch.empty((n_groups, h, N, N), dtype=torch.float32,
                           device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                 lse.data_ptr(), bias.data_ptr(), dq.data_ptr(),
                 dk.data_ptr(), dv.data_ptr(), partials.data_ptr(), Bw, N, C,
                 h, ws, nWh, nWw, sh, sw, wpb, stream)
    check(err, 'window_attention_core_backward')
    window_attention_core_backward.launches += 1
    return dq, dk, dv, dbias_reduce(partials)


def window_attention_core_backward(q, k, v, bias, dout, lse, grid_hw=(1, 1),
                                   shift: Optional[Tuple[int, int]] = None):
    """(dq, dk, dv in q's dtype, dbias (h, N, N) f32) for the upstream
    gradient `dout` of `window_attention_core_forward`'s output and its
    `lse`. CUDA tensors go to the backward kernel and `dbias_reduce`;
    CPU tensors to the plain version."""
    if not is_cuda_tensor(q):
        return window_attention_core_backward_reference(
            q, k, v, bias, dout, lse, grid_hw, shift)
    refuse_grad('window_attention_core_backward', q, k, v, bias, dout)
    return _backward_launch(q, k, v, bias, dout, lse, grid_hw, shift)


window_attention_core_backward.launches = 0


def dbias_reduce(partials):
    """(h, N, N) sum of (G, h, N, N) f32 partials over G, in order
    0 .. G-1. CUDA tensors go to the kernel; CPU tensors to the plain
    version."""
    if not is_cuda_tensor(partials):
        return dbias_reduce_reference(partials)
    refuse_grad('dbias_reduce', partials)
    if partials.dim() != 4 or partials.dtype != torch.float32:
        raise ValueError(f'dbias_reduce takes (G, h, N, N) float32 '
                         f'partials, got {tuple(partials.shape)} '
                         f'{partials.dtype}')
    fn = _entry('wac_dbias_reduce', 2, 2)
    partials = partials.contiguous()
    out = torch.empty(partials.shape[1:], dtype=torch.float32,
                      device=partials.device)
    with torch.cuda.device(partials.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(partials.data_ptr(), out.data_ptr(), partials.shape[0],
                 out.numel(), stream)
    check(err, 'dbias_reduce')
    dbias_reduce.launches += 1
    return out


dbias_reduce.launches = 0


class _WindowAttentionCore(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, grid_hw, shift):
        out, lse = window_attention_core_forward(q, k, v, bias, grid_hw,
                                                 shift)
        ctx.save_for_backward(q, k, v, bias, lse)
        ctx.grid_hw, ctx.shift = grid_hw, shift
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias, lse = ctx.saved_tensors
        dq, dk, dv, dbias = window_attention_core_backward(
            q, k, v, bias, dout, lse, ctx.grid_hw, ctx.shift)
        return dq, dk, dv, dbias.to(bias.dtype), None, None


def window_attention_core(q, k, v, bias, grid_hw=(1, 1),
                          shift: Optional[Tuple[int, int]] = None):
    """Differentiable window attention (Bw, N, C) of scaled q, k, v with
    the (h, N, N) bias and the shift mask of `shift` on `grid_hw`: the
    forward and backward kernels on the card, their plain versions on
    the CPU."""
    return _WindowAttentionCore.apply(q, k, v, bias, tuple(grid_hw),
                                      None if shift is None else tuple(shift))

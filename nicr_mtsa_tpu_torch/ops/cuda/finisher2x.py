"""Fused 2x semantic finisher: one learned-3x3-zeropad x2 upsampling of
half-res logits, then first argmax and max-softmax score at full
resolution, without writing the 2x logits (counterpart of
nicr_mtsa_tpu/ops/pallas/semantic_finisher.py `upsample2x_argmax_score`
and `finish_deferred_semantic`: the semantic head of EMSANet served
with its last prediction upsampling deferred, `bench.py --no-defer4x`).

On the card the work is done by csrc/finisher4x.cu's one-stage instance
(`finisher2x_kernel`, the 4x finishers' tile template without stage 1:
the staged zero-padded input window is the plane its stage reads), in
output tiles whose geometry is `finisher4x.f4_plan(..., stages=1)`; it
reads the logits through their strides (channels-last included, no
copy). On CPU tensors the wrapper runs the plain version, which follows
the same exact-phase numerics. Inputs are (B, C, H, W)."""
import ctypes
import functools

import torch

from ...models.upsampling import DeferredUpsampling, zeropad2x_logits_exact
from ..reduce import semantic_score_idx
from ._build import check, is_cuda_tensor, load_library, refuse_grad
from .finisher4x import F4Plan, cached_stage_weights, f4_plan

_FUNCS = {torch.float32: 'finisher2x_f32', torch.bfloat16: 'finisher2x_bf16'}


def upsample2x_argmax_score_reference(x, kernel, bias):
    """Plain PyTorch version: (idx int32, score f32), both (B, 2H, 2W)."""
    return semantic_score_idx(zeropad2x_logits_exact(x, kernel, bias), dim=1)


def plan_for(x) -> F4Plan:
    """The one-stage tile plan of logits x (B, C, H, W)."""
    return f4_plan(tuple(x.shape), x.stride(), x.element_size(),
                   x.data_ptr() % 16 == 0, stages=1)


@functools.lru_cache(maxsize=None)
def _fn(dtype):
    lib = load_library('finisher4x')
    fn = getattr(lib, _FUNCS[dtype])
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 \
        + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    occ = getattr(lib, _FUNCS[dtype] + '_blocks_per_sm')
    occ.restype = ctypes.c_int
    occ.argtypes = [ctypes.c_int] * 3
    return fn, occ


def blocks_per_sm(dtype, C: int, plan: F4Plan) -> int:
    """Resident blocks an SM of the instance that takes C classes, at
    the plan's tile (the library's occupancy query)."""
    n = _fn(dtype)[1](C, plan.tile_y, plan.tile_x)
    if n <= 0:
        raise RuntimeError(f'finisher2x: no occupancy at {plan} ({n})')
    return n


def _launch(x, kernel, bias):
    if x.dim() != 4 or x.dtype not in _FUNCS:
        raise ValueError(f'finisher2x takes (B, C, H, W) float32/bfloat16 '
                         f'logits, got {tuple(x.shape)} {x.dtype}')
    fn, _ = _fn(x.dtype)
    B, C, H, W = x.shape
    plan = plan_for(x)
    kt, b = cached_stage_weights(kernel, bias, x.dtype, x.device)
    idx = torch.empty((B, 2 * H, 2 * W), dtype=torch.int32, device=x.device)
    score = torch.empty((B, 2 * H, 2 * W), dtype=torch.float32,
                        device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), kt.data_ptr(), b.data_ptr(), idx.data_ptr(),
                 score.data_ptr(), B, C, H, W, *x.stride(), plan.tile_y,
                 plan.tile_x, int(plan.vec), stream)
    check(err, 'finisher2x')
    upsample2x_argmax_score.launches += 1
    return idx, score


def upsample2x_argmax_score(x, kernel, bias):
    """(first-argmax idx int32, max-softmax score f32), both (B, 2H, 2W),
    of (B, C, H, W) logits x with any strides upsampled by one
    learned-3x3-zeropad x2 stage (kernel (C, 1, 3, 3) f32, bias (C,) or
    None). CUDA tensors go to the kernel; CPU tensors to the plain
    version."""
    if not is_cuda_tensor(x):
        return upsample2x_argmax_score_reference(x, kernel, bias)
    refuse_grad('upsample2x_argmax_score', x, kernel, bias)
    return _launch(x, kernel, bias)


upsample2x_argmax_score.launches = 0


def finish_deferred_semantic(deferred: DeferredUpsampling):
    """(idx, score) of a semantic head's DeferredUpsampling output."""
    return upsample2x_argmax_score(deferred.x, deferred.kernel,
                                   deferred.bias)

"""Fused 4x semantic finisher: two x2 upsamplings of quarter-res
logits, then first argmax and max-softmax score at full resolution,
without writing the 2x or 4x logits.

Counterpart of nicr_mtsa_tpu/ops/pallas/semantic_finisher4x.py:
- `upsample4x_argmax_score` / `finish_deferred_semantic2`: two
  learned-3x3-zeropad stages (the dense decoders' semantic head);
- `upsample4x_bilinear_argmax_score` / `finish_deferred_bilinear2`: two
  half-pixel bilinear stages (the MLP decoders' semantic head), which
  are the same kernel with the fixed bilinear stage weights, zero
  biases, the input edge-replicated and no zero ring (`edge`).
On the card the work is done by csrc/finisher4x.cu; on CPU tensors the
wrappers run the plain versions, which follow the same exact-phase
numerics. The two entries count their launches apart. Inputs are
NCHW."""
import ctypes
from functools import lru_cache

import torch

from ...models.upsampling import (DeferredBilinear2, DeferredUpsampling2,
                                  bilinear_kernel, finisher4x_logits_exact,
                                  fused_zeropad_2x_kernel)
from ..reduce import semantic_score_idx
from ._build import check, is_cuda_tensor, load_library, refuse_grad

_FUNCS = {torch.float32: 'finisher4x_f32', torch.bfloat16: 'finisher4x_bf16'}


def upsample4x_argmax_score_reference(x, kernel1, bias1, kernel2, bias2):
    """Plain PyTorch version: (idx int32, score f32), both (B, 4H, 4W)."""
    logits = finisher4x_logits_exact(x, kernel1, bias1, kernel2, bias2)
    return semantic_score_idx(logits, dim=1)


def stage_weights(kernel, bias, C, dt, device):
    """Fused 4x4 kernel as (C, 16) and bias as (C,), f32 values rounded
    to the compute dtype (what a finisher kernel multiplies and adds, at
    each of its learned-3x3-zeropad stages)."""
    kt = fused_zeropad_2x_kernel(kernel)[:, 0].to(dt).float()
    b = (torch.zeros(C) if bias is None else bias.to(dt).float())
    return (kt.reshape(C, 16).to(device).contiguous(),
            b.to(device).contiguous())


@lru_cache(maxsize=16)
def _bilinear_stages(C: int, dt, device):
    """The bilinear entry's fixed stage weights on `device`, built once."""
    k, b = stage_weights(bilinear_kernel(C), None, C, dt, device)
    return k, b, k, b


def upsample4x_bilinear_argmax_score_reference(x):
    """Plain PyTorch version of the bilinear entry: the exact phase
    twin with `edge` (not two `resize_bilinear` calls, which round
    differently)."""
    k = bilinear_kernel(x.shape[1], x.device)
    logits = finisher4x_logits_exact(x, k, None, k, None, edge=True)
    return semantic_score_idx(logits, dim=1)


def _launch(x, stages, edge: bool, counter):
    """stages: (k1, b1, k2, b2) from `stage_weights` on x's device."""
    if x.dim() != 4 or x.dtype not in _FUNCS:
        raise ValueError(f'finisher4x takes (B, C, H, W) float32/bfloat16 '
                         f'logits, got {tuple(x.shape)} {x.dtype}')
    lib = load_library('finisher4x')
    fn = getattr(lib, _FUNCS[x.dtype])
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    B, C, H, W = x.shape
    x = x.contiguous()
    k1, b1, k2, b2 = stages
    idx = torch.empty((B, 4 * H, 4 * W), dtype=torch.int32, device=x.device)
    score = torch.empty((B, 4 * H, 4 * W), dtype=torch.float32,
                        device=x.device)
    # the temporaries above may be freed when this returns: the caching
    # allocator reuses memory in stream order, after the kernel
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), k1.data_ptr(), b1.data_ptr(), k2.data_ptr(),
                 b2.data_ptr(), idx.data_ptr(), score.data_ptr(),
                 B, C, H, W, int(edge), stream)
    check(err, 'finisher4x')
    counter.launches += 1
    return idx, score


def upsample4x_argmax_score(x, kernel1, bias1, kernel2, bias2):
    """(first-argmax idx int32, max-softmax score f32), both (B, 4H, 4W),
    of NCHW logits x upsampled by two learned-3x3-zeropad x2 stages
    (kernels (C, 1, 3, 3) f32, biases (C,) or None). CUDA tensors go
    to the kernel; CPU tensors to the plain version."""
    if not is_cuda_tensor(x):
        return upsample4x_argmax_score_reference(x, kernel1, bias1,
                                                 kernel2, bias2)
    refuse_grad('upsample4x_argmax_score', x, kernel1, bias1, kernel2, bias2)
    C, dt = x.shape[1], x.dtype
    stages = (stage_weights(kernel1, bias1, C, dt, x.device)
              + stage_weights(kernel2, bias2, C, dt, x.device))
    return _launch(x, stages, False, upsample4x_argmax_score)


upsample4x_argmax_score.launches = 0


def upsample4x_bilinear_argmax_score(x):
    """(first-argmax idx int32, max-softmax score f32), both (B, 4H, 4W),
    of NCHW logits x upsampled by two half-pixel bilinear x2 stages.
    CUDA tensors go to the kernel; CPU tensors to the plain version."""
    if not is_cuda_tensor(x):
        return upsample4x_bilinear_argmax_score_reference(x)
    refuse_grad('upsample4x_bilinear_argmax_score', x)
    return _launch(x, _bilinear_stages(x.shape[1], x.dtype, x.device), True,
                   upsample4x_bilinear_argmax_score)


upsample4x_bilinear_argmax_score.launches = 0


def finish_deferred_semantic2(deferred: DeferredUpsampling2):
    """(idx, score) of a semantic head's DeferredUpsampling2 output."""
    return upsample4x_argmax_score(deferred.x, deferred.kernel1,
                                   deferred.bias1, deferred.kernel2,
                                   deferred.bias2)


def finish_deferred_bilinear2(deferred: DeferredBilinear2):
    """(idx, score) of a semantic head's DeferredBilinear2 output."""
    return upsample4x_bilinear_argmax_score(deferred.x)

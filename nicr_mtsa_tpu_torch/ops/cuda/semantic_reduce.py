"""First argmax and max-softmax score over the class axis of NCHW
logits (counterpart of nicr_mtsa_tpu/ops/pallas/semantic_reduce.py
`semantic_score_idx_pallas`).

On the card the work is done by csrc/semantic_reduce.cu, which reads
the logits through their strides (channels-last included, no copy); on
CPU tensors the wrapper runs the plain version, ops/reduce.py
`semantic_score_idx`."""
import ctypes

import torch

from ..reduce import semantic_score_idx
from ._build import check, is_cuda_tensor, load_library, refuse_grad

_FUNCS = {torch.float32: 'semantic_score_idx_f32',
          torch.bfloat16: 'semantic_score_idx_bf16'}


def semantic_argmax_score_reference(logits):
    """Plain PyTorch version: (idx int32, score f32), both (B, H, W)."""
    return semantic_score_idx(logits, dim=1)


def _launch(logits):
    if logits.dim() != 4 or logits.dtype not in _FUNCS:
        raise ValueError(f'semantic_argmax_score takes (B, C, H, W) '
                         f'float32/bfloat16 logits, got '
                         f'{tuple(logits.shape)} {logits.dtype}')
    lib = load_library('semantic_reduce')
    fn = getattr(lib, _FUNCS[logits.dtype])
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 \
        + [ctypes.c_longlong] * 4 + [ctypes.c_void_p]
    B, C, H, W = logits.shape
    idx = torch.empty((B, H, W), dtype=torch.int32, device=logits.device)
    score = torch.empty((B, H, W), dtype=torch.float32,
                        device=logits.device)
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(logits.data_ptr(), idx.data_ptr(), score.data_ptr(),
                 B, C, H, W, *logits.stride(), stream)
    check(err, 'semantic_argmax_score')
    semantic_argmax_score.launches += 1
    return idx, score


def semantic_argmax_score(logits):
    """(first-argmax idx int32, max-softmax score f32), both (B, H, W),
    of (B, C, H, W) logits with any strides. CUDA tensors go to the
    kernel; CPU tensors to the plain version."""
    if not is_cuda_tensor(logits):
        return semantic_argmax_score_reference(logits)
    refuse_grad('semantic_argmax_score', logits)
    return _launch(logits)


semantic_argmax_score.launches = 0

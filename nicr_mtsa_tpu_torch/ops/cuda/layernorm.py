"""Single-pass LayerNorm over the last axis (counterpart of
nicr_mtsa_tpu/ops/pallas/layernorm.py `fused_layer_norm`).

Semantics: f32 statistics with the fast variance E[x^2] - E[x]^2
clamped at 0, eps inside the rsqrt, the affine in f32, one cast to
`out_dtype` (default: x's dtype) at the end. On the card the work is
done by csrc/layernorm.cu (one warp per row); on CPU tensors the
wrapper runs the plain version, `layer_norm_reference`."""
import ctypes

import torch

from ...utils.dtypes import upcast
from ._build import check, is_cuda_tensor, load_library, refuse_grad

_NAMES = {torch.float32: 'f32', torch.bfloat16: 'bf16'}


def layer_norm_reference(x, weight, bias, eps: float = 1e-5,
                         out_dtype=None):
    """Plain PyTorch version, the same arithmetic as the kernel."""
    x32 = upcast(x)
    mean = x32.mean(-1, keepdim=True)
    var = ((x32 * x32).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * upcast(weight) + upcast(bias)
    return y.to(out_dtype or x.dtype)


def _launch(x, weight, bias, eps, out_dtype):
    if x.dtype not in _NAMES or out_dtype not in _NAMES or x.dim() < 1:
        raise ValueError(f'fused_layer_norm takes float32/bfloat16 input '
                         f'and output, got {x.dtype} -> {out_dtype}')
    C = x.shape[-1]
    if tuple(weight.shape) != (C,) or tuple(bias.shape) != (C,):
        raise ValueError(f'fused_layer_norm: weight/bias must be ({C},)')
    lib = load_library('layernorm')
    fn = getattr(lib, f'layer_norm_{_NAMES[x.dtype]}_{_NAMES[out_dtype]}')
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_float, ctypes.c_void_p]
    x = x.contiguous()
    w = weight.to(device=x.device, dtype=torch.float32).contiguous()
    b = bias.to(device=x.device, dtype=torch.float32).contiguous()
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                 x.numel() // max(C, 1), C, float(eps), stream)
    check(err, 'fused_layer_norm')
    fused_layer_norm.launches += 1
    return out


def fused_layer_norm(x, weight, bias, eps: float = 1e-5, out_dtype=None):
    """LayerNorm of x over its last axis with (C,) weight and bias.
    CUDA tensors go to the kernel; CPU tensors to the plain version."""
    if not is_cuda_tensor(x):
        return layer_norm_reference(x, weight, bias, eps, out_dtype)
    refuse_grad('fused_layer_norm', x, weight, bias)
    return _launch(x, weight, bias, eps, out_dtype or x.dtype)


fused_layer_norm.launches = 0

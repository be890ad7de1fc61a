"""Single-pass LayerNorm over the last axis (counterpart of
nicr_mtsa_tpu/ops/pallas/layernorm.py `fused_layer_norm`).

Semantics: f32 statistics with the fast variance E[x^2] - E[x]^2
clamped at 0, eps inside the rsqrt, the affine in f32, one cast to
`out_dtype` (default: x's dtype) at the end. On the card the work is
done by csrc/layernorm.cu on the grid of `ln_plan`; on CPU tensors the
wrapper runs the plain version, `layer_norm_reference`."""
import ctypes
import functools
from typing import NamedTuple

import torch

from ...utils.dtypes import upcast
from ._build import check, is_cuda_tensor, load_library, refuse_grad

_NAMES = {torch.float32: 'f32', torch.bfloat16: 'bf16'}
THREADS = 256                    # csrc/layernorm.cu THREADS
WARPS = THREADS // 32
MAX_NV = 4                       # 16-byte vectors a lane on the row path
MAX_WAVES = 16                   # grid waves before warps loop over rows


class LnPlan(NamedTuple):
    """The kernel's grid and row map. nv > 0: the row path, `lanes`
    lanes a row with nv 16-byte vectors each, `groups` = 32 / lanes rows
    a warp a pass and `unroll` passes in flight, so a warp takes
    `step` = groups x unroll rows, warp w of the grid rows
    [w step + k blocks WARPS step, ...) for k < `steps`. nv = 0: the
    generic path, one warp a row (`vec`: 16-byte loads)."""
    nv: int
    lanes: int
    unroll: int
    vec: bool
    blocks: int
    steps: int

    @property
    def groups(self) -> int:
        return 32 // self.lanes if self.nv else 1

    @property
    def step(self) -> int:
        return self.groups * self.unroll


def unroll_for(nv: int) -> int:
    """Rows a lane group keeps in flight (csrc `Unroll`)."""
    return 4 if nv == 1 else 1 if nv == 4 else 2


def ln_plan(rows: int, C: int, in_size: int, aligned: bool, n_sm: int,
            blocks_per_sm: int) -> LnPlan:
    """The launch of `rows` x C inputs of `in_size` bytes a value:
    - lanes a row: the largest power of two <= 32 that divides the row's
      16-byte vectors, nv = vectors / lanes (the row path while nv <= 4
      and the row and both pointers are 16-byte aligned);
    - the grid: one row step a warp up to MAX_WAVES waves of
      `blocks_per_sm` blocks on each of `n_sm` SMs; beyond, as many
      warps as keep every warp at the same number of steps within
      MAX_WAVES waves, each warp looping over its steps."""
    per_vec = 16 // in_size
    vec = aligned and C % per_vec == 0
    nv, lanes = 0, 32
    if vec:
        n = C // per_vec
        lanes = 1
        while lanes < 32 and n % (2 * lanes) == 0:
            lanes *= 2
        if n // lanes <= MAX_NV:
            nv = n // lanes
        else:
            lanes = 32
    unroll = unroll_for(nv) if nv else 1
    step = (32 // lanes if nv else 1) * unroll
    warp_steps = max(1, -(-rows // step))
    waves = MAX_WAVES * max(1, n_sm * blocks_per_sm) * WARPS
    steps = -(-warp_steps // waves)
    warps = -(-warp_steps // steps)
    return LnPlan(nv, lanes, unroll, vec, -(-warps // WARPS), steps)


def plan_rows(plan: LnPlan, block: int, warp: int):
    """The rows (with those past the end) warp `warp` of block `block`
    takes, in the kernel's order."""
    w = block * WARPS + warp
    stride = plan.blocks * WARPS * plan.step
    for k in range(plan.steps):
        base = w * plan.step + k * stride
        for i in range(plan.unroll):
            for grp in range(plan.groups):
                yield base + i * plan.groups + grp


def layer_norm_reference(x, weight, bias, eps: float = 1e-5,
                         out_dtype=None):
    """Plain PyTorch version, the same arithmetic as the kernel."""
    x32 = upcast(x)
    mean = x32.mean(-1, keepdim=True)
    var = ((x32 * x32).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * upcast(weight) + upcast(bias)
    return y.to(out_dtype or x.dtype)


@functools.lru_cache(maxsize=None)
def _fn(tin, tout):
    lib = load_library('layernorm')
    name = f'layer_norm_{_NAMES[tin]}_{_NAMES[tout]}'
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
    occ = getattr(lib, f'{name}_blocks_per_sm')
    occ.restype, occ.argtypes = ctypes.c_int, [ctypes.c_int]
    return fn, occ


@functools.lru_cache(maxsize=256)
def _plan(rows, C, tin, tout, aligned, device_index):
    _, occ = _fn(tin, tout)
    n_sm = torch.cuda.get_device_properties(
        device_index).multi_processor_count
    in_size = torch.empty((), dtype=tin).element_size()
    first = ln_plan(rows, C, in_size, aligned, n_sm, 1)
    with torch.cuda.device(device_index):
        per_sm = occ(first.nv)
    if per_sm <= 0:
        raise RuntimeError(f'fused_layer_norm: no occupancy for nv '
                           f'{first.nv} ({per_sm})')
    return ln_plan(rows, C, in_size, aligned, n_sm, per_sm)


def _launch(x, weight, bias, eps, out_dtype):
    if x.dtype not in _NAMES or out_dtype not in _NAMES or x.dim() < 1:
        raise ValueError(f'fused_layer_norm takes float32/bfloat16 input '
                         f'and output, got {x.dtype} -> {out_dtype}')
    C = x.shape[-1]
    if tuple(weight.shape) != (C,) or tuple(bias.shape) != (C,):
        raise ValueError(f'fused_layer_norm: weight/bias must be ({C},)')
    x = x.contiguous()
    w = weight.to(device=x.device, dtype=torch.float32).contiguous()
    b = bias.to(device=x.device, dtype=torch.float32).contiguous()
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    rows = x.numel() // max(C, 1)
    aligned = x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    plan = _plan(rows, C, x.dtype, out_dtype, aligned, x.device.index)
    fn, _ = _fn(x.dtype, out_dtype)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                 rows, C, float(eps), plan.nv, plan.lanes.bit_length() - 1,
                 int(plan.vec), plan.blocks, stream)
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

"""Fused 4x semantic finisher: two x2 upsamplings of quarter-res
logits, then first argmax and max-softmax score at full resolution,
without writing the 2x or 4x logits. (Its CUDA source also holds the
2x finisher, finisher2x.py: the same tile template with one stage.)

Counterpart of nicr_mtsa_tpu/ops/pallas/semantic_finisher4x.py:
- `upsample4x_argmax_score` / `finish_deferred_semantic2`: two
  learned-3x3-zeropad stages (the dense decoders' semantic head);
- `upsample4x_bilinear_argmax_score` / `finish_deferred_bilinear2`: two
  half-pixel bilinear stages (the MLP decoders' semantic head), which
  are the same kernel with the fixed bilinear stage weights, zero
  biases, the input edge-replicated and no zero ring (`edge`).
On the card the work is done by csrc/finisher4x.cu, which reads the
logits through their strides (channels-last included, no copy) in
output tiles whose geometry is `f4_plan`; on CPU tensors the wrappers
run the plain versions, which follow the same exact-phase numerics.
The two entries count their launches apart. Inputs are
(B, C, H, W)."""
import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
from torch.utils.weak import WeakIdKeyDictionary

from ...models.upsampling import (DeferredBilinear2, DeferredUpsampling2,
                                  bilinear_kernel, finisher4x_logits_exact,
                                  fused_zeropad_2x_kernel)
from ..reduce import semantic_score_idx
from ._build import check, is_cuda_tensor, load_library, refuse_grad

_FUNCS = {torch.float32: 'finisher4x_f32', torch.bfloat16: 'finisher4x_bf16'}
MAX_SMEM = 227 * 1024            # dynamic shared memory a block can take
SM_SMEM = 228 * 1024             # an SM's, 1 KB of it reserved a block
# output tiles (rows, cols) in the order tried, each side a multiple of
# 4 and the columns a divisor of half the block's 256 threads: the first
# whose shared memory lets two blocks share an SM (the kernel's launch
# bounds), else the first that fits a block
TILES = ((32, 64), (16, 64), (16, 32), (8, 32), (8, 16), (4, 16), (4, 8),
         (4, 4))


class F4Plan(NamedTuple):
    """The kernel's geometry: block (tile column, tile row, image)
    computes output rows [tile row tile_y, + tile_y) and columns
    [tile column tile_x, + tile_x) of `stages` x2 stages (2: the 4x
    finishers, 1: the 2x finisher); it stages the padded input's
    `window(...)[0]` and (two stages) builds the stage-1 plane's
    `window(...)[1]`, `classes` values a position (C rounded up to 16
    bytes), `smem` bytes with the weights; `vec`: the window is copied
    by 16-byte cp.async (channels-last, aligned)."""
    tile_y: int
    tile_x: int
    tiles_y: int
    tiles_x: int
    classes: int
    smem: int
    vec: bool
    stages: int = 2


def padded_classes(C: int, elt: int) -> int:
    v = 16 // elt
    return -(-C // v) * v


def smem_bytes(C: int, elt: int, tile_y: int, tile_x: int,
               stages: int = 2) -> int:
    """A block's dynamic shared memory (csrc/finisher4x.cu `smem_bytes`):
    the windows in the input's dtype (two stages: the padded input's and
    the stage-1 plane's; one stage: the padded input's, which is the
    plane), a permuted (C, 16) kernel and a bias (C rounded up to a
    multiple of 8) a stage in f32."""
    n_pos = (tile_y // 2 + 2) * (tile_x // 2 + 2)
    if stages == 2:
        n_pos += (tile_y // 4 + 2) * (tile_x // 4 + 2)
    return n_pos * padded_classes(C, elt) * elt \
        + stages * (C * 64 + (-(-C // 8) * 8) * 4)


def window(plan: F4Plan, tile_row: int, tile_col: int):
    """((row0, rows, col0, cols) of the padded input (H + 2, W + 2) that
    the tile stages, the same of the plane that its last stage reads):
    two stages read the stage-1 plane (2H + 2, 2W + 2), one stage the
    staged padded input itself."""
    q0, s0 = tile_row * plan.tile_y // 2, tile_col * plan.tile_x // 2
    plane = (q0, plan.tile_y // 2 + 2, s0, plan.tile_x // 2 + 2)
    if plan.stages == 1:
        return plane, plane
    return ((q0 // 2, plan.tile_y // 4 + 2, s0 // 2, plan.tile_x // 4 + 2),
            plane)


@functools.lru_cache(maxsize=256)
def f4_plan(shape, strides, elt: int, aligned: bool = True,
            stages: int = 2) -> F4Plan:
    """The geometry for logits of `shape` (B, C, H, W) and `strides`,
    `elt` bytes a value, the data address 16-byte `aligned` or not,
    upsampled by `stages` x2 stages: the first tile of TILES whose
    shared memory lets two blocks share an SM, else the first within
    MAX_SMEM; the window copied by 16-byte cp.async where each pixel's
    classes are contiguous whole 16-byte words (channels-last, aligned),
    else by plain loads."""
    B, C, H, W = shape
    sb, sc, sh, sw = strides
    vec = (aligned and sc == 1 and C * elt % 16 == 0 and sw * elt % 16 == 0
           and sh * elt % 16 == 0 and sb * elt % 16 == 0)
    sizes = [(ty, tx, smem_bytes(C, elt, ty, tx, stages)) for ty, tx in TILES]
    fits = [s for s in sizes if 2 * (s[2] + 1024) <= SM_SMEM] \
        or [s for s in sizes if s[2] <= MAX_SMEM]
    if not fits:
        raise ValueError(f'semantic finisher: {C} classes do not fit the '
                         f'kernel\'s shared memory')
    ty, tx, smem = fits[0]
    up = 2 ** stages
    return F4Plan(ty, tx, -(-up * H // ty), -(-up * W // tx),
                  padded_classes(C, elt), smem, vec, stages)


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


_STAGES = WeakIdKeyDictionary()


def _stamp(t: Optional[torch.Tensor]):
    """What identifies a weight's values: its storage and version (an
    inference tensor has no version counter and counts as unchanged
    while it lives)."""
    if t is None:
        return None
    return t.data_ptr(), None if t.is_inference() else t._version


def cached_stage_weights(kernel, bias, dt, device) -> Tuple[torch.Tensor,
                                                            torch.Tensor]:
    """`stage_weights` of (kernel, bias), cached per kernel tensor,
    dtype and device until the kernel or the bias changes (in place, or
    another bias): a serving request passes the same parameters every
    call. Built outside inference mode, so a later training step can
    use the tensors."""
    stamp = (_stamp(kernel), _stamp(bias))
    entry = _STAGES.setdefault(kernel, {})
    hit = entry.get((dt, device))
    if hit is None or hit[0] != stamp:
        with torch.inference_mode(False), torch.no_grad():
            packed = stage_weights(kernel, bias, kernel.shape[0], dt, device)
        hit = entry[(dt, device)] = (stamp, packed)
    return hit[1]


@functools.lru_cache(maxsize=16)
def _bilinear_stages(C: int, dt, device):
    """The bilinear entry's fixed stage weights on `device`, built once,
    outside inference mode."""
    with torch.inference_mode(False), torch.no_grad():
        k, b = stage_weights(bilinear_kernel(C), None, C, dt, device)
    return k, b, k, b


def upsample4x_bilinear_argmax_score_reference(x):
    """Plain PyTorch version of the bilinear entry: the exact phase
    twin with `edge` (not two `resize_bilinear` calls, which round
    differently)."""
    k = bilinear_kernel(x.shape[1], x.device)
    logits = finisher4x_logits_exact(x, k, None, k, None, edge=True)
    return semantic_score_idx(logits, dim=1)


@functools.lru_cache(maxsize=None)
def _fn(dtype):
    lib = load_library('finisher4x')
    fn = getattr(lib, _FUNCS[dtype])
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 \
        + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    occ = getattr(lib, _FUNCS[dtype] + '_blocks_per_sm')
    occ.restype = ctypes.c_int
    occ.argtypes = [ctypes.c_int] * 3
    return fn, occ


def blocks_per_sm(dtype, C: int, plan: F4Plan) -> int:
    """Resident blocks an SM of the instance that takes C classes, at
    the plan's tile (the library's occupancy query)."""
    n = _fn(dtype)[1](C, plan.tile_y, plan.tile_x)
    if n <= 0:
        raise RuntimeError(f'finisher4x: no occupancy at {plan} ({n})')
    return n


def _launch(x, stages, edge: bool, counter):
    """stages: (k1, b1, k2, b2) from `stage_weights` on x's device."""
    if x.dim() != 4 or x.dtype not in _FUNCS:
        raise ValueError(f'finisher4x takes (B, C, H, W) float32/bfloat16 '
                         f'logits, got {tuple(x.shape)} {x.dtype}')
    fn, _ = _fn(x.dtype)
    B, C, H, W = x.shape
    plan = f4_plan(tuple(x.shape), x.stride(), x.element_size(),
                   x.data_ptr() % 16 == 0)
    k1, b1, k2, b2 = stages
    idx = torch.empty((B, 4 * H, 4 * W), dtype=torch.int32, device=x.device)
    score = torch.empty((B, 4 * H, 4 * W), dtype=torch.float32,
                        device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), k1.data_ptr(), b1.data_ptr(), k2.data_ptr(),
                 b2.data_ptr(), idx.data_ptr(), score.data_ptr(),
                 B, C, H, W, *x.stride(), int(edge), plan.tile_y,
                 plan.tile_x, int(plan.vec), stream)
    check(err, 'finisher4x')
    counter.launches += 1
    return idx, score


def upsample4x_argmax_score(x, kernel1, bias1, kernel2, bias2):
    """(first-argmax idx int32, max-softmax score f32), both (B, 4H, 4W),
    of (B, C, H, W) logits x with any strides upsampled by two
    learned-3x3-zeropad x2 stages (kernels (C, 1, 3, 3) f32, biases (C,)
    or None). CUDA tensors go to the kernel; CPU tensors to the plain
    version."""
    if not is_cuda_tensor(x):
        return upsample4x_argmax_score_reference(x, kernel1, bias1,
                                                 kernel2, bias2)
    refuse_grad('upsample4x_argmax_score', x, kernel1, bias1, kernel2, bias2)
    stages = (cached_stage_weights(kernel1, bias1, x.dtype, x.device)
              + cached_stage_weights(kernel2, bias2, x.dtype, x.device))
    return _launch(x, stages, False, upsample4x_argmax_score)


upsample4x_argmax_score.launches = 0


def upsample4x_bilinear_argmax_score(x):
    """(first-argmax idx int32, max-softmax score f32), both (B, 4H, 4W),
    of (B, C, H, W) logits x with any strides upsampled by two
    half-pixel bilinear x2 stages. CUDA tensors go to the kernel; CPU
    tensors to the plain version."""
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

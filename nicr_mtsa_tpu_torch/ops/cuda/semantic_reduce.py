"""First argmax and max-softmax score over the class axis of NCHW
logits (counterpart of nicr_mtsa_tpu/ops/pallas/semantic_reduce.py
`semantic_score_idx_pallas`).

On the card the work is done by csrc/semantic_reduce.cu, which reads
the logits through their strides (channels-last included, no copy):
its staged kernel where each pixel's classes are one 16-byte aligned
run, its strided kernel for every other layout; `sr_plan` chooses. On
CPU tensors the wrapper runs the plain version, ops/reduce.py
`semantic_score_idx`."""
import ctypes
import functools
from typing import Callable, NamedTuple, Tuple

import torch

from ..reduce import semantic_score_idx
from ._build import check, is_cuda_tensor, load_library, refuse_grad

_FUNCS = {torch.float32: 'semantic_score_idx_f32',
          torch.bfloat16: 'semantic_score_idx_bf16'}
RUN = 128                 # pixels a staged run (threads a block)
STAGES = 3                # runs a block keeps in flight
MAX_SMEM = 227 * 1024     # dynamic shared memory a block can take
STRIDED_THREADS = 128     # csrc STRIDED_THREADS
MAX_GRID_YZ = 65535


class SrPlan(NamedTuple):
    """The launch. 'staged': the logits' pixels form B H W / seg_len
    contiguous segments of seg_len pixels (a row, an image or all of
    them; segment s starts at image s // segs_per_img, row s %
    segs_per_img), each cut into runs_per_seg runs of `run` pixels;
    `blocks` persistent blocks of `run` threads walk the `tiles` runs
    with `stages` slots of slot_bytes in a ring of `smem` bytes.
    'strided': a thread a pixel on a (W / 128, H, B) grid."""
    path: str
    run: int
    stages: int
    seg_len: int
    segs_per_img: int
    runs_per_seg: int
    tiles: int
    blocks: int
    slot_bytes: int
    smem: int


def sr_plan(shape: Tuple[int, ...], strides: Tuple[int, ...], elt: int,
            aligned: bool, n_sm: int,
            blocks_per_sm: Callable[[int, int], int]) -> SrPlan:
    """The kernel for logits of `shape` (B, C, H, W) and `strides`
    (elements), `elt` bytes a value, whose storage starts 16-byte
    `aligned`:
    - 'staged' where a pixel's classes are contiguous (class stride 1,
      pixel stride C), C elt is a multiple of 16, the storage and the
      row and image strides are 16-byte aligned and STAGES runs fit
      MAX_SMEM; the segments are the longest contiguous pixel runs, the
      run RUN pixels, at most the segment rounded up to a warp, the
      grid one wave of `blocks_per_sm(run, smem)` blocks on each of
      `n_sm` SMs at most;
    - 'strided' otherwise."""
    B, C, H, W = shape
    sb, sc, sh, sw = strides
    n_px = B * H * W
    if n_px >= 2 ** 31:
        raise ValueError(f'semantic_argmax_score: {n_px} pixels exceed '
                         f'the kernels\' 32-bit pixel index')
    if sh == W * C or H == 1:
        seg_len, segs_per_img = (n_px, 1) if sb == H * W * C or B == 1 \
            else (H * W, 1)
    else:
        seg_len, segs_per_img = W, H
    run = min(RUN, -(-seg_len // 32) * 32)
    slot = -(-run * C * elt // 128) * 128
    staged = (sc == 1 and sw == C and C * elt % 16 == 0 and aligned
              and sh * elt % 16 == 0 and sb * elt % 16 == 0
              and STAGES * slot <= MAX_SMEM and n_px > 0)
    if not staged:
        if H > MAX_GRID_YZ or B > MAX_GRID_YZ:
            raise ValueError(f'semantic_argmax_score: H {H} and B {B} '
                             f'must be at most {MAX_GRID_YZ}')
        blocks = B * H * -(-W // STRIDED_THREADS)
        return SrPlan('strided', STRIDED_THREADS, 0, W, H,
                      -(-W // STRIDED_THREADS), blocks, blocks, 0, 0)
    runs_per_seg = -(-seg_len // run)
    tiles = n_px // seg_len * runs_per_seg
    smem = STAGES * slot
    blocks = min(tiles, n_sm * max(1, blocks_per_sm(run, smem)))
    return SrPlan('staged', run, STAGES, seg_len, segs_per_img,
                  runs_per_seg, tiles, blocks, slot, smem)


def semantic_argmax_score_reference(logits):
    """Plain PyTorch version: (idx int32, score f32), both (B, H, W)."""
    return semantic_score_idx(logits, dim=1)


@functools.lru_cache(maxsize=None)
def _fns(dtype):
    """(strided, staged, staged blocks an SM) entries of the library."""
    lib = load_library('semantic_reduce')
    name = _FUNCS[dtype]
    strided = getattr(lib, name)
    strided.restype = ctypes.c_int
    strided.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 \
        + [ctypes.c_longlong] * 4 + [ctypes.c_void_p]
    staged = getattr(lib, name + '_staged')
    staged.restype = ctypes.c_int
    staged.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] \
        + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    occ = getattr(lib, name + '_staged_blocks_per_sm')
    occ.restype, occ.argtypes = ctypes.c_int, [ctypes.c_int] * 3
    return strided, staged, occ


@functools.lru_cache(maxsize=256)
def _plan(shape, strides, dtype, aligned, device_index):
    _, _, occ = _fns(dtype)
    n_sm = torch.cuda.get_device_properties(
        device_index).multi_processor_count
    elt = torch.empty((), dtype=dtype).element_size()

    def blocks_per_sm(threads, smem):
        with torch.cuda.device(device_index):
            per_sm = occ(shape[1], threads, smem)
        if per_sm <= 0:
            raise RuntimeError(f'semantic_argmax_score: no occupancy for '
                               f'{smem} bytes of shared memory ({per_sm})')
        return per_sm

    return sr_plan(shape, strides, elt, aligned, n_sm, blocks_per_sm)


def plan_of(logits) -> SrPlan:
    """The plan the kernel takes for these CUDA logits."""
    return _plan(tuple(logits.shape), tuple(logits.stride()), logits.dtype,
                 logits.data_ptr() % 16 == 0, logits.device.index)


def _launch(logits):
    if logits.dim() != 4 or logits.dtype not in _FUNCS:
        raise ValueError(f'semantic_argmax_score takes (B, C, H, W) '
                         f'float32/bfloat16 logits, got '
                         f'{tuple(logits.shape)} {logits.dtype}')
    B, C, H, W = logits.shape
    idx = torch.empty((B, H, W), dtype=torch.int32, device=logits.device)
    score = torch.empty((B, H, W), dtype=torch.float32,
                        device=logits.device)
    if idx.numel() == 0 or C == 0:
        return idx, score
    plan = plan_of(logits)
    strided, staged, _ = _fns(logits.dtype)
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream().cuda_stream
        if plan.path == 'staged':
            sb, _, sh, _ = logits.stride()
            err = staged(logits.data_ptr(), idx.data_ptr(),
                         score.data_ptr(), C, sb, sh, plan.seg_len,
                         plan.segs_per_img, plan.runs_per_seg, plan.tiles,
                         plan.run, plan.stages, plan.slot_bytes,
                         plan.blocks, stream)
        else:
            err = strided(logits.data_ptr(), idx.data_ptr(),
                          score.data_ptr(), B, C, H, W, *logits.stride(),
                          stream)
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

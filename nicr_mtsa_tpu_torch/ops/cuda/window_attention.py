"""Whole Swin window-attention sub-block (counterpart of
nicr_mtsa_tpu/ops/pallas/window_attention.py
`fused_window_attention_block`): the qkv product, the v2 cosine
normalisation with the logit scale, the relative-position bias, the
shift mask, an f32 softmax, the product with V and the output
projection, for windows of N <= 64 tokens.

Two entries share the kernel and its launch counter:
- `window_attention_block` takes windows (Bw, N, C), the JAX
  function's interface;
- `window_attention_image` takes the Swin block's (B, H, W, C) image
  and does the zero pad to window multiples, the cyclic shift (disabled
  on an axis one window covers) and the window partition, and their
  inverses, in the kernel's addressing: no padded, rolled or
  partitioned copies. This is the entry the Swin backbone calls.

On the card the work is done by csrc/window_attention_block.cu, which
also computes the qkv and output-projection products itself (in bf16
two kernels a call: qkv and attention per (window, head), then the
projection as a tiled GEMM over all windows' rows); on CPU tensors the
wrappers run the plain versions, `window_attention_block_reference` and
`window_attention_image_reference`. Both round at the TPU kernel's
points. The shift mask follows `shift_region_ids`: the kernel derives
each token's region from the window's grid position instead of reading
an (nW, N, N) mask. The bf16 image entry finds each token's pixel in
`image_token_rows`, a table cached per image shape."""
import ctypes
import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from ._build import check, is_cuda_tensor, load_library, refuse_grad

_FUNCS = {torch.float32: 'window_attention_block_f32',
          torch.bfloat16: 'window_attention_block_bf16'}
HEAD_DIM = 32                  # the kernel's head width
KC = 64                        # the bf16 kernels' K chunk
PROJ_BN = 128                  # the projection kernel's output columns a tile


def window_partition(x, ws: int):
    """(B, H, W, C) -> (B * H//ws * W//ws, ws*ws, C)."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // ws, ws, W // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, C)


def window_unpartition(windows, ws: int, H: int, W: int):
    """Inverse of window_partition."""
    B = windows.shape[0] // (H // ws * W // ws)
    x = windows.reshape(B, H // ws, W // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, -1)


def image_windows(H: int, W: int, ws: int, shift: int):
    """(pad_h, pad_w, (nWh, nWw), (shift_h, shift_w)) of a Swin block on
    an H x W image: padded to window multiples, the shift disabled on
    an axis that one window covers."""
    pad_h, pad_w = (ws - H % ws) % ws, (ws - W % ws) % ws
    Hp, Wp = H + pad_h, W + pad_w
    return (pad_h, pad_w, (Hp // ws, Wp // ws),
            (shift if ws < Hp else 0, shift if ws < Wp else 0))


def shift_region_ids(grid_hw: Tuple[int, int], ws: int,
                     shift: Tuple[int, int], device=None) -> torch.Tensor:
    """(nW, ws * ws) int64 shift region of every token of the padded
    image's window grid (the JAX package's `_shift_attn_mask` regions):
    per axis, positions below Hp - ws are region 0, below Hp - shift
    region 1, the rest region 2; an axis with no shift is all region 2."""
    nWh, nWw = grid_hw

    def axis(n, s):
        pos = torch.arange(n, device=device)
        if s == 0:
            return torch.full((n,), 2, device=device)
        return torch.where(pos < n - ws, 0, torch.where(pos < n - s, 1, 2))

    img = axis(nWh * ws, shift[0])[:, None] * 3 \
        + axis(nWw * ws, shift[1])[None, :]
    return img.reshape(nWh, ws, nWw, ws).permute(0, 2, 1, 3).reshape(
        nWh * nWw, ws * ws)


@functools.lru_cache(maxsize=32)
def image_token_rows(B: int, H: int, W: int, ws: int, shift: int,
                     device=None) -> torch.Tensor:
    """(B * nWh * nWw * ws * ws,) int32: the pixel b H W + y W + x of a
    (B, H, W, C) image that each token of the Swin block's windows reads
    (zero pad to window multiples, cyclic shift as `image_windows`
    gives it, window partition; windows in image-major, then row-major
    grid order), -1 for a token of the zero pad. The kernels' row table
    of the image entry; cached per shape."""
    pad_h, pad_w, _, (sh, sw) = image_windows(H, W, ws, shift)
    idx = torch.arange(B * H * W, dtype=torch.int32, device=device)
    idx = F.pad(idx.view(B, H, W, 1), (0, 0, 0, pad_w, 0, pad_h), value=-1)
    if sh or sw:
        idx = torch.roll(idx, (-sh, -sw), dims=(1, 2))
    return window_partition(idx, ws).reshape(-1).contiguous()


def shift_attn_mask(grid_hw, ws: int, shift, device=None) -> torch.Tensor:
    """(nW, N, N) f32 additive mask: -100 between tokens of different
    shift regions, else 0."""
    ids = shift_region_ids(grid_hw, ws, shift, device)
    return torch.where(ids[:, :, None] != ids[:, None, :], -100.0,
                       0.0).float()


def attention_from_qkv(qkv, bias, n_heads: int, grid_hw=(1, 1),
                       shift: Optional[Tuple[int, int]] = None,
                       v2_scale=None):
    """Plain PyTorch attention over the packed qkv (Bw, N, 3C), its last
    axis (3, h, d), at the TPU kernels' rounding points: (v2) q and k
    divided by max(||.||, 1e-6) in f32 and rounded; f32 logits x the
    scale, + bias, + the shift mask; f32 softmax rounded to qkv's dtype;
    the product with v in f32, rounded. Returns (Bw, N, C); shared by
    the plain versions of the sub-block and of
    window_attention_qkv.py."""
    Bw, N, C3 = qkv.shape
    h, dt = n_heads, qkv.dtype
    C = C3 // 3
    d = C // h
    q, k, v = qkv.reshape(Bw, N, 3, h, d).permute(2, 0, 3, 1, 4)
    if v2_scale is not None:
        def cos_norm(t):
            t32 = t.float()
            nrm = torch.sqrt((t32 * t32).sum(-1, keepdim=True))
            return (t32 / nrm.clamp_min(1e-6)).to(dt)
        q, k = cos_norm(q), cos_norm(k)
        scale = v2_scale.float().view(1, h, 1, 1)
    else:
        scale = float(d) ** -0.5
    logits = (q.float() @ k.float().transpose(-1, -2)) * scale \
        + bias.float()[None]
    if shift is not None:
        mask = shift_attn_mask(grid_hw, math.isqrt(N), shift, qkv.device)
        nW = mask.shape[0]
        logits = (logits.view(Bw // nW, nW, h, N, N)
                  + mask[None, :, None]).view(Bw, h, N, N)
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    p = (e / e.sum(-1, keepdim=True)).to(dt)
    return (p.float() @ v.float()).to(dt).transpose(1, 2).reshape(Bw, N, C)


def window_attention_block_reference(x, wqkv, bqkv, wproj, bproj, bias,
                                     n_heads: int, grid_hw=(1, 1),
                                     shift: Optional[Tuple[int, int]] = None,
                                     v2_scale=None):
    """Plain PyTorch version (see `window_attention_block`)."""
    dt = x.dtype
    qkv = (x.float() @ wqkv.to(dt).float()).to(dt) + bqkv.to(dt)
    o = attention_from_qkv(qkv, bias, n_heads, grid_hw, shift, v2_scale)
    return (o.float() @ wproj.to(dt).float()).to(dt) + bproj.to(dt)


def window_attention_image_reference(x, wqkv, bqkv, wproj, bproj, bias,
                                     n_heads: int, ws: int, shift: int = 0,
                                     v2_scale=None):
    """Plain PyTorch version of `window_attention_image`: pad, roll,
    partition, the sub-block, and back."""
    B, H, W, C = x.shape
    pad_h, pad_w, grid_hw, (sh, sw) = image_windows(H, W, ws, shift)
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    if sh or sw:
        x = torch.roll(x, (-sh, -sw), dims=(1, 2))
    windows = window_attention_block_reference(
        window_partition(x, ws), wqkv, bqkv, wproj, bproj, bias, n_heads,
        grid_hw, (sh, sw) if sh or sw else None, v2_scale)
    y = window_unpartition(windows, ws, H + pad_h, W + pad_w)
    if sh or sw:
        y = torch.roll(y, (sh, sw), dims=(1, 2))
    return y[:, :H, :W] if pad_h or pad_w else y


def pack_wqkv(wqkv, n_heads: int) -> torch.Tensor:
    """(C, 3C) -> (h, ceil(C / 64), 64 * 96): for each head j and chunk of
    64 rows, the q_j, k_j and v_j columns as one contiguous tile in the
    bf16 kernel's shared-memory layout of the B operand (8 x 8 core
    matrices, core (k / 8, n / 8) at (k / 8) 12 + n / 8; rows past C
    zero)."""
    C = wqkv.shape[0]
    nK = -(-C // KC)
    w = F.pad(wqkv, (0, 0, 0, nK * KC - C))
    # k = (chunk, core row, row in core); n = (part, head, core, column)
    w = w.reshape(nK, KC // 8, 8, 3, n_heads, HEAD_DIM // 8, 8)
    return w.permute(4, 0, 1, 3, 5, 2, 6).reshape(n_heads, nK, -1)


def pack_wproj(wproj) -> torch.Tensor:
    """(C, C) -> (ceil(C / 128), ceil(C / 64), 64 * 128): for each tile of
    128 output columns and chunk of 64 rows, one contiguous tile in the
    projection kernel's shared-memory layout (as `pack_wqkv`, 16 cores a
    core row; padding zero)."""
    C = wproj.shape[0]
    nK, nN = -(-C // KC), -(-C // PROJ_BN)
    w = F.pad(wproj, (0, nN * PROJ_BN - C, 0, nK * KC - C))
    w = w.reshape(nK, KC // 8, 8, nN, PROJ_BN // 8, 8)
    return w.permute(3, 0, 1, 4, 2, 5).reshape(nN, nK, -1)


_PACKED = WeakIdKeyDictionary()


def _packed(w, dt, n_heads=None):
    """`pack_wqkv(w, n_heads)` (or with n_heads None `pack_wproj(w)`) in
    dtype dt, cached per weight tensor, dtype and version: the Swin
    blocks pass the same weights every call. An inference tensor has no
    version counter and is taken as unchanged while it lives (the
    model's cached weights are new tensors whenever a parameter
    changes)."""
    key = (dt, n_heads)
    version = None if w.is_inference() else w._version
    entry = _PACKED.setdefault(w, {})
    hit = entry.get(key)
    if hit is None or hit[0] != version:
        wt = w.to(dt)
        packed = pack_wproj(wt) if n_heads is None else pack_wqkv(wt, n_heads)
        hit = entry[key] = (version, packed.contiguous())
    return hit[1]


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    fn = getattr(load_library('window_attention_block'), name)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 11 \
        + [ctypes.c_float, ctypes.c_void_p]
    return fn


def _launch(x, wqkv, bqkv, wproj, bproj, bias, n_heads, ws, grid_hw, shift,
            v2_scale, image_shift=None):
    """x: windows (Bw, N, C), or with `image_shift` (the block's shift)
    the (B, H, W, C) image."""
    C, N = x.shape[-1], ws * ws
    if x.dtype not in _FUNCS or N > 64 or C != n_heads * HEAD_DIM:
        raise ValueError(f'window_attention_block takes (Bw, N <= 64 square, '
                         f'C = 32 * n_heads) float32/bfloat16 windows, got '
                         f'{tuple(x.shape)} {x.dtype} with {n_heads} heads')
    if tuple(bias.shape) != (n_heads, N, N):
        raise ValueError(f'window_attention_block: bias must be '
                         f'({n_heads}, {N}, {N}), got {tuple(bias.shape)}')
    dt, dev = x.dtype, x.device
    image = image_shift is not None
    sh, sw = shift if shift is not None else (0, 0)
    nWh, nWw = grid_hw
    Bw = x.shape[0] * nWh * nWw if image else x.shape[0]
    img_h, img_w = x.shape[1:3] if image else (0, 0)
    if (sh or sw) and Bw % (nWh * nWw):
        raise ValueError(f'window_attention_block: {Bw} windows are not '
                         f'whole images of a {nWh} x {nWw} window grid')
    fn = _entry(_FUNCS[dt])
    x = x.contiguous()
    if x.data_ptr() % 16:               # the kernels load 16-byte vectors
        x = x.clone()
    rows = (image_token_rows(x.shape[0], img_h, img_w, ws, image_shift, dev)
            if image and dt == torch.bfloat16 else None)
    if dt == torch.bfloat16:     # the kernels' tiled weight layouts
        wqkv = _packed(wqkv.to(dev), dt, n_heads)
        wproj = _packed(wproj.to(dev), dt)
    else:
        wqkv = wqkv.to(device=dev, dtype=dt).contiguous()
        wproj = wproj.to(device=dev, dtype=dt).contiguous()
    # biases in f32: the kernels round them to the compute dtype
    bqkv = bqkv.to(device=dev, dtype=torch.float32).contiguous()
    bproj = bproj.to(device=dev, dtype=torch.float32).contiguous()
    bias = bias.to(device=dev, dtype=torch.float32).contiguous()
    scale = (None if v2_scale is None else
             v2_scale.to(device=dev, dtype=torch.float32).contiguous())
    attn = torch.empty((Bw, N, C), dtype=dt, device=dev)  # concat heads
    out = torch.empty_like(x)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), None if rows is None else rows.data_ptr(),
                 wqkv.data_ptr(), bqkv.data_ptr(),
                 wproj.data_ptr(), bproj.data_ptr(), bias.data_ptr(),
                 None if scale is None else scale.data_ptr(),
                 attn.data_ptr(), out.data_ptr(), Bw, N, C, n_heads, ws,
                 nWh, nWw, sh, sw, img_h, img_w, float(C // n_heads) ** -0.5,
                 stream)
    check(err, 'window_attention_block')
    window_attention_block.launches += 1
    return out


def window_attention_block(x, wqkv, bqkv, wproj, bproj, bias, n_heads: int,
                           grid_hw: Tuple[int, int] = (1, 1),
                           shift: Optional[Tuple[int, int]] = None,
                           v2_scale=None):
    """proj(attention(qkv(x))) of windows x (Bw, N, C): wqkv (C, 3C),
    bqkv (3C,) (v2: the k third already zeroed), wproj (C, C), bproj
    (C,), bias (h, N, N) additive query-major, `shift` None for an
    unshifted block else (shift_h, shift_w) on the (nWh, nWw) window
    grid `grid_hw` of the padded image (windows in image-major, then
    row-major grid order), `v2_scale` (h,) f32 logit scales for v2
    cosine attention or None (v1: d^-0.5). Returns (Bw, N, C) in x's
    dtype. CUDA tensors go to the kernel; CPU tensors to the plain
    version."""
    if not is_cuda_tensor(x):
        return window_attention_block_reference(
            x, wqkv, bqkv, wproj, bproj, bias, n_heads, grid_hw, shift,
            v2_scale)
    refuse_grad('window_attention_block', x, wqkv, bqkv, wproj, bproj, bias,
                v2_scale)
    ws = math.isqrt(x.shape[1])
    if ws * ws != x.shape[1]:
        raise ValueError(f'window_attention_block: {x.shape[1]} tokens are '
                         f'not a square window')
    return _launch(x, wqkv, bqkv, wproj, bproj, bias, n_heads, ws,
                   tuple(grid_hw), shift, v2_scale)


window_attention_block.launches = 0


def window_attention_image(x, wqkv, bqkv, wproj, bproj, bias, n_heads: int,
                           ws: int, shift: int = 0, v2_scale=None):
    """The Swin block's attention part on its (B, H, W, C) image: zero
    pad to multiples of the window size `ws`, cyclic shift by `shift`
    (0 for an unshifted block; disabled on an axis one window covers),
    window partition, `window_attention_block`, and the inverses.
    Returns (B, H, W, C). CUDA tensors go to the kernel (no copies of
    the image; one launch, counted on `window_attention_block`); CPU
    tensors to the plain version."""
    if not is_cuda_tensor(x):
        return window_attention_image_reference(
            x, wqkv, bqkv, wproj, bproj, bias, n_heads, ws, shift, v2_scale)
    refuse_grad('window_attention_image', x, wqkv, bqkv, wproj, bproj, bias,
                v2_scale)
    _, _, grid_hw, (sh, sw) = image_windows(x.shape[1], x.shape[2], ws, shift)
    return _launch(x, wqkv, bqkv, wproj, bproj, bias, n_heads, ws, grid_hw,
                   (sh, sw) if sh or sw else None, v2_scale, shift)

"""The upsampling modes (learned-3x3-zeropad, learned-3x3, bilinear,
nearest) and the deferred two-stage forms (counterpart of
nicr_mtsa_tpu/models/upsampling.py).

`learned-3x3-zeropad` is nearest x2 followed by a zero-padded depthwise
3x3 conv. Its fused form is one input-dilated depthwise conv with a
4x4 kernel built from the 3x3 one by exact adds (`_phase_combine`);
here that conv is a `conv_transpose2d` with the flipped 4x4 kernel.

`DeferredUpsampling` carries the semantic head's last prediction
upsampling as data and `DeferredUpsampling2` its two, so
postprocessing can fuse them with the argmax and score reduction
(ops/cuda/finisher2x.py, ops/cuda/finisher4x.py); `DeferredBilinear2`
does the same for two half-pixel bilinear x2 upsamplings (the MLP
decoders' semantic head), which are nearest x2 + a replication-padded
depthwise 3x3 with the fixed bilinear kernel. `zeropad2x_logits_exact`
and `finisher4x_logits_exact` are the dense forms with those kernels'
exact rounding order (`apply_deferred_upsampling_exact` picks the one
of a deferred marker); both build their last stage with
`_zeropad_phases`. All tensors here are NCHW; depthwise kernels are
(C, 1, 3, 3).

`resize_bilinear` / `resize_nearest` resize the last two axes to a
full resolution (the JAX package's `resize_bilinear` and
`resize_nearest`); their tap tables are computed on the host in float64
numpy exactly as `_two_tap_params` does there."""
from functools import lru_cache
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .common import Conv2d, cached_weight

_BILINEAR_KERNEL = ((0.0625, 0.1250, 0.0625),
                    (0.1250, 0.2500, 0.1250),
                    (0.0625, 0.1250, 0.0625))


class DeferredBilinear2(NamedTuple):
    """Two chained half-pixel bilinear x2 upsamplings captured as data
    (parameter-free: only the quarter-res logits)."""
    x: torch.Tensor                  # (B, C, H, W) quarter-res logits


class DeferredUpsampling(NamedTuple):
    """One learned-3x3-zeropad x2 upsampling captured as data."""
    x: torch.Tensor                  # (B, C, H, W) half-res logits
    kernel: torch.Tensor             # (C, 1, 3, 3) f32
    bias: Optional[torch.Tensor]     # (C,) f32 or None


class DeferredUpsampling2(NamedTuple):
    """Two chained learned-3x3-zeropad x2 upsamplings captured as data."""
    x: torch.Tensor                  # (B, C, H, W) quarter-res logits
    kernel1: torch.Tensor            # (C, 1, 3, 3) f32
    bias1: Optional[torch.Tensor]    # (C,) f32 or None
    kernel2: torch.Tensor
    bias2: Optional[torch.Tensor]


# every deferred-upsampling marker a postprocessor may receive in place
# of a dense output tensor
DEFERRED_TYPES = (DeferredUpsampling, DeferredUpsampling2, DeferredBilinear2)


def _phase_combine(k, dim: int):
    """Kernel axis of 3 -> the 4 zeropad-x2 phase rows
    [K0, K0+K1, K1+K2, K2], built with exact adds (never a matmul)."""
    k0, k1, k2 = (k.narrow(dim, i, 1) for i in range(3))
    return torch.cat([k0, k0 + k1, k1 + k2, k2], dim=dim)


def fused_zeropad_2x_kernel(kernel):
    """(C, 1, 3, 3) depthwise kernel -> the fused (C, 1, 4, 4) kernel
    of the input-dilated one-conv form; rows first, then columns, in
    f32 (the JAX package's order)."""
    return _phase_combine(_phase_combine(kernel.float(), 2), 3)


def _round(t, dt):
    """Round f32 values to the compute dtype and back to f32."""
    return t.to(dt).float()


def _bias_f32(bias, C, dt, device):
    if bias is None:
        return torch.zeros(1, C, 1, 1, device=device)
    return _round(bias, dt).view(1, C, 1, 1)


def bilinear_kernel(n_channels: int, device=None):
    """The fixed bilinear depthwise kernel, (C, 1, 3, 3) f32."""
    k = torch.tensor(_BILINEAR_KERNEL, dtype=torch.float32, device=device)
    return k.view(1, 1, 3, 3).repeat(n_channels, 1, 1, 1)


def _tap(k, i: int, j: int):
    """Tap (i, j) of a (C, 4, 4) fused kernel as a (1, C, 1, 1) tensor."""
    return k[:, i, j].view(1, -1, 1, 1)


def _zeropad_phases(xp, kt, bias, dt):
    """One learned-3x3-zeropad x2 stage on the padded f32 input xp
    (B, C, H + 2, W + 2): output phase (py, px) is the four taps
    kt[2a + py, 2b + px] * xp[py + a + i, px + b + j] multiplied and
    summed in f32 in (a, b) order, rounded to `dt`, plus the f32 `bias`
    (1, C, 1, 1), rounded again. kt: (C, 4, 4) f32 values rounded to
    `dt`. Returns (B, C, 2H, 2W) in `dt`."""
    B, C, Hp, Wp = xp.shape
    H, W = Hp - 2, Wp - 2
    out = xp.new_empty((B, C, 2 * H, 2 * W), dtype=dt)
    for py in (0, 1):
        for px in (0, 1):
            acc = None
            for a in (0, 1):
                for b in (0, 1):
                    t = _tap(kt, 2 * a + py, 2 * b + px) \
                        * xp[:, :, py + a:py + a + H, px + b:px + b + W]
                    acc = t if acc is None else acc + t
            out[:, :, py::2, px::2] = (_round(acc, dt) + bias).to(dt)
    return out


def zeropad2x_logits_exact(x, kernel, bias):
    """Dense (B, C, 2H, 2W) logits of one learned-3x3-zeropad x2 stage
    with the 2x finisher's exact numerics (`_zeropad_phases` on the
    zero-padded input, the fused 4x4 kernel rounded to x's dtype).
    Returns x's dtype."""
    C, dt = x.shape[1], x.dtype
    kt = _round(fused_zeropad_2x_kernel(kernel)[:, 0], dt)   # (C, 4, 4)
    return _zeropad_phases(F.pad(x, (1, 1, 1, 1)).float(), kt,
                           _bias_f32(bias, C, dt, x.device), dt)


def finisher4x_logits_exact(x, kernel1, bias1, kernel2, bias2,
                            edge: bool = False):
    """Dense (B, C, 4H, 4W) logits with the 4x finisher's exact
    numerics: per output phase, the four taps multiplied and summed in
    f32 in (a, b) order; rounded to x's dtype; the (rounded) bias added
    in f32; at stage 1 the zero-pad ring of stage 2 applied after the
    bias (zeropad chain) or, with `edge`, the input edge-padded and no
    ring (bilinear chain); rounded again. Returns x's dtype."""
    B, C, H, W = x.shape
    dt = x.dtype
    k1t = _round(fused_zeropad_2x_kernel(kernel1)[:, 0], dt)  # (C, 4, 4)
    k2t = _round(fused_zeropad_2x_kernel(kernel2)[:, 0], dt)
    b1 = _bias_f32(bias1, C, dt, x.device)
    b2 = _bias_f32(bias2, C, dt, x.device)
    xp = (F.pad(x.float(), (1, 1, 1, 1), mode='replicate') if edge
          else F.pad(x, (1, 1, 1, 1)).float())

    # stage 1 incl. the stage-2 halo ring: phase (py, px) at H+1 rows
    # and W+1 cols lands on inter[2r + 1 - py, 2s + 1 - px]
    inter = x.new_empty((B, C, 2 * H + 2, 2 * W + 2), dtype=torch.float32)
    for py in (0, 1):
        for px in (0, 1):
            acc = None
            for a in (0, 1):
                for b in (0, 1):
                    t = _tap(k1t, 2 * a + py, 2 * b + px) \
                        * xp[:, :, a:a + H + 1, b:b + W + 1]
                    acc = t if acc is None else acc + t
            inter[:, :, 1 - py::2, 1 - px::2] = acc
    inter = _round(inter, dt) + b1
    if not edge:
        inter[:, :, 0] = 0.0
        inter[:, :, -1] = 0.0
        inter[:, :, :, 0] = 0.0
        inter[:, :, :, -1] = 0.0
    # stage 2 is one zeropad x2 stage on the rounded, ringed plane
    return _zeropad_phases(_round(inter, dt), k2t, b2, dt)


def apply_deferred_upsampling_exact(d):
    """The dense logits of a deferred upsampling with the numerics of
    the finisher that reduces it (`zeropad2x_logits_exact` for one
    learned stage, `finisher4x_logits_exact` for two, with `edge` and
    the fixed kernel for the bilinear pair): their argmax is the
    finisher's idx, bf16 ties included."""
    if isinstance(d, DeferredBilinear2):
        k = bilinear_kernel(d.x.shape[1], d.x.device)
        return finisher4x_logits_exact(d.x, k, None, k, None, edge=True)
    if isinstance(d, DeferredUpsampling2):
        return finisher4x_logits_exact(d.x, d.kernel1, d.bias1, d.kernel2,
                                       d.bias2)
    return zeropad2x_logits_exact(d.x, d.kernel, d.bias)


def two_tap_params(n: int, m: int):
    """Taps and weights of a half-pixel 2-tap linear resize n -> m
    (torch F.interpolate bilinear, align_corners=False): output j is
    w0[j] * x[lo[j]] + w1[j] * x[hi[j]] with lo = clip(i0), hi =
    clip(i0 + 1), w1 = f = f32(src - i0) and w0 = f32(1 - f) formed in
    float64 (the JAX package's `1.0 - w` on a Python float)."""
    j = np.arange(m)
    src = (j + 0.5) * (n / m) - 0.5
    i0 = np.floor(src).astype(np.int64)
    f = (src - i0).astype(np.float32)
    w0 = (1.0 - f.astype(np.float64)).astype(np.float32)
    return np.clip(i0, 0, n - 1), np.clip(i0 + 1, 0, n - 1), w0, f


@lru_cache(maxsize=64)
def _tap_tensors(n: int, m: int, device, dtype):
    """`two_tap_params(n, m)` as tensors on `device` (weights in `dtype`),
    built once: a serving request resizes the same shapes every time.
    Built outside inference mode even when first asked for inside it,
    so a training step can save the weights for its backward."""
    lo, hi, w0, w1 = two_tap_params(n, m)
    if dtype == torch.float64:
        # a float64 run forms 1 - w in float64, as the JAX package's
        # `1.0 - w` (a Python float) stays under x64 (its periodic
        # resize; only a period above 32, which no float64 path here
        # meets, takes its f32 dense form)
        w0 = 1.0 - w1.astype(np.float64)
    with torch.inference_mode(False):
        return (torch.from_numpy(lo).to(device),
                torch.from_numpy(hi).to(device),
                torch.from_numpy(w0).to(device=device, dtype=dtype),
                torch.from_numpy(w1).to(device=device, dtype=dtype))


def _resize_axis_linear(x, m: int, dim: int):
    n = x.shape[dim]
    if m == n:
        return x
    lo, hi, w0, w1 = _tap_tensors(n, m, x.device, x.dtype)
    shape = [1] * x.ndim
    shape[dim] = m
    # three roundings in x's dtype: a * w0, b * w1, their sum (no FMA)
    return (x.index_select(dim, lo) * w0.view(shape)
            + x.index_select(dim, hi) * w1.view(shape))


def resize_bilinear(x, height: int, width: int):
    """Half-pixel bilinear resize of the last two axes (rows, then
    columns), in x's dtype (the JAX package's weak-typed `a * (1 - w) +
    b * w`: the weights, multiples of 1/16 for x2-x8, are exact in
    bf16)."""
    return _resize_axis_linear(_resize_axis_linear(x, height, -2),
                               width, -1)


def _resize_axis_nearest(x, m: int, dim: int):
    n = x.shape[dim]
    if m == n:
        return x
    idx = (np.arange(m) * n) // m          # floor(j * n / m), in range
    return x.index_select(dim, torch.from_numpy(idx).to(x.device))


def resize_nearest(x, height: int, width: int):
    """Nearest resize of the last two axes with the floor(i * src / dst)
    index map (exact for label maps)."""
    return _resize_axis_nearest(_resize_axis_nearest(x, height, -2),
                                width, -1)


KNOWN_UPSAMPLING_METHODS = ('nearest', 'bilinear', 'learned-3x3',
                            'learned-3x3-zeropad')


def upsample_nearest_2x(x):
    """Nearest x2 of the last two axes (each value repeated 2 x 2)."""
    return F.interpolate(x, scale_factor=2, mode='nearest')


class Upsampling(nn.Module):
    """Upsampling by `scale_factor` of one of the JAX package's modes:
    - `learned-3x3-zeropad` (x2): nearest x2 + zero-padded depthwise 3x3
      + bias, as one conv_transpose2d with the flipped fused 4x4 kernel;
      weight (C, 1, 3, 3) initialised to the bilinear kernel, bias zero;
    - `learned-3x3` (x2): nearest x2, an edge (replication) pad, then a
      depthwise 3x3 conv `conv` (weight and bias; the bilinear kernel
      at init): another parameter tree than the zeropad mode's;
    - `bilinear`: a half-pixel resize (`resize_bilinear`);
    - `nearest`: nearest x2, or the floor(i * src / dst) resize for
      other factors (`resize_nearest`).
    The two parameter-free modes take any factor (1 is the identity)."""

    def __init__(self, mode: str, n_channels: int, use_bias: bool = True,
                 scale_factor: int = 2):
        super().__init__()
        mode = mode.lower()
        if mode not in KNOWN_UPSAMPLING_METHODS:
            raise ValueError(f"Unknown upsampling: '{mode}'")
        self.mode = mode
        self.scale_factor = int(scale_factor)
        if mode in ('bilinear', 'nearest'):
            return
        if self.scale_factor != 2:
            raise ValueError(f"'{mode}' upsampling is x2 only, not "
                             f"x{scale_factor}")
        if mode == 'learned-3x3':
            self.conv = Conv2d(n_channels, n_channels, 3, padding=0,
                               groups=n_channels, use_bias=use_bias)
            with torch.no_grad():
                self.conv.weight.copy_(bilinear_kernel(n_channels))
            return
        self.weight = nn.Parameter(bilinear_kernel(n_channels))
        self.bias = (nn.Parameter(torch.zeros(n_channels)) if use_bias
                     else None)

    def forward(self, x):
        f = self.scale_factor
        if self.mode == 'bilinear':
            return resize_bilinear(x, f * x.shape[-2], f * x.shape[-1])
        if self.mode == 'nearest':
            if f == 2:
                return upsample_nearest_2x(x)
            return resize_nearest(x, f * x.shape[-2], f * x.shape[-1])
        if self.mode == 'learned-3x3':
            x = F.pad(upsample_nearest_2x(x), (1, 1, 1, 1), mode='replicate')
            return self.conv(x)
        dt = x.dtype
        kt = cached_weight(self, 'weight', dt,
                           lambda w: fused_zeropad_2x_kernel(w).flip(2, 3))
        return F.conv_transpose2d(x, kt, cached_weight(self, 'bias', dt),
                                  stride=2, padding=1, groups=x.shape[1])

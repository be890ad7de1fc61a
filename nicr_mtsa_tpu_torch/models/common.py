"""Shared model building blocks: conv, BatchNorm, the LayerNorm over the
last axis, the LayerNorm over the channels of conv models (`ln`), a
Dense layer, ConvNormAct, SqueezeAndExcitation (counterpart of
nicr_mtsa_tpu/models/common.py).

Parameters stay float32; every module casts its weights to the dtype
of its input (once, then cached; inside the autograd graph, uncached,
where grad is on), as the flax modules compute in a threaded `dtype`
with f32 masters. Training mode is `nn.Module.train()`: BatchNorm then
normalises with batch statistics and updates its running ones,
`FusedLayerNorm` runs its differentiable plain version, and `Dropout`
draws its mask from the generator it is called with. Submodule and
parameter names follow the flax names (`conv`, `norm`, `fc1`, ...) so
utils/flax_weights.py maps the trees mechanically. Initialisation:
He fan-out normal for convs (torch's kaiming_normal_(mode='fan_out',
nonlinearity='relu')), BN and LN identity."""
import math
from typing import Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.dtypes import upcast
from .remat import recomputing

KNOWN_NORMALIZATIONS = ('bn', 'batchnorm', 'ln', 'layernorm')
KNOWN_ACTIVATIONS = ('relu', 'silu', 'swish')

_Pair = Union[int, Tuple[int, int]]


def _pair(v: _Pair) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def cached_weight(module: nn.Module, name: str, dtype, build=None):
    """Parameter or buffer `name` of `module`, passed through `build`
    and cast to `dtype`, cached until it is modified in place or moved:
    a forward pass would otherwise launch one cast per weight (about
    1200 copies per serving request). Each transform (`build`'s code)
    has its own slot, apart from the plain cast. Where grad is on and
    the parameter requires it, the cast is built inside the autograd
    graph every call and not cached, so the parameter gets its
    gradient."""
    p = getattr(module, name)
    if p is None:
        return None
    if torch.is_grad_enabled() and p.requires_grad:
        return (p if build is None else build(p)).to(dtype)
    key = (dtype, p.device, p.data_ptr(), p._version)
    slot = name if build is None else (name, build.__code__)
    cache = module.__dict__.setdefault('_weight_cache', {})
    hit = cache.get(slot)
    if hit is None or hit[0] != key:
        with torch.no_grad():
            t = (p if build is None else build(p)).to(dtype).detach()
        hit = cache[slot] = (key, t)
    return hit[1]


def get_activation(name: Optional[str] = None):
    name = (name or 'relu').lower()
    if name not in KNOWN_ACTIVATIONS:
        raise ValueError(f"Unknown activation: '{name}'")
    return F.relu if name == 'relu' else F.silu


def get_normalization_name(name: Optional[str] = None) -> str:
    """'batchnorm' or 'layernorm' for a registry name."""
    name = (name or 'batchnorm').lower()
    if name not in KNOWN_NORMALIZATIONS:
        raise ValueError(f"Unknown normalization: '{name}'")
    return 'batchnorm' if name in ('bn', 'batchnorm') else 'layernorm'


def make_norm(name: Optional[str], n_channels: int,
              zero_init_scale: bool = False) -> nn.Module:
    """The channel normalization of conv models named `name` (the JAX
    package's `Norm`): BatchNorm, or ChannelLayerNorm for 'ln'; with
    `zero_init_scale` its scale starts at 0 (zero-residual init)."""
    cls = (BatchNorm if get_normalization_name(name) == 'batchnorm'
           else ChannelLayerNorm)
    norm = cls(n_channels)
    if zero_init_scale:
        with torch.no_grad():
            norm.weight.zero_()
    return norm


class Conv2d(nn.Module):
    """NCHW conv with explicit (torch-style) padding; weight OIHW."""

    def __init__(self, n_in: int, n_out: int, kernel_size: _Pair = 3,
                 stride: _Pair = 1, padding: Optional[_Pair] = None,
                 dilation: _Pair = 1, groups: int = 1,
                 use_bias: bool = False, generator=None):
        super().__init__()
        kh, kw = _pair(kernel_size)
        dh, dw = _pair(dilation)
        if padding is None:
            padding = (kh // 2 + dh - 1, kw // 2 + dw - 1)
        self.stride = _pair(stride)
        self.padding = _pair(padding)
        self.dilation = (dh, dw)
        self.groups = groups
        self.weight = nn.Parameter(
            torch.empty(n_out, n_in // groups, kh, kw))
        self.bias = (nn.Parameter(torch.zeros(n_out)) if use_bias
                     else None)
        std = math.sqrt(2.0 / (n_out * kh * kw))
        with torch.no_grad():
            self.weight.normal_(0.0, std, generator=generator)

    def forward(self, x):
        dt = x.dtype
        return F.conv2d(x, cached_weight(self, 'weight', dt),
                        cached_weight(self, 'bias', dt), self.stride,
                        self.padding, self.dilation, self.groups)


class BatchNorm(nn.Module):
    """BatchNorm over the channel axis of NCHW tensors (eps 1e-5,
    momentum 0.9, as the flax `Norm`); running statistics are buffers.
    Training mode follows flax's `nn.BatchNorm`: f32 batch statistics
    over (N, H, W) with the fast variance E[x^2] - E[x]^2 clamped at 0,
    y = (x - mean) * (rsqrt(var + eps) * weight) + bias in f32, one cast
    to x's dtype; the running statistics move by ra = 0.9 ra + 0.1 batch
    with the biased variance (`F.batch_norm` would use the unbiased
    one), once a step: not in a block's recompute (models/remat.py)."""
    momentum = 0.9

    def __init__(self, n_channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(n_channels))
        self.bias = nn.Parameter(torch.zeros(n_channels))
        self.register_buffer('running_mean', torch.zeros(n_channels))
        self.register_buffer('running_var', torch.ones(n_channels))

    def forward(self, x):
        if self.training:
            return self._train_forward(x)
        dt = x.dtype
        return F.batch_norm(
            x, cached_weight(self, 'running_mean', dt),
            cached_weight(self, 'running_var', dt),
            cached_weight(self, 'weight', dt),
            cached_weight(self, 'bias', dt), False, 0.0, self.eps)

    def _train_forward(self, x):
        x32 = upcast(x)
        mean = x32.mean(dim=(0, 2, 3))
        var = ((x32 * x32).mean(dim=(0, 2, 3)) - mean * mean).clamp_min(0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x32 - mean.view(1, -1, 1, 1)) * mul.view(1, -1, 1, 1) \
            + self.bias.view(1, -1, 1, 1)
        if recomputing():
            return y.to(x.dtype)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.copy_(m * self.running_mean
                                    + (1.0 - m) * mean.detach())
            self.running_var.copy_(m * self.running_var
                                   + (1.0 - m) * var.detach())
        return y.to(x.dtype)


class ChannelLayerNorm(nn.Module):
    """LayerNorm over the channel axis 1 of NCHW tensors, the `ln`
    normalization of conv models: flax's `nn.LayerNorm` (eps 1e-6, its
    default), f32 statistics with the clamped fast variance, y = (x -
    mean) * (rsqrt(var + eps) * weight) + bias in f32, one cast to x's
    dtype; the same arithmetic in training. Not the LN kernel, whose
    JAX counterpart serves only the Swin path."""

    def __init__(self, n_channels: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(n_channels))
        self.bias = nn.Parameter(torch.zeros(n_channels))

    def forward(self, x):
        x32 = upcast(x)
        mean = x32.mean(dim=1, keepdim=True)
        var = ((x32 * x32).mean(dim=1, keepdim=True)
               - mean * mean).clamp_min(0.0)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        mul = torch.rsqrt(var + self.eps) * self.weight.view(shape)
        return ((x32 - mean) * mul + self.bias.view(shape)).to(x.dtype)


class FusedLayerNorm(nn.Module):
    """LayerNorm over the last axis through the LN kernel
    (ops/cuda/layernorm.py; its plain version on the CPU): f32
    statistics with the clamped fast variance, eps inside the rsqrt,
    the affine in f32, one cast at the end. eps 1e-5 is the JAX
    package's `FusedLayerNorm` (torch's default); the decoders' skip
    LayerNorm is flax `nn.LayerNorm` and passes its 1e-6. In training
    mode it runs the same arithmetic as the differentiable plain
    version on every device, as the JAX package trains through XLA."""

    def __init__(self, n_channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(n_channels))
        self.bias = nn.Parameter(torch.zeros(n_channels))

    def forward(self, x):
        # imported here: ops/cuda imports this module's siblings
        from ..ops.cuda.layernorm import (fused_layer_norm,
                                          layer_norm_reference)
        norm = layer_norm_reference if self.training else fused_layer_norm
        return norm(x, self.weight, self.bias, self.eps)


def bernoulli_keep(shape, keep: float, generator, device) -> torch.Tensor:
    """Bool mask of `shape`, True with probability `keep`, drawn from
    `generator` (on `device`, or on the generator's device and moved)."""
    gdev = device if generator is None else generator.device
    u = torch.rand(shape, generator=generator, device=gdev)
    return (u < keep).to(device)


class Dropout(nn.Module):
    """Channel dropout of NCHW tensors in training mode (flax
    `nn.Dropout(rate, broadcast_dims=(1, 2))` on NHWC): one keep/drop
    draw per (sample, channel), broadcast over H and W; kept values
    are divided by 1 - rate rounded to x's dtype (flax's weak-typed
    `x / keep_prob`: 0.80078125 in bf16). The identity in eval mode or
    at rate 0."""

    def __init__(self, rate: float = 0.1):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x, generator=None):
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        mask = bernoulli_keep((x.shape[0], x.shape[1], 1, 1), keep,
                              generator, x.device)
        scale = float(torch.tensor(keep, dtype=x.dtype))
        return torch.where(mask, x / scale, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


def trunc_normal_(t, std: float = 0.02, generator=None):
    """Normal(0, std) truncated at two standard deviations, in place."""
    with torch.no_grad():
        t.normal_(0.0, std, generator=generator).clamp_(-2 * std, 2 * std)
    return t


class Linear(nn.Module):
    """Dense layer over the last axis (flax `nn.Dense`): weight (out,
    in), computed in the input's dtype. Initialisation: truncated
    normal (std 0.02) by default, else flax's lecun-normal kernel;
    zero bias."""

    def __init__(self, n_in: int, n_out: int, use_bias: bool = True,
                 std: Optional[float] = 0.02, generator=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n_out, n_in))
        self.bias = nn.Parameter(torch.zeros(n_out)) if use_bias else None
        if std is None:
            with torch.no_grad():
                self.weight.normal_(0.0, 1.0 / math.sqrt(n_in),
                                    generator=generator)
        else:
            trunc_normal_(self.weight, std, generator)

    def forward(self, x):
        dt = x.dtype
        return F.linear(x, cached_weight(self, 'weight', dt),
                        cached_weight(self, 'bias', dt))


class ConvNormAct(nn.Module):
    """conv -> norm -> act; `norm=None` gives the conv a bias. A 1x1
    ConvNormAct also takes a sequence of NCHW tensors, the conv of
    their channel concatenation (the JAX package's per-part kernel
    slices: same parameters, only the f32 summation order differs)."""

    def __init__(self, n_in: int, n_out: int, kernel_size: int = 1,
                 stride: int = 1, dilation: int = 1,
                 norm: Optional[str] = 'batchnorm',
                 act: Optional[str] = 'relu', generator=None):
        super().__init__()
        self.conv = Conv2d(n_in, n_out, kernel_size, stride,
                           dilation=dilation, use_bias=norm is None,
                           generator=generator)
        self.norm = make_norm(norm, n_out) if norm is not None else None
        self.act = get_activation(act) if act is not None else None

    def forward(self, x):
        if isinstance(x, (tuple, list)):
            x = torch.cat(x, dim=1)
        x = self.conv(x)
        if self.norm is not None:
            x = self.norm(x)
        if self.act is not None:
            x = self.act(x)
        return x


class SqueezeAndExcitation(nn.Module):
    """GAP -> 1x1 reduce -> act -> 1x1 expand -> sigmoid -> scale."""

    def __init__(self, n_channels: int, reduction: int = 16,
                 act: str = 'relu', generator=None):
        super().__init__()
        n_red = n_channels // reduction
        assert n_red > 0
        self.fc1 = Conv2d(n_channels, n_red, 1, use_bias=True,
                          generator=generator)
        self.fc2 = Conv2d(n_red, n_channels, 1, use_bias=True,
                          generator=generator)
        self.act = get_activation(act)

    def forward(self, x):
        w = x.mean(dim=(2, 3), keepdim=True)
        w = self.act(self.fc1(w))
        w = torch.sigmoid(self.fc2(w))
        return x * w

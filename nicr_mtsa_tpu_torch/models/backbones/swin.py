"""Swin Transformer backbone v1 / v2 (counterpart of
nicr_mtsa_tpu/models/backbones/swin.py). Five stages, callable through
`forward_stage`:
  0: patch embed (4x4)                          ds 4
  1: stage-1 blocks                             ds 4
  2: patch merging + stage-2 blocks             ds 8
  3: patch merging + stage-3 blocks             ds 16
  4: patch merging + stage-4 blocks + final LN  ds 32
v1: 7x7 windows, pre-norm, a relative-position bias table; v2: 8x8
windows, post-norm, cosine attention with a learned logit scale and the
log-spaced continuous position bias MLP. Shifted windows on every
second block. Stochastic depth rises linearly over the blocks (to 0.2
for Swin-T) and is the identity at inference.

Layout: the blocks work on NHWC tensors (the LayerNorms and the window
partition read the channel axis last); `forward_stage` takes and
returns NCHW views of them, so the encoder and the decoders see the
port's usual NCHW shapes without a copy. At inference the attention
part of a block (pad to window multiples, cyclic shift, window
partition, the qkv product, attention, the output projection, and back)
is, with the attention backend 'auto', one call of
ops/cuda/window_attention.py `window_attention_image`; with 'qkv' the
qkv product, the pad, roll and partition run in torch and the
attention over the packed qkv is ops/cuda/window_attention_qkv.py
`window_attention_qkv` (the JAX package's 'pallas-qkv'). Every
LayerNorm goes through ops/cuda/layernorm.py (the kernels on the card,
their plain versions on the CPU); the MLP's dense layers and the patch
merging's reduction are plain `F.linear`.

Training mode (`nn.Module.train()`) takes the JAX package's training
path: the qkv product, the v2 cosine normalisation and the logit scale
folded into q in plain differentiable torch, the pad, roll and window
partition in torch, and the attention itself through the differentiable
ops/cuda/window_attention_core.py (row 7's forward and backward kernels
on the card) whatever the backend, except 'qkv', which has no gradient
and raises; the LayerNorms run their plain version, and the random
parts (DropPath) draw from the generator passed to `forward_stage`."""
import math
from typing import List, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.cuda.window_attention import (
    image_windows, window_attention_block, window_attention_image,
    window_partition, window_unpartition)
from ...ops.cuda.window_attention_core import window_attention_core
from ...ops.cuda.window_attention_qkv import window_attention_qkv
from ...utils.dtypes import upcast
from ..common import (Conv2d, FusedLayerNorm, Linear, bernoulli_keep,
                      cached_weight, trunc_normal_)
from ..remat import Recomputed
from .base import Backbone

# window-attention backends at inference: the whole-sub-block kernel,
# or the qkv product in torch and attention over the packed qkv
ATTN_BACKENDS = ('auto', 'qkv')


def relative_position_index(ws: int) -> np.ndarray:
    """(ws*ws, ws*ws) indices into the (2ws-1)^2 bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing='ij')).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel = rel + (ws - 1)
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).astype(np.int64)


def log_cpb_coords(ws: int) -> np.ndarray:
    """((2ws-1)^2, 2) f32 log-spaced relative coordinates of the v2
    continuous position bias."""
    r = np.arange(-(ws - 1), ws, dtype=np.float32)
    table = np.stack(np.meshgrid(r, r, indexing='ij'), axis=-1)
    table = table / (ws - 1) * 8.0
    table = np.sign(table) * np.log2(np.abs(table) + 1.0) / 3.0
    return table.reshape(-1, 2)


def _derived(module: nn.Module, key: str, params, build):
    """`build()` of several parameters, cached until one of them is
    modified in place or moved (as `cached_weight`); built inside the
    autograd graph, uncached, where grad is on and a parameter requires
    it."""
    if torch.is_grad_enabled() and any(p.requires_grad for p in params):
        return build()
    ver = tuple((p.device, p.data_ptr(), p._version) for p in params)
    cache = module.__dict__.setdefault('_derived_cache', {})
    hit = cache.get(key)
    if hit is None or hit[0] != ver:
        with torch.no_grad():
            hit = cache[key] = (ver, build())
    return hit[1]


class DropPath(nn.Module):
    """Per-sample stochastic depth on a residual branch in training
    mode: a sample is kept with probability 1 - rate and then divided
    by it (the flax module's `where(mask, x / keep, 0)`)."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x, generator=None):
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        mask = bernoulli_keep((x.shape[0],) + (1,) * (x.dim() - 1), keep,
                              generator, x.device)
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))


class WindowAttention(nn.Module):
    """Window attention over (B_windows, N, C); parameter names follow
    the flax module (`qkv`, `proj`, v2 `cpb_fc1`/`cpb_fc2`/
    `logit_scale`, v1 `relative_position_bias_table`). `backend`: one
    of ATTN_BACKENDS, the inference path."""

    def __init__(self, dim: int, n_heads: int, window_size: int,
                 v2: bool = False, generator=None, backend: str = 'auto'):
        super().__init__()
        if backend not in ATTN_BACKENDS:
            raise ValueError(f"Unknown window-attention backend '{backend}'"
                             f"; the port has "
                             f"{', '.join(map(repr, ATTN_BACKENDS))}")
        self.dim, self.n_heads, self.window_size = dim, n_heads, window_size
        self.v2, self.backend = v2, backend
        self.qkv = Linear(dim, 3 * dim, generator=generator)
        self.proj = Linear(dim, dim, generator=generator)
        if v2:
            self.cpb_fc1 = Linear(2, 512, std=None, generator=generator)
            self.cpb_fc2 = Linear(512, n_heads, use_bias=False, std=None,
                                  generator=generator)
            self.logit_scale = nn.Parameter(
                torch.full((n_heads, 1, 1), math.log(10.0)))
        else:
            self.relative_position_bias_table = nn.Parameter(trunc_normal_(
                torch.empty((2 * window_size - 1) ** 2, n_heads),
                generator=generator))

    def position_bias(self) -> torch.Tensor:
        """(h, N, N) f32 additive relative-position bias, query-major."""
        ws, h = self.window_size, self.n_heads
        N = ws * ws

        def build():
            idx = torch.from_numpy(relative_position_index(ws).reshape(-1))
            if self.v2:
                dev = self.cpb_fc1.weight.device
                coords = torch.from_numpy(log_cpb_coords(ws)).to(
                    dev, self.cpb_fc1.weight.dtype)
                t = F.relu(F.linear(coords, self.cpb_fc1.weight,
                                    self.cpb_fc1.bias))
                table = F.linear(t, self.cpb_fc2.weight)
            else:
                table = self.relative_position_bias_table
            bias = table[idx.to(table.device)].view(N, N, h).permute(2, 0, 1)
            bias = 16.0 * torch.sigmoid(bias) if self.v2 else bias
            return upcast(bias).contiguous()

        params = ((self.cpb_fc1.weight, self.cpb_fc1.bias,
                   self.cpb_fc2.weight) if self.v2
                  else (self.relative_position_bias_table,))
        return _derived(self, 'position_bias', params, build)

    def v2_scale(self) -> torch.Tensor:
        """(h,) f32 logit scale exp(min(s, log 100))."""
        return _derived(self, 'v2_scale', (self.logit_scale,), lambda: torch.exp(
            torch.minimum(upcast(self.logit_scale),
                          torch.log(torch.tensor(100.0)).to(
                              self.logit_scale.device))).view(-1))

    def qkv_bias(self) -> torch.Tensor:
        """(3C,) f32 qkv bias; v2 zeroes its k third on every forward
        (k is normalised per head, so a key bias is not a no-op): an
        exact 0 forward and an exact 0 gradient."""
        def build():
            b = upcast(self.qkv.bias)
            if self.v2:
                C = self.dim
                b = torch.cat([b[:C], torch.zeros_like(b[C:2 * C]),
                               b[2 * C:]])
            return b
        return _derived(self, 'qkv_bias', (self.qkv.bias,), build)

    def _weights(self, dt):
        """(wqkv (C, 3C), bqkv, wproj (C, C), bproj, position bias, v2
        scale or None), the products' weights in the compute dtype."""
        wqkv = cached_weight(self.qkv, 'weight', dt,
                             lambda w: w.t().contiguous())
        wproj = cached_weight(self.proj, 'weight', dt,
                              lambda w: w.t().contiguous())
        return (wqkv, self.qkv_bias(), wproj, self.proj.bias,
                self.position_bias(), self.v2_scale() if self.v2 else None)

    def forward(self, windows, grid_hw: Tuple[int, int] = (1, 1),
                shift=None):
        """Windows (Bw, N, C), as the flax module takes them; the
        inference path of the backend."""
        if self.backend == 'qkv':
            return self.forward_qkv(windows, grid_hw, shift)
        wqkv, bqkv, wproj, bproj, bias, scale = self._weights(windows.dtype)
        return window_attention_block(windows, wqkv, bqkv, wproj, bproj,
                                      bias, self.n_heads, grid_hw, shift,
                                      scale)

    def forward_qkv(self, windows, grid_hw: Tuple[int, int] = (1, 1),
                    shift=None):
        """The 'qkv' inference path on windows (Bw, N, C): qkv = x @ Wqkv
        rounded to the compute dtype, then + the (v2: k-zeroed) bias in
        it (the JAX `QKVProjection`'s order, where `F.linear` would fuse
        the bias into one rounding), attention over the packed qkv, and
        the output projection in the same order."""
        dt = windows.dtype
        wqkv, _, wproj, _, bias, scale = self._weights(dt)
        bqkv = _derived(self, f'qkv_bias_{dt}', (self.qkv.bias,),
                        lambda: self.qkv_bias().to(dt))
        out = window_attention_qkv(windows @ wqkv + bqkv, bias, self.n_heads,
                                   grid_hw, shift, scale)
        return out @ wproj + cached_weight(self.proj, 'bias', dt)

    def forward_train(self, windows, grid_hw: Tuple[int, int] = (1, 1),
                      shift=None):
        """The training path on windows (Bw, N, C), as the flax module
        takes them with `train=True`: qkv, (v2) q and k divided by
        max(||.||, 1e-6) per head and the logit scale folded into q in
        f32, rounded back (v1: q x d^-0.5), then the differentiable
        attention core and `proj`."""
        Bw, N, C = windows.shape
        h, dt = self.n_heads, windows.dtype
        qkv = F.linear(windows, cached_weight(self.qkv, 'weight', dt),
                       self.qkv_bias().to(dt))
        q, k, v = qkv.split(C, dim=-1)
        if self.v2:
            def unit(t):
                t32 = upcast(t.reshape(Bw, N, h, C // h))
                nrm = torch.linalg.vector_norm(t32, dim=-1, keepdim=True)
                return (t32 / nrm.clamp_min(1e-6)).to(dt)
            scale = self.v2_scale().view(1, 1, h, 1)
            q = (upcast(unit(q)) * scale).to(dt).reshape(Bw, N, C)
            k = unit(k).reshape(Bw, N, C)
        else:
            q = q * float(C // h) ** -0.5
        out = window_attention_core(q, k, v,
                                    self.position_bias(), grid_hw, shift)
        return self.proj(out)

    def forward_image(self, x, shift: int = 0):
        """A Swin block's attention part on its (B, H, W, C) image:
        padding, the cyclic shift and the window partition included;
        in training mode through `forward_train` (the 'qkv' backend
        raises: it has no gradient)."""
        if self.training:
            if self.backend == 'qkv':
                raise RuntimeError(
                    "the 'qkv' window-attention backend is inference only "
                    "(its kernel has no gradient); train with "
                    "backbone_attn_backend='auto'")
            return self._windowed(x, shift, self.forward_train)
        if self.backend == 'qkv':
            return self._windowed(x, shift, self.forward_qkv)
        wqkv, bqkv, wproj, bproj, bias, scale = self._weights(x.dtype)
        return window_attention_image(x, wqkv, bqkv, wproj, bproj, bias,
                                      self.n_heads, self.window_size,
                                      shift, scale)

    def _windowed(self, x, shift: int, attend):
        """attend(windows, grid_hw, shift) on the zero-padded, rolled and
        partitioned (B, H, W, C) image, and back."""
        B, H, W, C = x.shape
        ws = self.window_size
        pad_h, pad_w, grid_hw, (sh, sw) = image_windows(H, W, ws, shift)
        if pad_h or pad_w:
            x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
        if sh or sw:
            x = torch.roll(x, (-sh, -sw), dims=(1, 2))
        y = attend(window_partition(x, ws), grid_hw,
                   (sh, sw) if sh or sw else None)
        y = window_unpartition(y, ws, H + pad_h, W + pad_w)
        if sh or sw:
            y = torch.roll(y, (sh, sw), dims=(1, 2))
        return y[:, :H, :W] if pad_h or pad_w else y


class SwinBlock(Recomputed):
    """A Swin block on (B, H, W, C); `attn_chunk_size` (cs): where B > cs
    and cs divides B, the attention part runs cs images at a time (the
    JAX package's `attn_chunk_size`: it bounds the attention's live
    intermediates at large batches; a window never spans two images, so
    the output is that of the whole batch at once). With `remat` set
    (`SwinBackbone(remat=True)`) the block recomputes its activations in
    the backward pass (models/remat.py)."""

    def __init__(self, dim: int, n_heads: int, window_size: int,
                 shift: int = 0, mlp_ratio: float = 4.0, v2: bool = False,
                 drop_path: float = 0.0, generator=None,
                 attn_backend: str = 'auto', attn_chunk_size: int = 0):
        super().__init__()
        self.window_size, self.shift, self.v2 = window_size, shift, v2
        self.attn_chunk_size = int(attn_chunk_size)
        self.drop_path = DropPath(drop_path)
        self.attn = WindowAttention(dim, n_heads, window_size, v2,
                                    generator, attn_backend)
        self.norm1 = FusedLayerNorm(dim)
        self.norm2 = FusedLayerNorm(dim)
        hidden = int(dim * mlp_ratio)
        self.mlp_fc1 = Linear(dim, hidden, generator=generator)
        self.mlp_fc2 = Linear(hidden, dim, generator=generator)

    def _attention_part(self, y):
        B, cs = y.shape[0], self.attn_chunk_size
        if cs and B > cs and B % cs == 0:
            return torch.cat([self.attn.forward_image(y[i:i + cs], self.shift)
                              for i in range(0, B, cs)])
        return self.attn.forward_image(y, self.shift)

    def _mlp_part(self, y):
        # exact (erf) GELU, as the JAX package's
        return self.mlp_fc2(F.gelu(self.mlp_fc1(y)))

    def block_forward(self, x, generator=None):
        """x: (B, H, W, C); `generator` feeds DropPath in training."""
        dp = lambda y: self.drop_path(y, generator)
        if self.v2:                    # post-norm
            x = x + dp(self.norm1(self._attention_part(x)))
            return x + dp(self.norm2(self._mlp_part(x)))
        x = x + dp(self._attention_part(self.norm1(x)))
        return x + dp(self._mlp_part(self.norm2(x)))


class PatchMerging(nn.Module):
    """2x2 patch merging, concat of the 4 neighbours in (dy, dx) order
    -> 2C; v1: LN then projection, v2: projection then LN."""

    def __init__(self, dim: int, v2: bool = False, generator=None):
        super().__init__()
        self.v2 = v2
        self.reduction = Linear(4 * dim, 2 * dim, use_bias=False,
                                generator=generator)
        self.norm = FusedLayerNorm(2 * dim if v2 else 4 * dim)

    def forward(self, x):
        B, H, W, C = x.shape
        if H % 2 or W % 2:
            x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
            H, W = H + H % 2, W + W % 2
        x = x.reshape(B, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(B, H // 2, W // 2, 4 * C)
        if self.v2:
            return self.norm(self.reduction(x))
        return self.reduction(self.norm(x))


class PatchEmbed(nn.Module):
    """4x4 stride-4 conv (NCHW in) + LN (NHWC out)."""

    def __init__(self, embed_dim: int = 96, patch_size: int = 4,
                 n_input_channels: int = 3, generator=None):
        super().__init__()
        self.proj = Conv2d(n_input_channels, embed_dim, patch_size,
                           stride=patch_size, padding=0, use_bias=True)
        trunc_normal_(self.proj.weight, generator=generator)
        self.norm = FusedLayerNorm(embed_dim)

    def forward(self, x):
        return self.norm(self.proj(x).permute(0, 2, 3, 1))


class MergedPatchEmbedder(nn.Module):
    """Multimodal patch embed: separate rgb / depth patch convs + LNs,
    concatenated channel-wise."""

    def __init__(self, embed_dim_rgb: int = 64, embed_dim_depth: int = 32,
                 patch_size: int = 4, generator=None):
        super().__init__()
        self.rgb = PatchEmbed(embed_dim_rgb, patch_size, 3, generator)
        self.depth = PatchEmbed(embed_dim_depth, patch_size, 1, generator)

    def forward(self, x):
        """x: (B, 4, H, W) rgbd."""
        return torch.cat([self.rgb(x[:, :3]), self.depth(x[:, 3:])], dim=-1)


class SwinBackbone(Backbone):
    def __init__(self, embed_dim: int = 96,
                 depths: Tuple[int, ...] = (2, 2, 6, 2),
                 n_heads: Tuple[int, ...] = (3, 6, 12, 24),
                 window_size: int = 7, mlp_ratio: float = 4.0,
                 v2: bool = False, n_input_channels: int = 3,
                 multimodal: bool = False, embed_dim_depth: int = 32,
                 stochastic_depth: float = 0.2, generator=None,
                 attn_backend: str = 'auto', remat: bool = False,
                 attn_chunk_size: int = 0):
        super().__init__()
        self.embed_dim = embed_dim
        self.n_input_channels = n_input_channels
        if multimodal:
            assert n_input_channels == 4
            self.patch_embed = MergedPatchEmbedder(
                embed_dim - embed_dim_depth, embed_dim_depth,
                generator=generator)
        else:
            self.patch_embed = PatchEmbed(embed_dim, 4, n_input_channels,
                                          generator)
        self._layer_names: List[List[str]] = []
        dp_rates = np.linspace(0, stochastic_depth, sum(depths))
        for i, (depth, heads) in enumerate(zip(depths, n_heads)):
            names = []
            for b in range(depth):
                name = f'layer{i + 1}_block{b}'
                block = SwinBlock(
                    embed_dim * 2 ** i, heads, window_size,
                    shift=0 if b % 2 == 0 else window_size // 2,
                    mlp_ratio=mlp_ratio, v2=v2,
                    drop_path=float(dp_rates[sum(depths[:i]) + b]),
                    generator=generator, attn_backend=attn_backend,
                    attn_chunk_size=attn_chunk_size)
                block.remat = remat
                self.add_module(name, block)
                names.append(name)
            self._layer_names.append(names)
        for i in range(1, 4):
            self.add_module(f'merge{i}', PatchMerging(
                embed_dim * 2 ** (i - 1), v2, generator))
        self.norm = FusedLayerNorm(8 * embed_dim)

    @property
    def stages_n_channels(self) -> List[int]:
        e = self.embed_dim
        return [e, e, 2 * e, 4 * e, 8 * e]

    @property
    def stages_downsampling(self) -> List[int]:
        return [4, 4, 8, 16, 32]

    def forward_stage(self, idx: int, x, generator=None):
        """NCHW in, an NCHW view of the NHWC result out; `generator`
        feeds the stochastic depth in training."""
        if idx == 0:
            return self.patch_embed(x).permute(0, 3, 1, 2)
        x = x.permute(0, 2, 3, 1).contiguous()
        if idx >= 2:
            x = getattr(self, f'merge{idx - 1}')(x)
        for name in self._layer_names[idx - 1]:
            x = getattr(self, name)(x, generator)
        if idx == 4:
            x = self.norm(x)
        return x.permute(0, 3, 1, 2)


def get_swin_backbone(name: str, n_input_channels: int = 3,
                      stochastic_depth=None, generator=None,
                      attn_backend: str = 'auto', remat: bool = False,
                      attn_chunk_size: int = 0) -> SwinBackbone:
    """swin-{t,s,b}[-v2], swin-t[-v2]-128, and the swin-multi-*
    variants with the merged rgb + depth patch embedder; stochastic
    depth (the last block's rate) defaults to the variant's (0.2, 0.3,
    0.5 for t, s, b); `attn_backend`: one of ATTN_BACKENDS; `remat`:
    every block recomputes its activations in the backward pass;
    `attn_chunk_size`: images per attention chunk (0: the whole
    batch)."""
    name = name.lower()
    v2 = '-v2' in name
    multimodal = name.startswith('swin-multi')
    if '-t' in name:
        depths, heads, embed, sd = (2, 2, 6, 2), (3, 6, 12, 24), 96, 0.2
    elif '-s' in name:
        depths, heads, embed, sd = (2, 2, 18, 2), (3, 6, 12, 24), 96, 0.3
    elif '-b' in name:
        depths, heads, embed, sd = (2, 2, 18, 2), (4, 8, 16, 32), 128, 0.5
    else:
        raise ValueError(f"Unknown swin backbone: '{name}'")
    if name.endswith('-128'):
        # EMSAFormer's widened Swin-T (head width 32, like swin-b)
        embed, heads = 128, (4, 8, 16, 32)
    if multimodal:
        n_input_channels = 4
    return SwinBackbone(embed_dim=embed, depths=depths, n_heads=heads,
                        window_size=8 if v2 else 7, v2=v2,
                        n_input_channels=n_input_channels,
                        multimodal=multimodal,
                        stochastic_depth=(sd if stochastic_depth is None
                                          else stochastic_depth),
                        generator=generator, attn_backend=attn_backend,
                        remat=remat, attn_chunk_size=attn_chunk_size)

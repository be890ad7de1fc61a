"""Task heads (counterpart of nicr_mtsa_tpu/models/decoders/heads.py).

- `TaskHead`: 3x3 conv -> n x2 prediction upsamplings -> optional
  post-op (`post='unit-length'`: the normals' unit vectors); with
  `defer_last_upsampling=True` the last learned-3x3-zeropad upsampling
  is returned as a DeferredUpsampling, with `'all'` both upsamplings of
  a two-step head as a DeferredUpsampling2 (learned-3x3-zeropad) or a
  DeferredBilinear2 (bilinear, parameter-free); the parameters are the
  same in every case. Another mode, or a post-op, cannot be deferred
  and raises (the JAX package asserts it).
- `InstanceHead`: shared 3x3 ConvNormAct split into centre (sigmoid),
  offset (tanh) and orientation (unit length) convs; the concatenated
  raw maps are upsampled jointly before the activations."""
from typing import Optional

import torch
import torch.nn as nn

from ..common import Conv2d, ConvNormAct
from ..upsampling import (DeferredBilinear2, DeferredUpsampling,
                          DeferredUpsampling2, Upsampling)


def unit_length(x, epsilon: float = 1e-7, dim: int = 1):
    """Normalise vectors along `dim` (channels) to unit length."""
    return x / (torch.linalg.vector_norm(x, dim=dim, keepdim=True)
                + epsilon)


class TaskHead(nn.Module):
    def __init__(self, n_in: int, n_channels_out: int,
                 upsampling: str = 'learned-3x3-zeropad',
                 n_upsamplings: int = 0, defer_last_upsampling=False,
                 post: Optional[str] = None, generator=None):
        super().__init__()
        if post not in (None, 'unit-length'):
            raise ValueError(f"Unknown task-head post-op: '{post}'")
        self.defer_all = defer_last_upsampling == 'all'
        self.defer_last = defer_last_upsampling is True and n_upsamplings > 0
        if self.defer_all:
            assert n_upsamplings == 2, n_upsamplings
        deferrable = (('bilinear', 'learned-3x3-zeropad') if self.defer_all
                      else ('learned-3x3-zeropad',))
        if (self.defer_all or self.defer_last) and (
                upsampling not in deferrable or post is not None):
            raise ValueError(
                f'defer_last_upsampling={defer_last_upsampling!r} defers '
                f'{" or ".join(deferrable)} upsampling without a post-op, '
                f'not {upsampling!r} with post {post!r}')
        self.bilinear = upsampling == 'bilinear'
        self.post = post
        self.n_upsamplings = n_upsamplings
        k = 3 if n_upsamplings else 1
        self.conv = Conv2d(n_in, n_channels_out, k, use_bias=True,
                           generator=generator)
        for i in range(n_upsamplings):
            self.add_module(f'upsample_{i}',
                            Upsampling(upsampling, n_channels_out))

    def forward(self, x):
        x = self.conv(x)
        if self.defer_all and self.bilinear:
            return DeferredBilinear2(x=x)
        if self.defer_all:
            u0, u1 = self.upsample_0, self.upsample_1
            return DeferredUpsampling2(x=x, kernel1=u0.weight,
                                       bias1=u0.bias, kernel2=u1.weight,
                                       bias2=u1.bias)
        n_applied = self.n_upsamplings - int(self.defer_last)
        for i in range(n_applied):
            x = getattr(self, f'upsample_{i}')(x)
        if self.defer_last:
            u = getattr(self, f'upsample_{n_applied}')
            return DeferredUpsampling(x=x, kernel=u.weight, bias=u.bias)
        if self.post == 'unit-length':
            x = unit_length(x)
        return x


class InstanceHead(nn.Module):
    def __init__(self, n_in: int, n_channels_per_task: int = 32,
                 with_orientation: bool = False, norm: str = 'batchnorm',
                 act: str = 'relu', upsampling='learned-3x3-zeropad',
                 n_upsamplings: int = 0, generator=None):
        super().__init__()
        n_tasks = 3 if with_orientation else 2
        npt = self.npt = n_channels_per_task
        self.with_orientation = with_orientation
        self.n_upsamplings = n_upsamplings
        self.shared_conv = ConvNormAct(n_in, n_tasks * npt, 3, norm=norm,
                                       act=act, generator=generator)
        k = 3 if n_upsamplings else 1
        self.conv_center = Conv2d(npt, 1, k, use_bias=True,
                                  generator=generator)
        self.conv_offset = Conv2d(npt, 2, k, use_bias=True,
                                  generator=generator)
        self.conv_orientation: Optional[Conv2d] = None
        if with_orientation:
            self.conv_orientation = Conv2d(npt, 2, k, use_bias=True,
                                           generator=generator)
        n_cat = 1 + 2 + (2 if with_orientation else 0)
        for i in range(n_upsamplings):
            self.add_module(f'upsample_{i}', Upsampling(upsampling, n_cat))

    def forward(self, x):
        npt = self.npt
        x = self.shared_conv(x)
        outs = [self.conv_center(x[:, 0:npt]),
                self.conv_offset(x[:, npt:2 * npt])]
        if self.with_orientation:
            outs.append(self.conv_orientation(x[:, 2 * npt:3 * npt]))
        cat = torch.cat(outs, dim=1)
        for i in range(self.n_upsamplings):
            cat = getattr(self, f'upsample_{i}')(cat)
        result = [torch.sigmoid(cat[:, 0:1]), torch.tanh(cat[:, 1:3])]
        if self.with_orientation:
            result.append(unit_length(cat[:, 3:5]))
        return tuple(result)

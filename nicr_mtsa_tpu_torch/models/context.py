"""Context modules (counterpart of nicr_mtsa_tpu/models/context.py):
the PSPNet pyramid pooling module (PPM), the adaptive PPM (APPM) whose
bins scale with the input's size over its training size, and the
no-context 1x1 adapter. Each returns `(features, branch_tuple)`; a
pooling module's branch 0 (bin 1) is the global pooled feature the
scene decoder reads, the no-context module has no branches (`bins`
is empty). The branches are upsampled back by the port's
`resize_bilinear` (the JAX package's two-tap arithmetic; the JAX
modules' `upsampling='nearest'` has no caller there and is not
ported)."""
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .common import ConvNormAct
from .upsampling import resize_bilinear

KNOWN_CONTEXT_MODULES = ('none', 'ppm', 'ppm-1-2-4-8', 'appm',
                         'appm-1-2-4-8')


def adaptive_avg_pool2d(x, output_size: Tuple[int, int]):
    """torch.nn.AdaptiveAvgPool2d semantics on NCHW: window i spans
    [floor(i*H/h), ceil((i+1)*H/h))."""
    return F.adaptive_avg_pool2d(x, output_size)


class PyramidPoolingModule(nn.Module):
    """Fixed output bins; with `input_size` (the context's input size
    in training) the adaptive module: each bin is multiplied by
    int(h / h_train + 0.5) (and so for the width), at least 1."""

    def __init__(self, n_channels_in: int, n_channels_out: int,
                 bins: Tuple[int, ...] = (1, 2, 3, 6),
                 norm: str = 'batchnorm', act: str = 'relu',
                 generator=None,
                 input_size: Optional[Tuple[int, int]] = None):
        super().__init__()
        self.bins = tuple(bins)
        self.input_size = None if input_size is None else tuple(input_size)
        n_red = n_channels_in // len(self.bins)
        for i in range(len(self.bins)):
            self.add_module(f'branch{i}', ConvNormAct(
                n_channels_in, n_red, 1, norm=norm, act=act,
                generator=generator))
        self.final_conv = ConvNormAct(
            n_channels_in + n_red * len(self.bins), n_channels_out, 1,
            norm=norm, act=act, generator=generator)

    def pool_sizes(self, h: int, w: int):
        """(h, w) of each branch's pooled map at input size (h, w)."""
        if self.input_size is None:
            return [(b, b) for b in self.bins]
        h_inp, w_inp = self.input_size
        mh, mw = int(h / h_inp + 0.5), int(w / w_inp + 0.5)
        return [(max(b * mh, 1), max(b * mw, 1)) for b in self.bins]

    def forward(self, x):
        h, w = x.shape[-2:]
        out = [x]
        features_context = []
        for i, size in enumerate(self.pool_sizes(h, w)):
            y = getattr(self, f'branch{i}')(adaptive_avg_pool2d(x, size))
            features_context.append(y)
            out.append(resize_bilinear(y, h, w))
        out = self.final_conv(torch.cat(out, dim=1))
        return out, tuple(features_context)


class AdaptivePyramidPoolingModule(PyramidPoolingModule):
    """APPM: the bins scale with the input over `input_size`, so a
    larger evaluation input pools comparable regions."""

    def __init__(self, n_channels_in: int, n_channels_out: int,
                 input_size: Tuple[int, int] = (20, 27),
                 bins: Tuple[int, ...] = (1, 2, 3, 6), **kwargs):
        super().__init__(n_channels_in, n_channels_out, bins,
                         input_size=input_size, **kwargs)


class NoContextModule(nn.Module):
    """A 1x1 ConvNormAct (`conv`) where the channels differ, else the
    identity; no branches."""
    bins = ()

    def __init__(self, n_channels_in: int, n_channels_out: int,
                 norm: str = 'batchnorm', act: str = 'relu',
                 generator=None):
        super().__init__()
        self.conv = (ConvNormAct(n_channels_in, n_channels_out, 1,
                                 norm=norm, act=act, generator=generator)
                     if n_channels_in != n_channels_out else None)

    def forward(self, x):
        return (x if self.conv is None else self.conv(x)), ()


def get_context_module(name: Optional[str], n_channels_in: int,
                       n_channels_out: int,
                       input_size: Optional[Tuple[int, int]] = None,
                       normalization='batchnorm', activation='relu',
                       generator=None):
    """The context module of a registry name; 'appm*' needs
    `input_size`, the context's input size in training."""
    name = (name or 'ppm').lower()
    if name not in KNOWN_CONTEXT_MODULES:
        raise ValueError(f"Unknown context module: '{name}'")
    if name == 'none':
        return NoContextModule(n_channels_in, n_channels_out,
                               normalization, activation, generator)
    bins = (1, 2, 4, 8) if name.endswith('1-2-4-8') else (1, 2, 3, 6)
    kwargs = dict(bins=bins, norm=normalization, act=activation,
                  generator=generator)
    if name.startswith('appm'):
        if input_size is None:
            raise ValueError(f"'{name}' needs the context's input size "
                             f"in training")
        return AdaptivePyramidPoolingModule(
            n_channels_in, n_channels_out, input_size=input_size, **kwargs)
    return PyramidPoolingModule(n_channels_in, n_channels_out, **kwargs)

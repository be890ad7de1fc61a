"""PSPNet pyramid pooling context module (counterpart of
nicr_mtsa_tpu/models/context.py `adaptive_avg_pool2d` and
`PyramidPoolingModule`). Returns `(features, branch_tuple)`; branch 0
(bin 1) is the global pooled feature the scene decoder reads."""
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .common import ConvNormAct

KNOWN_CONTEXT_MODULES = ('ppm', 'ppm-1-2-4-8')


def adaptive_avg_pool2d(x, output_size: Tuple[int, int]):
    """torch.nn.AdaptiveAvgPool2d semantics on NCHW: window i spans
    [floor(i*H/h), ceil((i+1)*H/h))."""
    return F.adaptive_avg_pool2d(x, output_size)


def resize_bilinear(x, height: int, width: int):
    """Half-pixel bilinear resize (align_corners=False, no antialias),
    the semantics of the JAX package's `resize_bilinear`."""
    if tuple(x.shape[-2:]) == (height, width):
        return x
    return F.interpolate(x, size=(height, width), mode='bilinear',
                         align_corners=False)


class PyramidPoolingModule(nn.Module):
    def __init__(self, n_channels_in: int, n_channels_out: int,
                 bins: Tuple[int, ...] = (1, 2, 3, 6),
                 norm: str = 'batchnorm', act: str = 'relu',
                 generator=None):
        super().__init__()
        self.bins = tuple(bins)
        n_red = n_channels_in // len(self.bins)
        for i in range(len(self.bins)):
            self.add_module(f'branch{i}', ConvNormAct(
                n_channels_in, n_red, 1, norm=norm, act=act,
                generator=generator))
        self.final_conv = ConvNormAct(
            n_channels_in + n_red * len(self.bins), n_channels_out, 1,
            norm=norm, act=act, generator=generator)

    def forward(self, x):
        h, w = x.shape[-2:]
        out = [x]
        features_context = []
        for i, bin_ in enumerate(self.bins):
            y = adaptive_avg_pool2d(x, (bin_, bin_))
            y = getattr(self, f'branch{i}')(y)
            features_context.append(y)
            out.append(resize_bilinear(y, h, w))
        out = self.final_conv(torch.cat(out, dim=1))
        return out, tuple(features_context)


def get_context_module(name: Optional[str], n_channels_in: int,
                       n_channels_out: int, normalization='batchnorm',
                       activation='relu', generator=None):
    name = (name or 'ppm').lower()
    if name not in KNOWN_CONTEXT_MODULES:
        raise ValueError(f"Unsupported context module in this port: "
                         f"'{name}'")
    bins = (1, 2, 4, 8) if name.endswith('1-2-4-8') else (1, 2, 3, 6)
    return PyramidPoolingModule(n_channels_in, n_channels_out, bins,
                                normalization, activation, generator)

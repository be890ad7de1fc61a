"""Residual blocks: BasicBlock (ResNet v1) and NonBottleneck1D (ERFNet
factorised 3x1/1x3 with channel dropout before the residual add),
counterparts of nicr_mtsa_tpu/models/blocks.py. `forward(x, generator)`
takes the generator of training mode's random parts (NonBottleneck1D's
dropout, rate `dropout_p`, one draw per (sample, channel)); BasicBlock
has none and does not read it. `make_block(..., remat=True)` gives a
block that recomputes its activations in the backward pass
(models/remat.py), the parameters unchanged."""
from typing import Optional

import torch.nn as nn

from .common import (BatchNorm, Conv2d, ConvNormAct, Dropout,
                     get_activation)
from .remat import Recomputed

KNOWN_BLOCKS = ('basicblock', 'nonbottleneck1d')


def get_block_name(name: Optional[str] = None) -> str:
    name = (name or 'nonbottleneck1d').lower()
    if name not in KNOWN_BLOCKS:
        raise ValueError(f"Unknown block: '{name}'")
    return name


class BasicBlock(Recomputed):
    def __init__(self, n_in: int, planes: int, stride: int = 1,
                 use_downsample: bool = False, dilation: int = 1,
                 norm: str = 'batchnorm', act: str = 'relu',
                 generator=None):
        super().__init__()
        self.conv1 = Conv2d(n_in, planes, 3, stride, generator=generator)
        self.norm1 = BatchNorm(planes)
        self.conv2 = Conv2d(planes, planes, 3, generator=generator)
        self.norm2 = BatchNorm(planes)
        self.downsample = (
            ConvNormAct(n_in, planes, 1, stride=stride, norm=norm,
                        act=None, generator=generator)
            if use_downsample else None)
        self.act = get_activation(act)

    def block_forward(self, x, generator=None):
        out = self.act(self.norm1(self.conv1(x)))
        out = self.norm2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return self.act(out + identity)


class NonBottleneck1D(Recomputed):
    def __init__(self, n_in: int, planes: int, stride: int = 1,
                 use_downsample: bool = False, dilation: int = 1,
                 norm: str = 'batchnorm', act: str = 'relu',
                 dropout_p: float = 0.2, generator=None):
        super().__init__()
        d = dilation
        g = generator
        self.conv1_1 = Conv2d(n_in, planes, (3, 1), (stride, 1),
                              padding=(1, 0), use_bias=True, generator=g)
        self.conv1_2 = Conv2d(planes, planes, (1, 3), (1, stride),
                              padding=(0, 1), generator=g)
        self.norm1 = BatchNorm(planes)
        self.conv2_1 = Conv2d(planes, planes, (3, 1), padding=(d, 0),
                              dilation=(d, 1), use_bias=True, generator=g)
        self.conv2_2 = Conv2d(planes, planes, (1, 3), padding=(0, d),
                              dilation=(1, d), generator=g)
        self.norm2 = BatchNorm(planes)
        self.dropout = Dropout(dropout_p)
        self.downsample = (
            ConvNormAct(n_in, planes, 1, stride=stride, norm=norm,
                        act=None, generator=g)
            if use_downsample else None)
        self.act = get_activation(act)

    def block_forward(self, x, generator=None):
        act = self.act
        out = act(self.conv1_1(x))
        out = act(self.norm1(self.conv1_2(out)))
        out = act(self.conv2_1(out))
        out = self.dropout(self.norm2(self.conv2_2(out)), generator)
        identity = x if self.downsample is None else self.downsample(x)
        return act(out + identity)


def make_block(block_type: str, remat: bool = False, **kwargs) -> nn.Module:
    """The block of `block_type`; `dropout_p` reaches NonBottleneck1D
    only; `remat`: recompute its activations in the backward pass."""
    block_type = get_block_name(block_type)
    if block_type != 'nonbottleneck1d':
        kwargs.pop('dropout_p', None)
    cls = {'basicblock': BasicBlock,
           'nonbottleneck1d': NonBottleneck1D}[block_type]
    block = cls(**kwargs)
    block.remat = remat
    return block

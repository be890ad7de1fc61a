"""Residual blocks: BasicBlock (ResNet v1), Bottleneck (ResNet v1.5:
the stride on the 3x3 conv, expansion 4) and NonBottleneck1D (ERFNet
factorised 3x1/1x3 with channel dropout before the residual add),
counterparts of nicr_mtsa_tpu/models/blocks.py. Their norms are the
`norm` of the model (BatchNorm, or the channel LayerNorm of 'ln');
`zero_init_residual` starts the last norm's scale at 0.
`forward(x, generator)` takes the generator of training mode's random
parts (NonBottleneck1D's dropout, rate `dropout_p`, one draw per
(sample, channel)); the other blocks have none and do not read it.
`make_block(..., remat=True)` gives a block that recomputes its
activations in the backward pass (models/remat.py), the parameters
unchanged."""
from typing import Optional

import torch.nn as nn

from .common import Conv2d, ConvNormAct, Dropout, get_activation, make_norm
from .remat import Recomputed

KNOWN_BLOCKS = ('basicblock', 'bottleneck', 'nonbottleneck1d')


def get_block_name(name: Optional[str] = None) -> str:
    name = (name or 'nonbottleneck1d').lower()
    if name not in KNOWN_BLOCKS:
        raise ValueError(f"Unknown block: '{name}'")
    return name


def block_expansion(name: str) -> int:
    """Output channels of a block over its `planes`."""
    return 4 if get_block_name(name) == 'bottleneck' else 1


def _downsample(use: bool, n_in: int, n_out: int, stride: int, norm: str,
                generator):
    return (ConvNormAct(n_in, n_out, 1, stride=stride, norm=norm, act=None,
                        generator=generator) if use else None)


class BasicBlock(Recomputed):
    """Two 3x3 convs; `dilation` is not used (as in the JAX package)."""

    def __init__(self, n_in: int, planes: int, stride: int = 1,
                 use_downsample: bool = False, dilation: int = 1,
                 norm: str = 'batchnorm', act: str = 'relu',
                 zero_init_residual: bool = False, generator=None):
        super().__init__()
        self.conv1 = Conv2d(n_in, planes, 3, stride, generator=generator)
        self.norm1 = make_norm(norm, planes)
        self.conv2 = Conv2d(planes, planes, 3, generator=generator)
        self.norm2 = make_norm(norm, planes, zero_init_residual)
        self.downsample = _downsample(use_downsample, n_in, planes, stride,
                                      norm, generator)
        self.act = get_activation(act)

    def block_forward(self, x, generator=None):
        out = self.act(self.norm1(self.conv1(x)))
        out = self.norm2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return self.act(out + identity)


class Bottleneck(Recomputed):
    """1x1 reduce to `width` = planes * base_width / 64 * groups, the
    strided (dilated, grouped) 3x3, 1x1 expand to 4 * planes."""
    expansion = 4

    def __init__(self, n_in: int, planes: int, stride: int = 1,
                 use_downsample: bool = False, dilation: int = 1,
                 groups: int = 1, base_width: int = 64,
                 norm: str = 'batchnorm', act: str = 'relu',
                 zero_init_residual: bool = False, generator=None):
        super().__init__()
        g = generator
        width = int(planes * (base_width / 64.0)) * groups
        n_out = planes * self.expansion
        self.conv1 = Conv2d(n_in, width, 1, generator=g)
        self.norm1 = make_norm(norm, width)
        self.conv2 = Conv2d(width, width, 3, stride, dilation=dilation,
                            groups=groups, generator=g)
        self.norm2 = make_norm(norm, width)
        self.conv3 = Conv2d(width, n_out, 1, generator=g)
        self.norm3 = make_norm(norm, n_out, zero_init_residual)
        self.downsample = _downsample(use_downsample, n_in, n_out, stride,
                                      norm, g)
        self.act = get_activation(act)

    def block_forward(self, x, generator=None):
        act = self.act
        out = act(self.norm1(self.conv1(x)))
        out = act(self.norm2(self.conv2(out)))
        out = self.norm3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return act(out + identity)


class NonBottleneck1D(Recomputed):
    def __init__(self, n_in: int, planes: int, stride: int = 1,
                 use_downsample: bool = False, dilation: int = 1,
                 norm: str = 'batchnorm', act: str = 'relu',
                 dropout_p: float = 0.2, zero_init_residual: bool = False,
                 generator=None):
        super().__init__()
        d = dilation
        g = generator
        self.conv1_1 = Conv2d(n_in, planes, (3, 1), (stride, 1),
                              padding=(1, 0), use_bias=True, generator=g)
        self.conv1_2 = Conv2d(planes, planes, (1, 3), (1, stride),
                              padding=(0, 1), generator=g)
        self.norm1 = make_norm(norm, planes)
        self.conv2_1 = Conv2d(planes, planes, (3, 1), padding=(d, 0),
                              dilation=(d, 1), use_bias=True, generator=g)
        self.conv2_2 = Conv2d(planes, planes, (1, 3), padding=(0, d),
                              dilation=(1, d), generator=g)
        self.norm2 = make_norm(norm, planes)
        self.dropout = Dropout(dropout_p)
        self.downsample = _downsample(use_downsample, n_in, planes, stride,
                                      norm, g)
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
    only, `groups` and `base_width` Bottleneck only; `remat`: recompute
    its activations in the backward pass."""
    block_type = get_block_name(block_type)
    if block_type != 'nonbottleneck1d':
        kwargs.pop('dropout_p', None)
    if block_type != 'bottleneck':
        kwargs.pop('groups', None)
        kwargs.pop('base_width', None)
    cls = {'basicblock': BasicBlock, 'bottleneck': Bottleneck,
           'nonbottleneck1d': NonBottleneck1D}[block_type]
    block = cls(**kwargs)
    block.remat = remat
    return block

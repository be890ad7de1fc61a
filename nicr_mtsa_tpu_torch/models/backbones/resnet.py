"""ResNet backbone (resnet18/34) with a pluggable residual block,
written natively (counterpart of nicr_mtsa_tpu/models/backbones/
resnet.py). Five stages, each callable through `forward_stage` so the
fused RGB-D encoder can interleave per-stage fusion:
  0: stem conv7x7/s2 + norm + act            (ds 2,  64ch)
  1: maxpool3x3/s2 + layer1                  (ds 4)
  2-4: layer2-4                              (ds 8, 16, 32)"""
from typing import List, Tuple

import torch.nn.functional as F

from ..blocks import get_block_name, make_block
from ..common import BatchNorm, Conv2d, get_activation
from .base import Backbone


class ResNetBackbone(Backbone):
    def __init__(self, block: str = 'basicblock',
                 layers: Tuple[int, ...] = (2, 2, 2, 2),
                 n_input_channels: int = 3, norm: str = 'batchnorm',
                 act: str = 'relu', remat: bool = False, generator=None):
        super().__init__()
        self.block = get_block_name(block)
        self.n_input_channels = n_input_channels
        self.act = get_activation(act)
        self.conv1 = Conv2d(n_input_channels, 64, 7, 2,
                            generator=generator)
        self.norm1 = BatchNorm(64)

        in_ch = 64
        self._layer_names: List[List[str]] = []
        for i, (planes, n_blocks) in enumerate(
                zip((64, 128, 256, 512), layers)):
            stride = 1 if i == 0 else 2
            names = []
            for b in range(n_blocks):
                name = f'layer{i + 1}_block{b}'
                s = stride if b == 0 else 1
                self.add_module(name, make_block(
                    self.block, n_in=in_ch, planes=planes, stride=s,
                    use_downsample=(b == 0 and (s != 1 or in_ch != planes)),
                    norm=norm, act=act, remat=remat, generator=generator))
                names.append(name)
                in_ch = planes
            self._layer_names.append(names)

    @property
    def stages_n_channels(self) -> List[int]:
        return [64, 64, 128, 256, 512]

    @property
    def stages_downsampling(self) -> List[int]:
        return [2, 4, 8, 16, 32]

    def forward_stage(self, idx: int, x, generator=None):
        """`generator` feeds the blocks' channel dropout in training."""
        if idx == 0:
            return self.act(self.norm1(self.conv1(x)))
        if idx == 1:
            x = F.max_pool2d(x, 3, stride=2, padding=1)
        for name in self._layer_names[idx - 1]:
            x = getattr(self, name)(x, generator)
        return x


def get_resnet_backbone(name: str, block=None, n_input_channels: int = 3,
                        normalization: str = 'batchnorm',
                        activation: str = 'relu', remat: bool = False,
                        generator=None) -> ResNetBackbone:
    """resnet18 / resnet34 with `block` blocks; `remat`: each block
    recomputes its activations in the backward pass."""
    name = name.lower()
    layers = {'resnet18': (2, 2, 2, 2), 'resnet34': (3, 4, 6, 3)}.get(name)
    if layers is None:
        raise ValueError(f"Unsupported backbone in this port: '{name}'")
    return ResNetBackbone(block=get_block_name(block), layers=layers,
                          n_input_channels=n_input_channels,
                          norm=normalization, act=activation,
                          remat=remat, generator=generator)

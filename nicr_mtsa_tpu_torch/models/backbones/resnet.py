"""ResNet backbone with a pluggable residual block (basicblock,
nonbottleneck1d, or bottleneck for ResNet-50/101), `-d16` dilation and
per-stage Squeeze-and-Excitation (`*se`), written natively (counterpart
of nicr_mtsa_tpu/models/backbones/resnet.py). Five stages, each
callable through `forward_stage` so the fused RGB-D encoder can
interleave per-stage fusion:
  0: stem conv7x7/s2 + norm + act            (ds 2,  64ch)
  1: maxpool3x3/s2 + layer1                  (ds 4)
  2-4: layer2-4                              (ds 8, 16, 32; with
     `replace_stride_with_dilation=(.., .., True)` (-d16) layer4 keeps
     ds 16 and dilates its blocks instead)
A stage's channels are its planes (64, 64, 128, 256, 512) times the
block's expansion (4 for bottleneck) past the stem; with `se`, stage i
ends in `se_stage{i}`."""
from typing import List, Tuple

import torch.nn.functional as F

from ..blocks import block_expansion, get_block_name, make_block
from ..common import Conv2d, SqueezeAndExcitation, get_activation, make_norm
from .base import Backbone


class ResNetBackbone(Backbone):
    def __init__(self, block: str = 'basicblock',
                 layers: Tuple[int, ...] = (2, 2, 2, 2),
                 replace_stride_with_dilation: Tuple[bool, bool, bool] = (
                     False, False, False),
                 n_input_channels: int = 3, norm: str = 'batchnorm',
                 act: str = 'relu', se: bool = False,
                 zero_init_residual: bool = False, groups: int = 1,
                 width_per_group: int = 64, remat: bool = False,
                 generator=None):
        super().__init__()
        self.block = get_block_name(block)
        self.replace_stride_with_dilation = tuple(
            replace_stride_with_dilation)
        self.n_input_channels = n_input_channels
        self.se = se
        self.act = get_activation(act)
        e = block_expansion(self.block)
        self.conv1 = Conv2d(n_input_channels, 64, 7, 2, generator=generator)
        self.norm1 = make_norm(norm, 64)

        # torchvision's _make_layer, with its dilation bookkeeping
        dilation, in_ch = 1, 64
        self._layer_names: List[List[str]] = []
        for i, (planes, n_blocks) in enumerate(
                zip((64, 128, 256, 512), layers)):
            stride = 1 if i == 0 else 2
            dilation_in = dilation
            if i > 0 and self.replace_stride_with_dilation[i - 1]:
                dilation *= stride
                stride = 1
            names = []
            for b in range(n_blocks):
                name = f'layer{i + 1}_block{b}'
                first = b == 0
                self.add_module(name, make_block(
                    self.block, n_in=in_ch, planes=planes,
                    stride=stride if first else 1,
                    use_downsample=first and (stride != 1
                                              or in_ch != planes * e),
                    dilation=dilation_in if first else dilation,
                    norm=norm, act=act,
                    zero_init_residual=zero_init_residual, groups=groups,
                    base_width=width_per_group, remat=remat,
                    generator=generator))
                names.append(name)
                in_ch = planes * e
            self._layer_names.append(names)
        if se:
            for i, n in enumerate(self.stages_n_channels):
                self.add_module(f'se_stage{i}', SqueezeAndExcitation(
                    n, act=act, generator=generator))

    @property
    def stages_n_channels(self) -> List[int]:
        e = block_expansion(self.block)
        return [64, 64 * e, 128 * e, 256 * e, 512 * e]

    @property
    def stages_downsampling(self) -> List[int]:
        d = self.replace_stride_with_dilation
        return [2, 4, 4 * 2 ** (1 - sum(d[:1])), 4 * 2 ** (2 - sum(d[:2])),
                4 * 2 ** (3 - sum(d))]

    def forward_stage(self, idx: int, x, generator=None):
        """`generator` feeds the blocks' channel dropout in training."""
        if idx == 0:
            x = self.act(self.norm1(self.conv1(x)))
        else:
            if idx == 1:
                x = F.max_pool2d(x, 3, stride=2, padding=1)
            for name in self._layer_names[idx - 1]:
                x = getattr(self, name)(x, generator)
        if self.se:
            x = getattr(self, f'se_stage{idx}')(x)
        return x


def get_resnet_backbone(name: str, block=None, n_input_channels: int = 3,
                        normalization: str = 'batchnorm',
                        activation: str = 'relu', remat: bool = False,
                        generator=None) -> ResNetBackbone:
    """A ResNet of a registry name: 'resnet{18,34,50,101}', with 'se'
    for per-stage SE and '-d16' for a dilated last stage; ResNet-50/101
    take bottleneck blocks, the others `block`. `remat`: each block
    recomputes its activations in the backward pass."""
    name = name.lower()
    base = name.replace('-d16', '')
    depth = base[len('resnet'):-2] if base.endswith('se') \
        else base[len('resnet'):]
    layers = {'18': (2, 2, 2, 2), '34': (3, 4, 6, 3), '50': (3, 4, 6, 3),
              '101': (3, 4, 23, 3)}.get(depth)
    if not base.startswith('resnet') or layers is None:
        raise ValueError(f"Unknown ResNet: '{name}'")
    block_name = ('bottleneck' if depth in ('50', '101')
                  else get_block_name(block))
    return ResNetBackbone(block=block_name, layers=layers,
                          replace_stride_with_dilation=(
                              False, False, '-d16' in name),
                          n_input_channels=n_input_channels,
                          norm=normalization, act=activation,
                          se=base.endswith('se'), remat=remat,
                          generator=generator)

"""RGB-D encoder fusion: channel-weighted add of rgb and depth features
(counterpart of nicr_mtsa_tpu/models/encoder_fusion.py)."""
from typing import Optional, Tuple

import torch.nn as nn

from .common import SqueezeAndExcitation

KNOWN_ENCODER_FUSIONS = ('se-add', 'add', 'add-uni-rgb', 'add-uni-depth',
                         'se-add-uni-rgb', 'se-add-uni-depth', 'none')


def get_encoder_fusion_kwargs(name: Optional[str] = None) -> dict:
    name = (name or 'add-uni-rgb').lower()
    if name not in KNOWN_ENCODER_FUSIONS:
        raise ValueError(f"Unknown encoder fusion: '{name}'")
    kwargs = {'use_se_weighting': 'se' in name}
    if 'uni-rgb' in name:
        kwargs['destinations'] = ('rgb',)
    elif 'uni-depth' in name:
        kwargs['destinations'] = ('depth',)
    elif name == 'none':
        kwargs['destinations'] = ()
    else:
        kwargs['destinations'] = ('rgb', 'depth')
    return kwargs


class EncoderRGBDFusionWeightedAdd(nn.Module):
    def __init__(self, n_channels_in: int,
                 destinations: Tuple[str, ...] = ('rgb',),
                 use_se_weighting: bool = False, act: str = 'relu',
                 generator=None):
        super().__init__()
        self.destinations = tuple(destinations)
        self.use_se_weighting = use_se_weighting
        if use_se_weighting:
            self.weighting_rgb = SqueezeAndExcitation(
                n_channels_in, act=act, generator=generator)
            self.weighting_depth = SqueezeAndExcitation(
                n_channels_in, act=act, generator=generator)

    def forward(self, x: dict) -> dict:
        x_rgb, x_depth = x['rgb'], x['depth']
        if self.use_se_weighting:
            fused = self.weighting_rgb(x_rgb) + self.weighting_depth(x_depth)
        else:
            fused = x_rgb + x_depth
        return {'rgb': fused if 'rgb' in self.destinations else x_rgb,
                'depth': fused if 'depth' in self.destinations else x_depth}

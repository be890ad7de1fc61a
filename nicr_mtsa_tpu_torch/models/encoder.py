"""Encoders (counterpart of nicr_mtsa_tpu/models/encoder.py): the
single-backbone `Encoder` (one modality, or the rgbd concat of a
4-channel backbone) and the dual-backbone `FusedRGBDEncoder` with
stage-interleaved fusion.

Contract: `forward({modality: x}) -> ({modality: out}, skips)` with
`skips = {str(downsampling): {modality: features}}`; in the fused
encoder the fused features feed the next stage of the destination
backbone(s)."""
from typing import List, Sequence, Tuple

import torch.nn as nn

from .backbones.base import Backbone
from .encoder_fusion import (EncoderRGBDFusionWeightedAdd,
                             get_encoder_fusion_kwargs)


def _skip_stage_indices(stages_downsampling: Sequence[int],
                        skip_downsamplings: Sequence[int]) -> List[int]:
    """Stage index captured for each skip downsampling: the last stage
    with that downsampling, unless it is the final stage."""
    n = len(stages_downsampling)
    indices = []
    for ds in skip_downsamplings:
        idx = n - 1 - list(stages_downsampling)[::-1].index(ds)
        if idx == n - 1:
            idx = list(stages_downsampling).index(ds)
        indices.append(idx)
    return indices


class Encoder(nn.Module):
    """Single-backbone encoder (one modality, or rgbd concat)."""

    def __init__(self, backbone: Backbone,
                 skip_downsamplings: Sequence[int] = (4, 8, 16)):
        super().__init__()
        self.backbone = backbone
        self.skip_downsamplings = tuple(skip_downsamplings)

    @property
    def _skip_idx(self) -> List[int]:
        return _skip_stage_indices(self.backbone.stages_downsampling,
                                   self.skip_downsamplings)

    @property
    def skips_n_channels(self) -> Tuple[int, ...]:
        return tuple(self.backbone.stages_n_channels[i]
                     for i in self._skip_idx)

    @property
    def skips_downsamplings(self) -> Tuple[int, ...]:
        return self.skip_downsamplings

    @property
    def n_channels_out(self) -> int:
        return self.backbone.stages_n_channels[-1]

    @property
    def downsampling(self) -> int:
        return self.backbone.stages_downsampling[-1]

    def forward(self, x: dict, generator=None):
        """`generator` feeds the backbone's random parts in training."""
        assert len(x) == 1
        key, y = next(iter(x.items()))
        outs = []
        for i in range(self.backbone.n_stages):
            y = self.backbone.forward_stage(i, y, generator)
            outs.append(y)
        skips = {str(ds): {key: outs[i]}
                 for ds, i in zip(self.skip_downsamplings, self._skip_idx)}
        return {key: outs[-1]}, skips


class FusedRGBDEncoder(nn.Module):
    def __init__(self, backbone_rgb: Backbone, backbone_depth: Backbone,
                 fusion: str = 'se-add-uni-rgb', act: str = 'relu',
                 skip_downsamplings: Sequence[int] = (4, 8, 16),
                 generator=None):
        super().__init__()
        assert backbone_rgb.stages_n_channels == \
            backbone_depth.stages_n_channels
        assert backbone_rgb.stages_downsampling == \
            backbone_depth.stages_downsampling
        self.backbone_rgb = backbone_rgb
        self.backbone_depth = backbone_depth
        self.skip_downsamplings = tuple(skip_downsamplings)
        kwargs = get_encoder_fusion_kwargs(fusion)
        for i, n in enumerate(backbone_rgb.stages_n_channels):
            self.add_module(f'fusion{i}', EncoderRGBDFusionWeightedAdd(
                n, act=act, generator=generator, **kwargs))

    @property
    def _skip_idx(self) -> List[int]:
        return _skip_stage_indices(self.backbone_rgb.stages_downsampling,
                                   self.skip_downsamplings)

    @property
    def skips_n_channels(self) -> Tuple[int, ...]:
        return tuple(self.backbone_rgb.stages_n_channels[i]
                     for i in self._skip_idx)

    @property
    def skips_downsamplings(self) -> Tuple[int, ...]:
        return self.skip_downsamplings

    @property
    def n_channels_out(self) -> int:
        return self.backbone_rgb.stages_n_channels[-1]

    @property
    def downsampling(self) -> int:
        return self.backbone_rgb.stages_downsampling[-1]

    def forward(self, x: dict, generator=None):
        idx_to_ds = {i: ds for ds, i in zip(self.skip_downsamplings,
                                            self._skip_idx)}
        skips = {}
        x_ = {'rgb': x['rgb'], 'depth': x['depth']}
        for i in range(self.backbone_rgb.n_stages):
            x_ = {'rgb': self.backbone_rgb.forward_stage(i, x_['rgb'],
                                                         generator),
                  'depth': self.backbone_depth.forward_stage(
                      i, x_['depth'], generator)}
            x_ = getattr(self, f'fusion{i}')(x_)
            if i in idx_to_ds:
                skips[str(idx_to_ds[i])] = dict(x_)
        return x_, skips

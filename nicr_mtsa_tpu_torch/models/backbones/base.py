"""Backbone interface: a sequence of stages with per-stage channel and
downsampling metadata (nicr_mtsa_tpu/models/backbones/base.py)."""
from typing import List

import torch.nn as nn


class Backbone(nn.Module):
    @property
    def stages_n_channels(self) -> List[int]:
        raise NotImplementedError

    @property
    def stages_downsampling(self) -> List[int]:
        raise NotImplementedError

    @property
    def n_stages(self) -> int:
        return len(self.stages_n_channels)

    def forward_stage(self, idx: int, x, generator=None):
        """Stage `idx` of NCHW x; `generator` feeds the stage's random
        parts in training mode, if it has any."""
        raise NotImplementedError

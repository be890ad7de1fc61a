"""Scene classification decoder: one Linear on the context module's
global-pool branch (counterpart of nicr_mtsa_tpu/models/decoders/
scene.py)."""
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..common import cached_weight


class SceneClassificationDecoder(nn.Module):
    def __init__(self, n_features: int, n_classes: int = 10,
                 generator=None):
        super().__init__()
        self.task_head = nn.Linear(n_features, n_classes)
        # fan-in normal kernel and zero bias, like flax's Dense default
        with torch.no_grad():
            self.task_head.weight.normal_(
                0.0, 1.0 / math.sqrt(n_features), generator=generator)
            self.task_head.bias.zero_()

    def batch_statistics(self, x, skips=None, generator=None):
        """Nothing: the decoder has no BatchNorm."""

    def forward(self, x, skips=None, generator=None):
        cm_output, cm_context_features = x
        if cm_context_features:
            feat = cm_context_features[0]
            if tuple(feat.shape[-2:]) != (1, 1):
                feat = feat.mean(dim=(-2, -1), keepdim=True)
        else:
            feat = cm_output.mean(dim=(-2, -1), keepdim=True)
        feat = feat.reshape(feat.shape[0], -1)
        dt = feat.dtype
        out = F.linear(feat, cached_weight(self.task_head, 'weight', dt),
                       cached_weight(self.task_head, 'bias', dt))
        return out, ()

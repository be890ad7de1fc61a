"""Backbone pretraining head (counterpart of nicr_mtsa_tpu/models/
backbones/pretraining.py): the global average pool of the backbone's
last stage and a linear classifier `fc`, as used to pretrain backbones
on ImageNet before scene-analysis training. Its names are the flax
module's (`backbone`, `fc`), so utils/flax_weights.py maps the JAX
module's variables over unchanged."""
import torch.nn as nn

from ..common import Linear
from .base import Backbone


class ImageNetClassifier(nn.Module):
    def __init__(self, backbone: Backbone, n_classes: int = 1000,
                 generator=None):
        super().__init__()
        self.backbone = backbone
        # flax's Dense initialisation (lecun-normal kernel, zero bias)
        self.fc = Linear(backbone.stages_n_channels[-1], n_classes,
                         std=None, generator=generator)

    def forward(self, x, generator=None):
        """NCHW `x` -> (B, n_classes) logits in the dtype of `x`."""
        for i in range(self.backbone.n_stages):
            x = self.backbone.forward_stage(i, x, generator)
        return self.fc(x.mean(dim=(2, 3)))

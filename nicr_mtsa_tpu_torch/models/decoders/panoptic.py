"""Panoptic helper (counterpart of nicr_mtsa_tpu/models/decoders/
panoptic.py): the semantic and the instance decoder run on the same
context features and skips, their raw outputs returned together as
((semantic, instance), (semantic sides, instance sides)), the form the
panoptic postprocessing takes."""
import torch.nn as nn


class PanopticHelper(nn.Module):
    def __init__(self, semantic_decoder: nn.Module,
                 instance_decoder: nn.Module):
        super().__init__()
        self.semantic_decoder = semantic_decoder
        self.instance_decoder = instance_decoder

    def forward(self, x, skips, generator=None):
        s_output, s_side = self.semantic_decoder(x, skips, generator)
        i_output, i_side = self.instance_decoder(x, skips, generator)
        return (s_output, i_output), (s_side, i_side)

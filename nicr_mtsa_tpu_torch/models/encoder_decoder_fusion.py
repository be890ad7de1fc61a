"""Encoder-decoder skip fusion (counterpart of nicr_mtsa_tpu/models/
encoder_decoder_fusion.py): pick the skip of one modality, optionally
LayerNorm it over the channels (`swin-ln-*`: flax `nn.LayerNorm`,
eps 1e-6, through the LN kernel), adapt its channels with a 1x1
ConvNormAct where they differ from the decoder's, then add it to the
decoder features (`add`) or return it (`select`)."""
from typing import Optional

import torch.nn as nn

from .common import ConvNormAct, FusedLayerNorm

KNOWN_ENCODER_DECODER_FUSIONS = (
    'add', 'add-rgb', 'add-depth',
    'select', 'select-rgb', 'select-depth',
    'swin-ln-add', 'swin-ln-add-rgb', 'swin-ln-add-depth',
    'swin-ln-select', 'swin-ln-select-rgb', 'swin-ln-select-depth',
    'swin-add', 'swin-add-rgb', 'swin-add-depth',
    'swin-select', 'swin-select-rgb', 'swin-select-depth',
    'none',
)
FLAX_LAYER_NORM_EPS = 1e-6


def parse_encoder_decoder_fusion(name: Optional[str] = None) -> dict:
    name = (name or 'add-rgb').lower()
    if name not in KNOWN_ENCODER_DECODER_FUSIONS:
        raise ValueError(f"Unknown encoder decoder fusion: '{name}'")
    if name == 'none':
        return {'operation': 'none', 'modality': None,
                'apply_layer_norm': False}
    modality = None                  # a single-modality skip: lazily
    if name.endswith('rgb'):
        modality = 'rgb'
    elif name.endswith('depth'):
        modality = 'depth'
    return {'operation': 'add' if 'add' in name else 'select',
            'modality': modality, 'apply_layer_norm': 'swin-ln' in name}


class EncoderDecoderFusion(nn.Module):
    def __init__(self, n_channels_encoder: int, n_channels_decoder: int,
                 operation: str = 'add', modality: Optional[str] = None,
                 apply_layer_norm: bool = False, norm: str = 'batchnorm',
                 act: str = 'relu', generator=None):
        super().__init__()
        self.operation = operation
        self.modality = modality
        self.ln = (FusedLayerNorm(n_channels_encoder, FLAX_LAYER_NORM_EPS)
                   if apply_layer_norm and operation != 'none' else None)
        self.adapter = None
        if operation != 'none' and n_channels_encoder != n_channels_decoder:
            self.adapter = ConvNormAct(
                n_channels_encoder, n_channels_decoder, 1, norm=norm,
                act=act, generator=generator)

    def forward(self, x_enc: dict, x_dec):
        if self.operation == 'none':
            return x_dec
        modality = self.modality
        if modality is None:
            assert len(x_enc) == 1
            modality = next(iter(x_enc))
        x = x_enc[modality]
        if self.ln is not None:              # over the channels (NCHW)
            x = self.ln(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        if self.adapter is not None:
            x = self.adapter(x)
        return x + x_dec if self.operation == 'add' else x

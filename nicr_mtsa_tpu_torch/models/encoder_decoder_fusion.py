"""Encoder-decoder skip fusion, `add` variants (counterpart of
nicr_mtsa_tpu/models/encoder_decoder_fusion.py): pick the skip of one
modality, adapt its channels with a 1x1 ConvNormAct where they differ
from the decoder's, and add."""
from typing import Optional

import torch.nn as nn

from .common import ConvNormAct

KNOWN_ENCODER_DECODER_FUSIONS = ('add', 'add-rgb', 'add-depth')


def parse_encoder_decoder_fusion(name: Optional[str] = None) -> dict:
    name = (name or 'add-rgb').lower()
    if name not in KNOWN_ENCODER_DECODER_FUSIONS:
        raise ValueError(f"Unsupported encoder decoder fusion in this "
                         f"port: '{name}'")
    modality = None
    if name.endswith('rgb'):
        modality = 'rgb'
    elif name.endswith('depth'):
        modality = 'depth'
    return {'modality': modality}


class EncoderDecoderFusion(nn.Module):
    def __init__(self, n_channels_encoder: int, n_channels_decoder: int,
                 modality: Optional[str] = None, norm: str = 'batchnorm',
                 act: str = 'relu', generator=None):
        super().__init__()
        self.modality = modality
        self.adapter = None
        if n_channels_encoder != n_channels_decoder:
            self.adapter = ConvNormAct(
                n_channels_encoder, n_channels_decoder, 1, norm=norm,
                act=act, generator=generator)

    def forward(self, x_enc: dict, x_dec):
        modality = self.modality
        if modality is None:
            assert len(x_enc) == 1
            modality = next(iter(x_enc))
        x = x_enc[modality]
        if self.adapter is not None:
            x = self.adapter(x)
        return x + x_dec

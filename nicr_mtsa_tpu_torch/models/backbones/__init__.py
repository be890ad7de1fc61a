"""Backbones of the port: ResNet-18/34 with basicblock or
nonbottleneck1d blocks, ResNet-50/101 with bottleneck blocks, each
also with per-stage SE (`*se`) or a dilated last stage (`*-d16`), and
Swin v1/v2 (single- or multimodal).
`get_backbone` is the registry (counterpart of nicr_mtsa_tpu/models/
backbones/__init__.py)."""
from .base import Backbone
from .resnet import ResNetBackbone, get_resnet_backbone
from .swin import ATTN_BACKENDS, SwinBackbone, get_swin_backbone

KNOWN_BACKBONES = (
    'resnet18', 'resnet34', 'resnet50', 'resnet101',
    'resnet18se', 'resnet34se', 'resnet50se', 'resnet101se',
    'resnet18-d16', 'resnet34-d16', 'resnet50-d16', 'resnet101-d16',
    'swin-t', 'swin-s', 'swin-b', 'swin-t-v2', 'swin-s-v2', 'swin-b-v2',
    'swin-t-128', 'swin-t-v2-128',
    'swin-multi-t', 'swin-multi-s', 'swin-multi-b',
    'swin-multi-t-v2', 'swin-multi-s-v2', 'swin-multi-b-v2',
    'swin-multi-t-128', 'swin-multi-t-v2-128',
)


def get_backbone(name: str, resnet_block=None, n_input_channels: int = 3,
                 normalization: str = 'batchnorm', activation: str = 'relu',
                 stochastic_depth=None, attn_backend: str = 'auto',
                 remat: bool = False, attn_chunk_size: int = 0,
                 generator=None) -> Backbone:
    """`stochastic_depth` (Swin only): the last block's rate, None for
    the variant's default; `attn_backend` (Swin only; a ResNet takes
    'auto'): one of ATTN_BACKENDS; `remat` (both families): every block
    recomputes its activations in the backward pass; `attn_chunk_size`
    (Swin only; a ResNet ignores it, as the JAX package's
    `build_model` passes it to Swin backbones only): images per
    window-attention chunk, 0 for the whole batch."""
    name = name.lower()
    if name not in KNOWN_BACKBONES:
        raise ValueError(f"Unsupported backbone in this port: '{name}'")
    if attn_backend not in ATTN_BACKENDS:
        raise ValueError(f"Unknown window-attention backend "
                         f"'{attn_backend}'; the port has "
                         f"{', '.join(map(repr, ATTN_BACKENDS))}")
    if name.startswith('resnet'):
        return get_resnet_backbone(name, block=resnet_block,
                                   n_input_channels=n_input_channels,
                                   normalization=normalization,
                                   activation=activation, remat=remat,
                                   generator=generator)
    return get_swin_backbone(name, n_input_channels=n_input_channels,
                             stochastic_depth=stochastic_depth,
                             attn_backend=attn_backend, remat=remat,
                             attn_chunk_size=attn_chunk_size,
                             generator=generator)


__all__ = ['ATTN_BACKENDS', 'Backbone', 'ResNetBackbone', 'SwinBackbone',
           'KNOWN_BACKBONES', 'get_backbone', 'get_resnet_backbone',
           'get_swin_backbone']

"""Pretrained backbones: one call from a registry name and a local
checkpoint to the port's backbone tensors, with the checkpoint surgery
of utils/torch_port.py applied, and a graft of those tensors into a
model (counterpart of nicr_mtsa_tpu/utils/pretrained.py):

    state = load_pretrained_backbone('resnet34', n_input_channels=1,
                                     checkpoint_path='resnet34.pth')
    merge_backbone_variables(model, state,
                             path=('encoder', 'backbone_depth'))

Checkpoint sources, in order: the `checkpoint_path` argument (a torch
.pth state dict, or a dict holding one under 'state_dict'), then
`$MTSA_PRETRAINED_DIR/<name>.pth`. Only local files are read: where the
JAX package falls back to torchvision's weight registry and its
download cache, the port raises with the same guidance (the card's
machine has no torchvision and no network).

The name's suffixes are stripped as the JAX package strips them ('se',
'-d16', '-v2', '-128'; 'swin-multi' reads 'swin'), so a '-v2' name
loads the v1 layout of its base name, as there."""
import os
from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn

from .torch_port import (adapt_first_conv, port_resnet_state_dict,
                         port_swin_state_dict)

_RESNET_LAYERS = {
    'resnet18': (2, 2, 2, 2), 'resnet34': (3, 4, 6, 3),
    'resnet50': (3, 4, 6, 3), 'resnet101': (3, 4, 23, 3),
}
_SWIN_DEPTHS = {
    'swin-t': (2, 2, 6, 2), 'swin-s': (2, 2, 18, 2),
    'swin-b': (2, 2, 18, 2),
}
# the names the JAX package would fetch from torchvision's registry
_TORCHVISION_NAMES = {
    'resnet18': 'resnet18', 'resnet34': 'resnet34',
    'resnet50': 'resnet50', 'resnet101': 'resnet101',
    'swin-t': 'swin_t', 'swin-s': 'swin_s', 'swin-b': 'swin_b',
}


def _load_state_dict(name: str, checkpoint_path: Optional[str]):
    if checkpoint_path is None:
        pre_dir = os.environ.get('MTSA_PRETRAINED_DIR')
        if pre_dir:
            cand = os.path.join(pre_dir, f'{name}.pth')
            if os.path.isfile(cand):
                checkpoint_path = cand

    if checkpoint_path is not None:
        obj = torch.load(checkpoint_path, map_location='cpu',
                         weights_only=True)
        return obj.get('state_dict', obj) if isinstance(obj, dict) else obj

    if name not in _TORCHVISION_NAMES:
        raise ValueError(
            f"no torchvision weights for '{name}'; pass checkpoint_path "
            f"or set $MTSA_PRETRAINED_DIR")
    raise RuntimeError(
        f"could not fetch torchvision weights for '{name}' "
        f"(offline? set $MTSA_PRETRAINED_DIR or pass "
        f"checkpoint_path to a local .pth): the port reads local "
        f"checkpoints only")


def load_pretrained_backbone(
    name: str,
    n_input_channels: int = 3,
    checkpoint_path: Optional[str] = None,
) -> Dict[str, torch.Tensor]:
    """Registry name -> {name: tensor} of the matching backbone of
    `models.backbones`, the stem adapted to depth (1) or rgbd (4)
    inputs."""
    base = name.lower()
    for suffix in ('se', '-d16', '-v2', '-128'):
        base = base.replace(suffix, '')
    base = base.replace('swin-multi', 'swin')

    state = _load_state_dict(base, checkpoint_path)

    if base.startswith('resnet'):
        return port_resnet_state_dict(
            state, layers=_RESNET_LAYERS[base],
            bottleneck=base in ('resnet50', 'resnet101'),
            n_input_channels=n_input_channels)

    if base in _SWIN_DEPTHS:
        out = port_swin_state_dict(state, depths=_SWIN_DEPTHS[base])
        if n_input_channels != 3:
            out['patch_embed.proj.weight'] = adapt_first_conv(
                out['patch_embed.proj.weight'], n_input_channels)
        return out

    raise ValueError(f"unknown pretrained backbone: '{name}'")


@torch.no_grad()
def merge_backbone_variables(
    model: nn.Module,
    backbone_state: Dict[str, torch.Tensor],
    path: Sequence[str] = ('encoder', 'backbone_rgb'),
) -> nn.Module:
    """Graft backbone tensors into `model` at the submodule `path` (()
    for the model itself), in place, and return `model`. Every tensor is
    checked before any is copied: one the model lacks raises KeyError,
    one of another shape ValueError. Each is cast to the dtype of the model's tensor; every
    other tensor of the model (SE modules, heads, decoders) keeps its
    value, as the reference's strict=False load with surgery."""
    targets = dict(model.named_parameters())
    targets.update(model.named_buffers())
    prefix = ''.join(f'{p}.' for p in path)
    pairs = []
    for key, value in backbone_state.items():
        dst = targets.get(prefix + key)
        if dst is None:
            raise KeyError(f'{"/".join(path)}/{key} not in model')
        if tuple(value.shape) != tuple(dst.shape):
            raise ValueError(
                f'{"/".join(path)}/{key}: checkpoint shape '
                f'{tuple(value.shape)} != model shape {tuple(dst.shape)}')
        pairs.append((dst, value))
    for dst, value in pairs:
        dst.copy_(torch.as_tensor(value).to(dst.dtype))
    return model

"""torchvision-layout state dicts -> the port's backbone names (own copy
of the checkpoint surgery of nicr_mtsa_tpu/utils/torch_port.py).

A torchvision ResNet or Swin state dict (or one saved by a training
run of the reference, with its wrapper prefixes) becomes a flat
{name: tensor} of the port's `ResNetBackbone` / `SwinBackbone`, with

- `model.` / `backbone.` / `_orig_mod.` stripped anywhere in a key
  (DataParallel, DDP and torch.compile artifacts) and the `fc` /
  `fc_embedding` heads dropped,
- the stem conv adapted to the input channels: 1 (depth) sums the RGB
  kernels; 4 (rgbd) appends the summed kernel and halves the whole,
- both `bn*` and the reference's `norm*` BatchNorm naming accepted,
- the Swin patch-merging neighbour order fixed: torchvision
  concatenates (0,0), (1,0), (0,1), (1,1), the port (as the JAX
  package) row-major (0,0), (0,1), (1,0), (1,1), so the reduction
  weight's input blocks, and for v1 the merging norm over those 4C
  inputs, are permuted.

The port's modules are torch, so kernels keep their OIHW / (out, in)
layouts. Only the keys the backbone needs are read: the dict's buffers
(`num_batches_tracked`, `relative_position_index`,
`relative_coords_table`), heads and any other key are ignored, as the
JAX package's reader ignores them."""
from typing import Any, Dict, Tuple

import numpy as np
import torch

# torchvision's patch-merging neighbour blocks in the port's order
_MERGE_ORDER = (0, 2, 1, 3)


def _t(value) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu()
    return torch.from_numpy(np.asarray(value))


def clean_state_dict_keys(state_dict: Dict[str, Any]) -> Dict[str, Any]:
    """Strip wrapper prefixes and drop classifier heads."""
    out = {}
    for key, value in state_dict.items():
        new_key = key.replace('model.', '').replace('backbone.', '')
        new_key = new_key.replace('_orig_mod.', '')
        out[new_key] = value
    for head in ('fc.weight', 'fc.bias',
                 'fc_embedding.weight', 'fc_embedding.bias'):
        out.pop(head, None)
    return out


def adapt_first_conv(kernel_oihw: torch.Tensor,
                     n_input_channels: int) -> torch.Tensor:
    """Channel surgery on the OIHW stem conv: 1 input channel sums the
    kernels over theirs, 4 appends that sum and halves the whole;
    another count than the kernel's raises ValueError."""
    c_in = kernel_oihw.shape[1]
    if c_in == n_input_channels:
        return kernel_oihw
    summed = kernel_oihw.sum(dim=1, keepdim=True)
    if n_input_channels == 1:
        return summed
    if n_input_channels == 4:
        return torch.cat([kernel_oihw, summed], 1) / 2.0
    raise ValueError(
        f'cannot adapt {c_in}-channel conv to {n_input_channels} inputs')


def _bn(state, prefix: str, name: str) -> Dict[str, torch.Tensor]:
    return {f'{name}.weight': _t(state[f'{prefix}.weight']),
            f'{name}.bias': _t(state[f'{prefix}.bias']),
            f'{name}.running_mean': _t(state[f'{prefix}.running_mean']),
            f'{name}.running_var': _t(state[f'{prefix}.running_var'])}


def port_resnet_state_dict(
    state_dict: Dict[str, Any],
    layers: Tuple[int, ...] = (2, 2, 2, 2),
    bottleneck: bool = False,
    n_input_channels: int = 3,
) -> Dict[str, torch.Tensor]:
    """torchvision ResNet state dict -> {name: tensor} of the port's
    `ResNetBackbone` (basicblock, or bottleneck for ResNet-50/101)."""
    state = clean_state_dict_keys(state_dict)
    for key in list(state):
        if '.norm' in key or key.startswith('norm'):
            state[key.replace('norm', 'bn')] = state.pop(key)

    out = {'conv1.weight': adapt_first_conv(_t(state['conv1.weight']),
                                            n_input_channels)}
    out.update(_bn(state, 'bn1', 'norm1'))
    n_convs = 3 if bottleneck else 2
    for li, n_blocks in enumerate(layers, start=1):
        for bi in range(n_blocks):
            t, name = f'layer{li}.{bi}', f'layer{li}_block{bi}'
            for ci in range(1, n_convs + 1):
                out[f'{name}.conv{ci}.weight'] = _t(
                    state[f'{t}.conv{ci}.weight'])
                out.update(_bn(state, f'{t}.bn{ci}', f'{name}.norm{ci}'))
            if f'{t}.downsample.0.weight' in state:
                out[f'{name}.downsample.conv.weight'] = _t(
                    state[f'{t}.downsample.0.weight'])
                out.update(_bn(state, f'{t}.downsample.1',
                               f'{name}.downsample.norm'))
    return out


def _merge_blocks(t: torch.Tensor, C: int, dim: int) -> torch.Tensor:
    """`t`'s four C-wide neighbour blocks along `dim` in the port's
    order."""
    return torch.cat([t.narrow(dim, k * C, C) for k in _MERGE_ORDER], dim)


def port_swin_state_dict(
    state_dict: Dict[str, Any],
    depths: Tuple[int, ...] = (2, 2, 6, 2),
    v2: bool = False,
) -> Dict[str, torch.Tensor]:
    """torchvision-style Swin state dict -> {name: tensor} of the port's
    `SwinBackbone`. torchvision's layout: features.0 is the patch embed
    (conv, permute, LN), features.{1,3,5,7} the block stages,
    features.{2,4,6} the patch mergings, `norm` the last LN. v1 ports
    each block's relative-position bias table; v2 its `logit_scale` and
    the log-CPB MLP (`cpb_mlp.0/.2` -> `cpb_fc1` / `cpb_fc2`), and its
    merging norm acts on the reduced 2C features, so only the reduction
    weight is permuted."""
    state = clean_state_dict_keys(state_dict)
    out = {'patch_embed.proj.weight': _t(state['features.0.0.weight']),
           'patch_embed.proj.bias': _t(state['features.0.0.bias']),
           'patch_embed.norm.weight': _t(state['features.0.2.weight']),
           'patch_embed.norm.bias': _t(state['features.0.2.bias'])}
    for stage, depth in enumerate(depths):
        for b in range(depth):
            t, name = f'features.{1 + 2 * stage}.{b}', \
                f'layer{stage + 1}_block{b}'
            pairs = {'norm1': 'norm1', 'norm2': 'norm2',
                     'attn.qkv': 'attn.qkv', 'attn.proj': 'attn.proj',
                     'mlp.0': 'mlp_fc1', 'mlp.3': 'mlp_fc2'}
            if v2:
                pairs['attn.cpb_mlp.0'] = 'attn.cpb_fc1'
                out[f'{name}.attn.logit_scale'] = _t(
                    state[f'{t}.attn.logit_scale'])
                out[f'{name}.attn.cpb_fc2.weight'] = _t(
                    state[f'{t}.attn.cpb_mlp.2.weight'])
            else:
                out[f'{name}.attn.relative_position_bias_table'] = _t(
                    state[f'{t}.attn.relative_position_bias_table'])
            for src, dst in pairs.items():
                out[f'{name}.{dst}.weight'] = _t(state[f'{t}.{src}.weight'])
                out[f'{name}.{dst}.bias'] = _t(state[f'{t}.{src}.bias'])
        if stage < 3:
            t, name = f'features.{2 + 2 * stage}', f'merge{stage + 1}'
            red = _t(state[f'{t}.reduction.weight'])       # (2C, 4C)
            C = red.shape[1] // 4
            scale = _t(state[f'{t}.norm.weight'])
            bias = _t(state[f'{t}.norm.bias'])
            if not v2:
                scale, bias = (_merge_blocks(scale, C, 0),
                               _merge_blocks(bias, C, 0))
            out[f'{name}.reduction.weight'] = _merge_blocks(red, C, 1)
            out[f'{name}.norm.weight'] = scale
            out[f'{name}.norm.bias'] = bias
    out['norm.weight'] = _t(state['norm.weight'])
    out['norm.bias'] = _t(state['norm.bias'])
    return out

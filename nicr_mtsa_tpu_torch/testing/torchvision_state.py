"""Seeded state dicts in torchvision's layout, written in place of
ImageNet checkpoints (nothing is downloaded): a ResNet (basic or
bottleneck blocks) and a Swin v1 or v2, with the classifier head and
the buffers torchvision saves (`num_batches_tracked`,
`relative_position_index`, `relative_coords_table`), optionally under
a wrapper prefix. Values come from a seeded `torch.Generator`:
weights normal with std 1 / sqrt(fan-in), the other leaves with std
`std` around their identity values, BatchNorm variances in [0.5, 1.5);
every leaf (and each of a patch merging's four neighbour blocks)
distinct."""
from typing import Dict, Tuple

import torch

_RESNET_PLANES = (64, 128, 256, 512)


class _Filler:
    def __init__(self, seed: int, std: float):
        self.g = torch.Generator().manual_seed(seed)
        self.std = std

    def normal(self, *shape):
        return torch.randn(shape, generator=self.g) * self.std

    def weight(self, *shape):
        """A conv or linear weight, its std 1 / sqrt(fan-in): outputs
        keep their scale through a deep stack in eval mode."""
        fan_in = 1
        for n in shape[1:]:
            fan_in *= n
        return torch.randn(shape, generator=self.g) / fan_in ** 0.5

    def bn(self, state, prefix, n):
        state[f'{prefix}.weight'] = 1.0 + self.normal(n)
        state[f'{prefix}.bias'] = self.normal(n)
        state[f'{prefix}.running_mean'] = self.normal(n)
        state[f'{prefix}.running_var'] = 0.5 + torch.rand(n, generator=self.g)
        state[f'{prefix}.num_batches_tracked'] = torch.tensor(1000)

    def ln(self, state, prefix, n):
        state[f'{prefix}.weight'] = 1.0 + self.normal(n)
        state[f'{prefix}.bias'] = self.normal(n)

    def linear(self, state, prefix, n_out, n_in, bias=True):
        state[f'{prefix}.weight'] = self.weight(n_out, n_in)
        if bias:
            state[f'{prefix}.bias'] = self.normal(n_out)


def _prefixed(state: Dict[str, torch.Tensor], prefix: str):
    return {prefix + k: v for k, v in state.items()}


def resnet_state_dict(layers: Tuple[int, ...] = (2, 2, 2, 2),
                      bottleneck: bool = False, n_classes: int = 1000,
                      seed: int = 0, std: float = 0.05, prefix: str = ''
                      ) -> Dict[str, torch.Tensor]:
    """torchvision `resnet*().state_dict()`'s keys and shapes."""
    f, s = _Filler(seed, std), {}
    s['conv1.weight'] = f.weight(64, 3, 7, 7)
    f.bn(s, 'bn1', 64)
    e = 4 if bottleneck else 1
    n_in = 64
    for li, (planes, n_blocks) in enumerate(zip(_RESNET_PLANES, layers), 1):
        for b in range(n_blocks):
            t = f'layer{li}.{b}'
            stride = 2 if li > 1 and b == 0 else 1
            if bottleneck:
                convs = ((planes, n_in, 1), (planes, planes, 3),
                         (planes * e, planes, 1))
            else:
                convs = ((planes, n_in, 3), (planes, planes, 3))
            for ci, (o, i, k) in enumerate(convs, 1):
                s[f'{t}.conv{ci}.weight'] = f.weight(o, i, k, k)
                f.bn(s, f'{t}.bn{ci}', o)
            if b == 0 and (stride != 1 or n_in != planes * e):
                s[f'{t}.downsample.0.weight'] = f.weight(planes * e, n_in,
                                                         1, 1)
                f.bn(s, f'{t}.downsample.1', planes * e)
            n_in = planes * e
    f.linear(s, 'fc', n_classes, n_in)
    return _prefixed(s, prefix)


def swin_state_dict(embed_dim: int = 96,
                    depths: Tuple[int, ...] = (2, 2, 6, 2),
                    n_heads: Tuple[int, ...] = (3, 6, 12, 24),
                    window_size: int = 7, v2: bool = False,
                    n_classes: int = 1000, seed: int = 0, std: float = 0.05,
                    prefix: str = '') -> Dict[str, torch.Tensor]:
    """torchvision `swin_*()` / `swin_v2_*()`'s keys and shapes."""
    f, s = _Filler(seed, std), {}
    s['features.0.0.weight'] = f.weight(embed_dim, 3, 4, 4)
    s['features.0.0.bias'] = f.normal(embed_dim)
    f.ln(s, 'features.0.2', embed_dim)
    n_rel = (2 * window_size - 1) ** 2
    for stage, (depth, heads) in enumerate(zip(depths, n_heads)):
        C = embed_dim * 2 ** stage
        for b in range(depth):
            t = f'features.{1 + 2 * stage}.{b}'
            f.ln(s, f'{t}.norm1', C)
            f.linear(s, f'{t}.attn.qkv', 3 * C, C)
            f.linear(s, f'{t}.attn.proj', C, C)
            if v2:
                s[f'{t}.attn.logit_scale'] = torch.log(
                    10 * torch.ones(heads, 1, 1)) + f.normal(heads, 1, 1)
                f.linear(s, f'{t}.attn.cpb_mlp.0', 512, 2)
                f.linear(s, f'{t}.attn.cpb_mlp.2', heads, 512, bias=False)
                s[f'{t}.attn.relative_coords_table'] = torch.zeros(
                    1, 2 * window_size - 1, 2 * window_size - 1, 2)
            else:
                s[f'{t}.attn.relative_position_bias_table'] = f.normal(
                    n_rel, heads)
            s[f'{t}.attn.relative_position_index'] = torch.zeros(
                window_size ** 4, dtype=torch.int64)
            f.ln(s, f'{t}.norm2', C)
            f.linear(s, f'{t}.mlp.0', 4 * C, C)
            f.linear(s, f'{t}.mlp.3', C, 4 * C)
        if stage < len(depths) - 1:
            t = f'features.{2 + 2 * stage}'
            f.linear(s, f'{t}.reduction', 2 * C, 4 * C, bias=False)
            f.ln(s, f'{t}.norm', 2 * C if v2 else 4 * C)
    C = embed_dim * 2 ** (len(depths) - 1)
    f.ln(s, 'norm', C)
    f.linear(s, 'head', n_classes, C)
    return _prefixed(s, prefix)

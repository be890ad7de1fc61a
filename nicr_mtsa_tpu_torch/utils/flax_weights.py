"""Fill the port's modules from the JAX package's flax variables.

`variables` is `{'params': ..., 'batch_stats': ...}` as nested dicts of
numpy arrays (for example `jax.tree_util.tree_map(np.asarray, v)`).
The port names its submodules after the flax modules, so a flax path
maps to a torch name by dropping the unnamed `BatchNorm_0` and
`LayerNorm_0` levels (inside the `Norm` wrapper) and renaming the leaf:

  params       kernel/scale -> weight, bias -> bias,
               relative_position_bias_table, logit_scale (Swin): as is
  batch_stats  mean -> running_mean, var -> running_var

and the `kernel` layouts convert as
  4-d conv kernel HWIO (depthwise (3, 3, 1, C))  -> OIHW ((C, 1, 3, 3))
  2-d Dense kernel (in, out)                     -> (out, in)
(for example a Swin qkv kernel (C, 3C) -> (3C, C)); other leaves keep
their shapes (a v2 `logit_scale` stays (h, 1, 1), a v1 bias table
((2ws-1)^2, h)).

Strict: every leaf is consumed and every torch parameter and buffer is
filled, with matching shapes, or it raises."""
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

_LEAF_NAMES = {
    'params': {'kernel': 'weight', 'scale': 'weight', 'bias': 'bias',
               'relative_position_bias_table':
                   'relative_position_bias_table',
               'logit_scale': 'logit_scale'},
    'batch_stats': {'mean': 'running_mean', 'var': 'running_var'},
}
_WRAPPED_LEVELS = ('BatchNorm_0', 'LayerNorm_0')


def _walk(tree, prefix=()) -> Iterator[Tuple[Tuple[str, ...], object]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _to_torch_layout(a: np.ndarray, leaf_name: str) -> np.ndarray:
    if leaf_name != 'kernel':
        return a
    if a.ndim == 4:
        return a.transpose(3, 2, 0, 1)
    if a.ndim == 2:
        return a.T
    return a


def flax_to_torch_state(variables: Dict) -> Dict[str, np.ndarray]:
    """Flat {torch name: array in torch layout}."""
    state = {}
    for collection, renames in _LEAF_NAMES.items():
        for path, leaf in _walk(variables.get(collection, {})):
            *mods, leaf_name = (p for p in path
                                if p not in _WRAPPED_LEVELS)
            if leaf_name not in renames:
                raise KeyError(f'unknown {collection} leaf: '
                               f"{'/'.join(path)}")
            name = '.'.join(mods + [renames[leaf_name]])
            if name in state:
                raise KeyError(f'two flax leaves map to {name}')
            state[name] = _to_torch_layout(np.asarray(leaf), leaf_name)
    unknown = set(variables) - set(_LEAF_NAMES)
    if unknown:
        raise KeyError(f'unknown variable collections: {sorted(unknown)}')
    return state


def load_flax_variables(model: torch.nn.Module, variables: Dict) -> None:
    """Copy flax variables into `model` in place (strict)."""
    state = flax_to_torch_state(variables)
    targets = dict(model.named_parameters())
    targets.update(model.named_buffers())
    missing = sorted(set(targets) - set(state))
    unused = sorted(set(state) - set(targets))
    if missing or unused:
        raise KeyError(f'flax/torch mismatch: torch names not filled '
                       f'{missing}; flax leaves not consumed {unused}')
    with torch.no_grad():
        for name, t in targets.items():
            src = torch.from_numpy(np.ascontiguousarray(state[name]))
            if tuple(src.shape) != tuple(t.shape):
                raise ValueError(f'{name}: flax shape {tuple(src.shape)} '
                                 f'!= torch shape {tuple(t.shape)}')
            t.copy_(src.to(t.dtype))

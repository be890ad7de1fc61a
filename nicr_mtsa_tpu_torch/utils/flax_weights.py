"""Fill the port's modules from the JAX package's flax variables, and
map flax trees (gradients, updated parameters, BatchNorm statistics) to
the port's names and back.

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

Both layout changes only permute a leaf's elements, so the same map
takes a gradient tree or an updated parameter tree of the JAX package
to the port's names (`flax_tree_to_torch`), and its inverse takes the
port's tensors into a flax tree (`torch_to_flax_variables`).

A model with recompute (`backbone_remat`, `decoder_remat`) or
attention chunking has the tree of the model without: flax's `nn.remat`
keeps the blocks' names and the port's `remat` is a plain attribute, so
the variables of such a JAX model map over unchanged (and back).

Strict: every leaf is consumed and every torch parameter and buffer is
filled, with matching shapes, or it raises. So a tree and a model must
come from the same mode: a training init of the JAX package
(`init(..., train=True)`) has the dense decoders' `side_head{i}`
leaves, which only a model built for training
(`build_model(..., train=True)`) has; an eval-mode init and a serving
model have neither."""
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


def _to_flax_layout(a: np.ndarray, leaf_name: str) -> np.ndarray:
    """Inverse of `_to_torch_layout`."""
    if leaf_name != 'kernel':
        return a
    if a.ndim == 4:
        return a.transpose(2, 3, 1, 0)
    if a.ndim == 2:
        return a.T
    return a


def torch_name(collection: str, path: Tuple[str, ...]) -> Tuple[str, str]:
    """(torch name, flax leaf name) of the flax leaf at `path` of
    `collection`."""
    *mods, leaf_name = (p for p in path if p not in _WRAPPED_LEVELS)
    renames = _LEAF_NAMES[collection]
    if leaf_name not in renames:
        raise KeyError(f"unknown {collection} leaf: {'/'.join(path)}")
    return '.'.join(mods + [renames[leaf_name]]), leaf_name


def flax_to_torch_state(variables: Dict) -> Dict[str, np.ndarray]:
    """Flat {torch name: array in torch layout}."""
    state = {}
    for collection in _LEAF_NAMES:
        for path, leaf in _walk(variables.get(collection, {})):
            name, leaf_name = torch_name(collection, path)
            if name in state:
                raise KeyError(f'two flax leaves map to {name}')
            state[name] = _to_torch_layout(np.asarray(leaf), leaf_name)
    unknown = set(variables) - set(_LEAF_NAMES)
    if unknown:
        raise KeyError(f'unknown variable collections: {sorted(unknown)}')
    return state


def flax_tree_to_torch(tree: Dict, collection: str = 'params'
                       ) -> Dict[str, np.ndarray]:
    """A tree shaped like the flax `collection` (gradients or updated
    parameters for 'params', statistics after a step for
    'batch_stats') as {torch name: array in torch layout}."""
    return flax_to_torch_state({collection: tree})


def torch_to_flax_variables(model: torch.nn.Module, template: Dict) -> Dict:
    """The model's parameters and buffers as flax variables shaped like
    `template` ({'params': ..., 'batch_stats': ...} nested dicts whose
    leaves have `.shape`, for example from `jax.eval_shape`): nested
    dicts of f32 numpy arrays in flax layout. Strict as the loader."""
    tensors = dict(model.named_parameters())
    tensors.update(model.named_buffers())
    used = set()

    def fill(tree, collection, prefix=()):
        out = {}
        for k, v in tree.items():
            if hasattr(v, 'items'):
                out[k] = fill(v, collection, prefix + (k,))
                continue
            name, leaf_name = torch_name(collection, prefix + (k,))
            if name not in tensors:
                raise KeyError(f'flax leaf {"/".join(prefix + (k,))} has no '
                               f'torch tensor {name}')
            a = _to_flax_layout(
                tensors[name].detach().float().cpu().numpy(), leaf_name)
            if tuple(a.shape) != tuple(v.shape):
                raise ValueError(f'{name}: torch shape {tuple(a.shape)} != '
                                 f'flax shape {tuple(v.shape)}')
            used.add(name)
            out[k] = np.ascontiguousarray(a)
        return out

    unknown = set(template) - set(_LEAF_NAMES)
    if unknown:
        raise KeyError(f'unknown variable collections: {sorted(unknown)}')
    out = {c: fill(template[c], c) for c in template}
    unused = sorted(set(tensors) - used)
    if unused:
        raise KeyError(f'torch tensors without a flax leaf: {unused}')
    return out


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

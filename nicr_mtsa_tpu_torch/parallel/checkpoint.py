"""Checkpoints of a train state (counterpart of
nicr_mtsa_tpu/parallel/checkpoint.py `save_checkpoint` /
`load_checkpoint`): one `torch.save` file of plain state dicts, read
back with `torch.load(weights_only=True)`.

A train state is `MultiTaskPipeline.create_train_state()`'s dict:
'params' and 'batch_stats' (the model's own tensors, by name),
'opt_state' (the AdamW `count`, `mu`, `nu`) and 'step'. The file holds
{'state': {'params', 'batch_stats', 'opt_state': {'count', 'mu', 'nu'},
'step'} as CPU tensors, 'extra': the host-side trainer state (epoch,
the loss weighting's `state_dict()`) of plain Python values}.

Loading into a `target` train state copies every leaf into the
target's tensors in place (so into the model the pipeline trains), on
their devices; a leaf missing on either side, or of another shape or
dtype, raises, as the JAX package's `_check_leaf` does. A JAX train
state converts through `utils/flax_weights.py`
(`flax_train_state_to_torch`) into the same plain form."""
import os
from typing import Any, Dict, Optional

import torch

from ..optim import AdamWState


def _cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().to('cpu', copy=True)
    return {k: _cpu(v) for k, v in tree.items()}


def train_state_dict(state: Dict[str, Any]) -> Dict[str, Any]:
    """The train state as plain dicts of CPU tensors."""
    opt = state['opt_state']
    return {'params': _cpu(state['params']),
            'batch_stats': _cpu(state['batch_stats']),
            'opt_state': {'count': _cpu(opt.count), 'mu': _cpu(opt.mu),
                          'nu': _cpu(opt.nu)},
            'step': _cpu(state['step'])}


def _file(path: str) -> str:
    return path if path.endswith('.pt') else path + '.pt'


def save_checkpoint(path: str, state: Dict[str, Any],
                    extra: Optional[Dict[str, Any]] = None) -> str:
    """Save a train state and the host-side `extra` to `path` ('.pt'
    appended unless it ends so); returns the file's path."""
    path = _file(path)
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    tmp = f'{path}.{os.getpid()}.tmp'
    torch.save({'state': train_state_dict(state), 'extra': extra}, tmp)
    os.replace(tmp, path)
    return path


def _copy_leaf(src, dst: torch.Tensor, where: str) -> None:
    if not isinstance(src, torch.Tensor):
        raise ValueError(f'checkpoint leaf {where!r} is not a tensor')
    if src.shape != dst.shape or src.dtype != dst.dtype:
        raise ValueError(
            f'checkpoint leaf {where!r} has shape/dtype '
            f'{tuple(src.shape)}/{src.dtype}, expected '
            f'{tuple(dst.shape)}/{dst.dtype}')
    dst.copy_(src)


def _copy_tree(src: dict, dst: dict, where: str) -> None:
    if not isinstance(src, dict) or set(src) != set(dst):
        missing = sorted(set(dst) - set(src)) if isinstance(src, dict) \
            else '(not a dict)'
        unknown = sorted(set(src) - set(dst)) if isinstance(src, dict) \
            else ''
        raise ValueError(f'checkpoint node {where!r}: missing {missing}, '
                         f'unknown {unknown}')
    for k, t in dst.items():
        _copy_leaf(src[k], t, f'{where}/{k}')


@torch.no_grad()
def load_train_state(target: Dict[str, Any], state: Dict[str, Any]
                     ) -> Dict[str, Any]:
    """Copy a plain train state (`train_state_dict`'s form) into the
    tensors of `target`, checked leaf by leaf; returns `target`."""
    opt = target['opt_state']
    if not isinstance(opt, AdamWState):
        raise TypeError('the target optimizer state is not an AdamWState')
    _copy_tree(state['params'], target['params'], '/params')
    _copy_tree(state['batch_stats'], target['batch_stats'], '/batch_stats')
    src = state['opt_state']
    _copy_leaf(src['count'], opt.count, '/opt_state/count')
    _copy_tree(src['mu'], opt.mu, '/opt_state/mu')
    _copy_tree(src['nu'], opt.nu, '/opt_state/nu')
    _copy_leaf(state['step'], target['step'], '/step')
    return target


def load_checkpoint(path: str, target: Optional[Dict[str, Any]] = None):
    """(state, extra) of a checkpoint of `save_checkpoint`. With
    `target` (a train state, e.g. a fresh `create_train_state()`) the
    state is loaded into it and returned; without, the plain dicts of
    CPU tensors."""
    data = torch.load(_file(path), map_location='cpu', weights_only=True)
    state = data['state']
    if target is not None:
        state = load_train_state(target, state)
    return state, data.get('extra')

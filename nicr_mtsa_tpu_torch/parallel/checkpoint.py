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
(`flax_train_state_to_torch`) into the same plain form.

`StepCheckpointManager` keeps step-numbered checkpoints of a training
run in one directory (`step_<n>.pt`), the last `max_to_keep` of them
(the JAX package's rules without orbax), and resumes from the latest.
Its save copies the state to the host once, then writes and prunes in
a background thread; an error there is raised by the manager's next
call or by `wait_until_finished`."""
import copy
import os
import shutil
import threading
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


def _write(path: str, data: Dict[str, Any]) -> str:
    path = _file(path)
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    tmp = f'{path}.{os.getpid()}.tmp'
    torch.save(data, tmp)
    os.replace(tmp, path)
    return path


def save_checkpoint(path: str, state: Dict[str, Any],
                    extra: Optional[Dict[str, Any]] = None) -> str:
    """Save a train state and the host-side `extra` to `path` ('.pt'
    appended unless it ends so); returns the file's path."""
    return _write(path, {'state': train_state_dict(state), 'extra': extra})


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


def _is_step_temp(name: str) -> bool:
    """A `step_<n>.pt.<pid>.tmp` that `_write` leaves where a write was
    killed before its rename."""
    return name.startswith('step_') and name.endswith('.tmp')


def _writer_alive(name: str) -> bool:
    """Whether the process that named a temp file `step_<n>.pt.<pid>.tmp`
    runs still, other than this one (whose write is renamed before its
    prune)."""
    pid = name.split('.')[-2]
    if not pid.isdigit() or int(pid) == os.getpid():
        return False
    try:
        os.kill(int(pid), 0)
    except ProcessLookupError:
        return False
    except PermissionError:                   # another user's process
        return True
    return True


def _step_of(name: str) -> Optional[int]:
    """n of a file `step_<n>[.<suffixes>]` (not a write's temp file),
    else None."""
    base = name.split('.')[0]
    if (base.startswith('step_') and base[5:].isdigit()
            and not _is_step_temp(name)):
        return int(base[5:])
    return None


class StepCheckpointManager:
    """Step-numbered checkpoints of a training run in `directory`, the
    last `max_to_keep` kept, resumed by `latest_step` / `restore`
    (counterpart of the JAX package's `StepCheckpointManager` on its
    path without orbax)."""

    def __init__(self, directory: str, max_to_keep: int = 3) -> None:
        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)
        self._max_to_keep = max_to_keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _path(self, step: int) -> str:
        return os.path.join(self._dir, f'step_{step}')

    def save(self, step: int, state: Dict[str, Any],
             extra: Optional[Dict[str, Any]] = None) -> None:
        """Copy `state` (and `extra`) to the host now, then write
        `step_<step>.pt` and drop the steps beyond the last
        `max_to_keep` in a background thread (one write at a time)."""
        self.wait_until_finished()
        data = {'state': train_state_dict(state),
                'extra': copy.deepcopy(extra)}
        path = self._path(step)

        def write():
            try:
                _write(path, data)
                self._prune()
            except BaseException as e:        # raised by the next call
                self._error = e
        self._thread = threading.Thread(target=write,
                                        name=f'checkpoint-step-{step}')
        self._thread.start()

    def _prune(self) -> None:
        """keep-last-N: delete the files (and directories) of the steps
        before the last `max_to_keep`, and the temp files of killed
        writes (this manager's own write has been renamed by now; a
        temp file of another live process is its write in flight and
        stays)."""
        steps: Dict[int, list] = {}
        for name in os.listdir(self._dir):
            if _is_step_temp(name):
                if not _writer_alive(name):
                    os.remove(os.path.join(self._dir, name))
                continue
            step = _step_of(name)
            if step is not None:
                steps.setdefault(step, []).append(name)
        for step in sorted(steps)[:-self._max_to_keep or None]:
            for name in steps[step]:
                full = os.path.join(self._dir, name)
                if os.path.isdir(full):
                    shutil.rmtree(full)
                else:
                    os.remove(full)

    def wait_until_finished(self) -> None:
        """Wait for the write in flight; raise the error of a failed
        one."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def latest_step(self) -> Optional[int]:
        self.wait_until_finished()
        steps = [s for s in map(_step_of, os.listdir(self._dir))
                 if s is not None]
        return max(steps) if steps else None

    def restore(self, step: Optional[int] = None,
                target: Optional[Dict[str, Any]] = None):
        """(state, extra) of `step` (default: the latest; (None, None)
        where there is none), loaded into `target` where given, as
        `load_checkpoint`."""
        if step is None:
            step = self.latest_step()
        else:
            self.wait_until_finished()
        if step is None:
            return None, None
        return load_checkpoint(self._path(step), target=target)

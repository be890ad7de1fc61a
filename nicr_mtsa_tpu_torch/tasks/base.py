"""Task-helper base (counterpart of nicr_mtsa_tpu/tasks/base.py).

A task helper wires one task's losses and metric states around the
shared batch dict, for the training step and the fused eval step:

- `compute_losses(batch, predictions_post) -> {name: loss}` (under
  autograd in training; `training_step` wraps it as the JAX helpers'
  `(losses, logs)`),
- `empty_metric_states(device)`, `update_metric_states(state, batch,
  predictions_post) -> state` (device tensors, no host sync),
- `load_metric_states(state)` then `validation_epoch_end() ->
  (artifacts, examples, logs)` on the host;

and for the eager validation loop (the JAX package's `validation_step`
path): `validation_step(batch, batch_idx, predictions_post) -> (losses,
logs)` accumulates the helper's own states through the same
`update_metric_states` (the GT angle tables walked from the batch's id
dicts, as the JAX package walks them), with the losses mirrored into
the logs and the step's host time under `<task>_step_time`; after an
eager epoch `validation_epoch_end` also logs `<task>_epoch_end_time`
(a fused epoch's logs stay the states' metrics). `initialize()` makes
the losses and metrics anew. Example images (`store_examples`) are not
ported and raise.

`prediction_keys` names the postprocessed keys the helper reads; the
step computes no full-resolution output beyond those and the caller's.

Multiscale supervision (the JAX package's pairing): a dense decoder's
side outputs carry no scale, so each one's downscale k is the main
output's width over its own, and its targets are the batch's
`_down_<k>` sub-dict, under the loss key `down_<k>`; a side output
without that sub-dict gets no loss (the bench's batches have none)."""
from functools import wraps
from time import perf_counter

import torch

from ..data.fullres import get_fullres
from ._orientation_tables import gt_slot_angles

TOTAL_LOSS_SUFFIX = '_total_loss'
MULTI_DOWNSCALE_KEY_FMT = '_down_{}'


def get_total_loss_key(key: str) -> str:
    return f'{key}{TOTAL_LOSS_SUFFIX}'


def get_downscale(batch: dict, downscale: int):
    """The batch's targets at 1 / `downscale` resolution, or None."""
    return batch.get(MULTI_DOWNSCALE_KEY_FMT.format(downscale), None)


def _spatial_width(output) -> int:
    """Width of a prediction (NCHW or (B, H, W)); a multi-head output (a
    tuple) reports its first head's."""
    head = output[0] if isinstance(output, (tuple, list)) else output
    return head.shape[-1]


def append_detached_losses_to_logs(step_fn):
    """Mirror every loss of the step, detached, into its log dict."""
    @wraps(step_fn)
    def wrapper(*args, **kwargs):
        losses, logs = step_fn(*args, **kwargs)
        logs.update({k: v.detach() if isinstance(v, torch.Tensor) else v
                     for k, v in losses.items()})
        return losses, logs
    return wrapper


def append_profile_to_logs(key: str):
    """Record the step's host wall time (s) under `key` in the log dict
    it returns last."""
    def decorator(step_fn):
        @wraps(step_fn)
        def wrapper(*args, **kwargs):
            tic = perf_counter()
            results = step_fn(*args, **kwargs)
            results[-1][key] = perf_counter() - tic
            return results
        return wrapper
    return decorator


def epoch_end(key: str):
    """The helper's `validation_epoch_end`: after an eager epoch it
    first takes the states its `validation_step`s accumulated and logs
    its host time under `key`; the states of a fused epoch are the ones
    `load_metric_states` was given."""
    def decorator(fn):
        @wraps(fn)
        def wrapper(self):
            eager = self._eager_epoch
            tic = perf_counter()
            if eager:
                self.load_metric_states(self._eager_states)
            results = fn(self)
            self._eager_states, self._eager_epoch = None, False
            if eager:
                results[-1][key] = perf_counter() - tic
            return results
        return wrapper
    return decorator


def refuse_examples(store_examples: bool) -> None:
    if store_examples:
        raise NotImplementedError('store_examples (the example images of '
                                  'the validation step) is not ported')


class TaskHelperBase:
    prediction_keys = ()
    # further postprocessed keys the eager `validation_step` reads
    validation_keys = ()
    # the states of the eager steps since the last epoch end
    _eager_epoch = False
    _eager_states = None

    def initialize(self) -> None:
        """Make the losses and metrics anew (the JAX helpers' late
        construction)."""

    def validation_step(self, batch, batch_idx, predictions_post):
        raise NotImplementedError(f'{type(self).__name__} has no eager '
                                  f'validation_step in the port yet')

    def update_eagerly(self, batch, predictions_post) -> None:
        """One eager step's metric update, into the helper's own
        states."""
        self._eager_states = self.update_metric_states(
            self._eager_states, batch, predictions_post)
        self._eager_epoch = True

    @staticmethod
    def with_gt_angle_tables(batch, on: bool) -> dict:
        """The batch with the GT angle tables the orientation-aware PQ
        reads walked from its id dicts (`gt_slot_angles`, as the JAX
        package's `validation_step` walks them) where `on`, without them
        otherwise."""
        batch = dict(batch)
        batch.pop('panoptic_gt_angle_table', None)
        batch.pop('panoptic_gt_angle_table_valid', None)
        if on:
            table = batch['panoptic_segment_table_fullres']
            angle, valid = gt_slot_angles(
                table.cpu().numpy(),
                batch['panoptic_ids_to_instance_dict_fullres'],
                batch['orientations_present'])
            batch['panoptic_gt_angle_table'] = torch.from_numpy(angle).to(
                table.device)
            batch['panoptic_gt_angle_table_valid'] = torch.from_numpy(
                valid).to(table.device)
        return batch

    def collect_predictions_for_loss(self, batch, predictions_post,
                                     key: str, side_outputs_key: str = None):
        """(predictions, loss keys, target dicts): the main output with
        `batch` ('main'), then each side output of `side_outputs_key`
        whose `_down_<k>` targets the batch holds, with them
        ('down_<k>')."""
        main = predictions_post[key]
        side = () if side_outputs_key is None else \
            predictions_post.get(side_outputs_key, ())
        preds, keys, targets = [main], ['main'], [batch]
        for s in side:
            if s is None:
                continue
            k = _spatial_width(main) // _spatial_width(s)
            sub = get_downscale(batch, k)
            if sub is not None:
                preds.append(s)
                keys.append(f'down_{k}')
                targets.append(sub)
        return preds, keys, targets

    def training_step(self, batch, batch_idx, predictions_post):
        """(losses, logs) of one training batch: the losses of
        `compute_losses`, no logs."""
        return self.compute_losses(batch, predictions_post), {}

    @staticmethod
    def accumulate_losses(losses, n_elements):
        """sum(losses) / sum(n_elements); a zero count returns the (then
        also zero) loss sum unscaled."""
        total_loss = sum(losses)
        total_n = sum(n_elements)
        return torch.where(total_n > 0,
                           total_loss / torch.clamp(total_n, min=1),
                           total_loss)

    @staticmethod
    def mark_as_total(key: str) -> str:
        return get_total_loss_key(key)

    @staticmethod
    def get_fullres(batch, key: str):
        return get_fullres(batch, key)

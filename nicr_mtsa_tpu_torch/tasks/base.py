"""Task-helper base (counterpart of nicr_mtsa_tpu/tasks/base.py).

A task helper wires one task's losses and metric states around the
shared batch dict, for the training step and the fused eval step:

- `compute_losses(batch, predictions_post) -> {name: loss}` (under
  autograd in training; `training_step` wraps it as the JAX helpers'
  `(losses, logs)`),
- `empty_metric_states(device)`, `update_metric_states(state, batch,
  predictions_post) -> state` (device tensors, no host sync),
- `load_metric_states(state)` then `validation_epoch_end() ->
  (artifacts, examples, logs)` on the host.

`prediction_keys` names the postprocessed keys the helper reads; the
step computes no full-resolution output beyond those and the caller's.

Multiscale supervision (the JAX package's pairing): a dense decoder's
side outputs carry no scale, so each one's downscale k is the main
output's width over its own, and its targets are the batch's
`_down_<k>` sub-dict, under the loss key `down_<k>`; a side output
without that sub-dict gets no loss (the bench's batches have none)."""
import torch

from ..data.fullres import get_fullres

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


class TaskHelperBase:
    prediction_keys = ()

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

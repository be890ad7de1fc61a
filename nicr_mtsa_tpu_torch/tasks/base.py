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
Only the main scale is supervised: neither the eval forward pass nor the
MLP decoders' training pass has side outputs, and multiscale targets
are not ported yet."""
import torch

from ..data.fullres import get_fullres

TOTAL_LOSS_SUFFIX = '_total_loss'


def get_total_loss_key(key: str) -> str:
    return f'{key}{TOTAL_LOSS_SUFFIX}'


class TaskHelperBase:
    prediction_keys = ()

    def collect_predictions_for_loss(self, predictions_post, key: str,
                                     side_outputs_key: str = None):
        """([main], ['main']); side outputs must be absent."""
        side = () if side_outputs_key is None else \
            predictions_post.get(side_outputs_key, ())
        if any(s is not None for s in side):
            raise NotImplementedError(
                'side outputs (multiscale supervision) are not ported yet')
        return [predictions_post[key]], ['main']

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

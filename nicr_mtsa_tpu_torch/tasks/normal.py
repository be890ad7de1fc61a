"""Surface-normal task helper (counterpart of
nicr_mtsa_tpu/tasks/normal.py): an L1 or MSE loss over the pixels whose
ground-truth normal is not all zero, the predictions masked to them,
at the main scale and, unless `disable_multiscale_supervision`, at each
side output's with its `_down_<k>` targets; the per-pixel RMSE at full
resolution (`normal_output_fullres` against `normal_fullres`), by the
fused step or by eager `validation_step`s, logged as `normal_rmse`;
with `store_examples` the first image of batch 0 as an example
image."""
import torch

from ..data.fullres import get_fullres_key
from ..losses import L1Loss, MSELoss
from ..metrics import RootMeanSquaredError
from ..visualization import visualize_normal_pil
from .base import (TaskHelperBase, append_detached_losses_to_logs,
                   append_profile_to_logs, epoch_end, to_numpy as np_of)

KNOWN_NORMAL_LOSS_FUNCTIONS = ('l1', 'mse')
_OUTPUT_FULLRES = get_fullres_key('normal_output')


def valid_gt_normals(gt: torch.Tensor) -> torch.Tensor:
    """(B, H, W) bool: the GT normal (B, 3, H, W) is not all zero."""
    return (gt != 0).any(dim=1)


class NormalTaskHelper(TaskHelperBase):
    prediction_keys = ('normal_output', 'normal_side_outputs',
                       _OUTPUT_FULLRES)

    def __init__(self, loss_name: str = 'l1',
                 disable_multiscale_supervision: bool = False,
                 store_examples: bool = False):
        if loss_name not in KNOWN_NORMAL_LOSS_FUNCTIONS:
            raise ValueError(f"Unknown normal loss: '{loss_name}'")
        self._loss_class = MSELoss if loss_name == 'mse' else L1Loss
        self._disable_multiscale_supervision = disable_multiscale_supervision
        self._examples = {}
        self._store_examples = store_examples
        self.initialize()

    def initialize(self) -> None:
        self._loss = self._loss_class(reduction='sum')
        self._metric_rmse = RootMeanSquaredError()

    def compute_losses(self, batch, predictions_post) -> dict:
        preds, keys, targets = self.collect_predictions_for_loss(
            batch, predictions_post, 'normal_output',
            None if self._disable_multiscale_supervision
            else 'normal_side_outputs')
        gts = [t['normal'] for t in targets]
        masks = [valid_gt_normals(gt) for gt in gts]
        n_valid = [m.sum(dtype=torch.int32) for m in masks]
        outs = self._loss([p * m[:, None] for p, m in zip(preds, masks)],
                          gts)
        d = {f'normal_loss_{k}': loss / n.clamp(min=1)
             for k, (loss, _), n in zip(keys, outs, n_valid)}
        d[self.mark_as_total('normal')] = self.accumulate_losses(
            [loss for loss, _ in outs], n_valid)
        return d

    def empty_metric_states(self, device=None):
        return self._metric_rmse.empty_state(device)

    def update_metric_states(self, state, batch, predictions_post):
        target = self.get_fullres(batch, 'normal')
        if state is None:
            state = self.empty_metric_states(target.device)
        return self._metric_rmse.update_state(
            state, predictions_post[_OUTPUT_FULLRES], target,
            mask=valid_gt_normals(target))

    def load_metric_states(self, state):
        self._metric_rmse.state = state

    @append_profile_to_logs('normal_step_time')
    @append_detached_losses_to_logs
    def training_step(self, batch, batch_idx, predictions_post):
        return self.compute_losses(batch, predictions_post), {}

    @append_profile_to_logs('normal_step_time')
    @append_detached_losses_to_logs
    def validation_step(self, batch, batch_idx, predictions_post):
        self.update_eagerly(batch, predictions_post)
        if self._store_examples and batch_idx == 0:
            self._examples['normal_example_batch_0_0'] = \
                visualize_normal_pil(np_of(
                    predictions_post['normal_output'][0].permute(1, 2, 0)))
        return self.compute_losses(batch, predictions_post), {}

    @epoch_end('normal_epoch_end_time')
    def validation_epoch_end(self):
        logs = {'normal_rmse': self._metric_rmse.compute()}
        self._metric_rmse.reset()
        return {}, self._examples, logs

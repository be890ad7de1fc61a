"""Semantic task helper (counterpart of nicr_mtsa_tpu/tasks/semantic.py):
class-weighted cross-entropy at the main scale and at each side
output's with its `_down_<k>` targets; a full-resolution confusion matrix
(void-masked, labels shifted by -1) accumulated on device -> mIoU, by
the fused step or by eager `validation_step`s."""
import numpy as np
import torch

from ..data.fullres import get_fullres_key
from ..losses import CrossEntropyLossSemantic
from ..metrics import MeanIntersectionOverUnion, confusion_matrix
from ..metrics.base import to_numpy
from .base import (TaskHelperBase, append_detached_losses_to_logs,
                   append_profile_to_logs, epoch_end, refuse_examples)

_IDX_FULLRES = get_fullres_key('semantic_segmentation_idx')


class SemanticTaskHelper(TaskHelperBase):
    prediction_keys = ('semantic_output', 'semantic_side_outputs',
                       _IDX_FULLRES)

    def __init__(self, n_classes: int, class_weights=None,
                 label_smoothing: float = 0.0,
                 store_examples: bool = False):
        refuse_examples(store_examples)
        self._n_classes = n_classes
        self._class_weights = class_weights
        self._label_smoothing = label_smoothing
        self.initialize()

    def initialize(self) -> None:
        self._loss = CrossEntropyLossSemantic(
            weights=self._class_weights,
            label_smoothing=self._label_smoothing)
        self._metric_iou = MeanIntersectionOverUnion(n_classes=self._n_classes)

    def compute_losses(self, batch, predictions_post) -> dict:
        preds, keys, targets = self.collect_predictions_for_loss(
            batch, predictions_post, 'semantic_output',
            'semantic_side_outputs')
        outs = self._loss(preds, [t['semantic'] for t in targets])
        d = {f'semantic_loss_{k}': loss / n.clamp(min=1)
             for k, (loss, n) in zip(keys, outs)}
        d[self.mark_as_total('semantic')] = self.accumulate_losses(
            [loss for loss, _ in outs], [n for _, n in outs])
        return d

    def empty_metric_states(self, device=None):
        return self._metric_iou.empty_state(device)

    def update_metric_states(self, state, batch, predictions_post):
        target = self.get_fullres(batch, 'semantic')
        if state is None:
            state = self.empty_metric_states(target.device)
        preds = predictions_post[_IDX_FULLRES]
        # void pixels are left out (the JAX package counts them into
        # the (0, 0) cell and subtracts them again)
        t = torch.where(target != 0, target.long() - 1, -1)
        return state + confusion_matrix(preds, t, self._n_classes)

    def load_metric_states(self, state):
        self._metric_iou.state = state

    @append_profile_to_logs('semantic_step_time')
    @append_detached_losses_to_logs
    def validation_step(self, batch, batch_idx, predictions_post):
        self.update_eagerly(batch, predictions_post)
        return self.compute_losses(batch, predictions_post), {}

    @epoch_end('semantic_epoch_end_time')
    def validation_epoch_end(self):
        miou, ious = self._metric_iou.compute(return_ious=True)
        artifacts = {'semantic_cm': np.asarray(to_numpy(
            self._metric_iou.state)), 'semantic_ious_per_class': ious}
        self._metric_iou.reset()
        return artifacts, {}, {'semantic_miou': miou}

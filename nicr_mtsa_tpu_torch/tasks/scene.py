"""Scene classification task helper (counterpart of
nicr_mtsa_tpu/tasks/scene.py): mean cross-entropy with void (label 0)
left out; a confusion matrix on device -> accuracy and balanced
accuracy, by the fused step or by eager `validation_step`s."""
import numpy as np
import torch

from ..metrics import confusion_matrix
from ..metrics.base import to_numpy
from ..utils.dtypes import upcast
from .base import (TaskHelperBase, append_detached_losses_to_logs,
                   append_profile_to_logs, epoch_end)


class SceneTaskHelper(TaskHelperBase):
    prediction_keys = ('scene_output', 'scene_class_idx')

    def __init__(self, n_classes: int, class_weights=None,
                 label_smoothing: float = 0.0):
        self._n_classes = n_classes
        self._class_weights = (None if class_weights is None else
                               torch.as_tensor(class_weights,
                                               dtype=torch.float32))
        self._label_smoothing = float(label_smoothing)
        self.initialize()

    def initialize(self) -> None:
        self._cm_state = None

    def compute_losses(self, batch, predictions_post) -> dict:
        logits = upcast(predictions_post['scene_output'])     # (B, C)
        target = batch['scene'].long() - 1                     # -1 = void
        valid = target >= 0
        tclip = target.clamp(0, self._n_classes - 1)
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, 1, tclip[:, None])[:, 0]
        if self._label_smoothing > 0:
            ls = self._label_smoothing
            nll = (1 - ls) * nll + ls * -logp.mean(dim=-1)
        if self._class_weights is not None:
            w = self._class_weights.to(logits.device)[tclip]
            nll = nll * w
            denom = torch.where(valid, w, 0.0).sum()
        else:
            denom = valid.sum(dtype=torch.float32)
        total = torch.where(valid, nll, 0.0).sum() / denom.clamp(min=1e-12)
        return {self.mark_as_total('scene'): total}

    def empty_metric_states(self, device=None):
        return torch.zeros((self._n_classes, self._n_classes),
                           dtype=torch.int32, device=device)

    def update_metric_states(self, state, batch, predictions_post):
        target = batch['scene'].long()
        if state is None:
            state = self.empty_metric_states(target.device)
        # void samples (label 0) are left out
        t = torch.where(target != 0, target - 1, -1)
        return state + confusion_matrix(predictions_post['scene_class_idx'],
                                        t, self._n_classes)

    def load_metric_states(self, state):
        self._cm_state = state

    @append_profile_to_logs('scene_step_time')
    @append_detached_losses_to_logs
    def training_step(self, batch, batch_idx, predictions_post):
        return self.compute_losses(batch, predictions_post), {}

    @append_profile_to_logs('scene_step_time')
    @append_detached_losses_to_logs
    def validation_step(self, batch, batch_idx, predictions_post):
        self.update_eagerly(batch, predictions_post)
        return self.compute_losses(batch, predictions_post), {}

    @epoch_end('scene_epoch_end_time')
    def validation_epoch_end(self):
        cm = np.asarray(to_numpy(self._cm_state)).astype(np.float64)
        tp = np.diag(cm)
        gt = cm.sum(axis=1)
        mask = gt != 0
        tp, gt = tp[mask], gt[mask]
        acc = float(tp.sum() / gt.sum()) if gt.sum() else 0.0
        bacc = float(np.mean(tp / gt)) if len(gt) else 0.0
        artifacts = {'scene_cm': np.asarray(to_numpy(self._cm_state))}
        self._cm_state = None
        return artifacts, {}, {'scene_acc': np.float32(acc),
                               'scene_bacc': np.float32(bacc)}

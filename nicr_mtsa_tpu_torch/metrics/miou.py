"""Mean intersection-over-union from a device confusion matrix
(counterpart of nicr_mtsa_tpu/metrics/miou.py). The matrix is an
integer `bincount` of target * C + pred (exact; the JAX package's
one-hot product is its TPU formulation)."""
import numpy as np
import torch

from .base import MetricBase, to_numpy


def confusion_matrix(preds, target, n_classes: int):
    """(...,) int preds/target -> (C, C) int32 counts (rows = target,
    cols = prediction); pairs with a value outside [0, C) are not
    counted."""
    t = target.reshape(-1).long()
    p = preds.reshape(-1).long()
    ok = (t >= 0) & (t < n_classes) & (p >= 0) & (p < n_classes)
    cell = torch.where(ok, t * n_classes + p, n_classes * n_classes)
    counts = torch.bincount(cell, minlength=n_classes * n_classes + 1)
    return counts[:-1].view(n_classes, n_classes).to(torch.int32)


class MeanIntersectionOverUnion(MetricBase):
    def __init__(self, n_classes: int, ignore_first_class: bool = False):
        self._n_classes = n_classes
        self._ignore_first_class = ignore_first_class

    def empty_state(self, device=None):
        return torch.zeros((self._n_classes, self._n_classes),
                           dtype=torch.int32, device=device)

    def update_state(self, state, preds, target):
        return state + confusion_matrix(preds, target, self._n_classes)

    def compute_from_state(self, state, return_ious: bool = False):
        confmat = np.asarray(to_numpy(state)).astype(np.float64)
        tp = np.diag(confmat)
        sum_pred = confmat.sum(axis=0)
        sum_gt = confmat.sum(axis=1)
        if self._ignore_first_class:
            # exclude void row/col; void GT pixels predicted as a class
            # must not count against that class's prediction sum
            tp = tp[1:]
            sum_pred = sum_pred[1:] - confmat[0, 1:]
            sum_gt = sum_gt[1:]
        mask = sum_gt != 0
        tp_m = tp[mask]
        iou = tp_m / (sum_pred[mask] + sum_gt[mask] - tp_m)
        miou = np.float32(iou.mean() if len(iou) else 0.0)
        if not return_ious:
            return miou
        ious = np.full((self._n_classes,), np.nan, dtype=np.float32)
        idx = np.nonzero(mask)[0]
        if self._ignore_first_class:
            idx = idx + 1
        ious[idx] = iou
        return miou, ious

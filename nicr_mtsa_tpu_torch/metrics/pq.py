"""Panoptic Quality on device with fixed shapes (counterpart of
nicr_mtsa_tpu/metrics/pq.py).

Each image's panoptic ids are compressed to a sorted segment table
(ops/segments.py); the intersection areas of all (gt, pred) segment
pairs are one (S_gt+1, S_pred+1) histogram per image (the CUDA
intersection kernel on the card); matching (IoU > 0.5, same category,
void-overlap union correction) and the per-class reductions are masked
dense ops. States: per-class IoU sums and TP/FN/FP counts, f32 (the
counts are exact integers)."""
from typing import Dict, List, NamedTuple, Union

import numpy as np
import torch

from ..ops.segments import (SEGMENT_TABLE_PAD, ids_to_slots,
                            intersection_matrix, unique_table)
from .base import MetricBase, to_numpy
from .mae import abs_angle_error_rad

_EPSILON = 1e-10
_CLASS_KEYS = ('iou_per_class', 'tp_per_class', 'fn_per_class',
               'fp_per_class')


class PQCompareResult(NamedTuple):
    iou_per_class: torch.Tensor   # (C,) float32
    tp_per_class: torch.Tensor    # (C,) float32
    fn_per_class: torch.Tensor    # (C,) float32
    fp_per_class: torch.Tensor    # (C,) float32
    match: torch.Tensor           # (B, S_gt, S_pred) bool matched pairs
    gt_table: torch.Tensor        # (B, S_gt)
    pred_table: torch.Tensor      # (B, S_pred)


def _per_class(values, cats, C: int):
    """(B, S) f32 values summed by their (B, S) category -> (C,)."""
    out = torch.zeros(C, dtype=torch.float32, device=values.device)
    return out.index_add_(0, cats.reshape(-1), values.reshape(-1).float())


def pq_compare(pred, target, gt_table, pred_table, num_categories: int,
               ignored_label: int, max_instances_per_category: int,
               pred_slots=None, gt_slots=None) -> PQCompareResult:
    """`pred` (B, H, W) panoptic ids may be None when `pred_slots` is
    given (a merge that knows each pixel's slot); `gt_slots` lets a
    step with several PQ pipelines against one GT map slot it once."""
    C = num_categories
    M = max_instances_per_category
    S_gt = gt_table.shape[-1]
    S_pred = pred_table.shape[-1]
    void_segment_id = ignored_label * M

    if gt_slots is None:
        gt_slots = ids_to_slots(target.to(torch.int32), gt_table)
    if pred_slots is None:
        pred_slots = ids_to_slots(pred.to(torch.int32), pred_table)
    N_full = intersection_matrix(gt_slots, pred_slots, S_gt, S_pred)

    # segment areas include the overflow row/col (total pixel counts)
    gt_area = N_full.sum(dim=2)[:, :S_gt]               # (B, S_gt)
    pred_area = N_full.sum(dim=1)[:, :S_pred]           # (B, S_pred)
    N = N_full[:, :S_gt, :S_pred]

    gt_valid = gt_table != SEGMENT_TABLE_PAD
    pred_valid = pred_table != SEGMENT_TABLE_PAD
    gt_cat = torch.div(gt_table, M, rounding_mode='floor').clamp(0, C - 1)
    pred_cat = torch.div(pred_table, M,
                         rounding_mode='floor').clamp(0, C - 1)

    # union correction: overlap of each pred segment with the gt void
    # segment (id = ignored_label * M); and its overlap with all gt
    # segments of the ignored category
    gt_is_void_seg = gt_valid & (gt_table == void_segment_id)
    r = (N * gt_is_void_seg[:, :, None]).sum(dim=1)     # (B, S_pred)
    gt_is_ignored = gt_valid & (gt_cat == ignored_label)
    pio = (N * gt_is_ignored[:, :, None]).sum(dim=1)    # (B, S_pred)

    same_cat = gt_cat[:, :, None] == pred_cat[:, None, :]
    pair_valid = gt_valid[:, :, None] & pred_valid[:, None, :]
    union = gt_area[:, :, None] + pred_area[:, None, :] - N - r[:, None, :]
    iou = torch.where(union > 0, N / union.clamp(min=1.0), 0.0)
    # the reference skips the pair (gt id 0, pred id void_segment_id)
    exclude_pair = ((gt_table == 0)[:, :, None]
                    & (pred_table == void_segment_id)[:, None, :])
    match = same_cat & pair_valid & (N > 0) & (iou > 0.5) & ~exclude_pair

    # each gt/pred slot matches at most one partner (IoU > 0.5)
    gt_matched = match.any(dim=2)
    pred_matched = match.any(dim=1)
    iou_per_gt = torch.where(match, iou, 0.0).sum(dim=2)
    fn_mask = (gt_valid & ~gt_matched & (gt_cat != ignored_label)
               & (gt_area > 0))
    # an unmatched prediction mostly covered by ignored gt is forgiven
    fp_mask = (pred_valid & ~pred_matched & ~(pio > 0.5 * pred_area)
               & (pred_area > 0))
    gt_cat_l = gt_cat.long()
    return PQCompareResult(
        iou_per_class=_per_class(iou_per_gt, gt_cat_l, C),
        tp_per_class=_per_class(gt_matched, gt_cat_l, C),
        fn_per_class=_per_class(fn_mask, gt_cat_l, C),
        fp_per_class=_per_class(fp_mask, pred_cat.long(), C),
        match=match, gt_table=gt_table, pred_table=pred_table)


def realdiv_maybe_zero(x, y):
    out = np.zeros_like(x)
    np.divide(x, y, out=out, where=np.abs(y) >= _EPSILON)
    return out


class PanopticQuality(MetricBase):
    def __init__(self, num_categories: int, ignored_label: int,
                 max_instances_per_category: int,
                 is_thing: Union[np.ndarray, List[bool], None] = None,
                 gt_table_size: int = 256, pred_table_size: int = 128):
        self.num_categories = num_categories
        self.ignored_label = ignored_label
        self.max_instances_per_category = max_instances_per_category
        self.is_thing = np.asarray(is_thing, dtype=bool)
        self.is_stuff = np.logical_not(self.is_thing)
        if len(self.is_thing) != num_categories:
            raise ValueError('is_thing needs one entry per category')
        self._gt_table_size = gt_table_size
        self._pred_table_size = pred_table_size

    @property
    def pred_table_size(self) -> int:
        return self._pred_table_size

    def empty_state(self, device=None):
        return {k: torch.zeros((self.num_categories,), dtype=torch.float32,
                               device=device) for k in _CLASS_KEYS}

    def compare(self, preds, targets, gt_table=None, pred_table=None,
                pred_slots=None, gt_slots=None) -> PQCompareResult:
        B = targets.shape[0]
        if gt_table is None:
            gt_table = unique_table(targets.reshape(B, -1),
                                    self._gt_table_size)
        if pred_table is None:
            pred_table = unique_table(preds.reshape(B, -1),
                                      self._pred_table_size)
        return pq_compare(
            preds, targets, gt_table, pred_table,
            num_categories=self.num_categories,
            ignored_label=self.ignored_label,
            max_instances_per_category=self.max_instances_per_category,
            pred_slots=pred_slots, gt_slots=gt_slots)

    def update_state(self, state, preds, targets, gt_table=None,
                     pred_table=None, pred_slots=None, gt_slots=None):
        res = self.compare(preds, targets, gt_table, pred_table,
                           pred_slots, gt_slots)
        return {k: state[k] + getattr(res, k) for k in _CLASS_KEYS}

    def result_per_category(self, state) -> Dict:
        s = {k: np.asarray(to_numpy(v)).astype(np.float64)
             for k, v in state.items()}
        sq = realdiv_maybe_zero(s['iou_per_class'], s['tp_per_class'])
        rq = realdiv_maybe_zero(
            s['tp_per_class'],
            s['tp_per_class'] + 0.5 * s['fn_per_class']
            + 0.5 * s['fp_per_class'])
        return {'sq_per_class': sq, 'rq_per_class': rq,
                'pq_per_class': sq * rq}

    def _valid_categories(self, s, with_gt_only: bool):
        total = s['tp_per_class'] + s['fn_per_class']
        if not with_gt_only:
            total = total + s['fp_per_class']
        valid = total != 0
        if 0 <= self.ignored_label < self.num_categories:
            valid[self.ignored_label] = False
        return valid

    def compute_from_state(self, state, suffix: str = '') -> Dict:
        s = {k: np.asarray(to_numpy(state[k])).astype(np.float64)
             for k in _CLASS_KEYS}
        results = self.result_per_category(
            {k: state[k] for k in _CLASS_KEYS})
        valid = self._valid_categories(s, with_gt_only=False)
        valid_with_gt = self._valid_categories(s, with_gt_only=True)
        category_sets = {
            f'all{suffix}': valid,
            f'things{suffix}': valid & self.is_thing,
            f'stuff{suffix}': valid & self.is_stuff,
            f'all_with_gt{suffix}': valid_with_gt,
            f'things_with_gt{suffix}': valid_with_gt & self.is_thing,
            f'stuff_with_gt{suffix}': valid_with_gt & self.is_stuff,
        }
        for name, in_set in category_sets.items():
            if in_set.any():
                results.update({
                    f'{name}_pq': results['pq_per_class'][in_set].mean(),
                    f'{name}_sq': results['sq_per_class'][in_set].mean(),
                    f'{name}_rq': results['rq_per_class'][in_set].mean(),
                    f'{name}_num_categories': int(in_set.sum()),
                })
            else:
                results.update({
                    f'{name}_pq': 0.0, f'{name}_sq': 0.0,
                    f'{name}_rq': 0.0, f'{name}_num_categories': 0,
                })
        return results


class PanopticQualityWithOrientationMAE(PanopticQuality):
    """PQ plus the mean absolute angular error over matched instances,
    from per-segment-slot angle tables (angle + validity) on both
    sides."""

    def empty_state(self, device=None):
        state = super().empty_state(device)
        state['sum_angular_error'] = torch.zeros((), dtype=torch.float32,
                                                 device=device)
        state['n_elements'] = torch.zeros((), dtype=torch.int32,
                                          device=device)
        return state

    def update_state(self, state, preds, targets, gt_table=None,
                     pred_table=None, gt_angle=None, gt_angle_valid=None,
                     pred_angle=None, pred_angle_valid=None,
                     pred_slots=None, gt_slots=None):
        res = self.compare(preds, targets, gt_table, pred_table,
                           pred_slots, gt_slots)
        new = {k: state[k] + getattr(res, k) for k in _CLASS_KEYS}
        if gt_angle is not None and pred_angle is not None:
            pair_ok = (res.match & gt_angle_valid[:, :, None]
                       & pred_angle_valid[:, None, :]
                       # gt panoptic id 0 is not a real instance
                       & (res.gt_table != 0)[:, :, None])
            err = abs_angle_error_rad(pred_angle[:, None, :].float(),
                                      gt_angle[:, :, None].float())
            new['sum_angular_error'] = state['sum_angular_error'] + \
                torch.where(pair_ok, err, 0.0).sum()
            new['n_elements'] = state['n_elements'] + \
                pair_ok.sum(dtype=torch.int32)
        else:
            new['sum_angular_error'] = state['sum_angular_error']
            new['n_elements'] = state['n_elements']
        return new

    def compute_from_state(self, state, suffix: str = '') -> Dict:
        results = super().compute_from_state(state, suffix=suffix)
        n = int(to_numpy(state['n_elements']))
        rad = (float(to_numpy(state['sum_angular_error'])) / n
               if n else float('nan'))
        results[f'mae{suffix}_rad'] = rad
        results[f'mae{suffix}_deg'] = np.rad2deg(rad)
        return results

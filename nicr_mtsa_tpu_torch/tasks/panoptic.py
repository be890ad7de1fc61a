"""Panoptic task helper (counterpart of nicr_mtsa_tpu/tasks/panoptic.py):
PQ/SQ/RQ (+ orientation MAE) of the merged panoptic prediction against
the full-resolution GT, scored through the merge's own slot map and
segment table, plus the mIoU of the panoptic-derived semantic, by the
fused step or by eager `validation_step`s (the GT angle tables then
walked from the batch's id dicts where it has `orientations_present`).
No loss."""
import numpy as np
import torch

from ..data.fullres import get_fullres_key
from ..metrics import (MeanIntersectionOverUnion,
                       PanopticQualityWithOrientationMAE)
from ..metrics.base import to_numpy
from ._orientation_tables import pred_slot_angles
from .base import (TaskHelperBase, append_profile_to_logs, epoch_end,
                   refuse_examples)

_PAN_FULLRES = get_fullres_key('panoptic_segmentation_deeplab')
_SLOTS_FULLRES = get_fullres_key('panoptic_segmentation_deeplab_slots')
_ORI_KEY = 'orientations_panoptic_segmentation_deeplab_instance'


class PanopticTaskHelper(TaskHelperBase):
    prediction_keys = (_PAN_FULLRES, _SLOTS_FULLRES,
                       'panoptic_segmentation_deeplab_slot_table',
                       'panoptic_segmentation_deeplab_ids', _ORI_KEY)

    def __init__(self, semantic_n_classes: int, semantic_classes_is_thing,
                 store_examples: bool = False):
        refuse_examples(store_examples)
        self._semantic_n_classes = semantic_n_classes
        self._is_thing = np.asarray(semantic_classes_is_thing, dtype=bool)
        self._max_instances_per_category = 1 << 16
        self.initialize()

    def initialize(self) -> None:
        self._mae_pq_deeplab = PanopticQualityWithOrientationMAE(
            num_categories=self._semantic_n_classes, ignored_label=0,
            max_instances_per_category=self._max_instances_per_category,
            is_thing=self._is_thing)
        self._metric_iou = MeanIntersectionOverUnion(
            n_classes=self._semantic_n_classes, ignore_first_class=True)

    def empty_metric_states(self, device=None):
        return {'pq': self._mae_pq_deeplab.empty_state(device),
                'miou': self._metric_iou.empty_state(device)}

    def update_metric_states(self, state, batch, predictions_post):
        panoptic_pred = predictions_post[_PAN_FULLRES].to(torch.int32)
        if state is None:
            state = self.empty_metric_states(panoptic_pred.device)
        pred_table = predictions_post[
            'panoptic_segmentation_deeplab_slot_table']
        kwargs = {}
        if 'panoptic_gt_angle_table' in batch and _ORI_KEY in predictions_post:
            pred_angle, pred_angle_valid = pred_slot_angles(
                pred_table, predictions_post[
                    'panoptic_segmentation_deeplab_ids'],
                predictions_post[_ORI_KEY])
            kwargs = dict(gt_angle=batch['panoptic_gt_angle_table'],
                          gt_angle_valid=batch[
                              'panoptic_gt_angle_table_valid'],
                          pred_angle=pred_angle,
                          pred_angle_valid=pred_angle_valid)
        pq_state = self._mae_pq_deeplab.update_state(
            state['pq'], panoptic_pred,
            self.get_fullres(batch, 'panoptic').to(torch.int32),
            gt_table=batch['panoptic_segment_table_fullres'],
            pred_table=pred_table,
            pred_slots=predictions_post[_SLOTS_FULLRES].to(torch.int32),
            gt_slots=batch.get('panoptic_gt_slots_fullres'), **kwargs)
        deeplab_semantic = torch.div(panoptic_pred,
                                     self._max_instances_per_category,
                                     rounding_mode='floor')
        miou_state = self._metric_iou.update_state(
            state['miou'], deeplab_semantic,
            self.get_fullres(batch, 'semantic').to(torch.int32))
        return {'pq': pq_state, 'miou': miou_state}

    def load_metric_states(self, state):
        self._mae_pq_deeplab.state = state['pq']
        self._metric_iou.state = state['miou']

    @append_profile_to_logs('panoptic_step_time')
    def validation_step(self, batch, batch_idx, predictions_post):
        self.update_eagerly(self.with_gt_angle_tables(
            batch, 'orientations_present' in batch), predictions_post)
        return {}, {}

    @epoch_end('panoptic_epoch_end_time')
    def validation_epoch_end(self):
        artifacts, logs = {}, {}
        for key, value in self._mae_pq_deeplab.compute(
                suffix='_deeplab').items():
            if np.ndim(value) == 0:
                logs[f'panoptic_{key}'] = value
            else:
                artifacts[f'panoptic_{key}'] = value
        self._mae_pq_deeplab.reset()
        artifacts['panoptic_deeplab_semantic_cm'] = np.asarray(
            to_numpy(self._metric_iou.state))
        miou, ious = self._metric_iou.compute(return_ious=True)
        logs['panoptic_deeplab_semantic_miou'] = miou
        artifacts['panoptic_deeplab_semantic_ious_per_class'] = ious
        self._metric_iou.reset()
        return artifacts, {}, logs

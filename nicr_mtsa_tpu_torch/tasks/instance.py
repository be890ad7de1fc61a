"""Instance task helper (counterpart of nicr_mtsa_tpu/tasks/instance.py):
the training, fused-eval and eager validation paths.

Losses, at the main scale and at each side output's with its
`_down_<k>` targets: masked centre MSE (instance_center_mask), masked
offset L1 (instance_foreground), von Mises orientation loss on the
orientation foreground; each total over all scales. Metric: the
predicted instances (segmented under the GT foreground) are merged
with the GT semantic and scored with the orientation-aware PQ against
the GT panoptic map, the merge emitting the pred slot map directly
(`deeplab_merge_pq`), by the fused step or by eager `validation_step`s
(the GT angle tables then walked from the batch's id dicts). The
eager steps also score the mean orientation of each GT instance
(postprocessing branch o-1) against its GT angle: the plain MAE against
the GT instances (`orientation_mae_gt_rad`/`_deg`), which the fused
step does not compute (as in the JAX package). With `store_examples`
the first image of batch 0 gives example images: the centre heatmap,
the offsets, the predicted centres, the instances and the
orientations."""
import numpy as np
import torch

from ..data.fullres import get_fullres_key
from ..losses import L1Loss, MSELoss, von_mises_biternion
from ..metrics import (MeanAbsoluteAngularError,
                       PanopticQualityWithOrientationMAE)
from ..ops.merge import deeplab_merge_pq
from ..ops.segments import SEGMENT_TABLE_PAD
from ..postprocessing.instance import O1_KEY
from ._orientation_tables import pred_slot_angles
from ..visualization import (visualize_instance_center_pil,
                             visualize_instance_offset_pil,
                             visualize_instance_pil,
                             visualize_orientation_pil)
from .base import (TaskHelperBase, append_detached_losses_to_logs,
                   append_profile_to_logs, epoch_end, to_numpy as np_of)

_SEG_FULLRES = get_fullres_key('instance_segmentation_gt_foreground')
_ORI_KEY = 'orientations_instance_segmentation_gt_orientation_foreground'


class InstanceTaskHelper(TaskHelperBase):
    prediction_keys = ('instance_output', 'instance_side_outputs',
                       _SEG_FULLRES, _ORI_KEY)
    validation_keys = (O1_KEY,)

    def __init__(self, semantic_n_classes: int, semantic_classes_is_thing,
                 loss_name_instance_center: str = 'mse',
                 top_k_instances: int = 64, store_examples: bool = False):
        if loss_name_instance_center not in ('mse', 'l1'):
            raise ValueError(f"unknown centre loss "
                             f"'{loss_name_instance_center}'")
        self._examples = {}
        self._store_examples = store_examples
        self._loss_name_instance_center = loss_name_instance_center
        self._semantic_n_classes = semantic_n_classes     # with void
        self._is_thing_np = np.asarray(semantic_classes_is_thing, dtype=bool)
        self._is_thing_cpu = torch.tensor(self._is_thing_np)
        self._is_thing = {}
        self._max_instances_per_category = 1 << 16
        self._top_k_instances = top_k_instances
        self.initialize()

    def initialize(self) -> None:
        self._loss_center = (MSELoss()
                             if self._loss_name_instance_center == 'mse'
                             else L1Loss())
        self._loss_offset = L1Loss()
        self._mae_pq_deeplab = PanopticQualityWithOrientationMAE(
            num_categories=self._semantic_n_classes, ignored_label=0,
            max_instances_per_category=self._max_instances_per_category,
            is_thing=self._is_thing_np)
        self._mae_gt = MeanAbsoluteAngularError()
        # an eager epoch whose outputs had an orientation head
        self._with_orientation = False

    def _thing_table(self, device):
        if device not in self._is_thing:
            self._is_thing[device] = self._is_thing_cpu.to(device)
        return self._is_thing[device]

    def compute_losses(self, batch, predictions_post) -> dict:
        preds, keys, targets = self.collect_predictions_for_loss(
            batch, predictions_post, 'instance_output',
            'instance_side_outputs')
        l_c, n_c, l_o, n_o, l_r, n_r = [], [], [], [], [], []
        for pred, t in zip(preds, targets):
            mask_c = t['instance_center_mask']
            (loss, _), = self._loss_center([pred[0][:, 0] * mask_c],
                                           [t['instance_center']])
            l_c.append(loss)
            n_c.append(mask_c.sum(dtype=torch.int32))
            mask_o = t['instance_foreground']
            (loss, _), = self._loss_offset([pred[1] * mask_o[:, None]],
                                           [t['instance_offset']])
            l_o.append(loss)
            n_o.append(mask_o.sum(dtype=torch.int32))
            if len(pred) == 3:
                mask = t['orientation_foreground']
                score = von_mises_biternion(pred[2], t['orientation'])
                l_r.append(torch.where(mask, score, 0.0).sum())
                n_r.append(mask.sum(dtype=torch.int32).clamp(min=1))
        d = {}
        for name, losses, counts in (('center', l_c, n_c),
                                     ('offset', l_o, n_o),
                                     ('orientation', l_r, n_r)):
            if not losses:
                continue
            for k, loss, n in zip(keys, losses, counts):
                d[f'instance_{name}_loss_{k}'] = loss / n.clamp(min=1)
            d[self.mark_as_total(f'instance_{name}')] = \
                self.accumulate_losses(losses, counts)
        return d

    def empty_metric_states(self, device=None):
        return {'pq': self._mae_pq_deeplab.empty_state(device)}

    def update_metric_states(self, state, batch, predictions_post):
        semantic = self.get_fullres(batch, 'semantic').to(torch.int32)
        if state is None:
            state = self.empty_metric_states(semantic.device)
        instance_gt = self.get_fullres(batch, 'instance')
        merge = deeplab_merge_pq(
            semantic, predictions_post[_SEG_FULLRES].to(torch.int32),
            instance_gt != 0, self._thing_table(semantic.device),
            max_instances_per_category=self._max_instances_per_category,
            top_k=self._top_k_instances,
            n_classes_with_void=self._semantic_n_classes,
            pred_table_size=self._mae_pq_deeplab.pred_table_size)
        kwargs = {}
        if 'panoptic_gt_angle_table' in batch and _ORI_KEY in predictions_post:
            pred_angle, pred_angle_valid = pred_slot_angles(
                merge.pred_table, merge.panoptic_id_table,
                predictions_post[_ORI_KEY])
            kwargs = dict(gt_angle=batch['panoptic_gt_angle_table'],
                          gt_angle_valid=batch[
                              'panoptic_gt_angle_table_valid'],
                          pred_angle=pred_angle,
                          pred_angle_valid=pred_angle_valid)
        return {'pq': self._mae_pq_deeplab.update_state(
            state['pq'], None,
            self.get_fullres(batch, 'panoptic').to(torch.int32),
            gt_table=batch['panoptic_segment_table_fullres'],
            pred_table=merge.pred_table, pred_slots=merge.slots,
            gt_slots=batch.get('panoptic_gt_slots_fullres'), **kwargs)}

    def load_metric_states(self, state):
        self._mae_pq_deeplab.state = state['pq']

    @append_profile_to_logs('instance_step_time')
    @append_detached_losses_to_logs
    def training_step(self, batch, batch_idx, predictions_post):
        return self.compute_losses(batch, predictions_post), {}

    @append_profile_to_logs('instance_step_time')
    @append_detached_losses_to_logs
    def validation_step(self, batch, batch_idx, predictions_post):
        losses = self.compute_losses(batch, predictions_post)
        with_orientation = len(predictions_post['instance_output']) == 3
        self._with_orientation = with_orientation
        self.update_eagerly(self.with_gt_angle_tables(batch, with_orientation),
                            predictions_post)
        if with_orientation:
            o1 = predictions_post[O1_KEY]
            angles, valid = self._gt_table_target_angles(
                o1['ids'].cpu().numpy(), batch['orientations_present'])
            dev = o1['angles'].device
            self._mae_gt.update(
                o1['angles'], torch.from_numpy(angles).to(dev),
                valid=torch.from_numpy(valid).to(dev) & o1['valid'])
        if self._store_examples and batch_idx == 0:
            self._store_example_images(predictions_post)
        return losses, {}

    def _store_example_images(self, predictions_post):
        center, offset, *orientation = predictions_post['instance_output']
        ex = self._examples
        ex['instance_center_heatmap_example_batch_0_0'] = \
            visualize_instance_center_pil(center_img=np_of(center[0, 0]),
                                          min_=0, max_=1)
        ex['instance_offset_example_batch_0_0'] = \
            visualize_instance_offset_pil(np_of(offset[0].permute(1, 2, 0)))
        meta = predictions_post['instance_segmentation_gt_meta']
        centers = [tuple(yx) for yx, v in
                   zip(np_of(meta['centers_yx'][0]), np_of(meta['valid'][0]))
                   if v]
        ex['instance_predicted_centers_example_batch_0_0'] = \
            visualize_instance_center_pil(centers=centers,
                                          height=center.shape[2],
                                          width=center.shape[3])
        ex['instance_instance_example_batch_0_0'] = visualize_instance_pil(
            np_of(predictions_post['instance_segmentation_gt_foreground'][0]))
        if orientation:
            ex['orientation_example_batch_0_0'] = visualize_orientation_pil(
                np_of(orientation[0][0].permute(1, 2, 0)))

    @staticmethod
    def _gt_table_target_angles(ids_table, orientations_present):
        """(B, S) GT angles and validity of a table of GT instance ids,
        from the per-sample orientation dicts (host)."""
        angles = np.zeros(ids_table.shape, np.float32)
        valid = np.zeros(ids_table.shape, bool)
        for b, row in enumerate(ids_table):
            ori = orientations_present[b]
            for s, iid in enumerate(row):
                iid = int(iid)
                if iid not in (0, SEGMENT_TABLE_PAD) and iid in ori:
                    angles[b, s] = float(ori[iid])
                    valid[b, s] = True
        return angles, valid

    @epoch_end('instance_epoch_end_time')
    def validation_epoch_end(self):
        artifacts, logs = {}, {}
        for key, value in self._mae_pq_deeplab.compute(
                suffix='_deeplab').items():
            if np.ndim(value) == 0:
                logs[f'instance_{key}'] = value
            else:
                artifacts[f'instance_{key}'] = value
        self._mae_pq_deeplab.reset()
        if self._with_orientation:
            logs['orientation_mae_gt_rad'], logs['orientation_mae_gt_deg'] = \
                self._mae_gt.compute()
            self._mae_gt.reset()
            self._with_orientation = False
        return artifacts, self._examples, logs

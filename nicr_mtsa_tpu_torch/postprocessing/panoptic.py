"""Panoptic postprocessing, inference branch (counterpart of
nicr_mtsa_tpu/postprocessing/panoptic.py): semantic + instance
postprocessing, the thing-foreground mask, the Panoptic-DeepLab merge,
per-instance orientations and, with a valid region in the batch, the
nearest full-resolution maps, all on device. The merge also emits its
PQ slot map and segment table (`deeplab_merge_pq`) when the caller
reads them (the eval step), else it is the plain `deeplab_merge` (the
serving path). With `compute_scores` it adds the dense scores
(`_add_scores`: each pixel's semantic softmax score of its panoptic
class, its instance's centre score, and their panoptic product) and
their full-resolution maps, and each instance's mean semantic score and
panoptic score in the instance meta. Training passes the semantic and
instance outputs on."""
from typing import Tuple

import torch

from ..data.fullres import get_fullres_key
from ..ops.grouping import instance_orientations
from ..ops.merge import deeplab_merge, deeplab_merge_pq
from .base import DensePostprocessingBase, wants
from .instance import InstancePostprocessing
from .semantic import SOFTMAX_KEY, SemanticPostprocessing

_FULLRES_SOURCES = ('panoptic_segmentation_deeplab',
                    'panoptic_segmentation_deeplab_instance_idx',
                    'panoptic_segmentation_deeplab_semantic_idx',
                    'panoptic_segmentation_deeplab_slots')
_SLOT_KEYS = ('panoptic_segmentation_deeplab_slots',
              'panoptic_segmentation_deeplab_slot_table',
              get_fullres_key('panoptic_segmentation_deeplab_slots'))
SCORE_KEYS = tuple(f'panoptic_segmentation_deeplab_{k}_score'
                   for k in ('semantic', 'instance', 'panoptic'))


class PanopticPostprocessing(DensePostprocessingBase):
    def __init__(self, semantic_postprocessing: SemanticPostprocessing,
                 instance_postprocessing: InstancePostprocessing,
                 semantic_classes_is_thing: Tuple[bool, ...],
                 semantic_class_has_orientation: Tuple[bool, ...],
                 compute_scores: bool = False):
        self._semantic_postprocessing = semantic_postprocessing
        self._instance_postprocessing = instance_postprocessing
        is_thing = [bool(v) for v in semantic_classes_is_thing]
        has_ori = [bool(v) for v in semantic_class_has_orientation]
        # class tables; the panoptic ones include void at index 0
        self._tables_cpu = {
            'thing': torch.tensor(is_thing),
            'thing_panoptic': torch.tensor([False] + is_thing),
            'orientation_panoptic': torch.tensor([False] + has_ori)}
        self._tables = {}
        self._n_classes_with_void = len(is_thing) + 1
        self._max_instances_per_category = 1 << 16
        self._compute_scores = compute_scores

    def _device_tables(self, device) -> dict:
        """The class tables on `device`, copied there once (a copy per
        request would synchronise the host with the card)."""
        if device not in self._tables:
            self._tables[device] = {k: v.to(device)
                                    for k, v in self._tables_cpu.items()}
        return self._tables[device]

    @property
    def max_instances_per_category(self) -> int:
        return self._max_instances_per_category

    def _postprocess_training(self, data, batch):
        (s_output, i_output), (s_side, i_side) = data
        r_dict = self._semantic_postprocessing._postprocess_training(
            (s_output, s_side), batch)
        r_dict.update(self._instance_postprocessing._postprocess_training(
            (i_output, i_side), batch))
        return r_dict

    def _postprocess_inference(self, data, batch, keys=None):
        (s_output, i_output), (s_side, i_side) = data
        r_dict = self._semantic_postprocessing._postprocess_inference(
            (s_output, s_side), batch, keys,
            extra=(SOFTMAX_KEY,) if self._compute_scores else ())
        post = self._instance_postprocessing
        r_dict.update(post._postprocess_inference((i_output, i_side), batch,
                                                  keys))
        center_heatmap, center_offset = i_output[0], i_output[1]

        # thing-foreground mask from the working-resolution prediction
        semantic_idx = r_dict['semantic_segmentation_idx']   # (B, H, W)
        tables = self._device_tables(semantic_idx.device)
        foreground_mask = tables['thing'][semantic_idx.long()]
        r_dict['panoptic_foreground_mask'] = foreground_mask

        result = post._get_instance_segmentation(
            center_heatmap, post._denormalize(center_offset),
            foreground_mask)
        instance_segmentation = result.segmentation
        # semantic + 1: predictions have no void class
        want_slots = any(wants(keys, k) for k in _SLOT_KEYS)
        merge = (deeplab_merge_pq if want_slots else deeplab_merge)(
            semantic_idx + 1, instance_segmentation, foreground_mask,
            tables['thing_panoptic'],
            max_instances_per_category=self._max_instances_per_category,
            top_k=post._top_k_instances,
            n_classes_with_void=self._n_classes_with_void)
        if want_slots:
            r_dict['panoptic_segmentation_deeplab_slots'] = merge.slots
            r_dict['panoptic_segmentation_deeplab_slot_table'] = \
                merge.pred_table
        panoptic_seg = merge.panoptic
        pan_seg_semantic = torch.div(
            panoptic_seg, self._max_instances_per_category,
            rounding_mode='floor')
        r_dict.update({
            'panoptic_segmentation_deeplab': panoptic_seg,
            'panoptic_segmentation_deeplab_ids': merge.panoptic_id_table,
            'panoptic_segmentation_deeplab_semantic_idx': pan_seg_semantic,
            'panoptic_segmentation_deeplab_instance_idx':
                instance_segmentation,
            'panoptic_segmentation_deeplab_instance_meta': {
                'centers_yx': result.centers.yx,
                'scores': result.scores,
                'valid': result.centers.valid,
                'areas': result.areas,
                'panoptic_ids': merge.panoptic_id_table,
                'semantic_idx': merge.instance_class,
            },
        })
        if self._compute_scores:
            self._add_scores(r_dict, pan_seg_semantic, instance_segmentation,
                             result, merge)
        for key in _FULLRES_SOURCES + SCORE_KEYS:
            if key in r_dict:
                self._add_fullres(r_dict, batch, key, keys,
                                  shape_key='instance')
        if len(i_output) == 3:
            fg_ori = tables['orientation_panoptic'][pan_seg_semantic.clamp(
                0, self._n_classes_with_void - 1).long()]
            r_dict['orientations_panoptic_segmentation_deeplab_instance'] = \
                instance_orientations(i_output[2], instance_segmentation,
                                      fg_ori, post._top_k_instances)
        return r_dict

    def _add_scores(self, r_dict, pan_seg_semantic, instance_segmentation,
                    result, merge) -> None:
        """Dense scores (Panoptic-DeepLab style): stuff pixels carry
        their semantic score, thing pixels their instance's centre score
        times the mean semantic score of the instance's panoptic pixels
        (summed in f32). Gathers and scatter-adds of the (B, K+1)
        tables; instance id 0 (no instance) reads the zero slot."""
        K = self._instance_postprocessing._top_k_instances
        scores = r_dict[SOFTMAX_KEY]                        # (B, C, H, W)
        void = pan_seg_semantic == 0
        sem_score = torch.gather(
            scores, 1, torch.where(void, 0, pan_seg_semantic - 1)
            .long()[:, None])[:, 0]
        sem_score = torch.where(void, 0.0, sem_score)
        r_dict[SCORE_KEYS[0]] = sem_score

        B, H, W = instance_segmentation.shape
        flat_ins = instance_segmentation.reshape(B, -1).long()
        # pixels of instances the merge kept (a thing panoptic id)
        px_valid = torch.gather(merge.panoptic_id_table != 0, 1, flat_ins)
        score_table = torch.cat([result.scores.new_zeros((B, 1)),
                                 result.scores], dim=1)
        inst_score = torch.where(px_valid,
                                 torch.gather(score_table, 1, flat_ins), 0.0)
        r_dict[SCORE_KEYS[1]] = inst_score.reshape(B, H, W)

        flat_sem = sem_score.reshape(B, -1)
        masked = torch.where(px_valid, flat_ins, 0)
        sums = torch.zeros((B, K + 1), dtype=torch.float32,
                           device=flat_ins.device)
        sums.scatter_add_(1, masked, flat_sem.float())
        counts = torch.zeros_like(sums).scatter_add_(
            1, masked, torch.ones_like(flat_sem, dtype=torch.float32))
        mean_sem = sums / counts.clamp(min=1.0)              # (B, K+1)
        pan_score = torch.where(
            px_valid, inst_score * torch.gather(mean_sem, 1, flat_ins),
            flat_sem)
        r_dict[SCORE_KEYS[2]] = pan_score.reshape(B, H, W)
        meta = r_dict['panoptic_segmentation_deeplab_instance_meta']
        meta['semantic_score'] = mean_sem[:, 1:]
        meta['panoptic_score'] = result.scores * mean_sem[:, 1:]

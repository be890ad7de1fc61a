"""Panoptic postprocessing, inference branch (counterpart of
nicr_mtsa_tpu/postprocessing/panoptic.py): semantic + instance
postprocessing, the thing-foreground mask, the Panoptic-DeepLab merge,
per-instance orientations and, with a valid region in the batch, the
nearest full-resolution maps, all on device. The merge also emits its
PQ slot map and segment table (`deeplab_merge_pq`) when the caller
reads them (the eval step), else it is the plain `deeplab_merge` (the
serving path). Dense scores (`compute_scores`) are not ported."""
from typing import Tuple

import torch

from ..data.fullres import get_fullres_key
from ..ops.grouping import instance_orientations
from ..ops.merge import deeplab_merge, deeplab_merge_pq
from .base import DensePostprocessingBase, wants
from .instance import InstancePostprocessing
from .semantic import SemanticPostprocessing

_FULLRES_SOURCES = ('panoptic_segmentation_deeplab',
                    'panoptic_segmentation_deeplab_instance_idx',
                    'panoptic_segmentation_deeplab_semantic_idx',
                    'panoptic_segmentation_deeplab_slots')
_SLOT_KEYS = ('panoptic_segmentation_deeplab_slots',
              'panoptic_segmentation_deeplab_slot_table',
              get_fullres_key('panoptic_segmentation_deeplab_slots'))


class PanopticPostprocessing(DensePostprocessingBase):
    def __init__(self, semantic_postprocessing: SemanticPostprocessing,
                 instance_postprocessing: InstancePostprocessing,
                 semantic_classes_is_thing: Tuple[bool, ...],
                 semantic_class_has_orientation: Tuple[bool, ...]):
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

    def _postprocess_inference(self, data, batch, keys=None):
        (s_output, i_output), (s_side, i_side) = data
        r_dict = self._semantic_postprocessing._postprocess_inference(
            (s_output, s_side), batch, keys)
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
        for key in _FULLRES_SOURCES:
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

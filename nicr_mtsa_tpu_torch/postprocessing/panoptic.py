"""Panoptic postprocessing, inference branch of the serving path
(counterpart of nicr_mtsa_tpu/postprocessing/panoptic.py): semantic +
instance postprocessing, the thing-foreground mask, the Panoptic-
DeepLab merge and per-instance orientations, all on device.

The JAX serving program calls `deeplab_merge_pq` and lets XLA drop the
PQ slot maps it never returns; here the plain `deeplab_merge` gives
the same panoptic map, and the slot maps come with the eval slice.
Dense scores (`compute_scores`) and the full-resolution keys are not
ported: the serving dict reads neither."""
from typing import Tuple

import torch

from ..ops.grouping import instance_orientations
from ..ops.merge import deeplab_merge
from .base import PostprocessingBase
from .instance import InstancePostprocessing
from .semantic import SemanticPostprocessing


class PanopticPostprocessing(PostprocessingBase):
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

    def _postprocess_inference(self, data, batch):
        (s_output, i_output), (s_side, i_side) = data
        r_dict = self._semantic_postprocessing._postprocess_inference(
            (s_output, s_side), batch)
        post = self._instance_postprocessing
        r_dict.update(post._postprocess_inference((i_output, i_side),
                                                  batch))
        with_orientation = len(i_output) == 3
        center_heatmap, center_offset = i_output[0], i_output[1]
        center_offset_ = post._denormalize(center_offset)

        semantic_idx = r_dict['semantic_segmentation_idx']   # (B, H, W)
        tables = self._device_tables(semantic_idx.device)
        foreground_mask = tables['thing'][semantic_idx.long()]
        r_dict['panoptic_foreground_mask'] = foreground_mask

        result = post._get_instance_segmentation(
            center_heatmap, center_offset_, foreground_mask)
        instance_segmentation = result.segmentation
        merge = deeplab_merge(
            semantic_idx + 1, instance_segmentation, foreground_mask,
            tables['thing_panoptic'],
            max_instances_per_category=self._max_instances_per_category,
            top_k=post._top_k_instances,
            n_classes_with_void=self._n_classes_with_void)
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
        if with_orientation:
            fg_ori = tables['orientation_panoptic'][pan_seg_semantic.clamp(
                0, self._n_classes_with_void - 1).long()]
            r_dict['orientations_panoptic_segmentation_deeplab_instance'] = \
                instance_orientations(i_output[2], instance_segmentation,
                                      fg_ori, post._top_k_instances)
        return r_dict

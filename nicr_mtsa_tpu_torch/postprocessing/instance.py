"""Instance postprocessing (counterpart of
nicr_mtsa_tpu/postprocessing/instance.py). Training passes the outputs
on. Inference: centre NMS + offset-vote
grouping on device. With ground truth in the batch (dataset
evaluation) it also segments under the GT foreground (branch i-1, with
its full-resolution map) and reads per-instance orientations under the
GT orientation foreground (branch o-2), and, where a reader asks for
it (the eager validation step), the mean orientation of each GT
instance under the GT orientation foreground (branch o-1,
`segment_orientation_table`). With `debug` it also segments with
every pixel foreground (branch i-2, `instance_segmentation_all_
foreground` and its full-resolution map: one more grouping) and, with
ground truth in the batch, reads the mean orientation of every GT
instance and of every predicted instance without a foreground mask
(`orientations_gt_instance`, `orientations_instance_segmentation`)."""
from typing import Optional

import torch

from ..ops.grouping import (denormalize_offsets, get_instance_segmentation,
                            instance_orientations)
from ..ops.segments import SEGMENT_TABLE_PAD, ids_to_slots, unique_table
from .base import DensePostprocessingBase, wants

O1_KEY = 'orientations_gt_instance_gt_orientation_foreground'
ALL_FG_KEY = 'instance_segmentation_all_foreground'


def segment_orientation_table(orientation, ids_map, foreground_mask,
                              table_size: int = 128) -> dict:
    """Mean orientation of each segment of an id map with arbitrary ids
    (a GT instance map): the ids compressed to a sorted table of
    `table_size`, the biternion channels of orientation (B, 2, H, W)
    summed in f32 over each segment's pixels under `foreground_mask`
    (B, H, W) (all pixels where None). {'ids', 'angles', 'valid'},
    (B, S) each; a slot is valid where it holds an id other than 0 with
    at least one counted pixel."""
    B = ids_map.shape[0]
    flat_ids = ids_map.reshape(B, -1).to(torch.int32)
    table = unique_table(flat_ids, table_size)
    S = table.shape[-1]
    if foreground_mask is not None:
        flat_ids = torch.where(foreground_mask.reshape(B, -1), flat_ids, -1)
    slots = ids_to_slots(flat_ids, table).long()        # S: dropped
    ori = orientation.float().reshape(B, 2, -1)
    sums = torch.zeros((B, 2, S + 1), dtype=torch.float32,
                       device=ori.device)
    sums.scatter_add_(2, slots[:, None].expand(-1, 2, -1), ori)
    counts = torch.zeros((B, S + 1), dtype=torch.int32, device=ori.device)
    counts.scatter_add_(1, slots, torch.ones_like(slots, dtype=torch.int32))
    sums, counts = sums[..., :S], counts[:, :S]
    return {'ids': table,
            'angles': torch.atan2(sums[:, 1], sums[:, 0]),
            'valid': (table != SEGMENT_TABLE_PAD) & (table != 0)
            & (counts > 0)}


class InstancePostprocessing(DensePostprocessingBase):
    def __init__(self, heatmap_threshold: float = 0.1,
                 heatmap_nms_kernel_size: int = 3,
                 heatmap_apply_foreground_mask: bool = False,
                 top_k_instances: int = 64, normalized_offset: bool = True,
                 offset_distance_threshold: Optional[float] = None,
                 debug: bool = False):
        if heatmap_nms_kernel_size % 2 != 1:
            raise ValueError('heatmap_nms_kernel_size must be odd')
        if not 0 < top_k_instances <= 254:
            raise ValueError('top_k_instances must be in [1, 254]')
        self._heatmap_threshold = heatmap_threshold
        self._heatmap_nms_kernel_size = heatmap_nms_kernel_size
        self._heatmap_apply_foreground_mask = heatmap_apply_foreground_mask
        self._top_k_instances = top_k_instances
        self._normalized_offset = normalized_offset
        self._offset_distance_threshold = offset_distance_threshold
        self.debug = debug

    def _denormalize(self, center_offset):
        if not self._normalized_offset:
            return center_offset
        h, w = center_offset.shape[-2:]
        return denormalize_offsets(center_offset, h, w)

    def _get_instance_segmentation(self, center_heatmap, center_offset,
                                   foreground_mask):
        """center_heatmap (B, 1, H, W); center_offset unnormalised."""
        return get_instance_segmentation(
            center_heatmap[:, 0], center_offset, foreground_mask,
            threshold=self._heatmap_threshold,
            kernel_size=self._heatmap_nms_kernel_size,
            top_k=self._top_k_instances,
            offset_distance_threshold=self._offset_distance_threshold,
            heatmap_apply_foreground_mask=(
                self._heatmap_apply_foreground_mask))

    def _get_instance_orientation(self, orientation, segmentation,
                                  foreground_mask):
        return instance_orientations(orientation, segmentation,
                                     foreground_mask, self._top_k_instances)

    def _postprocess_training(self, data, batch):
        output, side_outputs = data
        return {'instance_output': output,
                'instance_side_outputs': side_outputs}

    def _postprocess_inference(self, data, batch, keys=None):
        output, side_outputs = data
        r_dict = {'instance_output': output,
                  'instance_side_outputs': side_outputs,
                  'instance_centers': output[0],
                  'instance_offsets': output[1]}
        offsets = self._denormalize(output[1])
        with_orientation = len(output) == 3

        # i-1: segmentation under the GT foreground (dataset evaluation)
        if 'instance_foreground' in batch:
            result = self._get_instance_segmentation(
                output[0], offsets, batch['instance_foreground'])
            r_dict['instance_segmentation_gt_foreground'] = \
                result.segmentation
            r_dict['instance_segmentation_gt_meta'] = {
                'centers_yx': result.centers.yx, 'scores': result.scores,
                'valid': result.centers.valid, 'areas': result.areas}
            self._add_fullres(r_dict, batch,
                              'instance_segmentation_gt_foreground', keys,
                              shape_key='instance')

        # i-2: every pixel foreground (debugging)
        if self.debug:
            B, _, H, W = output[0].shape
            r_dict[ALL_FG_KEY] = self._get_instance_segmentation(
                output[0], offsets,
                torch.ones((B, H, W), dtype=torch.bool,
                           device=output[0].device)).segmentation
            self._add_fullres(r_dict, batch, ALL_FG_KEY, keys,
                              shape_key='instance')
        if not with_orientation:
            return r_dict

        # o-1: GT instances + GT orientation foreground, on request
        if wants(keys, O1_KEY) and all(
                k in batch for k in ('instance', 'orientation_foreground')):
            r_dict[O1_KEY] = segment_orientation_table(
                output[2], batch['instance'],
                batch['orientation_foreground'])

        # o-2: predicted instances + GT orientation foreground
        seg = r_dict.get('instance_segmentation_gt_foreground')
        if seg is not None and 'orientation_foreground' in batch:
            r_dict['orientations_instance_segmentation'
                   '_gt_orientation_foreground'] = \
                self._get_instance_orientation(
                    output[2], seg, batch['orientation_foreground'])

        # the same without a foreground mask (debugging)
        if self.debug and 'instance' in batch:
            r_dict['orientations_gt_instance'] = segment_orientation_table(
                output[2], batch['instance'], None)
        if self.debug and seg is not None:
            r_dict['orientations_instance_segmentation'] = \
                self._get_instance_orientation(output[2], seg, None)
        return r_dict

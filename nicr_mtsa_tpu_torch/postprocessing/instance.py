"""Instance postprocessing, inference branch (counterpart of
nicr_mtsa_tpu/postprocessing/instance.py): centre NMS + offset-vote
grouping on device. With ground truth in the batch (dataset
evaluation) it also segments under the GT foreground (branch i-1, with
its full-resolution map) and reads per-instance orientations under the
GT orientation foreground (branch o-2). Not ported: the debug branches
and the GT-instance orientation table (branch o-1), which only the
eager validation path reads."""
from typing import Optional

from ..ops.grouping import (denormalize_offsets, get_instance_segmentation,
                            instance_orientations)
from .base import DensePostprocessingBase


class InstancePostprocessing(DensePostprocessingBase):
    def __init__(self, heatmap_threshold: float = 0.1,
                 heatmap_nms_kernel_size: int = 3,
                 heatmap_apply_foreground_mask: bool = False,
                 top_k_instances: int = 64, normalized_offset: bool = True,
                 offset_distance_threshold: Optional[float] = None):
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

    def _postprocess_inference(self, data, batch, keys=None):
        output, side_outputs = data
        r_dict = {'instance_output': output,
                  'instance_side_outputs': side_outputs,
                  'instance_centers': output[0],
                  'instance_offsets': output[1]}
        if 'instance_foreground' not in batch:
            return r_dict

        # i-1: segmentation under the GT foreground (dataset evaluation)
        result = self._get_instance_segmentation(
            output[0], self._denormalize(output[1]),
            batch['instance_foreground'])
        r_dict['instance_segmentation_gt_foreground'] = result.segmentation
        r_dict['instance_segmentation_gt_meta'] = {
            'centers_yx': result.centers.yx, 'scores': result.scores,
            'valid': result.centers.valid, 'areas': result.areas}
        self._add_fullres(r_dict, batch, 'instance_segmentation_gt_foreground',
                          keys, shape_key='instance')

        # o-2: predicted instances + GT orientation foreground
        if len(output) == 3 and 'orientation_foreground' in batch:
            r_dict['orientations_instance_segmentation'
                   '_gt_orientation_foreground'] = \
                self._get_instance_orientation(
                    output[2], result.segmentation,
                    batch['orientation_foreground'])
        return r_dict

"""Instance postprocessing, inference branch of the serving path
(counterpart of nicr_mtsa_tpu/postprocessing/instance.py): centre NMS
+ offset-vote grouping on device. The branches that read ground truth
from the batch (dataset evaluation) come with the eval slice."""
from typing import Optional

from ..ops.grouping import (denormalize_offsets, get_instance_segmentation,
                            instance_orientations)
from .base import PostprocessingBase


class InstancePostprocessing(PostprocessingBase):
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

    def _postprocess_inference(self, data, batch):
        output, side_outputs = data
        return {'instance_output': output,
                'instance_side_outputs': side_outputs,
                'instance_centers': output[0],
                'instance_offsets': output[1]}

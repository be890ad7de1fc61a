"""Offset-vote pixel grouping and per-instance readouts (counterpart of
nicr_mtsa_tpu/ops/grouping.py). Maps are (B, H, W); offsets and
orientations are NCHW (B, 2, H, W)."""
from typing import NamedTuple, Optional

import torch

from .cuda.grouping import group_pixels_offsets
from .nms import Centers, get_instance_centers


class InstanceSegmentation(NamedTuple):
    segmentation: torch.Tensor   # (B, H, W) int32: 0 = no instance, 1..K
    centers: Centers
    areas: torch.Tensor          # (B, K+1) int32 pixel counts per id
    scores: torch.Tensor         # (B, K) heatmap score at each centre


def denormalize_offsets(offset, height: int, width: int):
    """Undo the [0, 1] offset normalisation in the offset's own dtype:
    channel 0 (y) * H, channel 1 (x) * W."""
    return torch.cat((offset[:, 0:1] * height, offset[:, 1:2] * width),
                     dim=1)


def group_pixels(centers_yx, centers_valid, offset, foreground_mask,
                 offset_distance_threshold=None):
    """(B, H, W) int32 instance ids (1..K, 0 = background) for
    unnormalised offsets (B, 2, H, W): one launch of the grouping kernel
    (loc formation, the mask and the threshold inside) on the card."""
    ids, _ = group_pixels_offsets(offset, centers_yx, centers_valid,
                                  foreground_mask, offset_distance_threshold)
    return ids


def instance_areas(segmentation, top_k: int):
    """(B, H, W) -> (B, K+1) int32 pixel counts per id (0 = bg)."""
    B = segmentation.shape[0]
    flat = segmentation.reshape(B, -1).long()
    counts = torch.zeros((B, top_k + 1), dtype=torch.int64,
                         device=flat.device)
    counts.scatter_add_(1, flat, torch.ones_like(flat))
    return counts.to(torch.int32)


def get_instance_segmentation(center_heatmap, center_offset,
                              foreground_mask, threshold: float = 0.1,
                              kernel_size: int = 3, top_k: int = 64,
                              offset_distance_threshold=None,
                              heatmap_apply_foreground_mask: bool = False
                              ) -> InstanceSegmentation:
    """Centre NMS + pixel grouping + per-instance meta; heatmap
    (B, H, W), unnormalised offsets (B, 2, H, W), mask (B, H, W)."""
    centers = get_instance_centers(
        center_heatmap, foreground_mask, threshold=threshold,
        kernel_size=kernel_size, top_k=top_k,
        use_foreground_mask=heatmap_apply_foreground_mask)
    seg = group_pixels(centers.yx, centers.valid, center_offset,
                       foreground_mask, offset_distance_threshold)
    return InstanceSegmentation(segmentation=seg, centers=centers,
                                areas=instance_areas(seg, top_k),
                                scores=centers.score)


def instance_orientations(orientation, segmentation,
                          foreground_mask: Optional[torch.Tensor],
                          top_k: int = 64):
    """(B, K+1) f32 mean orientation angle per instance id: the
    biternion channels (B, 2, H, W) summed over each instance's
    (masked) pixels, then atan2."""
    B = segmentation.shape[0]
    seg = segmentation.reshape(B, -1).long()
    if foreground_mask is not None:
        seg = torch.where(foreground_mask.reshape(B, -1), seg, 0)
    ori = orientation.reshape(B, 2, -1).float()
    sums = torch.zeros((B, 2, top_k + 1), dtype=torch.float32,
                       device=seg.device)
    sums.scatter_add_(2, seg[:, None].expand(B, 2, seg.shape[1]), ori)
    return torch.atan2(sums[:, 1], sums[:, 0])

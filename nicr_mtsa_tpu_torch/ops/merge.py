"""Panoptic-DeepLab merge, fixed-shape and batched (counterpart of
nicr_mtsa_tpu/ops/merge.py `deeplab_merge` and the lookups of
nicr_mtsa_tpu/ops/lookup.py, which become plain indexing here):

1. per-instance class histogram over thing pixels (integer scatter-add,
   exact),
2. majority class = first argmax (ties -> smallest class id),
3. per-class running instance ids by a cumulative sum over the
   instance slots (ascending id order),
4. per-pixel panoptic ids gathered from the (K+1)-entry table."""
from typing import NamedTuple

import torch

from .reduce import first_argmax


class PanopticMerge(NamedTuple):
    panoptic: torch.Tensor           # (B, H, W) int32 panoptic ids
    panoptic_id_table: torch.Tensor  # (B, K+1) int32: ins id -> pan id
    instance_class: torch.Tensor     # (B, K+1) int32 majority class


def deeplab_merge(semantic, instance, semantic_thing_seg,
                  thing_class_table, max_instances_per_category: int = 1 << 16,
                  top_k: int = 64,
                  n_classes_with_void: int = 41) -> PanopticMerge:
    """semantic (B, H, W) int (0 = void), instance (B, H, W) ids 0..K,
    semantic_thing_seg (B, H, W) bool, thing_class_table (C,) bool on
    the same device, indexed by class id with void."""
    B, H, W = semantic.shape
    K, C, M = top_k, n_classes_with_void, max_instances_per_category
    sem = semantic.reshape(B, -1).long()
    ins = instance.reshape(B, -1).long()
    fg = semantic_thing_seg.reshape(B, -1)
    is_thing_px = (ins > 0) & fg
    ins_slot = torch.where(is_thing_px, ins, 0)

    # (1) histogram (B, K+1, C); slot 0 collects non-thing pixels
    hist = torch.zeros((B, (K + 1) * C), dtype=torch.int64,
                       device=sem.device)
    hist.scatter_add_(1, ins_slot * C + sem, torch.ones_like(sem))
    hist = hist.view(B, K + 1, C)
    counts = hist.sum(dim=-1)
    # (2) majority class, ties -> smallest class id
    majority = first_argmax(hist, -1)
    valid = (counts > 0) & (majority > 0)
    valid[:, 0] = False
    # (3) rank among valid instances of the same class, ascending id
    cls = torch.where(valid, majority, 0)
    onehot = torch.zeros((B, K + 1, C), dtype=torch.int64,
                         device=sem.device)
    onehot.scatter_(2, cls[..., None], valid[..., None].long())
    rank = torch.gather(onehot.cumsum(dim=1), 2, majority[..., None])[..., 0]
    table = torch.where(valid, majority * M + rank, 0).to(torch.int32)

    # (4) per-pixel assembly
    table_gather = torch.gather(table, 1, ins_slot)
    is_stuff_class = ~thing_class_table[sem.clamp(0, C - 1)]
    stuff_px = (ins == 0) & (sem > 0) & is_stuff_class
    pan = torch.where(is_thing_px, table_gather, 0)
    pan = torch.where(stuff_px, (sem * M).to(torch.int32), pan)
    return PanopticMerge(
        panoptic=pan.reshape(B, H, W).to(torch.int32),
        panoptic_id_table=table,
        instance_class=cls.to(torch.int32))

"""Panoptic-DeepLab merge, fixed-shape and batched (counterpart of
nicr_mtsa_tpu/ops/merge.py `deeplab_merge` and `deeplab_merge_pq`, and
of the lookups of nicr_mtsa_tpu/ops/lookup.py, which become plain
indexing here):

1. per-instance class histogram over thing pixels (integer scatter-add,
   exact),
2. majority class = first argmax (ties -> smallest class id),
3. per-class running instance ids by a cumulative sum over the
   instance slots (ascending id order),
4. per-pixel panoptic ids gathered from the (K+1)-entry table.

`deeplab_merge_pq` also emits each pixel's PQ slot in a segment table
built from the merge's own candidates (ops/segments.py contract)."""
from typing import NamedTuple

import torch

from .reduce import first_argmax
from .segments import SEGMENT_TABLE_PAD, ids_to_slots


class PanopticMerge(NamedTuple):
    panoptic: torch.Tensor           # (B, H, W) int32 panoptic ids
    panoptic_id_table: torch.Tensor  # (B, K+1) int32: ins id -> pan id
    instance_class: torch.Tensor     # (B, K+1) int32 majority class


class PanopticMergeSlots(NamedTuple):
    slots: torch.Tensor              # (B, H, W) int32 pred PQ slots
    pred_table: torch.Tensor         # (B, S) int32 sorted, PAD-padded
    panoptic_id_table: torch.Tensor  # (B, K+1) int32: ins id -> pan id
    instance_class: torch.Tensor     # (B, K+1) int32 majority class
    panoptic: torch.Tensor           # (B, H, W) int32 merged id map


def _merge_tables(semantic, instance, semantic_thing_seg, K: int, C: int,
                  M: int):
    """Steps 1-3: flat maps (B, P) and the (B, K+1) tables."""
    B = semantic.shape[0]
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
    return sem, ins, is_thing_px, ins_slot, valid, cls, table


def deeplab_merge(semantic, instance, semantic_thing_seg,
                  thing_class_table, max_instances_per_category: int = 1 << 16,
                  top_k: int = 64,
                  n_classes_with_void: int = 41) -> PanopticMerge:
    """semantic (B, H, W) int (0 = void), instance (B, H, W) ids 0..K,
    semantic_thing_seg (B, H, W) bool, thing_class_table (C,) bool on
    the same device, indexed by class id with void."""
    B, H, W = semantic.shape
    K, C, M = top_k, n_classes_with_void, max_instances_per_category
    sem, ins, is_thing_px, ins_slot, _, cls, table = _merge_tables(
        semantic, instance, semantic_thing_seg, K, C, M)

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


def deeplab_merge_pq(semantic, instance, semantic_thing_seg,
                     thing_class_table,
                     max_instances_per_category: int = 1 << 16,
                     top_k: int = 64, n_classes_with_void: int = 41,
                     pred_table_size: int = 128) -> PanopticMergeSlots:
    """`deeplab_merge` plus the per-pixel PQ slots of the merged map in
    a sorted, PAD-padded table of the merge's candidates: void 0, one
    id per stuff class (present or not: a zero-area slot is inert in
    pq_compare) and one per valid instance. Raises ValueError unless
    pred_table_size >= C + top_k + 1 (the JAX package asserts it)."""
    B, H, W = semantic.shape
    K, C, M = top_k, n_classes_with_void, max_instances_per_category
    S = pred_table_size
    if S < C + K + 1:
        raise ValueError(f'pred_table_size {S} < C + K + 1 = {C + K + 1}')
    sem, ins, is_thing_px, ins_slot, valid, cls, table = _merge_tables(
        semantic, instance, semantic_thing_seg, K, C, M)
    dev = sem.device

    # candidates (B, C + K): void, stuff classes, valid instances
    is_stuff = ~thing_class_table
    class_ids = torch.arange(C, dtype=torch.int32, device=dev) * M
    stuff_cand = torch.where(is_stuff[1:], class_ids[1:],
                             SEGMENT_TABLE_PAD)
    thing_cand = torch.where(valid[:, 1:], table[:, 1:], SEGMENT_TABLE_PAD)
    cand = torch.cat([torch.zeros((B, 1), dtype=torch.int32, device=dev),
                      stuff_cand[None].expand(B, C - 1), thing_cand], dim=1)
    pred_table = torch.cat(
        [torch.sort(cand, dim=-1)[0],
         torch.full((B, S - C - K), SEGMENT_TABLE_PAD, dtype=torch.int32,
                    device=dev)], dim=1)

    # slot of each instance id and of each stuff class (void -> slot 0)
    slot_by_inst = torch.where(valid, ids_to_slots(table, pred_table), 0)
    stuff_ok = is_stuff.clone()
    stuff_ok[0] = False
    slot_by_class = torch.where(
        stuff_ok[None], ids_to_slots(class_ids[None].expand(B, C),
                                     pred_table), 0)

    # per-pixel assembly (id 0 sorts first, so the void slot is 0)
    sem_c = sem.clamp(0, C - 1)
    stuff_px = (ins == 0) & (sem > 0) & ~thing_class_table[sem_c]
    slots = torch.where(is_thing_px, torch.gather(slot_by_inst, 1, ins_slot),
                        torch.where(stuff_px,
                                    torch.gather(slot_by_class, 1, sem_c),
                                    0))
    pan = torch.where(is_thing_px, torch.gather(table, 1, ins_slot), 0)
    pan = torch.where(stuff_px, (sem * M).to(torch.int32), pan)
    return PanopticMergeSlots(
        slots=slots.reshape(B, H, W).to(torch.int32),
        pred_table=pred_table, panoptic_id_table=table,
        instance_class=cls.to(torch.int32),
        panoptic=pan.reshape(B, H, W).to(torch.int32))

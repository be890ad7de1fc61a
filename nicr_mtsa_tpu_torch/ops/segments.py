"""Fixed-size segment tables for the on-device panoptic metrics
(counterpart of nicr_mtsa_tpu/ops/segments.py).

Each image's unbounded panoptic-id space is compressed to a sorted
table of at most S ids, padded at the end with SEGMENT_TABLE_PAD (int32
max) so it stays sorted; pixel ids map to their slot in the table, and
"S" means "not in the table". Maps, tables and slots are int32.

`ids_to_slots` is a binary search (`torch.searchsorted`) plus an
equality test: the JAX package's compare-count and bucketed searches
exist for the TPU's matrix unit. `intersection_matrix` dispatches to
the CUDA histogram kernel (ops/cuda/intersection.py) on the card."""
import torch

from .cuda.intersection import intersection_matrix_kernel

SEGMENT_TABLE_PAD = 2 ** 31 - 1     # keeps tables sorted ascending


def unique_table(ids, size: int):
    """(B, ...) int -> (B, size) int32 sorted unique values, padded at
    the end with SEGMENT_TABLE_PAD (values beyond `size` are cut)."""
    B = ids.shape[0]
    s, _ = torch.sort(ids.reshape(B, -1).to(torch.int32), dim=-1)
    first = torch.ones_like(s, dtype=torch.bool)
    first[:, 1:] = s[:, 1:] != s[:, :-1]
    dedup = torch.where(first, s, SEGMENT_TABLE_PAD)
    return torch.sort(dedup, dim=-1)[0][:, :size]


def merged_segment_table(panoptic_map, n_classes_with_void: int,
                         top_k: int, max_instances_per_category: int,
                         size: int):
    """`unique_table` of a merged panoptic map whose ids are class * M
    + rank with rank <= top_k (ops/merge.py): presence over the
    (C, K+1) candidate grid, then a sort of the candidates. An id
    outside that contract has no candidate and drops out."""
    B = panoptic_map.shape[0]
    C, K, M = n_classes_with_void, top_k, max_instances_per_category
    ids = panoptic_map.reshape(B, -1).long()
    cls = torch.div(ids, M, rounding_mode='floor')
    rank = ids - cls * M
    ok = (rank <= K) & (cls >= 0) & (cls < C)
    cell = torch.where(ok, cls * (K + 1) + rank, C * (K + 1))
    present = torch.zeros((B, C * (K + 1) + 1), dtype=torch.bool,
                          device=ids.device)
    present.scatter_(1, cell, True)
    grid = (torch.arange(C, device=ids.device)[:, None] * M
            + torch.arange(K + 1, device=ids.device)[None, :]).reshape(-1)
    cand = torch.where(present[:, :-1], grid.to(torch.int32),
                       SEGMENT_TABLE_PAD)
    return torch.sort(cand, dim=-1)[0][:, :size]


def ids_to_slots(ids, table):
    """Slots (B, ...) int32 of pixel ids (B, ...) in a sorted table
    (B, S) whose real ids are unique; an id not in the table (e.g. -1)
    maps to S."""
    B, S = table.shape
    flat = ids.reshape(B, -1).to(table.dtype).contiguous()
    slot = torch.searchsorted(table.contiguous(), flat, out_int32=True)
    found = torch.gather(table, 1, slot.clamp(max=S - 1).long()) == flat
    return torch.where(found, slot, S).reshape(ids.shape)


def intersection_matrix(gt_slots, pred_slots, n_gt: int, n_pred: int):
    """(B, n_gt+1, n_pred+1) float32 pixel counts per (gt, pred) slot
    pair of two slot maps (B, ...); the last row/column holds the
    out-of-table pixels. Exact."""
    B = gt_slots.shape[0]
    return intersection_matrix_kernel(gt_slots.reshape(B, -1),
                                      pred_slots.reshape(B, -1),
                                      n_gt, n_pred)

"""Angle tables of the orientation-aware PQ (counterpart of
nicr_mtsa_tpu/tasks/_orientation_tables.py `pred_slot_angles`; the GT
side comes with the batch as `panoptic_gt_angle_table(_valid)`)."""
import torch

from ..ops.reduce import first_argmax
from ..ops.segments import SEGMENT_TABLE_PAD


def pred_slot_angles(pred_table, panoptic_id_table, angles_by_instance):
    """(B, S) angles + validity per pred segment slot: the slot's id is
    matched against the merge's (B, K+1) raw-instance -> panoptic-id
    table, and the angle of the first matching instance is taken."""
    eq = (pred_table[:, :, None] == panoptic_id_table[:, None, :])
    eq = eq & ((pred_table != 0) & (pred_table != SEGMENT_TABLE_PAD)
               )[:, :, None] & (panoptic_id_table != 0)[:, None, :]
    k = first_argmax(eq.to(torch.uint8), -1)
    return angles_by_instance.gather(1, k), eq.any(dim=-1)

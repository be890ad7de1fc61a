"""Angle tables of the orientation-aware PQ (counterpart of
nicr_mtsa_tpu/tasks/_orientation_tables.py): the GT side walked on the
host from the per-sample id dicts (`gt_slot_angles`, the eager
validation step; the fused step reads the tables the preprocessing
made, `panoptic_gt_angle_table(_valid)`), the prediction side on the
device (`pred_slot_angles`)."""
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..ops.reduce import first_argmax
from ..ops.segments import SEGMENT_TABLE_PAD


def gt_slot_angles(gt_table: np.ndarray, panoptic_id_dicts: List[Dict],
                   orientations_present: List[Dict]
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """(B, S) f32 angles and bool validity of each GT segment slot
    (`gt_table` (B, S) sorted panoptic ids): the slot's panoptic id ->
    instance id -> angle, where both are known."""
    gt_table = np.asarray(gt_table)
    angles = np.zeros(gt_table.shape, np.float32)
    valid = np.zeros(gt_table.shape, bool)
    for b, row in enumerate(gt_table):
        id_dict, ori = panoptic_id_dicts[b], orientations_present[b]
        for s, pan_id in enumerate(row):
            pan_id = int(pan_id)
            if pan_id in (0, SEGMENT_TABLE_PAD):
                continue
            ins_id = id_dict.get(pan_id)
            if ins_id is None or ori.get(ins_id) is None:
                continue
            angles[b, s] = float(ori[ins_id])
            valid[b, s] = True
    return angles, valid


def pred_slot_angles(pred_table, panoptic_id_table, angles_by_instance):
    """(B, S) angles + validity per pred segment slot: the slot's id is
    matched against the merge's (B, K+1) raw-instance -> panoptic-id
    table, and the angle of the first matching instance is taken."""
    eq = (pred_table[:, :, None] == panoptic_id_table[:, None, :])
    eq = eq & ((pred_table != 0) & (pred_table != SEGMENT_TABLE_PAD)
               )[:, :, None] & (panoptic_id_table != 0)[:, None, :]
    k = first_argmax(eq.to(torch.uint8), -1)
    return angles_by_instance.gather(1, k), eq.any(dim=-1)

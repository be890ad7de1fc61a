"""Angular error of the orientation-aware PQ (counterpart of
nicr_mtsa_tpu/metrics/mae.py `abs_angle_error_rad`; the stand-alone
MAE metric belongs to the eager validation path, not ported)."""
import math

import torch

TWO_PI = 2.0 * math.pi


def abs_angle_error_rad(pred_angle, target_angle):
    """Smallest absolute difference between two angles, in [0, pi]
    (floored remainders, as jnp's `%`)."""
    diff = pred_angle % TWO_PI - target_angle % TWO_PI
    return torch.abs((diff + math.pi) % TWO_PI - math.pi)

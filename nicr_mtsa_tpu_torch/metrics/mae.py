"""Mean absolute angular error (counterpart of
nicr_mtsa_tpu/metrics/mae.py): `abs_angle_error_rad`, which the
orientation-aware PQ also reads, and the stand-alone metric of the
eager validation path (the orientation MAE against the GT instances)."""
import math

import numpy as np
import torch

from .base import MetricBase

TWO_PI = 2.0 * math.pi


def abs_angle_error_rad(pred_angle, target_angle):
    """Smallest absolute difference between two angles, in [0, pi]
    (floored remainders, as jnp's `%`)."""
    diff = pred_angle % TWO_PI - target_angle % TWO_PI
    return torch.abs((diff + math.pi) % TWO_PI - math.pi)


class MeanAbsoluteAngularError(MetricBase):
    """State {'sum_angular_error': f32, 'n_elements': int32} scalars on
    the device; `compute` gives (rad, deg) as float32, nan where nothing
    was counted."""

    def empty_state(self, device=None):
        return {'sum_angular_error': torch.zeros((), dtype=torch.float32,
                                                 device=device),
                'n_elements': torch.zeros((), dtype=torch.int32,
                                          device=device)}

    def update_state(self, state, pred_angles, target_angles, valid=None):
        """Angles of any one shape (rad); `valid` marks the entries to
        count."""
        err = abs_angle_error_rad(pred_angles.float(), target_angles.float())
        if valid is not None:
            err = torch.where(valid, err, 0.0)
            n = valid.sum(dtype=torch.int32)
        else:
            n = err.numel()
        return {'sum_angular_error': state['sum_angular_error'] + err.sum(),
                'n_elements': state['n_elements'] + n}

    def compute_from_state(self, state):
        n = int(state['n_elements'])
        rad = float(state['sum_angular_error']) / n if n else float('nan')
        return np.float32(rad), np.float32(np.rad2deg(rad))

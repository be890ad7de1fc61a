"""Masked per-pixel RMSE of surface normals (counterpart of
nicr_mtsa_tpu/metrics/rmse.py): the mean over valid pixels of each
pixel's root of its channel-mean squared error, not the root of the
pooled mean squared error (the two differ wherever the error varies
across pixels)."""
import numpy as np
import torch

from .base import MetricBase


class RootMeanSquaredError(MetricBase):
    """State {'sum_rmse': f32, 'n_elements': int32} scalars on the
    device; `compute` gives the mean per-pixel RMSE as float32 (0 where
    nothing was counted)."""

    def empty_state(self, device=None):
        return {'sum_rmse': torch.zeros((), dtype=torch.float32,
                                        device=device),
                'n_elements': torch.zeros((), dtype=torch.int32,
                                          device=device)}

    def update_state(self, state, preds, target, mask=None):
        """preds, target: (B, C, H, W) (the channels on axis 1); mask:
        (B, H, W) bool of the pixels to count."""
        diff = preds.float() - target.float()
        rmse = torch.sqrt((diff * diff).mean(dim=1))
        if mask is not None:
            rmse = torch.where(mask, rmse, 0.0)
            n = mask.sum(dtype=torch.int32)
        else:
            n = rmse.numel()
        return {'sum_rmse': state['sum_rmse'] + rmse.sum(),
                'n_elements': state['n_elements'] + n}

    def compute_from_state(self, state):
        total = float(state['sum_rmse'])
        n = int(state['n_elements'])
        return np.float32(total / n if n else 0.0)

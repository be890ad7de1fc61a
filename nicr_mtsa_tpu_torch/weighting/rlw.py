"""Random Loss Weighting (own copy of nicr_mtsa_tpu/weighting/rlw.py,
after arXiv:2111.10603): fresh softmax-of-gaussian weights every step,
drawn from the weighting's own `numpy.random.default_rng(seed)`."""
from typing import Dict, Sequence

import numpy as np

from .base import LossWeightingBase


class RandomLossWeighting(LossWeightingBase):
    """softmax(normal / T) weights each step; with `scale` rescaled to
    sum to the number of tasks."""

    def __init__(self, loss_keys_to_consider: Sequence[str],
                 temperature: float = 1.0, scale: bool = False,
                 seed: int = 0) -> None:
        self._loss_keys = tuple(loss_keys_to_consider)
        self._temperature = temperature
        self._scale = scale
        self._rng = np.random.default_rng(seed)
        self._weights = None
        self.reset_weights()

    @property
    def weights(self) -> Dict[str, float]:
        return self._weights

    def reset_weights(self) -> None:
        self._compute_weights()

    def _compute_weights(self) -> None:
        gauss = self._rng.normal(size=len(self._loss_keys))
        softmax = np.exp(gauss / self._temperature)
        softmax /= softmax.sum()
        if self._scale:
            softmax *= len(softmax)
        self._weights = dict(zip(self._loss_keys,
                                 (float(w) for w in softmax)))

    def reduce_losses(self, losses: Dict, batch_idx: int):
        self._compute_weights()
        return self._weighted_sum(losses)

"""Fixed loss weighting (own copy of nicr_mtsa_tpu/weighting/fixed.py)."""
from copy import deepcopy
from typing import Dict

from .base import LossWeightingBase


class FixedLossWeighting(LossWeightingBase):
    """A static weighted sum of the per-task total losses."""

    def __init__(self, weights: Dict[str, float]) -> None:
        self._initial_weights = weights
        self.reset_weights()

    @property
    def weights(self) -> Dict[str, float]:
        return self._weights

    def reset_weights(self) -> None:
        self._weights = deepcopy(self._initial_weights)

    def reduce_losses(self, losses: Dict, batch_idx: int):
        return self._weighted_sum(losses)

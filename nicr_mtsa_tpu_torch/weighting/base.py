"""Loss-weighting base (own copy of nicr_mtsa_tpu/weighting/base.py).

`weights` maps each weighted '*_total_loss' key to a float; the
training step multiplies by the weights as they stand before it, then
hands the step's losses of those keys (floats, fetched once a step)
to `reduce_losses(losses, batch_idx)`, which moves the state machine on
(DWA at epoch boundaries, RLW every step) and returns their weighted
sum."""
import abc
from typing import Dict


class LossWeightingBase(abc.ABC):
    @property
    @abc.abstractmethod
    def weights(self) -> Dict[str, float]:
        ...

    @abc.abstractmethod
    def reset_weights(self) -> None:
        ...

    @abc.abstractmethod
    def reduce_losses(self, losses: Dict, batch_idx: int):
        ...

    def _weighted_sum(self, losses: Dict):
        return sum(self.weights[key] * losses[key] for key in self.weights)

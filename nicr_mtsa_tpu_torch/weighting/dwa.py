"""Dynamic Weight Average (own copy of nicr_mtsa_tpu/weighting/dwa.py,
after Liu et al., arXiv:1803.10704). At each epoch boundary (the step
with `batch_idx == 0`) the weight of task k becomes

    w_k = n_tasks * softmax_k(mean_loss_k(t-1) / mean_loss_k(t-2) / T)

and until two epoch means exist every weight is 1. The state (the two
epoch means, the running epoch's losses, the weights) is host-side and
rides along in checkpoints (`state_dict`)."""
from typing import Dict, List, Sequence

import numpy as np

from .base import LossWeightingBase


def dwa_weights(prev_epoch: Dict[str, float],
                prev_prev_epoch: Dict[str, float], keys: Sequence[str],
                temperature: float) -> Dict[str, float]:
    descent = np.array([prev_epoch[k] / prev_prev_epoch[k] for k in keys],
                       dtype=np.float64)
    scores = np.exp(descent / temperature)
    scale = len(keys) / scores.sum()
    return {k: float(s * scale) for k, s in zip(keys, scores)}


class DynamicWeightAverage(LossWeightingBase):
    """Per-epoch softmax-of-loss-ratio task weights."""

    def __init__(self, loss_keys_to_consider: Sequence[str],
                 temperature: float = 2.0) -> None:
        self._loss_keys = tuple(loss_keys_to_consider)
        self._temperature = temperature
        self.reset_weights()

    @property
    def weights(self) -> Dict[str, float]:
        return self._weights

    def reset_weights(self) -> None:
        self._epoch_means: List[Dict[str, float]] = []
        self._loss_buffer: List[Dict[str, float]] = []
        self._weights = {k: 1.0 for k in self._loss_keys}

    def _close_epoch(self) -> None:
        """Fold the buffered epoch into the history, refresh the
        weights."""
        if self._loss_buffer:
            means = {k: float(np.mean([step[k] for step in
                                       self._loss_buffer]))
                     for k in self._loss_keys}
            self._epoch_means = (self._epoch_means + [means])[-2:]
        if len(self._epoch_means) == 2:
            self._weights = dwa_weights(self._epoch_means[-1],
                                        self._epoch_means[-2],
                                        self._loss_keys, self._temperature)
        else:
            self._weights = {k: 1.0 for k in self._loss_keys}

    def reduce_losses(self, losses: Dict, batch_idx: int):
        if batch_idx == 0:
            self._close_epoch()
        snapshot = {k: float(losses[k]) for k in self._loss_keys}
        if batch_idx < len(self._loss_buffer):
            # a resumed or repeated step overwrites its entry (epochs of
            # equal length)
            self._loss_buffer[batch_idx] = snapshot
        else:
            self._loss_buffer.append(snapshot)
        return self._weighted_sum(losses)

    def state_dict(self) -> Dict:
        return {'loss_history': list(self._epoch_means),
                'loss_buffer': list(self._loss_buffer),
                'weights': dict(self._weights)}

    def load_state_dict(self, state: Dict) -> None:
        self._epoch_means = list(state['loss_history'])[-2:]
        self._loss_buffer = list(state['loss_buffer'])
        self._weights = dict(state['weights'])

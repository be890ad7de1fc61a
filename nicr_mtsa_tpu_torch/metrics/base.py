"""Metric protocol: device-resident states (counterpart of
nicr_mtsa_tpu/metrics/base.py). A metric is a pair of functions over a
state of tensors (or a dict of them):

- `empty_state(device)` -> a state of zeros,
- `update_state(state, ...)` -> the new state (on the state's device),
- `compute_from_state(state)` -> results, on the host at epoch end,

plus a stateful holder (`state`, `compute`, `reset`) for the task
helpers' epoch end."""
import torch


class MetricBase:
    def empty_state(self, device=None):
        raise NotImplementedError

    def update_state(self, state, *args, **kwargs):
        raise NotImplementedError

    def compute_from_state(self, state, *args, **kwargs):
        raise NotImplementedError

    @property
    def state(self):
        if getattr(self, '_state', None) is None:
            self._state = self.empty_state()
        return self._state

    @state.setter
    def state(self, value):
        self._state = value

    def compute(self, *args, **kwargs):
        return self.compute_from_state(self.state, *args, **kwargs)

    def reset(self):
        self._state = self.empty_state()


def to_numpy(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t

"""Metric protocol: device-resident states (counterpart of
nicr_mtsa_tpu/metrics/base.py). A metric is a pair of functions over a
state of tensors (or a dict of them):

- `empty_state(device)` -> a state of zeros,
- `update_state(state, ...)` -> the new state (on the state's device),
- `compute_from_state(state)` -> results, on the host at epoch end,

plus a stateful holder (`state`, `update`, `compute`, `reset`) for the
task helpers' eager steps and epoch end."""
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

    def update(self, *args, **kwargs):
        """The state updated in place (the stateful API of the eager
        path); a first state is made on the device of the first tensor
        argument."""
        if getattr(self, '_state', None) is None:
            device = next((a.device for a in args
                           if isinstance(a, torch.Tensor)), None)
            self._state = self.empty_state(device)
        self._state = self.update_state(self._state, *args, **kwargs)

    def compute(self, *args, **kwargs):
        return self.compute_from_state(self.state, *args, **kwargs)

    def reset(self):
        """Back to an empty state, made where the next update is."""
        self._state = None


def to_numpy(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t

"""AdamW as the JAX pipeline runs it (counterpart of `optax.adamw`:
`scale_by_adam`, `add_decayed_weights`, `scale_by_learning_rate`, then
`apply_updates`), on a dict of parameters, in place.

Per parameter p with gradient g, at step t (count, from 1):
  mu = (1 - b1) g + b1 mu'      nu = (1 - b2) g^2 + b2 nu'
  u = (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps) + wd p
  p = p + (-lr) u
with the bias corrections 1 - b^t formed in f32. A parameter with no
gradient counts as a zero gradient: its moments and its decay still
step, as they do for optax (where every parameter has a gradient);
`torch.optim.AdamW` would skip it. With `mu_dtype` (bfloat16) the first
moment is stored in that dtype: b1 mu' is computed in it, with b1
itself rounded to it (optax's weak-typed decay takes the moment's
dtype), the sum and the update in f32, and the f32 mu is cast when
stored (optax's order)."""
from typing import Dict, NamedTuple, Optional

import torch


class AdamWState(NamedTuple):
    count: torch.Tensor                      # int32 scalar, steps taken
    mu: Dict[str, torch.Tensor]              # first moments (mu_dtype)
    nu: Dict[str, torch.Tensor]              # second moments (f32)


class AdamW:
    def __init__(self, learning_rate: float = 1e-4, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 1e-4,
                 mu_dtype: Optional[torch.dtype] = None):
        self.lr, self.b1, self.b2 = learning_rate, b1, b2
        self.eps, self.weight_decay = eps, weight_decay
        self.mu_dtype = mu_dtype

    def init(self, params: Dict[str, torch.Tensor]) -> AdamWState:
        device = next(iter(params.values())).device
        return AdamWState(
            count=torch.zeros((), dtype=torch.int32, device=device),
            mu={n: torch.zeros_like(p, dtype=self.mu_dtype or p.dtype)
                for n, p in params.items()},
            nu={n: torch.zeros_like(p) for n, p in params.items()})

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, Optional[torch.Tensor]],
             state: AdamWState) -> None:
        """One update of `params` and `state`, in place; `grads` maps a
        name to its gradient or None (a zero gradient)."""
        state.count.add_(1)
        t = state.count.float()
        bc1 = 1.0 - torch.tensor(self.b1, device=t.device) ** t
        bc2 = 1.0 - torch.tensor(self.b2, device=t.device) ** t
        b1_mu = torch.tensor(self.b1, dtype=self.mu_dtype or torch.float32,
                             device=t.device)
        for name, p in params.items():
            g = grads.get(name)
            if g is None:
                g = torch.zeros_like(p)
            mu = (1.0 - self.b1) * g + b1_mu * state.mu[name]
            nu = (1.0 - self.b2) * (g * g) + self.b2 * state.nu[name]
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            u = u + self.weight_decay * p
            p.add_(u * -self.lr)
            state.mu[name].copy_(mu)
            state.nu[name].copy_(nu)

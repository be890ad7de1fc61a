"""Activation recompute of a block in training (the JAX package's
`nn.remat` over its residual, Swin and dense-decoder blocks:
nicr_mtsa_tpu/models/blocks.py `make_block(remat=True)`,
backbones/swin.py, decoders/base.py).

`recompute(fn, x, generator)` runs `fn(x, generator)` under
`torch.utils.checkpoint` (non-reentrant): the block keeps only its
input, and its activations are computed again in the backward pass.
Two things must come out as in the step without recompute, and this
module is the one place that sees to both:

- the random parts: the recompute draws the dropout and DropPath masks
  from the caller's explicit generator set back to its state at the
  block's forward, and afterwards the generator is put back where the
  backward found it. So the masks, and the generator's state after the
  step, are those of the step without recompute (torch's checkpoint
  saves and restores only the global RNG states);
- BatchNorm's running statistics: a BatchNorm in training mode moves
  them in its forward; during a recompute `recomputing()` is true and
  it leaves them alone, so they move once a step (flax's remat drops
  the recompute's state updates).

Where no gradient is taken (serving, eval, inference mode) the block
runs as it is: nothing is kept or recomputed, and the kernels and their
launches are those of the model without recompute.

`Recomputed` is the base of such a block: its `forward(x, generator)`
runs `block_forward` through `recompute` where the block's `remat` is
set. `remat` is a plain attribute, so the parameter tree is that of
the block without it and weights interchange."""
import contextlib
import threading

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

_local = threading.local()


def recomputing() -> bool:
    """True inside the backward pass's recompute of a block (on the
    thread that runs it)."""
    return getattr(_local, 'depth', 0) > 0


@contextlib.contextmanager
def _recompute_scope(generator, forward_state):
    _local.depth = getattr(_local, 'depth', 0) + 1
    resume = None
    if generator is not None:
        resume = generator.get_state()
        generator.set_state(forward_state)
    try:
        yield
    finally:
        # also where the checkpoint stops the recompute early by raising
        if generator is not None:
            generator.set_state(resume)
        _local.depth -= 1


def recompute(fn, x, generator=None):
    """fn(x, generator) with its activations recomputed in the backward
    pass; where grad is off, fn(x, generator) as it is. With
    `generator` None the random parts draw from the global RNG, which
    torch's checkpoint saves and restores itself."""
    if not torch.is_grad_enabled():
        return fn(x, generator)
    forward_state = None if generator is None else generator.get_state()
    ran = []

    def run(y):
        if not ran:                      # the forward
            ran.append(True)
            return fn(y, generator)
        with _recompute_scope(generator, forward_state):
            return fn(y, generator)

    return checkpoint(run, x, use_reentrant=False,
                      preserve_rng_state=generator is None)


class Recomputed(nn.Module):
    """A block whose forward is `block_forward(x, generator)`, run
    through `recompute` where `self.remat` is set."""
    remat = False

    def block_forward(self, x, generator=None):
        raise NotImplementedError

    def forward(self, x, generator=None):
        if self.remat:
            return recompute(self.block_forward, x, generator)
        return self.block_forward(x, generator)

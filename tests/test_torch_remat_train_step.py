"""`bench.py --remat` on the EMSANet training step: the port's step
with `emsanet_train_config(remat=True)` (every encoder block and the
dense decoders' blocks recompute their activations in the backward
pass, models/remat.py) against the JAX package's step with
`backbone_remat=True, decoder_remat=True`, on the CPU in f32, with the
small model, batch and shared variables of
`_torch_emsanet_train_helpers.py` (channel dropout off on both sides):

- every loss within rtol 1e-5, the same loss keys;
- the gradients leaf by leaf against the port's float64 remat step
  (which equals its float64 step without remat), within 1e-3 of the
  leaf's max |.| or within 4x the JAX f32 remat step's own error where
  that is more (the rule of test_torch_emsanet_train_step.py: two f32
  steps of this ReLU network differ by percents on the leaves behind a
  pre-activation rounded to the other side of 0);
- the BatchNorm statistics after the step within 1e-5 of the JAX
  step's (moved once: the recompute leaves them alone);
- the remat tree is the tree without remat, so the variables carry
  over unchanged, and the port's remat model blocks recompute."""
import numpy as np
import pytest
import torch

from _torch_emsanet_train_helpers import (jax_step, port_model, port_step,
                                          template, variables)
from _torch_train_helpers import grad as _grad

torch.set_num_threads(2)


@pytest.fixture(scope='module')
def steps():
    v = variables(template())
    jlosses, jgrads, _, jstats = jax_step(v, remat=True)
    tlosses, tstate, _ = port_step(v, remat=True)
    _, ref_state, _ = port_step(v, 'float64', remat=True)
    ref = {n: _grad(p).double().numpy()
           for n, p in ref_state['params'].items()}
    return dict(jlosses=jlosses, tlosses=tlosses, jgrads=jgrads,
                jstats=jstats, tstate=tstate, ref=ref)


def _errors(grads, ref):
    largest = max(float(np.abs(g).max()) for g in ref.values())
    return {n: float(np.abs(grads[n] - r).max())
            / max(float(np.abs(r).max()), 1e-5 * largest)
            for n, r in ref.items()}


def test_remat_train_losses_match_jax(steps):
    assert set(steps['tlosses']) == set(steps['jlosses'])
    for k, want in steps['jlosses'].items():
        np.testing.assert_allclose(steps['tlosses'][k], want, rtol=1e-5,
                                   err_msg=k)


def test_remat_train_gradients_match_reference(steps):
    params = steps['tstate']['params']
    assert set(params) == set(steps['jgrads']) == set(steps['ref'])
    got = _errors({n: _grad(p).numpy() for n, p in params.items()},
                  steps['ref'])
    jax_err = _errors(steps['jgrads'], steps['ref'])
    for name, err in got.items():
        assert err <= max(1e-3, 4 * jax_err[name]), (name, err,
                                                     jax_err[name])
    n_over = sum(e > 1e-3 for e in got.values())
    assert n_over < 0.4 * len(got)


def test_remat_train_batch_stats_match_jax(steps):
    stats = steps['tstate']['batch_stats']
    assert set(steps['jstats']) == set(stats)
    for name, want in steps['jstats'].items():
        np.testing.assert_allclose(stats[name].numpy(), want, rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def test_remat_model_recomputes_every_block():
    model = port_model(remat=True)
    blocks = [m for m in model.modules() if hasattr(m, 'block_forward')]
    # 2 x ResNet-18 (8 basic blocks each), 3 decoder steps x 1 NBt1D
    # block in each of the semantic and the instance decoder
    assert len(blocks) == 2 * 8 + 2 * 3
    assert all(m.remat for m in blocks)
    assert not any(m.remat for m in port_model().modules()
                   if hasattr(m, 'block_forward'))

"""The EMSANet training step of the PyTorch/CUDA port against the JAX
package's, both in float64 on the CPU (the JAX package under
`jax.enable_x64` with the model's dtype float64), with the small model
and shared variables of `_torch_emsanet_train_helpers.py`. In float64
no pre-activation of this ReLU network lands on the other side of 0
between the two steps, so the step is held leaf by leaf:

- every loss within rtol 1e-6;
- each gradient within 1e-5 of its leaf's max |.| (of 1e-5 x the step's
  largest where the exact gradient is 0), the learned upsamplings' 3x3
  weights included (their 4x4 kernels built in the graph by exact
  adds), and the same set of leaves with a nonzero gradient;
- the BatchNorm statistics after the step within 1e-6;
- the updated parameters within 2e-9 where the gradient is above
  1e-3 of its leaf's max or exactly 0 (weight decay alone), the side
  heads included (the port forms Adam's bias corrections in f32, as
  optax does without x64: about 1e-9 of an update of 1e-4).

test_torch_emsanet_train_step.py holds the port's f32 step to this
float64 step."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from _torch_emsanet_train_helpers import (SIDE, jax_step, port_step,
                                          template, variables)
from _torch_train_helpers import grad as _grad

torch.set_num_threads(2)


@pytest.fixture(scope='module')
def steps():
    v = variables(template())
    jlosses, jgrads, jparams, jstats = jax_step(v, jnp.float64)
    tlosses, tstate, _ = port_step(v, 'float64')
    return dict(jlosses=jlosses, tlosses=tlosses, jgrads=jgrads,
                jparams=jparams, jstats=jstats, tstate=tstate)


def test_emsanet_train_f64_losses_match_jax(steps):
    assert set(steps['tlosses']) == set(steps['jlosses'])
    for k, want in steps['jlosses'].items():
        np.testing.assert_allclose(steps['tlosses'][k], want, rtol=1e-6,
                                   err_msg=k)


def test_emsanet_train_f64_gradients_match_jax(steps):
    params = steps['tstate']['params']
    jgrads = steps['jgrads']
    assert set(params) == set(jgrads)
    largest = max(float(np.abs(g).max()) for g in jgrads.values())
    for name, want in jgrads.items():
        got = _grad(params[name]).double().numpy()
        tol = 1e-5 * max(float(np.abs(want).max()), 1e-5 * largest)
        assert np.abs(got - want).max() <= tol, name
    got = {n for n, p in params.items() if bool((_grad(p) != 0).any())}
    assert got == {n for n, g in jgrads.items() if (g != 0).any()}
    ups = [n for n in got if '.upsample' in n and n.endswith('weight')]
    assert len(ups) == 2 * 3 + 2 + 2
    assert not any(n.startswith(SIDE) for n in got)


def test_emsanet_train_f64_state_after_matches_jax(steps):
    stats = steps['tstate']['batch_stats']
    assert set(steps['jstats']) == set(stats)
    for name, want in steps['jstats'].items():
        np.testing.assert_allclose(stats[name].double().numpy(), want,
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    params = steps['tstate']['params']
    compared = set()
    for name, want in steps['jparams'].items():
        g = steps['jgrads'][name]
        well = (np.abs(g) > 1e-3 * float(np.abs(g).max())) | (g == 0)
        got = params[name].detach().double().numpy()
        np.testing.assert_allclose(got[well], want[well], rtol=1e-9,
                                   atol=2e-9, err_msg=name)
        if well.any():
            compared.add(name)
    assert len(compared) == len(params)
    assert {n for n in params if n.startswith(SIDE)} <= compared

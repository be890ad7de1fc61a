"""The training step of the PyTorch/CUDA port (nicr_mtsa_tpu_torch,
`MultiTaskPipeline.train_step`) against the JAX package's
`MultiTaskPipeline.train_step`, on the CPU in f32:

- one step of the small `emsaformer_dve_v2`-shaped model of
  `_torch_train_helpers.py` on the random batch of `bench.py --train`,
  the JAX side through the Pallas window-attention VJP in interpret
  mode: every loss within rtol 1e-5, the gradients leaf by leaf within
  1e-3 of the leaf's max |.|. 1e-3, not 1e-4: the port's own f32
  gradients of this step differ from a float64 run of the JAX step by
  up to 3.5e-4 of a leaf's max (rounding through some 40 layers,
  amplified where the decoders' reductions cancel;
  test_torch_train_step_f64.py). A leaf whose exact gradient is 0 (a
  bias ahead of a training-mode BatchNorm, the backbone's last
  LayerNorm bias, which feeds the PPM only) carries only rounding noise
  and is held to 1e-3 of 1e-5 x the step's largest |gradient|;
  the same set of parameters with a nonzero gradient, the BatchNorm
  statistics after the step within 1e-5 and the updated parameters
  within 1e-6 where the gradient is well above 0. The stem, the first
  stage and the CPB fc1 / logit-scale leaves are left out of the
  leaf-by-leaf bounds: there the JAX f32 step through the Pallas VJP is
  off by up to the whole of a leaf's max against a float64 step, so it
  is no reference; test_torch_train_step_f64.py holds those leaves to
  the float64 JAX step (the port's float64 step within 1e-4, its f32
  step within 1e-3), test_torch_train_model.py to the flax block, and
  this file to the same nonzero set;
- `optim.AdamW` against `optax.adamw` on identical gradients over 3
  steps, with and without a bf16 first moment;
- the flax <-> torch layout map is a permutation of each leaf;
- `build_train_pipeline` at full width on a 64 x 96 input takes a
  finite step on the CPU without launching a kernel."""
import numpy as np
import jax.numpy as jnp
import optax
import pytest
import torch

from nicr_mtsa_tpu_torch.ops import cuda as kernels
from nicr_mtsa_tpu_torch.optim import AdamW
from nicr_mtsa_tpu_torch.pipeline import (build_train_pipeline,
                                          emsaformer_train_config)
from nicr_mtsa_tpu_torch.testing import build_train_batch
from nicr_mtsa_tpu_torch.utils import flax_weights as fw
from _torch_train_helpers import (grad as _grad, jax_step,
                                  left_out_of_f32_reference, noise_floor,
                                  port_step, variables)

torch.set_num_threads(2)


@pytest.fixture(scope='module')
def steps():
    v = variables()
    jlosses, jgrads, jparams, jstats = jax_step(v)
    tlosses, tstate = port_step(v)
    return dict(jlosses=jlosses, tlosses=tlosses, jgrads=jgrads,
                tstate=tstate, jparams=jparams, jstats=jstats)


def test_train_step_losses_match_jax(steps):
    assert set(steps['tlosses']) == set(steps['jlosses'])
    for k, want in steps['jlosses'].items():
        np.testing.assert_allclose(steps['tlosses'][k], want, rtol=1e-5,
                                   err_msg=k)


def test_train_step_gradients_match_jax(steps):
    params = steps['tstate']['params']
    assert set(params) == set(steps['jgrads'])
    floor = noise_floor(steps['jgrads'])
    n_compared = 0
    for name, want in steps['jgrads'].items():
        if left_out_of_f32_reference(name):
            continue
        got = _grad(params[name]).numpy()
        tol = 1e-3 * max(float(np.abs(want).max()), floor)
        assert np.abs(got - want).max() <= tol, name
        n_compared += 1
    assert n_compared > 150


def test_train_step_nonzero_gradient_sets_match_jax(steps):
    params = steps['tstate']['params']
    got = {n for n, p in params.items() if bool((_grad(p) != 0).any())}
    want = {n for n, g in steps['jgrads'].items() if (g != 0).any()}
    assert got == want
    # the embedding decoder trains its statistics, not its weights
    assert not any(n.startswith('embedding_decoder.') for n in got)


def test_train_step_state_after_matches_jax(steps):
    stats = steps['tstate']['batch_stats']
    assert set(steps['jstats']) <= set(stats)
    for name, want in steps['jstats'].items():
        np.testing.assert_allclose(stats[name].numpy(), want, rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    params = steps['tstate']['params']
    floor = noise_floor(steps['jgrads'])
    n_compared = 0
    for name, want in steps['jparams'].items():
        g = steps['jgrads'][name]
        if left_out_of_f32_reference(name):
            continue
        # Adam's first step moves p by about lr sign(g): compared where
        # |g| is well above the noise; a zero gradient leaves the decay
        # alone, compared too
        well = (np.abs(g) > 1e-3 * max(float(np.abs(g).max()), floor)) \
            | (g == 0)
        got = params[name].detach().numpy()
        np.testing.assert_allclose(got[well], want[well], rtol=1e-6,
                                   atol=1e-7, err_msg=name)
        n_compared += int(well.sum())
    assert n_compared > 1000


@pytest.mark.parametrize('mu_bf16', [False, True])
def test_adamw_matches_optax(mu_bf16):
    rng = np.random.default_rng(8)
    shapes = {'a': (7, 5), 'b': (300,), 'c': (3, 2, 4, 4), 'unused': (6,)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    opt = optax.adamw(1e-4, mu_dtype=jnp.bfloat16 if mu_bf16 else None)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = opt.init(jparams)
    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    topt = AdamW(1e-4, mu_dtype=torch.bfloat16 if mu_bf16 else None)
    tstate = topt.init(tparams)
    for step in range(3):
        grads = {k: (rng.normal(size=s) * 10.0 ** -step).astype(np.float32)
                 for k, s in shapes.items()}
        grads['unused'][:] = 0.0      # no gradient: a zero one for optax
        upd, jstate = opt.update({k: jnp.asarray(g) for k, g in
                                  grads.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        topt.step(tparams, {k: None if k == 'unused' else
                            torch.from_numpy(g) for k, g in grads.items()},
                  tstate)
        adam = jstate[0]
        for k in shapes:
            np.testing.assert_allclose(
                tstate.mu[k].float().numpy(),
                np.asarray(adam.mu[k], np.float32), rtol=1e-6, err_msg=k)
            np.testing.assert_allclose(tstate.nu[k].numpy(),
                                       np.asarray(adam.nu[k]), rtol=1e-6,
                                       err_msg=k)
            assert tstate.mu[k].dtype == (torch.bfloat16 if mu_bf16
                                          else torch.float32)
            well = np.abs(grads[k]) > 1e-3 * 10.0 ** -step
            if k == 'unused':
                well = np.ones_like(well)   # the decay alone
            np.testing.assert_allclose(tparams[k].numpy()[well],
                                       np.asarray(jparams[k])[well],
                                       rtol=1e-6, err_msg=k)
    assert int(tstate.count) == int(adam.count) == 3


@pytest.mark.parametrize('leaf,shape', [
    ('kernel', (3, 3, 16, 32)), ('kernel', (3, 3, 1, 8)),
    ('kernel', (64, 192)), ('bias', (192,)), ('scale', (32,)),
    ('relative_position_bias_table', (225, 4)),
    ('logit_scale', (4, 1, 1))])
def test_layout_map_is_a_permutation(leaf, shape):
    a = np.random.default_rng(9).permutation(
        int(np.prod(shape))).astype(np.float32).reshape(shape)
    t = fw._to_torch_layout(a, leaf)
    assert np.array_equal(np.sort(t, axis=None), np.sort(a, axis=None))
    assert np.array_equal(fw._to_flax_layout(t, leaf), a)


def test_build_train_pipeline_steps_on_cpu():
    pipe = build_train_pipeline(emsaformer_train_config((64, 96),
                                                        'float32'),
                                device='cpu')
    assert pipe.model.training
    state = pipe.create_train_state()
    kernels.reset_launch_counts()
    state, losses = pipe.train_step(
        state, build_train_batch(2, 64, 96, seed=1, device='cpu'),
        torch.Generator().manual_seed(0))
    assert int(state['step']) == 1
    assert all(bool(torch.isfinite(v)) for v in losses.values())
    assert 'total_loss' in losses
    assert all(fn.launches == 0 for fn in kernels.KERNELS.values())

"""The EMSANet training step of the PyTorch/CUDA port (nicr_mtsa_tpu_torch,
`MultiTaskPipeline.train_step` on `emsanet_train_config`, the default
model of `bench.py --train`) against the JAX package's
`MultiTaskPipeline.train_step`, on the CPU in f32, with the small model
and shared variables of `_torch_emsanet_train_helpers.py`:

- every loss within rtol 1e-5, the same loss keys (only '*_main': the
  bench's batch has no `_down_<k>` targets, so the decoders' side
  outputs get no loss);
- the gradients leaf by leaf against the port's float64 step (which
  test_torch_emsanet_train_step_f64.py holds to the JAX package's
  float64 step): within 1e-3 of the leaf's max |.| (of 1e-5 x the
  step's largest where the exact gradient is 0), or within 4x the JAX
  f32 step's own error where that is more. Two f32 steps of this ReLU
  network are not within 1e-3 of each other everywhere: each rounds a
  few of its ~2.8 M pre-activations to the other side of 0 against a
  float64 step, and such a flip moves the gradients of the leaves
  behind it by up to percents of their max (the test checks that the
  JAX f32 step itself misses the float64 one by more than 1e-3 on some
  leaves, and that the port's f32 step does so on fewer of them);
- the same set of leaves with a nonzero gradient: none of the side
  heads' (no target reaches them);
- the BatchNorm statistics after the step within 1e-5, the side heads'
  included;
- the updated parameters within 1e-6 where the float64 gradient is
  well above 0 (above 1e-3 of its leaf's max and 4x either f32 step's
  error there: Adam's first step moves p by lr sign(g)) or exactly 0
  (weight decay alone), the side heads included;
- the flax tree of the training init maps onto the port's training
  model both ways, and the port's serving model has no side heads;
- the step launches none of the port's CUDA kernel wrappers."""
import numpy as np
import pytest
import torch

from nicr_mtsa_tpu_torch.utils import flax_weights as fw
from _torch_emsanet_train_helpers import (SIDE, jax_step, port_model,
                                          port_step, template, variables)
from _torch_train_helpers import grad as _grad

torch.set_num_threads(2)


@pytest.fixture(scope='module')
def tmpl():
    return template()


@pytest.fixture(scope='module')
def steps(tmpl):
    v = variables(tmpl)
    jlosses, jgrads, jparams, jstats = jax_step(v)
    tlosses, tstate, launches = port_step(v)
    _, ref_state, _ = port_step(v, 'float64')
    ref = {n: _grad(p).double().numpy()
           for n, p in ref_state['params'].items()}
    return dict(jlosses=jlosses, tlosses=tlosses, jgrads=jgrads,
                jparams=jparams, jstats=jstats, tstate=tstate, ref=ref,
                launches=launches)


def _errors(grads, ref):
    largest = max(float(np.abs(g).max()) for g in ref.values())
    return {n: float(np.abs(grads[n] - r).max())
            / max(float(np.abs(r).max()), 1e-5 * largest)
            for n, r in ref.items()}


def test_emsanet_train_losses_match_jax(steps):
    assert set(steps['tlosses']) == set(steps['jlosses'])
    assert not any('_loss_down_' in k for k in steps['tlosses'])
    assert 'instance_orientation_loss_main' in steps['tlosses']
    for k, want in steps['jlosses'].items():
        np.testing.assert_allclose(steps['tlosses'][k], want, rtol=1e-5,
                                   err_msg=k)


def test_emsanet_train_gradients_match_reference(steps):
    params = steps['tstate']['params']
    assert set(params) == set(steps['jgrads']) == set(steps['ref'])
    got = _errors({n: _grad(p).numpy() for n, p in params.items()},
                  steps['ref'])
    jax_err = _errors(steps['jgrads'], steps['ref'])
    for name, err in got.items():
        assert err <= max(1e-3, 4 * jax_err[name]), (name, err,
                                                     jax_err[name])
    # most leaves within 1e-3 outright; the JAX f32 step is no closer
    n_over = sum(e > 1e-3 for e in got.values())
    assert n_over < 0.4 * len(got)
    assert n_over <= sum(e > 1e-3 for e in jax_err.values())
    assert max(jax_err.values()) > 1e-3
    # the learned upsamplings' 3x3 weights, through the phase-combined
    # 4x4 kernel built in the graph: the decoder steps' and the heads'
    ups = [n for n in params if '.upsample' in n and n.endswith('weight')
           and not n.startswith(SIDE)]
    assert len(ups) == 2 * 3 + 2 + 2
    assert all(float(_grad(params[n]).abs().max()) > 0 for n in ups)


def test_emsanet_train_nonzero_gradient_sets_match_jax(steps):
    params = steps['tstate']['params']
    got = {n for n, p in params.items() if bool((_grad(p) != 0).any())}
    want = {n for n, g in steps['jgrads'].items() if (g != 0).any()}
    assert got == want
    side = [n for n in params if n.startswith(SIDE)]
    assert len(side) == 3 * 2 + 3 * 9
    assert not any(n.startswith(SIDE) for n in got)


def test_emsanet_train_state_after_matches_jax(steps):
    stats = steps['tstate']['batch_stats']
    assert set(steps['jstats']) == set(stats)
    assert any(n.startswith('instance_decoder.side_head') for n in stats)
    for name, want in steps['jstats'].items():
        np.testing.assert_allclose(stats[name].numpy(), want, rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    params = steps['tstate']['params']
    compared, n_values = set(), 0
    for name, want in steps['jparams'].items():
        g, ref = steps['jgrads'][name], steps['ref'][name]
        noise = np.maximum(np.abs(g - ref),
                           np.abs(_grad(params[name]).numpy() - ref))
        well = ((np.abs(ref) > 1e-3 * float(np.abs(ref).max()))
                & (np.abs(ref) > 4 * noise)) | (g == 0)
        got = params[name].detach().numpy()
        np.testing.assert_allclose(got[well], want[well], rtol=1e-6,
                                   atol=1e-7, err_msg=name)
        if well.any():
            compared.add(name)
            n_values += int(well.sum())
    assert {n for n in params if n.startswith(SIDE)} <= compared
    assert len(compared) == len(params)
    assert n_values > 0.5 * sum(p.numel() for p in params.values())


def test_emsanet_train_step_launches_no_kernel(steps):
    assert all(n == 0 for n in steps['launches'].values())


def test_emsanet_flax_tree_maps_both_ways(tmpl):
    model = port_model()
    v = fw.torch_to_flax_variables(model, tmpl)
    for collection, decoder in (('params', 'semantic_decoder'),
                                ('params', 'instance_decoder'),
                                ('batch_stats', 'instance_decoder')):
        assert {'side_head0', 'side_head1', 'side_head2'} <= set(
            v[collection][decoder]), (collection, decoder)
    other = port_model()
    with torch.no_grad():
        for p in other.parameters():
            p.zero_()
    fw.load_flax_variables(other, v)
    want = dict(model.named_parameters())
    want.update(model.named_buffers())
    got = dict(other.named_parameters())
    got.update(other.named_buffers())
    assert set(got) == set(want)
    for n, t in want.items():
        assert torch.equal(got[n], t), n
    # serving builds no side heads (the JAX package's eval-mode tree)
    serving = port_model(train=False)
    assert not serving.training
    assert not any(n.startswith(SIDE) for n, _ in
                   serving.named_parameters())

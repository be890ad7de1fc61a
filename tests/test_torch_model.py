"""Model parity of the PyTorch port (nicr_mtsa_tpu_torch) against the
JAX package on the CPU, f32, on the same randomly initialised flax
weights (`_torch_port_helpers.shaped_variables`) carried across with
`load_flax_variables`.

Tolerance rtol/atol 1e-3, as tests/test_full_model_parity.py uses
across the two frameworks: the same f32 sums taken in another order
over ~40 layers. JAX runs under default_matmul_precision('highest')
so its CPU convs are not reduced-precision."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import _torch_port_helpers as hp
from nicr_mtsa_tpu_torch.models.upsampling import DeferredUpsampling2
from nicr_mtsa_tpu_torch.utils.flax_weights import (
    flax_to_torch_state, load_flax_variables, torch_to_flax_variables,
)

torch.set_num_threads(2)
TOL = dict(rtol=1e-3, atol=1e-3)


@pytest.fixture(scope='module')
def models():
    jm = hp.jax_model('all')
    v = hp.shaped_variables(jm)
    tm = hp.torch_model('all')
    load_flax_variables(tm, v)
    return jm, v, tm


@pytest.fixture(scope='module')
def outputs(models):
    jm, v, tm = models
    rgb, depth = hp.inputs()
    with jax.default_matmul_precision('highest'):
        out_j = jax.jit(lambda v, r, d: jm.apply(
            v, {'rgb': r, 'depth': d}, train=False))(v, rgb, depth)
    with torch.no_grad():
        out_t = tm({'rgb': hp.to_nchw(rgb), 'depth': hp.to_nchw(depth)})
    return out_j, out_t


def test_flax_weights_fill_every_tensor(models):
    jm, v, tm = models
    state = flax_to_torch_state(v)
    names = {n for n, _ in tm.named_parameters()}
    names |= {n for n, _ in tm.named_buffers()}
    assert set(state) == names
    for n, t in tm.state_dict().items():
        np.testing.assert_array_equal(t.numpy(), state[n])


def test_flax_weights_strict(models):
    jm, v, tm = models
    import copy
    broken = copy.deepcopy(v)
    del broken['params']['scene_decoder']
    with pytest.raises(KeyError):
        load_flax_variables(hp.torch_model('all'), broken)
    extra = copy.deepcopy(v)
    extra['params']['scene_decoder']['extra'] = {'kernel': np.zeros(3)}
    with pytest.raises(KeyError):
        load_flax_variables(hp.torch_model('all'), extra)
    wrong = copy.deepcopy(v)
    wrong['params']['scene_decoder']['task_head']['bias'] = np.zeros(11)
    with pytest.raises(ValueError):
        load_flax_variables(hp.torch_model('all'), wrong)


def test_semantic_deferred_fields(outputs):
    out_j, out_t = outputs
    dj, dt = out_j['semantic'][0], out_t['semantic'][0]
    assert isinstance(dt, DeferredUpsampling2)
    assert dt.x.shape == (2, hp.N_CLASSES, hp.H // 4, hp.W // 4)
    np.testing.assert_allclose(hp.to_nhwc(dt.x), np.asarray(dj.x), **TOL)
    for a, b in ((dt.kernel1, dj.kernel1), (dt.kernel2, dj.kernel2),
                 (dt.bias1, dj.bias1), (dt.bias2, dj.bias2)):
        b = np.asarray(b)
        a = a.detach().numpy()
        if b.ndim == 4:
            a = a.transpose(2, 3, 1, 0)
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('i,name', [(0, 'center'), (1, 'offset'),
                                    (2, 'orientation')])
def test_instance_head(outputs, i, name):
    out_j, out_t = outputs
    a = hp.to_nhwc(out_t['instance'][0][i])
    b = np.asarray(out_j['instance'][0][i])
    assert a.shape == b.shape == (2, hp.H, hp.W, 1 if i == 0 else 2)
    np.testing.assert_allclose(a, b, **TOL)


def test_scene_head(outputs):
    out_j, out_t = outputs
    np.testing.assert_allclose(out_t['scene'][0].numpy(),
                               np.asarray(out_j['scene'][0]), **TOL)


def test_nondeferred_semantic_logits(models, outputs):
    """defer=False: the same parameters, both prediction upsamplings
    applied as convs (the port's conv_transpose form) vs the JAX
    package's conv form of the same ladder (`apply_deferred_upsampling`,
    which its tests hold equal to the non-deferred model)."""
    from nicr_mtsa_tpu.models.upsampling import apply_deferred_upsampling
    _, v, _ = models
    out_j, _ = outputs
    with jax.default_matmul_precision('highest'):
        want = np.asarray(apply_deferred_upsampling(out_j['semantic'][0]))
    tm = hp.torch_model(False)
    load_flax_variables(tm, v)
    rgb, depth = hp.inputs()
    with torch.no_grad():
        got = tm({'rgb': hp.to_nchw(rgb), 'depth': hp.to_nchw(depth)})
    assert want.shape == (2, hp.H, hp.W, hp.N_CLASSES)
    np.testing.assert_allclose(hp.to_nhwc(got['semantic'][0]), want, **TOL)


def _shared_variables(fmod, tmod, x, seed=0, **apply_kw):
    """Flax variables of `fmod` shaped by `jax.eval_shape` (no compiled
    init), filled from `tmod`'s initial tensors (built after a
    `torch.manual_seed`), norms randomised, and loaded into `tmod`."""
    tmpl = jax.eval_shape(lambda: fmod.init(
        jax.random.PRNGKey(seed), jnp.asarray(x), **apply_kw))
    v = {k: dict(c) for k, c in torch_to_flax_variables(tmod, tmpl).items()}
    hp._randomise(v, np.random.default_rng(seed))
    load_flax_variables(tmod, v)
    return v


def _flax_module_parity(fmod, tmod, x, seed=0, **apply_kw):
    """Carry shared variables into both modules, compare (the flax
    apply jitted: one compile is cheaper than op-by-op dispatch)."""
    v = _shared_variables(fmod, tmod, x, seed, **apply_kw)
    with jax.default_matmul_precision('highest'):
        want = np.asarray(jax.jit(lambda v, a: fmod.apply(
            v, a, **apply_kw))(v, jnp.asarray(x)))
    with torch.no_grad():
        got = hp.to_nhwc(tmod(hp.to_nchw(x)))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize('block', ['basicblock', 'nonbottleneck1d'])
@pytest.mark.parametrize('stride', [1, 2])
def test_blocks(block, stride):
    from nicr_mtsa_tpu.models.blocks import make_block as jblock
    from nicr_mtsa_tpu_torch.models.blocks import make_block as tblock
    x = np.random.default_rng(3).normal(size=(2, 12, 10, 16))
    x = x.astype(np.float32)
    down = stride != 1
    fmod = jblock(block, planes=24 if down else 16, stride=stride,
                  use_downsample=down)
    torch.manual_seed(0)                   # the shared weights' init
    tmod = tblock(block, n_in=16, planes=24 if down else 16,
                  stride=stride, use_downsample=down).eval()
    _flax_module_parity(fmod, tmod, x, train=False)


def test_pyramid_pooling():
    from nicr_mtsa_tpu.models.context import PyramidPoolingModule as J
    from nicr_mtsa_tpu_torch.models.context import (
        PyramidPoolingModule as T,
    )
    # 15 x 20 is the ds-32 map of a 480 x 640 frame: bins 3 and 6 do
    # not divide it (the general adaptive-pooling windows)
    x = np.random.default_rng(4).normal(size=(2, 15, 20, 32))
    x = x.astype(np.float32)
    fmod = J(32, 24)
    torch.manual_seed(0)                   # the shared weights' init
    tmod = T(32, 24).eval()
    v = _shared_variables(fmod, tmod, x)
    with jax.default_matmul_precision('highest'):
        want, ctx_j = jax.jit(fmod.apply)(v, jnp.asarray(x))
    with torch.no_grad():
        got, ctx_t = tmod(hp.to_nchw(x))
    np.testing.assert_allclose(hp.to_nhwc(got), np.asarray(want), **TOL)
    for a, b in zip(ctx_t, ctx_j):
        np.testing.assert_allclose(hp.to_nhwc(a), np.asarray(b), **TOL)


def test_learned_zeropad_upsampling():
    from nicr_mtsa_tpu.models.upsampling import Upsampling as J
    from nicr_mtsa_tpu_torch.models.upsampling import Upsampling as T
    x = np.random.default_rng(5).normal(size=(2, 7, 9, 5))
    x = x.astype(np.float32)
    fmod = J(mode='learned-3x3-zeropad', n_channels=5)
    v = {'params': {
        'kernel': np.random.default_rng(6).normal(
            size=(3, 3, 1, 5)).astype(np.float32),
        'bias': np.random.default_rng(7).normal(size=(5,)).astype(
            np.float32)}}
    with jax.default_matmul_precision('highest'):
        want = np.asarray(fmod.apply(v, jnp.asarray(x)))
    tmod = T('learned-3x3-zeropad', 5)
    load_flax_variables(tmod, v)
    with torch.no_grad():
        got = hp.to_nhwc(tmod(hp.to_nchw(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

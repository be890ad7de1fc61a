"""Surface normals in the PyTorch port (nicr_mtsa_tpu_torch) against the
JAX package on the CPU, f32 unless stated, on the same seeded numpy
inputs and shared weights:

- `RootMeanSquaredError`: `n_elements` exact, `sum_rmse` within rtol
  1e-5; the metric is the mean of per-pixel RMSEs, not the root of the
  pooled MSE (a case where the two differ);
- `NormalDecoder`: the unit-length main output and, in training, the
  unit-length side outputs within rtol/atol 1e-3 (~10 layers);
- `NormalPostprocessing`: `normal_output_fullres` (crop + nearest
  resize) equal, from `normal_fullres` or, without it, `rgb_fullres`;
- `NormalTaskHelper` losses for 'l1' and 'mse', with and without
  multiscale supervision, within rtol 1e-5;
- the fused eval states (`evaluate_outputs`) and the eager
  `validation_step` / `validation_epoch_end` against the JAX helper's
  states and `normal_rmse`, on the same raw outputs;
- one training step of a small dense model with the normal task
  (single rgb ResNet-18 encoder, semantic + normal heads, side outputs
  paired with `_down_<k>` targets), both sides in float64: losses
  within rtol 1e-6, gradients within 1e-5 of each leaf's max |.| (the
  float64 recipe of tests/test_torch_emsanet_train_step_f64.py, tighter
  than tests/test_torch_train_step.py's f32 bounds);
- serving: `normal_output` of `PanopticInferencePipeline(
  extra_output_tasks=('normal', ...))` on the configuration of
  tests/test_pipeline.py::test_inference_pipeline_extra_output_tasks
  against the JAX pipeline's preprocessing and forward, within 1e-3,
  unit length within 1e-5."""
import flax.linen
import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

import _torch_port_helpers as hp
from nicr_mtsa_tpu_torch.utils import flax_weights as fw

torch.set_num_threads(2)
TOL = dict(rtol=1e-3, atol=1e-3)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _nhwc(t):
    return t.detach().double().numpy().transpose(0, 2, 3, 1)


def _unit(rng, shape, invalid=0.1):
    n = rng.normal(size=shape).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    n[rng.random(shape[:-1]) < invalid] = 0.0
    return n


# --- the metric --------------------------------------------------------------

def test_rmse_states_match_jax():
    from nicr_mtsa_tpu.metrics import RootMeanSquaredError as J
    from nicr_mtsa_tpu_torch.metrics import RootMeanSquaredError as T
    rng = np.random.default_rng(0)
    jm, tm = J(), T()
    js, ts = jm.empty_state(), tm.empty_state()
    for _ in range(2):
        target = _unit(rng, (2, 24, 32, 3))
        pred = _unit(rng, (2, 24, 32, 3), invalid=0.0)
        mask = np.any(target != 0, axis=-1)
        js = jm.update_state(js, jnp.asarray(pred), jnp.asarray(target),
                             jnp.asarray(mask))
        ts = tm.update_state(ts, torch.from_numpy(pred).permute(0, 3, 1, 2),
                             torch.from_numpy(target).permute(0, 3, 1, 2),
                             torch.from_numpy(mask))
    assert ts['n_elements'].dtype == torch.int32
    assert int(ts['n_elements']) == int(js['n_elements'])
    np.testing.assert_allclose(float(ts['sum_rmse']), float(js['sum_rmse']),
                               rtol=1e-5)
    np.testing.assert_allclose(tm.compute_from_state(ts),
                               jm.compute_from_state(js), rtol=1e-5)


def test_rmse_is_the_mean_of_per_pixel_rmse():
    from nicr_mtsa_tpu_torch.metrics import RootMeanSquaredError
    # two valid pixels with errors 0 and 3 in every channel, one masked
    pred = torch.zeros(1, 3, 1, 3)
    target = torch.tensor([0.0, 3.0, 7.0]).view(1, 1, 1, 3).repeat(1, 3, 1, 1)
    mask = torch.tensor([[[True, True, False]]])
    m = RootMeanSquaredError()
    s = m.update_state(m.empty_state(), pred, target, mask)
    assert int(s['n_elements']) == 2
    assert m.compute_from_state(s) == np.float32(1.5)       # (0 + 3) / 2
    pooled = np.sqrt((0.0 + 9.0) / 2)                        # 2.12
    assert abs(float(m.compute_from_state(s)) - pooled) > 0.5


# --- the decoder ------------------------------------------------------------

DEC = dict(n_channels_in=16, downsampling_in=32, n_channels=(16, 12, 8),
           downsamplings=(16, 8, 4), n_blocks=1, fusion='add-rgb',
           fusion_n_channels=(20, 12, 10), fusion_downsamplings=(16, 8, 4),
           upsampling='learned-3x3-zeropad',
           prediction_upsampling='learned-3x3-zeropad')


class _NoDropout:
    """flax `nn.Dropout(...)` as the identity."""

    def __init__(self, *args, **kwargs):
        pass

    def __call__(self, x, *args, **kwargs):
        return x


@pytest.mark.parametrize('train', [False, True])
def test_normal_decoder_matches_jax(train):
    from nicr_mtsa_tpu.models.decoders import NormalDecoder as J
    from nicr_mtsa_tpu_torch.models.common import Dropout
    from nicr_mtsa_tpu_torch.models.decoders import NormalDecoder as T
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 2, 3, 16)).astype(np.float32)
    skips = {str(ds): {m: rng.normal(size=(2, 64 // ds, 96 // ds, c)).astype(
        np.float32) for m in ('rgb', 'depth')}
        for ds, c in zip((16, 8, 4), (20, 12, 10))}
    jin = ((jnp.asarray(x), ()), {k: {m: jnp.asarray(a) for m, a in d.items()}
                                  for k, d in skips.items()})
    tin = ((hp.to_nchw(x), ()), {k: {m: hp.to_nchw(a) for m, a in d.items()}
                                 for k, d in skips.items()})
    fmod = J(**DEC)
    tmod = T(side_heads=train, generator=_gen(), **DEC).train(train)
    for m in tmod.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    tmpl = jax.eval_shape(lambda: fmod.init(
        {'params': jax.random.PRNGKey(0), 'dropout': jax.random.PRNGKey(1)},
        *jin, train=train))
    v = {k: dict(c) for k, c in fw.torch_to_flax_variables(tmod, tmpl).items()}
    hp._randomise(v, np.random.default_rng(2))
    fw.load_flax_variables(tmod, v)
    with jax.default_matmul_precision('highest'), \
            pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen, 'Dropout', _NoDropout)
        out = jax.jit(lambda v, a, b: fmod.apply(
            v, a, b, train=train, mutable=['batch_stats'] if train
            else False))(v, *jin)
    (want, want_sides) = out[0] if train else out
    with torch.no_grad():
        got, got_sides = tmod(*tin)
    assert got.shape == (2, 3, 64, 96)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        torch.linalg.vector_norm(got, dim=1).numpy(), 1.0, atol=1e-5)
    assert len(got_sides) == len(want_sides) == (3 if train else 0)
    for a, b in zip(got_sides, want_sides):
        np.testing.assert_allclose(_nhwc(a), np.asarray(b), **TOL)
        np.testing.assert_allclose(
            torch.linalg.vector_norm(a, dim=1).numpy(), 1.0, atol=1e-5)


# --- postprocessing, losses, metric states -----------------------------------

def _fullres_batches(B, h, w, H0, W0, sy, sx, with_normal_fullres, seed=3):
    """(JAX batch, port batch): the Resize provenance, full-resolution
    normals (or only rgb) and working-resolution normal targets."""
    from nicr_mtsa_tpu_torch.data.fullres import APPLIED_PREPROCESSING_KEY
    rng = np.random.default_rng(seed)
    meta = {APPLIED_PREPROCESSING_KEY: [[{
        'type': 'Resize', 'valid_region_slice_y': sy,
        'valid_region_slice_x': sx}]]}
    jb, tb = dict(meta), dict(meta)
    full = _unit(rng, (B, H0, W0, 3))
    if with_normal_fullres:
        jb['normal_fullres'] = jnp.asarray(full)
        tb['normal_fullres'] = torch.from_numpy(full).permute(0, 3, 1, 2)
    rgb = rng.integers(0, 256, (B, H0, W0, 3), dtype=np.uint8)
    jb['rgb_fullres'] = jnp.asarray(rgb)
    tb['rgb_fullres'] = torch.from_numpy(rgb).permute(0, 3, 1, 2)
    work = _unit(rng, (B, h, w, 3))
    jb['normal'] = jnp.asarray(work)
    tb['normal'] = torch.from_numpy(work).permute(0, 3, 1, 2)
    for k in (8, 16):
        d = _unit(rng, (B, h // k, w // k, 3))
        jb[f'_down_{k}'] = {'normal': jnp.asarray(d)}
        tb[f'_down_{k}'] = {'normal': torch.from_numpy(d).permute(0, 3, 1, 2)}
    return jb, tb


def _raw(B, h, w, seed=4):
    """Raw normal outputs (main and two side outputs), NHWC numpy."""
    rng = np.random.default_rng(seed)
    return (_unit(rng, (B, h, w, 3), 0.0),
            tuple(_unit(rng, (B, h // k, w // k, 3), 0.0) for k in (16, 8)))


def _raw_pair(raw):
    main, sides = raw
    return ((jnp.asarray(main), tuple(jnp.asarray(s) for s in sides)),
            (hp.to_nchw(main), tuple(hp.to_nchw(s) for s in sides)))


@pytest.mark.parametrize('with_normal_fullres', [True, False])
def test_normal_postprocessing_fullres_matches_jax(with_normal_fullres):
    from nicr_mtsa_tpu.postprocessing import NormalPostprocessing as J
    from nicr_mtsa_tpu_torch.postprocessing import NormalPostprocessing as T
    B, h, w = 2, 24, 32
    jb, tb = _fullres_batches(B, h, w, 40, 56, slice(0, 20), slice(0, w),
                              with_normal_fullres)
    jraw, traw = _raw_pair(_raw(B, h, w))
    want = J().postprocess(jraw, jb, is_training=False)
    got = T().postprocess(traw, tb, is_training=False)
    assert set(got) == set(want) == {'normal_output', 'normal_side_outputs',
                                     'normal_output_fullres'}
    assert got['normal_output_fullres'].shape == (B, 3, 40, 56)
    np.testing.assert_array_equal(_nhwc(got['normal_output_fullres']),
                                  np.asarray(want['normal_output_fullres']))
    train = T().postprocess(traw, tb, is_training=True)
    assert set(train) == {'normal_output', 'normal_side_outputs'}


@pytest.mark.parametrize('multiscale', [True, False])
@pytest.mark.parametrize('loss_name', ['l1', 'mse'])
def test_normal_losses_match_jax(loss_name, multiscale):
    from nicr_mtsa_tpu.tasks import NormalTaskHelper as J
    from nicr_mtsa_tpu_torch.tasks import NormalTaskHelper as T
    B, h, w = 2, 32, 48
    jb, tb = _fullres_batches(B, h, w, 32, 48, slice(0, h), slice(0, w),
                              True)
    jraw, traw = _raw_pair(_raw(B, h, w))
    kw = dict(loss_name=loss_name,
              disable_multiscale_supervision=not multiscale)
    want = J(**kw).compute_losses(
        jb, {'normal_output': jraw[0], 'normal_side_outputs': jraw[1]})
    got = T(**kw).compute_losses(
        tb, {'normal_output': traw[0], 'normal_side_outputs': traw[1]})
    assert set(got) == set(want)
    assert ('normal_loss_down_8' in got) == multiscale
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-5,
                                   err_msg=k)


def test_normal_helper_refuses_examples_and_unknown_losses():
    """Example images are ported (tests/test_torch_eval_outputs.py holds
    them against the JAX helper's): `store_examples` is taken; an
    unknown loss still raises."""
    from nicr_mtsa_tpu_torch.tasks import NormalTaskHelper
    helper = NormalTaskHelper(store_examples=True)
    assert helper._store_examples and helper._examples == {}
    with pytest.raises(ValueError):
        NormalTaskHelper(loss_name='huber')


def test_fused_and_eager_normal_states_match_jax():
    """Two batches through the port's fused seam (`evaluate_outputs`)
    and its eager `validation_step`, and through the JAX postprocessing
    and helper: the states after each, and `normal_rmse` at epoch end."""
    from nicr_mtsa_tpu.postprocessing import NormalPostprocessing as JP
    from nicr_mtsa_tpu.tasks import NormalTaskHelper as JH
    from nicr_mtsa_tpu_torch.models.multi_task import (
        MultiTaskModelConfig, build_model,
    )
    from nicr_mtsa_tpu_torch.pipeline import MultiTaskPipeline
    from nicr_mtsa_tpu_torch.postprocessing import NormalPostprocessing
    from nicr_mtsa_tpu_torch.tasks import NormalTaskHelper
    B, h, w = 2, 24, 32
    model = build_model(MultiTaskModelConfig(**TRAIN_MODEL), device='cpu')
    pipe = MultiTaskPipeline(model, {
        'normal': NormalPostprocessing()}, {'normal': NormalTaskHelper()})
    jh = JH()
    fused, js = pipe.empty_metric_states(), jh.empty_metric_states()
    for seed in (5, 6):
        jb, tb = _fullres_batches(B, h, w, 40, 56, slice(0, 20),
                                  slice(0, w), True, seed=seed)
        jraw, traw = _raw_pair(_raw(B, h, w, seed=seed + 10))
        _, losses, fused = pipe.evaluate_outputs({'normal': traw}, tb,
                                                 fused)
        pipe.validate_outputs({'normal': traw}, tb)
        jpost = JP().postprocess(jraw, jb, is_training=False)
        js = jh.update_metric_states(js, jb, jpost)
        jlosses, _ = jh.validation_step(jb, 0, jpost)
        for k, v in jlosses.items():
            np.testing.assert_allclose(float(losses[k]), float(v), rtol=1e-5)
        for states in (fused['normal'], pipe.task_helpers['normal']
                       ._eager_states):
            assert int(states['n_elements']) == int(js['n_elements'])
            np.testing.assert_allclose(float(states['sum_rmse']),
                                       float(js['sum_rmse']), rtol=1e-5)
    eager = pipe.task_helpers['normal']._eager_states
    assert torch.equal(eager['sum_rmse'], fused['normal']['sum_rmse'])
    assert torch.equal(eager['n_elements'], fused['normal']['n_elements'])
    _, _, logs = pipe.validation_epoch_end()
    _, _, jlogs = jh.validation_epoch_end()
    np.testing.assert_allclose(logs['normal_rmse'], jlogs['normal_rmse'],
                               rtol=1e-5)
    assert 'normal_epoch_end_time' in logs
    pipe.load_metric_states(fused)
    _, _, logs = pipe.validation_epoch_end()
    np.testing.assert_allclose(logs['normal_rmse'], jlogs['normal_rmse'],
                               rtol=1e-5)


def test_default_postprocessors_and_helpers_take_normals():
    from nicr_mtsa_tpu_torch.pipeline import (default_postprocessors,
                                              eval_task_helpers,
                                              train_task_helpers)
    from nicr_mtsa_tpu_torch.postprocessing import NormalPostprocessing
    from nicr_mtsa_tpu_torch.tasks import NormalTaskHelper
    post = default_postprocessors(('semantic', 'normal'), (False,) * 4)
    assert isinstance(post['normal'], NormalPostprocessing)
    assert isinstance(eval_task_helpers(normal=True)['normal'],
                      NormalTaskHelper)
    assert 'normal' not in eval_task_helpers()
    assert isinstance(train_task_helpers(normal=True)['normal'],
                      NormalTaskHelper)


def test_synthetic_normal_targets_leave_other_batches_unchanged():
    from nicr_mtsa_tpu_torch.testing import (build_eval_batch,
                                             train_arrays)
    from nicr_mtsa_tpu_torch.testing.batch import NORMAL_INVALID_SHARE
    plain = train_arrays(2, 32, 48, seed=1)
    with_n = train_arrays(2, 32, 48, seed=1, normals=True, downscales=(8,))
    for k, v in plain.items():
        np.testing.assert_array_equal(with_n[k], v)
    n = with_n['normal']
    valid = np.any(n != 0, axis=-1)
    np.testing.assert_allclose(np.linalg.norm(n[valid], axis=-1), 1.0,
                               rtol=1e-6)
    assert abs((1 - valid.mean()) - NORMAL_INVALID_SHARE) < 0.03
    np.testing.assert_array_equal(with_n['_down_8']['normal'],
                                  n[:, ::8, ::8])
    is_thing = tuple(i < 8 for i in range(40))
    a = build_eval_batch(2, (32, 48), (40, 60), 40, is_thing, seed=2,
                         device='cpu')
    b = build_eval_batch(2, (32, 48), (40, 60), 40, is_thing, seed=2,
                         device='cpu', normals=True)
    for k, v in a.batch.items():
        assert torch.equal(b.batch[k], v), k
    assert b.batch['normal_fullres'].shape == (2, 3, 40, 60)
    assert b.batch['normal'].shape == (2, 3, 32, 48)


# --- the training step, float64 ----------------------------------------------

TH, TW, TB = 64, 96, 4
TRAIN_TASKS = ('semantic', 'normal')
TRAIN_MODEL = dict(tasks=TRAIN_TASKS, backbone_rgb='resnet18',
                   backbone_depth=None, resnet_block='basicblock',
                   context_n_channels=32, decoder_n_channels=(32, 24, 16),
                   decoder_n_blocks=1, input_size=(TH, TW),
                   semantic_n_classes=12,
                   upsampling='learned-3x3-zeropad',
                   prediction_upsampling='learned-3x3-zeropad',
                   defer_semantic_prediction_upsampling=False)
DOWNSCALES = (8, 16, 32)


def _train_batch_arrays():
    from nicr_mtsa_tpu_torch.testing import train_arrays
    return train_arrays(TB, TH, TW, seed=0, n_classes=12, rgbd=False,
                        normals=True, downscales=DOWNSCALES)


@pytest.fixture(scope='module')
def train_steps():
    from nicr_mtsa_tpu.models.multi_task import (
        MultiTaskModelConfig as JC, build_model as jbuild,
    )
    from nicr_mtsa_tpu.pipeline import (MultiTaskPipeline as JPipe,
                                        default_postprocessors as jpost)
    from nicr_mtsa_tpu.tasks import NormalTaskHelper as JN
    from nicr_mtsa_tpu.tasks import SemanticTaskHelper as JS
    from nicr_mtsa_tpu_torch.models.common import Dropout
    from nicr_mtsa_tpu_torch.models.multi_task import (
        MultiTaskModelConfig as TC, build_model as tbuild,
    )
    from nicr_mtsa_tpu_torch.optim import AdamW
    from nicr_mtsa_tpu_torch.pipeline import (MultiTaskPipeline,
                                              default_postprocessors)
    from nicr_mtsa_tpu_torch.tasks import NormalTaskHelper, SemanticTaskHelper
    from nicr_mtsa_tpu_torch.testing import build_train_batch
    from _torch_train_helpers import np_tree, randomise_norms

    is_thing = (False,) * 12
    model = tbuild(TC(**TRAIN_MODEL), device='cpu', train=True)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    arrays = _train_batch_arrays()
    with jax.enable_x64(True):
        jm = jbuild(JC(dtype=jnp.float64, **TRAIN_MODEL))
        capture = optax.GradientTransformation(
            lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
            lambda u, s, p=None: (u, u))
        jp = JPipe(jm, jpost(TRAIN_TASKS, is_thing),
                   {'semantic': JS(n_classes=12), 'normal': JN()},
                   optimizer=optax.chain(capture, optax.adamw(1e-4)))

        def jbatch():
            return jax.tree_util.tree_map(
                lambda a: jnp.asarray(a, jnp.float64)
                if a.dtype == np.float32 else jnp.asarray(a), arrays)
        tmpl = jax.eval_shape(lambda: jm.init(
            {'params': jax.random.PRNGKey(0),
             'dropout': jax.random.PRNGKey(1)},
            jp.model_inputs(jbatch()), train=True))
        v = fw.torch_to_flax_variables(model, tmpl)
        randomise_norms(v, np.random.default_rng(3))
        cast = lambda t: jax.tree_util.tree_map(   # noqa: E731
            lambda a: jnp.asarray(a, jnp.float64), t)
        params = cast(v['params'])
        state = {'params': params, 'batch_stats': cast(v['batch_stats']),
                 'opt_state': jp.optimizer.init(params),
                 'step': jnp.zeros((), jnp.int32)}
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(flax.linen, 'Dropout', _NoDropout)
            with jax.default_matmul_precision('highest'):
                new_state, jlosses = jp.train_step(
                    state, jbatch(), rng=jax.random.PRNGKey(1))
        jlosses = {k: float(x) for k, x in jlosses.items()}
        jgrads = fw.flax_tree_to_torch(np_tree(new_state['opt_state'][0],
                                               np.float64))
    fw.load_flax_variables(model, v)
    model.double()
    pipe = MultiTaskPipeline(
        model, default_postprocessors(TRAIN_TASKS, is_thing),
        {'semantic': SemanticTaskHelper(n_classes=12),
         'normal': NormalTaskHelper()},
        compute_dtype=torch.float64, optimizer=AdamW(1e-4))
    tstate = pipe.create_train_state()
    batch = build_train_batch(TB, TH, TW, seed=0, device='cpu',
                              n_classes=12, rgbd=False, normals=True,
                              downscales=DOWNSCALES)
    tstate, tlosses = pipe.train_step(tstate, batch, torch.Generator())
    return dict(jlosses=jlosses, jgrads=jgrads, tstate=tstate,
                tlosses={k: float(x) for k, x in tlosses.items()})


def test_normal_train_step_losses_match_jax(train_steps):
    got, want = train_steps['tlosses'], train_steps['jlosses']
    assert set(got) == set(want)
    for k in ('normal_loss_main', 'normal_total_loss',
              *(f'normal_loss_down_{k}' for k in DOWNSCALES)):
        assert k in got
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-6, err_msg=k)


def test_normal_train_step_gradients_match_jax(train_steps):
    from _torch_train_helpers import grad as _grad
    params = train_steps['tstate']['params']
    jgrads = train_steps['jgrads']
    assert set(params) == set(jgrads)
    assert any(n.startswith('normal_decoder.side_head') for n in params)
    largest = max(float(np.abs(g).max()) for g in jgrads.values())
    for name, want in jgrads.items():
        got = _grad(params[name]).double().numpy()
        tol = 1e-5 * max(float(np.abs(want).max()), 1e-5 * largest)
        assert np.abs(got - want).max() <= tol, name
    # the side heads of the normal decoder get their gradient from the
    # `_down_<k>` targets
    side = [n for n in params if n.startswith('normal_decoder.side_head')]
    assert all(float(_grad(params[n]).abs().max()) > 0 for n in side)


# --- serving ---------------------------------------------------------------

SERVE = dict(tasks=('semantic', 'instance', 'normal',
                    'dense_visual_embedding'),
             backbone_rgb='resnet18', backbone_depth='resnet18',
             resnet_block='basicblock', context_n_channels=64,
             decoder_n_channels=(32, 24, 16), decoder_n_blocks=1,
             input_size=(64, 96), semantic_n_classes=12, embedding_dim=32)


def test_serving_normal_output_matches_jax():
    from nicr_mtsa_tpu.models.multi_task import (
        MultiTaskModelConfig as JC, build_model as jbuild,
    )
    from nicr_mtsa_tpu.pipeline import PanopticInferencePipeline as JPipe
    from nicr_mtsa_tpu_torch.models.multi_task import (
        MultiTaskModelConfig as TC,
    )
    from nicr_mtsa_tpu_torch.pipeline import build_serving_pipeline
    jm = jbuild(JC(**SERVE))
    jpipe = JPipe(jm, None, compute_dtype=jnp.float32,
                  extra_output_tasks=('normal', 'dense_visual_embedding'))
    tpipe = build_serving_pipeline(
        TC(**SERVE), device='cpu', n_thing=4,
        extra_output_tasks=('normal', 'dense_visual_embedding'))
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 255, (2, 64, 96, 3), dtype=np.uint8)
    depth = rng.integers(0, 2 ** 14, (2, 64, 96), dtype=np.uint16)
    tmpl = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jpipe.preprocess(rgb, depth), train=False))
    v = {k: dict(c) for k, c in
         fw.torch_to_flax_variables(tpipe.model, tmpl).items()}
    hp._randomise(v, np.random.default_rng(1))
    fw.load_flax_variables(tpipe.model, v)
    with jax.default_matmul_precision('highest'):
        want = jax.jit(lambda v, r, d: jm.apply(
            v, jpipe.preprocess(r, d), train=False))(v, rgb, depth)
    got = tpipe(rgb, depth)
    assert got['normal_output'].shape == (2, 3, 64, 96)
    np.testing.assert_allclose(_nhwc(got['normal_output']),
                               np.asarray(want['normal'][0]), **TOL)
    np.testing.assert_allclose(
        torch.linalg.vector_norm(got['normal_output'], dim=1).numpy(), 1.0,
        atol=1e-5)
    assert got['dense_visual_embedding_output'].shape == (2, 32, 64, 96)
    np.testing.assert_allclose(
        _nhwc(got['dense_visual_embedding_output']),
        np.asarray(want['dense_visual_embedding'][0]), **TOL)

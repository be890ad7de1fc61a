"""The training loop of examples/train_synthetic.py in the PyTorch/CUDA
port against the JAX package, on the CPU in f32, with the example's
model (2x ResNet-18 basic blocks, context 128, decoders (64, 48, 32)
with one block, bilinear upsampling, 10 classes of which 3 things, 5
scenes, top-k 32) at 64 x 96 and two batches (B=2) of the synthetic
dataset through the example's training preprocessing (each sample's
augmentation from `RandomState(i)` in the port and `np.random.seed(i)`
in the JAX package; the host batches bit-equal).

One JAX train state steps both packages: the flax tree of a training
init (shaped by `jax.eval_shape`, filled from the port's seeded model,
norms randomised), AdamW moments carried from earlier steps (random mu,
nu, count 10), carried into the port through
`flax_weights.flax_train_state_to_torch`, and a DWA weighting whose two
recorded epoch means give weights other than 1.

- The weighted step: the DWA weights it uses equal the JAX step's; the
  losses within rtol 1e-5, the updated parameters and BatchNorm
  statistics within 1e-5 (with moments carried, Adam's update is
  smooth in the gradient, so f32 gradient noise moves it by far less);
  the DWA state after the step within rtol 1e-5.
- The eager validation: the JAX package's `validation_step` over both
  batches and `validation_epoch_end` against the port's
  `validate_outputs` on the JAX step's raw outputs (the forward passes
  of the two packages differ in their last bits, which moves near-tie
  argmaxes): the same log keys in every step and at the epoch end, the
  metric states equal (integers exactly, float sums within rtol 1e-5),
  the orientation MAE against the GT instances included; the epoch
  metrics within rtol 1e-5.
- The port's own `validation_step` over the two batches gives states
  equal to its fused step's on the same batches, and its raw outputs
  from the JAX step's updated state (carried through `flax_weights`)
  equal the JAX outputs within 1e-4 of their scale.
- A checkpoint round trip on the CPU: the next training step of a
  pipeline loaded from a checkpoint is bit-equal to that of the
  pipeline that saved it; the DWA state and the epoch come back from
  `extra`; a leaf of another shape or dtype raises."""
import copy

import flax.linen
import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from nicr_mtsa_tpu.data import mt_collate as j_collate
from nicr_mtsa_tpu.data import preprocessing as jpre
from nicr_mtsa_tpu.models.multi_task import (MultiTaskModelConfig as JConfig,
                                             build_model as jax_build)
from nicr_mtsa_tpu.pipeline import (MultiTaskPipeline as JPipeline,
                                    default_postprocessors as j_post,
                                    strip_non_arrays as j_strip)
from nicr_mtsa_tpu.tasks import (InstanceTaskHelper as JInstance,
                                 PanopticTaskHelper as JPanoptic,
                                 SceneTaskHelper as JScene,
                                 SemanticTaskHelper as JSemantic)
from nicr_mtsa_tpu.testing.dataset import SyntheticRGBDDataset as JDataset
from nicr_mtsa_tpu.weighting import DynamicWeightAverage as JDWA
from nicr_mtsa_tpu_torch.data import (move_batch_to_device, mt_collate)
from nicr_mtsa_tpu_torch.data import preprocessing as pre
from nicr_mtsa_tpu_torch.examples.train_synthetic import (
    make_pipeline, train_preprocessing)
from nicr_mtsa_tpu_torch.models.common import Dropout
from nicr_mtsa_tpu_torch.models.multi_task import (MultiTaskModelConfig,
                                                   build_model)
from nicr_mtsa_tpu_torch.parallel import (load_checkpoint, load_train_state,
                                          save_checkpoint)
from nicr_mtsa_tpu_torch.pipeline import strip_non_arrays
from nicr_mtsa_tpu_torch.testing import SyntheticRGBDDataset
from nicr_mtsa_tpu_torch.utils import flax_weights as fw
from _torch_emsanet_train_helpers import _NoDropout
from _torch_data_helpers import jax_native_loaded  # noqa: F401
from _torch_loop_helpers import H, IS_THING, W, _same, train_compose
from _torch_train_helpers import randomise_norms

torch.set_num_threads(2)
B = 2
DWA_KEYS = ('semantic_total_loss', 'instance_center_total_loss',
            'instance_offset_total_loss', 'instance_orientation_total_loss',
            'scene_total_loss')
# two recorded epoch means (the second after the first) and a partial
# epoch: the DWA weights of the next epoch are not 1
DWA_STATE = {
    'loss_history': [dict(zip(DWA_KEYS, (2.5, 0.02, 0.9, 0.8, 1.7))),
                     dict(zip(DWA_KEYS, (2.1, 0.03, 0.7, 0.8, 1.2)))],
    'loss_buffer': [dict(zip(DWA_KEYS, (2.0, 0.02, 0.6, 0.7, 1.1)))],
    'weights': {}}
CONFIG = dict(
    tasks=('semantic', 'instance', 'orientation', 'scene'),
    backbone_rgb='resnet18', backbone_depth='resnet18',
    resnet_block='basicblock', context_n_channels=128,
    decoder_n_channels=(64, 48, 32), decoder_n_blocks=1,
    upsampling='bilinear', prediction_upsampling='bilinear',
    input_size=(H, W), semantic_n_classes=10, scene_n_classes=5)
RAW_KEYS = ('semantic_output', 'instance_output', 'scene_output')


def jax_host_batches():
    ds = JDataset(n_samples=2 * B, height=2 * H, width=2 * W)
    compose, out = train_compose(jpre), []
    for b in range(2):
        samples = []
        for i in range(b * B, (b + 1) * B):
            np.random.seed(i)
            samples.append(compose(ds[i]))
        out.append(j_collate(samples))
    return out


def port_host_batches():
    ds = SyntheticRGBDDataset(n_samples=2 * B, height=2 * H, width=2 * W,
                              preprocessor=train_preprocessing(H, W))
    return [mt_collate([ds.load(i, np.random.RandomState(i))
                        for i in range(b * B, (b + 1) * B)])
            for b in range(2)]


def jax_pipeline(dtype=jnp.float32):
    return JPipeline(
        jax_build(JConfig(**CONFIG, dtype=dtype)),
        j_post(tasks=CONFIG['tasks'] + ('panoptic',),
               semantic_classes_is_thing=IS_THING[1:], top_k_instances=32),
        {'semantic': JSemantic(n_classes=10),
         'instance': JInstance(semantic_n_classes=11,
                               semantic_classes_is_thing=IS_THING,
                               top_k_instances=32),
         'panoptic': JPanoptic(semantic_n_classes=11,
                               semantic_classes_is_thing=IS_THING),
         'scene': JScene(n_classes=5)},
        loss_weighting=JDWA(DWA_KEYS), optimizer=optax.adamw(3e-4))


def port_pipeline():
    model = build_model(MultiTaskModelConfig(**CONFIG), device='cpu',
                        train=True)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    return make_pipeline(model, MultiTaskModelConfig(**CONFIG))


def dwa_state():
    s = copy.deepcopy(DWA_STATE)
    w = JDWA(DWA_KEYS)
    w.load_state_dict(dict(s, weights={k: 1.0 for k in DWA_KEYS}))
    w._close_epoch()                   # the weights of the history
    s['weights'] = dict(w.weights)
    return s


def jax_train_state(jp, tmpl):
    """The flax variables filled from the port's model, with Adam
    moments of earlier steps."""
    v = fw.torch_to_flax_variables(port_pipeline().model, tmpl)
    randomise_norms(v, np.random.default_rng(3))
    params = v['params']
    opt = jp.optimizer.init(params)
    rng = np.random.default_rng(5)
    adam = opt[0]._replace(
        count=jnp.asarray(10, jnp.int32),
        mu=jax.tree_util.tree_map(
            lambda a: rng.normal(0, 1e-3, a.shape).astype(np.float32),
            params),
        nu=jax.tree_util.tree_map(
            lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32),
            params))
    return {'params': params, 'batch_stats': v['batch_stats'],
            'opt_state': (adam,) + tuple(opt[1:]),
            'step': jnp.asarray(10, jnp.int32)}


def np_state(state):
    return jax.tree_util.tree_map(np.asarray, state)


def _f64(tree):
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float64)
        if np.asarray(a).dtype == np.float32 else a, tree)


@pytest.fixture(scope='module')
def run():
    jhost = jax_host_batches()
    thost = port_host_batches()
    jp = jax_pipeline()
    x = {'rgb': jnp.zeros((1, H, W, 3)), 'depth': jnp.zeros((1, H, W, 1))}
    tmpl = jax.eval_shape(lambda: jp.model.init(
        {'params': jax.random.PRNGKey(0), 'dropout': jax.random.PRNGKey(1)},
        x, train=True))
    start = np_state(jax_train_state(jp, tmpl))
    # the weighted step in float64 (the f32 steps of this random-init
    # model move by up to ~6e-4 with their summation order)
    with jax.enable_x64(True):
        jp64 = jax_pipeline(jnp.float64)
        jp64.loss_weighting.load_state_dict(dwa_state())
        jweights = dict(jp64.loss_weighting.weights)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(flax.linen, 'Dropout', _NoDropout)
            with jax.default_matmul_precision('highest'):
                jnew64, jlosses = jp64.train_step(
                    _f64(start), _f64(j_strip(jhost[0])), batch_idx=1,
                    rng=jax.random.PRNGKey(1))
        jnew64 = np_state(jnew64)
        jlosses = {k: float(v) for k, v in jlosses.items()}
    jnew = jax.tree_util.tree_map(
        lambda a: a.astype(np.float32) if a.dtype == np.float64 else a,
        jnew64)
    jval = []
    # `validation_step` with its forward and postprocessing jitted (the
    # same computation, one compile instead of eager dispatch)
    static = {jpre.APPLIED_PREPROCESSING_KEY:
              jhost[0][jpre.APPLIED_PREPROCESSING_KEY]}
    forward = jax.jit(lambda p, bs, arrays: jp._val_forward_impl(
        p, bs, dict(arrays, **static)))
    with jax.default_matmul_precision('highest'):
        for i, hb in enumerate(jhost):
            pp = forward(jnew['params'], jnew['batch_stats'], j_strip(hb))
            losses, logs = {}, {}
            for helper in jp.task_helpers.values():
                step_losses, step_logs = helper.validation_step(hb, i, pp)
                losses.update(step_losses)
                logs.update(step_logs)
            jval.append(({k: np.asarray(pp[k]) if k != 'instance_output'
                          else tuple(np.asarray(a) for a in pp[k])
                          for k in RAW_KEYS},
                         set(losses), set(logs)))
        jstates = {
            'semantic': np.asarray(jp.task_helpers['semantic']
                                   ._metric_iou.state),
            'scene': np.asarray(jp.task_helpers['scene']._cm_state),
            'instance': {'pq': jax.device_get(
                jp.task_helpers['instance']._mae_pq_deeplab.state)},
            'panoptic': {
                'pq': jax.device_get(
                    jp.task_helpers['panoptic']._mae_pq_deeplab.state),
                'miou': np.asarray(
                    jp.task_helpers['panoptic']._metric_iou.state)},
            'mae_gt': jax.device_get(
                jp.task_helpers['instance']._mae_gt.state)}
        _, _, jlogs = jp.validation_epoch_end()
    return dict(jhost=jhost, thost=thost, start=start, jweights=jweights,
                jnew64=jnew64, jnew=jnew, jdwa=jp64.loss_weighting,
                jlosses=jlosses, jval=jval, jstates=jstates, jlogs=jlogs)


def _port_batch(host):
    return move_batch_to_device(host, device='cpu')


def test_train_chain_batches_equal_jax(run):
    for jb, tb in zip(run['jhost'], run['thost']):
        _same(tb, jb)


def _loaded_pipeline(run, state):
    tp = port_pipeline()
    ts = tp.create_train_state()
    load_train_state(ts, fw.flax_train_state_to_torch(state))
    return tp, ts


def port_weighted_step_f64(run):
    """The port's weighted step from the JAX start state in float64 (the
    model, the state and the batch's floats)."""
    def f64(t):
        if isinstance(t, dict):
            return {k: f64(v) for k, v in t.items()}
        return t.double() if t.is_floating_point() else t

    tp = port_pipeline()
    tp.model.double()
    tp._compute_dtype = torch.float64
    ts = load_train_state(tp.create_train_state(),
                          f64(fw.flax_train_state_to_torch(run['start'])))
    tp.loss_weighting.load_state_dict(dwa_state())
    weights = dict(tp.loss_weighting.weights)
    batch = f64(strip_non_arrays(_port_batch(run['thost'][0])))
    ts, losses = tp.train_step(ts, batch, torch.Generator(), batch_idx=1)
    return tp, ts, losses, weights


def test_weighted_train_step_matches_jax(run):
    """In float64 on both sides (the JAX package under x64), as
    test_torch_emsanet_train_step_f64.py holds the unweighted step:
    the DWA weights the step uses equal the JAX step's (not 1), every
    loss within rtol 1e-6, the BatchNorm statistics within 1e-6, the
    updated parameters within 2e-9 (with Adam's moments carried the
    update is smooth in the gradient, so every element is held), the
    step and Adam counts, and the DWA state after the step (the step's
    losses recorded at its index)."""
    tp, ts, losses, weights = port_weighted_step_f64(run)
    assert weights == run['jweights']
    assert any(abs(w - 1.0) > 1e-3 for w in weights.values())
    assert set(losses) == set(run['jlosses'])
    assert any('_loss_down_' in k for k in losses)
    for k, want in run['jlosses'].items():
        np.testing.assert_allclose(float(losses[k]), want, rtol=1e-6,
                                   err_msg=k)
    want = fw.flax_train_state_to_torch(run['jnew64'])
    for group, tol in (('params', 2e-9), ('batch_stats', 1e-6)):
        assert set(ts[group]) == set(want[group])
        for name, w in want[group].items():
            np.testing.assert_allclose(ts[group][name].detach().numpy(),
                                       w.numpy(), rtol=tol, atol=tol,
                                       err_msg=name)
    assert int(ts['step']) == int(want['step']) == 11
    assert int(ts['opt_state'].count) == int(want['opt_state']['count'])
    got, jdwa = tp.loss_weighting.state_dict(), run['jdwa'].state_dict()
    assert got['weights'] == jdwa['weights'] == weights
    assert got['loss_history'] == jdwa['loss_history']
    assert len(got['loss_buffer']) == len(jdwa['loss_buffer']) == 2
    assert got['loss_buffer'][0] == jdwa['loss_buffer'][0]
    for k in DWA_KEYS:
        np.testing.assert_allclose(got['loss_buffer'][1][k],
                                   jdwa['loss_buffer'][1][k], rtol=1e-6,
                                   err_msg=k)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a).transpose(0, 3, 1, 2)))


def _raw(jraw):
    return {'semantic': (_nchw(jraw['semantic_output']), ()),
            'instance': (tuple(_nchw(a) for a in jraw['instance_output']),
                         ()),
            'scene': (torch.from_numpy(np.array(jraw['scene_output'])), ())}


def _assert_states(got, want, where=''):
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _assert_states(got[k], want[k], f'{where}/{k}')
        return
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    if want.dtype.kind == 'f':
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                   err_msg=where)
    else:
        np.testing.assert_array_equal(got, want, err_msg=where)


def _port_states(tp):
    h = tp.task_helpers
    return {'semantic': h['semantic']._eager_states,
            'scene': h['scene']._eager_states,
            'instance': h['instance']._eager_states,
            'panoptic': h['panoptic']._eager_states,
            'mae_gt': h['instance']._mae_gt.state}


def test_eager_validation_matches_jax(run):
    tp = port_pipeline()
    for i, (host, (jraw, jloss_keys, jlog_keys)) in enumerate(
            zip(run['thost'], run['jval'])):
        _, losses, logs = tp.validate_outputs(_raw(jraw), _port_batch(host),
                                              batch_idx=i)
        assert set(losses) == jloss_keys
        assert set(logs) == jlog_keys
    _assert_states(_port_states(tp), run['jstates'])
    assert int(run['jstates']['mae_gt']['n_elements']) > 0
    _, _, logs = tp.validation_epoch_end()
    assert set(logs) == set(run['jlogs'])
    assert {'orientation_mae_gt_rad', 'orientation_mae_gt_deg',
            'semantic_epoch_end_time'} <= set(logs)
    for k, want in run['jlogs'].items():
        if k.endswith('_time'):
            continue
        np.testing.assert_allclose(float(logs[k]), float(want), rtol=1e-5,
                                   err_msg=k)


def test_port_validation_equals_fused_step_and_jax_forward(run):
    tp, _ = _loaded_pipeline(run, run['jnew'])
    batches = [_port_batch(h) for h in run['thost']]
    for i, b in enumerate(batches):
        preds, _, _ = tp.validation_step(b, batch_idx=i)
        jraw = run['jval'][i][0]
        pairs = {'semantic': (preds['semantic_output'],
                              jraw['semantic_output']),
                 'scene': (preds['scene_output'], jraw['scene_output'])}
        pairs.update(zip(('centre', 'offset', 'orientation'),
                         zip(preds['instance_output'],
                             jraw['instance_output'])))
        for name, (got, want) in pairs.items():
            want = np.asarray(want)
            got = got.numpy()
            if got.ndim == 4:
                got = got.transpose(0, 2, 3, 1)
            # the offsets (tanh of large pre-activations at random init)
            # and the orientation's unit vectors (normalising amplifies
            # the raw output's rounding by 1 / its length)
            scale = 10.0 if name in ('offset', 'orientation') else 1.0
            np.testing.assert_allclose(
                got, want, rtol=0, err_msg=name,
                atol=1e-4 * scale * float(np.abs(want).max()))
    eager = _port_states(tp)
    static = {pre.APPLIED_PREPROCESSING_KEY:
              run['thost'][0][pre.APPLIED_PREPROCESSING_KEY]}
    step = tp.make_fused_eval_step(static)
    states = tp.empty_metric_states()
    for b in batches:
        _, _, states = step(strip_non_arrays(b), states)
    for name in ('semantic', 'scene', 'instance', 'panoptic'):
        _assert_states(eager[name], states[name], name)
    tp.validation_epoch_end()
    assert tp.task_helpers['semantic']._eager_states is None


def test_checkpoint_round_trip_resumes_bit_equal(run, tmp_path):
    batch = strip_non_arrays(_port_batch(run['thost'][0]))
    tp, ts = _loaded_pipeline(run, run['start'])
    tp.loss_weighting.load_state_dict(dwa_state())
    ts, _ = tp.train_step(ts, batch, torch.Generator().manual_seed(0),
                          batch_idx=1)
    path = save_checkpoint(str(tmp_path / 'ckpt_epoch0'), ts,
                           extra={'epoch': 0,
                                  'dwa': tp.loss_weighting.state_dict()})
    assert path.endswith('.pt')
    other = port_pipeline()
    os_ = other.create_train_state()
    os_, extra = load_checkpoint(path, os_)
    assert extra['epoch'] == 0
    other.loss_weighting.load_state_dict(extra['dwa'])
    assert other.loss_weighting.state_dict() == \
        tp.loss_weighting.state_dict()
    ts, la = tp.train_step(ts, batch, torch.Generator().manual_seed(1),
                           batch_idx=2)
    os_, lb = other.train_step(os_, batch, torch.Generator().manual_seed(1),
                               batch_idx=2)
    for k in la:
        assert torch.equal(la[k], lb[k]), k
    for group in ('params', 'batch_stats'):
        for n, t in ts[group].items():
            assert torch.equal(t, os_[group][n]), n
    for n, t in ts['opt_state'].mu.items():
        assert torch.equal(t, os_['opt_state'].mu[n]), n
        assert torch.equal(ts['opt_state'].nu[n], os_['opt_state'].nu[n])
    assert int(ts["step"]) == int(os_["step"]) == 12
    assert other.loss_weighting.state_dict() == \
        tp.loss_weighting.state_dict()
    # a leaf of another shape or dtype is refused
    state, _ = load_checkpoint(path)
    name = next(iter(state['params']))
    bad = copy.deepcopy(state)
    bad['params'][name] = bad['params'][name][..., :1]
    with pytest.raises(ValueError, match='shape/dtype'):
        load_train_state(os_, bad)
    bad = copy.deepcopy(state)
    bad['step'] = bad['step'].long()
    with pytest.raises(ValueError, match='shape/dtype'):
        load_train_state(os_, bad)

"""Slice parity of the EMSAFormer eval path of the PyTorch/CUDA port
(nicr_mtsa_tpu_torch) against the JAX package's fused eval step, on the
CPU in f32: `bench.py --eval --model emsaformer_dve_v2`'s wiring (the
semantic upsampling in the head; semantic, instance, orientation, scene
and dense-visual-embedding tasks plus the panoptic helper; the DVE
class tables and targets of the bench) on a narrow SwinV2 RGB-D model
(the widths of tests/_torch_train_helpers.py, embedding 8, class
tables (40, 8)), both packages on the same weights, the batch of
tests/test_torch_eval_pipeline.py (dummy samples of 512 x 512 resized
to 96 x 128) with the bench's DVE targets. The JAX model runs its
window attention on XLA ('auto' on the CPU); the window-attention
sub-block and the LayerNorm kernels are held against Pallas interpret
mode in their own files.

- From the same raw outputs (the JAX step's), the port's
  postprocessing + metric updates give integer states equal, float
  sums within rtol 1e-5, and every loss within rtol 1e-5; the DVE
  confusion matrices are equal or differ only at counted near-ties
  (pixels whose top two JAX full-resolution retrieval logits are within
  1e-5 of their magnitude).
- Each package's own step: the semantic and DVE matrices differ in at
  most 0.1 % of the counted pixels; every epoch metric is in range.
- Units: the DVE targets, the score-matrix cosine, the cosine's bound,
  the rgbd input, the pipeline's refusals and the postprocessor's
  keys."""
import dataclasses
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_train_helpers import BACKBONE, SMALL, randomise_norms
from test_torch_eval_pipeline import _jax_batch, port_batch
from nicr_mtsa_tpu.configs import emsaformer_dve_v2
from nicr_mtsa_tpu.data.preprocessing.base import APPLIED_PREPROCESSING_KEY
from nicr_mtsa_tpu.data.preprocessing.dense_visual_embedding import (
    _index_image,
)
from nicr_mtsa_tpu.losses import (
    CosineEmbeddingLoss as JCos, L1Loss as JL1, MSELoss as JMSE,
)
from nicr_mtsa_tpu.models.backbones.swin import SwinBackbone
from nicr_mtsa_tpu.models.multi_task import build_model as jax_build
from nicr_mtsa_tpu.pipeline import (
    MultiTaskPipeline as JPipeline, default_postprocessors as j_post,
    strip_non_arrays as j_strip_non_arrays,
)
from nicr_mtsa_tpu.tasks import (
    DenseVisualEmbeddingTaskHelper as JDveHelper, InstanceTaskHelper,
    PanopticTaskHelper, SceneTaskHelper, SemanticTaskHelper,
)
from nicr_mtsa_tpu.tasks.dense_visual_embedding import (
    pad_embedding_luts as j_pad_embedding_luts,
)
from nicr_mtsa_tpu_torch.data.fullres import get_fullres_key
from nicr_mtsa_tpu_torch.data.targets import index_image
from nicr_mtsa_tpu_torch.losses import CosineEmbeddingLoss, L1Loss, MSELoss
from nicr_mtsa_tpu_torch.models.backbones.swin import (
    SwinBackbone as TSwinBackbone,
)
from nicr_mtsa_tpu_torch.models.multi_task import build_model as torch_build
from nicr_mtsa_tpu_torch.pipeline import (
    MultiTaskPipeline, build_eval_pipeline, default_postprocessors,
    emsaformer_eval_config, eval_task_helpers,
)
from nicr_mtsa_tpu_torch.postprocessing import (
    DenseVisualEmbeddingPostprocessing,
)
from nicr_mtsa_tpu_torch.postprocessing import (
    dense_visual_embedding as t_dve_post,
)
from nicr_mtsa_tpu_torch.tasks import DenseVisualEmbeddingTaskHelper
from nicr_mtsa_tpu_torch.testing import dve_arrays, dve_tables
from nicr_mtsa_tpu_torch.utils import flax_weights as fw

torch.set_num_threads(2)
H, W = 96, 128
N_CLASSES, N_THING, D = 40, 8, SMALL['embedding_dim']
IS_THING = tuple(i < N_THING for i in range(N_CLASSES))
IS_THING_V = (False,) + IS_THING
DVE = 'dense_visual_embedding'
PREFIXES = (f'{DVE}_text_based_semantic', f'{DVE}_visual_mean_based_semantic')
DVE_STATES = dict(zip(('text_cm', 'visual_mean_cm'), PREFIXES))
RAW_KEYS = ('semantic_output', 'instance_output', 'scene_output',
            f'{DVE}_output')
FULLRES_KEYS = tuple(get_fullres_key(f'{p}_{s}') for p in PREFIXES
                     for s in ('idx', 'output'))


def _dve_kwargs(text, visual_mean):
    return dict(with_text_embeddings_per_class=True,
                text_embeddings_per_class=text,
                with_mean_visual_embedding_per_class=True,
                mean_visual_embedding_per_class=visual_mean)


def _jax_model():
    cfg = dataclasses.replace(
        emsaformer_dve_v2(input_size=(H, W), dtype=jnp.float32), **SMALL,
        defer_semantic_prediction_upsampling=False)
    m = jax_build(cfg)
    backbone = SwinBackbone(dtype=jnp.float32, **BACKBONE)
    return m.clone(encoder=m.encoder.clone(backbone=backbone),
                   context_module=m.context_module.clone(
                       n_channels_in=backbone.stages_n_channels[-1]))


def _port_model():
    cfg = dataclasses.replace(emsaformer_eval_config((H, W), 'float32'),
                              **SMALL)
    return torch_build(cfg, device='cpu', rgbd_backbone=TSwinBackbone(
        generator=torch.Generator().manual_seed(0), **BACKBONE))


def _bench_dve_loop(pan, rng):
    """bench.py:258-271: the JAX package's own loop over the images."""
    luts, idx_imgs = [], []
    for b in range(pan.shape[0]):
        ids = np.unique(pan[b])
        ids = ids[ids != 0]
        m = rng.normal(size=(len(ids), D)).astype(np.float32)
        luts.append(m / np.linalg.norm(m, axis=1, keepdims=True))
        index_img = np.zeros(pan[b].shape, np.int32)
        for j, sid in enumerate(ids, start=1):
            index_img[pan[b] == sid] = j
        idx_imgs.append(index_img)
    return np.stack(idx_imgs), j_pad_embedding_luts(luts, D)


@pytest.fixture(scope='module')
def runs():
    """Both pipelines on the same weights and batch; the JAX step's raw
    and retrieval outputs, losses and states."""
    _, text, visual_mean = dve_tables(N_CLASSES, D)
    jm = _jax_model()
    batch = _jax_batch()
    batch.update(dve_arrays(np.asarray(batch['panoptic']), D,
                            dve_tables(N_CLASSES, D)[0]))
    static = {APPLIED_PREPROCESSING_KEY: batch[APPLIED_PREPROCESSING_KEY]}
    arrays = j_strip_non_arrays(batch)
    template = jax.eval_shape(lambda: jm.init(
        {'params': jax.random.PRNGKey(0)},
        {'rgbd': jnp.zeros((1, H, W, 4))}, train=False))
    tm = _port_model()
    v = fw.torch_to_flax_variables(tm, template)
    randomise_norms(v, np.random.default_rng(3))
    fw.load_flax_variables(tm, v)

    jpipe = JPipeline(
        model=jm,
        postprocessors=j_post(
            tasks=('semantic', 'instance', 'orientation', 'scene', DVE,
                   'panoptic'),
            semantic_classes_is_thing=IS_THING, top_k_instances=64,
            **_dve_kwargs(text, visual_mean)),
        task_helpers={
            'semantic': SemanticTaskHelper(n_classes=N_CLASSES),
            'instance': InstanceTaskHelper(
                semantic_n_classes=N_CLASSES + 1,
                semantic_classes_is_thing=IS_THING_V, top_k_instances=64),
            'panoptic': PanopticTaskHelper(
                semantic_n_classes=N_CLASSES + 1,
                semantic_classes_is_thing=IS_THING_V),
            'scene': SceneTaskHelper(n_classes=10),
            DVE: JDveHelper(n_classes=N_CLASSES)})
    states = {n: h.empty_metric_states()
              for n, h in jpipe.task_helpers.items()}
    with jax.default_matmul_precision('highest'):
        step = jpipe.make_fused_eval_step(static,
                                          output_keys=RAW_KEYS + FULLRES_KEYS)
        out, losses1, states1 = step(v['params'], v.get('batch_stats', {}),
                                     arrays, states)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)   # noqa: E731

    tpipe = MultiTaskPipeline(
        tm, default_postprocessors(
            ('semantic', 'instance', 'orientation', 'scene', DVE,
             'panoptic'), IS_THING, top_k_instances=64,
            **_dve_kwargs(text, visual_mean)),
        eval_task_helpers(N_CLASSES, N_THING, 64, 10,
                          dense_visual_embedding=True))
    return dict(jpipe=jpipe, tpipe=tpipe, batch=batch, static=static,
                out=to_np(out), losses1=to_np(losses1),
                states1=to_np(states1))


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a).transpose(0, 3, 1, 2)))


def _port_batch(runs):
    return dict(port_batch(runs['batch']), **runs['static'])


def _near_ties(got_idx, want_idx, want_logits):
    """(number of differing pixels, whether each is a near tie on the
    reference side: its top two logits within 1e-5 of their
    magnitude)."""
    diff = got_idx != want_idx
    top2 = np.sort(want_logits[diff], axis=-1)[:, -2:]
    gap = top2[:, 1] - top2[:, 0]
    return int(diff.sum()), bool(np.all(
        gap <= 1e-5 * np.maximum(np.abs(top2[:, 1]), 1e-30)))


def _assert_states_match(got, want, name=''):
    if isinstance(want, dict):
        assert set(got) == set(want), name
        for k in want:
            _assert_states_match(got[k], want[k], f'{name}/{k}')
        return
    got = got.numpy()
    if name.endswith(('iou_per_class', 'sum_angular_error')):
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=name)
    else:
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_states_and_losses_from_same_raw_outputs(runs):
    out = runs['out']
    heat, offset, ori = out['instance_output']
    predictions = {
        'semantic': (_nchw(out['semantic_output']), ()),
        'instance': ((_nchw(heat), _nchw(offset), _nchw(ori)), ()),
        'scene': (torch.from_numpy(np.array(out['scene_output'])), ()),
        DVE: (_nchw(out[f'{DVE}_output']), ())}
    tpipe = runs['tpipe']
    preds, losses, states = tpipe.evaluate_outputs(
        predictions, _port_batch(runs), tpipe.empty_metric_states(),
        output_keys=FULLRES_KEYS[::2])
    want = runs['states1']
    _assert_states_match({k: v for k, v in states.items() if k != DVE},
                         {k: v for k, v in want.items() if k != DVE})
    assert float(states['instance']['pq']['tp_per_class'].sum()) > 0
    for state_key, prefix in DVE_STATES.items():
        cm = states[DVE][state_key].numpy()
        assert cm.sum() == want[DVE][state_key].sum() > 0
        key = get_fullres_key(f'{prefix}_idx')
        n, ties = _near_ties(preds[key].numpy(), out[key],
                             out[get_fullres_key(f'{prefix}_output')])
        print(f'{state_key}: {n} pixels differ, all near ties: {ties}')
        assert ties
        if n == 0:
            np.testing.assert_array_equal(cm, want[DVE][state_key])
    assert set(losses) == set(runs['losses1'])
    assert f'{DVE}_loss_main' in losses
    for k, w in runs['losses1'].items():
        np.testing.assert_allclose(float(losses[k]), w, rtol=1e-5, err_msg=k)

    # epoch results from those states
    jpipe = runs['jpipe']
    for name, helper in jpipe.task_helpers.items():
        helper.load_metric_states(runs['states1'][name])
    _, _, want_logs = jpipe.validation_epoch_end()
    tpipe.load_metric_states(states)
    _, _, got = tpipe.validation_epoch_end()
    eager_only = ('orientation_mae_gt', '_time')
    assert set(got) == {k for k in want_logs
                        if not any(e in k for e in eager_only)}
    assert {f'{DVE}_text_miou', f'{DVE}_visual_mean_miou'} <= set(got)
    for k, g in got.items():
        np.testing.assert_allclose(g, want_logs[k], rtol=1e-5, err_msg=k)


def _in_range(logs):
    for k, val in logs.items():
        if k.endswith('num_categories'):
            continue
        if '_mae_' in k:
            assert math.isnan(val) or 0.0 <= val <= (
                180.0 if k.endswith('deg') else math.pi), (k, val)
        else:
            assert 0.0 <= val <= 1.0, (k, val)


def test_fused_step_end_to_end(runs):
    tpipe = runs['tpipe']
    batch = port_batch(runs['batch'])
    step = tpipe.make_fused_eval_step(runs['static'])
    preds, losses, states = step(batch, tpipe.empty_metric_states())
    assert preds == {}
    assert all(bool(torch.isfinite(v)) for v in losses.values())
    assert 0.0 <= float(losses[f'{DVE}_loss_main']) <= 2.0
    counted = int((np.asarray(runs['batch']['semantic_fullres']) != 0
                   ).sum())
    want = runs['states1']
    for cm, w in ((states['semantic'], want['semantic']),
                  *((states[DVE][k], want[DVE][k]) for k in DVE_STATES)):
        cm = cm.numpy()
        assert cm.sum() == w.sum() == counted
        assert np.abs(cm - w).sum() / 2 <= 1e-3 * cm.sum()
    tpipe.load_metric_states(states)
    _, _, logs = tpipe.validation_epoch_end()
    assert {'semantic_miou', 'panoptic_all_deeplab_pq', 'scene_acc',
            f'{DVE}_text_miou', f'{DVE}_visual_mean_miou'} <= set(logs)
    _in_range(logs)


def test_dve_targets_match_jax_and_bench_loop(runs):
    pan = np.asarray(runs['batch']['panoptic'])
    got = dve_arrays(pan, D, np.random.default_rng(11))
    want_idx, want_lut = _bench_dve_loop(pan, np.random.default_rng(11))
    np.testing.assert_array_equal(got[f'{DVE}_indices'], want_idx)
    np.testing.assert_array_equal(got[f'{DVE}_lut'], want_lut)
    assert want_idx.max() == want_lut.shape[1] - 1 >= 4
    # ids in any order: the index image follows the order given
    rng = np.random.default_rng(2)
    for b in range(pan.shape[0]):
        ids = rng.permutation(np.unique(pan[b]).astype(np.int64))
        np.testing.assert_array_equal(index_image(pan[b], ids),
                                      _index_image(pan[b], ids))
    np.testing.assert_array_equal(index_image(pan[0], np.zeros(0, np.int64)),
                                  _index_image(pan[0], np.zeros(0, np.int64)))


def _loss_inputs(seed=0, B=2, h=12, w=16, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    p = rng.normal(size=(B, D, h, w)).astype(np.float32)
    idx = rng.integers(0, 6, (B, h, w)).astype(np.int32)   # 0: void
    lut = rng.normal(size=(B, 6, D)).astype(np.float32)
    lut[:, 0] = 0.0
    return torch.from_numpy(p).to(dtype), idx, lut


@pytest.mark.parametrize('loss_name', ['cos_emb', 'mse', 'l1'])
def test_score_matrix_loss_matches_dense_targets(loss_name):
    p, idx, lut = _loss_inputs()
    helper = DenseVisualEmbeddingTaskHelper(N_CLASSES, loss_name)
    got = helper.compute_losses(
        {f'{DVE}_indices': torch.from_numpy(idx),
         f'{DVE}_lut': torch.from_numpy(lut)},
        {f'{DVE}_output': p, f'{DVE}_side_outputs': ()})
    # the dense target of each pixel, and both packages' loss classes
    pn = p.numpy().transpose(0, 2, 3, 1).reshape(-1, D)
    target = np.take_along_axis(lut, idx.reshape(2, -1, 1), axis=1
                                ).reshape(-1, D)
    valid = idx.reshape(-1) != 0
    port_cls = {'cos_emb': CosineEmbeddingLoss, 'mse': MSELoss,
                'l1': L1Loss}[loss_name](reduction='none')
    jax_cls = {'cos_emb': JCos, 'mse': JMSE, 'l1': JL1}[loss_name](
        reduction='none')
    (per_t, _), = port_cls([torch.from_numpy(pn)],
                           [torch.from_numpy(target)])
    (per_j, _), = jax_cls([jnp.asarray(pn)], [jnp.asarray(target)])
    for per in (per_t.numpy(), np.asarray(per_j)):
        if per.ndim == 2:
            per = per.mean(axis=1)
        want = per[valid].sum() / valid.sum()
        np.testing.assert_allclose(float(got[f'{DVE}_loss_main']), want,
                                   rtol=1e-5)
    np.testing.assert_allclose(float(got[f'{DVE}_total_loss']),
                               float(got[f'{DVE}_loss_main']), rtol=1e-7)
    # the JAX helper on the same inputs (channels-last)
    with jax.default_matmul_precision('highest'):
        jgot = JDveHelper(N_CLASSES, loss_name).compute_losses(
            {f'{DVE}_indices': jnp.asarray(idx), f'{DVE}_lut':
             jnp.asarray(lut)},
            {f'{DVE}_output': jnp.asarray(p.numpy().transpose(0, 2, 3, 1)),
             f'{DVE}_side_outputs': ()})
    for k, w in jgot.items():
        np.testing.assert_allclose(float(got[k]), float(w), rtol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_cosine_of_own_target_row_at_most_one(dtype):
    """A prediction equal to its pixel's LUT row: the cosine stays <= 1
    (the JAX package's numerator einsum has no `precision=` and can
    exceed 1 on reduced-precision backends: ROADMAP Queue 3)."""
    _, idx, lut = _loss_inputs(1)
    lut = lut * np.random.default_rng(4).uniform(0.5, 40.0, (2, 6, 1)
                                                 ).astype(np.float32)
    lut = torch.from_numpy(lut).to(dtype).float()  # representable in dtype
    p = torch.stack([lut[b][torch.from_numpy(idx[b]).long()]
                     for b in range(2)]).permute(0, 3, 1, 2).to(dtype)
    helper = DenseVisualEmbeddingTaskHelper(N_CLASSES)
    for b in range(2):
        flat_idx = torch.from_numpy(idx[b]).reshape(-1).long()
        per = helper._pixel_losses(p[b].permute(1, 2, 0).reshape(-1, D),
                                   lut[b], flat_idx)
        valid = flat_idx != 0
        assert float(per[valid].min()) >= -1e-6       # cos <= 1 + 1e-6
    loss = helper.compute_losses(
        {f'{DVE}_indices': torch.from_numpy(idx), f'{DVE}_lut': lut},
        {f'{DVE}_output': p, f'{DVE}_side_outputs': ()})
    assert abs(float(loss[f'{DVE}_loss_main'])) <= 1e-6


def test_model_inputs_concatenates_rgbd(runs):
    """A 4-channel backbone and an eval batch (rgb and depth apart): the
    port gave no input at all before; now the JAX function's rgbd."""
    jpipe, tpipe = runs['jpipe'], runs['tpipe']
    arrays = j_strip_non_arrays(runs['batch'])
    want = jpipe.model_inputs(arrays)
    got = tpipe.model_inputs(port_batch(runs['batch']))
    assert set(got) == set(want) == {'rgbd'}
    np.testing.assert_array_equal(
        got['rgbd'].numpy().transpose(0, 2, 3, 1), np.asarray(want['rgbd']))
    # an rgbd the batch carries goes through as it is
    rgbd = torch.zeros(1, 4, H, W)
    assert torch.equal(tpipe.model_inputs({'rgbd': rgbd, 'rgb': rgbd[:, :3],
                                           'depth': rgbd[:, 3:]})['rgbd'],
                       rgbd)


def test_build_eval_pipeline_needs_cuda_and_tables(monkeypatch):
    _, text, visual_mean = dve_tables(N_CLASSES, 512)
    with pytest.raises(ValueError, match='class tables'):
        build_eval_pipeline(emsaformer_eval_config(), device='cpu')
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        build_eval_pipeline(emsaformer_eval_config(),
                            dve_tables=(text, visual_mean))


def test_dve_postprocessor_computes_only_read_keys(monkeypatch):
    _, text, visual_mean = dve_tables(N_CLASSES, D)
    post = DenseVisualEmbeddingPostprocessing(**_dve_kwargs(text,
                                                            visual_mean))
    x = _loss_inputs(2, h=24, w=32)[0]
    batch = {'semantic_fullres': torch.zeros(2, 30, 40, dtype=torch.int32),
             APPLIED_PREPROCESSING_KEY: [[{
                 'type': 'Resize', 'valid_region_slice_y': slice(0, 24),
                 'valid_region_slice_x': slice(0, 32)}]]}
    calls = []
    inner = t_dve_post.semantic_argmax_score
    monkeypatch.setattr(t_dve_post, 'semantic_argmax_score',
                        lambda t: calls.append(t) or inner(t))
    read = frozenset(DenseVisualEmbeddingTaskHelper.prediction_keys)
    got = post.postprocess((x, ()), batch, keys=read)
    assert set(got) == {f'{DVE}_output', f'{DVE}_side_outputs',
                        *(get_fullres_key(f'{p}_idx') for p in PREFIXES)}
    assert calls == []                # no working-resolution reduce
    assert got[get_fullres_key(f'{PREFIXES[0]}_idx')].shape == (2, 30, 40)
    assert set(post.postprocess((x, ()), batch, keys=frozenset())) == {
        f'{DVE}_output', f'{DVE}_side_outputs'}
    every = post.postprocess((x, ()), batch)
    assert set(every) == {f'{DVE}_output', f'{DVE}_side_outputs', *(
        f'{p}{s}' for p in PREFIXES for s in (
            '_output', '_idx', '_score', '_idx_fullres', '_score_fullres'))}
    # the logits: cosine similarities of the map with each table's rows
    xn = x / torch.linalg.vector_norm(x, dim=1, keepdim=True)
    for p, table in zip(PREFIXES, (text, visual_mean)):
        want = torch.einsum('bdhw,cd->bchw', xn, torch.from_numpy(table))
        torch.testing.assert_close(every[f'{p}_output'], want, rtol=1e-5,
                                   atol=1e-6)
        assert torch.equal(every[f'{p}_idx'], want.argmax(dim=1).int())

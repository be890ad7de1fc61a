"""Slice parity of the eval path of the PyTorch/CUDA port
(nicr_mtsa_tpu_torch) against the JAX package's fused eval step
(`MultiTaskPipeline.make_fused_eval_step`), on the CPU in f32.

One batch is built by the JAX preprocessing chain of
tests/test_pipeline.py (dummy samples of 512 x 512 resized to 96 x 128,
so that the semantic full-resolution keys go through the crop + resize
+ reduce) and converted to tensors; one small model (the config of
tests/_torch_port_helpers.py, semantic upsampling in the head) runs in
both packages on the same weights.

- From the same raw outputs (the JAX step's, converted to NCHW), the
  port's postprocessing + metric updates give integer states equal to
  the JAX step's exactly, float sums within rtol 1e-5 and losses within
  rtol 1e-4.
- Each package's own step, run twice: the semantic confusion matrices
  differ in at most 0.1 % of the counted pixels (both models are f32,
  but their sums run in another order, which flips near-tie pixels),
  and every epoch metric is in range.
- The port's host batch builder gives the JAX generators' arrays
  exactly for the same ground truth."""
import math

import numpy as np
import jax
import pytest
import torch

import _torch_port_helpers as hp
from nicr_mtsa_tpu.data import mt_collate
from nicr_mtsa_tpu.data.preprocessing import (
    Compose, FullResCloner, InstanceClearStuffIDs, InstanceTargetGenerator,
    NormalizeDepth, NormalizeRGB, OrientationTargetGenerator,
    PanopticTargetGenerator, Resize, ToDeviceArrays,
)
from nicr_mtsa_tpu.data.preprocessing.base import APPLIED_PREPROCESSING_KEY
from nicr_mtsa_tpu.data._types import AppliedPreprocessingMeta
from nicr_mtsa_tpu.pipeline import (
    MultiTaskPipeline as JPipeline, default_postprocessors as j_post,
    strip_non_arrays as j_strip_non_arrays,
)
from nicr_mtsa_tpu.tasks import (
    InstanceTaskHelper, PanopticTaskHelper, SceneTaskHelper,
    SemanticTaskHelper,
)
from nicr_mtsa_tpu.testing import get_dummy_sample
from nicr_mtsa_tpu_torch.pipeline import (
    MultiTaskPipeline, build_eval_pipeline, default_postprocessors,
    eval_task_helpers, strip_non_arrays,
)
from nicr_mtsa_tpu_torch.testing import (
    build_eval_batch, eval_arrays, synthetic_ground_truth,
)
from nicr_mtsa_tpu_torch.utils.flax_weights import load_flax_variables

torch.set_num_threads(2)
IS_THING = tuple(i < hp.N_THING for i in range(hp.N_CLASSES))
IS_THING_V = (False,) + IS_THING
RAW_KEYS = ('semantic_output', 'instance_output', 'scene_output')
TABLE = 128


def _preprocessing():
    return Compose([
        InstanceClearStuffIDs(semantic_classes_is_thing=IS_THING_V),
        FullResCloner(('rgb', 'depth', 'semantic', 'instance')),
        Resize(height=hp.H, width=hp.W),
        InstanceTargetGenerator(sigma=8,
                                semantic_classes_is_thing=IS_THING_V),
        OrientationTargetGenerator(
            semantic_classes_estimate_orientation=IS_THING_V),
        PanopticTargetGenerator(semantic_classes_is_thing=IS_THING_V,
                                segment_table_size=TABLE),
        NormalizeRGB(),
        NormalizeDepth(depth_mean=8000.0, depth_std=4000.0,
                       raw_depth=True),
        ToDeviceArrays(),
    ])


def _jax_batch():
    """Two dummy samples (the second mirrored) through the chain."""
    pre = _preprocessing()
    samples = []
    for i in range(2):
        s = get_dummy_sample()
        if i:
            for k in ('rgb', 'depth', 'instance', 'semantic'):
                s[k] = np.ascontiguousarray(s[k][:, ::-1])
        s['scene'] = i + 1
        samples.append(pre(s))
    return mt_collate(samples)


def port_batch(batch) -> dict:
    """A JAX-package batch as the port's tensors: (B, H, W, C) arrays
    become NCHW, unsigned and int64 ids int32; meta and the nested
    dicts are dropped (the provenance goes into the static batch)."""
    out = {}
    for k, v in strip_non_arrays(batch).items():
        if isinstance(v, dict):
            continue
        a = np.asarray(v)
        if a.ndim == 4:
            a = a.transpose(0, 3, 1, 2)
        if a.dtype in (np.uint8, np.uint16, np.uint32, np.int64):
            a = a.astype(np.int32)
        out[k] = torch.from_numpy(np.ascontiguousarray(a))
    return out


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a).transpose(0, 3, 1, 2)))


@pytest.fixture(scope='module')
def runs():
    """Both pipelines on the same weights and batch; the JAX step run
    twice, its raw outputs returned (one compile)."""
    jm = hp.jax_model(False)
    v = hp.shaped_variables(jm, seed=1)
    jpipe = JPipeline(
        model=jm,
        postprocessors=j_post(tasks=('semantic', 'instance', 'orientation',
                                     'scene', 'panoptic'),
                              semantic_classes_is_thing=IS_THING,
                              top_k_instances=64),
        task_helpers={
            'semantic': SemanticTaskHelper(n_classes=hp.N_CLASSES),
            'instance': InstanceTaskHelper(
                semantic_n_classes=hp.N_CLASSES + 1,
                semantic_classes_is_thing=IS_THING_V, top_k_instances=64),
            'panoptic': PanopticTaskHelper(
                semantic_n_classes=hp.N_CLASSES + 1,
                semantic_classes_is_thing=IS_THING_V),
            'scene': SceneTaskHelper(n_classes=10),
        })
    batch = _jax_batch()
    static = {APPLIED_PREPROCESSING_KEY: batch[APPLIED_PREPROCESSING_KEY]}
    arrays = j_strip_non_arrays(batch)
    states = {n: h.empty_metric_states()
              for n, h in jpipe.task_helpers.items()}
    with jax.default_matmul_precision('highest'):
        step = jpipe.make_fused_eval_step(static, output_keys=RAW_KEYS)
        raw, losses1, states1 = step(v['params'], v['batch_stats'], arrays,
                                     states)
        _, _, states2 = step(v['params'], v['batch_stats'], arrays, states1)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)   # noqa: E731

    tm = hp.torch_model(False)
    load_flax_variables(tm, v)
    tpipe = MultiTaskPipeline(
        tm, default_postprocessors(
            ('semantic', 'instance', 'orientation', 'scene', 'panoptic'),
            IS_THING, top_k_instances=64),
        eval_task_helpers(hp.N_CLASSES, hp.N_THING, 64, 10))
    return dict(jpipe=jpipe, tpipe=tpipe, batch=batch, static=static,
                raw=to_np(raw), losses1=to_np(losses1),
                states1=to_np(states1), states2=to_np(states2))


def _assert_states_match(got, want, name=''):
    """Integer states exactly, float sums within rtol 1e-5."""
    if isinstance(want, dict):
        assert set(got) == set(want), name
        for k in want:
            _assert_states_match(got[k], want[k], f'{name}/{k}')
        return
    got = got.numpy()
    if name.endswith(('iou_per_class', 'sum_angular_error')):
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=name)
    else:                   # confusion matrices, TP/FN/FP, counts
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_states_from_same_raw_outputs(runs):
    raw = runs['raw']
    heat, offset, ori = raw['instance_output']
    predictions = {
        'semantic': (_nchw(raw['semantic_output']), ()),
        'instance': ((_nchw(heat), _nchw(offset), _nchw(ori)), ()),
        'scene': (torch.from_numpy(np.array(raw['scene_output'])), ())}
    batch = dict(port_batch(runs['batch']), **runs['static'])
    tpipe = runs['tpipe']
    preds, losses, states = tpipe.evaluate_outputs(
        predictions, batch, tpipe.empty_metric_states())
    assert preds == {}
    _assert_states_match(states, runs['states1'])
    # the batch really exercises the matching: PQ has true positives
    assert float(states['instance']['pq']['tp_per_class'].sum()) > 0
    assert set(losses) == set(runs['losses1'])
    for k, want in runs['losses1'].items():
        np.testing.assert_allclose(float(losses[k]), want, rtol=1e-4,
                                   err_msg=k)

    # epoch results from those states
    jpipe = runs['jpipe']
    for name, helper in jpipe.task_helpers.items():
        helper.load_metric_states(runs['states1'][name])
    _, _, want = jpipe.validation_epoch_end()
    tpipe.load_metric_states(states)
    _, _, got = tpipe.validation_epoch_end()
    eager_only = ('orientation_mae_gt', '_time')
    assert set(got) == {k for k in want
                        if not any(e in k for e in eager_only)}
    for k, g in got.items():
        np.testing.assert_allclose(g, want[k], rtol=1e-5, err_msg=k)


def _in_range(logs):
    for k, val in logs.items():
        if k.endswith('num_categories'):
            continue
        if '_mae_' in k:           # nan when no matched pair had an angle
            assert math.isnan(val) or 0.0 <= val <= (
                180.0 if k.endswith('deg') else math.pi), (k, val)
        else:
            assert 0.0 <= val <= 1.0, (k, val)


def test_fused_step_end_to_end(runs):
    tpipe = runs['tpipe']
    batch = port_batch(runs['batch'])
    step = tpipe.make_fused_eval_step(runs['static'])
    states = tpipe.empty_metric_states()
    for _ in range(2):                        # states accumulate
        preds, losses, states = step(batch, states)
    assert preds == {}
    assert all(bool(torch.isfinite(v)) for v in losses.values())
    cm, want = states['semantic'].numpy(), runs['states2']['semantic']
    counted = int((np.asarray(runs['batch']['semantic_fullres']) != 0
                   ).sum())
    assert cm.sum() == want.sum() == 2 * counted
    assert np.abs(cm - want).sum() / 2 <= 1e-3 * cm.sum()
    tpipe.load_metric_states(states)
    _, _, logs = tpipe.validation_epoch_end()
    assert {'semantic_miou', 'panoptic_all_deeplab_pq',
            'instance_all_deeplab_pq', 'panoptic_deeplab_semantic_miou',
            'scene_acc'} <= set(logs)
    _in_range(logs)


def test_output_keys_select_and_fullres_logits_not_built(runs):
    tpipe = runs['tpipe']
    batch = port_batch(runs['batch'])
    step = tpipe.make_fused_eval_step(
        runs['static'], output_keys=('semantic_segmentation_idx_fullres',
                                     'panoptic_segmentation_deeplab'))
    preds, _, _ = step(batch, tpipe.empty_metric_states())
    assert set(preds) == {'semantic_segmentation_idx_fullres',
                          'panoptic_segmentation_deeplab'}
    assert preds['semantic_segmentation_idx_fullres'].shape == (2, 512, 512)
    # all keys: no full-resolution logits or softmax exist to return
    preds, _, _ = tpipe.make_fused_eval_step(runs['static'], None)(
        batch, tpipe.empty_metric_states())
    assert not any(k.startswith(('semantic_output_fullres',
                                 'semantic_softmax')) for k in preds)
    assert preds['panoptic_segmentation_deeplab_instance_idx_fullres'
                 ].shape == (2, 512, 512)


def _jax_targets(gt):
    pre = Compose([
        InstanceClearStuffIDs(semantic_classes_is_thing=IS_THING_V),
        FullResCloner(('rgb', 'depth', 'semantic', 'instance')),
        Resize(height=96, width=128),
        InstanceTargetGenerator(sigma=8,
                                semantic_classes_is_thing=IS_THING_V),
        OrientationTargetGenerator(
            semantic_classes_estimate_orientation=IS_THING_V),
        PanopticTargetGenerator(semantic_classes_is_thing=IS_THING_V,
                                segment_table_size=16),
    ])
    H, W = gt.semantic.shape
    return pre({'rgb': np.zeros((H, W, 3), np.uint8),
                'depth': np.ones((H, W), np.uint16),
                'semantic': gt.semantic.copy(),
                'instance': gt.instance.copy(),
                'orientations': dict(gt.orientations),
                APPLIED_PREPROCESSING_KEY: AppliedPreprocessingMeta()})


def test_batch_builder_matches_jax_generators():
    rng = np.random.default_rng(0)
    gts = [synthetic_ground_truth(rng, (200, 300), hp.N_CLASSES, IS_THING,
                                  n_instances=n) for n in (10, 25)]
    got, overflow = eval_arrays(gts, (96, 128), IS_THING,
                                segment_table_size=16)
    want = [_jax_targets(gt) for gt in gts]
    for k in ('semantic', 'instance', 'instance_center', 'instance_offset',
              'instance_foreground', 'instance_center_mask', 'orientation',
              'orientation_foreground', 'panoptic_fullres',
              'panoptic_segment_table_fullres', 'panoptic_gt_angle_table',
              'panoptic_gt_angle_table_valid'):
        for b in range(2):
            np.testing.assert_array_equal(got[k][b], want[b][k],
                                          err_msg=k)
    # 25 instances + stuff + void do not fit into 16 slots: counted
    n_ids = len(np.unique(want[1]['panoptic_fullres']))
    assert n_ids > 16 and overflow == n_ids - 16


def test_build_eval_batch_layouts():
    eb = build_eval_batch(2, (48, 64), (60, 80), hp.N_CLASSES, IS_THING,
                          seed=1, device='cpu')
    b = eb.batch
    assert eb.segment_table_overflow == 0
    assert b['rgb'].shape == (2, 3, 48, 64)
    assert b['depth'].shape == (2, 1, 48, 64)
    assert b['instance_offset'].shape == (2, 2, 48, 64)
    assert b['semantic_fullres'].shape == (2, 60, 80)
    assert b['panoptic_segment_table_fullres'].dtype == torch.int32
    assert b['instance_foreground'].dtype == torch.bool
    assert 1 <= int(b['scene'].min()) and int(b['scene'].max()) <= 10
    assert eb.static_batch[APPLIED_PREPROCESSING_KEY][0][0][
        'valid_region_slice_x'] == slice(0, 64)


def test_build_eval_pipeline_needs_cuda_unless_cpu_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        build_eval_pipeline()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        build_eval_batch(1, (8, 8), (8, 8), 4, (True, False, False, False))

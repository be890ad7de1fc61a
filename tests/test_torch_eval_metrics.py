"""Module parity of the eval slice of the PyTorch/CUDA port
(nicr_mtsa_tpu_torch) against the JAX package, on the CPU: segment
tables and slots, `deeplab_merge_pq`, `pq_compare` and the PQ/mIoU/MAE
states and results, the confusion matrix, the losses and the host
target generators.

Inputs come from numpy seeds. Integer results (tables, slots, merge
fields, confusion matrices, TP/FN/FP counts) must be equal exactly; the
PQ IoU sums within rtol 1e-5 (f32 sums in another order); each loss
within rtol 1e-5."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nicr_mtsa_tpu.losses import (
    CrossEntropyLossSemantic as JCE, L1Loss as JL1, MSELoss as JMSE,
    VonMisesLossBiternion as JVM,
)
from nicr_mtsa_tpu.metrics import (
    MeanIntersectionOverUnion as JMIoU,
    PanopticQualityWithOrientationMAE as JPQ, confusion_matrix as j_cm,
    pq_compare as j_pq_compare,
)
from nicr_mtsa_tpu.ops.merge import deeplab_merge_pq as j_merge_pq
from nicr_mtsa_tpu.ops.merge_np import (
    naive_merge_semantic_and_instance_np as j_naive_merge,
)
from nicr_mtsa_tpu.ops.segments import (
    ids_to_slots as j_ids_to_slots, merged_segment_table as j_merged_table,
    unique_table as j_unique_table,
)
from nicr_mtsa_tpu.tasks import SceneTaskHelper as JScene
from nicr_mtsa_tpu.tasks._orientation_tables import (
    pred_slot_angles as j_pred_slot_angles,
)
from nicr_mtsa_tpu_torch import losses as t_losses
from nicr_mtsa_tpu_torch.data import targets as t_targets
from nicr_mtsa_tpu_torch.metrics import (
    MeanIntersectionOverUnion as TMIoU,
    PanopticQualityWithOrientationMAE as TPQ, confusion_matrix as t_cm,
    pq_compare as t_pq_compare,
)
from nicr_mtsa_tpu_torch.ops.merge import deeplab_merge_pq as t_merge_pq
from nicr_mtsa_tpu_torch.ops.segments import (
    SEGMENT_TABLE_PAD, ids_to_slots as t_ids_to_slots,
    merged_segment_table as t_merged_table, unique_table as t_unique_table,
)
from nicr_mtsa_tpu_torch.tasks import SceneTaskHelper as TScene
from nicr_mtsa_tpu_torch.tasks._orientation_tables import (
    pred_slot_angles as t_pred_slot_angles,
)

torch.set_num_threads(2)
M = 1 << 16
C = 11                                       # classes with void
IS_THING = np.array([i in (1, 2, 3, 4) for i in range(C)])


def _t(a):
    return torch.from_numpy(np.array(a))


def _merged_maps(seed, B=2, H=24, W=32, K=8):
    """Semantic (with void), instance ids and a thing foreground."""
    rng = np.random.default_rng(seed)
    sem = rng.integers(0, C, (B, H, W)).astype(np.int32)
    ins = rng.integers(0, K + 1, (B, H, W)).astype(np.int32)
    fg = rng.random((B, H, W)) < 0.7
    return sem, ins, fg


def _merge_both(sem, ins, fg, K=8, S=32):
    kw = dict(max_instances_per_category=M, top_k=K, n_classes_with_void=C,
              pred_table_size=S)
    want = j_merge_pq(jnp.asarray(sem), jnp.asarray(ins), jnp.asarray(fg),
                      jnp.asarray(IS_THING), **kw)
    got = t_merge_pq(_t(sem), _t(ins), _t(fg), _t(IS_THING), **kw)
    return want, got


def test_unique_table_and_slots():
    rng = np.random.default_rng(0)
    ids = (rng.integers(0, 9, (3, 40, 30)) * M
           + rng.integers(0, 4, (3, 40, 30))).astype(np.int32)
    ids[0, :5] = -1                          # not in the table
    for size in (8, 48):                     # truncating / padded tables
        want = np.asarray(j_unique_table(jnp.asarray(ids.reshape(3, -1)),
                                         size))
        got = t_unique_table(_t(ids), size)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        # both the small-table and the bucketed JAX search
        slots_j = np.asarray(j_ids_to_slots(jnp.asarray(ids),
                                            jnp.asarray(want)))
        slots_t = t_ids_to_slots(_t(ids), got)
        assert slots_t.dtype == torch.int32 and slots_t.shape == ids.shape
        np.testing.assert_array_equal(slots_t.numpy(), slots_j)


def test_merged_segment_table():
    sem, ins, fg = _merged_maps(1)
    pan = np.array(j_merge_pq(
        jnp.asarray(sem), jnp.asarray(ins), jnp.asarray(fg),
        jnp.asarray(IS_THING), top_k=8, n_classes_with_void=C,
        pred_table_size=32).panoptic)
    pan[0, 0, :3] = 3 * M + 99               # rank > K: outside contract
    for size in (16, 64):
        want = np.asarray(j_merged_table(jnp.asarray(pan), C, 8, M, size))
        got = t_merged_table(_t(pan), C, 8, M, size)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize('seed', [2, 3])
def test_deeplab_merge_pq_fields(seed):
    want, got = _merge_both(*_merged_maps(seed))
    for field in want._fields:
        g = getattr(got, field)
        assert g.dtype == torch.int32, field
        np.testing.assert_array_equal(g.numpy(),
                                      np.asarray(getattr(want, field)),
                                      err_msg=field)


def test_deeplab_merge_pq_tied_majority():
    """Instance 1 covers 10 px of class 2 and 10 px of class 1: the tie
    goes to the smaller class id, in both packages."""
    sem = np.zeros((1, 4, 6), np.int32)
    ins = np.ones((1, 4, 6), np.int32)
    sem[0, :2] = 2
    sem[0, 2:] = 1
    ins[0, :, 5] = 0
    sem[0, :, 5] = 7                         # a stuff column
    fg = np.ones((1, 4, 6), bool)
    want, got = _merge_both(sem, ins, fg)
    assert int(got.instance_class[0, 1]) == 1
    for field in want._fields:
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)))


def test_merge_pq_table_too_small_raises():
    sem, ins, fg = _merged_maps(4)
    with pytest.raises(ValueError, match='pred_table_size'):
        t_merge_pq(_t(sem), _t(ins), _t(fg), _t(IS_THING), top_k=8,
                   n_classes_with_void=C, pred_table_size=C + 8)


def _pq_inputs(seed, B=2, H=24, W=32):
    """GT panoptic map (naive merge of random rectangles) + table, and
    a predicted merge of a perturbed copy."""
    rng = np.random.default_rng(seed)
    gt_sem = np.full((B, H, W), 7, np.uint8)
    gt_ins = np.zeros((B, H, W), np.uint16)
    gt_sem[:, :, :4] = 0
    for b in range(B):
        for i in range(1, 5):
            y, x = rng.integers(0, H - 8), rng.integers(0, W - 8)
            gt_sem[b, y:y + 8, x:x + 8] = rng.integers(1, 5)
            gt_ins[b, y:y + 8, x:x + 8] = i
    pans = [j_naive_merge(s, i, M, np.flatnonzero(IS_THING), 0)[0]
            for s, i in zip(gt_sem, gt_ins)]
    target = np.stack(pans).astype(np.int32)
    table = np.full((B, 16), SEGMENT_TABLE_PAD, np.int32)
    for b in range(B):
        u = np.unique(target[b])
        table[b, :len(u)] = u
    noise = rng.random((B, H, W)) < 0.1
    sem = np.where(noise, rng.integers(0, C, (B, H, W)), gt_sem)
    ins = np.where(rng.random((B, H, W)) < 0.05, 0, gt_ins)
    fg = IS_THING[sem]
    return target, table, sem.astype(np.int32), ins.astype(np.int32), fg


def test_pq_compare_states():
    target, table, sem, ins, fg = _pq_inputs(5)
    jm, tm = _merge_both(sem, ins, fg)
    kw = dict(num_categories=C, ignored_label=0,
              max_instances_per_category=M)
    with jax.default_matmul_precision('highest'):
        want = j_pq_compare(None, jnp.asarray(target), jnp.asarray(table),
                            jm.pred_table, pred_slots=jm.slots, **kw)
        want_map = j_pq_compare(jm.panoptic, jnp.asarray(target),
                                jnp.asarray(table), jm.pred_table, **kw)
    got = t_pq_compare(None, _t(target), _t(table), tm.pred_table,
                       pred_slots=tm.slots, **kw)
    got_map = t_pq_compare(tm.panoptic, _t(target), _t(table),
                           tm.pred_table, **kw)
    assert float(got.tp_per_class.sum()) > 0      # matches exist
    for w, g in ((want, got), (want_map, got_map), (want, got_map)):
        for k in ('tp_per_class', 'fn_per_class', 'fp_per_class', 'match'):
            np.testing.assert_array_equal(getattr(g, k).numpy(),
                                          np.asarray(getattr(w, k)), k)
        np.testing.assert_allclose(g.iou_per_class.numpy(),
                                   np.asarray(w.iou_per_class), rtol=1e-5)


def test_pq_with_orientation_states_and_results():
    target, table, sem, ins, fg = _pq_inputs(6)
    jm, tm = _merge_both(sem, ins, fg)
    rng = np.random.default_rng(7)
    B, S = table.shape
    gt_angle = rng.uniform(0, 2 * np.pi, (B, S)).astype(np.float32)
    gt_valid = rng.random((B, S)) < 0.8
    by_inst = rng.uniform(-np.pi, np.pi, (B, 9)).astype(np.float32)
    j_ang, j_val = j_pred_slot_angles(jm.pred_table, jm.panoptic_id_table,
                                      jnp.asarray(by_inst))
    t_ang, t_val = t_pred_slot_angles(tm.pred_table, tm.panoptic_id_table,
                                      _t(by_inst))
    np.testing.assert_array_equal(t_ang.numpy(), np.asarray(j_ang))
    np.testing.assert_array_equal(t_val.numpy(), np.asarray(j_val))

    kw = dict(num_categories=C, ignored_label=0,
              max_instances_per_category=M, is_thing=IS_THING)
    jpq, tpq = JPQ(**kw), TPQ(**kw)
    js, ts = jpq.empty_state(), tpq.empty_state()
    for _ in range(2):                               # states accumulate
        with jax.default_matmul_precision('highest'):
            js = jpq.update_state(
                js, None, jnp.asarray(target), gt_table=jnp.asarray(table),
                pred_table=jm.pred_table, pred_slots=jm.slots,
                gt_angle=jnp.asarray(gt_angle),
                gt_angle_valid=jnp.asarray(gt_valid), pred_angle=j_ang,
                pred_angle_valid=j_val)
        ts = tpq.update_state(
            ts, None, _t(target), gt_table=_t(table),
            pred_table=tm.pred_table, pred_slots=tm.slots,
            gt_angle=_t(gt_angle), gt_angle_valid=_t(gt_valid),
            pred_angle=t_ang, pred_angle_valid=t_val)
    assert int(ts['n_elements']) > 0
    for k in ('tp_per_class', 'fn_per_class', 'fp_per_class', 'n_elements'):
        np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]), k)
    for k in ('iou_per_class', 'sum_angular_error'):
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                   rtol=1e-5, err_msg=k)
    want = jpq.compute_from_state(js, suffix='_deeplab')
    got = tpq.compute_from_state(ts, suffix='_deeplab')
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def test_confusion_matrix_and_miou():
    rng = np.random.default_rng(8)
    p = rng.integers(0, C, (2, 40, 50)).astype(np.int32)
    t = rng.integers(0, C, (2, 40, 50)).astype(np.int32)
    with jax.default_matmul_precision('highest'):
        want = np.asarray(j_cm(jnp.asarray(p), jnp.asarray(t), C))
    got = t_cm(_t(p), _t(t), C)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    for ignore in (False, True):
        j, tt = (JMIoU(C, ignore_first_class=ignore),
                 TMIoU(C, ignore_first_class=ignore))
        (mj, ij), (mt, it) = (j.compute_from_state(want, True),
                              tt.compute_from_state(got, True))
        assert mj == mt
        np.testing.assert_array_equal(ij, it)


def test_losses_match():
    rng = np.random.default_rng(9)
    B, H, W = 2, 12, 16
    logits = rng.normal(size=(B, H, W, 40)).astype(np.float32) * 3
    target = rng.integers(0, 41, (B, H, W)).astype(np.int32)
    weights = rng.uniform(0.5, 2, 40).astype(np.float32)
    for kw in ({}, {'weights': weights, 'label_smoothing': 0.1}):
        (lj, nj), = JCE(**kw)([jnp.asarray(logits)], [jnp.asarray(target)])
        (lt, nt), = t_losses.CrossEntropyLossSemantic(**kw)(
            [_t(logits).permute(0, 3, 1, 2)], [_t(target)])
        np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
        assert int(nt) == int(nj)
    a = rng.normal(size=(B, H, W, 2)).astype(np.float32)
    b = rng.normal(size=(B, H, W, 2)).astype(np.float32)
    for jl, tl in ((JL1(), t_losses.L1Loss()), (JMSE(), t_losses.MSELoss())):
        for x, y in ((a, b), (a[..., 0], b[..., 0])):       # NHWC / maps
            (lj, nj), = jl([jnp.asarray(x)], [jnp.asarray(y)])
            xt, yt = _t(x), _t(y)
            if x.ndim == 4:
                xt, yt = xt.permute(0, 3, 1, 2), yt.permute(0, 3, 1, 2)
            (lt, nt), = tl([xt], [yt])
            np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
            assert int(nt) == int(nj)
    (sj, _), = JVM(reduction='none')([jnp.asarray(a.reshape(-1, 2))],
                                     [jnp.asarray(b.reshape(-1, 2))])
    st = t_losses.von_mises_biternion(_t(a).permute(0, 3, 1, 2),
                                      _t(b).permute(0, 3, 1, 2))
    np.testing.assert_allclose(st.numpy().reshape(-1),
                               np.asarray(sj).reshape(-1), rtol=1e-5,
                               atol=1e-7)


def test_scene_helper_matches():
    rng = np.random.default_rng(10)
    logits = rng.normal(size=(6, 10)).astype(np.float32)
    scene = np.array([0, 1, 3, 10, 5, 5], np.int32)      # 0 = void
    idx = rng.integers(0, 10, 6).astype(np.int32)
    j, t = JScene(10), TScene(10)
    lj = j.compute_losses({'scene': jnp.asarray(scene)},
                          {'scene_output': jnp.asarray(logits)})
    lt = t.compute_losses({'scene': _t(scene)}, {'scene_output': _t(logits)})
    np.testing.assert_allclose(float(lt['scene_total_loss']),
                               float(lj['scene_total_loss']), rtol=1e-5)
    with jax.default_matmul_precision('highest'):
        sj = j.update_metric_states(None, {'scene': jnp.asarray(scene)},
                                    {'scene_class_idx': jnp.asarray(idx)})
    st = t.update_metric_states(None, {'scene': _t(scene)},
                                {'scene_class_idx': _t(idx)})
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    j.load_metric_states(sj)
    t.load_metric_states(st)
    logs_j, logs_t = j.validation_epoch_end()[2], t.validation_epoch_end()[2]
    for k in ('scene_acc', 'scene_bacc'):
        assert logs_t[k] == logs_j[k], k


def test_naive_merge_matches():
    rng = np.random.default_rng(11)
    sem = rng.integers(0, C, (30, 40)).astype(np.uint8)
    ins = rng.integers(0, 6, (30, 40)).astype(np.uint16)
    for thing_ids in (np.flatnonzero(IS_THING), []):
        pj, dj = j_naive_merge(sem, ins, M, thing_ids, 0)
        pt, dt = t_targets.naive_merge_semantic_and_instance_np(
            sem, ins, M, thing_ids, 0)
        np.testing.assert_array_equal(pt, pj)
        assert dt == dj


def test_postprocessing_fullres_keys_with_cropped_valid_region():
    """Eval postprocessing with a valid region smaller than the working
    image (a Resize that kept the aspect ratio): the full-resolution
    maps crop it before resizing (crop + resize + reduce, nearest crop
    and resize), equal to the JAX package's on the same raw outputs."""
    from nicr_mtsa_tpu.data.preprocessing.base import (
        APPLIED_PREPROCESSING_KEY,
    )
    from nicr_mtsa_tpu.pipeline import default_postprocessors as j_post
    from nicr_mtsa_tpu_torch.pipeline import default_postprocessors
    rng = np.random.default_rng(12)
    B, H, W, NC = 2, 24, 32, 12
    is_thing = tuple(i < 4 for i in range(NC))
    sem = rng.normal(size=(B, H, W, NC)).astype(np.float32) * 2
    heat = rng.random((B, H, W, 1)).astype(np.float32)
    off = rng.normal(0, 0.05, (B, H, W, 2)).astype(np.float32)
    ori = rng.normal(size=(B, H, W, 2)).astype(np.float32)
    batch = {
        APPLIED_PREPROCESSING_KEY: [[{
            'type': 'Resize', 'valid_region_slice_y': slice(3, 21),
            'valid_region_slice_x': slice(0, 32)}]],
        'semantic_fullres': np.zeros((B, 27, 45), np.int32),
        'instance_fullres': np.zeros((B, 27, 45), np.int32),
        'instance_foreground': rng.random((B, H, W)) < 0.5,
        'orientation_foreground': rng.random((B, H, W)) < 0.5}
    j_raw = ((jnp.asarray(sem), (jnp.asarray(heat), jnp.asarray(off),
                                 jnp.asarray(ori))), ((), ()))
    with jax.default_matmul_precision('highest'):
        want = j_post(('semantic', 'instance', 'orientation', 'panoptic'),
                      is_thing, top_k_instances=16)['panoptic'].postprocess(
            j_raw, {k: (jnp.asarray(v) if isinstance(v, np.ndarray)
                        else v) for k, v in batch.items()}, False)
    nchw = lambda a: _t(a).permute(0, 3, 1, 2)          # noqa: E731
    got = default_postprocessors(
        ('semantic', 'instance', 'orientation', 'panoptic'), is_thing,
        top_k_instances=16)['panoptic'].postprocess(
        ((nchw(sem), (nchw(heat), nchw(off), nchw(ori))), ((), ())),
        {k: (_t(v) if isinstance(v, np.ndarray) else v)
         for k, v in batch.items()})
    for k in ('semantic_segmentation_idx_fullres',
              'instance_segmentation_gt_foreground_fullres',
              'panoptic_segmentation_deeplab_fullres',
              'panoptic_segmentation_deeplab_instance_idx_fullres',
              'panoptic_segmentation_deeplab_semantic_idx_fullres',
              'panoptic_segmentation_deeplab_slots_fullres',
              'panoptic_segmentation_deeplab_slot_table'):
        assert got[k].shape == np.asarray(want[k]).shape, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    np.testing.assert_allclose(
        got['semantic_segmentation_score_fullres'].numpy(),
        np.asarray(want['semantic_segmentation_score_fullres']), rtol=1e-5)
    for k in ('orientations_instance_segmentation_gt_orientation_foreground',
              'orientations_panoptic_segmentation_deeplab_instance'):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)

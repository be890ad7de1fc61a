"""The outputs the port's postprocessing and task helpers produce beyond
the eval step, against the JAX package on the CPU in f32, on seeded
random raw outputs and the repo's fixture frames
(tests/fixtures/mini_dataset, `valid`, B=2, 96 x 128 through the eval
preprocessing of `bench.py --eval --dataset` in each package; 10
classes of which 3 things).

- The panoptic postprocessor with `compute_scores` and the instance
  postprocessor with `debug`: the three score maps and their
  full-resolution crops, the instance meta's scores (rtol 1e-5), the
  maps and ids exact, the all-foreground segmentation and the o-debug
  tables; the panoptic training branch passes the outputs on.
- `store_examples` of the semantic, instance, panoptic, normal and DVE
  helpers: the example keys equal to the JAX helpers', every image
  exact (from the same score maps).
- The DVE helper's eager `validation_step`: states equal to the fused
  update's at atol 0, and the losses (rtol 1e-5), states, logs and
  epoch metrics against the JAX helper's.
- Every helper's `training_step` logs: the JAX helper's keys (the
  detached losses and `<task>_step_time`), the losses within rtol 1e-5.
- `python -m nicr_mtsa_tpu_torch.examples.eval_dataset --cpu` through
  its `main(argv)`: the printed metrics those of the fused eval step on
  the same loader batches, also from a `--checkpoint` file and a step
  directory; without `--cpu` and without a card it raises."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from nicr_mtsa_tpu.data import mt_collate as j_collate
from nicr_mtsa_tpu.data import preprocessing as jpre
from nicr_mtsa_tpu.data.dataset import DirectoryRGBDDataset as JDataset
from nicr_mtsa_tpu.postprocessing import (
    InstancePostprocessing as JInstancePost,
    PanopticPostprocessing as JPanopticPost,
    SemanticPostprocessing as JSemanticPost)
from nicr_mtsa_tpu import tasks as jtasks
from nicr_mtsa_tpu_torch import tasks
from nicr_mtsa_tpu_torch.data import (DirectoryRGBDDataset,
                                      move_batch_to_device, mt_collate)
from nicr_mtsa_tpu_torch.data import preprocessing as pre
from nicr_mtsa_tpu_torch.postprocessing import (InstancePostprocessing,
                                                PanopticPostprocessing,
                                                SemanticPostprocessing)
from _torch_data_helpers import FIXTURE, eval_compose

torch.set_num_threads(2)
H, W, B = 96, 128, 2
RESIZE = '_applied_preprocessing'


def t(a):
    return torch.from_numpy(np.array(np.asarray(a)))


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a).transpose(0, 3, 1, 2)))


def np_nhwc(x):
    return x.detach().float().numpy().transpose(0, 2, 3, 1)


def close(got, want, where, rtol=1e-5, atol=1e-6):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               rtol=rtol, atol=atol, err_msg=where)


def equal(got, want, where):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_array_equal(got, np.asarray(want), err_msg=where)


# --- the fixture batch and random raw outputs -------------------------------

@pytest.fixture(scope='module')
def fixture():
    ds = DirectoryRGBDDataset(str(FIXTURE), split='valid')
    jds = JDataset(str(FIXTURE), split='valid')
    without_void = ds.config.semantic_label_list_without_void
    is_thing = tuple(without_void.classes_is_thing)
    is_thing_v = (False,) + is_thing
    host = mt_collate([eval_compose(pre, is_thing_v, H, W)(ds[i])
                       for i in range(B)])
    jhost = j_collate([eval_compose(jpre, is_thing_v, H, W)(jds[i])
                       for i in range(B)])
    rng = np.random.default_rng(7)
    C = len(without_void)
    coarse = rng.normal(0, 3, (B, H // 16, W // 16, C))
    sem = (np.repeat(np.repeat(coarse, 16, 1), 16, 2)
           + rng.normal(0, 0.5, (B, H, W, C))).astype(np.float32)
    yy, xx = np.mgrid[:H, :W]
    heat = np.zeros((B, H, W, 1), np.float32)
    for b in range(B):
        for cy, cx in rng.uniform((8, 8), (H - 8, W - 8), (6, 2)):
            heat[b, ..., 0] = np.maximum(heat[b, ..., 0], np.exp(
                -((yy - cy) ** 2 + (xx - cx) ** 2) / 50.0))
    raw = dict(
        semantic=sem, heat=heat,
        offset=rng.normal(0, 0.04, (B, H, W, 2)).astype(np.float32),
        orientation=rng.normal(size=(B, H, W, 2)).astype(np.float32),
        scene=rng.normal(size=(B, len(ds.config.scene_label_list))
                         ).astype(np.float32))
    return dict(is_thing=is_thing, is_thing_v=is_thing_v, C=C, raw=raw,
                jbatch=jhost, tbatch=move_batch_to_device(host, 'cpu'))


def _posts(f, debug=True, compute_scores=True):
    kwargs = dict(heatmap_threshold=0.1, heatmap_nms_kernel_size=3,
                  top_k_instances=64)
    jp = JPanopticPost(
        JSemanticPost(), JInstancePost(debug=debug, **kwargs),
        f['is_thing'], f['is_thing'], compute_scores=compute_scores)
    tp = PanopticPostprocessing(
        SemanticPostprocessing(), InstancePostprocessing(debug=debug,
                                                         **kwargs),
        f['is_thing'], f['is_thing'], compute_scores=compute_scores)
    return jp, tp


def _data(raw, port):
    conv = nchw if port else (lambda a: a)
    return ((conv(raw['semantic']), tuple(conv(raw[k]) for k in (
        'heat', 'offset', 'orientation'))), ((), ()))


@pytest.fixture(scope='module')
def panoptic(fixture):
    jp, tp = _posts(fixture)
    # jitted: one compile in place of the eager dispatch of every op
    jbatch = fixture['jbatch']
    static = {k: v for k, v in jbatch.items()
              if k == RESIZE or not isinstance(v, np.ndarray)}
    arrays = {k: v for k, v in jbatch.items() if k not in static}
    want = jax.jit(lambda data, a: jp.postprocess(
        data, dict(a, **static), is_training=False))(
            _data(fixture['raw'], False), arrays)
    want = jax.tree_util.tree_map(np.asarray, want)
    got = tp.postprocess(_data(fixture['raw'], True), fixture['tbatch'])
    return got, want


SCORE_KEYS = tuple(f'panoptic_segmentation_deeplab_{k}_score'
                   for k in ('semantic', 'instance', 'panoptic'))
EXACT_KEYS = ('panoptic_segmentation_deeplab',
              'panoptic_segmentation_deeplab_semantic_idx',
              'panoptic_segmentation_deeplab_instance_idx',
              'instance_segmentation_gt_foreground',
              'instance_segmentation_all_foreground',
              'semantic_segmentation_idx')


def test_panoptic_scores_and_debug_match_jax(panoptic):
    got, want = panoptic
    for key in EXACT_KEYS:
        equal(got[key], want[key], key)
        equal(got[key + '_fullres'], want[key + '_fullres'],
              key + '_fullres')
    # the debug segmentation differs from the GT-foreground one
    assert not torch.equal(got['instance_segmentation_all_foreground'],
                           got['instance_segmentation_gt_foreground'])
    for key in SCORE_KEYS:
        close(got[key], want[key], key)
        close(got[key + '_fullres'], want[key + '_fullres'], key)
        assert 0.0 <= float(got[key].min()) and float(got[key].max()) <= 1.0
    assert float(got[SCORE_KEYS[1]].max()) > 0.1   # thing pixels scored
    close(np_nhwc(got['semantic_softmax_scores']),
          want['semantic_softmax_scores'], 'softmax')
    meta, jmeta = (got['panoptic_segmentation_deeplab_instance_meta'],
                   want['panoptic_segmentation_deeplab_instance_meta'])
    for key in ('semantic_score', 'panoptic_score', 'scores', 'areas'):
        close(meta[key], jmeta[key], key)
    for key in ('orientations_gt_instance',):
        for field in ('ids', 'valid'):
            equal(got[key][field], want[key][field], f'{key}/{field}')
        v = want[key]['valid']
        assert v.any()
        close(got[key]['angles'].numpy()[v], want[key]['angles'][v], key,
              atol=1e-5)
    close(got['orientations_instance_segmentation'],
          want['orientations_instance_segmentation'], 'o-debug', atol=1e-4)


def test_panoptic_without_debug_or_scores_and_training_branch(fixture):
    _, tp = _posts(fixture, debug=False, compute_scores=False)
    got = tp.postprocess(_data(fixture['raw'], True), fixture['tbatch'])
    assert not set(got) & set(SCORE_KEYS + (
        'instance_segmentation_all_foreground', 'orientations_gt_instance',
        'orientations_instance_segmentation', 'semantic_softmax_scores'))
    jp, tp = _posts(fixture)
    data = _data(fixture['raw'], True)
    train = tp.postprocess(data, fixture['tbatch'], is_training=True)
    jtrain = jp.postprocess(_data(fixture['raw'], False), fixture['jbatch'],
                            is_training=True)
    assert set(train) == set(jtrain) == {
        'semantic_output', 'semantic_side_outputs', 'instance_output',
        'instance_side_outputs'}
    assert train['semantic_output'] is data[0][0]
    assert train['instance_output'] is data[0][1]


# --- example images --------------------------------------------------------

def _dense_tasks(seed=11, D=16, L=5, n_classes=10):
    """Hand-made predictions and batches of the normal and DVE tasks, in
    both layouts: (jax preds, jax batch, port preds, port batch)."""
    rng = np.random.default_rng(seed)
    h, w, fh, fw = 24, 32, 30, 40

    def unit(shape):
        n = rng.normal(size=shape).astype(np.float32)
        return n / np.linalg.norm(n, axis=-1, keepdims=True)
    normal_gt = unit((B, h, w, 3))
    normal_gt[:, :3] = 0
    lut = np.zeros((B, L + 1, D), np.float32)
    lut[:, 1:] = unit((B, L, D))
    jp = {'normal_output': unit((B, h, w, 3)), 'normal_side_outputs': (),
          'normal_output_fullres': unit((B, fh, fw, 3)),
          'dense_visual_embedding_output': rng.normal(
              size=(B, h, w, D)).astype(np.float32),
          'dense_visual_embedding_side_outputs': ()}
    for prefix in ('text_based', 'visual_mean_based'):
        key = f'dense_visual_embedding_{prefix}_semantic_idx'
        jp[key] = rng.integers(0, n_classes, (B, h, w)).astype(np.int32)
        jp[key + '_fullres'] = rng.integers(0, n_classes, (B, fh, fw)
                                            ).astype(np.int32)
    jb = {'normal': normal_gt, 'normal_fullres': unit((B, fh, fw, 3)),
          'dense_visual_embedding_lut': lut,
          'dense_visual_embedding_indices': rng.integers(
              0, L + 1, (B, h, w)).astype(np.int32),
          'semantic_fullres': rng.integers(0, n_classes + 1, (B, fh, fw)
                                           ).astype(np.int32)}
    tp = {k: (v if isinstance(v, tuple) else
              nchw(v) if v.ndim == 4 else t(v)) for k, v in jp.items()}
    tb = {k: (nchw(v) if v.ndim == 4 and k.startswith('normal') else t(v))
          for k, v in jb.items()}
    return jp, jb, tp, tb


def _helpers(f):
    colors = np.random.default_rng(0).integers(0, 255, (f['C'], 3))
    n, v = f['C'], f['is_thing_v']
    kw = dict(store_examples=True)
    pairs = {
        'semantic': lambda m: m.SemanticTaskHelper(
            n_classes=n, examples_cmap=colors, **kw),
        'instance': lambda m: m.InstanceTaskHelper(
            semantic_n_classes=n + 1, semantic_classes_is_thing=v,
            top_k_instances=64, **kw),
        'panoptic': lambda m: m.PanopticTaskHelper(
            semantic_n_classes=n + 1, semantic_classes_is_thing=v, **kw),
        'normal': lambda m: m.NormalTaskHelper(**kw),
        'dense_visual_embedding': lambda m: m.DenseVisualEmbeddingTaskHelper(
            n_classes=n, examples_cmap=colors, **kw)}
    return {k: (make(jtasks), make(tasks)) for k, make in pairs.items()}


def test_helpers_store_the_jax_example_images(fixture, panoptic):
    got, want = panoptic
    # the images of the score maps from the same scores
    got = dict(got, **{k: t(want[k]) for k in SCORE_KEYS
                       + ('semantic_segmentation_score',)})
    raw = fixture['raw']
    got['semantic_output'] = nchw(raw['semantic'])
    dense = _dense_tasks()
    for name, (jh, th) in _helpers(fixture).items():
        jpreds, jbatch, tpreds, tbatch = (
            dense if name in ('normal', 'dense_visual_embedding') else
            (want, fixture['jbatch'], got, fixture['tbatch']))
        jh.validation_step(jbatch, 0, jpreds)
        th.validation_step(tbatch, 0, tpreds)
        jh.validation_step(jbatch, 1, jpreds)          # not batch 0
        th.validation_step(tbatch, 1, tpreds)
        _, jex, _ = jh.validation_epoch_end()
        _, tex, _ = th.validation_epoch_end()
        assert jex and set(tex) == set(jex), name
        for key, img in jex.items():
            assert isinstance(img, Image.Image)
            assert tex[key].dtype == np.uint8, key
            equal(tex[key], np.asarray(img), key)


def test_dve_eager_validation_matches_fused_and_jax():
    n_classes = 10
    jh = jtasks.DenseVisualEmbeddingTaskHelper(n_classes=n_classes)
    th = tasks.DenseVisualEmbeddingTaskHelper(n_classes=n_classes)
    steps = [_dense_tasks(seed) for seed in (1, 2)]
    fused = None
    for i, (jp, jb, tp, tb) in enumerate(steps):
        jlosses, jlogs = jh.validation_step(jb, i, jp)
        tlosses, tlogs = th.validation_step(tb, i, tp)
        assert set(tlogs) == set(jlogs) and set(tlosses) == set(jlosses)
        assert 'dense_visual_embedding_step_time' in tlogs
        for k, v in jlosses.items():
            close(tlosses[k], v, k)
        fused = th.update_metric_states(fused, tb, tp)
    eager = th._eager_states
    for k in fused:
        assert torch.equal(eager[k], fused[k]), k
    equal(eager['text_cm'], jh._text_metric_iou.state, 'text_cm')
    equal(eager['visual_mean_cm'], jh._visual_mean_metric_iou.state,
          'visual_mean_cm')
    assert int(eager['text_cm'].sum()) > 0
    _, _, jlogs = jh.validation_epoch_end()
    _, _, tlogs = th.validation_epoch_end()
    assert set(tlogs) == set(jlogs)
    for k, v in jlogs.items():
        if not k.endswith('_time'):
            close(np.float32(tlogs[k]), v, k)
    # a fused epoch reports the states it was given
    th.load_metric_states(fused)
    _, _, logs = th.validation_epoch_end()
    close(np.float32(logs['dense_visual_embedding_text_miou']),
          jlogs['dense_visual_embedding_text_miou'], 'fused')


def test_training_step_logs_match_jax(fixture):
    raw = fixture['raw']
    jd, jdb, td, tdb = _dense_tasks()
    jpreds = dict(jd, semantic_output=raw['semantic'],
                  semantic_side_outputs=(),
                  instance_output=tuple(raw[k] for k in (
                      'heat', 'offset', 'orientation')),
                  instance_side_outputs=(), scene_output=raw['scene'])
    tpreds = dict(td, semantic_output=nchw(raw['semantic']),
                  semantic_side_outputs=(),
                  instance_output=tuple(nchw(raw[k]) for k in (
                      'heat', 'offset', 'orientation')),
                  instance_side_outputs=(), scene_output=t(raw['scene']))
    jbatch = dict(fixture['jbatch'], **{k: v for k, v in jdb.items()
                                        if k != 'semantic_fullres'})
    tbatch = dict(fixture['tbatch'], **{k: v for k, v in tdb.items()
                                        if k != 'semantic_fullres'})
    helpers = _helpers(fixture)
    helpers['scene'] = tuple(m.SceneTaskHelper(n_classes=raw['scene'].shape[1])
                             for m in (jtasks, tasks))
    for name, (jh, th) in helpers.items():
        jlosses, jlogs = jh.training_step(jbatch, 0, jpreds)
        tlosses, tlogs = th.training_step(tbatch, 0, tpreds)
        assert set(tlogs) == set(jlogs) and set(tlosses) == set(jlosses), \
            name
        assert f'{name}_step_time' in tlogs
        assert name == 'panoptic' or tlosses
        for k, v in jlosses.items():
            close(tlosses[k], v, k)
            assert not tlogs[k].requires_grad
            close(tlogs[k], v, k)


# --- the eval_dataset example -----------------------------------------------

def _direct_logs(pipeline, size, batch_size=2):
    """The fused eval step over the example's loader batches, outside
    the example."""
    from nicr_mtsa_tpu_torch.data import DataLoader
    from nicr_mtsa_tpu_torch.data.dataset import get_dataset
    from nicr_mtsa_tpu_torch.examples import eval_dataset as ex
    ds = get_dataset(str(FIXTURE), split='valid')
    ds.preprocessor = ex.eval_preprocessing(ds.config, *size)
    states = pipeline.empty_metric_states()
    for host in DataLoader(ds, batch_size=batch_size, num_workers=0):
        step = pipeline.make_fused_eval_step(
            {RESIZE: host[RESIZE]}, output_keys=())
        _, _, states = step(pre_strip(move_batch_to_device(host, 'cpu')),
                            states)
    logs = {}
    for name, helper in pipeline.task_helpers.items():
        helper.load_metric_states(states[name])
        logs.update(helper.validation_epoch_end()[2])
    return logs


def pre_strip(batch):
    from nicr_mtsa_tpu_torch.pipeline import strip_non_arrays
    return strip_non_arrays(batch)


def _printed(out):
    return {line.split(':')[0].strip(): float(line.split(':')[1])
            for line in out.splitlines() if line.startswith('  ')}


def test_eval_dataset_example(tmp_path, capsys):
    from nicr_mtsa_tpu_torch.data.dataset import get_dataset
    from nicr_mtsa_tpu_torch.examples import eval_dataset as ex
    from nicr_mtsa_tpu_torch.parallel import (StepCheckpointManager,
                                              save_checkpoint)
    size = (64, 96)
    argv = ['--cpu', '--dataset', str(FIXTURE), '--size', '64', '96']
    cfg = get_dataset(str(FIXTURE), split='valid').config

    logs = ex.main(argv)
    printed = _printed(capsys.readouterr().out)
    want = _direct_logs(ex.make_pipeline(cfg, *size, 'cpu'), size)
    assert set(printed) == {k for k, v in want.items()
                            if np.ndim(v) == 0 and 'time' not in k}
    for k, v in printed.items():
        np.testing.assert_equal(v, float(f'{float(want[k]):.4f}'),
                                err_msg=k)
        np.testing.assert_array_equal(np.asarray(logs[k]),
                                      np.asarray(want[k]), err_msg=k)
    for k in ('semantic_miou', 'panoptic_all_deeplab_pq', 'scene_acc'):
        assert np.isfinite(printed[k]) and 0 <= printed[k] <= 1

    # weights from a checkpoint file and from a step directory
    pipe = ex.make_pipeline(cfg, *size, 'cpu')
    with torch.no_grad():
        for p in pipe.model.parameters():
            p.mul_(1.5)
    state = pipe.create_train_state()
    path = save_checkpoint(str(tmp_path / 'weights'), state)
    mgr = StepCheckpointManager(str(tmp_path / 'steps'))
    mgr.save(7, state)
    mgr.wait_until_finished()
    want = _direct_logs(pipe, size)
    for ckpt in (path, str(tmp_path / 'steps')):
        logs = ex.main(argv + ['--checkpoint', ckpt])
        for k, v in want.items():
            np.testing.assert_array_equal(np.asarray(logs[k]), np.asarray(v),
                                          err_msg=k)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no CUDA device'):
            ex.main(argv[1:])

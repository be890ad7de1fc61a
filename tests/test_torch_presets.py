"""The six `bench.py --model` presets and `--quick` in the PyTorch/CUDA
port (nicr_mtsa_tpu_torch/configs.py `BENCH_CONFIGS`,
`pipeline.emsanet_bench_config(quick=True)`) against the JAX package,
on the CPU in f32:

- every preset under the JAX name with the JAX field values (the
  compute dtype named as a string), for every field both configs have;
- the parameter tree of each of the four dense presets (the
  single-rgb `resnet18_rgb_semantic`, the 37-class
  `rgbd_resnet34_nbt1d_semantic`, `panoptic_resnet34_nbt1d` without
  orientation, `emsanet`) leaf for leaf the JAX package's (shaped by
  `jax.eval_shape`): the strict map fills every leaf from a port
  tensor of its shape and uses every port parameter;
- `resnet18_rgb_semantic` forward (the single-backbone encoder on rgb
  alone) within rtol 1e-3 and 1e-5 of the largest |logit| (at full
  width the random logits reach ~300, where another f32 summation
  order moves a value by ~2e-3);
- `--quick` served end to end (2x ResNet-18 basic blocks, context 128,
  decoders (64, 48, 32) x 1, 128 x 160, both upsamplings deferred):
  `semantic_idx` and the panoptic maps agree on >= 99.9 % of pixels,
  scene logits within 1e-3 (the rule of test_torch_pipeline.py);
- serving a semantic-only preset raises KeyError('instance') in both
  packages (the JAX pipeline reads `predictions['instance']`);
- the instance task's metric update reads the full-resolution panoptic
  targets in both packages: on a batch without them both raise (a
  defect of the reference, pinned here, not guarded in the port)."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import _torch_port_helpers as hp
from nicr_mtsa_tpu import configs as j_configs
from nicr_mtsa_tpu.models.multi_task import (MultiTaskModelConfig as JConfig,
                                             build_model as jax_build)
from nicr_mtsa_tpu.pipeline import PanopticInferencePipeline as JPipe
from nicr_mtsa_tpu.postprocessing import (
    InstancePostprocessing, PanopticPostprocessing, SemanticPostprocessing,
)
from nicr_mtsa_tpu.tasks import InstanceTaskHelper as JInstanceHelper
from nicr_mtsa_tpu_torch import configs as t_configs
from nicr_mtsa_tpu_torch.models.multi_task import build_model
from nicr_mtsa_tpu_torch.pipeline import (PanopticInferencePipeline,
                                          emsanet_bench_config,
                                          serving_postprocessing)
from nicr_mtsa_tpu_torch.tasks import InstanceTaskHelper
from nicr_mtsa_tpu_torch.utils import flax_weights as fw

torch.set_num_threads(4)
H, W = 64, 96
TOL = dict(rtol=1e-3, atol=1e-3)
DENSE_PRESETS = ('resnet18_rgb_semantic', 'rgbd_resnet34_nbt1d_semantic',
                 'panoptic_resnet34_nbt1d', 'emsanet')
IS_THING = tuple(i < 8 for i in range(40))


def _frames(B, h, w, seed=0):
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 256, (B, h, w, 3), dtype=np.uint8)
    depth = rng.integers(0, 2 ** 16, (B, h, w), dtype=np.uint16)
    depth[:, :8] = 0
    return rgb, depth


def _jax_post():
    return PanopticPostprocessing(
        semantic_postprocessing=SemanticPostprocessing(),
        instance_postprocessing=InstancePostprocessing(
            heatmap_threshold=0.1, heatmap_nms_kernel_size=3,
            top_k_instances=64),
        semantic_classes_is_thing=IS_THING,
        semantic_class_has_orientation=IS_THING)


def test_bench_presets_match_jax_fields():
    assert list(t_configs.BENCH_CONFIGS) == list(j_configs.BENCH_CONFIGS)
    for name, jfn in j_configs.BENCH_CONFIGS.items():
        j, t = jfn(), t_configs.BENCH_CONFIGS[name]()
        for f in dataclasses.fields(j):
            if f.name == 'dtype':
                assert t.dtype == jnp.dtype(j.dtype).name, name
            elif hasattr(t, f.name):
                assert getattr(t, f.name) == getattr(j, f.name), (name,
                                                                  f.name)
    assert t_configs.resnet18_rgb_semantic().dtype == 'float32'
    assert t_configs.rgbd_resnet34_nbt1d_semantic().semantic_n_classes == 37


def _inputs(cfg, B=1, seed=None):
    keys = (('rgb', 3),) if cfg.backbone_depth is None else (
        ('rgb', 3), ('depth', 1))
    if seed is None:
        return {k: jnp.zeros((B, H, W, c)) for k, c in keys}
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=(B, H, W, c)).astype(np.float32)
            for k, c in keys}


@pytest.fixture(scope='module')
def trees():
    """name -> (JAX model, flax tree shapes, port model)."""
    out = {}
    for name in DENSE_PRESETS:
        jcfg = j_configs.BENCH_CONFIGS[name](input_size=(H, W),
                                             dtype=jnp.float32)
        jm = jax_build(jcfg)
        tmpl = jax.eval_shape(lambda: jm.init(
            {'params': jax.random.PRNGKey(0)}, _inputs(jcfg), train=False))
        tm = build_model(t_configs.BENCH_CONFIGS[name](
            input_size=(H, W), dtype='float32'), device='cpu')
        out[name] = (jm, tmpl, tm)
    return out


@pytest.mark.parametrize('name', DENSE_PRESETS)
def test_dense_preset_tree_matches_jax(trees, name):
    _, tmpl, tm = trees[name]
    # strict both ways: every leaf of the tree from a port tensor of its
    # shape, and every port tensor into a leaf
    v = fw.torch_to_flax_variables(tm, tmpl)
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), tmpl)
    assert jax.tree_util.tree_map(lambda a: tuple(a.shape), v) == shapes
    assert dict(fw.flax_tree_to_torch(v['params'])).keys() == dict(
        tm.named_parameters()).keys()


@pytest.fixture(scope='module')
def resnet18_rgb(trees):
    jm, tmpl, tm = trees['resnet18_rgb_semantic']
    v = fw.torch_to_flax_variables(tm, tmpl)
    v = {k: dict(c) for k, c in v.items()}
    hp._randomise(v, np.random.default_rng(2))
    fw.load_flax_variables(tm, v)
    return jm, v, tm


def test_resnet18_rgb_semantic_forward_matches_jax(resnet18_rgb):
    jm, v, tm = resnet18_rgb
    assert set(dict(tm.encoder.named_children())) == {'backbone'}
    x = _inputs(j_configs.resnet18_rgb_semantic(), B=2, seed=3)
    with jax.default_matmul_precision('highest'):
        want = jax.jit(lambda v, x: jm.apply(v, x, train=False))(
            v, {k: jnp.asarray(a) for k, a in x.items()})
    with torch.no_grad():
        got = tm({'rgb': hp.to_nchw(x['rgb'])})
    assert set(got) == set(want) == {'semantic'}
    want = np.asarray(want['semantic'][0])
    np.testing.assert_allclose(hp.to_nhwc(got['semantic'][0]), want,
                               rtol=1e-3, atol=1e-5 * np.abs(want).max())


def test_semantic_only_serving_raises_keyerror_in_both(resnet18_rgb):
    jm, v, tm = resnet18_rgb
    rgb, depth = _frames(1, H, W)
    with pytest.raises(KeyError, match='instance'):
        JPipe(jm, _jax_post(), compute_dtype=jnp.float32)(
            v, jnp.asarray(rgb), jnp.asarray(depth))
    tpipe = PanopticInferencePipeline(tm, serving_postprocessing(),
                                      compute_dtype=torch.float32)
    assert set(tpipe.preprocess(rgb, depth)) == {'rgb'}
    with pytest.raises(KeyError, match='instance'):
        tpipe(rgb, depth)


def test_quick_serving_matches_jax():
    # bench.py:558-584 with --quick and its default --defer4x, in f32
    jcfg = JConfig(
        tasks=('semantic', 'instance', 'orientation', 'scene'),
        backbone_rgb='resnet18', backbone_depth='resnet18',
        resnet_block='basicblock', context_n_channels=128,
        decoder_n_channels=(64, 48, 32), decoder_n_blocks=1,
        input_size=(128, 160), semantic_n_classes=40, scene_n_classes=10,
        upsampling='learned-3x3-zeropad',
        prediction_upsampling='learned-3x3-zeropad',
        defer_semantic_prediction_upsampling='all', dtype=jnp.float32)
    tcfg = emsanet_bench_config(quick=True, dtype='float32')
    assert tcfg.input_size == (128, 160)
    jm = jax_build(jcfg)
    tm = build_model(tcfg, device='cpu')
    x = {'rgb': jnp.zeros((1, 128, 160, 3)),
         'depth': jnp.zeros((1, 128, 160, 1))}
    v = fw.torch_to_flax_variables(tm, jax.eval_shape(lambda: jm.init(
        {'params': jax.random.PRNGKey(0)}, x, train=False)))
    v = {k: dict(c) for k, c in v.items()}
    hp._randomise(v, np.random.default_rng(4))
    fw.load_flax_variables(tm, v)
    rgb, depth = _frames(2, 128, 160, seed=5)
    with jax.default_matmul_precision('highest'):
        want = jax.tree_util.tree_map(np.asarray, JPipe(
            jm, _jax_post(), compute_dtype=jnp.float32)(
                v, jnp.asarray(rgb), jnp.asarray(depth)))
    got = PanopticInferencePipeline(
        tm, serving_postprocessing(), compute_dtype=torch.float32)(rgb, depth)
    assert set(got) == set(want)
    for k in ('semantic_idx', 'panoptic', 'panoptic_semantic'):
        assert got[k].shape == (2, 128, 160)
        agree = (got[k].numpy() == want[k]).mean()
        assert agree >= 0.999, (k, agree)
    np.testing.assert_allclose(got['scene_logits'].numpy(),
                               want['scene_logits'], **TOL)


def _instance_batch(with_panoptic: bool):
    rng = np.random.default_rng(0)
    sem = rng.integers(0, 9, (1, 16, 16)).astype(np.int32)
    ins = (rng.integers(0, 3, (1, 16, 16)) * (sem > 0)).astype(np.int32)
    batch = {'semantic_fullres': sem, 'instance_fullres': ins}
    pred = {'instance_segmentation_gt_foreground_fullres': ins}
    if with_panoptic:
        batch['panoptic_fullres'] = sem * 256 + ins
        batch['panoptic_segment_table_fullres'] = np.zeros((1, 128),
                                                           np.int32)
    return batch, pred


@pytest.mark.parametrize('with_panoptic', [True, False])
def test_instance_metric_update_needs_panoptic_targets_in_both(
        with_panoptic):
    """Both packages update the instance PQ state from a batch with the
    full-resolution panoptic targets; without them the JAX package's
    `jnp.asarray(None)` raises ValueError and the port's `None.to`
    AttributeError, after the same merge."""
    thing = (False,) + IS_THING[:8]
    jh = JInstanceHelper(semantic_n_classes=9,
                         semantic_classes_is_thing=thing)
    th = InstanceTaskHelper(semantic_n_classes=9,
                            semantic_classes_is_thing=thing)
    batch, pred = _instance_batch(with_panoptic)

    def jax_update():
        return jh.update_metric_states(
            None, {k: jnp.asarray(a) for k, a in batch.items()},
            {k: jnp.asarray(a) for k, a in pred.items()})

    def port_update():
        return th.update_metric_states(
            None, {k: torch.from_numpy(a) for k, a in batch.items()},
            {k: torch.from_numpy(a) for k, a in pred.items()})
    if with_panoptic:
        jstate, tstate = jax_update(), port_update()
        np.testing.assert_array_equal(
            tstate['pq']['tp_per_class'].numpy(),
            np.asarray(jstate['pq']['tp_per_class']))
        return
    with pytest.raises(ValueError, match='None'):
        jax_update()
    with pytest.raises(AttributeError, match='NoneType'):
        port_update()

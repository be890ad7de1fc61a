"""Postprocessing parity of the PyTorch port (nicr_mtsa_tpu_torch)
against the JAX package on the CPU: the SAME raw outputs (the JAX
model's, as numpy, and synthetic ones with tied heatmap maxima) go
through the JAX `PanopticPostprocessing` and the port's.

Integer maps, the centre table and the merge tables must be
bit-identical; the semantic score (an exp sum taken in another order)
matches to rtol 1e-5; orientation angles (f32 sums over an instance's
pixels in another order) to atol 1e-4 rad."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import _torch_port_helpers as hp
from nicr_mtsa_tpu.data.preprocessing.base import APPLIED_PREPROCESSING_KEY
from nicr_mtsa_tpu.models.upsampling import DeferredUpsampling2 as JD
from nicr_mtsa_tpu.ops.merge import deeplab_merge as j_merge
from nicr_mtsa_tpu.ops.nms import get_instance_centers as j_centers
from nicr_mtsa_tpu.postprocessing import (
    InstancePostprocessing as JInst,
    PanopticPostprocessing as JPan,
    ScenePostprocessing as JScene,
    SemanticPostprocessing as JSem,
)
from nicr_mtsa_tpu_torch.models.upsampling import DeferredUpsampling2 as TD
from nicr_mtsa_tpu_torch.ops.merge import deeplab_merge as t_merge
from nicr_mtsa_tpu_torch.ops.nms import get_instance_centers as t_centers
from nicr_mtsa_tpu_torch.pipeline import serving_postprocessing
from nicr_mtsa_tpu_torch.postprocessing import ScenePostprocessing as TScene

torch.set_num_threads(2)
IS_THING = tuple(i < hp.N_THING for i in range(hp.N_CLASSES))


def _jax_post():
    return JPan(semantic_postprocessing=JSem(),
                instance_postprocessing=JInst(
                    heatmap_threshold=0.1, heatmap_nms_kernel_size=3,
                    top_k_instances=64),
                semantic_classes_is_thing=IS_THING,
                semantic_class_has_orientation=IS_THING)


def _run_jax(sem, inst):
    """sem: JAX DeferredUpsampling2, inst: tuple of NHWC arrays."""
    B, h, w = sem.x.shape[:3]
    batch = {
        APPLIED_PREPROCESSING_KEY: [[{
            'type': 'Resize',
            'valid_region_slice_y': slice(0, 4 * h),
            'valid_region_slice_x': slice(0, 4 * w)}]],
        'rgb_fullres': np.zeros((B, 4 * h, 4 * w, 3), np.uint8),
    }
    post = _jax_post()
    with jax.default_matmul_precision('highest'):
        r = jax.jit(lambda s, i: post.postprocess(
            ((s, i), ((), ())), batch, is_training=False))(sem, inst)
    return jax.tree_util.tree_map(np.asarray, r)


def _run_port(sem, inst):
    post = serving_postprocessing(hp.N_CLASSES, hp.N_THING)
    d = TD(x=hp.to_nchw(np.asarray(sem.x)),
           kernel1=hp.hwio_to_torch(np.asarray(sem.kernel1)),
           bias1=torch.from_numpy(np.array(sem.bias1)),
           kernel2=hp.hwio_to_torch(np.asarray(sem.kernel2)),
           bias2=torch.from_numpy(np.array(sem.bias2)))
    i = tuple(hp.to_nchw(np.asarray(a)) for a in inst)
    r = post.postprocess(((d, i), ((), ())))
    return r


def _compare(rj, rt):
    for key in ('semantic_segmentation_idx', 'panoptic_foreground_mask',
                'panoptic_segmentation_deeplab',
                'panoptic_segmentation_deeplab_semantic_idx',
                'panoptic_segmentation_deeplab_instance_idx',
                'panoptic_segmentation_deeplab_ids'):
        np.testing.assert_array_equal(rt[key].numpy(), rj[key], err_msg=key)
    mj = rj['panoptic_segmentation_deeplab_instance_meta']
    mt = rt['panoptic_segmentation_deeplab_instance_meta']
    assert set(mj) == set(mt)
    for key in mj:
        np.testing.assert_array_equal(mt[key].numpy(), mj[key],
                                      err_msg=key)
    np.testing.assert_allclose(rt['semantic_segmentation_score'].numpy(),
                               rj['semantic_segmentation_score'],
                               rtol=1e-5)
    key = 'orientations_panoptic_segmentation_deeplab_instance'
    used = mj['areas'] > 0
    np.testing.assert_allclose(rt[key].numpy()[used], rj[key][used],
                               atol=1e-4)


@pytest.fixture(scope='module')
def model_outputs():
    jm = hp.jax_model('all')
    v = hp.jax_variables(jm, seed=2)
    rgb, depth = hp.inputs(2)
    with jax.default_matmul_precision('highest'):
        out = jax.jit(lambda v, r, d: jm.apply(
            v, {'rgb': r, 'depth': d}, train=False))(v, rgb, depth)
    return out['semantic'][0], out['instance'][0]


def test_postprocessing_on_model_outputs(model_outputs):
    sem, inst = model_outputs
    _compare(_run_jax(sem, inst), _run_port(sem, inst))


def _synthetic_outputs(seed, B=2, h=24, w=32, C=hp.N_CLASSES):
    """Raw outputs with many instances: quarter-res logits biased to
    thing classes, a heatmap of quantised blobs (plateaus of tied
    maxima), offsets pointing at the blob centres."""
    rng = np.random.default_rng(seed)
    H, W = 4 * h, 4 * w
    x = rng.normal(size=(B, h, w, C)).astype(np.float32)
    x[..., :hp.N_THING] += 1.0
    k = [rng.normal(0, 0.3, size=(3, 3, 1, C)).astype(np.float32)
         for _ in range(2)]
    b = [rng.normal(0, 0.1, size=(C,)).astype(np.float32)
         for _ in range(2)]
    sem = JD(x=jnp.asarray(x), kernel1=jnp.asarray(k[0]),
             bias1=jnp.asarray(b[0]), kernel2=jnp.asarray(k[1]),
             bias2=jnp.asarray(b[1]))
    yy, xx = np.mgrid[:H, :W].astype(np.float32)
    heat = np.zeros((B, H, W), np.float32)
    off = np.zeros((B, H, W, 2), np.float32)
    best = np.full((B, H, W), np.inf, np.float32)
    for bi in range(B):
        for cy, cx in rng.uniform((0, 0), (H, W), (40, 2)):
            d2 = (yy - cy) ** 2 + (xx - cx) ** 2
            heat[bi] = np.maximum(heat[bi], np.exp(-d2 / 50.0))
            near = d2 < best[bi]
            best[bi] = np.where(near, d2, best[bi])
            off[bi, ..., 0] = np.where(near, (cy - yy) / H, off[bi, ..., 0])
            off[bi, ..., 1] = np.where(near, (cx - xx) / W, off[bi, ..., 1])
    heat = np.round(heat * 8) / 8           # plateaus: tied maxima
    ang = rng.uniform(-np.pi, np.pi, (B, H, W))
    ori = np.stack([np.cos(ang), np.sin(ang)], -1).astype(np.float32)
    inst = (jnp.asarray(heat[..., None]), jnp.asarray(off),
            jnp.asarray(ori))
    return sem, inst


@pytest.mark.parametrize('seed', [0, 1])
def test_postprocessing_on_synthetic_outputs(seed):
    sem, inst = _synthetic_outputs(seed)
    rj = _run_jax(sem, inst)
    rt = _run_port(sem, inst)
    assert rj['panoptic_segmentation_deeplab_instance_meta'][
        'valid'].sum() > 10
    _compare(rj, rt)


@pytest.mark.parametrize('shape', [(2, 96, 128), (2, 37, 51)])
def test_instance_centers_with_ties(shape):
    rng = np.random.default_rng(3)
    # quantised values: many tied maxima, inside and across 2x2 blocks
    heat = (rng.integers(0, 6, shape) / 5.0).astype(np.float32)
    want = j_centers(jnp.asarray(heat), threshold=0.1, kernel_size=3,
                     top_k=64)
    got = t_centers(torch.from_numpy(heat), threshold=0.1, kernel_size=3,
                    top_k=64)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got.valid.all()          # the 64 slots are full of ties


def test_deeplab_merge_matches():
    rng = np.random.default_rng(4)
    B, H, W, K, C = 2, 32, 48, 16, 11
    sem = rng.integers(0, C, (B, H, W)).astype(np.int32)
    ins = rng.integers(0, K + 1, (B, H, W)).astype(np.int32)
    fg = rng.random((B, H, W)) > 0.3
    thing = np.array([False] + [i < 5 for i in range(C - 1)])
    want = j_merge(jnp.asarray(sem), jnp.asarray(ins), jnp.asarray(fg),
                   jnp.asarray(thing), top_k=K, n_classes_with_void=C)
    got = t_merge(torch.from_numpy(sem), torch.from_numpy(ins),
                  torch.from_numpy(fg), torch.from_numpy(thing), top_k=K,
                  n_classes_with_void=C)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_deeplab_merge_majority_tie_smallest_class():
    # instance 1 has two pixels of class 3 and two of class 2: class 2
    sem = np.array([[[3, 2, 3, 2]]], np.int32)
    ins = np.ones((1, 1, 4), np.int32)
    fg = np.ones((1, 1, 4), bool)
    thing = np.array([False, True, True, True])
    got = t_merge(torch.from_numpy(sem), torch.from_numpy(ins),
                  torch.from_numpy(fg), torch.from_numpy(thing), top_k=2,
                  n_classes_with_void=4)
    assert got.instance_class[0, 1].item() == 2
    assert (got.panoptic.numpy() == 2 * 65536 + 1).all()


def test_scene_postprocessing():
    logits = np.random.default_rng(5).normal(size=(4, 10))
    logits = logits.astype(np.float32)
    logits[0, 3] = logits[0, 7] = 9.0           # tie -> first
    want = JScene().postprocess((jnp.asarray(logits), ()), {}, False)
    got = TScene().postprocess((torch.from_numpy(logits), ()))
    np.testing.assert_array_equal(got['scene_class_idx'].numpy(),
                                  np.asarray(want['scene_class_idx']))
    np.testing.assert_array_equal(got['scene_output'].numpy(), logits)
    np.testing.assert_allclose(got['scene_class_score'].numpy(),
                               np.asarray(want['scene_class_score']),
                               rtol=1e-6)

"""Slice parity of the PyTorch port (nicr_mtsa_tpu_torch): the same
uint8 RGB / uint16 depth batch through the JAX `PanopticInferencePipeline`
(f32 compute) and the port's pipeline (f32, CPU) on the same weights.

`semantic_idx` and `panoptic` must agree on >= 99.9 % of pixels, not
all: both models are f32, but their sums are taken in another order,
which moves logits by ~1e-5 and flips pixels whose top two classes are
that close. Scene logits agree to 1e-3 (the model tolerance)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import _torch_port_helpers as hp
from nicr_mtsa_tpu.pipeline import PanopticInferencePipeline as JPipe
from nicr_mtsa_tpu.postprocessing import (
    InstancePostprocessing, PanopticPostprocessing, SemanticPostprocessing,
)
from nicr_mtsa_tpu_torch.pipeline import (
    PanopticInferencePipeline, depth_to_int32, serving_postprocessing,
)
from nicr_mtsa_tpu_torch.utils.flax_weights import load_flax_variables

torch.set_num_threads(2)
IS_THING = tuple(i < hp.N_THING for i in range(hp.N_CLASSES))


def _frames(seed=0, B=2):
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 256, (B, hp.H, hp.W, 3), dtype=np.uint8)
    depth = rng.integers(0, 2 ** 16, (B, hp.H, hp.W), dtype=np.uint16)
    depth[:, :8] = 0                       # invalid depth
    depth[:, 8:12] = 65535
    return rgb, depth


@pytest.fixture(scope='module')
def pipelines():
    jm = hp.jax_model('all')
    v = hp.jax_variables(jm, seed=1)
    jpost = PanopticPostprocessing(
        semantic_postprocessing=SemanticPostprocessing(),
        instance_postprocessing=InstancePostprocessing(
            heatmap_threshold=0.1, heatmap_nms_kernel_size=3,
            top_k_instances=64),
        semantic_classes_is_thing=IS_THING,
        semantic_class_has_orientation=IS_THING)
    jpipe = JPipe(jm, jpost, compute_dtype=jnp.float32)
    tm = hp.torch_model('all')
    load_flax_variables(tm, v)
    tpipe = PanopticInferencePipeline(
        tm, serving_postprocessing(hp.N_CLASSES, hp.N_THING),
        compute_dtype=torch.float32)
    return jpipe, v, tpipe


def test_preprocess_matches(pipelines):
    jpipe, _, tpipe = pipelines
    rgb, depth = _frames(3)
    want = jpipe.preprocess(jnp.asarray(rgb), jnp.asarray(depth))
    for d in (depth, torch.from_numpy(depth)):      # numpy and torch u16
        got = tpipe.preprocess(rgb, d)
        for k in ('rgb', 'depth'):
            np.testing.assert_array_equal(hp.to_nhwc(got[k]),
                                          np.asarray(want[k]))


def test_depth_to_int32():
    d = np.array([[0, 1, 32767, 32768, 65535]], np.uint16)
    want = d.astype(np.int32)
    for t in (torch.from_numpy(d), torch.from_numpy(d.view(np.int16)),
              torch.from_numpy(d.astype(np.int32))):
        got = depth_to_int32(t)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_serving_slice_matches(pipelines):
    jpipe, v, tpipe = pipelines
    rgb, depth = _frames(0)
    with jax.default_matmul_precision('highest'):
        want = jax.tree_util.tree_map(
            np.asarray, jpipe(v, jnp.asarray(rgb), jnp.asarray(depth)))
    got = tpipe(rgb, depth)
    assert set(got) == set(want)
    for k in ('panoptic', 'panoptic_semantic', 'panoptic_instance',
              'semantic_idx'):
        assert got[k].shape == (2, hp.H, hp.W)
        assert got[k].dtype == torch.int32
    for k in ('semantic_idx', 'panoptic', 'panoptic_semantic'):
        agree = (got[k].numpy() == want[k]).mean()
        assert agree >= 0.999, (k, agree)
    np.testing.assert_allclose(got['scene_logits'].numpy(),
                               want['scene_logits'], rtol=1e-3, atol=1e-3)
    same = got['semantic_idx'].numpy() == want['semantic_idx']
    np.testing.assert_allclose(got['semantic_score'].numpy()[same],
                               want['semantic_score'][same], rtol=1e-3)


def test_channels_last_layout_same_outputs(pipelines):
    """The card's NHWC layout (activations and conv weights), run here
    on the CPU: the same maps up to near-tie pixels."""
    _, v, tpipe = pipelines
    tm = hp.torch_model('all')
    load_flax_variables(tm, v)
    nhwc = PanopticInferencePipeline(
        tm, serving_postprocessing(hp.N_CLASSES, hp.N_THING),
        compute_dtype=torch.float32, channels_last=True)
    assert tm.encoder.backbone_depth.conv1.weight.is_contiguous(
        memory_format=torch.channels_last)
    rgb, depth = _frames(4, B=1)
    want, got = tpipe(rgb, depth), nhwc(rgb, depth)
    for k in ('semantic_idx', 'panoptic'):
        assert (got[k] == want[k]).float().mean().item() >= 0.999, k


def test_entry_points_need_cuda_unless_cpu_asked(monkeypatch):
    from nicr_mtsa_tpu_torch.pipeline import build_serving_pipeline
    from nicr_mtsa_tpu_torch.utils.device import resolve_device
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        resolve_device(None)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        build_serving_pipeline()
    assert resolve_device('cpu').type == 'cpu'


@pytest.mark.cuda
def test_depth_to_int32_on_card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    d = np.array([[0, 1, 32768, 65535]], np.uint16)
    got = depth_to_int32(torch.from_numpy(d).cuda())
    np.testing.assert_array_equal(got.cpu().numpy(), d.astype(np.int32))

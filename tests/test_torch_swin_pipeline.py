"""Slice parity of the EMSAFormer serving path in the PyTorch/CUDA port
(nicr_mtsa_tpu_torch): the same uint8 RGB / uint16 depth frames through
the JAX `PanopticInferencePipeline` and the port's, on the same weights
(the `emsaformer_dve_v2` preset at full width, 64 x 96, f32 on the CPU,
both semantic prediction upsamplings deferred to the bilinear 4x
finisher, the bench's serving postprocessing).

`semantic_idx` must agree on >= 99.9 % of pixels (f32 sums in another
order flip pixels whose top two classes are that close), and the
panoptic and instance maps wherever the semantic map agrees; the scene
logits and the dense visual embedding (asked for as an extra output)
within the model tolerance 1e-3."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_port_helpers import _randomise, to_nhwc
from nicr_mtsa_tpu.configs import emsaformer_dve_v2
from nicr_mtsa_tpu.models.multi_task import build_model as jax_build
from nicr_mtsa_tpu.pipeline import PanopticInferencePipeline as JPipe
from nicr_mtsa_tpu.postprocessing import (
    InstancePostprocessing, PanopticPostprocessing, SemanticPostprocessing,
)
from nicr_mtsa_tpu_torch.pipeline import (
    PanopticInferencePipeline, build_serving_pipeline,
    emsaformer_bench_config, serving_postprocessing,
)
from nicr_mtsa_tpu_torch.utils.flax_weights import (load_flax_variables,
                                                  torch_to_flax_variables)

torch.set_num_threads(2)
H, W = 64, 96
N_CLASSES, N_THING = 40, 8
IS_THING = tuple(i < N_THING for i in range(N_CLASSES))
DVE = 'dense_visual_embedding'


def _frames(seed=0, B=2):
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8)
    depth = rng.integers(0, 2 ** 16, (B, H, W), dtype=np.uint16)
    depth[:, :8] = 0                       # invalid depth
    return rgb, depth


def _torch_pipe(v, channels_last=None, extra=(DVE,)):
    cfg = emsaformer_bench_config((H, W), 'float32')
    pipe = build_serving_pipeline(cfg, device='cpu', seed=0,
                                  extra_output_tasks=extra)
    load_flax_variables(pipe.model, v)
    if channels_last:
        return PanopticInferencePipeline(
            pipe.model, serving_postprocessing(N_CLASSES, N_THING),
            compute_dtype=torch.float32, channels_last=True)
    return pipe


@pytest.fixture(scope='module')
def pipelines():
    jm = jax_build(dataclasses.replace(
        emsaformer_dve_v2(input_size=(H, W), dtype=jnp.float32),
        defer_semantic_prediction_upsampling='all'))
    # the tree shaped without a compiled init, filled from the port's
    # seeded model
    template = jax.eval_shape(lambda: jm.init(
        {'params': jax.random.PRNGKey(0)}, {'rgbd': jnp.zeros((1, H, W, 4))},
        train=False))
    v = torch_to_flax_variables(build_serving_pipeline(
        emsaformer_bench_config((H, W), 'float32'), device='cpu',
        seed=0).model, template)
    v = {k: dict(c) for k, c in v.items()}
    _randomise(v, np.random.default_rng(1))
    jpost = PanopticPostprocessing(
        semantic_postprocessing=SemanticPostprocessing(),
        instance_postprocessing=InstancePostprocessing(
            heatmap_threshold=0.1, heatmap_nms_kernel_size=3,
            top_k_instances=64),
        semantic_classes_is_thing=IS_THING,
        semantic_class_has_orientation=IS_THING)
    jpipe = JPipe(jm, jpost, compute_dtype=jnp.float32,
                  extra_output_tasks=(DVE,))
    return jpipe, v, _torch_pipe(v)


@pytest.fixture(scope='module')
def served(pipelines):
    jpipe, v, tpipe = pipelines
    rgb, depth = _frames(0)
    with jax.default_matmul_precision('highest'):
        want = jax.tree_util.tree_map(
            np.asarray, jpipe(v, jnp.asarray(rgb), jnp.asarray(depth)))
    return want, tpipe(rgb, depth)


def test_preprocess_emits_rgbd(pipelines):
    jpipe, _, tpipe = pipelines
    rgb, depth = _frames(3)
    want = jpipe.preprocess(jnp.asarray(rgb), jnp.asarray(depth))
    got = tpipe.preprocess(rgb, depth)
    assert set(got) == set(want) == {'rgbd'}
    np.testing.assert_array_equal(to_nhwc(got['rgbd']),
                                  np.asarray(want['rgbd']))


def test_swin_serving_maps_match(served):
    want, got = served
    assert set(got) == set(want)
    for k in ('panoptic', 'panoptic_semantic', 'panoptic_instance',
              'semantic_idx'):
        assert got[k].shape == (2, H, W) and got[k].dtype == torch.int32
    agree = (got['semantic_idx'].numpy() == want['semantic_idx']).mean()
    assert agree >= 0.999, agree
    same = got['semantic_idx'].numpy() == want['semantic_idx']
    for k in ('panoptic', 'panoptic_semantic', 'panoptic_instance'):
        np.testing.assert_array_equal(got[k].numpy()[same], want[k][same])
    np.testing.assert_allclose(got['semantic_score'].numpy()[same],
                               want['semantic_score'][same], rtol=1e-3)


def test_swin_serving_scene_and_embedding_match(served):
    want, got = served
    np.testing.assert_allclose(got['scene_logits'].numpy(),
                               want['scene_logits'], rtol=0, atol=1e-3)
    e_t, e_j = to_nhwc(got[f'{DVE}_output']), want[f'{DVE}_output']
    assert e_t.shape == e_j.shape == (2, H, W, 512)
    np.testing.assert_allclose(e_t, e_j, rtol=0,
                               atol=1e-3 * np.abs(e_j).max())


def test_swin_serving_without_extra_outputs(pipelines):
    """The default serving dict has no embedding: its decoder does not
    run; the maps are those of the pipeline that computed it."""
    _, v, tpipe = pipelines
    plain = _torch_pipe(v, extra=())
    rgb, depth = _frames(5, B=1)
    got, ref = plain(rgb, depth), tpipe(rgb, depth)
    assert f'{DVE}_output' not in got
    for k in ('semantic_idx', 'panoptic', 'panoptic_instance'):
        assert torch.equal(got[k], ref[k]), k


def test_swin_channels_last_layout_same_outputs(pipelines):
    """The card's layout (channels-last activations and conv weights;
    the Swin blocks then read their NHWC views without a copy), run
    here on the CPU: the same maps up to near-tie pixels."""
    _, v, tpipe = pipelines
    nhwc = _torch_pipe(v, channels_last=True)
    rgb, depth = _frames(4, B=1)
    want, got = tpipe(rgb, depth), nhwc(rgb, depth)
    for k in ('semantic_idx', 'panoptic'):
        assert (got[k] == want[k]).float().mean().item() >= 0.999, k


def test_swin_entry_point_needs_cuda_unless_cpu_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        build_serving_pipeline(emsaformer_bench_config((H, W)))


@pytest.mark.cuda
def test_swin_serving_on_card_launches_kernels():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from nicr_mtsa_tpu_torch.ops import cuda as kernels
    pipe = build_serving_pipeline(emsaformer_bench_config((H, W)),
                                  device='cuda', seed=0)
    rgb, depth = _frames(6)
    kernels.reset_launch_counts()
    out = pipe(rgb, depth)
    torch.cuda.synchronize()
    counts = {k: f.launches for k, f in kernels.KERNELS.items()}
    assert counts['window_attention_block'] == 12
    assert counts['finisher4x_bilinear'] == 1 and counts['grouping'] == 1
    assert counts['layernorm'] == 36
    assert out['semantic_idx'].shape == (2, H, W)

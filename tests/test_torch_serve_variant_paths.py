"""Parity of the two opt-in serving variants in the PyTorch/CUDA port
(nicr_mtsa_tpu_torch) with the JAX package, on the CPU in f32, on the
same weights: the port's seeded initialisation with its norms and
biases randomised, as flax variables shaped by the JAX model's
`jax.eval_shape(init)` (no compiled JAX init: that alone takes ~20 s
here), loaded back with the strict `load_flax_variables`.

- EMSANet `--no-defer4x` (`defer_semantic_prediction_upsampling=True`,
  the small configuration of `_torch_port_helpers`): the semantic
  head's `DeferredUpsampling` fields within 1e-3 (x) and exactly (the
  weights); the JAX `defer=True` tree loads strictly into the port's
  models of every deferral; the served `semantic_idx` and `panoptic`
  agree with the JAX pipeline on >= 99.9 % of pixels (f32 sums in
  another order flip pixels whose top two classes are that close), as
  test_torch_pipeline.py requires of the default variant.
- EMSAFormer `--attn-qkv` (`backbone_attn_backend='qkv'`): the small
  Swin of test_torch_swin_model.py (embed 32, depths (2, 2, 2, 2)) with
  the 'qkv' backend against the JAX backbone with 'pallas-qkv-interpret'
  within 1e-3 at every stage; 'qkv' against the port's own 'auto'
  within 1e-4 (v2 multimodal and v1 RGB); the `emsaformer_dve_v2`
  preset at full width (64 x 96) served with 'qkv' agrees with the JAX
  pipeline (through its XLA attention) on >= 99.9 % of pixels; 'qkv'
  in training mode and an unknown backend raise."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import _torch_port_helpers as hp
from nicr_mtsa_tpu.configs import emsaformer_dve_v2
from nicr_mtsa_tpu.models.backbones.swin import SwinBackbone
from nicr_mtsa_tpu.models.multi_task import build_model as jax_build
from nicr_mtsa_tpu.pipeline import PanopticInferencePipeline as JPipe
from nicr_mtsa_tpu.postprocessing import (
    InstancePostprocessing, PanopticPostprocessing, SemanticPostprocessing,
)
from nicr_mtsa_tpu_torch.models.backbones.swin import (
    SwinBackbone as TSwinBackbone,
)
from nicr_mtsa_tpu_torch.models.multi_task import (
    MultiTaskModelConfig, build_model as torch_build,
)
from nicr_mtsa_tpu_torch.models.upsampling import DeferredUpsampling
from nicr_mtsa_tpu_torch.pipeline import (
    PanopticInferencePipeline, build_serving_pipeline,
    emsaformer_bench_config, emsanet_bench_config, serving_postprocessing,
)
from nicr_mtsa_tpu_torch.utils.flax_weights import (
    load_flax_variables, torch_to_flax_variables,
)

torch.set_num_threads(2)
IS_THING = tuple(i < hp.N_THING for i in range(hp.N_CLASSES))


def _jax_post():
    return PanopticPostprocessing(
        semantic_postprocessing=SemanticPostprocessing(),
        instance_postprocessing=InstancePostprocessing(
            heatmap_threshold=0.1, heatmap_nms_kernel_size=3,
            top_k_instances=64),
        semantic_classes_is_thing=IS_THING,
        semantic_class_has_orientation=IS_THING)


def _shared_variables(init, port, seed=1):
    """Flax variables shaped like `init(key)`'s output, filled from the
    port's module `port` with its norms, scales and biases randomised
    (`_randomise`), and loaded back into `port` strictly."""
    template = jax.eval_shape(init, jax.random.PRNGKey(0))
    v = torch_to_flax_variables(port, template)
    hp._randomise(v, np.random.default_rng(seed))
    load_flax_variables(port, v)
    return v


def _frames(H, W, seed=0, B=2):
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8)
    depth = rng.integers(0, 2 ** 16, (B, H, W), dtype=np.uint16)
    depth[:, :8] = 0                       # invalid depth
    return rgb, depth


def _maps_agree(got, want, H, W):
    for k in ('panoptic', 'panoptic_semantic', 'panoptic_instance',
              'semantic_idx'):
        assert got[k].shape == (2, H, W) and got[k].dtype == torch.int32, k
    for k in ('semantic_idx', 'panoptic'):
        agree = (got[k].numpy() == want[k]).mean()
        assert agree >= 0.999, (k, agree)


# --- EMSANet --no-defer4x ----------------------------------------------------

@pytest.fixture(scope='module')
def emsanet():
    jm = hp.jax_model(True)
    tm = hp.torch_model(True)
    x = {'rgb': jnp.zeros((1, hp.H, hp.W, 3)),
         'depth': jnp.zeros((1, hp.H, hp.W, 1))}
    v = _shared_variables(
        lambda k: jm.init({'params': k}, x, train=False), tm)
    return jm, v, tm


def test_emsanet_defer2x_config(emsanet):
    assert emsanet_bench_config(
        defer=True).defer_semantic_prediction_upsampling is True
    head = emsanet[2].semantic_decoder.task_head
    assert head.defer_last and not head.defer_all


def test_emsanet_deferred_fields_match(emsanet):
    jm, v, tm = emsanet
    rgb, depth = hp.inputs()
    with jax.default_matmul_precision('highest'):
        dj = jax.jit(lambda v, r, d: jm.apply(
            v, {'rgb': r, 'depth': d}, train=False))(v, rgb, depth)[
                'semantic'][0]
    with torch.no_grad():
        dt = tm({'rgb': hp.to_nchw(rgb), 'depth': hp.to_nchw(depth)},
                outputs=('semantic',))['semantic'][0]
    assert isinstance(dt, DeferredUpsampling)
    assert dt.x.shape == (2, hp.N_CLASSES, hp.H // 2, hp.W // 2)
    np.testing.assert_allclose(hp.to_nhwc(dt.x), np.asarray(dj.x),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(dt.kernel.detach().numpy(),
                                  np.asarray(dj.kernel).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(dt.bias.detach().numpy(),
                                  np.asarray(dj.bias))


def test_emsanet_defer2x_loads_strictly_into_every_deferral(emsanet):
    """The parameter tree does not depend on the deferral: the variables
    shaped like the JAX `defer=True` tree fill the port's models of every
    setting."""
    _, v, tm = emsanet
    for defer in (False, True, 'all'):
        other = hp.torch_model(defer)
        load_flax_variables(other, v)
        for (n, a), (m, b) in zip(other.state_dict().items(),
                                  tm.state_dict().items()):
            assert n == m and torch.equal(a, b), n


def test_emsanet_defer2x_serving_maps_match(emsanet):
    jm, v, tm = emsanet
    jpipe = JPipe(jm, _jax_post(), compute_dtype=jnp.float32)
    tpipe = PanopticInferencePipeline(
        tm, serving_postprocessing(hp.N_CLASSES, hp.N_THING),
        compute_dtype=torch.float32)
    rgb, depth = _frames(hp.H, hp.W)
    with jax.default_matmul_precision('highest'):
        want = jax.tree_util.tree_map(
            np.asarray, jpipe(v, jnp.asarray(rgb), jnp.asarray(depth)))
    got = tpipe(rgb, depth)
    assert set(got) == set(want)
    _maps_agree(got, want, hp.H, hp.W)


# --- EMSAFormer --attn-qkv ---------------------------------------------------

H, W = 64, 96
BACKBONES = {
    'v2_multimodal': dict(embed_dim=32, depths=(2, 2, 2, 2),
                          n_heads=(1, 2, 4, 8), window_size=8, v2=True,
                          n_input_channels=4, multimodal=True,
                          embed_dim_depth=16),
    'v1_rgb': dict(embed_dim=32, depths=(2, 2, 2, 2), n_heads=(1, 2, 4, 8),
                   window_size=7, v2=False, n_input_channels=3),
}


def _stages(backbone, x):
    with torch.no_grad():
        y = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
        out = []
        for i in range(backbone.n_stages):
            y = backbone.forward_stage(i, y)
            out.append(hp.to_nhwc(y))
    return out


@pytest.fixture(scope='module')
def swin():
    """name -> (kw, input, flax variables, {backend: port backbone})."""
    cases = {}
    for name, kw in BACKBONES.items():
        x = np.random.default_rng(3).normal(
            size=(2, H, W, kw['n_input_channels'])).astype(np.float32)
        jb = SwinBackbone(stochastic_depth=0.0, **kw)
        ports = {b: TSwinBackbone(attn_backend=b, **kw).eval()
                 for b in ('auto', 'qkv')}
        v = _shared_variables(lambda k: jb.init(k, jnp.asarray(x)),
                              ports['auto'])
        load_flax_variables(ports['qkv'], v)
        cases[name] = (kw, x, v, ports)
    return cases


def test_swin_qkv_backbone_matches_pallas_qkv_interpret(swin):
    """The serving preset's kind of backbone (v2, multimodal)."""
    kw, x, v, ports = swin['v2_multimodal']
    jb = SwinBackbone(stochastic_depth=0.0,
                      attn_backend='pallas-qkv-interpret', **kw)
    with jax.default_matmul_precision('highest'):
        want = [np.asarray(o) for o in jax.jit(jb.apply)(v, jnp.asarray(x))]
    got = _stages(ports['qkv'], x)
    for stage, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape, stage
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-3,
                                   err_msg=f'stage {stage}')


@pytest.mark.parametrize('name', sorted(BACKBONES))
def test_swin_qkv_matches_auto(swin, name):
    _, x, _, ports = swin[name]
    for stage, (a, b) in enumerate(zip(_stages(ports['qkv'], x),
                                       _stages(ports['auto'], x))):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4,
                                   err_msg=f'stage {stage}')


def test_swin_qkv_refuses_training(swin):
    _, x, _, ports = swin['v2_multimodal']
    ports['qkv'].train()
    try:
        with pytest.raises(RuntimeError, match='inference only'):
            ports['qkv'].forward_stage(1, ports['qkv'].forward_stage(
                0, torch.from_numpy(np.ascontiguousarray(
                    x.transpose(0, 3, 1, 2)))))
    finally:
        ports['qkv'].eval()


def test_unknown_attention_backend_raises():
    with pytest.raises(ValueError, match="'auto', 'qkv'"):
        TSwinBackbone(attn_backend='pallas-block', **BACKBONES['v1_rgb'])
    with pytest.raises(ValueError, match="'auto', 'qkv'"):
        torch_build(MultiTaskModelConfig(backbone_attn_backend='xla',
                                         **hp.CONFIG_KWARGS), device='cpu')
    assert emsaformer_bench_config(
        attn_backend='qkv').backbone_attn_backend == 'qkv'


def test_emsaformer_qkv_serving_maps_match():
    jm = jax_build(dataclasses.replace(
        emsaformer_dve_v2(input_size=(H, W), dtype=jnp.float32),
        defer_semantic_prediction_upsampling='all'))
    jpipe = JPipe(jm, _jax_post(), compute_dtype=jnp.float32)
    tpipe = build_serving_pipeline(
        emsaformer_bench_config((H, W), 'float32', attn_backend='qkv'),
        device='cpu', seed=0)
    v = _shared_variables(lambda k: jm.init(
        {'params': k}, {'rgbd': jnp.zeros((1, H, W, 4))}, train=False),
        tpipe.model)
    rgb, depth = _frames(H, W, seed=2)
    with jax.default_matmul_precision('highest'):
        want = jax.tree_util.tree_map(
            np.asarray, jpipe(v, jnp.asarray(rgb), jnp.asarray(depth)))
    got = tpipe(rgb, depth)
    assert set(got) == set(want)
    _maps_agree(got, want, H, W)
    np.testing.assert_allclose(got['scene_logits'].numpy(),
                               want['scene_logits'], rtol=0, atol=1e-3)


@pytest.mark.cuda
def test_serve_variants_on_card_launch_their_kernels():
    """One request of each variant on the card at 64 x 96: 1 finisher2x
    and no finisher4x launch; 12 window_attention_qkv and no
    window_attention_block launches."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from nicr_mtsa_tpu_torch.ops import cuda as kernels
    rgb, depth = _frames(H, W, seed=6)
    for cfg, want in (
            (emsanet_bench_config((H, W), defer=True),
             {'finisher2x': 1, 'finisher4x': 0, 'grouping': 1}),
            (emsaformer_bench_config((H, W), attn_backend='qkv'),
             {'window_attention_qkv': 12, 'window_attention_block': 0,
              'layernorm': 36, 'finisher4x_bilinear': 1, 'grouping': 1})):
        pipe = build_serving_pipeline(cfg, device='cuda', seed=0)
        kernels.reset_launch_counts()
        out = pipe(rgb, depth)
        torch.cuda.synchronize()
        assert {k: kernels.KERNELS[k].launches for k in want} == want
        assert out['semantic_idx'].shape == (2, H, W)

"""Model parity of the EMSAFormer family in the PyTorch/CUDA port
(nicr_mtsa_tpu_torch) with the JAX package, on the CPU in f32.

Weights are flax variables with randomised norms and biases (the
port's seeded init in the tree `jax.eval_shape` shapes, with no
compiled JAX init) carried across with the strict
`load_flax_variables`:
- a small Swin backbone built directly on both sides (embed 32, depths
  (2, 2, 2, 2), head width 32), v2 multimodal RGB-D and v1 RGB: every
  stage output within 1e-3;
- the `emsaformer_dve_v2` and `emsaformer_dve` presets at full width on
  a 64 x 96 input: the raw outputs of every head (semantic
  `DeferredBilinear2.x`, instance centre/offset/orientation, scene, the
  dense visual embedding on request) within 1e-3;
- the strict loader consumes the whole `emsaformer_dve_v2` tree."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_port_helpers import _randomise, to_nhwc
from nicr_mtsa_tpu.configs import emsaformer_dve, emsaformer_dve_v2
from nicr_mtsa_tpu.models.backbones.swin import SwinBackbone
from nicr_mtsa_tpu.models.multi_task import build_model as jax_build
from nicr_mtsa_tpu_torch import configs as t_configs
from nicr_mtsa_tpu_torch.models.backbones.swin import (
    SwinBackbone as TSwinBackbone, WindowAttention as TWindowAttention,
)
from nicr_mtsa_tpu_torch.models.common import FusedLayerNorm
from nicr_mtsa_tpu_torch.models.multi_task import build_model as torch_build
from nicr_mtsa_tpu_torch.utils.flax_weights import (load_flax_variables,
                                                  torch_to_flax_variables)

torch.set_num_threads(2)
H, W = 64, 96
TOL = 1e-3


def _np_tree(v, seed):
    v = jax.tree_util.tree_map(lambda a: np.array(a), v)
    v = {k: dict(c) for k, c in v.items()}
    _randomise(v, np.random.default_rng(seed))
    return v


# --- the backbone alone ------------------------------------------------------

BACKBONES = {
    'v2_multimodal': dict(embed_dim=32, depths=(2, 2, 2, 2),
                          n_heads=(1, 2, 4, 8), window_size=8, v2=True,
                          n_input_channels=4, multimodal=True,
                          embed_dim_depth=16),
    'v1_rgb': dict(embed_dim=32, depths=(2, 2, 2, 2), n_heads=(1, 2, 4, 8),
                   window_size=7, v2=False, n_input_channels=3),
}


@pytest.fixture(scope='module', params=sorted(BACKBONES))
def backbone_outputs(request):
    kw = BACKBONES[request.param]
    jb = SwinBackbone(stochastic_depth=0.0, **kw)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, H, W, kw['n_input_channels'])).astype(np.float32)
    tb = TSwinBackbone(generator=torch.Generator().manual_seed(0),
                       **kw).eval()
    # shaped without a compiled init, filled from the port's seeded module
    v = _np_tree(torch_to_flax_variables(tb, jax.eval_shape(
        lambda: jb.init(jax.random.PRNGKey(0), jnp.asarray(x)))), 1)
    with jax.default_matmul_precision('highest'):
        want = [np.asarray(o) for o in jax.jit(jb.apply)(v, jnp.asarray(x))]
    load_flax_variables(tb, v)
    with torch.no_grad():
        y = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
        got = []
        for i in range(tb.n_stages):
            y = tb.forward_stage(i, y)
            got.append(to_nhwc(y))
    return want, got


@pytest.mark.parametrize('stage', range(5))
def test_swin_backbone_stage_matches(backbone_outputs, stage):
    want, got = backbone_outputs
    assert got[stage].shape == want[stage].shape
    np.testing.assert_allclose(got[stage], want[stage], rtol=0, atol=TOL)


# --- the presets -------------------------------------------------------------

PRESETS = {'emsaformer_dve_v2': (emsaformer_dve_v2,
                                 t_configs.emsaformer_dve_v2),
           'emsaformer_dve': (emsaformer_dve, t_configs.emsaformer_dve)}


def _models(name):
    jcfg, tcfg = PRESETS[name]
    jm = jax_build(dataclasses.replace(
        jcfg(input_size=(H, W), dtype=jnp.float32),
        defer_semantic_prediction_upsampling='all'))
    tm = torch_build(dataclasses.replace(
        tcfg(input_size=(H, W), dtype='float32'),
        defer_semantic_prediction_upsampling='all'), device='cpu')
    return jm, tm


@pytest.fixture(scope='module', params=sorted(PRESETS))
def preset_outputs(request):
    jm, tm = _models(request.param)
    x = np.random.default_rng(5).normal(size=(2, H, W, 4)).astype(np.float32)
    # the tree shaped without a compiled init, filled from the port's
    # seeded model
    v = _np_tree(torch_to_flax_variables(tm, jax.eval_shape(
        lambda: jm.init({'params': jax.random.PRNGKey(0)},
                        {'rgbd': jnp.zeros((1, H, W, 4))}, train=False))), 2)
    with jax.default_matmul_precision('highest'):
        want = jax.jit(lambda v, x: jm.apply(v, x, train=False))(
            v, {'rgbd': jnp.asarray(x)})
    load_flax_variables(tm, v)
    with torch.no_grad():
        got = tm({'rgbd': torch.from_numpy(np.ascontiguousarray(
            x.transpose(0, 3, 1, 2)))})
    return want, got


def test_semantic_head_matches(preset_outputs):
    want, got = preset_outputs
    from nicr_mtsa_tpu_torch.models.upsampling import DeferredBilinear2
    assert isinstance(got['semantic'][0], DeferredBilinear2)
    assert got['semantic'][1] == ()
    np.testing.assert_allclose(to_nhwc(got['semantic'][0].x),
                               np.asarray(want['semantic'][0].x),
                               rtol=0, atol=TOL)


@pytest.mark.parametrize('i,name', [(0, 'centre'), (1, 'offset'),
                                    (2, 'orientation')])
def test_instance_head_matches(preset_outputs, i, name):
    want, got = preset_outputs
    a, b = to_nhwc(got['instance'][0][i]), np.asarray(want['instance'][0][i])
    assert a.shape == b.shape == (2, H, W, 1 if i == 0 else 2), name
    np.testing.assert_allclose(a, b, rtol=0, atol=TOL)


def test_scene_head_matches(preset_outputs):
    want, got = preset_outputs
    np.testing.assert_allclose(got['scene'][0].numpy(),
                               np.asarray(want['scene'][0]), rtol=0, atol=TOL)


def test_embedding_head_matches(preset_outputs):
    want, got = preset_outputs
    a = to_nhwc(got['dense_visual_embedding'][0])
    b = np.asarray(want['dense_visual_embedding'][0])
    assert a.shape == b.shape == (2, H, W, 512)
    # 512 channels of magnitude ~30: the same 1e-3 relative to the scale
    np.testing.assert_allclose(a, b, rtol=0, atol=TOL * np.abs(b).max())


# --- weights and what runs ---------------------------------------------------

def test_strict_loader_consumes_the_v2_tree():
    jm, tm = _models('emsaformer_dve_v2')
    shapes = jax.eval_shape(lambda k: jm.init(
        {'params': k}, {'rgbd': jnp.zeros((1, H, W, 4))}, train=False),
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    v = jax.tree_util.tree_map(
        lambda s: rng.normal(size=s.shape).astype(np.float32), shapes)
    v = {k: dict(c) for k, c in v.items()}
    load_flax_variables(tm, v)
    qkv = tm.encoder.backbone.layer1_block0.attn.qkv.weight
    want = v['params']['encoder']['backbone']['layer1_block0']['attn'][
        'qkv']['kernel']
    np.testing.assert_array_equal(qkv.detach().numpy(), want.T)
    ls = tm.encoder.backbone.layer3_block5.attn.logit_scale
    assert tuple(ls.shape) == (16, 1, 1)
    # one leaf too many is refused
    v['params']['encoder']['backbone']['layer1_block0']['attn']['extra'] = \
        np.zeros(3, np.float32)
    with pytest.raises(KeyError):
        load_flax_variables(tm, v)


def test_forward_computes_only_requested_heads():
    _, tm = _models('emsaformer_dve_v2')
    calls = []
    tm.embedding_decoder.register_forward_hook(
        lambda *a: calls.append('dve'))
    x = torch.zeros(1, 4, H, W)
    with torch.no_grad():
        out = tm({'rgbd': x}, outputs=('semantic', 'instance', 'scene'))
    assert set(out) == {'semantic', 'instance', 'scene'} and not calls
    with torch.no_grad():
        out = tm({'rgbd': x})
    assert 'dense_visual_embedding' in out and calls == ['dve']


def test_served_heads_run_36_layer_norms():
    """A serving request (semantic, instance, scene) runs 36 LayerNorms,
    the LN kernel's launches a request on the card: the backbone's 30
    and 3 skip LNs in each of the semantic and the instance decoder."""
    _, tm = _models('emsaformer_dve_v2')
    calls = []
    for m in tm.modules():
        if isinstance(m, FusedLayerNorm):
            m.register_forward_hook(lambda *a: calls.append(1))
    with torch.no_grad():
        tm({'rgbd': torch.zeros(1, 4, H, W)},
           outputs=('semantic', 'instance', 'scene'))
    assert len(calls) == 36


def test_transposed_attention_weights_leave_linear_intact():
    """The window attention's transposed (C, 3C) / (C, C) weights are
    cached apart from the Linear layers' own casts: a later call of
    `proj` (square) still multiplies by W, not W^T."""
    attn = TWindowAttention(32, 2, 4, v2=True,
                            generator=torch.Generator().manual_seed(0))
    wqkv, _, wproj, _, _, _ = attn._weights(torch.float32)
    x = torch.randn(3, 32, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = attn.proj(x)
        want = torch.nn.functional.linear(x, attn.proj.weight,
                                          attn.proj.bias)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(wproj, attn.proj.weight.t(), rtol=0, atol=0)
    assert wqkv.shape == (32, 96)

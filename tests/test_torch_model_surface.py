"""The dense model surface of the PyTorch port (nicr_mtsa_tpu_torch)
against the JAX package on the CPU, f32, on shared weights: every
ResNet registry name (ResNet-18/34/50/101, `*se`, `*-d16`), the
Bottleneck block, the APPM and no-context modules, the `learned-3x3`
and `nearest` upsamplings, the `ln` normalization of conv models, the
dense EmbeddingDecoder and the PanopticHelper.

Weights: each flax tree is shaped by `jax.eval_shape(init)` (no
compiled init), filled from the port's seeded module by
`torch_to_flax_variables` (strict: every leaf and every torch tensor
is used, with equal shapes), its norms and 1-D biases randomised, and
loaded back; the round trip torch -> flax -> torch -> flax is exact.
Tolerances: rtol/atol 1e-3 where ~10 or more layers stack (the
backbones, decoders and the whole model, as tests/test_torch_model.py),
1e-5 for one or two layers; nearest resizes exact. JAX runs under
default_matmul_precision('highest')."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import _torch_port_helpers as hp
from nicr_mtsa_tpu_torch.utils.flax_weights import (
    load_flax_variables, torch_to_flax_variables,
)

torch.set_num_threads(2)
TOL = dict(rtol=1e-3, atol=1e-3)
TOL_LAYER = dict(rtol=1e-5, atol=1e-5)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _np(tree):
    return {k: _np(v) if hasattr(v, 'items') else np.asarray(v)
            for k, v in tree.items()}


def _assert_trees_equal(a, b, path=''):
    assert set(a) == set(b), path
    for k in a:
        if hasattr(a[k], 'items'):
            _assert_trees_equal(a[k], b[k], f'{path}/{k}')
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f'{path}/{k}')


def shared_variables(fmod, tmod, *args, seed=0, **kwargs):
    """Flax variables of `fmod` (applied to `args`) shaped without a
    compiled init, filled from `tmod`, norms randomised, loaded into
    `tmod`; asserts the exact round trip."""
    rngs = {'params': jax.random.PRNGKey(seed),
            'dropout': jax.random.PRNGKey(seed + 1)}
    tmpl = jax.eval_shape(lambda: fmod.init(rngs, *args, **kwargs))
    v = {k: dict(c) for k, c in torch_to_flax_variables(tmod, tmpl).items()}
    hp._randomise(v, np.random.default_rng(seed))
    load_flax_variables(tmod, v)
    _assert_trees_equal(torch_to_flax_variables(tmod, tmpl), _np(v))
    return v


def _apply(fmod, v, *args, **kwargs):
    """`fmod.apply` jitted (one compile is cheaper than op-by-op
    dispatch here), `kwargs` static."""
    with jax.default_matmul_precision('highest'):
        return jax.jit(lambda v, *a: fmod.apply(v, *a, **kwargs))(v, *args)


# --- backbones ----------------------------------------------------------

RESNETS = ('resnet18', 'resnet34', 'resnet50', 'resnet101',
           'resnet18se', 'resnet34se', 'resnet50se', 'resnet101se',
           'resnet18-d16', 'resnet34-d16', 'resnet50-d16', 'resnet101-d16')


def test_registry_holds_every_jax_resnet():
    from nicr_mtsa_tpu.models.backbones import KNOWN_BACKBONES as J
    from nicr_mtsa_tpu_torch.models.backbones import KNOWN_BACKBONES as T
    assert set(RESNETS) == {n for n in J if n.startswith('resnet')}
    assert set(J) == set(T)


@pytest.mark.parametrize('name', RESNETS)
def test_backbone_tree_matches_jax(name):
    """The registry name builds the JAX package's tree (NBt1D below
    ResNet-50), its stage channels and downsamplings (the strict map
    uses every leaf and every tensor)."""
    from nicr_mtsa_tpu.models.backbones import get_backbone as jget
    from nicr_mtsa_tpu_torch.models.backbones import get_backbone as tget
    jb = jget(name, resnet_block='nonbottleneck1d', n_input_channels=3)
    tb = tget(name, resnet_block='nonbottleneck1d', n_input_channels=3,
              generator=_gen())
    assert tb.stages_n_channels == jb.stages_n_channels
    assert tb.stages_downsampling == jb.stages_downsampling
    tmpl = jax.eval_shape(lambda: jb.init(jax.random.PRNGKey(0),
                                          jnp.zeros((1, 32, 32, 3))))
    v = torch_to_flax_variables(tb, tmpl)
    if name.endswith('se'):
        assert 'se_stage4' in v['params']


@pytest.mark.parametrize('stride,dilation,groups', [
    (1, 1, 1), (2, 1, 1), (1, 2, 1), (2, 1, 2)])
def test_bottleneck_matches_jax(stride, dilation, groups):
    from nicr_mtsa_tpu.models.blocks import make_block as jblock
    from nicr_mtsa_tpu_torch.models.blocks import make_block as tblock
    x = np.random.default_rng(1).normal(size=(2, 12, 10, 16))
    x = x.astype(np.float32)
    kw = dict(planes=8, stride=stride, use_downsample=True,
              dilation=dilation, groups=groups, base_width=32)
    fmod = jblock('bottleneck', **kw)
    tmod = tblock('bottleneck', n_in=16, generator=_gen(), **kw).eval()
    v = shared_variables(fmod, tmod, jnp.asarray(x))
    want = np.asarray(_apply(fmod, v, jnp.asarray(x)))
    with torch.no_grad():
        got = hp.to_nhwc(tmod(hp.to_nchw(x)))
    assert got.shape == (2, 12 // stride, 10 // stride, 32)
    np.testing.assert_allclose(got, want, **TOL_LAYER)


def test_zero_init_residual_starts_the_last_norm_at_zero():
    from nicr_mtsa_tpu_torch.models.blocks import make_block
    b = make_block('bottleneck', n_in=16, planes=8, zero_init_residual=True)
    assert float(b.norm3.weight.detach().abs().max()) == 0.0
    assert float(b.norm2.weight.detach().min()) == 1.0


BACKBONES = {
    'bottleneck': dict(block='bottleneck'),
    'bottleneck-se-d16': dict(block='bottleneck', se=True,
                              replace_stride_with_dilation=(False, False,
                                                            True)),
    'nonbottleneck1d-d16': dict(block='nonbottleneck1d',
                                replace_stride_with_dilation=(False, False,
                                                              True)),
    'basicblock-se': dict(block='basicblock', se=True),
}


@pytest.mark.parametrize('variant', sorted(BACKBONES))
def test_resnet_backbone_matches_jax(variant):
    """Every stage of a one-block-a-layer ResNet, with the Bottleneck,
    SE and -d16 options."""
    from nicr_mtsa_tpu.models.backbones.resnet import ResNetBackbone as J
    from nicr_mtsa_tpu_torch.models.backbones.resnet import (
        ResNetBackbone as T,
    )
    kw = dict(layers=(1, 1, 1, 1), **BACKBONES[variant])
    x = np.random.default_rng(2).normal(size=(2, 64, 64, 3))
    x = x.astype(np.float32)
    fmod = J(**kw)
    tmod = T(generator=_gen(), **kw).eval()
    v = shared_variables(fmod, tmod, jnp.asarray(x))
    want = _apply(fmod, v, jnp.asarray(x))
    y = hp.to_nchw(x)
    with torch.no_grad():
        for i in range(tmod.n_stages):
            y = tmod.forward_stage(i, y)
            np.testing.assert_allclose(hp.to_nhwc(y), np.asarray(want[i]),
                                       **TOL, err_msg=f'stage {i}')
    ds = 16 if 'd16' in variant else 32
    assert tmod.stages_downsampling[-1] == ds
    assert want[-1].shape[1] == 64 // ds


def test_d16_skip_stages_match_jax():
    """A -d16 encoder takes its ds-16 skip from stage 3 (the first of
    the two ds-16 stages: the last stage is never a skip), as the JAX
    package's first-occurrence rule does."""
    from nicr_mtsa_tpu.models.encoder import _skip_stage_indices as jidx
    from nicr_mtsa_tpu_torch.models.backbones import get_backbone
    from nicr_mtsa_tpu_torch.models.encoder import (
        Encoder, _skip_stage_indices as tidx,
    )
    ds = [2, 4, 8, 16, 16]
    assert tidx(ds, (4, 8, 16)) == list(jidx(ds, (4, 8, 16))) == [1, 2, 3]
    enc = Encoder(get_backbone('resnet34-d16', resnet_block='basicblock'))
    assert enc.downsampling == 16
    assert enc.skips_n_channels == (64, 128, 256)


# --- context modules --------------------------------------------------------

@pytest.mark.parametrize('name,scale', [('appm', 1), ('appm', 2),
                                        ('appm-1-2-4-8', 2)])
def test_appm_matches_jax(name, scale):
    """APPM at its training input size and at twice it (the bins
    doubled), output and branches."""
    from nicr_mtsa_tpu.models.context import get_context_module as jget
    from nicr_mtsa_tpu_torch.models.context import get_context_module as tget
    train_hw = (8, 10)
    x = np.random.default_rng(3).normal(
        size=(2, train_hw[0] * scale, train_hw[1] * scale, 32))
    x = x.astype(np.float32)
    fmod = jget(name, 32, 24, input_size=train_hw)
    tmod = tget(name, 32, 24, input_size=train_hw, generator=_gen()).eval()
    v = shared_variables(fmod, tmod, jnp.asarray(x))
    want, ctx_j = _apply(fmod, v, jnp.asarray(x))
    with torch.no_grad():
        got, ctx_t = tmod(hp.to_nchw(x))
    np.testing.assert_allclose(hp.to_nhwc(got), np.asarray(want), **TOL)
    bins = (1, 2, 4, 8) if name.endswith('8') else (1, 2, 3, 6)
    assert [tuple(c.shape[-2:]) for c in ctx_t] == \
        [(b * scale, b * scale) for b in bins]
    for a, b in zip(ctx_t, ctx_j):
        np.testing.assert_allclose(hp.to_nhwc(a), np.asarray(b), **TOL)


@pytest.mark.parametrize('n_out', [24, 32])
def test_no_context_with_scene_head_matches_jax(n_out):
    """'none': a 1x1 ConvNormAct where the channels differ, else the
    identity (no parameters), and no branches; the scene head then
    pools the context output."""
    from nicr_mtsa_tpu.models.context import NoContextModule as J
    from nicr_mtsa_tpu.models.decoders import SceneClassificationDecoder as JS
    from nicr_mtsa_tpu_torch.models.context import NoContextModule as T
    from nicr_mtsa_tpu_torch.models.decoders import (
        SceneClassificationDecoder as TS,
    )
    x = np.random.default_rng(4).normal(size=(2, 4, 5, 32))
    x = x.astype(np.float32)
    fmod, tmod = J(32, n_out), T(32, n_out, generator=_gen()).eval()
    if n_out == 32:
        assert not list(tmod.parameters())
        with torch.no_grad():
            got, ctx = tmod(hp.to_nchw(x))
        np.testing.assert_array_equal(hp.to_nhwc(got), x)
        want = x
    else:
        v = shared_variables(fmod, tmod, jnp.asarray(x))
        want, ctx_j = _apply(fmod, v, jnp.asarray(x))
        assert ctx_j == ()
        with torch.no_grad():
            got, ctx = tmod(hp.to_nchw(x))
        np.testing.assert_allclose(hp.to_nhwc(got), np.asarray(want),
                                   **TOL_LAYER)
    assert ctx == ()
    fs, ts = JS(n_channels_in=n_out, n_classes=10), TS(n_out, 10, _gen())
    cm = (jnp.asarray(want), ())
    vs = shared_variables(fs, ts, cm, None)
    want_s = np.asarray(_apply(fs, vs, cm, None)[0])
    with torch.no_grad():
        got_s = ts((got, ()))[0].numpy()
    np.testing.assert_allclose(got_s, want_s, **TOL_LAYER)


# --- upsampling, LayerNorm ---------------------------------------------------

@pytest.mark.parametrize('mode,factor', [
    ('learned-3x3', 2), ('nearest', 2), ('nearest', 4), ('bilinear', 4)])
def test_upsampling_matches_jax(mode, factor):
    from nicr_mtsa_tpu.models.upsampling import Upsampling as J
    from nicr_mtsa_tpu_torch.models.upsampling import Upsampling as T
    x = np.random.default_rng(5).normal(size=(2, 7, 9, 5))
    x = x.astype(np.float32)
    fmod = J(mode=mode, n_channels=5, scale_factor=factor)
    tmod = T(mode, 5, scale_factor=factor)
    if mode == 'learned-3x3':
        v = shared_variables(fmod, tmod, jnp.asarray(x))
        # random weights and bias: the edge pad, not the init, shows
        rng = np.random.default_rng(6)
        v['params']['conv']['kernel'] = rng.normal(
            size=(3, 3, 1, 5)).astype(np.float32)
        v['params']['conv']['bias'] = rng.normal(size=(5,)).astype(
            np.float32)
        load_flax_variables(tmod, v)
    else:
        v = {}
        assert not list(tmod.parameters())
    want = np.asarray(_apply(fmod, v, jnp.asarray(x)))
    with torch.no_grad():
        got = hp.to_nhwc(tmod(hp.to_nchw(x)))
    assert got.shape == (2, 7 * factor, 9 * factor, 5)
    if mode == 'nearest':
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **TOL_LAYER)


def test_learned_3x3_tree_differs_from_zeropad():
    from nicr_mtsa_tpu_torch.models.upsampling import Upsampling
    names = {n for n, _ in Upsampling('learned-3x3', 4).named_parameters()}
    zp = {n for n, _ in Upsampling('learned-3x3-zeropad',
                                   4).named_parameters()}
    assert names == {'conv.weight', 'conv.bias'}
    assert zp == {'weight', 'bias'}


@pytest.mark.parametrize('what', ['conv_norm_act', 'basicblock',
                                  'nonbottleneck1d', 'bottleneck'])
def test_layernorm_conv_modules_match_jax(what):
    """`ln` in conv models: flax's nn.LayerNorm over the channels (eps
    1e-6, scale and bias), in the ConvNormAct and in every block."""
    from nicr_mtsa_tpu.models.blocks import make_block as jblock
    from nicr_mtsa_tpu.models.common import ConvNormAct as JC
    from nicr_mtsa_tpu_torch.models.blocks import make_block as tblock
    from nicr_mtsa_tpu_torch.models.common import (
        ChannelLayerNorm, ConvNormAct as TC,
    )
    x = np.random.default_rng(7).normal(size=(2, 8, 10, 16)) * 3 + 1
    x = x.astype(np.float32)
    if what == 'conv_norm_act':
        fmod, tmod = JC(24, 3, norm='ln'), TC(16, 24, 3, norm='ln',
                                              generator=_gen())
    else:
        kw = dict(planes=8 if what == 'bottleneck' else 24, stride=2,
                  use_downsample=True, norm='ln')
        fmod = jblock(what, **kw)
        tmod = tblock(what, n_in=16, generator=_gen(), **kw)
    tmod.eval()
    assert any(isinstance(m, ChannelLayerNorm) for m in tmod.modules())
    assert all(m.eps == 1e-6 for m in tmod.modules()
               if isinstance(m, ChannelLayerNorm))
    v = shared_variables(fmod, tmod, jnp.asarray(x))
    want = np.asarray(_apply(fmod, v, jnp.asarray(x)))
    with torch.no_grad():
        got = hp.to_nhwc(tmod(hp.to_nchw(x)))
    np.testing.assert_allclose(got, want, **TOL_LAYER)


# --- decoders ---------------------------------------------------------------

DEC = dict(n_channels_in=16, downsampling_in=32, n_channels=(16, 12, 8),
           downsamplings=(16, 8, 4), n_blocks=1, fusion='add-rgb',
           fusion_n_channels=(20, 12, 10), fusion_downsamplings=(16, 8, 4),
           upsampling='learned-3x3-zeropad',
           prediction_upsampling='learned-3x3-zeropad')


def decoder_inputs(seed=8, B=2, H=64, W=96):
    """(context features, branches) at ds 32 and the rgb / depth skips
    at ds 16, 8, 4, NHWC numpy."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, H // 32, W // 32, 16)).astype(np.float32)
    skips = {str(ds): {m: rng.normal(size=(B, H // ds, W // ds, c)).astype(
        np.float32) for m in ('rgb', 'depth')}
        for ds, c in zip((16, 8, 4), (20, 12, 10))}
    return x, skips


class _NoDropout:
    """flax `nn.Dropout(...)` as the identity."""

    def __init__(self, *args, **kwargs):
        pass

    def __call__(self, x, *args, **kwargs):
        return x


def _jax_in(x, skips):
    return ((jnp.asarray(x), ()),
            {k: {m: jnp.asarray(a) for m, a in d.items()}
             for k, d in skips.items()})


def _torch_in(x, skips):
    return ((hp.to_nchw(x), ()),
            {k: {m: hp.to_nchw(a) for m, a in d.items()}
             for k, d in skips.items()})


@pytest.mark.parametrize('train', [False, True])
def test_dense_embedding_decoder_matches_jax(train):
    """The dense EmbeddingDecoder: the full-resolution map, and in
    training its side heads' maps."""
    from nicr_mtsa_tpu.models.decoders import EmbeddingDecoder as J
    from nicr_mtsa_tpu_torch.models.common import Dropout
    from nicr_mtsa_tpu_torch.models.decoders import EmbeddingDecoder as T
    x, skips = decoder_inputs()
    fmod = J(embedding_dim=6, **DEC)
    tmod = T(embedding_dim=6, side_heads=train, generator=_gen(), **DEC)
    for m in tmod.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    tmod.train(train)
    jin, tin = _jax_in(x, skips), _torch_in(x, skips)
    v = shared_variables(fmod, tmod, *jin, train=train)
    if train:
        # the JAX blocks' channel dropout as the identity (the port's
        # rates are 0); BatchNorm on batch statistics on both sides
        import flax.linen
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(flax.linen, 'Dropout', _NoDropout)
            (want, sides), _ = _apply(fmod, v, *jin, train=True,
                                      mutable=['batch_stats'])
    else:
        want, sides = _apply(fmod, v, *jin, train=False)
    with torch.no_grad():
        got, got_sides = tmod(*tin)
    assert got.shape == (2, 6, 64, 96)
    np.testing.assert_allclose(hp.to_nhwc(got), np.asarray(want), **TOL)
    assert len(got_sides) == len(sides) == (3 if train else 0)
    for a, b in zip(got_sides, sides):
        np.testing.assert_allclose(hp.to_nhwc(a), np.asarray(b), **TOL)


def test_panoptic_helper_matches_jax():
    from nicr_mtsa_tpu.models.decoders import (
        InstanceDecoder as JI, PanopticHelper as JP, SemanticDecoder as JS,
    )
    from nicr_mtsa_tpu_torch.models.decoders import (
        InstanceDecoder as TI, PanopticHelper as TP, SemanticDecoder as TS,
    )
    x, skips = decoder_inputs(seed=9)
    fmod = JP(semantic_decoder=JS(n_classes=7, **DEC),
              instance_decoder=JI(with_orientation=True, **DEC))
    g = _gen()
    tmod = TP(TS(n_classes=7, generator=g, **DEC),
              TI(with_orientation=True, generator=g, **DEC)).eval()
    jin, tin = _jax_in(x, skips), _torch_in(x, skips)
    v = shared_variables(fmod, tmod, *jin)
    (ws, wi), (ss, si) = _apply(fmod, v, *jin)
    with torch.no_grad():
        (gs, gi), (ts, ti) = tmod(*tin)
    assert ss == si == () and ts == ti == ()
    np.testing.assert_allclose(hp.to_nhwc(gs), np.asarray(ws), **TOL)
    for a, b in zip(gi, wi):
        np.testing.assert_allclose(hp.to_nhwc(a), np.asarray(b), **TOL)


# --- whole models -------------------------------------------------------

SMALL = dict(backbone_rgb='resnet18', backbone_depth='resnet18',
             resnet_block='basicblock', context_n_channels=32,
             decoder_n_channels=(32, 24, 16), decoder_n_blocks=1,
             input_size=(64, 96), semantic_n_classes=12, scene_n_classes=5,
             embedding_dim=8, upsampling='learned-3x3-zeropad',
             prediction_upsampling='learned-3x3-zeropad')
ALL_DENSE = ('semantic', 'instance', 'orientation', 'normal', 'scene',
             'dense_visual_embedding')
MODELS = {
    'appm': dict(context_module='appm'),
    'none_scene': dict(context_module='none', context_n_channels=512),
    'learned_3x3_nearest': dict(upsampling='learned-3x3',
                                prediction_upsampling='nearest'),
    'ln': dict(normalization='ln'),
    'all_dense_tasks': dict(tasks=ALL_DENSE),
}


def _configs(**kw):
    from nicr_mtsa_tpu.models.multi_task import MultiTaskModelConfig as JC
    from nicr_mtsa_tpu_torch.models.multi_task import (
        MultiTaskModelConfig as TC,
    )
    kw = dict(SMALL, **kw)
    return JC(**kw), TC(**kw)


@pytest.mark.parametrize('name,train', [
    ('appm', False), ('none_scene', False),
    ('learned_3x3_nearest', False), ('ln', False), ('all_dense_tasks', True)])
def test_model_tree_matches_jax(name, train):
    """`build_model` of each option builds the JAX package's tree (in
    training with the dense decoders' side heads), the scene head sized
    from the context module's branches or, without them, from its
    output."""
    from nicr_mtsa_tpu.models.multi_task import build_model as jbuild
    from nicr_mtsa_tpu_torch.models.multi_task import build_model as tbuild
    jc, tc = _configs(**MODELS[name])
    jm = jbuild(jc)
    tm = tbuild(tc, device='cpu', train=train)
    x = {'rgb': jnp.zeros((1, 64, 96, 3)), 'depth': jnp.zeros((1, 64, 96, 1))}
    tmpl = jax.eval_shape(lambda: jm.init(
        {'params': jax.random.PRNGKey(0), 'dropout': jax.random.PRNGKey(1)},
        x, train=train))
    load_flax_variables(tm, torch_to_flax_variables(tm, tmpl))
    if name == 'appm':
        # the context's input size in training: 64 x 96 over ds 32
        assert tm.context_module.input_size == (2, 3)


def test_whole_model_with_new_options_matches_jax():
    """One small model through `build_model` with SE encoders, the
    no-context module, learned-3x3 decoder and nearest prediction
    upsamplings, `ln` normalization and every dense task's head."""
    from nicr_mtsa_tpu.models.multi_task import build_model as jbuild
    from nicr_mtsa_tpu_torch.models.multi_task import build_model as tbuild
    jc, tc = _configs(backbone_rgb='resnet18se', backbone_depth='resnet18se',
                      context_module='none',
                      context_n_channels=512, upsampling='learned-3x3',
                      prediction_upsampling='nearest', normalization='ln',
                      tasks=ALL_DENSE)
    jm, tm = jbuild(jc), tbuild(tc, device='cpu')
    rgb, depth = hp.inputs(seed=10)
    rgb, depth = rgb[:, :64, :96], depth[:, :64, :96]
    v = shared_variables(jm, tm, {'rgb': jnp.asarray(rgb),
                                  'depth': jnp.asarray(depth)}, train=False)
    with jax.default_matmul_precision('highest'):
        want = jax.jit(lambda v, r, d: jm.apply(
            v, {'rgb': r, 'depth': d}, train=False))(v, rgb, depth)
    with torch.no_grad():
        got = tm({'rgb': hp.to_nchw(rgb), 'depth': hp.to_nchw(depth)})
    assert set(got) == set(want) == {'semantic', 'instance', 'normal',
                                     'scene', 'dense_visual_embedding'}
    for task in ('semantic', 'normal', 'dense_visual_embedding'):
        np.testing.assert_allclose(hp.to_nhwc(got[task][0]),
                                   np.asarray(want[task][0]), **TOL,
                                   err_msg=task)
    for a, b in zip(got['instance'][0], want['instance'][0]):
        np.testing.assert_allclose(hp.to_nhwc(a), np.asarray(b), **TOL)
    np.testing.assert_allclose(got['scene'][0].numpy(),
                               np.asarray(want['scene'][0]), **TOL)


def test_config_refusals():
    """A task without a decoder, an orientation head without the
    instance decoder and a deferred learned-3x3 head raise; a deferred
    learned-3x3-zeropad head builds."""
    from nicr_mtsa_tpu_torch.models.multi_task import (
        MultiTaskModelConfig, build_model,
    )
    for tasks in (('semantic', 'depth'), ('semantic', 'orientation')):
        with pytest.raises(ValueError):
            build_model(MultiTaskModelConfig(tasks=tasks, **SMALL),
                        device='cpu')
    for up in ('learned-3x3', 'nearest'):
        for defer in (True, 'all'):
            with pytest.raises(ValueError, match='defer'):
                build_model(MultiTaskModelConfig(
                    **dict(SMALL, prediction_upsampling=up),
                    defer_semantic_prediction_upsampling=defer),
                    device='cpu')
    build_model(MultiTaskModelConfig(
        defer_semantic_prediction_upsampling='all', **SMALL), device='cpu')


def test_jax_package_builds_no_more_option_names():
    """Every encoder, context, upsampling and normalization name the
    JAX package knows, the port knows."""
    from nicr_mtsa_tpu.models import common as jc, context as jx
    from nicr_mtsa_tpu.models import upsampling as ju
    from nicr_mtsa_tpu_torch.models import common as tc, context as tx
    from nicr_mtsa_tpu_torch.models import upsampling as tu
    assert set(jc.KNOWN_NORMALIZATIONS) == set(tc.KNOWN_NORMALIZATIONS)
    assert set(jx.KNOWN_CONTEXT_MODULES) == set(tx.KNOWN_CONTEXT_MODULES)
    assert set(ju.KNOWN_UPSAMPLING_METHODS) == set(
        tu.KNOWN_UPSAMPLING_METHODS)
    from nicr_mtsa_tpu.multi_task import KNOWN_TASKS as jt
    from nicr_mtsa_tpu_torch.models.multi_task import KNOWN_TASKS as tt
    assert tuple(jt) == tuple(tt)

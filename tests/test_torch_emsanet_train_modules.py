"""The modules of the PyTorch/CUDA port's EMSANet training step against
the JAX package's, on the CPU:

- an NBt1D ResNet stage (layer2 of a NonBottleneck1D ResNet: a strided
  block with its projection, then a plain block) and a dense-decoder
  module (3x3 ConvNormAct, two NBt1D blocks, the learned-3x3-zeropad x2
  upsampling) in training mode against the flax modules, in float64
  (`jax.enable_x64`; in f32 a few pre-activations land on the other
  side of 0 between the two, which moves a ReLU network's gradients by
  percents, see test_torch_emsanet_train_step.py), channel dropout off
  on both sides: the outputs (and the decoder module's side feature,
  its features before the upsampling) within 1e-9 of max |.|, the
  gradients of the input and of every parameter (the upsampling's 3x3
  weight through its phase-combined 4x4 kernel included) within 1e-8
  of the leaf's max, the BatchNorm statistics after the step within
  1e-12;
- the learned upsampling in training after a serving call under
  inference mode built its cached kernel: the gradient is the graph's;
- the dense decoders in training give one side output a step that
  upsamples, at that step's input resolution, from 1x1 side heads, and
  none in eval mode; a decoder built without side heads refuses to
  train;
- the side-output pairing of the semantic and instance helpers against
  the JAX helpers: without `_down_<k>` targets only the '*_main' losses,
  with them one 'down_<k>' loss per side output and the totals over all
  scales (within rtol 1e-5); a side output without its targets gets no
  loss;
- NonBottleneck1D's channel dropout against flax's `nn.Dropout(0.2,
  broadcast_dims=(1, 2))` formula: one draw per (sample, channel)
  broadcast over H x W, a kept share within 5 standard deviations of
  0.8, kept values exactly x / 0.8 (f32 and bf16), the identity in eval
  mode, equal masks from equal seeds; BasicBlock takes no dropout."""
import numpy as np
import jax
import jax.numpy as jnp
import flax.linen
import pytest
import torch

from nicr_mtsa_tpu.models.backbones.resnet import ResNetBackbone
from nicr_mtsa_tpu.models.decoders.base import DenseDecoderModule
from nicr_mtsa_tpu.tasks import InstanceTaskHelper, SemanticTaskHelper
from nicr_mtsa_tpu_torch.models.backbones.resnet import (
    ResNetBackbone as TResNetBackbone,
)
from nicr_mtsa_tpu_torch.models.blocks import (BasicBlock, NonBottleneck1D,
                                               make_block)
from nicr_mtsa_tpu_torch.models.common import Dropout
from nicr_mtsa_tpu_torch.models.decoders import (InstanceDecoder,
                                                 SemanticDecoder)
from nicr_mtsa_tpu_torch.models.decoders.base import (
    DenseDecoderModule as TDenseDecoderModule,
)
from nicr_mtsa_tpu_torch.models.upsampling import Upsampling
from nicr_mtsa_tpu_torch.tasks import (
    InstanceTaskHelper as TInstanceTaskHelper,
    SemanticTaskHelper as TSemanticTaskHelper,
)
from nicr_mtsa_tpu_torch.utils.flax_weights import (flax_tree_to_torch,
                                                    load_flax_variables)
from _torch_port_helpers import _randomise

torch.set_num_threads(2)


class _NoDropout:
    def __init__(self, *args, **kwargs):
        pass

    def __call__(self, x, *args, **kwargs):
        return x


def _np64(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float64), tree)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().double().numpy().transpose(0, 2, 3, 1)


def _flax_train_grads(module, x, weights, edit=None, init_kw=None,
                      **apply_kw):
    """(variables, outputs, parameter grads, input grad, new batch
    stats) of sum(out_i * weights_i) over the module's outputs, in
    float64, from randomised variables (norm statistics, scales and
    biases; then `edit`)."""
    with jax.enable_x64(True):
        v = _np64(jax.jit(lambda k, xin: module.init(
            k, xin, True, **(init_kw or {})))(jax.random.PRNGKey(0),
                                              jnp.asarray(x)))
        v = {k: dict(c) for k, c in v.items()}
        _randomise(v, np.random.default_rng(4))
        if edit is not None:
            edit(v)
        v = _np64(v)

        def f(params, xin):
            outs, upd = module.apply(
                {'params': params, 'batch_stats': v['batch_stats']}, xin,
                True, mutable=['batch_stats'], **apply_kw)
            outs = outs if isinstance(outs, tuple) else (outs,)
            loss = sum(jnp.sum(o * jnp.asarray(w))
                       for o, w in zip(outs, weights))
            return loss, (outs, upd['batch_stats'])

        (_, (outs, stats)), (g_p, g_x) = jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True)(v['params'], jnp.asarray(x))
        return v, [np.asarray(o) for o in outs], _np64(g_p), \
            np.asarray(g_x), _np64(stats)


def _close(got, want, rel, what):
    scale = max(float(np.abs(want).max()), 1e-300)
    assert np.abs(got - want).max() <= rel * scale, what


def _check_grads(tmod, want_p, rel):
    want = flax_tree_to_torch(want_p)
    got = {n: p.grad for n, p in tmod.named_parameters()}
    assert set(got) == set(want)
    for n, w in want.items():
        assert got[n] is not None, n
        _close(got[n].double().numpy(), w, rel, n)


def _check_stats(tmod, want_s):
    want = flax_tree_to_torch(want_s, 'batch_stats')
    got = dict(tmod.named_buffers())
    assert set(got) == set(want) and want
    for n, w in want.items():
        np.testing.assert_allclose(got[n].double().numpy(), w, rtol=1e-12,
                                   atol=1e-12, err_msg=n)


def test_nbt1d_resnet_stage_trains_as_flax():
    rng = np.random.default_rng(7)
    x = np.abs(rng.normal(size=(2, 16, 24, 64)))          # after a ReLU
    w = rng.normal(size=(2, 8, 12, 128))
    jm = ResNetBackbone(block='nonbottleneck1d', layers=(1, 2, 1, 1),
                        dropout_p=0.0, dtype=jnp.float64)
    stage = lambda m, xin, train: m.forward_stage(2, xin, train)  # noqa
    v, (out,), g_p, g_x, stats = _flax_train_grads(
        jm, x, [w], init_kw=dict(method=stage), method=stage)
    assert set(v['params']) == {'layer2_block0', 'layer2_block1'}

    tm = TResNetBackbone('nonbottleneck1d', (1, 2, 1, 1)).double().train()
    blocks = [tm.layer2_block0, tm.layer2_block1]
    for i, blk in enumerate(blocks):
        assert isinstance(blk, NonBottleneck1D)
        blk.dropout.rate = 0.0
        load_flax_variables(blk, {c: v[c][f'layer2_block{i}'] for c in v})
    xt = _nchw(x).requires_grad_()
    out_t = tm.forward_stage(2, xt, torch.Generator())
    (out_t * _nchw(w)).sum().backward()
    _close(_nhwc(out_t), out, 1e-9, 'output')
    _close(_nhwc(xt.grad), g_x, 1e-8, 'input gradient')
    for i, blk in enumerate(blocks):
        _check_grads(blk, g_p[f'layer2_block{i}'], 1e-8)
        _check_stats(blk, stats[f'layer2_block{i}'])


def test_dense_decoder_module_trains_as_flax():
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 6, 8, 48))
    w_out = rng.normal(size=(2, 12, 16, 32))
    w_side = rng.normal(size=(2, 6, 8, 32))
    jm = DenseDecoderModule(n_channels=32, block='nonbottleneck1d',
                            n_blocks=2, upsampling='learned-3x3-zeropad',
                            dtype=jnp.float64)

    def off_bilinear(v):
        # the upsampling's weight off the bilinear kernel it starts from
        up = v['params']['upsample']
        up['kernel'] = np.random.default_rng(9).normal(
            size=up['kernel'].shape)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen, 'Dropout', _NoDropout)
        v, (out, side), g_p, g_x, stats = _flax_train_grads(
            jm, x, [w_out, w_side], edit=off_bilinear)

    tm = TDenseDecoderModule(48, 32, n_blocks=2,
                             upsampling='learned-3x3-zeropad')
    tm = tm.double().train()
    for i in range(2):
        tm.get_submodule(f'block{i}').dropout.rate = 0.0
    load_flax_variables(tm, v)
    xt = _nchw(x).requires_grad_()
    out_t, side_t = tm(xt, torch.Generator())
    ((out_t * _nchw(w_out)).sum() + (side_t * _nchw(w_side)).sum()
     ).backward()
    _close(_nhwc(out_t), out, 1e-9, 'output')
    _close(_nhwc(side_t), side, 1e-9, 'side feature')
    _close(_nhwc(xt.grad), g_x, 1e-8, 'input gradient')
    _check_grads(tm, g_p, 1e-8)
    assert float(tm.upsample.weight.grad.abs().max()) > 0
    _check_stats(tm, stats)


def test_learned_upsampling_trains_after_a_serving_call():
    g = torch.Generator().manual_seed(2)
    x = torch.randn(2, 5, 7, 9, generator=g)
    fresh, served = Upsampling('learned-3x3-zeropad', 5), \
        Upsampling('learned-3x3-zeropad', 5)
    with torch.no_grad():
        fresh.weight.normal_(generator=g)
        served.weight.copy_(fresh.weight)
    with torch.inference_mode():
        served.eval()(x)                        # caches the 4x4 kernel
    for m in (fresh, served):
        m.train()(x).square().sum().backward()
    assert float(served.weight.grad.abs().max()) > 0
    assert torch.equal(served.weight.grad, fresh.weight.grad)
    assert torch.equal(served.bias.grad, fresh.bias.grad)


@pytest.mark.parametrize('cls', [SemanticDecoder, InstanceDecoder])
def test_dense_decoders_side_outputs(cls):
    kw = dict(n_channels_in=32, downsampling_in=32,
              n_channels=(32, 24, 16), downsamplings=(16, 8, 4),
              n_blocks=1, fusion_n_channels=(16, 8, 8),
              generator=torch.Generator().manual_seed(0))
    if cls is InstanceDecoder:
        kw['with_orientation'] = True
    dec = cls(side_heads=True, **kw)
    assert [n for n, _ in dec.named_children()
            if n.startswith('side_head')] == ['side_head0', 'side_head1',
                                              'side_head2']
    x = (torch.randn(2, 32, 2, 3), ())
    skips = {'16': {'rgb': torch.randn(2, 16, 4, 6)},
             '8': {'rgb': torch.randn(2, 8, 8, 12)},
             '4': {'rgb': torch.randn(2, 8, 16, 24)}}
    main, side = dec.train()(x, skips, torch.Generator())
    assert len(side) == 3
    for s, hw in zip(side, ((2, 3), (4, 6), (8, 12))):
        heads = s if isinstance(s, tuple) else (s,)
        assert all(tuple(h.shape[-2:]) == hw for h in heads)
        assert heads[0].shape[1] == (1 if cls is InstanceDecoder else 40)
    assert dec.eval()(x, skips)[1] == ()
    with pytest.raises(ValueError, match='side heads'):
        cls(**kw).train()(x, skips)


# --- the side-output pairing ------------------------------------------------

def _pairing_batch(rng, B, H, W, downscales):
    def targets(h, w):
        return {
            'semantic': rng.integers(0, 41, (B, h, w)).astype(np.int32),
            'instance_center': rng.random((B, h, w)).astype(np.float32),
            'instance_offset': rng.normal(size=(B, h, w, 2)).astype(
                np.float32),
            'instance_foreground': rng.random((B, h, w)) > 0.5,
            'instance_center_mask': rng.random((B, h, w)) > 0.3,
            'orientation': rng.normal(size=(B, h, w, 2)).astype(np.float32),
            'orientation_foreground': rng.random((B, h, w)) > 0.5}
    batch = targets(H, W)
    for k in downscales:
        batch[f'_down_{k}'] = targets(H // k, W // k)
    return batch


def _pairing_preds(rng, B, H, W, downscales):
    def sem(h, w):
        return rng.normal(size=(B, h, w, 40)).astype(np.float32)

    def ins(h, w):
        o = rng.normal(size=(B, h, w, 2)).astype(np.float32)
        return (rng.random((B, h, w, 1)).astype(np.float32),
                np.tanh(rng.normal(size=(B, h, w, 2))).astype(np.float32),
                o / np.linalg.norm(o, axis=-1, keepdims=True))
    return {'semantic_output': sem(H, W),
            'semantic_side_outputs': tuple(sem(H // k, W // k)
                                           for k in downscales),
            'instance_output': ins(H, W),
            'instance_side_outputs': tuple(ins(H // k, W // k)
                                           for k in downscales)}


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to_torch(v) for v in tree)
    if tree.ndim == 4:
        return _nchw(tree)
    return torch.from_numpy(tree)


def _losses(batch, preds, with_jax=True):
    is_thing = (False,) + tuple(i < 8 for i in range(40))
    port = {}
    tb, tp = _to_torch(batch), _to_torch(preds)
    for h in (TSemanticTaskHelper(40), TInstanceTaskHelper(41, is_thing)):
        port.update({k: float(v) for k, v in
                     h.compute_losses(tb, tp).items()})
    if not with_jax:
        return port
    jax_ = {}
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    jp = jax.tree_util.tree_map(jnp.asarray, preds)
    for h in (SemanticTaskHelper(40), InstanceTaskHelper(41, is_thing)):
        jax_.update({k: float(v) for k, v in
                     h.compute_losses(jb, jp).items()})
    return port, jax_


@pytest.mark.parametrize('with_targets', [False, True])
def test_side_output_pairing_matches_jax(with_targets):
    rng = np.random.default_rng(11)
    B, H, W, downscales = 2, 32, 48, (16, 8, 4)
    batch = _pairing_batch(rng, B, H, W,
                           downscales if with_targets else ())
    port, want = _losses(batch, _pairing_preds(rng, B, H, W, downscales))
    assert set(port) == set(want)
    downs = {k for k in port if '_loss_down_' in k}
    if with_targets:
        assert downs == {f'{t}_loss_down_{k}' for k in downscales
                         for t in ('semantic', 'instance_center',
                                   'instance_offset', 'instance_orientation')}
    else:
        assert not downs
    for k, v in want.items():
        np.testing.assert_allclose(port[k], v, rtol=1e-5, err_msg=k)


def test_side_output_without_its_targets_gets_no_loss():
    rng = np.random.default_rng(12)
    B, H, W = 2, 32, 48
    batch = _pairing_batch(rng, B, H, W, (8,))
    preds = _pairing_preds(rng, B, H, W, (16, 8))
    # (the JAX helpers pair targets with side outputs by position, so
    # they are held to the port only where every side output has its
    # targets or none has)
    port = _losses(batch, preds, with_jax=False)
    alone = _losses(batch['_down_8'], {
        'semantic_output': preds['semantic_side_outputs'][1],
        'instance_output': preds['instance_side_outputs'][1]},
        with_jax=False)
    assert {k for k in port if 'down' in k} == {
        'semantic_loss_down_8', 'instance_center_loss_down_8',
        'instance_offset_loss_down_8', 'instance_orientation_loss_down_8'}
    for k in ('semantic', 'instance_center', 'instance_offset',
              'instance_orientation'):
        np.testing.assert_allclose(port[f'{k}_loss_down_8'],
                                   alone[f'{k}_loss_main'], rtol=1e-6)


# --- NonBottleneck1D's channel dropout --------------------------------------

@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_nbt1d_channel_dropout_is_flax_formula(dtype):
    blk = NonBottleneck1D(64, 64).train()
    drop = blk.dropout
    assert isinstance(drop, Dropout) and drop.rate == 0.2
    B, C, H, W = 32, 64, 6, 10
    x = (torch.rand(B, C, H, W, generator=torch.Generator().manual_seed(1))
         + 0.5).to(dtype)
    y = drop(x, torch.Generator().manual_seed(5))
    kept = y != 0
    per = kept[:, :, :1, :1]
    assert torch.equal(kept, per.expand_as(kept))     # one draw a plane
    n, k = per.numel(), int(per.sum())
    sd = (n * 0.8 * 0.2) ** 0.5
    assert abs(k - 0.8 * n) <= 5 * sd, (k, n)
    # flax: lax.div(x, keep_prob) in x's dtype, 0 elsewhere
    assert torch.equal(y[kept], x[kept] / torch.tensor(0.8, dtype=dtype))
    assert torch.equal(drop(x, torch.Generator().manual_seed(5)), y)
    assert not torch.equal(drop(x, torch.Generator().manual_seed(6)), y)
    assert blk.eval().dropout(x) is x
    # the block in training draws its mask from the generator it is given
    xin = torch.randn(2, 64, 6, 10, generator=torch.Generator().manual_seed(3))
    blk.train()
    a = blk(xin, torch.Generator().manual_seed(0))
    assert torch.equal(a, blk(xin, torch.Generator().manual_seed(0)))
    drop.rate = 0.0
    assert not torch.equal(a, blk(xin, torch.Generator().manual_seed(0)))


def test_make_block_gives_dropout_to_nbt1d_only():
    assert make_block('nonbottleneck1d', n_in=8, planes=8,
                      dropout_p=0.3).dropout.rate == 0.3
    blk = make_block('basicblock', n_in=8, planes=8, dropout_p=0.3)
    assert isinstance(blk, BasicBlock)
    assert not any(isinstance(m, Dropout) for m in blk.modules())


def test_build_train_pipeline_emsanet_steps_on_cpu():
    """`build_train_pipeline(emsanet_train_config(...), mu_dtype=)` with
    `bench.py --quick`'s widths takes finite steps on the CPU with its
    channel dropout on, a bf16 first moment (`--mu-bf16`) and no kernel
    launch; the same generator seed gives the same step."""
    import dataclasses
    from nicr_mtsa_tpu_torch.ops import cuda as kernels
    from nicr_mtsa_tpu_torch.pipeline import (build_train_pipeline,
                                              emsanet_train_config)
    from nicr_mtsa_tpu_torch.testing import build_train_batch
    from _torch_emsanet_train_helpers import QUICK
    cfg = dataclasses.replace(emsanet_train_config((64, 96), 'float32'),
                              **QUICK)
    batch = build_train_batch(2, 64, 96, seed=1, device='cpu', rgbd=False)
    assert set(batch) >= {'rgb', 'depth'} and 'rgbd' not in batch
    assert batch['rgb'].shape == (2, 3, 64, 96)
    assert batch['depth'].shape == (2, 1, 64, 96)
    totals = []
    for _ in range(2):
        pipe = build_train_pipeline(cfg, device='cpu',
                                    mu_dtype=torch.bfloat16)
        assert pipe.model.training
        assert any(n.startswith('semantic_decoder.side_head')
                   for n, _ in pipe.model.named_parameters())
        state = pipe.create_train_state()
        kernels.reset_launch_counts()
        state, losses = pipe.train_step(state, batch,
                                        torch.Generator().manual_seed(0))
        assert all(fn.launches == 0 for fn in kernels.KERNELS.values())
        assert all(bool(torch.isfinite(v)) for v in losses.values())
        mu = state['opt_state'].mu
        assert all(m.dtype == torch.bfloat16 for m in mu.values())
        totals.append(float(losses['total_loss']))
    assert totals[0] == totals[1]

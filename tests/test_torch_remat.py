"""Activation recompute in the PyTorch/CUDA port (models/remat.py,
`backbone_remat` / `decoder_remat`, `bench.py --remat`), on the CPU in
f32.

The port's remat step against its step without remat, with the random
parts ON (NBt1D channel dropout in the encoders and the dense decoders;
Swin DropPath and the MLP decoders' dropout) and one generator seed:
losses, every gradient, the BatchNorm running statistics and the
generator's state afterwards bit-equal. Those are the two traps of
`torch.utils.checkpoint` in this port: it restores only the global RNG
states (a recompute from the caller's generator would draw other
masks), and a recompute in training mode would move the running
statistics a second time. The block-level tests below pin each trap on
its own; each fails with the trap planted back.

Against the JAX package: a small SwinV2 backbone with `remat=True` on
both sides (DropPath off), the gradients of the same scalar of its five
stage outputs within 1e-4 of each leaf's max |.| (the JAX side through
XLA's attention, no Pallas VJP); and the flax trees of remat and
chunked JAX models equal the plain ones, so their variables load into
the port's remat models unchanged (`utils/flax_weights.py`)."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_port_helpers import _randomise
from nicr_mtsa_tpu.configs import emsaformer_dve_v2 as j_emsaformer_dve_v2
from nicr_mtsa_tpu.models.backbones.swin import SwinBackbone as JSwin
from nicr_mtsa_tpu.models.multi_task import (MultiTaskModelConfig as JConfig,
                                             build_model as jax_build)
from nicr_mtsa_tpu_torch.models import remat
from nicr_mtsa_tpu_torch.models.backbones.swin import SwinBackbone
from nicr_mtsa_tpu_torch.models.blocks import make_block
from nicr_mtsa_tpu_torch.models.common import BatchNorm
from nicr_mtsa_tpu_torch.models.multi_task import build_model
from nicr_mtsa_tpu_torch.optim import AdamW
from nicr_mtsa_tpu_torch.pipeline import (
    MultiTaskPipeline, default_postprocessors, emsaformer_train_config,
    emsanet_train_config, train_task_helpers,
)
from nicr_mtsa_tpu_torch.testing import build_train_batch
from nicr_mtsa_tpu_torch.utils import flax_weights as fw

torch.set_num_threads(2)
TASKS = ('semantic', 'instance', 'orientation', 'scene', 'panoptic')
IS_THING = tuple(i < 8 for i in range(40))
# dense: 2x ResNet-18 layout with NBt1D blocks (dropout 0.2 in every
# block), dense decoders with one NBt1D block a step
DENSE = dict(backbone_rgb='resnet18', backbone_depth='resnet18',
             resnet_block='nonbottleneck1d', context_n_channels=64,
             decoder_n_channels=(64, 48, 32), decoder_n_blocks=1)
# Swin: multimodal SwinV2, DropPath rising to 0.3; MLP decoders with
# their dropout (0.1)
SWIN = dict(embed_dim=32, depths=(2, 2, 2, 1), n_heads=(1, 2, 4, 8),
            window_size=8, v2=True, n_input_channels=4, multimodal=True,
            embed_dim_depth=16, stochastic_depth=0.3)
SMALL_MLP = dict(embedding_dim=8, context_n_channels=64,
                 decoder_n_channels=(32, 16, 16, 16))


def _model(family, rm: bool):
    if family == 'dense':
        cfg = dataclasses.replace(
            emsanet_train_config((64, 96), 'float32', remat=rm), **DENSE)
        return build_model(cfg, device='cpu', train=True)
    cfg = emsaformer_train_config((128, 128), 'float32', remat=rm,
                                  **SMALL_MLP)
    bb = SwinBackbone(generator=torch.Generator().manual_seed(0), remat=rm,
                      **SWIN)
    return build_model(cfg, device='cpu', rgbd_backbone=bb, train=True)


def _step(family, rm: bool):
    model = _model(family, rm)
    pipe = MultiTaskPipeline(
        model, default_postprocessors(TASKS, IS_THING, top_k_instances=64),
        train_task_helpers(), optimizer=AdamW(1e-4))
    state = pipe.create_train_state()
    hw = (64, 96) if family == 'dense' else (128, 128)
    gen = torch.Generator().manual_seed(5)
    state, losses = pipe.train_step(
        state, build_train_batch(4, *hw, seed=0, device='cpu',
                                 rgbd=family == 'swin'), gen)
    return dict(losses={k: float(v) for k, v in losses.items()},
                grads={n: p.grad.clone() for n, p in model.named_parameters()
                       if p.grad is not None},
                stats={n: b.clone() for n, b in model.named_buffers()},
                generator=gen.get_state(),
                blocks=[m for m in model.modules()
                        if isinstance(m, remat.Recomputed)])


@pytest.fixture(scope='module', params=('dense', 'swin'))
def steps(request):
    return request.param, _step(request.param, False), \
        _step(request.param, True)


def test_remat_blocks_are_on(steps):
    family, plain, rm = steps
    assert rm['blocks'] and all(b.remat for b in rm['blocks'])
    assert not any(b.remat for b in plain['blocks'])
    # dense: 16 encoder blocks + 2 x 3 decoder blocks; Swin: 7 blocks
    assert len(rm['blocks']) == (22 if family == 'dense' else 7)


def test_remat_step_losses_equal(steps):
    _, plain, rm = steps
    assert rm['losses'] == plain['losses']


def test_remat_step_gradients_bit_equal(steps):
    _, plain, rm = steps
    assert set(rm['grads']) == set(plain['grads'])
    for n, g in plain['grads'].items():
        assert torch.equal(rm['grads'][n], g), n


def test_remat_step_batch_stats_equal(steps):
    _, plain, rm = steps
    assert set(rm['stats']) == set(plain['stats'])
    for n, s in plain['stats'].items():
        assert torch.equal(rm['stats'][n], s), n


def test_remat_step_generator_state_equal(steps):
    _, plain, rm = steps
    assert torch.equal(rm['generator'], plain['generator'])


def test_train_step_skips_the_unread_embedding_head():
    """No training loss reads the dense-visual-embedding head (bench.py
    --train's helpers: semantic, instance, scene): the step does not run
    its task head (a 512-channel full-resolution map: at B=48 it alone
    needs ~15 GB), but moves its fuse BatchNorm's statistics, as the
    JAX package's step does (XLA drops the dead head, keeps the
    statistics it returns); its parameters get no gradient (AdamW
    takes that as 0, as optax gets 0)."""
    model = _model('swin', False)
    dve = model.embedding_decoder
    calls = []
    dve.task_head.register_forward_hook(lambda *a: calls.append(1))
    before = dve.fuse.norm.running_mean.clone()
    pipe = MultiTaskPipeline(
        model, default_postprocessors(TASKS, IS_THING, top_k_instances=64),
        train_task_helpers(), optimizer=AdamW(1e-4))
    pipe.train_step(pipe.create_train_state(), build_train_batch(
        2, 128, 128, seed=0, device='cpu'), torch.Generator())
    assert not calls
    assert not torch.equal(dve.fuse.norm.running_mean, before)
    assert all(p.grad is None for p in dve.parameters())


# --- each trap on its own ----------------------------------------------------

def _nbt1d(rm: bool, dropout_p: float):
    torch.manual_seed(0)
    block = make_block('nonbottleneck1d', remat=rm, n_in=16, planes=16,
                       dropout_p=dropout_p,
                       generator=torch.Generator().manual_seed(0))
    return block.train()


def _block_grads(rm: bool, dropout_p: float):
    block = _nbt1d(rm, dropout_p)
    x = torch.randn(4, 16, 12, 10, generator=torch.Generator().manual_seed(1),
                    requires_grad=True)
    gen = torch.Generator().manual_seed(2)
    (block(x, gen) * torch.linspace(-1, 1, 10)).sum().backward()
    return block, x.grad, gen.get_state()


def test_recompute_draws_the_forward_masks():
    """Channel dropout at rate 0.5 drawn from an explicit generator: the
    recompute must draw the forward's mask (torch's checkpoint alone
    would draw the next one), and leave the generator where the step
    without recompute leaves it."""
    _, want, want_state = _block_grads(False, 0.5)
    block, got, got_state = _block_grads(True, 0.5)
    assert torch.equal(got, want)
    assert torch.equal(got_state, want_state)
    # the input gradient of the dropped channels is that of the identity
    assert bool((got != 0).all())


def test_recompute_moves_batchnorm_statistics_once():
    """A training BatchNorm updates its running statistics in its
    forward; the recompute must not update them again."""
    plain, _, _ = _block_grads(False, 0.0)
    rm, _, _ = _block_grads(True, 0.0)
    for name, b in plain.named_buffers():
        assert torch.equal(dict(rm.named_buffers())[name], b), name
    bn = plain.norm1
    assert isinstance(bn, BatchNorm)
    assert not torch.equal(bn.running_var, torch.ones_like(bn.running_var))


def test_no_recompute_without_gradients():
    """Serving and eval (no grad, inference mode) run each block once:
    the same work and kernel launches as without remat."""
    calls = []
    block = _nbt1d(True, 0.2).eval()
    inner = block.block_forward
    block.block_forward = lambda x, g=None: calls.append(1) or inner(x, g)
    x = torch.randn(2, 16, 6, 5)
    with torch.inference_mode():
        y_inf = block(x)
    with torch.no_grad():
        y_ng = block(x)
    assert len(calls) == 2
    block.remat = False
    with torch.no_grad():
        assert torch.equal(block(x), y_inf) and torch.equal(y_ng, y_inf)
    # and with grad in training, forward + recompute
    calls.clear()
    block.remat = True
    block.train()
    xg = x.clone().requires_grad_()
    block(xg, torch.Generator().manual_seed(0)).sum().backward()
    assert len(calls) == 2


# --- against the JAX package -------------------------------------------------

JSWIN = dict(embed_dim=32, depths=(2, 2, 2, 1), n_heads=(1, 2, 4, 8),
             window_size=8, v2=True, n_input_channels=4, multimodal=True,
             embed_dim_depth=16, stochastic_depth=0.0)
HS = WS = 256                 # no stage is padded (see module docstring)


@pytest.fixture(scope='module')
def swin_grads():
    jb = JSwin(remat=True, **JSWIN)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(1, HS, WS, 4)).astype(np.float32)
    template = jax.eval_shape(jb.init, jax.random.PRNGKey(0),
                              jnp.asarray(x))
    tb = SwinBackbone(generator=torch.Generator().manual_seed(0), remat=True,
                      **JSWIN)
    v = fw.torch_to_flax_variables(tb, template)
    v = {k: dict(c) for k, c in v.items()}
    _randomise(v, np.random.default_rng(1))
    fw.load_flax_variables(tb, v)
    # the scalar: each stage output times a fixed random tensor
    outs_shape = jax.eval_shape(jb.apply, v, jnp.asarray(x))
    weights = [rng.normal(size=o.shape).astype(np.float32)
               for o in outs_shape]

    def loss(params):
        outs = jb.apply({'params': params}, jnp.asarray(x), train=True)
        return sum(jnp.sum(o * w) for o, w in zip(outs, weights))
    with jax.default_matmul_precision('highest'):
        jg = jax.jit(jax.grad(loss))(v['params'])
    want = fw.flax_tree_to_torch(jax.tree_util.tree_map(np.asarray, jg))

    tb.train()
    y = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    total = 0.0
    for i, w in enumerate(weights):
        y = tb.forward_stage(i, y)
        total = total + (y * torch.from_numpy(
            np.ascontiguousarray(w.transpose(0, 3, 1, 2)))).sum()
    total.backward()
    got = {n: p.grad for n, p in tb.named_parameters()}
    return got, want, tb


def test_swin_remat_gradients_match_jax_remat(swin_grads):
    got, want, _ = swin_grads
    assert set(got) == set(want)
    for n, w in want.items():
        err = float(np.abs(got[n].numpy() - w).max()) / max(
            float(np.abs(w).max()), 1e-12)
        assert err <= 1e-4, (n, err)


def test_swin_remat_blocks_recompute(swin_grads):
    _, _, tb = swin_grads
    blocks = [m for m in tb.modules() if isinstance(m, remat.Recomputed)]
    assert len(blocks) == sum(JSWIN['depths']) and all(b.remat
                                                      for b in blocks)


# --- the variables of remat and chunked JAX models ---------------------------

def _shapes(tree):
    return jax.tree_util.tree_map(lambda a: tuple(a.shape), tree)


DENSE_J = dict(DENSE, tasks=('semantic', 'instance', 'orientation',
                             'scene'), input_size=(64, 96))


@pytest.mark.parametrize('family', ['dense', 'swin'])
def test_remat_and_chunked_jax_trees_load_unchanged(family):
    """flax's remat and the attention chunking leave the JAX tree as it
    is: the port's remat (and chunked) model, whose parameters are those
    of its model without them, maps strictly onto the remat JAX tree
    (every leaf from a port tensor of its shape, every port tensor into
    a leaf), and the loader fills another port model from it leaf for
    leaf (the training trees: test_torch_remat_train_step.py steps both
    packages' remat models from one set of variables)."""
    if family == 'dense':
        base = JConfig(**DENSE_J)
        x = {'rgb': jnp.zeros((1, 64, 96, 3)),
             'depth': jnp.zeros((1, 64, 96, 1))}
        variant = dict(backbone_remat=True, decoder_remat=True)
        port_cfg = dataclasses.replace(
            emsanet_train_config((64, 96), 'float32', remat=True),
            **DENSE, defer_semantic_prediction_upsampling='all')
        tasks_cfg = dict(defer_semantic_prediction_upsampling='all')
    else:
        base = j_emsaformer_dve_v2(input_size=(64, 96), dtype=jnp.float32)
        x = {'rgbd': jnp.zeros((1, 64, 96, 4))}
        variant = dict(backbone_remat=True, backbone_attn_chunk_size=2)
        port_cfg = dataclasses.replace(emsaformer_train_config(
            (64, 96), 'float32', remat=True, backbone_attn_chunk_size=2),
            defer_semantic_prediction_upsampling='all')
        tasks_cfg = dict(defer_semantic_prediction_upsampling='all')
    base = dataclasses.replace(base, **tasks_cfg)

    def tree(cfg):
        m = jax_build(cfg)
        return jax.eval_shape(lambda: m.init(
            {'params': jax.random.PRNGKey(0)}, x, train=False))
    varied = tree(dataclasses.replace(base, **variant))

    model = build_model(port_cfg, device='cpu')
    v = fw.torch_to_flax_variables(model, varied)
    assert _shapes(v) == _shapes(varied)
    assert dict(fw.flax_tree_to_torch(v['params'])).keys() == dict(
        model.named_parameters()).keys()
    other = build_model(port_cfg, device='cpu', seed=1)
    fw.load_flax_variables(other, v)
    for n, t in model.state_dict().items():
        assert torch.equal(other.state_dict()[n], t), n
    blocks = [m for m in other.modules() if isinstance(m, remat.Recomputed)]
    assert blocks and all(b.remat for b in blocks)
    if family == 'swin':
        assert all(b.attn_chunk_size == 2 for b in blocks)

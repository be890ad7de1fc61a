"""Training mode of the PyTorch/CUDA port's modules against the JAX
package, on the CPU in f32:

- a SwinV2 block (C 64, 2 heads, 8 x 8 windows) trained through the
  Pallas window-attention VJP in interpret mode: the gradients with
  respect to x and every parameter (cpb_fc*, logit_scale and the qkv
  bias's k third, an exact 0, included) within 1e-4 of max |.|, the
  output within 1e-5; unshifted, shifted, and on a padded image, where
  the JAX package's gradient of the v2 key norm at the zero keys of the
  pad is NaN (its qkv leaves; the port's, torch's norm convention,
  are 0 there) and every other leaf is compared;
- a BatchNorm training step: output, input gradient and the new
  running statistics (flax's rule, biased variance) within 1e-5;
- DropPath and the channel Dropout: mask shape, scaling by 1 / keep,
  the identity in eval mode or at rate 0, reproducible from the
  generator."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nicr_mtsa_tpu.models.backbones.swin import SwinBlock
from nicr_mtsa_tpu.models.common import Norm
from nicr_mtsa_tpu_torch.models.backbones.swin import (
    DropPath, SwinBlock as TSwinBlock,
)
from nicr_mtsa_tpu_torch.models.common import BatchNorm, Dropout
from nicr_mtsa_tpu_torch.utils.flax_weights import (
    flax_tree_to_torch, load_flax_variables,
)
from _torch_port_helpers import _randomise

torch.set_num_threads(2)
C, HEADS, WS = 64, 2, 8
# name: (image H, W, shift)
BLOCK_CASES = {'unshifted': (16, 24, 0), 'shifted': (16, 24, 4),
               'padded': (12, 20, 4)}


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


@pytest.fixture(scope='module', params=sorted(BLOCK_CASES))
def block_grads(request):
    H, W, shift = BLOCK_CASES[request.param]
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, H, W, C)).astype(np.float32)
    w = rng.normal(size=(2, H, W, C)).astype(np.float32)
    jb = SwinBlock(dim=C, n_heads=HEADS, window_size=WS, shift=shift,
                   v2=True, drop_path=0.0, attn_backend='pallas-interpret')
    params = _np_tree(jax.jit(jb.init)(jax.random.PRNGKey(0),
                                        jnp.asarray(x))['params'])
    tree = {'params': dict(params)}
    _randomise(tree, rng)              # LN scales and biases off identity
    params = tree['params']

    def loss(p, xin):
        out = jb.apply({'params': p}, xin, train=True)
        return jnp.sum(out * jnp.asarray(w)), out

    with jax.default_matmul_precision('highest'):
        (_, out), (g_p, g_x) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))

    tb = TSwinBlock(C, HEADS, WS, shift=shift, v2=True).train()
    load_flax_variables(tb, {'params': params})
    xt = torch.from_numpy(x).requires_grad_()
    out_t = tb(xt)
    (out_t * torch.from_numpy(w)).sum().backward()
    got = {n: p.grad for n, p in tb.named_parameters()}
    return dict(want_out=np.asarray(out), got_out=out_t.detach().numpy(),
                want_dx=np.asarray(g_x), got_dx=xt.grad.numpy(),
                want=flax_tree_to_torch(_np_tree(g_p)), got=got,
                padded=request.param == 'padded')


def test_swinv2_block_gradients_match_jax(block_grads):
    b = block_grads
    tol = lambda a: 1e-4 * max(float(np.abs(a).max()), 1e-30)
    assert np.abs(b['got_out'] - b['want_out']).max() <= 1e-5 * np.abs(
        b['want_out']).max()
    assert np.abs(b['got_dx'] - b['want_dx']).max() <= tol(b['want_dx'])
    assert set(b['got']) == set(b['want'])
    for name in ('attn.cpb_fc1.weight', 'attn.cpb_fc2.weight',
                 'attn.logit_scale'):
        assert float(b['got'][name].abs().max()) > 0, name
    # the k third of the qkv bias: an exact 0 gradient
    assert torch.equal(b['got']['attn.qkv.bias'][C:2 * C],
                       torch.zeros(C))
    for name, want in b['want'].items():
        got = b['got'][name].numpy()
        assert np.isfinite(got).all(), name
        if not np.isfinite(want).all():
            # the JAX package's NaN at the pad's zero keys (v2 norm)
            assert b['padded'] and name.startswith('attn.qkv.'), name
            continue
        assert np.abs(got - want).max() <= tol(want), name


def test_batchnorm_training_step_matches_flax():
    rng = np.random.default_rng(6)
    x = (rng.normal(size=(3, 5, 6, 8)) * 2 + 0.5).astype(np.float32)
    gy = rng.normal(size=x.shape).astype(np.float32)
    jn = Norm('batchnorm')
    v = _np_tree(jax.jit(jn.init)(jax.random.PRNGKey(0), jnp.asarray(x)))
    v = {k: dict(c) for k, c in v.items()}
    _randomise(v, rng)

    def f(params, xin):
        y, upd = jn.apply({'params': params,
                           'batch_stats': v['batch_stats']}, xin,
                          train=True, mutable=['batch_stats'])
        return jnp.sum(y * jnp.asarray(gy)), (y, upd['batch_stats'])

    (_, (y, stats)), (g_p, g_x) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(v['params'], jnp.asarray(x))
    bn = BatchNorm(8).train()
    load_flax_variables(bn, v)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).requires_grad_()
    yt = bn(xt)
    (yt * torch.from_numpy(gy.transpose(0, 3, 1, 2).copy())).sum().backward()
    close = lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-5,
                                                    atol=1e-5)
    close(yt.detach().numpy().transpose(0, 2, 3, 1), np.asarray(y))
    close(xt.grad.numpy().transpose(0, 2, 3, 1), np.asarray(g_x))
    want = flax_tree_to_torch(_np_tree(stats), 'batch_stats')
    want.update(flax_tree_to_torch(_np_tree(g_p)))
    close(bn.running_mean.numpy(), want['running_mean'])
    close(bn.running_var.numpy(), want['running_var'])
    close(bn.weight.grad.numpy(), want['weight'])
    close(bn.bias.grad.numpy(), want['bias'])


@pytest.mark.parametrize('kind', ['droppath', 'dropout'])
def test_stochastic_modules(kind):
    rate = 0.3
    mod = DropPath(rate) if kind == 'droppath' else Dropout(rate)
    x = torch.arange(1, 1 + 64 * 4 * 5 * 6, dtype=torch.float32).reshape(
        64, 4, 5, 6)
    draw = lambda seed: mod.train()(x, torch.Generator().manual_seed(seed))
    y = draw(0)
    kept = y != 0
    # one draw per sample (DropPath) or per (sample, channel) (Dropout),
    # broadcast over the rest
    per = kept[:, :1, :1, :1] if kind == 'droppath' else kept[:, :, :1, :1]
    assert torch.equal(kept, per.expand_as(kept))
    assert 0 < int(per.sum()) < per.numel()
    torch.testing.assert_close(y[kept], x[kept] / (1 - rate), rtol=1e-6,
                               atol=0)
    assert torch.equal(draw(0), y)
    assert not torch.equal(draw(1), y)
    assert mod.eval()(x) is x
    mod.rate = 0.0
    assert mod.train()(x, torch.Generator()) is x


def test_resize_cached_in_inference_mode_trains():
    """The bilinear resize's cached taps, first built while serving
    under inference mode, can be saved for a later backward."""
    from nicr_mtsa_tpu_torch.models.upsampling import resize_bilinear
    with torch.inference_mode():
        resize_bilinear(torch.zeros(1, 2, 5, 7), 19, 23)
    x = torch.ones(1, 2, 5, 7, requires_grad=True)
    resize_bilinear(x, 19, 23).sum().backward()
    assert torch.allclose(x.grad.sum(), torch.tensor(2 * 19 * 23.0))

"""Window-attention chunking in the PyTorch/CUDA port's Swin blocks
(`backbone_attn_chunk_size`, `bench.py --attn-chunk`) against the JAX
package's `SwinBlock(attn_chunk_size=...)`, on the CPU in f32.

A shifted SwinV2 block (C 64, 2 heads, 8 x 8 windows on a 16 x 16
image: a 2 x 2 window grid, the shift mask on) with chunk size 2, at
B=4 (two chunks) and B=3 (no chunking: the chunk size must divide a
larger batch), on the plain versions of both inference routes ('auto',
the whole sub-block; 'qkv', attention over the packed qkv) and in
training (the differentiable core):
- inference: outputs within 1e-4 of the JAX block's;
- training: the gradients of one scalar of the output, for the input
  and every parameter, within 1e-4 of each one's max |.|;
- the attention part runs once a chunk, and the chunked output equals
  the port's unchunked output bit for bit at inference (a window never
  spans two images)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_port_helpers import _randomise
from nicr_mtsa_tpu.models.backbones.swin import SwinBlock as JBlock
from nicr_mtsa_tpu_torch.models.backbones.swin import SwinBlock
from nicr_mtsa_tpu_torch.utils import flax_weights as fw

torch.set_num_threads(2)
C, HEADS, WS, SHIFT, HW, CS = 64, 2, 8, 4, 16, 2
TOL = 1e-4


def _blocks(route, chunk):
    jb = JBlock(dim=C, n_heads=HEADS, window_size=WS, shift=SHIFT, v2=True,
                attn_chunk_size=chunk)
    tb = SwinBlock(C, HEADS, WS, shift=SHIFT, v2=True,
                   generator=torch.Generator().manual_seed(0),
                   attn_backend='auto' if route == 'train' else route,
                   attn_chunk_size=chunk)
    template = jax.eval_shape(jb.init, jax.random.PRNGKey(0),
                              jnp.zeros((1, HW, HW, C)))
    v = fw.torch_to_flax_variables(tb, template)
    v = {k: dict(c) for k, c in v.items()}
    _randomise(v, np.random.default_rng(1))
    fw.load_flax_variables(tb, v)
    return jb, tb.train(route == 'train'), v


def _calls(tb):
    """Count the block's attention-part calls (one a chunk)."""
    inner, n = tb.attn.forward_image, []

    def counted(*a, **k):
        n.append(1)
        return inner(*a, **k)
    tb.attn.forward_image = counted
    return n


CASES = [(r, B) for r in ('auto', 'qkv', 'train') for B in (4, 3)]


@pytest.mark.parametrize('route,B', CASES,
                         ids=[f'{r}-B{B}' for r, B in CASES])
def test_chunked_block_matches_jax(route, B):
    jb, tb, v = _blocks(route, CS)
    rng = np.random.default_rng(B)
    x = rng.normal(size=(B, HW, HW, C)).astype(np.float32)
    r = rng.normal(size=x.shape).astype(np.float32)
    n = _calls(tb)
    xt = torch.from_numpy(x)
    if route != 'train':
        with jax.default_matmul_precision('highest'):
            want = np.asarray(jax.jit(lambda v, x: jb.apply(v, x))(
                v, jnp.asarray(x)))
        with torch.inference_mode():
            got = tb(xt).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    else:
        def loss(params, x):
            return jnp.sum(jb.apply({'params': params}, x, train=True) * r)
        with jax.default_matmul_precision('highest'):
            gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(
                v['params'], jnp.asarray(x))
        want = fw.flax_tree_to_torch(jax.tree_util.tree_map(np.asarray, gp))
        want['x'] = np.asarray(gx)
        xt.requires_grad_()
        (tb(xt, torch.Generator()) * torch.from_numpy(r)).sum().backward()
        got = {name: p.grad.numpy() for name, p in tb.named_parameters()
               if p.grad is not None}
        got['x'] = xt.grad.numpy()
        assert set(got) == set(want)
        for name, w in want.items():
            err = float(np.abs(got[name] - w).max()) / max(
                float(np.abs(w).max()), 1e-12)
            assert err <= TOL, (name, err)
    # B=4: two chunks of 2; B=3: the whole batch at once
    assert len(n) == (B // CS if B > CS and B % CS == 0 else 1)


@pytest.mark.parametrize('route', ['auto', 'qkv'])
def test_chunked_equals_unchunked(route):
    _, chunked, _ = _blocks(route, CS)
    _, whole, _ = _blocks(route, 0)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(4, HW, HW, C)).astype(np.float32))
    n = _calls(chunked)
    with torch.inference_mode():
        assert torch.equal(chunked(x), whole(x))
    assert len(n) == 2

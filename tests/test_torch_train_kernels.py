"""Row 7 of the PyTorch/CUDA port (nicr_mtsa_tpu_torch/ops/cuda/
window_attention_core.py) against the JAX package's
`fused_window_attention` (ops/pallas/window_attention.py) in interpret
mode, on the CPU in f32: the plain forward and its logsumexp against
the kernel's (`_fwd_call`), the plain backward against `jax.vjp` of the
kernel's custom VJP (dq, dk, dv and dbias, within 1e-5 of max |.|), and
the plain backward against torch autograd of the plain forward; for
v2's unshifted and shifted 64-token windows and a shifted v1 window of
49 tokens. In bf16 the plain backward is held against `jax.vjp` of the
kernel too (the same rounding points), and the backward kernel's
window partition is checked on the shapes of training. The CUDA
kernels themselves are checked on the card by chip_smoke.py."""
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nicr_mtsa_tpu.models.backbones.swin import _shift_attn_mask
from nicr_mtsa_tpu.ops.pallas.window_attention import (
    PADDED_TOKENS, _fwd_call, build_bias_pair, build_pattern_pairs,
    fused_window_attention, pick_tile_windows,
)
from nicr_mtsa_tpu_torch.ops.cuda import window_attention_core as wac

torch.set_num_threads(2)
TOL = 1e-5
# bf16: one bf16 ulp (2^-8) of max |.|; another f32 summation order can
# flip the rounding of P, dS or an output value by one ulp
BF16_TOL = 2.0 ** -8
GRID = (2, 3)                     # window grid of each of 2 images
# name: (tokens per window, shift or None)
CASES = {'v2_unshifted': (64, None), 'v2_shifted': (64, (4, 4)),
         'v1_shifted_49': (49, (3, 3))}


def _inputs(N, seed, C=64):
    """q (scaled), k, v, the upstream gradient (12, N, C) and the
    (h, N, N) bias, f32 numpy."""
    rng = np.random.default_rng(seed)
    Bw, h = 2 * GRID[0] * GRID[1], C // 32
    r = lambda *s: rng.normal(size=s).astype(np.float32)
    return r(Bw, N, C) * 2, r(Bw, N, C), r(Bw, N, C), r(Bw, N, C), \
        r(h, N, N)


def _jax_masks(N, shift):
    ws = math.isqrt(N)
    if shift is None:
        return (1, 1), None
    return GRID, _shift_attn_mask(GRID[0] * ws, GRID[1] * ws, ws, *shift)


def _jax_forward(q, k, v, bias, N, shift):
    """(out, lse (Bw, h, N)) of the TPU kernel's forward in interpret
    mode; its lse comes in window pairs (Bw / 2, h, 2 Np)."""
    grid, masks = _jax_masks(N, shift)
    Bw, _, C = q.shape
    h, Np = bias.shape[0], PADDED_TOKENS
    pad = lambda a: jnp.pad(jnp.asarray(a), ((0, 0), (0, Np - N), (0, 0)))
    bias_p = jnp.pad(jnp.asarray(bias), ((0, 0), (0, Np - N), (0, Np - N)))
    patterns = jnp.asarray(build_pattern_pairs(
        Np, masks, grid, n_valid=N if N < Np else None))
    out, lse = _fwd_call(pad(q), pad(k), pad(v), build_bias_pair(bias_p),
                         patterns, h, tuple(grid), pick_tile_windows(Bw, C),
                         True)
    lse = np.asarray(lse).reshape(Bw // 2, h, 2, Np).transpose(0, 2, 1, 3)
    return np.asarray(out)[:, :N], lse.reshape(Bw, h, Np)[..., :N]


def _close(got, want, name, tol=TOL):
    got = (got.detach().float().numpy() if isinstance(got, torch.Tensor)
           else got)
    want = np.asarray(want, dtype=np.float32)
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (name, err, np.abs(want).max())


@pytest.mark.parametrize('case', sorted(CASES))
def test_plain_forward_and_lse_match_pallas(case):
    N, shift = CASES[case]
    q, k, v, _, bias = _inputs(N, 1)
    with jax.default_matmul_precision('highest'):
        want_out, want_lse = _jax_forward(q, k, v, bias, N, shift)
        grid, masks = _jax_masks(N, shift)
        want_api = fused_window_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(bias), bias.shape[0], grid, masks, interpret=True)
    t = [torch.from_numpy(a) for a in (q, k, v, bias)]
    out, lse = wac.window_attention_core_reference(*t, grid, shift)
    _close(out, want_out, 'out')
    _close(out, want_api, 'out (fused_window_attention)')
    _close(lse, want_lse, 'lse')
    # the wrapper takes the plain version for CPU tensors, uncounted
    before = wac.window_attention_core_forward.launches
    got = wac.window_attention_core_forward(*t, grid, shift)
    assert torch.equal(got[0], out) and torch.equal(got[1], lse)
    assert wac.window_attention_core_forward.launches == before


@pytest.mark.parametrize('case', sorted(CASES))
def test_plain_backward_matches_pallas_vjp(case):
    N, shift = CASES[case]
    q, k, v, do, bias = _inputs(N, 2)
    grid, masks = _jax_masks(N, shift)
    h = bias.shape[0]
    with jax.default_matmul_precision('highest'):
        _, vjp = jax.vjp(
            lambda q_, k_, v_, b_: fused_window_attention(
                q_, k_, v_, b_, h, grid, masks, interpret=True),
            *(jnp.asarray(a) for a in (q, k, v, bias)))
        want = vjp(jnp.asarray(do))
    t = [torch.from_numpy(a) for a in (q, k, v, bias)]
    _, lse = wac.window_attention_core_reference(*t, grid, shift)
    got = wac.window_attention_core_backward_reference(
        *t, torch.from_numpy(do), lse, grid, shift)
    for name, g, w in zip(('dq', 'dk', 'dv', 'dbias'), got, want):
        _close(g, w, name)


@pytest.mark.parametrize('case', sorted(CASES))
def test_plain_backward_bf16_matches_pallas_vjp(case):
    """bf16 q, k, v and dO (bias f32) through `jax.vjp` of the kernel's
    custom VJP and through the plain backward, which rounds P, dS and
    the outputs to bf16 where the TPU kernel does: dq, dk, dv and dbias
    within 2^-8 of max |.|."""
    N, shift = CASES[case]
    q, k, v, do, bias = _inputs(N, 5)
    t = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v, do)]
    j = [jnp.asarray(a.float().numpy()).astype(jnp.bfloat16) for a in t]
    grid, masks = _jax_masks(N, shift)
    h = bias.shape[0]
    with jax.default_matmul_precision('highest'):
        _, vjp = jax.vjp(
            lambda q_, k_, v_, b_: fused_window_attention(
                q_, k_, v_, b_, h, grid, masks, interpret=True),
            *j[:3], jnp.asarray(bias))
        want = vjp(j[3])
    tb = torch.from_numpy(bias)
    _, lse = wac.window_attention_core_reference(*t[:3], tb, grid, shift)
    got = wac.window_attention_core_backward_reference(
        *t[:3], tb, t[3], lse, grid, shift)
    for name, g, w in zip(('dq', 'dk', 'dv', 'dbias'), got, want):
        assert g.dtype == (torch.float32 if name == 'dbias'
                           else torch.bfloat16), name
        _close(g, w, name, BF16_TOL)


@pytest.mark.parametrize('case', sorted(CASES))
def test_plain_backward_matches_autograd(case):
    """The step-by-step plain backward (and the autograd.Function that
    dispatches to it on the CPU) against torch autograd of the plain
    forward."""
    N, shift = CASES[case]
    q, k, v, do, bias = _inputs(N, 3)
    t = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, bias)]
    out, lse = wac.window_attention_core_reference(*t, shift=shift,
                                                   grid_hw=GRID)
    want = torch.autograd.grad(out, t, torch.from_numpy(do))
    with torch.no_grad():
        got = wac.window_attention_core_backward_reference(
            *t, torch.from_numpy(do), lse, GRID, shift)
    for name, g, w in zip(('dq', 'dk', 'dv', 'dbias'), got, want):
        _close(g, w.numpy(), name)
    before = (wac.window_attention_core_forward.launches,
              wac.window_attention_core_backward.launches,
              wac.dbias_reduce.launches)
    out_fn = wac.window_attention_core(*t, GRID, shift)
    assert torch.equal(out_fn, out)
    via_fn = torch.autograd.grad(out_fn, t, torch.from_numpy(do))
    for g, w in zip(via_fn, got):
        assert torch.equal(g, w)
    assert before == (wac.window_attention_core_forward.launches,
                      wac.window_attention_core_backward.launches,
                      wac.dbias_reduce.launches)


def test_dbias_reduce_plain_sums_in_order():
    """The reduction's plain version adds the partials in order 0 .. G-1
    (the kernel's order), and equals their sum."""
    parts = torch.from_numpy(np.random.default_rng(4).normal(
        size=(5, 2, 49, 49)).astype(np.float32))
    want = parts[0] + parts[1] + parts[2] + parts[3] + parts[4]
    assert torch.equal(wac.dbias_reduce(parts), want)


@pytest.mark.parametrize('G, h', [(134, 4), (72, 8), (40, 16), (24, 32)])
def test_dbias_reduce_plain_near_float64_sum(G, h):
    """At the partial shapes of stages 1 to 4 of B=8 480 x 640 training
    the plain reduction lies within G f32 ulps of max |.| of the float64
    sum."""
    parts = np.random.default_rng(G).normal(size=(G, h, 64, 64)).astype(
        np.float32)
    want = parts.astype(np.float64).sum(0)
    got = wac.dbias_reduce(torch.from_numpy(parts)).numpy()
    tol = G * float(np.spacing(np.float32(np.abs(want).max())))
    assert float(np.abs(got - want).max()) <= tol


@pytest.mark.parametrize('Bw, h', [(2400, 4), (640, 8), (160, 16), (48, 32),
                                   (24, 4), (12, 2), (7, 1)])
def test_bwd_partition_covers_each_window_once(Bw, h):
    """The backward's blocks of a head own contiguous, non-empty window
    ranges that cover every window exactly once, in one wave of
    BWD_SLOTS blocks at the stages of B=8 480 x 640 training, and the
    partition is a function of (Bw, h) alone."""
    wpb, G = wac.bwd_partition(Bw, h)
    covered = [g for grp in range(G)
               for g in range(grp * wpb, min(Bw, (grp + 1) * wpb))]
    assert covered == list(range(Bw))
    assert (G - 1) * wpb < Bw                  # no empty block
    assert G * h <= wac.BWD_SLOTS
    assert wac.bwd_partition(int(Bw), int(h)) == (wpb, G)

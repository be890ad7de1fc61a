"""Kernel parity of the PyTorch/CUDA port (nicr_mtsa_tpu_torch) against
the JAX package's Pallas kernels, on the CPU.

On CPU tensors the port's kernel wrappers run their plain PyTorch
versions; the Pallas kernels run in interpret mode, as the JAX
package's own tests run them. Inputs come from numpy seeds. The
finisher's idx and the grouping's ids/min_d2 must be bit-identical;
the finisher score (a 40-term exp sum taken in another order) to rtol
1e-5. The kernels themselves are held against the same plain versions
on the card by chip_smoke.py."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nicr_mtsa_tpu.models.upsampling import fused_zeropad_2x_kernel
from nicr_mtsa_tpu.ops.grouping import group_pixels
from nicr_mtsa_tpu.ops.pallas.grouping_kernel import group_pixels_pallas
from nicr_mtsa_tpu.ops.pallas.semantic_finisher4x import (
    upsample4x_argmax_score,
)
from nicr_mtsa_tpu_torch.models import upsampling as t_up
from nicr_mtsa_tpu_torch.ops.cuda import finisher4x as t_fin
from nicr_mtsa_tpu_torch.ops.cuda import grouping as t_grp

torch.set_num_threads(2)


def _hwio_to_torch(k):
    return torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))


def _finisher_case(seed, B=8, H=8, W=32, C=40):
    # C=40: interpret mode mispads small class counts
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, H, W, C)).astype(np.float32)
    k1 = rng.normal(0, 0.1, size=(3, 3, 1, C)).astype(np.float32)
    b1 = rng.normal(0, 0.05, size=(C,)).astype(np.float32)
    k2 = rng.normal(0, 0.1, size=(3, 3, 1, C)).astype(np.float32)
    b2 = rng.normal(0, 0.05, size=(C,)).astype(np.float32)
    return x, k1, b1, k2, b2


def _port_finisher(x, k1, b1, k2, b2, dtype):
    """x: numpy NHWC whose values are representable in `dtype`."""
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    b1 = None if b1 is None else torch.from_numpy(b1)
    b2 = None if b2 is None else torch.from_numpy(b2)
    idx, score = t_fin.upsample4x_argmax_score(
        xt.to(dtype), _hwio_to_torch(k1), b1, _hwio_to_torch(k2), b2)
    return idx.numpy(), score.numpy()


def test_fused_kernel_weights_exact():
    _, k1, _, _, _ = _finisher_case(1)
    want = np.asarray(fused_zeropad_2x_kernel(jnp.asarray(k1)))
    got = t_up.fused_zeropad_2x_kernel(_hwio_to_torch(k1)).numpy()
    np.testing.assert_array_equal(got.transpose(2, 3, 1, 0), want)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_finisher_matches_pallas_interpret(dtype):
    x, k1, b1, k2, b2 = _finisher_case(7)
    xj = jnp.asarray(x, getattr(jnp, dtype))
    idx_j, score_j = upsample4x_argmax_score(
        xj, jnp.asarray(k1), jnp.asarray(b1), jnp.asarray(k2),
        jnp.asarray(b2), interpret=True)
    x_rounded = np.array(xj.astype(jnp.float32))
    idx_t, score_t = _port_finisher(x_rounded, k1, b1, k2, b2,
                                    getattr(torch, dtype))
    assert idx_t.shape == (8, 32, 128) and idx_t.dtype == np.int32
    np.testing.assert_array_equal(idx_t, np.asarray(idx_j))
    np.testing.assert_allclose(score_t, np.asarray(score_j), rtol=1e-5)


def _zeropad_2x_f64(x, kern, bias):
    B, H, W, C = x.shape
    up = np.repeat(np.repeat(x.astype(np.float64), 2, 1), 2, 2)
    upp = np.pad(up, ((0, 0), (1, 1), (1, 1), (0, 0)))
    out = np.zeros_like(up)
    for dy in range(3):
        for dx in range(3):
            out += (kern[dy, dx, 0].astype(np.float64)
                    * upp[:, dy:dy + 2 * H, dx:dx + 2 * W, :])
    return out + bias.astype(np.float64)


def test_finisher_matches_float64_oracle():
    x, k1, b1, k2, b2 = _finisher_case(3)
    logits = _zeropad_2x_f64(_zeropad_2x_f64(x, k1, b1), k2, b2)
    m = logits.max(axis=-1, keepdims=True)
    idx_t, score_t = _port_finisher(x, k1, b1, k2, b2, torch.float32)
    np.testing.assert_array_equal(idx_t, np.argmax(logits, axis=-1))
    np.testing.assert_allclose(
        score_t, 1.0 / np.sum(np.exp(logits - m), axis=-1), rtol=1e-4)


def test_finisher_tie_break_first():
    B, H, W, C = 2, 4, 8, 8
    x = np.zeros((B, H, W, C), np.float32)
    x[..., 2] = 1.5
    x[..., 5] = 1.5              # tie with class 2 -> first wins
    kern = np.zeros((3, 3, 1, C), np.float32)
    kern[1, 1] = 1.0             # centre tap: ties survive both stages
    idx, score = _port_finisher(x, kern, None, kern, None, torch.float32)
    assert (idx == 2).all()
    # the centre tap copies each logit: two at 1.5, six at 0
    np.testing.assert_allclose(score, 1.0 / (2 + 6 * np.exp(-1.5)),
                               rtol=1e-6)


def test_finisher_dense_logits_match_jax_exact_twin():
    from nicr_mtsa_tpu.models.upsampling import _finisher4x_logits_exact
    x, k1, b1, k2, b2 = _finisher_case(5, B=2, H=5, W=7, C=6)
    xj = jnp.asarray(x, jnp.bfloat16)
    want = _finisher4x_logits_exact(xj, jnp.asarray(k1), jnp.asarray(b1),
                                    jnp.asarray(k2), jnp.asarray(b2))
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32)))
    got = t_up.finisher4x_logits_exact(
        xt.permute(0, 3, 1, 2).to(torch.bfloat16), _hwio_to_torch(k1),
        torch.from_numpy(b1), _hwio_to_torch(k2), torch.from_numpy(b2))
    np.testing.assert_array_equal(
        got.float().numpy().transpose(0, 2, 3, 1),
        np.asarray(want.astype(jnp.float32)))


def _grouping_case(seed, B, P, K, p_valid=0.7):
    rng = np.random.default_rng(seed)
    H = 16
    loc_y = rng.uniform(-4, H + 4, (B, P)).astype(np.float32)
    loc_x = rng.uniform(-4, 132, (B, P)).astype(np.float32)
    centers = rng.integers(0, (H, 128), (B, K, 2)).astype(np.float32)
    valid = rng.random((B, K)) < p_valid
    fg = rng.random((B, P)) > 0.3
    return loc_y, loc_x, centers, valid, fg


def _port_grouping(loc_y, loc_x, centers, valid, fg):
    ids, d2 = t_grp.group_pixels_kernel(
        torch.from_numpy(loc_y), torch.from_numpy(loc_x),
        torch.from_numpy(centers), torch.from_numpy(valid),
        torch.from_numpy(fg))
    return ids.numpy(), d2.numpy()


@pytest.mark.parametrize('P,p_valid', [(8192, 0.7), (3001, 0.7),
                                       (8192, 0.0)])
def test_grouping_matches_pallas_interpret(P, p_valid):
    args = _grouping_case(1, 2, P, 64, p_valid)
    ids_j, d2_j = group_pixels_pallas(*map(jnp.asarray, args),
                                      interpret=True)
    ids_t, d2_t = _port_grouping(*args)
    assert ids_t.dtype == np.int32 and d2_t.dtype == np.float32
    np.testing.assert_array_equal(ids_t, np.asarray(ids_j))
    np.testing.assert_array_equal(d2_t, np.asarray(d2_j))
    if p_valid == 0.0:
        assert (ids_t == 0).all()


def test_grouping_matches_xla_branch():
    rng = np.random.default_rng(2)
    B, H, W, K = 2, 16, 96, 64
    centers = rng.integers(0, (H, W), (B, K, 2)).astype(np.int32)
    valid = rng.random((B, K)) > 0.3
    offset = (rng.normal(size=(B, H, W, 2)) * 3).astype(np.float32)
    fg = rng.random((B, H, W)) > 0.4
    want = group_pixels(jnp.asarray(centers), jnp.asarray(valid),
                        jnp.asarray(offset), jnp.asarray(fg),
                        backend='xla')
    yy, xx = np.mgrid[:H, :W].astype(np.float32)
    loc_y = (yy[None] + offset[..., 0]).reshape(B, H * W)
    loc_x = (xx[None] + offset[..., 1]).reshape(B, H * W)
    ids_t, _ = _port_grouping(loc_y, loc_x, centers.astype(np.float32),
                              valid, fg.reshape(B, H * W))
    np.testing.assert_array_equal(ids_t.reshape(B, H, W), np.asarray(want))


def test_grouping_ties_first_centre():
    # two identical valid centres: the first one wins every pixel
    loc = np.zeros((1, 64), np.float32)
    centers = np.array([[[5.0, 5.0], [1.0, 1.0], [1.0, 1.0]]], np.float32)
    valid = np.array([[False, True, True]])
    ids, d2 = _port_grouping(loc, loc, centers, valid, np.ones((1, 64), bool))
    assert (ids == 2).all()
    np.testing.assert_array_equal(d2, 2.0)


def test_wrappers_count_no_cpu_launch():
    before = (t_fin.upsample4x_argmax_score.launches,
              t_grp.group_pixels_kernel.launches)
    _port_grouping(*_grouping_case(4, 1, 256, 4))
    x, k1, b1, k2, b2 = _finisher_case(4, B=1, H=2, W=2, C=3)
    _port_finisher(x, k1, b1, k2, b2, torch.float32)
    assert (t_fin.upsample4x_argmax_score.launches,
            t_grp.group_pixels_kernel.launches) == before


@pytest.mark.cuda
def test_kernels_on_card():
    """Kernel vs plain version on the card (skipped without one;
    chip_smoke.py runs the same comparison at the serving shapes)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    x, k1, b1, k2, b2 = _finisher_case(9)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).cuda()
    args = (_hwio_to_torch(k1).cuda(), torch.from_numpy(b1).cuda(),
            _hwio_to_torch(k2).cuda(), torch.from_numpy(b2).cuda())
    for dt in (torch.float32, torch.bfloat16):
        i_k, s_k = t_fin.upsample4x_argmax_score(xt.to(dt), *args)
        i_r, s_r = t_fin.upsample4x_argmax_score_reference(xt.to(dt), *args)
        assert torch.equal(i_k, i_r)
        torch.testing.assert_close(s_k, s_r, rtol=1e-5, atol=0)
    g = [torch.from_numpy(a).cuda() for a in _grouping_case(1, 2, 3001, 64)]
    for a, b in zip(t_grp.group_pixels_kernel(*g),
                    t_grp.group_pixels_reference(*g)):
        assert torch.equal(a, b)

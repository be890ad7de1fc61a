"""The 4x semantic finisher of the PyTorch/CUDA port
(nicr_mtsa_tpu_torch/ops/cuda/finisher4x.py) on the CPU: the host plan
of its CUDA kernel (tiles, staged windows, staging mode), the cache of
packed stage weights, and both entries on channels-last and NCHW inputs
against the JAX package's Pallas kernel in interpret mode.

On CPU tensors the wrappers run their plain PyTorch versions; the CUDA
kernel is held against the same plain versions on the card by
chip_smoke.py. idx must be bit-identical; scores within rtol 1e-5."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nicr_mtsa_tpu.ops.pallas.semantic_finisher4x import (
    upsample4x_argmax_score, upsample4x_bilinear_argmax_score,
)
from nicr_mtsa_tpu_torch.ops.cuda import finisher4x as t_fin

torch.set_num_threads(2)

# (B, C, H, W, dtype bytes): the serving shape in bf16 and f32, ragged
# shapes no tile divides, a class count other than 40, tiny inputs
PLAN_CASES = [(8, 40, 120, 160, 2), (8, 40, 120, 160, 4),
              (2, 40, 37, 53, 2), (2, 40, 37, 53, 4), (2, 19, 37, 53, 2),
              (1, 40, 5, 3, 2), (3, 13, 7, 10, 4), (1, 300, 9, 11, 4)]


def _strides(B, C, H, W, layout):
    return ((H * W * C, 1, W * C, C) if layout == 'cl'
            else (C * H * W, H * W, W, 1))


@pytest.mark.parametrize('layout', ['cl', 'nchw'])
@pytest.mark.parametrize('case', PLAN_CASES)
def test_f4_plan_covers_pixels_and_windows_hold_taps(case, layout):
    """`f4_plan`: every output pixel computed by exactly one tile; each
    tile's stage-1 window holds the 2 x 2 stage-1 values of each of its
    pixels, and its padded-input window the 2 x 2 inputs of each value
    of its stage-1 window, borders included; the shared memory within
    a block's; 16-byte staging exactly for aligned channels-last whole
    16-byte words."""
    B, C, H, W, elt = case
    plan = t_fin.f4_plan((B, C, H, W), _strides(B, C, H, W, layout), elt)
    HO, WO = 4 * H, 4 * W
    seen = np.zeros((HO, WO), np.int64)
    for tr in range(plan.tiles_y):
        for tc in range(plan.tiles_x):
            (i0, pr, j0, pc), (q0, r1, s0, s1) = t_fin.window(plan, tr, tc)
            ys = np.arange(tr * plan.tile_y, min((tr + 1) * plan.tile_y, HO))
            xs = np.arange(tc * plan.tile_x, min((tc + 1) * plan.tile_x, WO))
            assert len(ys) and len(xs)
            seen[ys[:, None], xs[None, :]] += 1
            # stage 2: output Y reads stage-1 rows (Y >> 1) + (Y & 1)
            # + {0, 1}, all within the plane (2H + 2 rows)
            for out, first, n, plane in ((ys, q0, r1, 2 * H + 2),
                                         (xs, s0, s1, 2 * W + 2)):
                lo = (out >> 1) + (out & 1)
                assert lo.min() >= first and lo.max() + 1 < first + n
                assert lo.max() + 1 < plane
            # stage 1: value q reads padded-input rows (q >> 1) + {0, 1}
            # (H + 2 rows), for every value the tile stages
            for first1, n1, first0, n0 in ((q0, r1, i0, pr),
                                           (s0, s1, j0, pc)):
                q = np.arange(first1, first1 + n1)
                assert (q >> 1).min() >= first0
                assert (q >> 1).max() + 1 < first0 + n0
    assert (seen == 1).all()
    assert plan.smem == t_fin.smem_bytes(C, elt, plan.tile_y, plan.tile_x)
    assert plan.smem <= t_fin.MAX_SMEM and plan.classes * elt % 16 == 0
    assert plan.tile_y % 4 == 0 and plan.tile_x % 4 == 0
    assert 128 % plan.tile_x == 0       # a thread keeps a column's phase
    assert plan.vec == (layout == 'cl' and C * elt % 16 == 0)
    if (C, H, W) == (40, 120, 160) and elt == 2:
        # the serving call: 32 x 64 tiles, two blocks an SM
        assert (plan.tile_y, plan.tile_x) == (32, 64)
        assert 2 * (plan.smem + 1024) <= t_fin.SM_SMEM


def test_f4_plan_stages_16_bytes_only_when_aligned():
    shape, strides = (8, 40, 120, 160), _strides(8, 40, 120, 160, 'cl')
    assert t_fin.f4_plan(shape, strides, 2, aligned=True).vec
    assert not t_fin.f4_plan(shape, strides, 2, aligned=False).vec
    # a class view of channels-last logits: pixels 80 bytes apart, 38
    # classes of them
    assert not t_fin.f4_plan((8, 38, 120, 160), strides, 2).vec


def test_f4_plan_rejects_what_shared_memory_cannot_hold():
    with pytest.raises(ValueError, match='shared memory'):
        t_fin.f4_plan((1, 40000, 8, 8), (1, 1, 1, 1), 4)


# the 2x finisher's one-stage plan (`f4_plan(..., stages=1)`): its
# path's shape in bf16 and f32, ragged shapes, other class counts, tiny
# inputs
PLAN2X_CASES = [(8, 40, 240, 320, 2), (8, 40, 240, 320, 4),
                (2, 40, 37, 53, 2), (2, 19, 37, 53, 4), (3, 13, 7, 10, 2),
                (1, 40, 5, 3, 4), (1, 300, 9, 11, 4)]


@pytest.mark.parametrize('layout', ['cl', 'nchw'])
@pytest.mark.parametrize('case', PLAN2X_CASES)
def test_f4_plan_one_stage_covers_pixels_and_window_holds_taps(case,
                                                              layout):
    """The 2x finisher's plan: every output pixel of (2H, 2W) computed by
    exactly one tile; each tile's staged padded-input window (the plane
    its one stage reads) holds the 2 x 2 taps of each of its pixels,
    borders included; the shared memory within a block's; 16-byte
    staging exactly for aligned channels-last whole 16-byte words."""
    B, C, H, W, elt = case
    plan = t_fin.f4_plan((B, C, H, W), _strides(B, C, H, W, layout), elt,
                         stages=1)
    assert plan.stages == 1
    HO, WO = 2 * H, 2 * W
    seen = np.zeros((HO, WO), np.int64)
    for tr in range(plan.tiles_y):
        for tc in range(plan.tiles_x):
            staged, plane = t_fin.window(plan, tr, tc)
            assert staged == plane
            q0, r1, s0, s1 = plane
            ys = np.arange(tr * plan.tile_y, min((tr + 1) * plan.tile_y, HO))
            xs = np.arange(tc * plan.tile_x, min((tc + 1) * plan.tile_x, WO))
            assert len(ys) and len(xs)
            seen[ys[:, None], xs[None, :]] += 1
            # output Y reads padded-input rows (Y >> 1) + (Y & 1) + {0, 1}
            # (H + 2 rows)
            for out, first, n, padded in ((ys, q0, r1, H + 2),
                                          (xs, s0, s1, W + 2)):
                lo = (out >> 1) + (out & 1)
                assert lo.min() >= first and lo.max() + 1 < first + n
                assert lo.max() + 1 < padded
    assert (seen == 1).all()
    assert plan.smem == t_fin.smem_bytes(C, elt, plan.tile_y, plan.tile_x,
                                         stages=1)
    assert plan.smem <= t_fin.MAX_SMEM and plan.classes * elt % 16 == 0
    assert plan.tile_y % 4 == 0 and plan.tile_x % 4 == 0
    assert 128 % plan.tile_x == 0       # a thread keeps a column's phase
    assert plan.vec == (layout == 'cl' and C * elt % 16 == 0)
    if (C, H, W) == (40, 240, 320) and elt == 2:
        # the `--no-defer4x` call: 32 x 64 tiles, a 18 x 34 x 40 bf16
        # window (48,960 B) and one stage's weights, two blocks an SM
        assert (plan.tile_y, plan.tile_x) == (32, 64)
        assert plan.smem == 18 * 34 * 40 * 2 + 40 * 64 + 40 * 4
        assert 2 * (plan.smem + 1024) <= t_fin.SM_SMEM


def test_f4_plan_one_stage_16_bytes_only_when_aligned():
    shape, strides = (8, 40, 240, 320), _strides(8, 40, 240, 320, 'cl')
    assert t_fin.f4_plan(shape, strides, 2, aligned=True, stages=1).vec
    assert not t_fin.f4_plan(shape, strides, 2, aligned=False,
                             stages=1).vec
    assert not t_fin.f4_plan((8, 38, 240, 320), strides, 2, stages=1).vec


def test_f4_plan_one_stage_smaller_than_two_and_within_limit():
    """One stage stages no stage-1 window and one stage's weights; a
    class count no tile can hold is refused."""
    for ty, tx in t_fin.TILES:
        assert t_fin.smem_bytes(40, 2, ty, tx, stages=1) < \
            t_fin.smem_bytes(40, 2, ty, tx)
    with pytest.raises(ValueError, match='shared memory'):
        t_fin.f4_plan((1, 60000, 8, 8), (1, 1, 1, 1), 4, stages=1)


def _stage_params(seed, C=6):
    rng = np.random.default_rng(seed)
    k = torch.from_numpy(rng.normal(0, 0.3, (C, 1, 3, 3)).astype(np.float32))
    b = torch.from_numpy(rng.normal(0, 0.1, (C,)).astype(np.float32))
    return k, b


def test_stage_weights_cached_until_kernel_or_bias_changes():
    k, b = _stage_params(0)
    dev = torch.device('cpu')
    with torch.inference_mode():
        first = t_fin.cached_stage_weights(k, b, torch.bfloat16, dev)
    assert not any(t.is_inference() for t in first)
    again = t_fin.cached_stage_weights(k, b, torch.bfloat16, dev)
    assert all(a is f for a, f in zip(again, first))
    want = t_fin.stage_weights(k, b, 6, torch.bfloat16, dev)
    for got, w in zip(first, want):
        torch.testing.assert_close(got, w, rtol=0, atol=0)
    # another dtype has its own entry
    f32 = t_fin.cached_stage_weights(k, b, torch.float32, dev)
    assert f32[0] is not first[0]
    with torch.no_grad():
        k.mul_(2.0)
    after_k = t_fin.cached_stage_weights(k, b, torch.bfloat16, dev)
    assert after_k[0] is not first[0]
    torch.testing.assert_close(
        after_k[0], t_fin.stage_weights(k, b, 6, torch.bfloat16, dev)[0],
        rtol=0, atol=0)
    with torch.no_grad():
        b.add_(1.0)
    after_b = t_fin.cached_stage_weights(k, b, torch.bfloat16, dev)
    assert after_b[1] is not after_k[1]
    torch.testing.assert_close(after_b[1], b.to(torch.bfloat16).float(),
                               rtol=0, atol=0)
    # no bias, then a bias: fresh tensors
    no_bias = t_fin.cached_stage_weights(k, None, torch.bfloat16, dev)
    assert (no_bias[1] == 0).all()
    assert t_fin.cached_stage_weights(k, b, torch.bfloat16, dev)[1] \
        is not no_bias[1]


def _case(seed, B, H, W, C=40):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 3, size=(B, H, W, C)).astype(np.float32)
    k1 = rng.normal(0, 0.3, size=(3, 3, 1, C)).astype(np.float32)
    b1 = rng.normal(0, 0.1, size=(C,)).astype(np.float32)
    k2 = rng.normal(0, 0.3, size=(3, 3, 1, C)).astype(np.float32)
    b2 = rng.normal(0, 0.1, size=(C,)).astype(np.float32)
    return x, k1, b1, k2, b2


def _hwio_to_torch(k):
    return torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))


def _port(entry, x_nhwc, dtype, layout, k1, b1, k2, b2):
    xt = torch.from_numpy(x_nhwc).permute(0, 3, 1, 2).to(dtype)
    xt = (xt.contiguous(memory_format=torch.channels_last) if layout == 'cl'
          else xt.contiguous())
    if entry == 'bilinear':
        return t_fin.upsample4x_bilinear_argmax_score(xt)
    return t_fin.upsample4x_argmax_score(
        xt, _hwio_to_torch(k1), torch.from_numpy(b1), _hwio_to_torch(k2),
        torch.from_numpy(b2))


@pytest.mark.parametrize('entry', ['zeropad', 'bilinear'])
def test_finisher4x_layouts_match_pallas_at_a_ragged_shape(entry):
    """Both entries on bf16 channels-last and NCHW inputs give the same
    maps, equal to the JAX package's Pallas kernel (interpret mode), at
    a shape whose 48 output rows no 32-row tile divides (the Pallas
    kernel takes B % 8 == 0, H % 4 == 0, W % 16 == 0)."""
    dtype = 'bfloat16'
    x, k1, b1, k2, b2 = _case(11, 8, 12, 16)
    xj = jnp.asarray(x, getattr(jnp, dtype))
    if entry == 'bilinear':
        idx_j, score_j = upsample4x_bilinear_argmax_score(xj,
                                                          interpret=True)
    else:
        idx_j, score_j = upsample4x_argmax_score(
            xj, jnp.asarray(k1), jnp.asarray(b1), jnp.asarray(k2),
            jnp.asarray(b2), interpret=True)
    x_rounded = np.array(xj.astype(jnp.float32))
    got = {lay: _port(entry, x_rounded, getattr(torch, dtype), lay, k1, b1,
                      k2, b2) for lay in ('cl', 'nchw')}
    assert got['cl'][0].shape == (8, 48, 64)
    for idx, score in got.values():
        np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
        np.testing.assert_allclose(score.numpy(), np.asarray(score_j),
                                   rtol=1e-5)
    assert torch.equal(got['cl'][0], got['nchw'][0])
    assert torch.equal(got['cl'][1], got['nchw'][1])


@pytest.mark.parametrize('entry', ['zeropad', 'bilinear'])
def test_finisher4x_layouts_agree_where_no_tile_fits(entry):
    """At (2, 40, 37, 53) (no tile divides 148 x 212; the zero ring and
    the edge replication inside tiles) and 19 classes, channels-last
    and NCHW give the same maps."""
    for C in (40, 19):
        x, k1, b1, k2, b2 = _case(12, 2, 37, 53, C)
        a = _port(entry, x, torch.bfloat16, 'cl', k1, b1, k2, b2)
        b = _port(entry, x, torch.bfloat16, 'nchw', k1, b1, k2, b2)
        assert a[0].shape == (2, 148, 212)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])

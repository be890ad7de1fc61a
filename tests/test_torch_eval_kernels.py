"""Kernel parity of the eval slice of the PyTorch/CUDA port
(nicr_mtsa_tpu_torch) against the JAX package's Pallas kernels, on the
CPU: the crop + resize + reduce (resize_reduce.py), the score/argmax
reduce (semantic_reduce.py) and the PQ intersection histogram
(intersection_kernel.py).

On CPU tensors the port's wrappers run their plain PyTorch versions;
the Pallas kernels run in interpret mode, as the JAX package's own
tests run them. Inputs come from numpy seeds. idx and counts must be
bit-identical; scores (a 40-term exp sum, which the JAX side may take
through logsumexp) within rtol 1e-5. The CUDA kernels are held against
the same plain versions on the card by chip_smoke.py and by the tests
marked `cuda` below."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nicr_mtsa_tpu.models.upsampling import (
    _two_tap_params, resize_bilinear, resize_nearest, resized_channel_reduce,
)
from nicr_mtsa_tpu.ops.pallas.intersection_kernel import (
    intersection_matrix_pallas,
)
from nicr_mtsa_tpu.ops.pallas.resize_reduce import crop_resize_argmax_score
from nicr_mtsa_tpu.ops.pallas.semantic_reduce import (
    semantic_score_idx, semantic_score_idx_pallas,
)
from nicr_mtsa_tpu.ops.segments import intersection_matrix
from nicr_mtsa_tpu_torch.models import upsampling as t_up
from nicr_mtsa_tpu_torch.ops.cuda import intersection as t_int
from nicr_mtsa_tpu_torch.ops.cuda import resize_reduce as t_rr
from nicr_mtsa_tpu_torch.ops.cuda import semantic_reduce as t_sr

torch.set_num_threads(2)

RESIZE_CASES = [
    # (H, W), crop, out: upscale both with edge-clamped taps
    ((60, 80), (slice(0, 60), slice(0, 80)), (64, 64)),
    # a crop smaller than the input
    ((64, 96), (slice(0, 48), slice(8, 88)), (96, 96)),
    # downscale one axis, upscale the other
    ((64, 96), (slice(0, 64), slice(0, 96)), (96, 64)),
    # identity rows, resize columns
    ((32, 60), (slice(0, 32), slice(0, 60)), (32, 48)),
]


def _nchw(x_nhwc, dtype=torch.float32):
    """NHWC numpy -> an NCHW torch view with channels-last strides (the
    layout of the model's logits on the card)."""
    return torch.from_numpy(np.array(x_nhwc)).permute(0, 3, 1, 2).to(dtype)


@pytest.mark.parametrize('n, m', [(480, 512), (640, 512), (96, 512),
                                  (128, 512), (64, 96), (60, 48), (7, 7)])
def test_two_tap_tables_match(n, m):
    i0, f = _two_tap_params(n, m)
    lo, hi, w0, w1 = t_up.two_tap_params(n, m)
    np.testing.assert_array_equal(lo, np.clip(i0, 0, n - 1))
    np.testing.assert_array_equal(hi, np.clip(i0 + 1, 0, n - 1))
    np.testing.assert_array_equal(w1, f)
    np.testing.assert_array_equal(
        w0, np.array([np.float32(1.0 - float(v)) for v in f]))


@pytest.mark.parametrize('case', RESIZE_CASES[:3])
def test_resize_matches(case):
    (H, W), _, (oh, ow) = case
    x = np.random.default_rng(1).normal(size=(2, H, W, 5)).astype(np.float32)
    want = np.asarray(resize_bilinear(jnp.asarray(x), oh, ow))
    got = t_up.resize_bilinear(_nchw(x), oh, ow)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    ids = np.random.default_rng(2).integers(0, 99, (2, H, W, 1)).astype(
        np.int32)
    want = np.asarray(resize_nearest(jnp.asarray(ids), oh, ow))[..., 0]
    got = t_up.resize_nearest(torch.from_numpy(ids[..., 0]), oh, ow)
    np.testing.assert_array_equal(got.numpy(), want)


def _port_resize_reduce(x, crop, oh, ow, dtype):
    xt = _nchw(np.array(x.astype(jnp.float32)), getattr(torch, dtype))
    idx, score = t_rr.crop_resize_argmax_score(xt, crop, oh, ow)
    assert idx.dtype == torch.int32 and idx.shape == (x.shape[0], oh, ow)
    return idx.numpy(), score.numpy()


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_resize_reduce_matches_pallas(dtype):
    """A crop smaller than the input, edge-clamped taps on both axes;
    small output tiles keep the interpret-mode kernel quick."""
    crop = (slice(2, 14), slice(4, 20))
    x = jnp.asarray(np.random.default_rng(4).normal(
        size=(2, 16, 24, 40)).astype(np.float32)).astype(dtype)
    idx_j, score_j = crop_resize_argmax_score(x, crop, 16, 24,
                                              interpret=True)
    idx, score = _port_resize_reduce(x, crop, 16, 24, dtype)
    np.testing.assert_array_equal(idx, np.asarray(idx_j))
    np.testing.assert_allclose(score, np.asarray(score_j), rtol=1e-5,
                               atol=0)


@pytest.mark.parametrize('case', RESIZE_CASES)
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_resize_reduce_matches_xla_twin(case, dtype):
    """The cases of tests/test_resize_reduce.py against the XLA twin
    that test holds the Pallas kernel to (resized_channel_reduce)."""
    (H, W), crop, (oh, ow) = case
    rng = np.random.default_rng(hash(case[0]) % 2 ** 31)
    x = jnp.asarray(rng.normal(size=(2, H, W, 40)).astype(np.float32)
                    ).astype(dtype)
    score_j, idx_j = resized_channel_reduce(x[:, crop[0], crop[1], :], oh,
                                            ow, semantic_score_idx)
    idx, score = _port_resize_reduce(x, crop, oh, ow, dtype)
    np.testing.assert_array_equal(idx, np.asarray(idx_j))
    np.testing.assert_allclose(score, np.asarray(score_j), rtol=1e-5,
                               atol=0)


def test_resize_reduce_tie_first_index():
    x = np.zeros((1, 12, 16, 8), np.float32)
    x[..., 3] = 2.0
    x[..., 6] = 2.0                         # tie -> the first (3) wins
    crop = (slice(0, 12), slice(0, 16))
    idx_j, _ = crop_resize_argmax_score(jnp.asarray(x), crop, 16, 24,
                                        interpret=True)
    idx, _ = t_rr.crop_resize_argmax_score(_nchw(x), crop, 16, 24)
    assert (idx == 3).all()
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))


def test_resize_reduce_rejects_strided_crop():
    x = torch.zeros(1, 4, 8, 8)
    with pytest.raises(ValueError, match='unit-step'):
        t_rr.crop_resize_argmax_score(x, (slice(0, 8, 2), slice(0, 8)),
                                      16, 16)


# row 5's kernel geometry: (B, C, crop H, W, out H, W, bytes a value):
# the eval call (480 x 640 -> 512 x 512) and chip_smoke.py's crops
RR_PLAN_CASES = [(8, 40, 480, 640, 512, 512, 2),
                 (8, 40, 448, 640, 512, 512, 2),
                 (8, 40, 474, 632, 512, 512, 2),
                 (8, 40, 480, 320, 512, 700, 2),
                 (8, 40, 480, 640, 333, 500, 2),
                 (8, 40, 474, 632, 333, 500, 2),
                 (8, 40, 474, 632, 512, 512, 4),
                 (2, 8, 48, 64, 64, 80, 2), (2, 40, 48, 64, 64, 80, 2),
                 (1, 19, 200, 900, 23, 17, 4),
                 (1, 150, 480, 640, 48, 64, 4)]     # 10x down: narrow strips


def _ring_trace(plan, lo_h, hi_h, lo_w, hi_w, C, out_h, out_w):
    """Walk every block as csrc/resize_reduce.cu does: count each output
    pixel computed and check that the ring slots hold both tap rows of
    every output row (and the slot both tap columns) when its group
    computes, after the next group's rows were issued."""
    seen = np.zeros((out_h, out_w), np.int64)
    G, R = plan.group_rows, plan.ring_rows
    for strip in range(plan.strips):
        ox0 = strip * plan.strip_w
        ox_end = min(ox0 + plan.strip_w, out_w)
        col0 = lo_w[ox0]
        assert (hi_w[ox_end - 1] + 1 - col0) * C <= plan.slot_elems
        for band in range(plan.bands):
            oy_begin = band * plan.band_groups * G
            assert oy_begin < out_h
            oy_stop = min(oy_begin + plan.band_groups * G, out_h)
            slots = [None] * R
            nxt = [lo_h[oy_begin]]

            def issue(last):
                for r in range(nxt[0], last + 1):
                    slots[r % R] = r
                nxt[0] = max(nxt[0], last + 1)

            issue(hi_h[min(oy_begin + G, oy_stop) - 1])
            n_groups = -(-(oy_stop - oy_begin) // G)
            for g in range(n_groups):
                oy_g = oy_begin + g * G
                if g + 1 < n_groups:
                    issue(hi_h[min(oy_g + 2 * G, oy_stop) - 1])
                for oy in range(oy_g, min(oy_g + G, oy_stop)):
                    assert slots[lo_h[oy] % R] == lo_h[oy]
                    assert slots[hi_h[oy] % R] == hi_h[oy]
                    seen[oy, ox0:ox_end] += 1
    return seen


@pytest.mark.parametrize('case', RR_PLAN_CASES)
def test_rr_plan_covers_pixels_and_ring_holds_taps(case):
    """`rr_plan`: every output pixel computed once, each output row's lo
    and hi tap rows resident in the ring when its group computes, each
    strip's tap columns within a slot, the shared memory within a
    block's and one wave of blocks."""
    B, C, in_h, in_w, out_h, out_w, elt = case
    plan = t_rr.rr_plan(B, C, in_h, out_h, in_w, out_w, elt, n_sm=132,
                        blocks_per_sm=lambda smem: 3)
    lo_h, hi_h, _, _ = t_up.two_tap_params(in_h, out_h)
    lo_w, hi_w, _, _ = t_up.two_tap_params(in_w, out_w)
    seen = _ring_trace(plan, lo_h, hi_h, lo_w, hi_w, C, out_h, out_w)
    assert (seen == 1).all()
    assert plan.smem == plan.ring_rows * plan.slot_elems * elt
    assert plan.smem <= t_rr.MAX_SMEM and plan.slot_elems * elt % 16 == 0
    assert B * plan.strips * plan.bands <= max(132 * 3, B * plan.strips)
    if (C, in_h, in_w, out_h, out_w) == (40, 480, 640, 512, 512):
        # the eval call: 256-column strips, 1-row groups, one wave
        assert (plan.strip_w, plan.group_rows) == (256, 1)
        assert B * plan.strips * plan.bands <= 132 * 3


def test_rr_plan_rejects_what_shared_memory_cannot_hold():
    with pytest.raises(ValueError, match='shared memory'):
        t_rr.rr_plan(1, 40000, 480, 48, 640, 64, 4, n_sm=132,
                     blocks_per_sm=lambda smem: 1)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_semantic_reduce_matches_pallas(dtype):
    rng = np.random.default_rng(0)
    logits = jnp.asarray(rng.normal(size=(2, 16, 128, 11)).astype(
        np.float32) * 4.0).astype(dtype)
    score_j, idx_j = semantic_score_idx_pallas(logits, block_h=8,
                                               interpret=True)
    score_x, idx_x = semantic_score_idx(logits, backend='xla')
    lt = _nchw(np.asarray(logits.astype(jnp.float32)), getattr(torch, dtype))
    idx, score = t_sr.semantic_argmax_score(lt)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_x))
    np.testing.assert_allclose(score.numpy(), np.asarray(score_j),
                               rtol=1e-5, atol=0)
    np.testing.assert_allclose(score.numpy(), np.asarray(score_x),
                               rtol=1e-5, atol=0)


def test_semantic_reduce_tie_first_index():
    logits = np.zeros((1, 8, 128, 5), np.float32)
    logits[..., 2] = 1.0
    logits[..., 4] = 1.0                    # tie with class 2 -> first
    _, idx_j = semantic_score_idx_pallas(jnp.asarray(logits), block_h=8,
                                         interpret=True)
    idx, _ = t_sr.semantic_argmax_score(_nchw(logits))
    assert (idx == 2).all()
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))


def test_intersection_matches_pallas():
    rng = np.random.default_rng(5)
    B, P = 2, 4096
    gt = rng.integers(0, 6, (B, P)).astype(np.int32)
    pred = rng.integers(0, 9, (B, P)).astype(np.int32)
    want = np.asarray(intersection_matrix_pallas(
        jnp.asarray(gt), jnp.asarray(pred), n_gt=5, n_pred=8, block_p=1024,
        interpret=True))
    got = t_int.intersection_matrix_kernel(torch.from_numpy(gt),
                                           torch.from_numpy(pred), 5, 8)
    assert got.dtype == torch.float32 and got.shape == (B, 6, 9)
    np.testing.assert_array_equal(got.numpy(), want)


def test_intersection_out_of_range_slots_not_counted():
    """Slots outside [0, n] (a one-hot of zeros in the JAX package) are
    dropped, as in ops/segments.intersection_matrix."""
    rng = np.random.default_rng(6)
    gt = rng.integers(-2, 9, (3, 777)).astype(np.int32)
    pred = rng.integers(-1, 12, (3, 777)).astype(np.int32)
    want = np.asarray(intersection_matrix(jnp.asarray(gt),
                                          jnp.asarray(pred), 6, 9))
    got = t_int.intersection_matrix_kernel(torch.from_numpy(gt),
                                           torch.from_numpy(pred), 6, 9)
    np.testing.assert_array_equal(got.numpy(), want)
    brute = np.zeros((3, 7, 10))
    for b in range(3):
        for g, p in zip(gt[b], pred[b]):
            if 0 <= g <= 6 and 0 <= p <= 9:
                brute[b, g, p] += 1
    np.testing.assert_array_equal(got.numpy(), brute)


@pytest.mark.cuda
def test_eval_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(2, 40, 60, 80)).astype(
        np.float32)).cuda().to(torch.bfloat16)
    crop = (slice(4, 56), slice(0, 80))
    for xx in (x, x.contiguous(memory_format=torch.channels_last)):
        for (idx, score), (idx_r, score_r) in (
                (t_rr.crop_resize_argmax_score(xx, crop, 64, 96),
                 t_rr.crop_resize_argmax_score_reference(xx, crop, 64, 96)),
                (t_sr.semantic_argmax_score(xx),
                 t_sr.semantic_argmax_score_reference(xx))):
            assert torch.equal(idx, idx_r)
            torch.testing.assert_close(score, score_r, rtol=1e-5, atol=0)
    gt = torch.randint(0, 130, (2, 5000), device='cuda', dtype=torch.int32)
    pred = torch.randint(0, 130, (2, 5000), device='cuda', dtype=torch.int32)
    assert torch.equal(
        t_int.intersection_matrix_kernel(gt, pred, 128, 128),
        t_int.intersection_matrix_reference(gt, pred, 128, 128))

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
the same plain versions on the card by chip_smoke.py and by
tests/test_torch_eval_kernels_card.py."""
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
from test_torch_eval_kernels_card import _blocky_slots

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


def _cl(B, C, H, W, dtype=torch.bfloat16):
    return torch.zeros(B, C, H, W, dtype=dtype).contiguous(
        memory_format=torch.channels_last)


# row 6's host plan: (name, logits, 16-byte aligned storage, path)
SR_PLAN_CASES = [
    ('eval_cl', lambda: _cl(8, 40, 480, 640), True, 'staged'),
    ('cl_f32', lambda: _cl(2, 40, 48, 64, torch.float32), True, 'staged'),
    ('nchw', lambda: torch.zeros(8, 40, 48, 64, dtype=torch.bfloat16), True,
     'strided'),
    ('cl_sliced', lambda: _cl(2, 40, 480, 640)[:, :, 8:472, 16:624], True,
     'staged'),
    ('cl_misaligned', lambda: _cl(2, 40, 48, 64), False, 'strided'),
    ('cl_41_classes', lambda: _cl(2, 41, 48, 64), True, 'strided'),
    ('cl_odd_column', lambda: _cl(2, 40, 48, 64)[:, :, :, 1:], True,
     'staged'),
    ('cl_short_rows', lambda: _cl(3, 16, 5, 7)[:, :, 1:4, 2:5], True,
     'staged'),
]


def _sr_plan(x, aligned):
    return t_sr.sr_plan(tuple(x.shape), tuple(x.stride()),
                        x.element_size(), aligned, n_sm=132,
                        blocks_per_sm=lambda threads, smem: 5)


@pytest.mark.parametrize('case', SR_PLAN_CASES, ids=lambda c: c[0])
def test_sr_plan_paths_and_runs_cover_pixels(case):
    """`sr_plan` chooses the staged kernel exactly where a pixel's
    classes are one 16-byte aligned run, and its runs, walked as
    csrc/semantic_reduce.cu `tile_of` walks them, read each pixel's
    classes where they lie and write each output pixel once."""
    _, make, aligned, path = case
    x = make()
    plan = _sr_plan(x, aligned)
    assert plan.path == path
    B, C, H, W = x.shape
    if path == 'strided':
        assert plan.blocks == B * H * -(-W // t_sr.STRIDED_THREADS)
        return
    sb, sc, sh, sw = x.stride()
    assert (sc, sw) == (1, C) and C * x.element_size() % 16 == 0
    assert plan.smem == plan.stages * plan.slot_bytes <= t_sr.MAX_SMEM
    assert plan.run * C * x.element_size() <= plan.slot_bytes
    assert plan.blocks <= min(plan.tiles, 132 * 5)
    written = np.zeros(B * H * W, np.int64)
    for t in range(plan.tiles):
        seg, r = divmod(t, plan.runs_per_seg)
        img, row = divmod(seg, plan.segs_per_img)
        w0 = r * plan.run
        n = min(plan.run, plan.seg_len - w0)
        assert n > 0
        p = seg * plan.seg_len + w0 + np.arange(n)
        written[p] += 1
        b, rest = np.divmod(p, H * W)
        h, w = np.divmod(rest, W)
        # the run's storage is contiguous from its first pixel's
        start = img * sb + row * sh + w0 * C
        np.testing.assert_array_equal(b * sb + h * sh + w * sw,
                                      start + np.arange(n) * C)
    assert (written == 1).all()


def test_sr_plan_eval_call_one_wave():
    plan = _sr_plan(_cl(8, 40, 480, 640), True)
    # the whole tensor is one segment: 19200 runs of 128 pixels
    assert (plan.seg_len, plan.run, plan.tiles) == (8 * 480 * 640, 128,
                                                    19200)
    assert plan.blocks == 132 * 5


def _it_covered(plan, P, step_threads=t_int.THREADS):
    """Pixels of one image each (rank, thread) counts, walked as
    csrc/intersection.cu walks them (vectors by trips of U slots, then
    the scalar head and tail)."""
    T, U, cs = step_threads, 4, plan.cluster
    step = cs * T
    seen = np.zeros(P, np.int64)
    for rank in range(cs):
        base = rank * T
        while base < plan.vectors:
            v = base + np.arange(U)[:, None] * step + np.arange(T)
            v = v[v < plan.vectors]
            for j in range(4):
                np.add.at(seen, plan.head + 4 * v + j, 1)
            base += U * step
        n_scalar = plan.head + plan.tail
        i0 = rank * T
        while i0 < n_scalar:
            i = i0 + np.arange(T)
            i = i[i < n_scalar]
            np.add.at(seen, np.where(i < plan.head, i,
                                     i + 4 * plan.vectors), 1)
            i0 += step
    return seen


# row 11's host plan: (B, P, G, Q, gt phase, pred phase, image strides,
# clusters of 16 / 8 the card holds at once, the cluster, vectors); the
# H100 holds 7 / 15 at 129 x 129 bins
IT_PLAN_CASES = [
    (8, 262144, 129, 129, 0, 0, (262144, 262144), (7, 15), 8, True),
    (8, 262144, 129, 129, 0, 0, (262144, 262144), (8, 15), 16, True),
    (1, 262144, 129, 129, 0, 0, (0, 0), (7, 15), 16, True),
    (8, 262144, 129, 129, 0, 0, (262144, 262144), (0, 15), 8, True),
    (8, 262143, 257, 129, 0, 0, (262144, 262144), (7, 15), 8, True),
    (8, 262144, 129, 129, 1, 1, (262144, 262144), (7, 15), 8, True),
    (8, 262144, 129, 129, 1, 0, (262144, 262144), (7, 15), 8, False),
    (8, 262144, 129, 129, 1, 1, (262145, 262144), (7, 15), 8, False),
    (1, 777, 257, 129, 0, 0, (0, 0), (7, 15), 1, True),
    (1, 777, 257, 129, 3, 3, (0, 0), (7, 15), 1, True),
]


@pytest.mark.parametrize('case', IT_PLAN_CASES)
def test_it_plan_cluster_and_tail_cover_pixels(case):
    """`it_plan`: the admitted cluster with the fewest waves a CTA's
    pixels (then the fewest waves) that leaves a CTA a vector a thread,
    16-byte vectors only where both maps share their phase and strides
    keep it, the histogram of all bins in shared memory, every bin
    summed by one rank, and the kernel's walk counts each pixel of an
    image once."""
    B, P, G, Q, pg, pp, (sg, sp), (n16, n8), cluster, vec = case
    held = {16: n16, 8: n8, 4: 30, 2: 66, 1: 132}
    plan = t_int.it_plan(B, P, G, Q, pg, pp, sg, sp,
                         lambda cs, smem: held[cs])
    assert (plan.cluster, plan.vec) == (cluster, vec)
    assert plan.smem % 16 == 0 and G * Q * 4 <= plan.smem <= t_int.MAX_SMEM
    assert plan.bins_per_rank % 4 == 0
    assert plan.bins_per_rank * plan.cluster >= G * Q
    assert plan.head + 4 * plan.vectors + plan.tail == P
    if vec:
        assert (pg + plan.head) % 4 == 0 and plan.tail < 4
    else:
        assert plan.vectors == 0
    assert (_it_covered(plan, P) == 1).all()


def test_it_plan_rejects_bins_beyond_shared_memory():
    with pytest.raises(ValueError, match='shared memory'):
        t_int.it_plan(1, 777, 257, 257, 0, 0, 0, 0, lambda cs, smem: 1)
    with pytest.raises(ValueError, match='no cluster'):
        t_int.it_plan(1, 777, 129, 129, 0, 0, 0, 0, lambda cs, smem: 0)


def _port_score_idx(x_nhwc_full, sl, dtype):
    """The port's (idx, score) of the channels-last NCHW view of the
    NHWC numpy logits, sliced by `sl` (rows, columns)."""
    xt = _nchw(x_nhwc_full, getattr(torch, dtype))[:, :, sl[0], sl[1]]
    assert xt.stride(1) == 1
    idx, score = t_sr.semantic_argmax_score(xt)
    return idx.numpy(), score.numpy()


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('case', ['sliced_view', '41_classes'])
def test_semantic_reduce_views_match_pallas(case, dtype):
    """The port on a channels-last sliced view (rows and columns cut, as
    postprocessing/semantic.py passes a crop) and on 41 classes, against
    the Pallas kernel in interpret mode on the same values."""
    rng = np.random.default_rng(12)
    if case == 'sliced_view':
        x = rng.normal(size=(2, 24, 131, 40)).astype(np.float32) * 4.0
        sl = (slice(4, 20), slice(2, 130))
    else:
        x = rng.normal(size=(2, 8, 128, 41)).astype(np.float32) * 4.0
        sl = (slice(None), slice(None))
    x = np.asarray(jnp.asarray(x).astype(dtype).astype(jnp.float32))
    score_j, idx_j = semantic_score_idx_pallas(
        jnp.asarray(x[:, sl[0], sl[1], :]).astype(dtype), block_h=8,
        interpret=True)
    idx, score = _port_score_idx(x, sl, dtype)
    np.testing.assert_array_equal(idx, np.asarray(idx_j))
    np.testing.assert_allclose(score, np.asarray(score_j), rtol=1e-5,
                               atol=0)


def test_intersection_blocky_maps_match_pallas():
    """257 x 129 bins on blocky slot maps (P a multiple of block_p):
    the port's counts against the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(13)
    gt = _blocky_slots(rng, 2, 32, 64, 256, 6)
    pred = _blocky_slots(rng, 2, 32, 64, 128, 9)
    want = np.asarray(intersection_matrix_pallas(
        jnp.asarray(gt), jnp.asarray(pred), n_gt=256, n_pred=128,
        block_p=1024, interpret=True))
    got = t_int.intersection_matrix_kernel(torch.from_numpy(gt),
                                           torch.from_numpy(pred), 256, 128)
    assert got.shape == (2, 257, 129)
    np.testing.assert_array_equal(got.numpy(), want)


def test_intersection_blocky_ragged_matches_segments():
    """P not a multiple of block_p (30 x 50 pixels), out-of-range slots
    in the maps: against ops/segments.intersection_matrix."""
    rng = np.random.default_rng(14)
    gt = _blocky_slots(rng, 3, 30, 50, 258, 7) - 1
    pred = _blocky_slots(rng, 3, 30, 50, 129, 5)
    want = np.asarray(intersection_matrix(jnp.asarray(gt),
                                          jnp.asarray(pred), 256, 128))
    got = t_int.intersection_matrix_kernel(torch.from_numpy(gt),
                                           torch.from_numpy(pred), 256, 128)
    np.testing.assert_array_equal(got.numpy(), want)

"""The offset-vote grouping of the PyTorch/CUDA port
(nicr_mtsa_tpu_torch/ops/cuda/grouping.py) on the CPU: the pipeline
entry (`group_pixels_offsets`, on the offset map) against the XLA
branch of the JAX package's `ops/grouping.py::group_pixels`, and the
loc-level entry (`group_pixels_kernel`) against the Pallas kernel in
interpret mode, on the same numpy inputs.

On CPU tensors the wrappers run their plain PyTorch versions; the CUDA
kernel is held against the same plain versions on the card by
chip_smoke.py (ids and min_d2 bit for bit). Here ids must be
bit-identical to the JAX package's, min_d2 to the Pallas kernel's."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nicr_mtsa_tpu.ops.grouping import group_pixels as j_group_pixels
from nicr_mtsa_tpu.ops.pallas.grouping_kernel import group_pixels_pallas
from nicr_mtsa_tpu_torch.ops import grouping as t_ops
from nicr_mtsa_tpu_torch.ops.cuda import grouping as t_grp

torch.set_num_threads(2)

# (B, H, W, K, valid centres, offset dtype, layout, threshold): both
# dtypes and layouts, a threshold and none, no valid centre, valid and
# invalid centres interleaved, K = 1 and K = 254
CASES = {
    'bf16_cl': (2, 16, 24, 64, 'p0.7', 'bf16', 'cl', None),
    'bf16_nchw_threshold': (2, 16, 24, 64, 'p0.7', 'bf16', 'nchw', 3.0),
    'f32_cl_threshold': (2, 16, 24, 64, 'p0.7', 'f32', 'cl', 2.5),
    'f32_nchw': (2, 16, 24, 64, 'p0.7', 'f32', 'nchw', None),
    'no_valid_centre': (2, 16, 24, 64, 'none', 'bf16', 'cl', None),
    'alternate_valid': (2, 16, 24, 64, 'alternate', 'f32', 'nchw', 4.0),
    'k1': (2, 13, 17, 1, 'p1.0', 'bf16', 'cl', None),
    'k254': (2, 13, 17, 254, 'p0.7', 'f32', 'cl', 2.0),
}


def _case(seed, B, H, W, K, valid, dt, layout):
    """numpy (offsets (B, H, W, 2) f32 holding `dt` values, int32
    centres (B, K, 2), validity (B, K), mask (B, H, W)) and the offsets
    as a torch (B, 2, H, W) tensor of `dt` in `layout`."""
    rng = np.random.default_rng(seed)
    off = (rng.normal(size=(B, H, W, 2)) * 3).astype(np.float32)
    tdt = torch.bfloat16 if dt == 'bf16' else torch.float32
    off_t = torch.from_numpy(off).permute(0, 3, 1, 2).to(tdt)
    off_t = (off_t.contiguous(memory_format=torch.channels_last)
             if layout == 'cl' else off_t.contiguous())
    off = off_t.float().permute(0, 2, 3, 1).numpy()     # the dt values
    centres = rng.integers(0, (H, W), (B, K, 2)).astype(np.int32)
    if valid == 'none':
        ok = np.zeros((B, K), bool)
    elif valid == 'alternate':
        ok = np.broadcast_to(np.arange(K) % 2 == 1, (B, K)).copy()
    else:
        ok = rng.random((B, K)) < float(valid[1:])
    fg = rng.random((B, H, W)) > 0.4
    return off, centres, ok, fg, off_t


def _jax_ids(off, centres, ok, fg, threshold):
    return np.asarray(j_group_pixels(
        jnp.asarray(centres), jnp.asarray(ok), jnp.asarray(off),
        jnp.asarray(fg), threshold, backend='xla'))


def _port(off_t, centres, ok, fg, threshold):
    return t_grp.group_pixels_offsets(
        off_t, torch.from_numpy(centres), torch.from_numpy(ok),
        torch.from_numpy(fg), threshold, return_min_d2=True)


@pytest.mark.parametrize('name', sorted(CASES))
def test_offsets_entry_matches_jax_xla_branch(name):
    B, H, W, K, valid, dt, layout, thr = CASES[name]
    off, centres, ok, fg, off_t = _case(len(name), B, H, W, K, valid, dt,
                                        layout)
    ids, min_d2 = _port(off_t, centres, ok, fg, thr)
    assert ids.dtype == torch.int32 and ids.shape == (B, H, W)
    np.testing.assert_array_equal(ids.numpy(),
                                  _jax_ids(off, centres, ok, fg, thr))
    # the pipeline's call gives the same ids
    got = t_ops.group_pixels(torch.from_numpy(centres), torch.from_numpy(ok),
                             off_t, torch.from_numpy(fg), thr)
    assert torch.equal(got, ids)
    # min_d2: the loc-level entry's at foreground pixels, 3.4e38 elsewhere
    yy, xx = np.mgrid[:H, :W].astype(np.float32)
    loc_ids, loc_d2 = t_grp.group_pixels_kernel(
        torch.from_numpy((yy + off[..., 0]).reshape(B, -1)),
        torch.from_numpy((xx + off[..., 1]).reshape(B, -1)),
        torch.from_numpy(centres), torch.from_numpy(ok),
        torch.from_numpy(fg.reshape(B, -1)))
    want = np.where(fg.reshape(B, -1), loc_d2.numpy(), np.float32(3.4e38))
    np.testing.assert_array_equal(min_d2.numpy().reshape(B, -1), want)
    if thr is None:
        np.testing.assert_array_equal(ids.numpy().reshape(B, -1),
                                      loc_ids.numpy())
    if valid == 'none':
        assert (ids == 0).all()


def test_offsets_entry_threshold_cuts_far_pixels():
    """The threshold sets ids to 0 exactly where min_d2 > thr^2 (f32)."""
    off, centres, ok, fg, off_t = _case(5, 2, 16, 24, 8, 'p1.0', 'f32',
                                        'nchw')
    ids, d2 = _port(off_t, centres, ok, fg, None)
    cut, _ = _port(off_t, centres, ok, fg, 2.0)
    assert 0 < int((ids != cut).sum()) < int((ids != 0).sum())
    np.testing.assert_array_equal(
        cut.numpy(), np.where(d2.numpy() <= np.float32(4.0), ids.numpy(), 0))


def test_offsets_entry_tie_resolves_to_first_centre():
    """Three centres at one place, the first invalid: centre 1 (id 2)
    wins every foreground pixel, in the port and in the JAX package."""
    off, centres, ok, fg, off_t = _case(6, 2, 16, 24, 3, 'p1.0', 'bf16',
                                        'cl')
    centres[:, 1:] = centres[:, :1]
    ok[:, 0] = False
    ids, _ = _port(off_t, centres, ok, fg, None)
    assert (ids.numpy()[fg] == 2).all() and (ids.numpy()[~fg] == 0).all()
    np.testing.assert_array_equal(ids.numpy(),
                                  _jax_ids(off, centres, ok, fg, None))


@pytest.mark.parametrize('K,ctr_dtype', [(64, np.float32), (254, np.int32)])
def test_loc_entry_matches_pallas_interpret_at_ragged_p(K, ctr_dtype):
    """The loc-level entry, f32 and int32 centres, at a P no 8192-pixel
    tile divides: ids and min_d2 bit for bit."""
    rng = np.random.default_rng(K)
    B, P = 2, 1500
    loc_y = rng.uniform(-4, 20, (B, P)).astype(np.float32)
    loc_x = rng.uniform(-4, 132, (B, P)).astype(np.float32)
    centres = rng.integers(0, (16, 128), (B, K, 2)).astype(np.float32)
    ok = rng.random((B, K)) < 0.6
    fg = rng.random((B, P)) > 0.3
    ids_j, d2_j = group_pixels_pallas(
        *map(jnp.asarray, (loc_y, loc_x, centres, ok, fg)), interpret=True)
    ids_t, d2_t = t_grp.group_pixels_kernel(
        torch.from_numpy(loc_y), torch.from_numpy(loc_x),
        torch.from_numpy(centres.astype(ctr_dtype)), torch.from_numpy(ok),
        torch.from_numpy(fg))
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    np.testing.assert_array_equal(d2_t.numpy(), np.asarray(d2_j))


def test_offsets_entry_counts_no_cpu_launch():
    _, centres, ok, fg, off_t = _case(7, 1, 8, 8, 4, 'p1.0', 'f32', 'cl')
    before = t_grp.group_pixels_offsets.launches
    _port(off_t, centres, ok, fg, 1.0)
    assert t_grp.group_pixels_offsets.launches == before


def _no_library(monkeypatch, tmp_path):
    """Pretend CPU tensors are CUDA tensors, no library is built and
    nvcc is absent."""
    import shutil
    from nicr_mtsa_tpu_torch.ops.cuda import _build
    monkeypatch.setattr(t_grp, 'is_cuda_tensor', lambda t: True)
    monkeypatch.setattr(t_grp, '_lib', t_grp._lib.__wrapped__)
    monkeypatch.setattr(_build, 'BUILD_DIR', tmp_path)
    monkeypatch.setattr(_build, '_LIBS', {})
    monkeypatch.setenv('CUDA_HOME', str(tmp_path / 'no-cuda'))
    monkeypatch.setattr(shutil, 'which', lambda name: None)


def test_offsets_entry_raises_without_library(monkeypatch, tmp_path):
    """No fallback: a CUDA tensor without a library raises, and no
    launch is counted; an input that requires grad raises first."""
    _, centres, ok, fg, off_t = _case(8, 1, 8, 8, 4, 'p1.0', 'f32', 'cl')
    _no_library(monkeypatch, tmp_path)
    args = (torch.from_numpy(centres), torch.from_numpy(ok),
            torch.from_numpy(fg))
    before = t_grp.group_pixels_offsets.launches
    with pytest.raises(RuntimeError, match='no gradient'):
        t_grp.group_pixels_offsets(off_t.clone().requires_grad_(), *args)
    with pytest.raises(RuntimeError, match='nvcc'):
        t_grp.group_pixels_offsets(off_t, *args)
    assert t_grp.group_pixels_offsets.launches == before


def test_offsets_entry_rejects_other_shapes():
    _, centres, ok, fg, off_t = _case(9, 1, 8, 8, 4, 'p1.0', 'f32', 'cl')
    with pytest.raises(ValueError, match='offset'):
        t_grp._launch_offsets(off_t[:, :1], torch.from_numpy(centres),
                              torch.from_numpy(ok), torch.from_numpy(fg),
                              None, False)


@pytest.mark.cuda
def test_grouping_entries_on_card():
    """Both entries against their plain versions on the card (skipped
    without one; chip_smoke.py runs the same comparison at the serving
    shape)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    for name, (B, H, W, K, valid, dt, layout, thr) in CASES.items():
        _, centres, ok, fg, off_t = _case(1, B, H, W, K, valid, dt, layout)
        args = (off_t.cuda(), torch.from_numpy(centres).cuda(),
                torch.from_numpy(ok).cuda(), torch.from_numpy(fg).cuda())
        got = t_grp.group_pixels_offsets(*args, threshold=thr,
                                         return_min_d2=True)
        want = t_grp.group_pixels_offsets_reference(*args, threshold=thr)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])

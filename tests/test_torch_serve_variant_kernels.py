"""Parity of the two opt-in serving variants' kernels in the PyTorch/CUDA
port (nicr_mtsa_tpu_torch) with the JAX package, on the CPU.

On CPU tensors the port's wrappers run their plain PyTorch versions;
the Pallas kernels run in interpret mode, as the JAX package's own
tests run them. Inputs come from numpy seeds.

- 2x finisher (`upsample2x_argmax_score`, EMSANet `--no-defer4x`):
  against `upsample2x_argmax_score(..., interpret=True)` at B=8, 8 x 32
  (the Pallas kernel's tiling) in f32 and bf16, idx equal and scores
  within rtol 1e-5; at an odd shape (B=2, 7 x 10) the dense logits
  bit for bit against `apply_deferred_upsampling_exact` and idx equal
  to its `semantic_score_idx`; tied classes resolve to the first
  index; channels-last logits give the same maps.
- Attention over the packed qkv (`window_attention_qkv`, EMSAFormer
  `--attn-qkv`): against `fused_window_attention_qkv(...,
  interpret=True)` in f32 within 2e-5 (the JAX tests' own tolerance for
  this kernel) for v2 shifted (16 x 24 grid, C=128, 4 heads), v2
  unshifted and v1 with 49-token windows; in bf16 within 2e-2 of max
  |out| (the kernels sum in another order, which moves bf16 roundings
  by an ulp); at a padded v2 stage, where the pad tokens have k = 0
  exactly, finite and equal within 2e-5.

The CUDA kernels are held against the same plain versions on the card
(the `cuda` test below, and chip_smoke.py phases 13 and 16)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nicr_mtsa_tpu.models.backbones.swin import _shift_attn_mask
from nicr_mtsa_tpu.models.upsampling import (
    DeferredUpsampling as JDeferredUpsampling, apply_deferred_upsampling_exact,
)
from nicr_mtsa_tpu.ops.pallas.semantic_finisher import (
    upsample2x_argmax_score as j_upsample2x,
)
from nicr_mtsa_tpu.ops.pallas.semantic_reduce import semantic_score_idx
from nicr_mtsa_tpu.ops.pallas.window_attention import (
    fused_window_attention_qkv,
)
from nicr_mtsa_tpu_torch.models.upsampling import (DeferredUpsampling,
                                                   zeropad2x_logits_exact)
from nicr_mtsa_tpu_torch.ops.cuda import finisher2x as t_fin
from nicr_mtsa_tpu_torch.ops.cuda import window_attention_qkv as t_waq

torch.set_num_threads(2)
DTYPES = {'float32': (torch.float32, jnp.float32),
          'bfloat16': (torch.bfloat16, jnp.bfloat16)}


# --- 2x finisher (row 4) -----------------------------------------------------

def _fin_case(seed, B, H, W, C=40, with_bias=True):
    """NHWC logits, a (3, 3, 1, C) depthwise kernel and a bias, f32."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(B, H, W, C)) * 3).astype(np.float32)
    k = rng.normal(0, 0.3, size=(3, 3, 1, C)).astype(np.float32)
    b = (rng.normal(0, 0.1, size=(C,)).astype(np.float32) if with_bias
         else None)
    return x, k, b


def _port_inputs(x, k, b, tdt):
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    kt = torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
    return xt.to(tdt), kt, None if b is None else torch.from_numpy(b)


@pytest.mark.parametrize('dtype', sorted(DTYPES))
def test_finisher2x_matches_pallas_interpret(dtype):
    tdt, jdt = DTYPES[dtype]
    x, k, b = _fin_case(1, 8, 8, 32)
    xt, kt, bt = _port_inputs(x, k, b, tdt)
    # the same (rounded) values on both sides
    xj = jnp.asarray(xt.float().numpy().transpose(0, 2, 3, 1)).astype(jdt)
    i_j, s_j = j_upsample2x(xj, jnp.asarray(k), jnp.asarray(b),
                            interpret=True)
    i_t, s_t = t_fin.upsample2x_argmax_score(xt, kt, bt)
    assert i_t.dtype == torch.int32 and i_t.shape == (8, 16, 64)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-5,
                               atol=0)


@pytest.mark.parametrize('dtype', sorted(DTYPES))
@pytest.mark.parametrize('with_bias', [True, False])
def test_finisher2x_logits_match_exact_twin(dtype, with_bias):
    """Odd shape: the dense logits equal the JAX exact twin's bit for bit,
    and the finisher's idx its reduce's."""
    tdt, jdt = DTYPES[dtype]
    x, k, b = _fin_case(2, 2, 7, 10, C=13, with_bias=with_bias)
    xt, kt, bt = _port_inputs(x, k, b, tdt)
    xj = jnp.asarray(xt.float().numpy().transpose(0, 2, 3, 1)).astype(jdt)
    want = apply_deferred_upsampling_exact(JDeferredUpsampling(
        x=xj, kernel=jnp.asarray(k), bias=None if b is None
        else jnp.asarray(b)))
    got = zeropad2x_logits_exact(xt, kt, bt)
    assert got.dtype == tdt and got.shape == (2, 13, 14, 20)
    np.testing.assert_array_equal(
        got.float().numpy().transpose(0, 2, 3, 1),
        np.asarray(want.astype(jnp.float32)))
    _, idx_j = semantic_score_idx(want.astype(jnp.float32))
    idx_t, _ = t_fin.finish_deferred_semantic(
        DeferredUpsampling(x=xt, kernel=kt, bias=bt))
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))


def test_finisher2x_ties_resolve_to_first_index():
    """Classes 2 and 5 equal and largest everywhere (the identity tap
    kernel): class 2 wins, as in the Pallas kernel."""
    C = 8
    x = np.zeros((8, 8, 32, C), np.float32)
    x[..., 2] = 1.5
    x[..., 5] = 1.5
    k = np.zeros((3, 3, 1, C), np.float32)
    k[1, 1] = 1.0
    i_j, _ = j_upsample2x(jnp.asarray(x), jnp.asarray(k),
                          jnp.zeros((C,), jnp.float32), interpret=True)
    xt, kt, _ = _port_inputs(x, k, None, torch.bfloat16)
    i_t, s_t = t_fin.upsample2x_argmax_score(xt, kt, None)
    assert bool((i_t == 2).all())
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    assert bool(torch.isfinite(s_t).all())


def test_finisher2x_reads_channels_last_logits():
    """The card's layout: NHWC logits viewed as (B, C, H, W) give the
    same maps as contiguous ones."""
    x, k, b = _fin_case(3, 2, 6, 9)
    xt, kt, bt = _port_inputs(x, k, b, torch.bfloat16)
    cl = xt.contiguous(memory_format=torch.channels_last)
    for got, want in zip(t_fin.upsample2x_argmax_score(cl, kt, bt),
                         t_fin.upsample2x_argmax_score(xt, kt, bt)):
        assert torch.equal(got, want)


# --- attention over the packed qkv (row 9) -----------------------------------

GRID = (2, 3)          # 16 x 24 tokens of 8 x 8 windows


def _qkv_case(seed, v2, ws, C=128, h=4, B=2, pad_tokens=None):
    """Packed qkv (B * 6, N, 3C) (v2: k bias zeroed, as the Swin block
    gives it), a position bias and the v2 logit scales, f32; with
    `pad_tokens` the k of the token mask is exactly 0 (a padded stage's
    pad tokens: zero input, zeroed k bias) and q, v their biases."""
    N = ws * ws
    rng = np.random.default_rng(seed)
    Bw = B * GRID[0] * GRID[1]
    qkv = rng.normal(size=(Bw, N, 3 * C)).astype(np.float32)
    if pad_tokens is not None:
        bias_q = rng.normal(0, 0.1, size=(C,)).astype(np.float32)
        bias_v = rng.normal(0, 0.1, size=(C,)).astype(np.float32)
        qkv[:, pad_tokens, :C] = bias_q
        qkv[:, pad_tokens, C:2 * C] = 0.0
        qkv[:, pad_tokens, 2 * C:] = bias_v
    if v2:
        bias = 16 / (1 + np.exp(-rng.normal(size=(h, N, N))))
        scale = np.exp(np.minimum(np.log(10.0) + rng.normal(0, 0.5, h),
                                  np.log(100.0)))
    else:
        bias, scale = rng.normal(0, 0.5, size=(h, N, N)), None
    return (qkv, bias.astype(np.float32),
            None if scale is None else scale.astype(np.float32))


def _run_both(qkv, bias, scale, h, ws, shifted, tdt, jdt):
    shift = (ws // 2, ws // 2) if shifted else None
    masks = (_shift_attn_mask(GRID[0] * ws, GRID[1] * ws, ws, *shift)
             if shifted else None)
    q_t = torch.from_numpy(qkv).to(tdt)
    want = fused_window_attention_qkv(
        jnp.asarray(q_t.float().numpy()).astype(jdt), jnp.asarray(bias), h,
        GRID if shifted else (1, 1), masks,
        v2_scale=None if scale is None else jnp.asarray(scale),
        interpret=True)
    got = t_waq.window_attention_qkv(
        q_t, torch.from_numpy(bias), h, GRID, shift,
        None if scale is None else torch.from_numpy(scale))
    assert got.dtype == tdt and got.shape == (qkv.shape[0], qkv.shape[1],
                                              qkv.shape[2] // 3)
    return got.float().numpy(), np.asarray(want.astype(jnp.float32))


QKV_CASES = {'v2_shifted': (True, 8, True), 'v2_unshifted': (True, 8, False),
             'v1_49_tokens': (False, 7, True)}


@pytest.mark.parametrize('case', sorted(QKV_CASES))
def test_window_attention_qkv_matches_pallas_interpret(case):
    v2, ws, shifted = QKV_CASES[case]
    qkv, bias, scale = _qkv_case(4, v2, ws)
    got, want = _run_both(qkv, bias, scale, 4, ws, shifted, torch.float32,
                          jnp.float32)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize('case', sorted(QKV_CASES))
def test_window_attention_qkv_bf16_matches_pallas_interpret(case):
    v2, ws, shifted = QKV_CASES[case]
    qkv, bias, scale = _qkv_case(5, v2, ws)
    got, want = _run_both(qkv, bias, scale, 4, ws, shifted, torch.bfloat16,
                          jnp.bfloat16)
    err = np.abs(got - want).max()
    assert err <= 2e-2 * np.abs(want).max(), err


def test_window_attention_qkv_padded_stage_is_finite():
    """A padded v2 stage: the last two token rows of every window are pad
    (k = 0 exactly). max(||k||, 1e-6) keeps their normalised k at 0, so
    the outputs are finite and agree with the Pallas kernel's."""
    pad = np.zeros(64, bool)
    pad[48:] = True
    qkv, bias, scale = _qkv_case(6, True, 8, pad_tokens=pad)
    got, want = _run_both(qkv, bias, scale, 4, 8, True, torch.float32,
                          jnp.float32)
    assert np.isfinite(got).all() and np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_window_attention_qkv_rejects_bad_shapes(monkeypatch):
    """The kernel's wrapper checks its shapes before it builds anything."""
    monkeypatch.setattr(t_waq, 'is_cuda_tensor', lambda t: True)
    with pytest.raises(ValueError, match='qkv'):
        t_waq.window_attention_qkv(torch.zeros(2, 64, 3 * 48),
                                   torch.zeros(1, 64, 64), 1)
    with pytest.raises(ValueError, match='bias'):
        t_waq.window_attention_qkv(torch.zeros(2, 64, 96),
                                   torch.zeros(2, 64, 64), 1)
    with pytest.raises(ValueError, match='whole images'):
        t_waq.window_attention_qkv(torch.zeros(5, 64, 96),
                                   torch.zeros(1, 64, 64), 1, (2, 3), (4, 4))


@pytest.mark.cuda
def test_serve_variant_kernels_on_card():
    """Both kernels against their plain versions on the card, one launch
    counted each."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    x, k, b = _fin_case(7, 2, 7, 10)
    xt, kt, bt = (t.cuda() for t in _port_inputs(x, k, b, torch.bfloat16))
    before = t_fin.upsample2x_argmax_score.launches
    got = t_fin.upsample2x_argmax_score(
        xt.contiguous(memory_format=torch.channels_last), kt, bt)
    torch.cuda.synchronize()
    want = t_fin.upsample2x_argmax_score_reference(xt, kt, bt)
    assert t_fin.upsample2x_argmax_score.launches == before + 1
    assert torch.equal(got[0], want[0])
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=0)
    qkv, bias, scale = _qkv_case(8, True, 8)
    args = (torch.from_numpy(qkv).cuda(), torch.from_numpy(bias).cuda(), 4,
            GRID, (4, 4), torch.from_numpy(scale).cuda())
    before = t_waq.window_attention_qkv.launches
    got = t_waq.window_attention_qkv(*args)
    torch.cuda.synchronize()
    want = t_waq.window_attention_qkv_reference(*args)
    assert t_waq.window_attention_qkv.launches == before + 1
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())

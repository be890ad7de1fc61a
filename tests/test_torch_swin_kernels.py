"""Parity of the Swin path's kernels in the PyTorch/CUDA port
(nicr_mtsa_tpu_torch) with the JAX package, on the CPU.

On CPU tensors the port's wrappers run their plain PyTorch versions;
the Pallas kernels run in interpret mode, as the JAX package's own
tests run them, and beside them the JAX package's XLA paths. Inputs
come from numpy seeds; everything is f32 unless a bf16 case says so.

- LayerNorm (`fused_layer_norm`): within 1e-5 of the Pallas kernel and
  the XLA path; the decoders' skip LN (eps 1e-6) within 1e-5 of flax
  `nn.LayerNorm`.
- Window-attention sub-block (`window_attention_block`): within 1e-5
  of max |out| of `fused_window_attention_block` and of the XLA
  `WindowAttention` (the JAX docstring claims ~1e-6), v2 and v1,
  shifted and unshifted; the shift-region rule equals
  `_shift_attn_mask`; the image entry (`window_attention_image`, the
  Swin block's call) within 1e-5 of the JAX block's pad, roll,
  partition, attention and back; the table of each window token's
  pixel that the bf16 image entry reads (`image_token_rows`) gathers
  exactly the JAX block's padded, rolled and partitioned windows, and
  the bf16 kernels' packed weight tiles (`pack_wqkv`, `pack_wproj`)
  hold each weight where the kernels read it.
- Bilinear 4x finisher (`upsample4x_bilinear_argmax_score`): idx
  bit-identical, first index on ties, score within rtol 1e-5.

The kernels themselves are held against the same plain versions on
the card (the `cuda` tests below, and chip_smoke.py at the path's
shapes)."""
import numpy as np
import flax.linen as fnn
import jax
import jax.numpy as jnp
import pytest
import torch

from nicr_mtsa_tpu.models.backbones.swin import (WindowAttention,
                                                 _shift_attn_mask,
                                                 window_partition,
                                                 window_unpartition)
from nicr_mtsa_tpu.models.common import FusedLayerNorm
from nicr_mtsa_tpu.models.upsampling import DeferredBilinear2
from nicr_mtsa_tpu.ops.pallas.layernorm import fused_layer_norm
from nicr_mtsa_tpu.ops.pallas.semantic_finisher4x import (
    finish_deferred_bilinear2, upsample4x_bilinear_argmax_score,
)
from nicr_mtsa_tpu.ops.pallas.window_attention import (
    fused_window_attention_block,
)
from nicr_mtsa_tpu_torch.models.backbones import swin as t_swin
from nicr_mtsa_tpu_torch.models.common import FusedLayerNorm as TLayerNorm
from nicr_mtsa_tpu_torch.ops.cuda import finisher4x as t_fin
from nicr_mtsa_tpu_torch.ops.cuda import layernorm as t_ln
from nicr_mtsa_tpu_torch.ops.cuda import window_attention as t_wa
from nicr_mtsa_tpu_torch.utils.flax_weights import load_flax_variables

torch.set_num_threads(2)


# --- LayerNorm (row 10) ------------------------------------------------------

def _ln_case(seed, rows, C):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(rows, C)) * 2 + 0.5).astype(np.float32)
    w = rng.uniform(0.5, 1.5, size=(C,)).astype(np.float32)
    b = rng.normal(0, 0.1, size=(C,)).astype(np.float32)
    return x, w, b


def _port_ln(x, w, b, eps=1e-5):
    return t_ln.fused_layer_norm(torch.from_numpy(x), torch.from_numpy(w),
                                 torch.from_numpy(b), eps).numpy()


@pytest.mark.parametrize('C', [32, 96, 128, 512])
def test_layer_norm_matches_pallas_interpret(C):
    # 1000 rows: not a multiple of the Pallas row block (512)
    x, w, b = _ln_case(C, 1000, C)
    want = np.asarray(fused_layer_norm(jnp.asarray(x), jnp.asarray(w),
                                       jnp.asarray(b), interpret=True))
    np.testing.assert_allclose(_port_ln(x, w, b), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize('C', [32, 96, 128, 512])
def test_layer_norm_matches_xla_path(C):
    x, w, b = _ln_case(C + 1, 3 * 7 * 11, C)
    x4 = x.reshape(3, 7, 11, C)
    mod = FusedLayerNorm(backend='xla')
    variables = {'params': {'scale': jnp.asarray(w), 'bias': jnp.asarray(b)}}
    want = np.asarray(mod.apply(variables, jnp.asarray(x4)))
    got = TLayerNorm(C)
    load_flax_variables(got, jax.tree_util.tree_map(np.array, variables))
    np.testing.assert_allclose(got(torch.from_numpy(x4)).detach().numpy(),
                               want, rtol=0, atol=1e-5)


def test_layer_norm_out_dtype_and_bf16_input():
    x, w, b = _ln_case(3, 64, 96)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = t_ln.fused_layer_norm(xb, torch.from_numpy(w), torch.from_numpy(b),
                                out_dtype=torch.float32)
    want = np.asarray(fused_layer_norm(
        jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16), jnp.asarray(w),
        jnp.asarray(b), interpret=True, out_dtype=jnp.float32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_fusion_layer_norm_matches_flax_layer_norm():
    """The decoders' skip LN: flax nn.LayerNorm at its own eps 1e-6,
    through the port's LN at eps 1e-6."""
    from nicr_mtsa_tpu_torch.models.encoder_decoder_fusion import (
        FLAX_LAYER_NORM_EPS,
    )
    x, w, b = _ln_case(5, 2 * 6 * 8, 256)
    x4 = x.reshape(2, 6, 8, 256)
    variables = {'params': {'scale': jnp.asarray(w), 'bias': jnp.asarray(b)}}
    want = np.asarray(fnn.LayerNorm().apply(variables, jnp.asarray(x4)))
    assert FLAX_LAYER_NORM_EPS == fnn.LayerNorm().epsilon
    got = _port_ln(x, w, b, FLAX_LAYER_NORM_EPS).reshape(x4.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# Row 10's Swin serving shapes at B=8 480 x 640 (chip_smoke.py LN_SHAPES)
# and ragged row counts: (rows, C, bytes a value, aligned, SMs); one SM
# makes the warps loop over several row steps
LN_PLAN_CASES = [(153600, 96, 2, True, 132), (153600, 32, 2, True, 132),
                 (153600, 128, 2, True, 132), (38400, 256, 2, True, 132),
                 (9600, 512, 2, True, 132), (2400, 1024, 2, True, 132),
                 (4801, 32, 2, True, 132), (4801, 96, 2, True, 132),
                 (4801, 128, 2, True, 132), (4801, 1024, 2, True, 132),
                 (4801, 128, 4, True, 132), (2400, 1024, 4, True, 132),
                 (4801, 24, 2, True, 132), (4801, 128, 2, False, 132),
                 (7, 512, 2, True, 132), (4801, 128, 2, True, 1),
                 (4801, 96, 2, True, 1), (4801, 128, 2, False, 1)]


@pytest.mark.parametrize('rows, C, size, aligned, n_sm', LN_PLAN_CASES)
def test_ln_plan_covers_every_row_once(rows, C, size, aligned, n_sm):
    """The kernel's row map under `ln_plan` takes every row exactly once
    and keeps every warp at the same number of row steps; the path's
    shapes all take the row path (16-byte vectors, <= 4 a lane)."""
    per_sm = 6 if n_sm > 1 else 1
    plan = t_ln.ln_plan(rows, C, size, aligned, n_sm, per_sm)
    seen = np.zeros(rows, np.int64)
    for block in range(plan.blocks):
        for warp in range(t_ln.WARPS):
            took = np.fromiter(t_ln.plan_rows(plan, block, warp), np.int64)
            assert len(took) == plan.steps * plan.step
            np.add.at(seen, took[took < rows], 1)
    assert (seen == 1).all()
    assert plan.blocks <= t_ln.MAX_WAVES * n_sm * per_sm
    assert (plan.steps > 1) == (n_sm == 1)
    if plan.nv:
        assert plan.vec and plan.lanes * plan.nv * (16 // size) == C
        assert plan.unroll == t_ln.unroll_for(plan.nv)
        assert plan.nv <= t_ln.MAX_NV and 32 % plan.lanes == 0
    if size == 2 and aligned and C in (32, 96, 128, 256, 512, 1024):
        assert plan.nv > 0
    if not aligned:
        assert plan.nv == 0 and not plan.vec


# --- window-attention sub-block (row 8) --------------------------------------

GRID, SHIFT_CASES = (2, 3), [None, (4, 4), (0, 4)]


def _wa_case(seed, v2, ws, C=64, h=2, B=2):
    """JAX WindowAttention variables and windows of B images of a 2 x 3
    window grid, weights and biases randomised."""
    N = ws * ws
    rng = np.random.default_rng(seed)
    Bw = B * GRID[0] * GRID[1]
    x = rng.normal(size=(Bw, N, C)).astype(np.float32)
    mod = WindowAttention(dim=C, n_heads=h, window_size=ws, v2=v2,
                          backend='xla')
    v = mod.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    v = jax.tree_util.tree_map(lambda a: np.array(a), v)
    p = v['params']
    for name in ('qkv', 'proj'):
        p[name]['bias'] = rng.normal(0, 0.1, p[name]['bias'].shape).astype(
            np.float32)
        p[name]['kernel'] = rng.normal(0, C ** -0.5, p[name]['kernel'].shape
                                       ).astype(np.float32)
    if v2:
        p['logit_scale'] = (np.log(10.0) + rng.normal(
            0, 0.5, p['logit_scale'].shape)).astype(np.float32)
    else:
        p['relative_position_bias_table'] = rng.normal(
            0, 0.5, p['relative_position_bias_table'].shape).astype(
                np.float32)
    return mod, v, x


def _port_attention(v, x, v2, ws, C=64, h=2, shift=None):
    attn = t_swin.WindowAttention(C, h, ws, v2)
    load_flax_variables(attn, v)
    with torch.no_grad():
        return attn(torch.from_numpy(x), GRID, shift).numpy(), attn


def _shift_spec(ws, shift):
    if shift is None:
        return None
    return (GRID[0] * ws, GRID[1] * ws, ws) + tuple(shift)


@pytest.mark.parametrize('v2,ws', [(True, 8), (False, 7)])
@pytest.mark.parametrize('shift', SHIFT_CASES)
def test_window_attention_matches_xla_path(v2, ws, shift):
    mod, v, x = _wa_case(1, v2, ws)
    if shift is not None:
        shift = (min(shift[0], ws // 2), min(shift[1], ws // 2))
    want = np.asarray(mod.apply(v, jnp.asarray(x), _shift_spec(ws, shift)))
    got, _ = _port_attention(v, x, v2, ws, shift=shift)
    err = np.abs(got - want).max()
    assert err <= 1e-5 * np.abs(want).max(), err


@pytest.mark.parametrize('v2,ws', [(True, 8), (False, 7)])
@pytest.mark.parametrize('shifted', [False, True])
def test_window_attention_matches_pallas_block_interpret(v2, ws, shifted):
    mod, v, x = _wa_case(2, v2, ws)
    shift = (ws // 2, ws // 2) if shifted else None
    _, attn = _port_attention(v, x, v2, ws)
    p = v['params']
    with torch.no_grad():      # the derived tensors, outside the graph
        bqkv = attn.qkv_bias().numpy()
        pos_bias = attn.position_bias()
        v2_scale = attn.v2_scale() if v2 else None
    masks = (_shift_attn_mask(GRID[0] * ws, GRID[1] * ws, ws, *shift)
             if shifted else None)
    want = np.asarray(fused_window_attention_block(
        jnp.asarray(x), jnp.asarray(p['qkv']['kernel']), jnp.asarray(bqkv),
        jnp.asarray(p['proj']['kernel']), jnp.asarray(p['proj']['bias']),
        jnp.asarray(pos_bias.numpy()), 2,
        GRID if shifted else (1, 1), masks,
        v2_scale=(jnp.asarray(v2_scale.numpy()) if v2 else None),
        interpret=True))
    got = t_wa.window_attention_block(
        torch.from_numpy(x), torch.from_numpy(p['qkv']['kernel']),
        torch.from_numpy(bqkv), torch.from_numpy(p['proj']['kernel']),
        torch.from_numpy(p['proj']['bias']), pos_bias, 2, GRID,
        shift, v2_scale).numpy()
    err = np.abs(got - want).max()
    assert err <= 1e-5 * np.abs(want).max(), err


def _jax_attention_part(mod, v, x, ws, shift):
    """The JAX SwinBlock's attention part around the XLA WindowAttention
    (models/backbones/swin.py `attention_part`)."""
    B, H, W, C = x.shape
    pad_h, pad_w = (ws - H % ws) % ws, (ws - W % ws) % ws
    Hp, Wp = H + pad_h, W + pad_w
    sh, sw = (shift if ws < Hp else 0), (shift if ws < Wp else 0)
    y = jnp.pad(jnp.asarray(x), ((0, 0), (0, pad_h), (0, pad_w), (0, 0)))
    spec = None
    if sh or sw:
        y = jnp.roll(y, (-sh, -sw), axis=(1, 2))
        spec = (Hp, Wp, ws, sh, sw)
    y = window_unpartition(mod.apply(v, window_partition(y, ws), spec), ws,
                           Hp, Wp)
    if sh or sw:
        y = jnp.roll(y, (sh, sw), axis=(1, 2))
    return np.asarray(y[:, :H, :W])


@pytest.mark.parametrize('v2,ws,H,W,shift', [
    (True, 8, 16, 24, 4),      # no pad, shifted
    (True, 8, 15, 20, 4),      # padded and shifted (stage 4 of 480 x 640)
    (False, 7, 15, 20, 3),     # v1, padded, shifted
    (True, 8, 8, 20, 4),       # one window row: shift only along W
    (True, 8, 12, 20, 0)])     # padded, unshifted
def test_window_attention_image_matches_jax_block(v2, ws, H, W, shift):
    mod, v, _ = _wa_case(4, v2, ws)
    x = np.random.default_rng(5).normal(size=(2, H, W, 64)).astype(
        np.float32)
    want = _jax_attention_part(mod, v, x, ws, shift)
    attn = t_swin.WindowAttention(64, 2, ws, v2)
    load_flax_variables(attn, v)
    with torch.no_grad():
        got = attn.forward_image(torch.from_numpy(x), shift).numpy()
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= 1e-5 * np.abs(want).max(), err


@pytest.mark.parametrize('B,H,W,ws,shift', [
    (2, 16, 24, 8, 4),         # no pad, shifted
    (2, 15, 20, 8, 4),         # padded and shifted (stage 4 of 480 x 640)
    (1, 15, 20, 7, 3),         # v1 49-token windows, padded, shifted
    (1, 8, 20, 8, 4),          # one window row: shift only along W
    (2, 12, 20, 8, 0),         # padded, unshifted
    (1, 30, 40, 8, 4)])        # stage 3 of 480 x 640, shifted
def test_image_token_rows_match_pad_roll_partition(B, H, W, ws, shift):
    """The bf16 image entry's row table: the image's pixels gathered by
    it (-1: a token of the zero pad) are the JAX block's windows,
    window_partition(roll(pad(x)))."""
    C = 8
    x = np.random.default_rng(6).normal(size=(B, H, W, C)).astype(
        np.float32)
    Hp, Wp = -(-H // ws) * ws, -(-W // ws) * ws
    sh, sw = (shift if ws < Hp else 0), (shift if ws < Wp else 0)
    y = jnp.pad(jnp.asarray(x), ((0, 0), (0, Hp - H), (0, Wp - W), (0, 0)))
    y = jnp.roll(y, (-sh, -sw), axis=(1, 2))
    want = np.asarray(window_partition(y, ws)).reshape(-1, C)
    rows = t_wa.image_token_rows(B, H, W, ws, shift).numpy()
    assert rows.dtype == np.int32 and rows.shape == (want.shape[0],)
    assert (rows == -1).sum() == B * (Hp * Wp - H * W)
    pixels = np.concatenate([x.reshape(-1, C), np.zeros((1, C), np.float32)])
    np.testing.assert_array_equal(pixels[rows], want)   # -1: the zero row


@pytest.mark.parametrize('C,h', [(128, 4), (96, 3), (256, 8)])
def test_packed_weights_hold_the_kernel_layout(C, h):
    """The bf16 kernels' weight tiles: element (k, n) of a 64-row chunk
    at ((k % 64) / 8 cores-per-row + n / 8) 64 + (k % 8) 8 + n % 8, with
    12 cores a row for head j's q_j | k_j | v_j columns and 16 for a
    128-column tile of Wproj; rows and columns past C zero."""
    rng = np.random.default_rng(7)
    wqkv = torch.from_numpy(rng.normal(size=(C, 3 * C)).astype(np.float32))
    wproj = torch.from_numpy(rng.normal(size=(C, C)).astype(np.float32))
    nK, nN = -(-C // 64), -(-C // 128)
    k = np.arange(nK * 64)[:, None]
    core = lambda n, per_row: (((k % 64) // 8) * per_row + n // 8) * 64 \
        + (k % 8) * 8 + n % 8
    got = t_wa.pack_wqkv(wqkv, h).numpy()
    assert got.shape == (h, nK, 64 * 96)
    n = np.arange(96)[None, :]
    w = np.concatenate([wqkv.numpy(), np.zeros((nK * 64 - C, 3 * C),
                                               np.float32)])
    for j in range(h):
        want = np.zeros((nK, 64 * 96), np.float32)
        want[k // 64, core(n, 12)] = w[k, (n // 32) * C + j * 32 + n % 32]
        np.testing.assert_array_equal(got[j], want)
    got = t_wa.pack_wproj(wproj).numpy()
    assert got.shape == (nN, nK, 64 * 128)
    n = np.arange(nN * 128)[None, :]
    w = np.zeros((nK * 64, nN * 128), np.float32)
    w[:C, :C] = wproj.numpy()
    want = np.zeros((nN, nK, 64 * 128), np.float32)
    want[n // 128, k // 64, core(n % 128, 16)] = w[k, n]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('grid_hw,ws,shift', [
    ((2, 3), 8, (4, 4)), ((3, 2), 7, (3, 3)), ((1, 4), 8, (0, 4)),
    ((4, 1), 8, (4, 0)), ((3, 5), 7, (3, 3))])
def test_shift_region_rule_matches_shift_attn_mask(grid_hw, ws, shift):
    want = _shift_attn_mask(grid_hw[0] * ws, grid_hw[1] * ws, ws, *shift)
    got = t_wa.shift_attn_mask(grid_hw, ws, shift).numpy()
    np.testing.assert_array_equal(got, want)


def test_window_attention_rejects_unsupported_shapes_on_card(monkeypatch):
    """Shapes the kernel does not take raise before any launch."""
    monkeypatch.setattr(t_wa, 'is_cuda_tensor', lambda t: True)
    x = torch.zeros(4, 64, 48)                     # C = 48: not 32 * h
    w = torch.zeros(48, 144)
    before = t_wa.window_attention_block.launches
    with pytest.raises(ValueError, match='32 \\* n_heads'):
        t_wa.window_attention_block(x, w, torch.zeros(144),
                                    torch.zeros(48, 48), torch.zeros(48),
                                    torch.zeros(2, 64, 64), 2)
    assert t_wa.window_attention_block.launches == before


# --- bilinear 4x finisher (row 3) --------------------------------------------

def _logits(seed, B=8, H=8, W=16, C=40):
    rng = np.random.default_rng(seed)
    return rng.normal(0, 3, size=(B, H, W, C)).astype(np.float32)


def _port_finisher_bilinear(x_nhwc, dtype):
    xt = torch.from_numpy(np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2)))
    idx, score = t_fin.upsample4x_bilinear_argmax_score(xt.to(dtype))
    return idx.numpy(), score.numpy()


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_finisher_bilinear_matches_pallas_interpret(dtype):
    x = _logits(1)
    xj = jnp.asarray(x, getattr(jnp, dtype))
    idx_j, score_j = upsample4x_bilinear_argmax_score(xj, interpret=True)
    idx_t, score_t = _port_finisher_bilinear(
        np.asarray(xj.astype(jnp.float32)), getattr(torch, dtype))
    assert idx_t.shape == (8, 32, 64) and idx_t.dtype == np.int32
    np.testing.assert_array_equal(idx_t, np.asarray(idx_j))
    np.testing.assert_allclose(score_t, np.asarray(score_j), rtol=1e-5)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_finisher_bilinear_matches_jax_cpu_path(dtype):
    """`finish_deferred_bilinear2` off the TPU: the exact phase twin."""
    x = _logits(2, H=6, W=10)
    xj = jnp.asarray(x, getattr(jnp, dtype))
    idx_j, score_j = finish_deferred_bilinear2(DeferredBilinear2(x=xj))
    xt = torch.from_numpy(np.asarray(xj.astype(jnp.float32)).transpose(
        0, 3, 1, 2).copy()).to(getattr(torch, dtype))
    from nicr_mtsa_tpu_torch.models.upsampling import DeferredBilinear2 as TD
    idx_t, score_t = t_fin.finish_deferred_bilinear2(TD(x=xt))
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(score_t.numpy(), np.asarray(score_j),
                               rtol=1e-5)


def test_finisher_bilinear_ties_to_first_index():
    x = np.zeros((8, 4, 16, 40), np.float32)
    x[..., 2] = 1.5
    x[..., 5] = 1.5
    idx, _ = _port_finisher_bilinear(x, torch.bfloat16)
    assert (idx == 2).all()
    idx_j, _ = upsample4x_bilinear_argmax_score(
        jnp.asarray(x, jnp.bfloat16), interpret=True)
    np.testing.assert_array_equal(idx, np.asarray(idx_j))


# --- the kernels on the card -------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')


@pytest.mark.cuda
def test_layer_norm_kernel_on_card():
    _need_card()
    x, w, b = (torch.from_numpy(a).cuda() for a in _ln_case(9, 3001, 96))
    for dt in (torch.float32, torch.bfloat16):
        got = t_ln.fused_layer_norm(x.to(dt), w, b)
        want = t_ln.layer_norm_reference(x.to(dt), w, b)
        torch.testing.assert_close(got.float(), want.float(), rtol=1e-2,
                                   atol=1e-5 if dt == torch.float32 else 2e-2)


@pytest.mark.cuda
def test_window_attention_kernel_on_card():
    _need_card()
    for v2, ws in ((True, 8), (False, 7)):
        _, v, x = _wa_case(3, v2, ws, C=128, h=4)
        attn = t_swin.WindowAttention(128, 4, ws, v2)
        load_flax_variables(attn, v)
        attn = attn.cuda()
        xc = torch.from_numpy(x).cuda()
        weights = (attn.qkv.weight.t(), attn.qkv_bias(), attn.proj.weight.t(),
                   attn.proj.bias, attn.position_bias(), 4)
        scale = attn.v2_scale() if v2 else None
        img = torch.randn(2, 15, 20, 128, device='cuda')
        for shift in (None, (ws // 2, ws // 2)):
            got = attn(xc, GRID, shift)
            want = t_wa.window_attention_block_reference(
                xc, *weights, GRID, shift, scale)
            err = float((got - want).abs().max())
            assert err <= 1e-4 * float(want.abs().max()), err
            s = 0 if shift is None else ws // 2
            got = attn.forward_image(img, s)
            want = t_wa.window_attention_image_reference(
                img, *weights, ws, s, scale)
            err = float((got - want).abs().max())
            assert err <= 1e-4 * float(want.abs().max()), err


@pytest.mark.cuda
def test_finisher_bilinear_kernel_on_card():
    _need_card()
    x = torch.from_numpy(_logits(4).transpose(0, 3, 1, 2).copy()).cuda()
    for dt in (torch.float32, torch.bfloat16):
        i_k, s_k = t_fin.upsample4x_bilinear_argmax_score(x.to(dt))
        i_r, s_r = t_fin.upsample4x_bilinear_argmax_score_reference(x.to(dt))
        assert torch.equal(i_k, i_r)
        torch.testing.assert_close(s_k, s_r, rtol=1e-5, atol=0)

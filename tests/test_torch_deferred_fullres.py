"""A deferred semantic head's full-resolution keys in the PyTorch/CUDA
port against the JAX package's `SemanticPostprocessing`, on the CPU, on
seeded deferred markers of each type (one learned-3x3-zeropad stage,
two, and the bilinear pair; 8 classes, a 48 x 64 dense output, B=2).

- With and without a crop and a resize to the full resolution: the idx
  (working and full resolution) exact in f32; the scores, the dense
  exact logits, the softmax and their full-resolution twins within rtol
  1e-5; without the dense keys the deferred marker stays and the maps
  are the same.
- On planted bf16 ties the dense logits' argmax is the finisher's idx
  at every pixel, `argmax(semantic_softmax_scores) ==
  semantic_segmentation_idx` on the tied pixels, and the idx equal the
  JAX package's."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nicr_mtsa_tpu.models import upsampling as jup
from nicr_mtsa_tpu.postprocessing import SemanticPostprocessing as \
    JSemanticPost
from nicr_mtsa_tpu_torch.models import upsampling as up
from nicr_mtsa_tpu_torch.postprocessing import SemanticPostprocessing
from test_torch_eval_outputs import RESIZE, B, close, equal, nchw, np_nhwc, t

torch.set_num_threads(2)


def _resize_batch(crop, shape):
    sy, sx = crop
    meta = [[{'type': 'Resize', 'valid_region_slice_y': sy,
              'valid_region_slice_x': sx}]]
    full = np.zeros((B,) + shape, np.int32)
    return ({RESIZE: meta, 'semantic_fullres': full},
            {RESIZE: meta, 'semantic_fullres': t(full)})


def _deferred(kind, dtype=np.float32, seed=0, C=8):
    """(JAX marker, port marker) of one deferred type; the dense output
    is 48 x 64."""
    rng = np.random.default_rng(seed)
    hw = (24, 32) if kind == 'zeropad2x' else (12, 16)
    x = rng.normal(0, 2, (B,) + hw + (C,)).astype(np.float32)
    ks = [rng.normal(0, 0.5, (3, 3, 1, C)).astype(np.float32)
          for _ in range(2)]
    bs = [rng.normal(0, 0.3, (C,)).astype(np.float32) for _ in range(2)]
    jx = jnp.asarray(x, dtype)
    tx = nchw(x).to(torch.bfloat16 if dtype == jnp.bfloat16 else
                    torch.float32)
    tk = [torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
          for k in ks]
    if kind == 'zeropad2x':
        return (jup.DeferredUpsampling(jx, ks[0], bs[0]),
                up.DeferredUpsampling(tx, tk[0], t(bs[0])))
    if kind == 'zeropad4x':
        return (jup.DeferredUpsampling2(jx, ks[0], bs[0], ks[1], bs[1]),
                up.DeferredUpsampling2(tx, tk[0], t(bs[0]), tk[1],
                                       t(bs[1])))
    return jup.DeferredBilinear2(jx), up.DeferredBilinear2(tx)


def _jax_semantic(jd, jbatch):
    """The JAX package's semantic postprocessing of a deferred marker,
    run eagerly, as its own tests run the exact twin: under `jax.jit`
    XLA contracts the twin's products into FMAs, and at the bilinear
    4x resize its full-resolution idx then moves on 2.2 % of these
    pixels."""
    out = JSemanticPost()._postprocess_inference((jd, ()), jbatch)
    return jax.tree_util.tree_map(np.asarray, out)


SEMANTIC_KEYS = ('semantic_output', 'semantic_softmax_scores',
                 'semantic_segmentation_score', 'semantic_segmentation_idx',
                 'semantic_output_fullres', 'semantic_softmax_scores_fullres',
                 'semantic_segmentation_score_fullres',
                 'semantic_segmentation_idx_fullres')
REGIONS = {'identity': ((slice(0, 48), slice(0, 64)), (48, 64)),
           'resize': ((slice(0, 48), slice(0, 64)), (72, 96)),
           'crop': ((slice(4, 44), slice(0, 64)), (40, 64)),
           'crop_resize': ((slice(3, 45), slice(5, 60)), (63, 80))}


@pytest.mark.parametrize('region', sorted(REGIONS))
@pytest.mark.parametrize('kind', ['zeropad2x', 'zeropad4x', 'bilinear4x'])
def test_deferred_fullres_keys_match_jax(kind, region):
    jd, td = _deferred(kind)
    jbatch, tbatch = _resize_batch(*REGIONS[region])
    want = _jax_semantic(jd, jbatch)
    got = SemanticPostprocessing().postprocess(
        (td, ()), tbatch, keys=frozenset(SEMANTIC_KEYS))
    for key in SEMANTIC_KEYS:
        g, w = got[key], np.asarray(want[key])
        if g.ndim == 4:
            g = np_nhwc(g)
        if 'idx' in key:
            equal(g, w, key)
        else:
            close(g, w, key)
    # without the dense keys the marker stays and no logits are built
    maps = SemanticPostprocessing().postprocess(
        (td, ()), tbatch, keys=frozenset(SEMANTIC_KEYS[2:4]
                                         + SEMANTIC_KEYS[6:]))
    assert isinstance(maps['semantic_output'], up.DEFERRED_TYPES) == (
        region == 'identity')
    assert 'semantic_softmax_scores' not in maps
    equal(maps['semantic_segmentation_idx_fullres'],
          want['semantic_segmentation_idx_fullres'], 'maps only')


@pytest.mark.parametrize('kind', ['zeropad2x', 'zeropad4x', 'bilinear4x'])
def test_softmax_argmax_is_idx_on_bf16_ties(kind):
    """Class 1 is class 0 times (1 + 2^-12): apart in f32, tied at many
    pixels once rounded to bf16; the first index wins in the finisher
    and in the dense exact logits alike (and in the JAX package). The
    promise holds on the tied pixels: elsewhere a bf16 softmax can
    round two near probabilities to one value, in the JAX package too
    (1-2 pixels of these 6144 there), so only the logits' argmax is
    held to idx at every pixel."""
    jd, td = _deferred(kind, jnp.bfloat16, seed=3)
    x = td.x.float()
    x[:, 1] = x[:, 0] * (1 + 2 ** -12)
    td = td._replace(x=x.to(torch.bfloat16))
    if kind != 'bilinear4x':
        fields = ('kernel', 'bias') if kind == 'zeropad2x' else (
            'kernel1', 'bias1', 'kernel2', 'bias2')
        td = td._replace(**{f: getattr(td, f).clone() for f in fields})
        for f in fields:
            getattr(td, f)[1] = getattr(td, f)[0]
    jd = jd._replace(x=jnp.asarray(np_nhwc(td.x), jnp.bfloat16),
                     **{f: jnp.asarray(np.asarray(getattr(td, f)).transpose(
                         2, 3, 1, 0) if getattr(td, f).ndim == 4 else
                         getattr(td, f).numpy())
                        for f in td._fields if f != 'x'})
    jbatch, tbatch = _resize_batch(*REGIONS['crop_resize'])
    got = SemanticPostprocessing().postprocess(
        (td, ()), tbatch, keys=frozenset(SEMANTIC_KEYS))
    logits = got['semantic_output']
    assert logits.dtype == torch.bfloat16
    top2 = logits.float().topk(2, dim=1).values
    tied = (top2[:, 0] == top2[:, 1]) & (logits.argmax(1) <= 1)
    assert int(tied.sum()) > 100
    idx = got['semantic_segmentation_idx']
    equal(got['semantic_softmax_scores'].float().argmax(dim=1)[tied],
          idx[tied], 'softmax argmax on ties')
    equal(logits.float().argmax(dim=1), idx, 'logits argmax')
    want = _jax_semantic(jd, jbatch)
    equal(idx, want['semantic_segmentation_idx'], 'idx vs JAX')
    equal(got['semantic_segmentation_idx_fullres'],
          want['semantic_segmentation_idx_fullres'], 'fullres idx vs JAX')

"""The eval slice's kernels of the PyTorch/CUDA port
(nicr_mtsa_tpu_torch) against their plain PyTorch versions on a CUDA
card: the crop + resize + reduce (also in f32 on the retrieval logits
of the dense-visual-embedding postprocessing), the score/argmax reduce
(NCHW, channels-last, a sliced view, 41 classes) and the PQ
intersection histogram (random and blocky slot maps). idx and counts
bit for bit, scores within rtol 1e-5.

The module imports neither JAX nor the JAX package, so it runs where
only PyTorch is installed; tests/conftest.py imports JAX, so there run

    python -m pytest --noconftest tests/test_torch_eval_kernels_card.py

Without a card the test skips."""
import numpy as np
import pytest
import torch

from nicr_mtsa_tpu_torch.ops.cuda import intersection as t_int
from nicr_mtsa_tpu_torch.ops.cuda import resize_reduce as t_rr
from nicr_mtsa_tpu_torch.ops.cuda import semantic_reduce as t_sr


def _blocky_slots(rng, B, H, W, n, cell):
    """Spatially coherent slot maps (B, H W): random slots in [0, n] on a
    grid of `cell`-pixel cells shifted by a random offset an image."""
    out = np.empty((B, H, W), np.int32)
    for b in range(B):
        oy, ox = rng.integers(0, cell, 2)
        coarse = rng.integers(0, n + 1, (H // cell + 2, W // cell + 2))
        ys = (np.arange(H) + oy) // cell
        xs = (np.arange(W) + ox) // cell
        out[b] = coarse[ys[:, None], xs[None, :]]
    return out.reshape(B, H * W)


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
    x_cl = x.contiguous(memory_format=torch.channels_last)
    x41 = torch.from_numpy(rng.normal(size=(2, 41, 60, 80)).astype(
        np.float32)).cuda().to(torch.bfloat16)
    for xx in (x_cl[:, :, 4:56, 8:72], x41,
               x41.contiguous(memory_format=torch.channels_last)):
        idx, score = t_sr.semantic_argmax_score(xx)
        idx_r, score_r = t_sr.semantic_argmax_score_reference(xx)
        assert torch.equal(idx, idx_r)
        torch.testing.assert_close(score, score_r, rtol=1e-5, atol=0)
    gt = torch.randint(0, 130, (2, 5000), device='cuda', dtype=torch.int32)
    pred = torch.randint(0, 130, (2, 5000), device='cuda', dtype=torch.int32)
    blocky = torch.from_numpy(_blocky_slots(rng, 2, 60, 80, 128, 8)).cuda()
    for a, b in ((gt, pred), (blocky, blocky.flip(1).contiguous())):
        assert torch.equal(
            t_int.intersection_matrix_kernel(a, b, 128, 128),
            t_int.intersection_matrix_reference(a, b, 128, 128))


@pytest.mark.cuda
def test_resize_reduce_f32_on_retrieval_logits_on_card():
    """Row 5's f32 instance at a small retrieval call: the f32
    channels-last logits of the DVE postprocessing (40 classes, an
    embedding of 64) cropped and resized to 64 x 96."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from nicr_mtsa_tpu_torch.postprocessing import (
        DenseVisualEmbeddingPostprocessing,
    )
    from nicr_mtsa_tpu_torch.postprocessing.dense_visual_embedding import (
        TEXT_PREFIX,
    )
    from nicr_mtsa_tpu_torch.testing import dve_tables
    _, text, _ = dve_tables(40, 64)
    post = DenseVisualEmbeddingPostprocessing(True, text)
    rng = np.random.default_rng(5)
    emb = torch.from_numpy(rng.normal(size=(2, 64, 60, 80)).astype(
        np.float32)).cuda().contiguous(memory_format=torch.channels_last)
    x = post.retrieval_logits(emb, [TEXT_PREFIX])[TEXT_PREFIX]
    assert x.dtype == torch.float32 and x.shape == (2, 40, 60, 80)
    assert x.is_contiguous(memory_format=torch.channels_last)
    for crop in ((slice(0, 60), slice(0, 80)), (slice(4, 56), slice(3, 77))):
        idx, score = t_rr.crop_resize_argmax_score(x, crop, 64, 96)
        idx_r, score_r = t_rr.crop_resize_argmax_score_reference(x, crop, 64,
                                                                 96)
        assert torch.equal(idx, idx_r)
        torch.testing.assert_close(score, score_r, rtol=1e-5, atol=0)

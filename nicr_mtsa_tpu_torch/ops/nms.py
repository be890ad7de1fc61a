"""Keypoint (instance-centre) NMS with a fixed-K centre table
(counterpart of nicr_mtsa_tpu/ops/nms.py).

A pixel survives iff it exceeds the threshold and is the FIRST maximum
(row-major scan order) of the k x k window centred on it; pixels closer
than (k-1)/2 to the border are excluded. The top-K selection breaks
score ties by the lowest flat index. On CUDA `torch.topk` leaves the
order of tied values undefined, so every selection here is a stable
descending `torch.sort`."""
from typing import NamedTuple

import torch
import torch.nn.functional as F


class Centers(NamedTuple):
    yx: torch.Tensor        # (B, K, 2) int32 centre coordinates
    score: torch.Tensor     # (B, K) heatmap value (-1 for padding)
    valid: torch.Tensor     # (B, K) bool


def nms_keep_mask(heatmap, threshold: float = 0.1, kernel_size: int = 3):
    """(B, H, W) -> (B, H, W) bool: local maxima above threshold."""
    assert kernel_size % 2 == 1
    pad = (kernel_size - 1) // 2
    B, H, W = heatmap.shape
    hm = torch.where(heatmap > threshold, heatmap,
                     torch.full_like(heatmap, -1.0))
    padded = F.pad(hm, (pad, pad, pad, pad), value=float('-inf'))
    keep = hm > -1.0
    for dy in range(-pad, pad + 1):
        for dx in range(-pad, pad + 1):
            if dy == 0 and dx == 0:
                continue
            nb = padded[:, dy + pad:dy + pad + H, dx + pad:dx + pad + W]
            if dy > 0 or (dy == 0 and dx > 0):
                keep &= hm >= nb         # later in scan: tie -> current
            else:
                keep &= hm > nb          # earlier in scan wins ties
    border = torch.zeros((H, W), dtype=torch.bool, device=hm.device)
    border[pad:H - pad, pad:W - pad] = True
    return keep & border


def _stable_top_k(x, k: int):
    """(values, indices) of the k largest along the last axis, ties by
    the lowest index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _block_reduced_top_k(scores_map, top_k: int):
    """Exact top-k over an NMS-masked scores map via a 2x2 block
    reduction; each block holds at most one survivor (see the JAX
    package's `_block_reduced_top_k`). 2*top_k block candidates are
    re-sorted by (-score, original flat index)."""
    B, H, W = scores_map.shape
    a = scores_map[:, 0::2, 0::2]
    b = scores_map[:, 0::2, 1::2]
    c = scores_map[:, 1::2, 0::2]
    d = scores_map[:, 1::2, 1::2]
    m = torch.maximum(torch.maximum(a, b), torch.maximum(c, d))
    Hr, Wr = H // 2, W // 2
    dev = scores_map.device
    base = (torch.arange(Hr, device=dev).view(1, Hr, 1) * (2 * W)
            + torch.arange(Wr, device=dev).view(1, 1, Wr) * 2)
    idx = torch.where(a == m, base,
                      torch.where(b == m, base + 1,
                                  torch.where(c == m, base + W,
                                              base + W + 1)))
    k2 = min(2 * top_k, Hr * Wr)
    s2, pos = _stable_top_k(m.reshape(B, Hr * Wr), k2)
    i2 = torch.gather(idx.reshape(B, Hr * Wr), 1, pos)
    # two-key sort: flat index ascending, then score descending (stable)
    o = torch.sort(i2, dim=1, stable=True).indices
    s2, i2 = torch.gather(s2, 1, o), torch.gather(i2, 1, o)
    o = torch.sort(s2, dim=1, descending=True, stable=True).indices
    s2, i2 = torch.gather(s2, 1, o), torch.gather(i2, 1, o)
    return s2[:, :top_k], i2[:, :top_k]


def get_instance_centers(heatmap, foreground_mask=None,
                         threshold: float = 0.1, kernel_size: int = 3,
                         top_k: int = 64,
                         use_foreground_mask: bool = False) -> Centers:
    """(B, H, W) heatmap -> top-K padded centre table (threshold > 0)."""
    B, H, W = heatmap.shape
    keep = nms_keep_mask(heatmap, threshold, kernel_size)
    neg = torch.full_like(heatmap, -1.0)
    scores_map = torch.where(keep, heatmap, neg)
    if use_foreground_mask and foreground_mask is not None:
        scores_map = torch.where(foreground_mask, scores_map, neg)
    if kernel_size >= 3 and H % 2 == 0 and W % 2 == 0 \
            and H * W > 4 * top_k:
        scores, flat_idx = _block_reduced_top_k(scores_map, top_k)
    else:
        scores, flat_idx = _stable_top_k(scores_map.reshape(B, H * W),
                                         top_k)
    yx = torch.stack([flat_idx // W, flat_idx % W], dim=-1)
    return Centers(yx=yx.to(torch.int32), score=scores, valid=scores > 0.0)

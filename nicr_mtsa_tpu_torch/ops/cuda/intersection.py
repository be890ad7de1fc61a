"""PQ intersection histogram: per image, the pixel counts of each
(gt slot, pred slot) pair of two slot maps (counterpart of
nicr_mtsa_tpu/ops/pallas/intersection_kernel.py
`intersection_matrix_pallas`, which computes
nicr_mtsa_tpu/ops/segments.py `intersection_matrix`).

On the card the work is done by csrc/intersection.cu (exact counts,
one launch a call: one thread-block cluster an image, its geometry
`it_plan`); on CPU tensors the wrapper runs the plain version,
`intersection_matrix_reference`, the one-hot product in f32 (exact
below 2^24 pixels per image)."""
import ctypes
import functools
from typing import Callable, NamedTuple

import torch

from ._build import check, is_cuda_tensor, load_library, refuse_grad

MAX_SMEM = 232448               # bytes of shared memory a block can take
MAX_BINS = MAX_SMEM // 4        # int32 bins in one block's shared memory
THREADS = 1024                  # csrc THREADS
CLUSTERS = (16, 8, 4, 2, 1)     # CTAs an image, in the order tried


class ItPlan(NamedTuple):
    """The launch: `cluster` CTAs an image, each with a histogram of
    `smem` bytes; an image's pixels are `head` scalar pixels up to the
    first 16-byte boundary, `vectors` 4-pixel vectors, then `tail`
    scalar pixels (vec False: all `head`); a CTA sums `bins_per_rank`
    bins (rounded up to groups of 4) over the cluster."""
    cluster: int
    vec: bool
    head: int
    vectors: int
    tail: int
    smem: int
    bins_per_rank: int


def it_plan(B: int, P: int, G: int, Q: int, gt_phase: int,
            pred_phase: int, gt_stride: int, pred_stride: int,
            max_clusters: Callable[[int, int], int]) -> ItPlan:
    """The geometry for B images of P pixels and G x Q bins. `*_phase`:
    the first image's offset in int32 elements past a 16-byte boundary,
    `*_stride`: the image strides (elements). 16-byte vectors where both
    maps start every image at the same phase. The cluster: of CLUSTERS
    that leave a CTA at least a vector a thread and that the card holds
    (`max_clusters(cluster, smem)` at once, at least 1), the one with
    the fewest waves of clusters per CTA an image (the pixels a CTA
    reads in turn), then the fewest waves (at B = 8 and 129 x 129 bins
    on an H100: 8, one wave, not 16 in two)."""
    if G * Q > MAX_BINS:
        raise ValueError(f'intersection_matrix: {G} x {Q} bins exceed '
                         f'one block\'s shared memory')
    if P >= 2 ** 31:
        raise ValueError(f'intersection_matrix: {P} pixels an image exceed '
                         f'the kernel\'s 32-bit pixel index')
    smem = -(-G * Q * 4 // 16) * 16
    vec = gt_phase == pred_phase and gt_stride % 4 == 0 \
        and pred_stride % 4 == 0
    if vec:
        head = min(P, -gt_phase % 4)
        vectors = (P - head) // 4
        tail = P - head - 4 * vectors
    else:
        head, vectors, tail = P, 0, 0
    costs = []
    for cluster in CLUSTERS:
        if cluster == 1 or cluster * 4 * THREADS <= P:
            held = max_clusters(cluster, smem)
            if held >= 1:
                waves = -(-B // held)
                costs.append((waves / cluster, waves, cluster))
    if not costs:
        raise ValueError(f'intersection_matrix: no cluster holds {smem} '
                         f'bytes of shared memory a CTA')
    cluster = min(costs)[2]
    return ItPlan(cluster, vec, head, vectors, tail, smem,
                  4 * -(-(-(-G * Q // 4)) // cluster))


def intersection_matrix_reference(gt_slots, pred_slots, n_gt: int,
                                  n_pred: int):
    """Plain PyTorch version: (B, n_gt+1, n_pred+1) f32 for slot maps
    (B, P); slots outside [0, n] are not counted."""
    def onehot(s, n):
        s = s.long()
        s = torch.where((s >= 0) & (s <= n), s, n + 1)
        oh = torch.zeros((*s.shape, n + 2), dtype=torch.float32,
                         device=s.device)
        return oh.scatter_(2, s[..., None], 1.0)[..., :n + 1]
    return torch.bmm(onehot(gt_slots, n_gt).transpose(1, 2),
                     onehot(pred_slots, n_pred))


@functools.lru_cache(maxsize=None)
def _fns():
    lib = load_library('intersection')
    fn = lib.intersection_counts
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] \
        + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    occ = lib.intersection_max_clusters
    occ.restype, occ.argtypes = ctypes.c_int, [ctypes.c_int] * 2
    return fn, occ


@functools.lru_cache(maxsize=256)
def _plan(B, P, G, Q, gt_phase, pred_phase, gt_stride, pred_stride,
          device_index):
    _, occ = _fns()

    def max_clusters(cluster, smem):
        with torch.cuda.device(device_index):
            n = occ(cluster, smem)
        if n < 0:
            raise RuntimeError(f'intersection_matrix: CUDA error {-n} '
                               f'asking for clusters of {cluster}')
        return n

    return it_plan(B, P, G, Q, gt_phase, pred_phase, gt_stride,
                   pred_stride, max_clusters)


def _int32_rows(slots, device):
    """(B, P) int32 on `device` with unit pixel stride: as given where
    it is so."""
    slots = slots.to(device=device, dtype=torch.int32)
    return slots if slots.stride(1) == 1 or slots.shape[1] <= 1 \
        else slots.contiguous()


def plan_of(gt, pred, n_gt: int, n_pred: int) -> ItPlan:
    """The plan the kernel takes for these (B, P) int32 CUDA slot maps
    of unit pixel stride."""
    def phase(t):
        return t.data_ptr() // 4 % 4

    def stride(t):                 # one image: no stride between images
        return t.stride(0) if t.shape[0] > 1 else 0
    return _plan(*gt.shape, n_gt + 1, n_pred + 1, phase(gt), phase(pred),
                 stride(gt), stride(pred), gt.device.index)


def _launch(gt_slots, pred_slots, n_gt: int, n_pred: int):
    B, P = gt_slots.shape
    if pred_slots.shape != (B, P):
        raise ValueError('intersection_matrix: gt and pred slot maps '
                         'must both be (B, P)')
    dev = gt_slots.device
    gt, pred = _int32_rows(gt_slots, dev), _int32_rows(pred_slots, dev)
    out = torch.empty((B, n_gt + 1, n_pred + 1), dtype=torch.float32,
                      device=dev)
    if B == 0:
        return out
    plan = plan_of(gt, pred, n_gt, n_pred)
    fn, _ = _fns()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(gt.data_ptr(), pred.data_ptr(), out.data_ptr(), B,
                 gt.stride(0), pred.stride(0), n_gt, n_pred, plan.cluster,
                 plan.head, plan.vectors, plan.tail, plan.smem, stream)
    check(err, 'intersection_matrix')
    intersection_matrix_kernel.launches += 1
    return out


def intersection_matrix_kernel(gt_slots, pred_slots, n_gt: int,
                               n_pred: int):
    """(B, n_gt+1, n_pred+1) f32 pixel counts of the (gt, pred) slot
    pairs of slot maps (B, P). CUDA tensors go to the kernel; CPU
    tensors to the plain version."""
    if not is_cuda_tensor(gt_slots):
        return intersection_matrix_reference(gt_slots, pred_slots, n_gt,
                                             n_pred)
    refuse_grad('intersection_matrix_kernel', gt_slots, pred_slots)
    return _launch(gt_slots, pred_slots, n_gt, n_pred)


intersection_matrix_kernel.launches = 0

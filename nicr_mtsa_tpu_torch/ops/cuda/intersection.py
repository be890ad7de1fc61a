"""PQ intersection histogram: per image, the pixel counts of each
(gt slot, pred slot) pair of two slot maps (counterpart of
nicr_mtsa_tpu/ops/pallas/intersection_kernel.py
`intersection_matrix_pallas`, which computes
nicr_mtsa_tpu/ops/segments.py `intersection_matrix`).

On the card the work is done by csrc/intersection.cu (int32 counts,
exact); on CPU tensors the wrapper runs the plain version,
`intersection_matrix_reference`, the one-hot product in f32 (exact
below 2^24 pixels per image)."""
import ctypes

import torch

from ._build import check, is_cuda_tensor, load_library, refuse_grad

MAX_BINS = 232448 // 4          # int32 bins in one block's shared memory


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


def _launch(gt_slots, pred_slots, n_gt: int, n_pred: int):
    B, P = gt_slots.shape
    if pred_slots.shape != (B, P):
        raise ValueError('intersection_matrix: gt and pred slot maps '
                         'must both be (B, P)')
    if (n_gt + 1) * (n_pred + 1) > MAX_BINS:
        raise ValueError(f'intersection_matrix: {n_gt + 1} x {n_pred + 1} '
                         f'bins exceed one block\'s shared memory')
    lib = load_library('intersection')
    fn = lib.intersection_counts
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong,
                                           ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    dev = gt_slots.device
    gt = gt_slots.to(torch.int32).contiguous()
    pred = pred_slots.to(device=dev, dtype=torch.int32).contiguous()
    counts = torch.zeros((B, n_gt + 1, n_pred + 1), dtype=torch.int32,
                         device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(gt.data_ptr(), pred.data_ptr(), counts.data_ptr(), B, P,
                 n_gt, n_pred, stream)
    check(err, 'intersection_matrix')
    intersection_matrix_kernel.launches += 1
    return counts.float()


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

"""Crop + half-pixel bilinear resize + first argmax / max-softmax score
(counterpart of nicr_mtsa_tpu/ops/pallas/resize_reduce.py
`crop_resize_argmax_score`): the full-resolution semantic idx/score of
working-resolution logits, without the resized logits ever existing.

On the card the work is done by csrc/resize_reduce.cu; on CPU tensors
the wrapper runs the plain version, `crop_resize_argmax_score_reference`
= semantic_score_idx(resize_bilinear(crop(x).float(), h, w)). Both use
the host tap tables of models/upsampling.py `two_tap_params` and the
same rounding steps, so their argmax is bit-identical. Inputs are
NCHW with any strides."""
import ctypes
from typing import Dict, Tuple

import torch

from ...models.upsampling import resize_bilinear, two_tap_params
from ..reduce import semantic_score_idx
from ._build import check, is_cuda_tensor, load_library, refuse_grad

_FUNCS = {torch.float32: 'resize_reduce_f32',
          torch.bfloat16: 'resize_reduce_bf16'}
_TABLES: Dict[Tuple, Tuple[torch.Tensor, ...]] = {}


def _crop_box(shape, crop_slices):
    """(y0, x0, in_h, in_w) of unit-step crop slices of (.., H, W)."""
    H, W = shape[-2:]
    y0, y1, ys = crop_slices[0].indices(H)
    x0, x1, xs = crop_slices[1].indices(W)
    if ys != 1 or xs != 1 or y1 <= y0 or x1 <= x0:
        raise ValueError(f'crop_resize_argmax_score needs non-empty '
                         f'unit-step crop slices, got {crop_slices}')
    return y0, x0, y1 - y0, x1 - x0


def crop_resize_argmax_score_reference(x, crop_slices, out_h: int,
                                       out_w: int):
    """Plain PyTorch version: (idx int32, score f32), (B, out_h, out_w)."""
    y0, x0, in_h, in_w = _crop_box(x.shape, crop_slices)
    cropped = x[:, :, y0:y0 + in_h, x0:x0 + in_w].float()
    return semantic_score_idx(resize_bilinear(cropped, out_h, out_w), dim=1)


def _tables(in_h, out_h, in_w, out_w, device):
    """Device copies of the tap tables, made once per shape/device (a
    copy per call would synchronise the host with the card)."""
    key = (in_h, out_h, in_w, out_w, str(device))
    if key not in _TABLES:
        ts = []
        for n, m in ((in_h, out_h), (in_w, out_w)):
            lo, hi, w0, w1 = two_tap_params(n, m)
            ts += [torch.from_numpy(lo).to(device, torch.int32),
                   torch.from_numpy(hi).to(device, torch.int32),
                   torch.from_numpy(w0).to(device),
                   torch.from_numpy(w1).to(device)]
        _TABLES[key] = tuple(ts)
    return _TABLES[key]


def _launch(x, crop_slices, out_h: int, out_w: int):
    if x.dim() != 4 or x.dtype not in _FUNCS:
        raise ValueError(f'crop_resize_argmax_score takes (B, C, H, W) '
                         f'float32/bfloat16 logits, got {tuple(x.shape)} '
                         f'{x.dtype}')
    y0, x0, in_h, in_w = _crop_box(x.shape, crop_slices)
    tables = _tables(in_h, out_h, in_w, out_w, x.device)
    lib = load_library('resize_reduce')
    fn = getattr(lib, _FUNCS[x.dtype])
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 \
        + [ctypes.c_longlong] * 4 + [ctypes.c_void_p]
    B, C = x.shape[:2]
    idx = torch.empty((B, out_h, out_w), dtype=torch.int32, device=x.device)
    score = torch.empty((B, out_h, out_w), dtype=torch.float32,
                        device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), *[t.data_ptr() for t in tables],
                 idx.data_ptr(), score.data_ptr(), B, C, out_h, out_w,
                 y0, x0, *x.stride(), stream)
    check(err, 'crop_resize_argmax_score')
    crop_resize_argmax_score.launches += 1
    return idx, score


def crop_resize_argmax_score(x, crop_slices, out_h: int, out_w: int):
    """(first-argmax idx int32, max-softmax score f32), both
    (B, out_h, out_w), of NCHW logits x cropped to `crop_slices`
    ((slice_y, slice_x), unit steps) and bilinearly resized. CUDA
    tensors go to the kernel; CPU tensors to the plain version."""
    if not is_cuda_tensor(x):
        return crop_resize_argmax_score_reference(x, crop_slices, out_h,
                                                  out_w)
    refuse_grad('crop_resize_argmax_score', x)
    return _launch(x, crop_slices, out_h, out_w)


crop_resize_argmax_score.launches = 0

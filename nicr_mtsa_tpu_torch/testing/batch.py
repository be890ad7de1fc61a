"""Synthetic batches: the random training batch of the JAX package's
`bench.py --train`, and eval batches, the host -> device hand-off of
the eval path without JAX or OpenCV (in the manner of
nicr_mtsa_tpu/testing/batch.py).

Ground truth is made at full resolution from a seed: stuff bands, a
void band and rectangular thing instances with one orientation each.
It is nearest-resized to the working resolution with the host
preprocessing's index map, the targets the eval step reads come from
the numpy generators of data/targets.py, and the batch moves to the
device as tensors: dense images NCHW ('rgb', 'depth',
'instance_offset', 'orientation', 'normal'), maps (B, H, W) int32 or
bool.

Surface-normal targets are opt-in (`normals=True`), drawn from a
generator of their own (`normal_rng(seed)`), so every batch without
them stays as it was: a unit vector a pixel, NORMAL_INVALID_SHARE of
the pixels all zero (invalid), nearest-resized like the labels."""
from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..data._utils import move_batch_to_device
from ..data.fullres import nearest_indices, resize_provenance
from ..data.targets import (index_image, instance_targets,
                            orientation_targets, panoptic_fullres_targets)
from ..pipeline import RGB_MEAN, RGB_STD
from ..tasks.dense_visual_embedding import pad_embedding_luts
from ..utils.device import resolve_device

DEPTH_MEAN, DEPTH_STD = 8000.0, 4000.0       # bench.py NormalizeDepth
# the share of all-zero (invalid) pixels of the synthetic normal targets
NORMAL_INVALID_SHARE = 0.1
# the training batch's keys that are not per-pixel targets
_INPUT_KEYS = ('rgb', 'depth', 'rgbd', 'scene')


class GroundTruth(NamedTuple):
    semantic: np.ndarray              # (H, W) uint8, 0 = void
    instance: np.ndarray              # (H, W) uint16, 0 = no instance
    orientations: Dict[int, float]    # instance id -> angle (rad)


class EvalBatch(NamedTuple):
    batch: Dict[str, torch.Tensor]    # tensors on the device
    static_batch: dict                # the Resize provenance
    segment_table_overflow: int       # GT ids the tables could not hold


def synthetic_ground_truth(rng, full_hw: Tuple[int, int], n_classes: int,
                           is_thing: Sequence[bool],
                           n_instances: int = 10) -> GroundTruth:
    """One full-resolution sample (`is_thing` without void)."""
    H, W = full_hw
    thing = [c + 1 for c in range(n_classes) if is_thing[c]]
    stuff = [c + 1 for c in range(n_classes) if not is_thing[c]]
    semantic = np.zeros((H, W), np.uint8)
    bands = np.sort(rng.choice(np.arange(1, H), size=3, replace=False))
    for y0, y1 in zip((0, *bands), (*bands, H)):
        semantic[y0:y1] = rng.choice(stuff)
    semantic[:, :W // 16] = 0                           # a void band
    instance = np.zeros((H, W), np.uint16)
    orientations = {}
    for i in range(1, n_instances + 1):
        h = int(rng.integers(H // 16, H // 3))
        w = int(rng.integers(W // 16, W // 3))
        y, x = int(rng.integers(0, H - h)), int(rng.integers(0, W - w))
        semantic[y:y + h, x:x + w] = rng.choice(thing)
        instance[y:y + h, x:x + w] = i
        orientations[i] = float(rng.uniform(0.0, 2 * np.pi))
    return GroundTruth(semantic, instance, orientations)


def eval_arrays(samples: List[GroundTruth], work_hw: Tuple[int, int],
                is_thing: Sequence[bool], segment_table_size: int = 128,
                sigma: int = 8) -> Tuple[Dict[str, np.ndarray], int]:
    """The ground-truth arrays of the eval batch, stacked (host side),
    and the number of GT ids the segment tables could not hold."""
    is_thing_v = (False,) + tuple(bool(t) for t in is_thing)
    h, w = work_hw
    out: Dict[str, list] = {}
    overflow = 0
    for gt in samples:
        yi = nearest_indices(gt.semantic.shape[0], h)
        xi = nearest_indices(gt.semantic.shape[1], w)
        sem = gt.semantic[yi[:, None], xi[None, :]]
        ins = gt.instance[yi[:, None], xi[None, :]]
        pan = panoptic_fullres_targets(gt.semantic, gt.instance, is_thing_v,
                                       gt.orientations, segment_table_size)
        overflow += pan.overflow
        sample = {'semantic': sem, 'instance': ins,
                  'semantic_fullres': gt.semantic,
                  'instance_fullres': gt.instance,
                  'panoptic_fullres': pan.panoptic,
                  'panoptic_segment_table_fullres': pan.segment_table,
                  'panoptic_gt_angle_table': pan.angle_table,
                  'panoptic_gt_angle_table_valid': pan.angle_table_valid}
        sample.update(instance_targets(ins, sem, is_thing_v,
                                       sigma=sigma).arrays)
        sample.update(orientation_targets(ins, sem, gt.orientations,
                                          is_thing_v).arrays)
        for k, v in sample.items():
            out.setdefault(k, []).append(v)
    return {k: np.stack(v) for k, v in out.items()}, overflow


def normal_rng(seed: int) -> np.random.Generator:
    """The generator of a batch's synthetic normal targets: apart from
    the batch's own, so that opting in changes nothing else."""
    return np.random.default_rng([seed, 1])


def normal_maps(rng, B: int, H: int, W: int,
                invalid_share: float = NORMAL_INVALID_SHARE) -> np.ndarray:
    """(B, H, W, 3) f32 unit normals, one a pixel (normalised Gaussian
    draws), with `invalid_share` of the pixels all zero."""
    n = rng.normal(size=(B, H, W, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    n[rng.random((B, H, W)) < invalid_share] = 0.0
    return n


def nearest_downscale(a: np.ndarray, k: int) -> np.ndarray:
    """A (B, H, W, ...) map at 1 / k resolution, by the host
    preprocessing's nearest index map."""
    H, W = a.shape[1:3]
    yi = nearest_indices(H, H // k)
    xi = nearest_indices(W, W // k)
    return a[:, yi][:, :, xi]


def train_arrays(B: int, H: int, W: int, seed: int = 0,
                 n_classes: int = 40, rgbd: bool = True,
                 normals: bool = False,
                 downscales: Sequence[int] = ()) -> Dict[str, np.ndarray]:
    """The random training batch of `bench.py --train`, in the JAX
    package's layouts (NHWC inputs, maps (B, H, W)), drawn in its order
    from `np.random.default_rng(seed)`: the inputs, 'rgbd' (B, H, W, 4)
    for a 4-channel backbone or, with `rgbd=False`, 'rgb' (B, H, W, 3)
    and 'depth' (B, H, W, 1) for two encoders; 'semantic' in
    [0, n_classes] (0 void), the instance centre, offset and masks, the
    orientation and its mask, and 'scene' in [1, 10). With `normals`,
    also 'normal' (`normal_maps` from `normal_rng(seed)`); for each k of
    `downscales`, '_down_<k>': every per-pixel target nearest-downscaled
    by k (the side outputs' multiscale supervision)."""
    rng = np.random.default_rng(seed)
    if rgbd:
        batch = {'rgbd': rng.normal(size=(B, H, W, 4)).astype(np.float32)}
    else:
        batch = {'rgb': rng.normal(size=(B, H, W, 3)).astype(np.float32),
                 'depth': rng.normal(size=(B, H, W, 1)).astype(np.float32)}
    batch.update({
        'semantic': rng.integers(0, n_classes + 1, (B, H, W)).astype(
            np.int32),
        'instance_center': rng.random((B, H, W)).astype(np.float32),
        'instance_offset': rng.normal(size=(B, H, W, 2)).astype(np.float32),
        'instance_foreground': rng.random((B, H, W)) > 0.5,
        'instance_center_mask': rng.random((B, H, W)) > 0.3,
        'orientation': rng.normal(size=(B, H, W, 2)).astype(np.float32),
        'orientation_foreground': rng.random((B, H, W)) > 0.5,
        'scene': rng.integers(1, 10, (B,)).astype(np.int32),
    })
    if normals:
        batch['normal'] = normal_maps(normal_rng(seed), B, H, W)
    targets = {k: v for k, v in batch.items() if k not in _INPUT_KEYS}
    for k in downscales:
        batch[f'_down_{k}'] = {key: nearest_downscale(v, k)
                               for key, v in targets.items()}
    return batch


def build_train_batch(B: int, H: int, W: int, seed: int = 0, device=None,
                      n_classes: int = 40, rgbd: bool = True,
                      normals: bool = False,
                      downscales: Sequence[int] = ()
                      ) -> Dict[str, torch.Tensor]:
    """`train_arrays` as tensors on `device` (default `cuda`): dense
    images NCHW ('rgbd' or 'rgb' and 'depth', 'instance_offset',
    'orientation', 'normal'), maps (B, H, W) int32 or bool, 'scene' (B,)
    int32, the '_down_<k>' dicts alike."""
    device = resolve_device(device)
    return move_batch_to_device(
        train_arrays(B, H, W, seed, n_classes, rgbd, normals, downscales),
        device)


def _unit_rows(rng, n: int, dim: int) -> np.ndarray:
    m = rng.normal(size=(n, dim)).astype(np.float32)
    return m / np.linalg.norm(m, axis=1, keepdims=True)


def dve_tables(n_classes: int, dim: int, seed: int = 7):
    """(generator, text table, visual-mean table) of the JAX package's
    `bench.py --eval` with the dense-visual-embedding task: unit rows of
    normals, (n_classes, dim) f32 each, drawn in the bench's order from
    `np.random.default_rng(seed)`; the generator goes on to draw the
    LUTs (`dve_arrays`)."""
    rng = np.random.default_rng(seed)
    text = _unit_rows(rng, n_classes, dim)
    return rng, text, _unit_rows(rng, n_classes, dim)


def dve_arrays(panoptic: np.ndarray, dim: int, rng) -> Dict[str, np.ndarray]:
    """The bench's synthetic dense-visual-embedding targets of
    working-resolution panoptic maps (B, H, W): each image's nonzero ids
    in ascending order are its LUT rows 1..L (unit rows drawn from
    `rng`, image by image), 'dense_visual_embedding_indices' (B, H, W)
    int32 each pixel's row (0: void) and 'dense_visual_embedding_lut'
    (B, L_max+1, dim) f32 the padded LUTs."""
    luts, indices = [], []
    for pan in panoptic:
        ids = np.unique(pan)
        ids = ids[ids != 0].astype(np.int64)
        luts.append(_unit_rows(rng, len(ids), dim))
        indices.append(index_image(pan, ids))
    return {'dense_visual_embedding_indices': np.stack(indices),
            'dense_visual_embedding_lut': pad_embedding_luts(luts, dim)}


def build_eval_batch(B: int, work_hw: Tuple[int, int],
                     full_hw: Tuple[int, int], n_classes: int,
                     is_thing: Sequence[bool], seed: int = 0,
                     segment_table_size: int = 128, device=None,
                     dve_dim: int = None, normals: bool = False
                     ) -> EvalBatch:
    """A synthetic eval batch of B samples on `device` (default
    `cuda`): normalised random RGB-D inputs at `work_hw`, ground truth
    and targets as `eval_arrays` makes them, scene labels in
    1..10, and the Resize provenance of a full valid region. With
    `dve_dim`, also the bench's dense-visual-embedding targets of that
    width (`dve_arrays` on the working-resolution panoptic maps, the
    LUTs drawn after `dve_tables(n_classes, dve_dim)`). With `normals`,
    'normal_fullres' (`normal_maps` at `full_hw` from `normal_rng(seed)`)
    and its nearest resize to `work_hw`, 'normal'."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    samples = [synthetic_ground_truth(rng, full_hw, n_classes, is_thing)
               for _ in range(B)]
    arrays, overflow = eval_arrays(samples, work_hw, is_thing,
                                   segment_table_size)
    if dve_dim is not None:
        is_thing_v = (False,) + tuple(bool(t) for t in is_thing)
        panoptic = np.stack([panoptic_fullres_targets(
            sem, ins, is_thing_v, {}, segment_table_size).panoptic
            for sem, ins in zip(arrays['semantic'], arrays['instance'])])
        arrays.update(dve_arrays(panoptic, dve_dim,
                                 dve_tables(n_classes, dve_dim)[0]))
    h, w = work_hw
    rgb = rng.integers(0, 256, (B, h, w, 3)).astype(np.float32)
    depth = rng.integers(0, 2 ** 14, (B, h, w, 1)).astype(np.float32)
    arrays['rgb'] = (rgb - RGB_MEAN) / RGB_STD
    arrays['depth'] = np.where(depth == 0, 0.0, (depth - DEPTH_MEAN)
                               / DEPTH_STD).astype(np.float32)
    arrays['scene'] = rng.integers(1, 11, (B,)).astype(np.int32)
    if normals:
        full = normal_maps(normal_rng(seed), B, *full_hw)
        arrays['normal_fullres'] = full
        arrays['normal'] = full[:, nearest_indices(full_hw[0], h)][
            :, :, nearest_indices(full_hw[1], w)]
    return EvalBatch(move_batch_to_device(arrays, device),
                     resize_provenance(h, w), overflow)

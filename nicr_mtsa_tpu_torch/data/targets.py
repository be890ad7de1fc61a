"""Host-side (numpy) target generation: own copies of the JAX package's
generators, the arithmetic behind the preprocessing steps of
data/preprocessing/ and the synthetic eval batch of testing/batch.py.
Counterparts:

- `instance_targets`: data/preprocessing/instance.py
  `InstanceTargetGenerator` (Gaussian centre heatmap, offsets to the
  centre, foreground and centre-loss masks),
- `orientation_targets`: data/preprocessing/orientation.py
  `OrientationTargetGenerator` (dense biternions + foreground),
- `naive_merge_semantic_and_instance_np`: ops/merge_np.py,
- `panoptic_fullres_targets`: the full-resolution part of
  data/preprocessing/panoptic.py `PanopticTargetGenerator` (panoptic
  map, sorted segment table, per-slot GT angles), which also reports
  how many ids the table could not hold: the JAX generator truncates
  silently,
- `index_image`: data/preprocessing/dense_visual_embedding.py
  `_index_image` (the dense-visual-embedding target's index map)."""
from collections import Counter
from typing import Dict, List, NamedTuple, Optional

import numpy as np

SEGMENT_TABLE_PAD = 2 ** 31 - 1
MAX_INSTANCES_PER_CATEGORY = 1 << 16


def _gaussian_patch(sigma: int) -> np.ndarray:
    """(6*sigma+3)^2 splat, peak 1.0 at the centre (3*sigma+1)."""
    c = 3 * sigma + 1
    dy, dx = np.ogrid[-c:c + 1, -c:c + 1]
    return np.exp((dy * dy + dx * dx) / (-2.0 * sigma * sigma))


class InstanceTargets(NamedTuple):
    arrays: Dict[str, np.ndarray]  # the four target images
    encoded: List[int]             # instance ids with targets
    skipped: List[int]             # instance ids skipped as stuff


def instance_targets(instance: np.ndarray, semantic: Optional[np.ndarray],
                     is_thing_with_void, sigma: int = 8,
                     normalized_offset: bool = True) -> InstanceTargets:
    """{'instance_center' (H, W) f32, 'instance_offset' (H, W, 2),
    'instance_foreground', 'instance_center_mask' (H, W) bool} of one
    sample; instances whose majority class is stuff are skipped. With
    `is_thing_with_void` None every instance is a thing and the centre
    mask is the foreground."""
    height, width = instance.shape
    ids, inverse = np.unique(instance, return_inverse=True)
    inverse = inverse.reshape(height, width)
    n_seg = len(ids)
    counts = np.bincount(inverse.ravel(), minlength=n_seg)

    stuff_ids = None
    is_thing_seg = np.ones(n_seg, dtype=bool)
    if is_thing_with_void is not None:
        is_thing = np.asarray(is_thing_with_void, dtype=bool)
        stuff_ids = np.flatnonzero(~is_thing)[1:]          # without void
        if semantic is not None:
            sem = np.asarray(semantic)
            n_classes = int(sem.max()) + 1
            hist = np.bincount(
                inverse.ravel() * n_classes + sem.ravel().astype(np.int64),
                minlength=n_seg * n_classes).reshape(n_seg, n_classes)
            is_thing_seg = np.isin(hist.argmax(axis=1),
                                   np.flatnonzero(is_thing))
    is_instance_seg = (ids != 0) & is_thing_seg

    # centre = int(mean(y)), int(mean(x)) per segment
    yy, xx = np.meshgrid(np.arange(height), np.arange(width),
                         indexing='ij')
    safe_counts = np.maximum(counts, 1)
    center_y = (np.bincount(inverse.ravel(), weights=yy.ravel(),
                            minlength=n_seg) / safe_counts).astype(np.int64)
    center_x = (np.bincount(inverse.ravel(), weights=xx.ravel(),
                            minlength=n_seg) / safe_counts).astype(np.int64)

    foreground = is_instance_seg[inverse]
    offset = np.zeros((height, width, 2), dtype='int16')
    offset[..., 0] = np.where(foreground, center_y[inverse] - yy, 0)
    offset[..., 1] = np.where(foreground, center_x[inverse] - xx, 0)

    center = np.zeros((height, width), dtype='float32')
    gauss = _gaussian_patch(sigma)
    reach = 3 * sigma + 1
    for seg_idx in np.nonzero(is_instance_seg)[0]:
        cy, cx = int(center_y[seg_idx]), int(center_x[seg_idx])
        y0, y1 = max(cy - reach, 0), min(cy + reach + 1, height)
        x0, x1 = max(cx - reach, 0), min(cx + reach + 1, width)
        if y0 >= y1 or x0 >= x1:
            continue
        py, px = y0 - (cy - reach), x0 - (cx - reach)
        patch = gauss[py:py + (y1 - y0), px:px + (x1 - x0)]
        np.maximum(center[y0:y1, x0:x1], patch, out=center[y0:y1, x0:x1])

    if normalized_offset:
        offset = offset.astype('float32')
        offset[..., 0] /= height
        offset[..., 1] /= width
    center_mask = foreground.copy()
    if stuff_ids is not None and semantic is not None:
        center_mask |= np.isin(semantic, stuff_ids)
    arrays = {'instance_center': center, 'instance_offset': offset,
              'instance_foreground': foreground,
              'instance_center_mask': center_mask}
    return InstanceTargets(
        arrays, [int(i) for i in ids[(ids != 0) & is_thing_seg]],
        [int(i) for i in ids[(ids != 0) & ~is_thing_seg]])


class OrientationTargets(NamedTuple):
    arrays: Dict[str, np.ndarray]  # 'orientation', 'orientation_foreground'
    present: Dict[int, float]      # the encoded instances' orientations


def orientation_targets(instance: np.ndarray, semantic: np.ndarray,
                        orientations: Dict[int, float],
                        estimate_orientation_with_void) -> OrientationTargets:
    """{'orientation' (H, W, 2) f32 (cos, sin), 'orientation_foreground'
    (H, W) bool} of one sample: annotated instances whose majority
    class estimates an orientation (any class where
    `estimate_orientation_with_void` is None)."""
    ids, inverse = np.unique(instance, return_inverse=True)
    slot_img = inverse.reshape(instance.shape)
    eligible = np.array([bool(i) and i in orientations for i in ids],
                        dtype=bool)
    if estimate_orientation_with_void is not None and eligible.any():
        n_classes = int(semantic.max()) + 1 if semantic.size else 1
        joint = np.bincount(
            slot_img.ravel().astype(np.int64) * n_classes
            + semantic.ravel().astype(np.int64),
            minlength=len(ids) * n_classes).reshape(len(ids), n_classes)
        eligible &= np.isin(joint.argmax(axis=1), np.flatnonzero(
            estimate_orientation_with_void))
    angles = np.array([orientations.get(i, 0.0) if keep else 0.0
                       for i, keep in zip(ids, eligible)], dtype=np.float32)
    lut = np.stack([np.cos(angles), np.sin(angles)],
                   axis=-1).astype(np.float32)
    lut[~eligible] = 0.0
    return OrientationTargets(
        {'orientation': lut[slot_img],
         'orientation_foreground': eligible[slot_img]},
        {i: orientations[i] for i, keep in zip(ids, eligible) if keep})


def naive_merge_semantic_and_instance_np(sem_seg, ins_seg,
                                         max_instances_per_category: int,
                                         thing_ids, void_label: int = 0):
    """(panoptic uint32, {panoptic id: instance id}): an instance that
    covers several classes is split per class; stuff on instance-free
    pixels gets class * M."""
    pan_seg = np.zeros_like(sem_seg, dtype=np.uint32) + void_label
    tracker: Counter = Counter()
    id_dict: Dict[int, int] = {}
    thing_id_set = (set(int(t) for t in thing_ids)
                    if thing_ids is not None else set())
    for ins_id in np.unique(ins_seg):
        if ins_id == 0:
            continue
        thing_mask = ins_seg == ins_id
        for class_id in np.unique(sem_seg[thing_mask]):
            if class_id == 0:
                continue
            class_id = np.uint32(class_id)
            tracker[int(class_id)] += 1                 # first id is 1
            panoptic_id = class_id * max_instances_per_category \
                + tracker[int(class_id)]
            id_dict[int(panoptic_id)] = int(ins_id)
            pan_seg[(sem_seg == class_id) & thing_mask] = panoptic_id
    for class_id in np.unique(sem_seg):
        if class_id == 0 or int(class_id) in thing_id_set:
            continue
        class_id = np.uint32(class_id)
        pan_seg[(sem_seg == class_id) & (ins_seg == 0)] = \
            class_id * max_instances_per_category
    return pan_seg, id_dict


class PanopticTargets(NamedTuple):
    panoptic: np.ndarray           # (H, W) uint32 panoptic ids
    segment_table: np.ndarray      # (S,) int64 sorted, PAD-padded
    angle_table: np.ndarray        # (S,) f32 GT angle per slot
    angle_table_valid: np.ndarray  # (S,) bool
    overflow: int                  # ids the table could not hold


def segment_table(panoptic: np.ndarray, table_size: int):
    """(table, overflow): the sorted ids of a panoptic map in a
    (table_size,) int64 table padded with SEGMENT_TABLE_PAD, and how
    many ids it could not hold."""
    ids = np.unique(panoptic).astype(np.int64)
    table = np.full((table_size,), SEGMENT_TABLE_PAD, dtype=np.int64)
    table[:min(len(ids), table_size)] = ids[:table_size]
    return table, max(0, len(ids) - table_size)


def merge_targets(semantic: np.ndarray, instance: np.ndarray, thing_ids):
    """(panoptic uint32, {panoptic id: instance id}) of one sample."""
    return naive_merge_semantic_and_instance_np(
        semantic, instance.astype(np.uint16), MAX_INSTANCES_PER_CATEGORY,
        thing_ids)


def angle_tables(table: np.ndarray, id_dict: Dict[int, int],
                 orientations: Dict[int, float]):
    """(angles f32, valid bool): the GT angle of each table slot whose
    panoptic id is an instance with an orientation."""
    angles = np.zeros(table.shape, np.float32)
    valid = np.zeros(table.shape, bool)
    for slot, pan_id in enumerate(table):
        ins_id = id_dict.get(int(pan_id))
        if ins_id is not None and ins_id in orientations:
            angles[slot] = float(orientations[ins_id])
            valid[slot] = True
    return angles, valid


def panoptic_fullres_targets(semantic: np.ndarray, instance: np.ndarray,
                             is_thing_with_void,
                             orientations: Dict[int, float],
                             table_size: int) -> PanopticTargets:
    """Full-resolution panoptic targets of one sample."""
    pan, id_dict = merge_targets(
        semantic, instance, np.flatnonzero(np.asarray(is_thing_with_void)))
    table, overflow = segment_table(pan, table_size)
    angles, valid = angle_tables(table, id_dict, orientations)
    return PanopticTargets(pan, table, angles, valid, overflow)


def index_image(panoptic: np.ndarray, segment_ids: np.ndarray) -> np.ndarray:
    """Dense int32 image of 1-based positions in `segment_ids` (the row
    of each pixel's segment in the embedding LUT), 0 where a pixel's id
    is not among them (void): one sorted search over the pixel map."""
    if not len(segment_ids):
        return np.zeros(panoptic.shape, dtype=np.int32)
    order = np.argsort(segment_ids)
    table = segment_ids[order]
    pixels = panoptic.astype(np.int64).ravel()
    slot = np.clip(np.searchsorted(table, pixels), 0, len(table) - 1)
    hit = table[slot] == pixels
    dense = np.where(hit, order[slot] + 1, 0).astype(np.int32)
    return dense.reshape(panoptic.shape)

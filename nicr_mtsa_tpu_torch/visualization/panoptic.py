"""Panoptic visualisation (own copy of
nicr_mtsa_tpu/visualization/panoptic.py); numpy images, as dense.py."""
from typing import Optional, Sequence

import numpy as np

from ._colors import PanopticColorGenerator, generate_semantic_colors


def visualize_panoptic(
    panoptic_img: np.ndarray,
    max_instances: int = 1 << 16,
    classes_is_thing: Optional[Sequence[bool]] = None,
    classes_colors: Optional[np.ndarray] = None,
    shared_color_generator: Optional[PanopticColorGenerator] = None,
) -> np.ndarray:
    """(H, W) panoptic ids -> (H, W, 3) uint8: stuff in its class colour,
    each thing instance in a jittered class colour."""
    panoptic_img = np.asarray(panoptic_img).astype(np.int64)
    if shared_color_generator is None:
        n_classes = int(panoptic_img.max() // max_instances) + 1
        if classes_colors is None:
            classes_colors = generate_semantic_colors(max(n_classes, 2))
        if classes_is_thing is None:
            classes_is_thing = [True] * len(classes_colors)
        # tables covering every class present
        n = max(n_classes, len(classes_colors))
        colors = np.zeros((n, 3), np.uint8)
        colors[:len(classes_colors)] = classes_colors
        is_thing = np.zeros((n,), bool)
        is_thing[:len(classes_is_thing)] = classes_is_thing
        shared_color_generator = PanopticColorGenerator(
            classes_colors=colors, classes_is_thing=is_thing,
            max_instances=max_instances)
    out = np.zeros((*panoptic_img.shape, 3), np.uint8)
    for pan_id in np.unique(panoptic_img):
        out[panoptic_img == pan_id] = \
            shared_color_generator.get_color(int(pan_id))
    return out


def visualize_panoptic_pil(panoptic_img, max_instances=1 << 16,
                           classes_is_thing=None, classes_colors=None,
                           shared_color_generator=None) -> np.ndarray:
    return visualize_panoptic(panoptic_img, max_instances, classes_is_thing,
                              classes_colors, shared_color_generator)

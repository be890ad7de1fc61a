"""Colour generators (own copy of
nicr_mtsa_tpu/visualization/_colors.py): deterministic id -> colour
mappings, stable across frames, panoptic segments de-duplicated against
the colours already taken."""
from typing import Dict, Optional, Sequence, Tuple

import colorsys

import numpy as np


def generate_semantic_colors(n_classes: int) -> np.ndarray:
    """(n, 3) uint8 palette with index 0 = black (void); hues spread
    around the wheel with alternating saturation/value tiers."""
    colors = np.zeros((n_classes, 3), np.uint8)
    for i in range(1, n_classes):
        h = (i * 0.6180339887498949) % 1.0          # golden-ratio hue
        s = 0.85 if i % 2 else 0.55
        v = 0.95 if i % 3 else 0.7
        r, g, b = colorsys.hsv_to_rgb(h, s, v)
        colors[i] = (int(r * 255), int(g * 255), int(b * 255))
    return colors


class InstanceColorGenerator:
    """Stable instance-id -> color mapping via golden-ratio hues;
    id 0 (no instance) is black."""

    def __init__(self, cmap_length: int = 256) -> None:
        self._cache: Dict[int, Tuple[int, int, int]] = {0: (0, 0, 0)}
        self._cmap_length = cmap_length

    def get_color(self, instance_id: int) -> Tuple[int, int, int]:
        instance_id = int(instance_id)
        if instance_id not in self._cache:
            h = (instance_id * 0.6180339887498949) % 1.0
            s = 0.7 + 0.3 * ((instance_id * 7) % 2)
            v = 0.8 + 0.2 * ((instance_id * 3) % 2)
            r, g, b = colorsys.hsv_to_rgb(h, min(s, 1.0), min(v, 1.0))
            self._cache[instance_id] = (int(r * 255), int(g * 255),
                                        int(b * 255))
        return self._cache[instance_id]

    def palette(self, max_id: int) -> np.ndarray:
        return np.array([self.get_color(i) for i in range(max_id + 1)],
                        np.uint8)


class PanopticColorGenerator:
    """Panoptic id -> color: stuff segments use the class color, thing
    instances get a per-instance jitter of their class color,
    de-duplicated against colors already taken."""

    def __init__(
        self,
        classes_colors: Sequence[Tuple[int, int, int]],
        classes_is_thing: Sequence[bool],
        max_instances: int = 1 << 16,
        void_label: int = 0,
    ) -> None:
        self._classes_colors = np.asarray(classes_colors, np.uint8)
        self._classes_is_thing = np.asarray(classes_is_thing, bool)
        self._max_instances = max_instances
        self._void_label = void_label
        self._cache: Dict[int, Tuple[int, int, int]] = {}
        self._taken = set()
        self._rng = np.random.default_rng(42)

    def get_color(self, panoptic_id: int) -> Tuple[int, int, int]:
        panoptic_id = int(panoptic_id)
        if panoptic_id in self._cache:
            return self._cache[panoptic_id]

        class_id = panoptic_id // self._max_instances
        if panoptic_id == self._void_label:
            color = (0, 0, 0)
        elif class_id >= len(self._classes_colors):
            color = (128, 128, 128)
        elif not self._classes_is_thing[class_id] \
                or panoptic_id % self._max_instances == 0:
            color = tuple(int(c) for c in self._classes_colors[class_id])
        else:
            base = self._classes_colors[class_id].astype(np.int32)
            for _ in range(32):
                jitter = self._rng.integers(-60, 61, size=3)
                cand = tuple(int(c) for c in
                             np.clip(base + jitter, 0, 255))
                if cand not in self._taken:
                    break
            color = cand
        self._cache[panoptic_id] = color
        self._taken.add(color)
        return color

"""Dense-map visualisations: semantic palettes, heatmaps, depth and
surface normals (own copy of nicr_mtsa_tpu/visualization/dense.py).

Every function returns a numpy (H, W, 3) uint8 image. The `*_pil`
names return the same array (PIL is not assumed where the port runs;
write an image with `data.png.write_png`), where the JAX package's
return PIL images; `to_pil_img` likewise returns the array the JAX
package's would put into its PIL image (an indexed image's palette
applied)."""
from typing import Optional

import numpy as np

from ._colors import generate_semantic_colors


def to_pil_img(img: np.ndarray, palette=None) -> np.ndarray:
    """The array of the JAX package's `to_pil_img`: with a palette, the
    (H, W, 3) uint8 colours of the ids; without, values above 255 as
    uint16, else uint8."""
    img = np.asarray(img)
    if palette is not None:
        return np.asarray(palette, dtype='uint8')[img]
    if img.size and img.max() > 255:
        return img.astype('uint16')
    return img.astype('uint8')


def visualize_semantic(semantic_img: np.ndarray,
                       colors: Optional[np.ndarray] = None) -> np.ndarray:
    """(H, W) class map -> (H, W, 3) palette image (index 0 black where
    `colors` follows the with-void convention)."""
    semantic_img = np.asarray(semantic_img)
    n = int(semantic_img.max()) + 1 if semantic_img.size else 1
    if colors is None:
        colors = generate_semantic_colors(max(n, 2))
    colors = np.asarray(colors, np.uint8)
    idx = np.clip(semantic_img, 0, len(colors) - 1).astype(np.int64)
    return colors[idx]


def visualize_semantic_pil(semantic_img, colors=None) -> np.ndarray:
    return visualize_semantic(semantic_img, colors)


# a viridis-like colormap where matplotlib is missing
_FALLBACK_CMAP = np.array([
    (68, 1, 84), (71, 44, 122), (59, 81, 139), (44, 113, 142),
    (33, 144, 141), (39, 173, 129), (92, 200, 99), (170, 220, 50),
    (253, 231, 37),
], np.uint8)


def visualize_heatmap(heatmap_img: np.ndarray,
                      min_: Optional[float] = None,
                      max_: Optional[float] = None,
                      cmap: str = 'viridis') -> np.ndarray:
    """(H, W) float -> (H, W, 3) uint8 through matplotlib's `cmap`
    where matplotlib is installed, else the built-in map."""
    x = np.asarray(heatmap_img, np.float32)
    lo = float(x.min()) if min_ is None else float(min_)
    hi = float(x.max()) if max_ is None else float(max_)
    x = np.clip((x - lo) / max(hi - lo, 1e-12), 0.0, 1.0)
    try:
        import matplotlib
        rgba = matplotlib.colormaps[cmap](x)
        return (rgba[..., :3] * 255).astype(np.uint8)
    except Exception:
        pos = x * (len(_FALLBACK_CMAP) - 1)
        i0 = np.floor(pos).astype(int)
        i1 = np.clip(i0 + 1, 0, len(_FALLBACK_CMAP) - 1)
        frac = (pos - i0)[..., None]
        c = _FALLBACK_CMAP[i0] * (1 - frac) + _FALLBACK_CMAP[i1] * frac
        return c.astype(np.uint8)


def visualize_heatmap_pil(heatmap_img, min_=None, max_=None,
                          cmap: str = 'viridis') -> np.ndarray:
    return visualize_heatmap(heatmap_img, min_, max_, cmap)


def visualize_depth(depth_img: np.ndarray) -> np.ndarray:
    """(H, W[, 1]) depth -> turbo heatmap over the valid range; invalid
    (0) pixels black."""
    d = np.asarray(depth_img, np.float32)
    if d.ndim == 3:
        d = d[..., 0]
    valid = d > 0
    if valid.any():
        lo, hi = d[valid].min(), d[valid].max()
    else:
        lo, hi = 0.0, 1.0
    img = visualize_heatmap(d, min_=lo, max_=hi, cmap='turbo')
    img[~valid] = 0
    return img


def visualize_depth_pil(depth_img) -> np.ndarray:
    return visualize_depth(depth_img)


def visualize_normal(normal_img: np.ndarray) -> np.ndarray:
    """(H, W, 3) unit normals in [-1, 1] -> RGB (n + 1) / 2; zero
    vectors (invalid) black."""
    n = np.asarray(normal_img, np.float32)
    img = np.clip((n + 1.0) * 0.5 * 255.0, 0, 255).astype(np.uint8)
    img[~np.any(n != 0, axis=-1)] = 0
    return img


def visualize_normal_pil(normal_img) -> np.ndarray:
    return visualize_normal(normal_img)

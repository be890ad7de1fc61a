"""Instance visualisations: stable instance colours, centre heatmaps and
crosses, offset fields, dense orientations and per-instance orientation
overlays (own copy of nicr_mtsa_tpu/visualization/instance.py); numpy
images, as dense.py. Only the overlay's angle text needs PIL (and a
font), imported when it is drawn."""
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ._colors import InstanceColorGenerator
from .dense import visualize_heatmap


def _pil():
    try:
        from PIL import Image, ImageDraw, ImageFont
    except ImportError as e:
        raise ImportError('visualize_instance_orientations draws its angle '
                          'text with PIL (Pillow), which is not '
                          'installed') from e
    return Image, ImageDraw, ImageFont


def _mono_bold_font(size: int = 30):
    """A monospace-bold TTF at `size` from matplotlib's bundled DejaVu
    fonts, else FreeMonoBold, else PIL's bitmap font."""
    _, _, ImageFont = _pil()
    try:
        import os
        import matplotlib
        path = os.path.join(os.path.dirname(matplotlib.__file__),
                            'mpl-data', 'fonts', 'ttf',
                            'DejaVuSansMono-Bold.ttf')
        return ImageFont.truetype(path, size)
    except Exception:
        try:
            return ImageFont.truetype('FreeMonoBold.ttf', size)
        except Exception:
            return ImageFont.load_default()


def visualize_instance(instance_img: np.ndarray,
                       color_generator: Optional[InstanceColorGenerator]
                       = None) -> np.ndarray:
    """(H, W) instance ids -> (H, W, 3) uint8 in stable colours."""
    instance_img = np.asarray(instance_img).astype(np.int64)
    gen = color_generator or InstanceColorGenerator()
    palette = gen.palette(int(instance_img.max()) if instance_img.size
                          else 0)
    return palette[np.clip(instance_img, 0, len(palette) - 1)]


def visualize_instance_pil(instance_img, color_generator=None) -> np.ndarray:
    return visualize_instance(instance_img, color_generator)


def visualize_instance_center(
    center_img: Optional[np.ndarray] = None,
    centers: Optional[Sequence[Tuple[int, int]]] = None,
    height: Optional[int] = None,
    width: Optional[int] = None,
    min_: float = 0.0,
    max_: float = 1.0,
    cross_size: int = 3,
) -> np.ndarray:
    """A centre heatmap through the colormap, or red crosses at the
    (y, x) `centers` on a black (height, width) image."""
    if center_img is not None:
        return visualize_heatmap(center_img, min_=min_, max_=max_)
    if centers is None or not height or not width:
        raise ValueError('pass center_img, or centers with height and '
                         'width')
    img = np.zeros((height, width, 3), np.uint8)
    for (y, x) in centers:
        y, x = int(y), int(x)
        y0, y1 = max(0, y - cross_size), min(height, y + cross_size + 1)
        x0, x1 = max(0, x - cross_size), min(width, x + cross_size + 1)
        img[y0:y1, x] = (255, 0, 0)
        img[y, x0:x1] = (255, 0, 0)
    return img


def visualize_instance_center_pil(center_img=None, centers=None,
                                  height=None, width=None,
                                  min_=0.0, max_=1.0) -> np.ndarray:
    return visualize_instance_center(center_img, centers, height, width,
                                     min_, max_)


def _angle_magnitude_to_rgb(angle, magnitude):
    """HSV wheel: hue the angle, value the magnitude."""
    h = (angle + np.pi) / (2 * np.pi)
    s = np.ones_like(h)
    hsv = np.stack([h, s, magnitude], axis=-1)
    i = np.floor(hsv[..., 0] * 6.0).astype(int) % 6
    f = hsv[..., 0] * 6.0 - np.floor(hsv[..., 0] * 6.0)
    p = hsv[..., 2] * (1 - hsv[..., 1])
    q = hsv[..., 2] * (1 - f * hsv[..., 1])
    t = hsv[..., 2] * (1 - (1 - f) * hsv[..., 1])
    vv = hsv[..., 2]
    r = np.choose(i, [vv, q, p, p, t, vv])
    g = np.choose(i, [t, vv, vv, q, p, p])
    b = np.choose(i, [p, p, t, vv, vv, q])
    return (np.stack([r, g, b], axis=-1) * 255).astype(np.uint8)


def visualize_instance_offset(offset_img: np.ndarray) -> np.ndarray:
    """(H, W, 2) (dy, dx) offsets -> direction as hue, length as value."""
    off = np.asarray(offset_img, np.float32)
    angle = np.arctan2(off[..., 0], off[..., 1])
    mag = np.linalg.norm(off, axis=-1)
    mag = mag / max(float(mag.max()), 1e-6)
    return _angle_magnitude_to_rgb(angle, mag)


def visualize_instance_offset_pil(offset_img) -> np.ndarray:
    return visualize_instance_offset(offset_img)


def visualize_orientation(orientation_img: np.ndarray) -> np.ndarray:
    """(H, W, 2) biternions (cos, sin) -> angle as hue; near-zero
    vectors stay dark."""
    o = np.asarray(orientation_img, np.float32)
    angle = np.arctan2(o[..., 1], o[..., 0])
    mag = np.clip(np.linalg.norm(o, axis=-1), 0.0, 1.0)
    return _angle_magnitude_to_rgb(angle, mag)


def visualize_orientation_pil(orientation_img) -> np.ndarray:
    return visualize_orientation(orientation_img)


def visualize_instance_orientations(
    instance_img: np.ndarray,
    orientations: Dict[int, float],
    color_generator: Optional[InstanceColorGenerator] = None,
    arrow_length: int = 12,
) -> np.ndarray:
    """The instance image with an orientation arrow and the angle in
    degrees at each oriented instance's centroid (text in a monospace
    bold font of size 30). Needs PIL: without it, an ImportError."""
    img = visualize_instance(instance_img, color_generator)
    instance_img = np.asarray(instance_img)
    Image, ImageDraw, _ = _pil()
    pil = Image.fromarray(img)
    draw = ImageDraw.Draw(pil)
    font = _mono_bold_font(size=30)
    for instance_id, angle in orientations.items():
        mask = instance_img == instance_id
        if not mask.any():
            continue
        ys, xs = np.nonzero(mask)
        cy, cx = float(ys.mean()), float(xs.mean())
        dy = -np.cos(float(angle)) * arrow_length
        dx = np.sin(float(angle)) * arrow_length
        draw.line([(cx, cy), (cx + dx, cy + dy)], fill=(255, 255, 255),
                  width=2)
        draw.text((cx + 2, cy + 2), f'{np.rad2deg(float(angle)):.0f}',
                  fill=(255, 255, 255), font=font)
    return np.asarray(pil)


def visualize_instance_orientations_pil(instance_img, orientations,
                                        color_generator=None) -> np.ndarray:
    return visualize_instance_orientations(instance_img, orientations,
                                           color_generator)

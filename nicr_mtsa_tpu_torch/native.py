"""ctypes wrapper of the native host-preprocessing library
(`native/mtsa_preproc.cpp`: nearest and bilinear resize, uint8 RGB
normalisation and uint8 HSV jitter over HWC numpy buffers, each
multithreaded over rows).

The source is compiled at first use by `g++` with the flags of
`native/Makefile` (other flags can change floating-point contraction,
and the bilinear resize would stop matching a build of the Makefile
bit for bit) into `_native_build/` beside this file (listed in
.gitignore), named by a hash of the source, the flags and the target
that `-march=native` resolves to. A missing source, a missing compiler
or a failed build raises: there is no numpy fallback. The numpy
versions stay as the plain versions (`*_reference`), which the tests
hold the library against. Nothing is built or loaded when this module
is imported."""
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from .data.fullres import nearest_indices

SOURCE = Path(__file__).resolve().parent.parent / 'native' / 'mtsa_preproc.cpp'
BUILD_DIR = Path(__file__).resolve().parent / '_native_build'
# native/Makefile: CXXFLAGS, then `-shared -o $@ $< -lpthread`
CXX_FLAGS = ('-O3', '-std=c++17', '-fPIC', '-Wall', '-march=native')

_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()


def _compiler() -> str:
    cxx = shutil.which('g++')
    if cxx is None:
        raise RuntimeError('g++ not found: the native preprocessing '
                           'library cannot be built')
    return cxx


def _target(cxx: str) -> Path:
    if not SOURCE.is_file():
        raise RuntimeError(f'native preprocessing source missing: {SOURCE}')
    # what -march=native means on this machine: a build directory copied
    # to another host must not load a library built for this CPU
    march = subprocess.run([cxx, '-march=native', '-Q', '--help=target'],
                           capture_output=True, text=True, timeout=60)
    h = hashlib.sha256(SOURCE.read_bytes() + ' '.join(CXX_FLAGS).encode()
                       + march.stdout.encode())
    return BUILD_DIR / f'libmtsa_preproc-{h.hexdigest()[:16]}.so'


def build() -> Path:
    """Compile the library unless this source, these flags and this
    target are built already; its path."""
    cxx = _compiler()
    out = _target(cxx)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f'.{os.getpid()}.tmp')
    cmd = [cxx, *CXX_FLAGS, '-shared', '-o', str(tmp), str(SOURCE),
           '-lpthread']
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        raise RuntimeError(f'building {SOURCE.name} failed:\n{res.stderr}')
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The loaded library, built on first use."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            u8p = ctypes.POINTER(ctypes.c_uint8)
            f32p = ctypes.POINTER(ctypes.c_float)
            i = ctypes.c_int
            lib.nearest_resize.argtypes = [u8p, u8p, i, i, i, i, i, i]
            lib.bilinear_resize_u8.argtypes = [u8p, u8p, i, i, i, i, i]
            lib.normalize_u8_to_f32.argtypes = [u8p, f32p, i, i, f32p, f32p]
            lib.hsv_jitter_u8.argtypes = [u8p, u8p, ctypes.c_int64, i, i, i]
            for fn in (lib.nearest_resize, lib.bilinear_resize_u8,
                       lib.normalize_u8_to_f32, lib.hsv_jitter_u8):
                fn.restype = None
            _LIB = lib
    return _LIB


def _u8(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _need_u8(value: np.ndarray, what: str, rgb: bool = False) -> None:
    if value.dtype != np.uint8:
        raise TypeError(f'{what} takes uint8, got {value.dtype}')
    if rgb and (value.ndim != 3 or value.shape[-1] != 3):
        raise ValueError(f'{what} takes (H, W, 3), got {value.shape}')
    if value.ndim not in (2, 3):
        raise ValueError(f'{what} takes (H, W[, C]), got {value.shape}')


def nearest_resize(value: np.ndarray, height: int, width: int) -> np.ndarray:
    """Nearest resize of an (H, W, ...) array of any fixed-size dtype
    (src = floor(dst * in / out), the cv2.INTER_NEAREST mapping)."""
    if value.ndim < 2 or value.dtype == object:
        raise ValueError(f'nearest_resize takes (H, W, ...) arrays, got '
                         f'{value.shape} {value.dtype}')
    lib = load()
    value = np.ascontiguousarray(value)
    h, w = value.shape[:2]
    channels = int(np.prod(value.shape[2:], dtype=np.int64))
    dst = np.empty((height, width) + value.shape[2:], dtype=value.dtype)
    lib.nearest_resize(_u8(value.view(np.uint8)), _u8(dst.view(np.uint8)),
                       h, w, height, width, channels, value.dtype.itemsize)
    return dst


def bilinear_resize_u8(value: np.ndarray, height: int,
                       width: int) -> np.ndarray:
    """Bilinear resize of uint8 (H, W[, C]) with half-pixel centres and
    edge clamping (cv2.INTER_LINEAR), rounded to nearest."""
    _need_u8(value, 'bilinear_resize_u8')
    lib = load()
    value = np.ascontiguousarray(value)
    h, w = value.shape[:2]
    channels = 1 if value.ndim == 2 else value.shape[2]
    dst = np.empty((height, width) + value.shape[2:], np.uint8)
    lib.bilinear_resize_u8(_u8(value), _u8(dst), h, w, height, width,
                           channels)
    return dst


def normalize_u8(value: np.ndarray, mean, std) -> np.ndarray:
    """(x - mean) / std in float32 of uint8 (H, W[, C]), per channel
    (the library multiplies by 1 / std)."""
    _need_u8(value, 'normalize_u8')
    lib = load()
    value = np.ascontiguousarray(value)
    channels = value.shape[-1] if value.ndim == 3 else 1
    mean32 = np.ascontiguousarray(mean, np.float32).reshape(-1)
    std32 = np.ascontiguousarray(std, np.float32).reshape(-1)
    if len(mean32) != channels or len(std32) != channels:
        raise ValueError(f'normalize_u8: {channels} channels, statistics '
                         f'of {len(mean32)} and {len(std32)}')
    dst = np.empty(value.shape, np.float32)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.normalize_u8_to_f32(
        _u8(value), dst.ctypes.data_as(f32p), value.size // channels,
        channels, mean32.ctypes.data_as(f32p), std32.ctypes.data_as(f32p))
    return dst


def hsv_jitter_u8(value: np.ndarray, h_offset: int, s_offset: int,
                  v_offset: int) -> np.ndarray:
    """Additive jitter of uint8 RGB (H, W, 3) in uint8 HSV space (OpenCV's
    convention, H in [0, 180)): hue wraps modulo 180, saturation and
    value clip to [0, 255]."""
    _need_u8(value, 'hsv_jitter_u8', rgb=True)
    lib = load()
    value = np.ascontiguousarray(value)
    dst = np.empty_like(value)
    lib.hsv_jitter_u8(_u8(value), _u8(dst), ctypes.c_int64(value.size // 3),
                      int(h_offset), int(s_offset), int(v_offset))
    return dst


# --- plain versions (numpy) --------------------------------------------------

def nearest_resize_reference(value: np.ndarray, height: int,
                             width: int) -> np.ndarray:
    yi = nearest_indices(value.shape[0], height)
    xi = nearest_indices(value.shape[1], width)
    return value[yi[:, None], xi[None, :], ...]


def bilinear_resize_u8_reference(value: np.ndarray, height: int,
                                 width: int) -> np.ndarray:
    """Half-pixel-centred bilinear resize with edge clamping in f32,
    rounded half to even (the library rounds half away from zero)."""
    x = np.asarray(value, dtype=np.float32)

    def coords(n_src, n_dst):
        c = (np.arange(n_dst) + 0.5) * (n_src / n_dst) - 0.5
        c0 = np.floor(c).astype(np.int64)
        frac = (c - c0).astype(np.float32)
        return (np.clip(c0, 0, n_src - 1), np.clip(c0 + 1, 0, n_src - 1),
                frac)

    y0, y1, fy = coords(value.shape[0], height)
    x0, x1, fx = coords(value.shape[1], width)
    fy = fy.reshape(-1, 1, *([1] * (x.ndim - 2)))
    fx = fx.reshape(1, -1, *([1] * (x.ndim - 2)))
    top = x[y0][:, x0] * (1 - fx) + x[y0][:, x1] * fx
    bot = x[y1][:, x0] * (1 - fx) + x[y1][:, x1] * fx
    out = top * (1 - fy) + bot * fy
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


def normalize_u8_reference(value: np.ndarray, mean, std) -> np.ndarray:
    return (value.astype(np.float32) - np.asarray(mean, np.float32)) \
        / np.asarray(std, np.float32)


def rgb_to_hsv_u8_reference(img_rgb: np.ndarray) -> np.ndarray:
    """uint8 RGB -> uint8 HSV, H in [0, 180), S and V in [0, 255]."""
    rgb = img_rgb.astype(np.int32)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    v = np.maximum(np.maximum(r, g), b)
    diff = v - np.minimum(np.minimum(r, g), b)
    s = np.where(v == 0, 0,
                 np.floor_divide(255 * diff + v // 2, np.maximum(v, 1)))
    diff_safe = np.maximum(diff, 1).astype(np.float64)
    h = np.where(
        v == r, (60.0 * (g - b)) / diff_safe,
        np.where(v == g, 120.0 + (60.0 * (b - r)) / diff_safe,
                 240.0 + (60.0 * (r - g)) / diff_safe))
    h = np.where(diff == 0, 0.0, h)
    h = np.where(h < 0, h + 360.0, h)
    h = np.round(h / 2.0).astype(np.int32) % 180
    return np.stack([h, s, v], axis=-1).astype(np.uint8)


def hsv_to_rgb_u8_reference(img_hsv: np.ndarray) -> np.ndarray:
    """uint8 HSV (H in [0, 180)) -> uint8 RGB."""
    h = img_hsv[..., 0].astype(np.float64) * 2.0
    s = img_hsv[..., 1].astype(np.float64) / 255.0
    v = img_hsv[..., 2].astype(np.float64) / 255.0
    c = v * s
    hp = h / 60.0
    x = c * (1.0 - np.abs(hp % 2.0 - 1.0))
    m = v - c
    hi = np.floor(hp).astype(np.int32) % 6
    z = np.zeros_like(c)
    r = np.choose(hi, [c, x, z, z, x, c])
    g = np.choose(hi, [x, c, c, x, z, z])
    b = np.choose(hi, [z, z, x, c, c, x])
    rgb = np.stack([r + m, g + m, b + m], axis=-1)
    return np.clip(np.round(rgb * 255.0), 0, 255).astype(np.uint8)


def hsv_jitter_u8_reference(value: np.ndarray, h_offset: int, s_offset: int,
                            v_offset: int) -> np.ndarray:
    hsv = rgb_to_hsv_u8_reference(value)
    h = ((hsv[..., 0].astype(int) + h_offset) % 180).astype(np.uint8)
    s = np.clip(hsv[..., 1].astype(int) + s_offset, 0, 255).astype(np.uint8)
    v = np.clip(hsv[..., 2].astype(int) + v_offset, 0, 255).astype(np.uint8)
    return hsv_to_rgb_u8_reference(np.stack([h, s, v], axis=2))

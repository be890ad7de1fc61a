"""PNG reader and writer on the standard library (`zlib`, `struct`) and
numpy, for the dataset's image files: the port reads and writes
datasets without PIL.

Read: non-interlaced 8-bit grey ((H, W) uint8), 16-bit grey ((H, W)
uint16, big-endian on disk, native-endian in memory) and 8-bit RGB
((H, W, 3) uint8), with any of the five row filters (None, Sub, Up,
Average, Paeth); chunk CRCs are checked, ancillary chunks skipped.
Anything else (interlaced, palette, alpha, other bit depths) raises.
Write: the same three kinds, every row with filter None."""
import struct
import zlib

import numpy as np

SIGNATURE = b'\x89PNG\r\n\x1a\n'
# (colour type, bit depth) -> (channels, bytes a sample)
_KINDS = {(0, 8): (1, 1), (0, 16): (1, 2), (2, 8): (3, 1)}


def _chunks(data: bytes, path: str):
    pos = len(SIGNATURE)
    while pos + 12 <= len(data):
        n, kind = struct.unpack('>I4s', data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc, = struct.unpack('>I', data[pos + 8 + n:pos + 12 + n])
        if len(body) != n or zlib.crc32(kind + body) != crc:
            raise ValueError(f'{path}: corrupt {kind!r} chunk')
        yield kind, body
        if kind == b'IEND':
            return
        pos += 12 + n
    raise ValueError(f'{path}: no IEND chunk')


def _unfilter_sequential(kind: int, f: bytes, prev: bytes, bpp: int
                         ) -> bytearray:
    """Average (3) or Paeth (4) of one row: each byte needs the
    reconstructed byte bpp to its left."""
    out = bytearray(len(f))
    for i in range(len(f)):
        a = out[i - bpp] if i >= bpp else 0
        b = prev[i]
        if kind == 3:
            out[i] = (f[i] + ((a + b) >> 1)) & 0xFF
            continue
        c = prev[i - bpp] if i >= bpp else 0
        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (f[i] + pred) & 0xFF
    return out


def _unfilter(raw: bytes, height: int, row_bytes: int, bpp: int,
              path: str) -> np.ndarray:
    rows = np.frombuffer(raw, np.uint8)
    if rows.size != height * (row_bytes + 1):
        raise ValueError(f'{path}: {rows.size} bytes of image data, '
                         f'expected {height * (row_bytes + 1)}')
    rows = rows.reshape(height, row_bytes + 1)
    out = np.empty((height, row_bytes), np.uint8)
    prev = np.zeros(row_bytes, np.uint8)
    for y in range(height):
        kind, f = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            out[y] = f
        elif kind == 1:           # Sub: running sum along each byte lane
            lanes = f.reshape(-1, bpp).astype(np.uint32)
            out[y] = (np.cumsum(lanes, axis=0) & 0xFF).reshape(-1)
        elif kind == 2:           # Up
            out[y] = f + prev
        elif kind in (3, 4):
            out[y] = np.frombuffer(_unfilter_sequential(
                kind, f.tobytes(), prev.tobytes(), bpp), np.uint8)
        else:
            raise ValueError(f'{path}: row {y} has filter type {kind}')
        prev = out[y]
    return out


def decode_png(data: bytes, path: str = '<bytes>') -> np.ndarray:
    if not data.startswith(SIGNATURE):
        raise ValueError(f'{path}: not a PNG file')
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b'IHDR':
            header = struct.unpack('>IIBBBBB', body)
        elif kind == b'IDAT':
            idat.append(body)
        elif kind == b'PLTE':
            raise ValueError(f'{path}: palette images are not supported')
    if header is None:
        raise ValueError(f'{path}: no IHDR chunk')
    width, height, depth, colour, method, filt, interlace = header
    if (colour, depth) not in _KINDS:
        raise ValueError(f'{path}: colour type {colour} at {depth} bits is '
                         f'not supported (8-bit grey, 16-bit grey and '
                         f'8-bit RGB are)')
    if interlace:
        raise ValueError(f'{path}: interlaced images are not supported')
    if method or filt:
        raise ValueError(f'{path}: unknown compression {method} or filter '
                         f'method {filt}')
    channels, size = _KINDS[(colour, depth)]
    bpp = channels * size
    rows = _unfilter(zlib.decompress(b''.join(idat)), height, width * bpp,
                     bpp, path)
    if size == 2:
        img = rows.view('>u2').astype(np.uint16)
    else:
        img = rows
    shape = (height, width) if channels == 1 else (height, width, channels)
    return img.reshape(shape)


def read_png(path: str) -> np.ndarray:
    """(H, W) uint8 / uint16 or (H, W, 3) uint8, a writable array."""
    with open(path, 'rb') as f:
        return decode_png(f.read(), path)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack('>I', len(body)) + kind + body
            + struct.pack('>I', zlib.crc32(kind + body)))


def encode_png(arr: np.ndarray) -> bytes:
    arr = np.asarray(arr)
    if arr.dtype == np.uint8 and arr.ndim == 2:
        colour, depth = 0, 8
    elif arr.dtype == np.uint16 and arr.ndim == 2:
        colour, depth = 0, 16
    elif arr.dtype == np.uint8 and arr.ndim == 3 and arr.shape[2] == 3:
        colour, depth = 2, 8
    else:
        raise ValueError(f'PNG writes (H, W) uint8/uint16 or (H, W, 3) '
                         f'uint8, got {arr.shape} {arr.dtype}')
    height, width = arr.shape[:2]
    rows = np.ascontiguousarray(arr.astype('>u2') if depth == 16 else arr)
    rows = rows.view(np.uint8).reshape(height, -1)
    raw = np.concatenate([np.zeros((height, 1), np.uint8), rows], axis=1)
    header = struct.pack('>IIBBBBB', width, height, depth, colour, 0, 0, 0)
    return (SIGNATURE + _chunk(b'IHDR', header)
            + _chunk(b'IDAT', zlib.compress(raw.tobytes()))
            + _chunk(b'IEND', b''))


def write_png(path: str, arr: np.ndarray) -> None:
    with open(path, 'wb') as f:
        f.write(encode_png(arr))

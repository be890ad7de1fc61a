"""The host data path of the PyTorch/CUDA port (nicr_mtsa_tpu_torch.data
and nicr_mtsa_tpu_torch.native) against the JAX package's
(nicr_mtsa_tpu.data, nicr_mtsa_tpu.native) on the repo's dataset
fixture (tests/fixtures/mini_dataset: 4 samples a split, 160 x 120, 10
classes of which 3 things).

- The `valid` samples through the eval Compose of `bench.py --eval
  --dataset` in both packages, each reading the files with its own
  dataset: every array equal, exactly (ints, bools, targets, depth;
  rgb as uint8 after the Resize, both sides on the native library), the
  normalised rgb within rtol 1e-6 (the port normalises on the native
  library, which multiplies by 1 / std, the JAX package in numpy), and
  the provenance equal but for the port's full-resolution overflow
  count.
- Resize with `keep_aspect_ratio`: padding and valid-region slices.
- A planted segment-table overflow is counted.
- The native library against its plain versions and against the JAX
  package's build of the same source (nearest and HSV exact, bilinear
  within 1 of the plain version, normalisation within rtol 1e-6).
- The PNG codec against PIL: every fixture file bit for bit, files with
  all five row filters, the writer read back by PIL; interlaced,
  palette and alpha files raise."""
import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from nicr_mtsa_tpu import native as jax_native
from nicr_mtsa_tpu.data import preprocessing as jpre
from nicr_mtsa_tpu.data.dataset import DirectoryRGBDDataset as JDataset
from nicr_mtsa_tpu_torch import native
from nicr_mtsa_tpu_torch.data import DirectoryRGBDDataset, png
from nicr_mtsa_tpu_torch.data import preprocessing as pre
from _torch_data_helpers import FIXTURE, eval_compose

@pytest.fixture(scope='module')
def datasets():
    ds = DirectoryRGBDDataset(str(FIXTURE), split='valid')
    is_thing_v = ds.config.semantic_label_list.classes_is_thing
    return ds, JDataset(str(FIXTURE), split='valid'), is_thing_v


def assert_same(got, want, where='', rgb_rtol=None):
    """Recursive equality of samples and provenance: arrays exactly
    (rgb within `rgb_rtol` where given), dicts key by key, sequences
    item by item."""
    if isinstance(want, np.ndarray) or isinstance(got, np.ndarray):
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape, where
        if rgb_rtol is not None and where.endswith('/rgb'):
            np.testing.assert_allclose(got, want, rtol=rgb_rtol, atol=0,
                                       err_msg=where)
        else:
            np.testing.assert_array_equal(got, want, err_msg=where)
    elif isinstance(want, dict):
        assert set(got) == set(want), (where, set(got) ^ set(want))
        for k in want:
            assert_same(got[k], want[k], f'{where}/{k}', rgb_rtol)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f'{where}[{i}]', rgb_rtol)
    else:
        assert got == want, (where, got, want)


def _without_port_overflow(meta):
    out = []
    for record in meta:
        record = dict(record)
        if record['type'] == 'PanopticTargetGenerator':
            assert record.pop('segment_table_overflow_fullres') == 0
        out.append(record)
    return out


@pytest.mark.parametrize('hw,samples', [((96, 128), (0, 1, 2, 3)),
                                        ((480, 640), (2,))],
                         ids=['96x128_all', '480x640_one'])
def test_eval_compose_matches_jax(datasets, hw, samples):
    ds, jds, is_thing_v = datasets
    assert native.load() is not None and jax_native.available()
    for i in samples:
        # rgb after the Resize, both on the native bilinear resize
        resized = eval_compose(pre, is_thing_v, *hw, stop_after='Resize')(
            ds[i])
        j_resized = eval_compose(jpre, is_thing_v, *hw,
                                 stop_after='Resize')(jds[i])
        np.testing.assert_array_equal(resized['rgb'], j_resized['rgb'])
        got = eval_compose(pre, is_thing_v, *hw)(ds[i])
        want = eval_compose(jpre, is_thing_v, *hw)(jds[i])
        meta_key = pre.APPLIED_PREPROCESSING_KEY
        got_meta, want_meta = got.pop(meta_key), want.pop(meta_key)
        assert_same(got, want, f'sample {i}', rgb_rtol=1e-6)
        assert_same(_without_port_overflow(got_meta), want_meta,
                    f'sample {i} provenance')
        assert pre.segment_table_overflow({meta_key: got_meta}) == 0
        assert got['rgb'].shape == hw + (3,)
        assert got['_down_8']['instance_center'].shape == (hw[0] // 8,
                                                            hw[1] // 8)


def test_resize_keep_aspect_ratio_matches_jax(datasets):
    ds, jds, _ = datasets
    meta_key = pre.APPLIED_PREPROCESSING_KEY
    for hw in ((100, 100), (90, 200)):
        got = pre.Resize(*hw, keep_aspect_ratio=True)(ds[1])
        want = jpre.Resize(*hw, keep_aspect_ratio=True)(jds[1])
        sy, sx = pre.get_valid_region_slices(got)
        assert_same(got.pop(meta_key), want.pop(meta_key), 'provenance')
        assert_same(got, want, f'{hw}')
        assert got['rgb'].shape[:2] == hw
        assert (sy.stop - sy.start, sx.stop - sx.start) != hw
        assert not got['rgb'][:sy.start].any() \
            and not got['rgb'][:, :sx.start].any()


def test_planted_overflow_is_counted(datasets):
    ds, jds, is_thing_v = datasets
    got = eval_compose(pre, is_thing_v, 96, 128, table=2)(ds[0])
    want = eval_compose(jpre, is_thing_v, 96, 128, table=2)(jds[0])
    n_full = len(np.unique(got['panoptic_fullres']))
    n_work = len(np.unique(got['panoptic']))
    assert n_full > 2 and n_work > 2
    np.testing.assert_array_equal(got['panoptic_segment_table_fullres'],
                                  want['panoptic_segment_table_fullres'])
    record = [r for r in got[pre.APPLIED_PREPROCESSING_KEY]
              if r['type'] == 'PanopticTargetGenerator'][0]
    assert record['segment_table_overflow_fullres'] == n_full - 2
    assert record['segment_table_overflow'] == n_work - 2
    assert pre.segment_table_overflow(got) > n_full + n_work - 4


NEAREST_CASES = [(np.uint8, (37, 53, 3)), (np.uint16, (64, 48)),
                 (np.uint32, (30, 40)), (np.int32, (24, 36)),
                 (np.float32, (24, 36, 2)), (bool, (32, 32))]


@pytest.mark.parametrize('dtype,shape', NEAREST_CASES,
                         ids=[np.dtype(d).name for d, _ in NEAREST_CASES])
def test_native_nearest_exact(dtype, shape):
    arr = np.random.default_rng(0).integers(0, 255, shape).astype(dtype)
    for h, w in ((17, 29), (64, 96), (37, 53)):
        got = native.nearest_resize(arr, h, w)
        np.testing.assert_array_equal(
            got, native.nearest_resize_reference(arr, h, w))
        np.testing.assert_array_equal(got,
                                      jax_native.nearest_resize(arr, h, w))


def test_native_bilinear_normalize_and_hsv():
    rng = np.random.default_rng(1)
    img = rng.integers(0, 255, (60, 80, 3), dtype=np.uint8)
    for h, w in ((45, 61), (120, 160), (15, 20)):
        got = native.bilinear_resize_u8(img, h, w)
        ref = native.bilinear_resize_u8_reference(img, h, w)
        assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
        np.testing.assert_array_equal(
            got, jax_native.bilinear_resize_u8(img, h, w))
    mean = np.array([100.0, 110.0, 120.0], np.float32)
    std = np.array([50.0, 55.0, 60.0], np.float32)
    got = native.normalize_u8(img, mean, std)
    np.testing.assert_allclose(
        got, native.normalize_u8_reference(img, mean, std), rtol=1e-6)
    np.testing.assert_array_equal(got, jax_native.normalize_u8(img, mean,
                                                               std))
    corners = np.zeros((4, 4, 3), np.uint8)
    corners[1], corners[2], corners[3] = 128, [255, 0, 0], [0, 255, 255]
    cases = [(rng.integers(0, 256, (41, 57, 3), dtype=np.uint8),
              int(rng.integers(-180, 181)), int(rng.integers(-255, 256)),
              int(rng.integers(-255, 256))) for _ in range(4)]
    cases += [(corners, *off) for off in ((-7, 30, -30), (90, -255, 255),
                                          (0, 0, 0))]
    for x, *off in cases:
        got = native.hsv_jitter_u8(x, *off)
        np.testing.assert_array_equal(
            got, native.hsv_jitter_u8_reference(x, *off), err_msg=str(off))
        np.testing.assert_array_equal(got, jax_native.hsv_jitter_u8(x, *off))
    with pytest.raises(TypeError):
        native.bilinear_resize_u8(img.astype(np.float32), 4, 4)


FIXTURE_PNGS = sorted(FIXTURE.glob('*/*/*.png'))


def _pil(data: bytes) -> np.ndarray:
    arr = np.array(Image.open(io.BytesIO(data)))
    return arr.astype(np.uint16) if arr.dtype == np.int32 else arr


def test_png_reader_equals_pil_on_fixture():
    assert len(FIXTURE_PNGS) == 32
    for path in FIXTURE_PNGS:
        got = png.read_png(str(path))
        want = _pil(path.read_bytes())
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=str(path))
        got[0, 0] = 0                          # writable, as PIL's copy


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filtered_png(arr: np.ndarray, filters) -> bytes:
    """A PNG of `arr` whose row y carries filter filters[y % len]."""
    colour, depth = (2, 8) if arr.ndim == 3 else (
        (0, 16) if arr.dtype == np.uint16 else (0, 8))
    rows = np.ascontiguousarray(arr.astype('>u2') if depth == 16 else arr)
    rows = rows.view(np.uint8).reshape(arr.shape[0], -1).astype(np.int64)
    bpp = (3 if colour == 2 else 1) * depth // 8
    prev = np.zeros_like(rows[0])
    raw = bytearray()
    for y, x in enumerate(rows):
        kind = filters[y % len(filters)]
        a = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        pred = {0: 0 * x, 1: a, 2: prev, 3: (a + prev) // 2,
                4: _paeth(a, prev, c)}[kind]
        raw += bytes([kind]) + ((x - pred) % 256).astype(np.uint8).tobytes()
        prev = x
    header = struct.pack('>IIBBBBB', arr.shape[1], arr.shape[0], depth,
                         colour, 0, 0, 0)
    chunk = lambda k, b: (struct.pack('>I', len(b)) + k + b   # noqa: E731
                          + struct.pack('>I', zlib.crc32(k + b)))
    return (png.SIGNATURE + chunk(b'IHDR', header)
            + chunk(b'IDAT', zlib.compress(bytes(raw))) + chunk(b'IEND', b''))


def _images():
    rng = np.random.default_rng(7)
    smooth = np.add.outer(np.arange(23), 3 * np.arange(31))
    return {'grey8': rng.integers(0, 256, (23, 31), dtype=np.uint8),
            'grey16': (smooth * 500 + rng.integers(0, 300, (23, 31))
                       ).astype(np.uint16),
            'rgb8': rng.integers(0, 256, (23, 31, 3), dtype=np.uint8)}


@pytest.mark.parametrize('kind', ['grey8', 'grey16', 'rgb8'])
def test_png_all_filters_and_writer_round_trip(kind, tmp_path):
    arr = _images()[kind]
    for filters in ((0, 1, 2, 3, 4), (3,), (4,), (4, 3, 1)):
        data = _filtered_png(arr, filters)
        np.testing.assert_array_equal(_pil(data), arr)
        np.testing.assert_array_equal(png.decode_png(data), arr)
    path = str(tmp_path / f'{kind}.png')
    png.write_png(path, arr)
    got = _pil(open(path, 'rb').read())
    assert got.dtype == arr.dtype
    np.testing.assert_array_equal(got, arr)
    np.testing.assert_array_equal(png.read_png(path), arr)


def test_png_refuses_other_kinds(tmp_path):
    rgb = _images()['rgb8']
    for name, img in (('palette', Image.fromarray(rgb).convert('P')),
                      ('rgba', Image.fromarray(rgb).convert('RGBA')),
                      ('grey_alpha', Image.fromarray(rgb).convert('LA'))):
        path = str(tmp_path / f'{name}.png')
        img.save(path)
        with pytest.raises(ValueError):
            png.read_png(path)
    data = bytearray(_filtered_png(rgb, (0,)))
    data[28] = 1                          # IHDR interlace method: Adam7
    data[29:33] = struct.pack('>I', zlib.crc32(bytes(data[12:29])))
    with pytest.raises(ValueError, match='interlaced'):
        png.decode_png(bytes(data))
    data[19] ^= 0xFF                      # a width byte, CRC unchanged
    with pytest.raises(ValueError, match='corrupt'):
        png.decode_png(bytes(data))
    with pytest.raises(ValueError):
        png.encode_png(rgb.astype(np.uint16))

"""Collate, sampling, the threaded loader and the hand-off to the device
of the PyTorch/CUDA port (nicr_mtsa_tpu_torch.data), on the CPU:

- `mt_collate` and `RandomSamplerSubset` give the JAX package's
  batches and indices on the same inputs and seeds;
- `DataLoader`: worker threads give the serial batches in order,
  `drop_last` and `len`, a worker's exception reaches the consumer;
- `prefetch_to_device(device='cpu')`: the same batches in the same
  order (dict batches in the port's layout, other arrays as they are),
  window size 1, an empty iterator, size < 1 raises;
- `move_batch_to_device(device='cpu')`: the layout and dtypes of the
  synthetic batches' former converter (NCHW dense images, int32 maps,
  ids and tables), through nested `_down_<k>` dicts and ragged lists."""
import random
import threading

import numpy as np
import pytest
import torch

from nicr_mtsa_tpu.data import (RandomSamplerSubset as JSampler,
                                mt_collate as j_collate)
from nicr_mtsa_tpu.data._types import (
    AppliedPreprocessingMeta as JMeta, CollateIgnoredDict as JIgnored)
from nicr_mtsa_tpu_torch.data import (
    AppliedPreprocessingMeta, CollateIgnoredDict, DataLoader,
    RandomSamplerSubset, move_batch_to_device, mt_collate,
    prefetch_to_device)
from nicr_mtsa_tpu_torch.testing import train_arrays


def _samples(ignored, meta, n=3, ragged=True):
    rng = np.random.default_rng(0)
    out = []
    for i in range(n):
        s = {'rgb': rng.integers(0, 255, (4, 5, 3)).astype(np.uint8),
             'scene': i, 'weight': 0.5 * i, 'flag': bool(i % 2),
             'identifier': ('valid', f'{i:04d}'),
             'ids': ignored({i: float(i)}),
             '_applied_preprocessing': meta([{'type': 'Resize'}]),
             '_down_4': {'semantic': np.full((2, 2), i, np.uint8)}}
        if ragged:
            s['lut'] = np.ones((i + 1, 2), np.float32)
        out.append(s)
    return out


def _same_tree(a, b):
    assert type(a) is type(b) or (isinstance(a, dict)
                                  and isinstance(b, dict)), (a, b)
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _same_tree(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_tree(x, y)
    else:
        assert a == b


def test_mt_collate_matches_jax():
    got = mt_collate(_samples(CollateIgnoredDict, AppliedPreprocessingMeta))
    want = j_collate(_samples(JIgnored, JMeta))
    assert got['rgb'].shape == (3, 4, 5, 3)
    assert isinstance(got['lut'], list) and isinstance(got['ids'], list)
    assert got['_down_4']['semantic'].shape == (3, 2, 2)
    # blacklisted types stay per-sample lists
    assert [dict(x) for x in got['ids']] == [dict(x) for x in want['ids']]
    assert got['_applied_preprocessing'] == want['_applied_preprocessing']
    assert set(got) == set(want)
    for k in set(want) - {'ids', '_applied_preprocessing'}:
        _same_tree(got[k], want[k])
    # equal shapes stack
    same = mt_collate(_samples(CollateIgnoredDict, AppliedPreprocessingMeta,
                               ragged=False))
    assert 'lut' not in same and same['scene'].tolist() == [0, 1, 2]


class _Concat:
    def __init__(self, sizes):
        self.datasets = [list(range(n)) for n in sizes]

    def __len__(self):
        return sum(len(d) for d in self.datasets)


@pytest.mark.parametrize('subset,deterministic', [(0.5, True), (1.0, False),
                                                  ((0.5, 0.25), True),
                                                  ((1.0, 0.5), False)])
def test_random_sampler_subset_matches_jax(subset, deterministic):
    source = _Concat((10, 8)) if isinstance(subset, tuple) else list(
        range(17))
    got_s = RandomSamplerSubset(source, subset, deterministic)
    want_s = JSampler(source, subset, deterministic)
    assert len(got_s) == len(want_s)
    for seed in (0, 1):
        np.random.seed(seed)
        random.seed(seed)
        got = list(got_s)
        np.random.seed(seed)
        random.seed(seed)
        assert got == list(want_s)
    assert len(got) == len(got_s) and len(set(got)) == len(got)


class _Dataset:
    def __init__(self, n, fail_at=None):
        self.n, self.fail_at = n, fail_at

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == self.fail_at:
            raise KeyError(f'sample {i} is broken')
        return {'x': np.full((2, 3), i, np.int64), 'i': i}


def test_loader_workers_equal_serial_and_drop_last():
    ds = _Dataset(11)
    serial = list(DataLoader(ds, batch_size=3, num_workers=0))
    threaded = list(DataLoader(ds, batch_size=3, num_workers=3,
                               prefetch_batches=1))
    assert len(serial) == len(threaded) == 4 \
        == len(DataLoader(ds, batch_size=3))
    for a, b in zip(serial, threaded):
        _same_tree(a, b)
    assert [b['i'].tolist() for b in threaded][-1] == [9, 10]
    dropped = list(DataLoader(ds, batch_size=3, num_workers=2,
                              drop_last=True))
    assert len(dropped) == 3 == len(DataLoader(ds, batch_size=3,
                                               drop_last=True))
    sampled = list(DataLoader(ds, batch_size=4, sampler=[5, 1, 7, 3, 2],
                              num_workers=2))
    assert [b['i'].tolist() for b in sampled] == [[5, 1, 7, 3], [2]]
    on_cpu = list(DataLoader(ds, batch_size=4, num_workers=2,
                             to_device=True, device='cpu'))
    assert on_cpu[0]['x'].dtype == torch.int32
    assert on_cpu[2]['x'].shape == (3, 2, 3)


def test_loader_passes_worker_errors_and_stops():
    before = threading.active_count()
    with pytest.raises(KeyError, match='sample 5'):
        for _ in DataLoader(_Dataset(12, fail_at=5), batch_size=2,
                            num_workers=2):
            pass
    with pytest.raises(KeyError, match='sample 0'):
        list(DataLoader(_Dataset(4, fail_at=0), batch_size=2,
                        num_workers=0))
    # a consumer that leaves early: the producer thread ends
    it = iter(DataLoader(_Dataset(40), batch_size=1, num_workers=2,
                         prefetch_batches=1))
    next(it)
    it.close()
    assert threading.active_count() <= before + 1


def _host_batches(n):
    rng = np.random.default_rng(3)
    out = []
    for i in range(n):
        frames = (rng.integers(0, 255, (2, 6, 8, 3), dtype=np.uint8),
                  rng.integers(0, 2 ** 14, (2, 6, 8), dtype=np.uint16))
        batch = {'rgb': rng.normal(size=(2, 6, 8, 3)).astype(np.float32),
                 'semantic': rng.integers(0, 9, (2, 6, 8)).astype(np.uint8),
                 'table': np.arange(4, dtype=np.int64) + i,
                 'lut': [np.ones((j + 1, 2), np.float32) for j in range(2)],
                 '_down_4': {'instance': np.full((2, 1, 2), i, np.uint16)},
                 'meta': [[{'type': 'Resize'}]] * 2}
        out.append((frames, batch))
    return out


@pytest.mark.parametrize('size', [1, 2, 3])
def test_prefetch_on_cpu_keeps_order_and_values(size):
    host = _host_batches(5)
    got = list(prefetch_to_device(iter(host), size=size, device='cpu'))
    assert len(got) == 5
    for (frames, batch), (g_frames, g_batch) in zip(host, got):
        assert isinstance(g_frames, tuple)
        # arrays outside a dict keep their layout and dtype
        assert g_frames[0].dtype == torch.uint8 \
            and g_frames[0].shape == (2, 6, 8, 3)
        assert g_frames[1].dtype == torch.uint16
        np.testing.assert_array_equal(g_frames[0].numpy(), frames[0])
        np.testing.assert_array_equal(
            g_frames[1].view(torch.int16).numpy().view(np.uint16),
            frames[1])
        # dict batches: the port's layout, as move_batch_to_device
        want = move_batch_to_device(batch, 'cpu')
        for k in ('rgb', 'semantic', 'table'):
            assert g_batch[k].dtype == want[k].dtype
            assert torch.equal(g_batch[k], want[k]), k
        assert torch.equal(g_batch['_down_4']['instance'],
                           want['_down_4']['instance'])
        assert all(torch.equal(a, b) for a, b in zip(g_batch['lut'],
                                                     want['lut']))
        assert g_batch['meta'] == batch['meta']


def test_prefetch_empty_and_bad_size():
    assert list(prefetch_to_device(iter([]), size=2, device='cpu')) == []
    with pytest.raises(ValueError, match='>= 1'):
        list(prefetch_to_device(iter(_host_batches(1)), size=0,
                                device='cpu'))


def _former_layout(a: np.ndarray) -> torch.Tensor:
    """The synthetic batches' converter before the port had a data path
    (testing/batch.py `_to_device`)."""
    if a.ndim == 4:
        a = a.transpose(0, 3, 1, 2)
    if a.dtype in (np.uint8, np.uint16, np.uint32, np.int64):
        a = a.astype(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a))


def test_move_batch_to_device_layout():
    arrays = train_arrays(2, 8, 12, rgbd=False)
    arrays['panoptic_segment_table_fullres'] = np.arange(6, dtype=np.int64)
    arrays['semantic_fullres'] = arrays['semantic'].astype(np.uint8)
    arrays['panoptic'] = arrays['semantic'].astype(np.uint32)
    batch = dict(arrays, _down_8={'instance': np.ones((2, 1, 1), np.int64)},
                 lut=[np.zeros((3, 4), np.uint16), 'x'],
                 _applied_preprocessing=[[{'type': 'Resize'}]],
                 ids=CollateIgnoredDict({1: 2}))
    got = move_batch_to_device(batch, device='cpu')
    for k, a in arrays.items():
        want = _former_layout(a)
        assert got[k].dtype == want.dtype and got[k].is_contiguous(), k
        assert torch.equal(got[k], want), k
    assert got['rgb'].shape == (2, 3, 8, 12)
    assert got['_down_8']['instance'].dtype == torch.int32
    assert got['lut'][0].dtype == torch.int32 and got['lut'][1] == 'x'
    assert got['ids'] is batch['ids']
    assert got['_applied_preprocessing'] == batch['_applied_preprocessing']
    kept = move_batch_to_device(batch, device='cpu', keys_to_ignore=('rgb',))
    assert kept['rgb'] is arrays['rgb']
    with pytest.raises(TypeError):
        move_batch_to_device([arrays], device='cpu')


def _same_structure(a, b, where='batch'):
    """a and b hold the same containers of the same types, equal tensors
    (dtype, shape, values) where they hold tensors, and the same objects
    where they pass one through."""
    assert type(a) is type(b), where
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), where
    elif isinstance(a, dict):
        assert list(a) == list(b), where
        for k in a:
            _same_structure(a[k], b[k], f'{where}[{k!r}]')
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same_structure(x, y, f'{where}[{i}]')
    else:
        assert a is b, where


def test_prefetch_and_move_walk_one_batch_alike():
    """prefetch_to_device and move_batch_to_device walk a batch with the
    same walker: the same containers of the same types (provenance
    lists, namedtuples, nested ragged lists), the same leaves; keys to
    ignore stay as they are at any depth."""
    import collections
    from nicr_mtsa_tpu_torch.data._types import (AppliedPreprocessingMeta,
                                                 PreprocessingParameterDict)
    from nicr_mtsa_tpu_torch.data._utils import map_leaves
    Pair = collections.namedtuple('Pair', 'a b')
    rng = np.random.default_rng(3)
    meta = AppliedPreprocessingMeta([PreprocessingParameterDict(
        type='Resize', shape=np.array([4, 6]))])
    batch = {'rgb': rng.normal(size=(2, 4, 6, 3)).astype(np.float32),
             '_applied_preprocessing': [meta, meta],
             'pair': Pair(np.arange(3, dtype=np.uint16), 'x'),
             'nested': [[np.ones((2, 2), np.int64)], (np.zeros(2, np.uint8),)],
             '_down_4': {'semantic': np.ones((2, 1, 2), np.uint8),
                         'keep': np.ones(2, np.uint8)}}
    want = move_batch_to_device(batch, 'cpu')
    (got,) = prefetch_to_device(iter([batch]), size=1, device='cpu')
    _same_structure(got, want)
    assert type(got['_applied_preprocessing'][0]) is AppliedPreprocessingMeta
    assert got['_applied_preprocessing'][0][0] is meta[0]
    assert got['pair'].a.dtype == torch.int32
    assert got['nested'][0][0].dtype == torch.int32
    assert got['nested'][1][0].dtype == torch.int32
    kept = move_batch_to_device(batch, 'cpu', keys_to_ignore=('keep',))
    assert kept['_down_4']['keep'] is batch['_down_4']['keep']
    assert kept['_down_4']['semantic'].dtype == torch.int32
    seen = []
    map_leaves(batch, lambda a, in_dict: seen.append((a.shape, in_dict)))
    assert seen == [((2, 4, 6, 3), True), ((3,), True), ((2, 2), True),
                    ((2,), True), ((2, 1, 2), True), ((2,), True)]
    assert map_leaves((np.ones(2, np.uint8),), lambda a, d: d) == (False,)

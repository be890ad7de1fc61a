"""The training half of the host data path in the PyTorch/CUDA port
against the JAX package, on the CPU: the augmentations, `RandomResize`,
the example's whole training preprocessing, the synthetic dataset and
the loader's per-sample generators.

- Each transform on `get_dummy_sample()` runs in the JAX package after
  `np.random.seed(s)` and in the port with `RandomState(s)`: outputs,
  orientations and the applied-preprocessing meta bit-equal, several
  seeds (flipped and not, crops with and without the upscale).
- `RandomHorizontalFlip` after `OrientationTargetGenerator` raises in
  both; a transform called without a generator raises in the port.
- The example's training chain (examples/train_synthetic.py:71-90) on
  the synthetic dataset: every entry bit-equal up to `NormalizeRGB`,
  the normalised rgb within rtol 1e-6 (the port's native library
  multiplies by 1 / std); the port's dummy sample and dataset give the
  JAX package's pixels for the same index.
- The loader with a seed: each sample's augmentation from
  `RandomState([seed, pass, index])`, so the batches do not depend on
  the number of worker threads, and a second pass draws anew."""
import numpy as np
import pytest

from nicr_mtsa_tpu.data import preprocessing as jpre
from nicr_mtsa_tpu.data.preprocessing import augmentation as jaug
from nicr_mtsa_tpu.data.preprocessing.resize import RandomResize as JResize
from nicr_mtsa_tpu.testing import get_dummy_sample as j_dummy
from nicr_mtsa_tpu.testing.dataset import SyntheticRGBDDataset as JDataset
from nicr_mtsa_tpu_torch.data import DataLoader, mt_collate
from nicr_mtsa_tpu_torch.data import preprocessing as pre
from nicr_mtsa_tpu_torch.examples.train_synthetic import train_preprocessing
from nicr_mtsa_tpu_torch.testing import SyntheticRGBDDataset, get_dummy_sample
from _torch_data_helpers import jax_native_loaded  # noqa: F401
from _torch_loop_helpers import IS_THING, _same, train_compose

SEEDS = (0, 1, 2, 3)
TRANSFORMS = {
    'flip': (jaug.RandomHorizontalFlip, pre.RandomHorizontalFlip, (0.5,)),
    'crop': (jaug.RandomCrop, pre.RandomCrop, (300, 400)),
    'crop_upscaled': (jaug.RandomCrop, pre.RandomCrop, (600, 512)),
    'hsv': (jaug.RandomHSVJitter, pre.RandomHSVJitter, (0.05, 0.1, 0.1)),
    'resize': (JResize, pre.RandomResize, (0.5, 1.5)),
    'resize_fixed': (JResize, pre.RandomResize, (0.75, 0.75)),
}


@pytest.mark.parametrize('name', sorted(TRANSFORMS))
def test_augmentation_matches_jax(name):
    jcls, tcls, args = TRANSFORMS[name]
    metas = []
    for s in SEEDS:
        np.random.seed(s)
        want = jcls(*args)(j_dummy())
        got = tcls(*args)(get_dummy_sample(), rng=np.random.RandomState(s))
        _same(got, want)
        metas.append(got[pre.APPLIED_PREPROCESSING_KEY][-1])
    if name == 'flip':
        assert {m['was_flipped'] for m in metas} == {True, False}
        flipped = next(i for i, m in enumerate(metas) if m['was_flipped'])
        np.random.seed(SEEDS[flipped])
        ori = jcls(*args)(j_dummy())['orientations']
        assert ori[1] == pytest.approx(2 * np.pi - np.deg2rad(45))
    if name == 'crop_upscaled':
        assert all(m['was_resized'] for m in metas)
        assert metas[0]['resize_height'] == int(512 * 600 / 512 + 0.5)


def test_flip_after_orientation_generator_raises_in_both():
    from nicr_mtsa_tpu.data import preprocessing as jpre
    for p, dummy, kwargs in ((pre, get_dummy_sample,
                              {'rng': np.random.RandomState(0)}),
                             (jpre, j_dummy, {})):
        sample = p.OrientationTargetGenerator(
            semantic_classes_estimate_orientation=IS_THING)(dummy())
        with pytest.raises(RuntimeError, match='OrientationTargetGenerator'):
            p.RandomHorizontalFlip(0.5)(sample, **kwargs)


def test_augmentation_without_generator_raises():
    for t in (pre.RandomHorizontalFlip(0.5), pre.RandomCrop(100, 100),
              pre.RandomHSVJitter(0.1, 0.1, 0.1), pre.RandomResize(0.5, 1)):
        with pytest.raises(TypeError, match='RandomState'):
            t(get_dummy_sample())
        with pytest.raises(TypeError, match='RandomState'):
            t(get_dummy_sample(), rng=np.random.default_rng(0))


def test_dummy_sample_and_dataset_pixels_match_jax():
    _same(get_dummy_sample(), j_dummy())
    tds = SyntheticRGBDDataset(n_samples=3, height=60, width=80)
    jds = JDataset(n_samples=3, height=60, width=80)
    for i in range(3):
        _same(tds[i], jds[i])


def test_train_chain_matches_jax_before_and_after_normalisation():
    tds = SyntheticRGBDDataset(n_samples=3, height=192, width=256)
    jds = JDataset(n_samples=3, height=192, width=256)
    full, jfull = train_preprocessing(96, 128), train_compose(jpre, 96, 128)
    names = [type(t).__name__ for t in full.transforms]
    cut = names.index('NormalizeRGB')
    head = pre.Compose(full.transforms[:cut])
    jhead = jpre.Compose(jfull.transforms[:cut])
    for i in range(3):
        np.random.seed(10 + i)
        want = jhead(jds[i])
        got = head(tds[i], rng=np.random.RandomState(10 + i))
        assert got['rgb'].dtype == np.uint8
        _same(got, want)
        np.random.seed(10 + i)
        want = jfull(jds[i])
        got = full(tds[i], rng=np.random.RandomState(10 + i))
        _same(got, want)


def _loader_batches(num_workers, n_passes=1):
    ds = SyntheticRGBDDataset(n_samples=4, height=48, width=64,
                              preprocessor=pre.Compose([
                                  pre.RandomHSVJitter(0.05, 0.1, 0.1),
                                  pre.RandomHorizontalFlip(0.5)]))
    loader = DataLoader(ds, batch_size=2, num_workers=num_workers,
                        collate_fn=mt_collate, seed=7)
    return ds, [list(loader) for _ in range(n_passes)]


def test_loader_draws_each_sample_from_its_own_generator():
    ds, (first, second) = _loader_batches(num_workers=0, n_passes=2)
    _, (threaded,) = _loader_batches(num_workers=3)
    for a, b in zip(first, threaded):
        _same(a, b)
    # the sample's generator is RandomState([seed, pass, index])
    for p, batches in enumerate((first, second)):
        for b, batch in enumerate(batches):
            for j in range(2):
                i = 2 * b + j
                want = ds.load(i, np.random.RandomState([7, p, i]))
                np.testing.assert_array_equal(batch['rgb'][j], want['rgb'])
    assert any(not np.array_equal(a['rgb'], b['rgb'])
               for a, b in zip(first, second))

"""The synthetic RGB-D dataset and its loader (own copy of
nicr_mtsa_tpu/testing/dataset.py): deterministic samples by index,
with semantic and instance annotations, orientations and a scene
class; the same pixels for the same index as the JAX package's
`SyntheticRGBDDataset`."""
from typing import Callable, Optional, Sequence, Tuple

import numpy as np

from ..data._collate import RandomSamplerSubset, mt_collate
from ..data._types import OrientationDict
from ..data.loader import DataLoader
from .preprocessing import get_dummy_sample


class SyntheticRGBDDataset:
    """Sample `idx` is drawn from `default_rng(1000 + idx)` at (height,
    width): random RGB and depth, 1-5 rectangular thing instances with
    an orientation each on a stuff background (class 4), a scene class
    in [1, n_scenes]. `load(idx, rng)` runs the preprocessor with the
    augmentations' generator (the loader's, by sample)."""

    def __init__(self, n_samples: int = 16, height: int = 480,
                 width: int = 640, n_classes_with_void: int = 11,
                 thing_class_ids: Tuple[int, ...] = (1, 2, 3),
                 n_scenes: int = 5, preprocessor: Optional[Callable] = None,
                 sample_keys: Optional[Sequence[str]] = None) -> None:
        self._n = n_samples
        self._h, self._w = height, width
        self._n_classes = n_classes_with_void
        self._things = thing_class_ids
        self._n_scenes = n_scenes
        self.preprocessor = preprocessor
        self._sample_keys = sample_keys

    def __len__(self) -> int:
        return self._n

    def raw(self, idx: int) -> dict:
        """Sample `idx` before preprocessing."""
        rng = np.random.default_rng(1000 + idx)
        h, w = self._h, self._w
        sample = get_dummy_sample()
        semantic = np.full((h, w), 4, dtype='uint16')
        instance = np.zeros((h, w), dtype='uint16')
        orientations = OrientationDict()
        for i in range(1, int(rng.integers(2, 7))):
            bh = int(rng.integers(h // 8, h // 3))
            bw = int(rng.integers(w // 8, w // 3))
            y = int(rng.integers(0, h - bh))
            x = int(rng.integers(0, w - bw))
            semantic[y:y + bh, x:x + bw] = int(rng.choice(self._things))
            instance[y:y + bh, x:x + bw] = i
            orientations[i] = float(rng.uniform(0, 2 * np.pi))
        sample.update({
            'rgb': rng.integers(0, 255, (h, w, 3), dtype=np.uint8),
            'depth': rng.integers(1, 2 ** 14, (h, w), dtype=np.uint16),
            'semantic': semantic,
            'instance': instance,
            'orientations': orientations,
            'scene': int(rng.integers(1, self._n_scenes + 1)),
        })
        if self._sample_keys is not None:
            sample = {k: v for k, v in sample.items()
                      if k in self._sample_keys or k.startswith('_')}
        return sample

    def load(self, idx: int, rng: Optional[np.random.RandomState] = None
             ) -> dict:
        sample = self.raw(idx)
        if self.preprocessor is not None:
            kwargs = {} if rng is None else {'rng': rng}
            sample = self.preprocessor(sample, **kwargs)
        return sample

    def __getitem__(self, idx: int) -> dict:
        return self.load(idx)


def get_dataset(preprocessor=None, n_samples: int = 16, height: int = 480,
                width: int = 640, **kwargs) -> SyntheticRGBDDataset:
    return SyntheticRGBDDataset(n_samples=n_samples, height=height,
                                width=width, preprocessor=preprocessor,
                                **kwargs)


def get_dataloader(dataset, batch_size: int = 4, subset=None,
                   deterministic: bool = True, num_workers: int = 2,
                   **kwargs) -> DataLoader:
    sampler = None
    if subset is not None:
        sampler = RandomSamplerSubset(dataset, subset=subset,
                                      deterministic=deterministic)
    return DataLoader(dataset, batch_size=batch_size, sampler=sampler,
                      num_workers=num_workers, collate_fn=mt_collate,
                      **kwargs)

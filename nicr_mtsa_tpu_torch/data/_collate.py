"""Batch collation and subset sampling (own copy of
nicr_mtsa_tpu/data/_collate.py): dict-of-sample -> dict-of-batch with

- blacklisted types (`CollateIgnoredDict`, `AppliedPreprocessingMeta`
  and `type_blacklist`) kept as per-sample lists,
- ragged arrays (differing shapes) and ragged key sets kept as lists,
- equal-shape numpy arrays stacked along a new leading batch axis,
- python and numpy scalars stacked into numpy arrays,
- anything else (strings, slices, None, tuples) kept as a list.

Batches stay numpy on the host; `move_batch_to_device` and the feeder
turn them into tensors. `RandomSamplerSubset` draws with numpy and
`random` as the JAX package does, so the same seeds give the same
indices."""
import random
from typing import Any, Iterator, List, Sequence, Sized, Tuple, Type, Union

import numpy as np

from ._types import AppliedPreprocessingMeta, CollateIgnoredDict

_DEFAULT_BLACKLIST = (CollateIgnoredDict, AppliedPreprocessingMeta)


def collate(data: List[Any], type_blacklist: Tuple[Type, ...] = (),
            default_type_blacklist: Tuple[Type, ...] = _DEFAULT_BLACKLIST,
            ) -> Any:
    elem = data[0]
    if isinstance(elem, type_blacklist + default_type_blacklist):
        return data
    if isinstance(elem, np.ndarray):
        if not all(a.shape == elem.shape for a in data):
            return data
        return np.stack(data)
    if isinstance(elem, dict):
        if any(set(s.keys()) != set(elem.keys()) for s in data):
            return data
        return {k: collate([s[k] for s in data], type_blacklist)
                for k in elem}
    if isinstance(elem, (int, float, bool, np.generic)):
        return np.asarray(data)
    return data


def mt_collate(data: List[Any], type_blacklist: Tuple[Type, ...] = ()) -> Any:
    return collate(data, type_blacklist=type_blacklist)


class RandomSamplerSubset:
    """Random sampling of a fraction of a dataset (optionally per
    sub-dataset of a concatenated dataset). `deterministic=True` seeds
    the permutation with 0, so every epoch visits the same subset (in
    shuffled order)."""

    def __init__(self, data_source: Sized,
                 subset: Union[float, Sequence[float]] = 1.0,
                 deterministic: bool = False) -> None:
        if isinstance(subset, (list, tuple)):
            if not hasattr(data_source, 'datasets') \
                    or len(subset) != len(data_source.datasets):
                raise ValueError('per-subset fractions need a concatenated '
                                 'dataset with one fraction a dataset')
        self._data_source = data_source
        self.subset = subset
        self.deterministic = deterministic

    def _spans(self) -> List[Tuple[int, int, float]]:
        """(start, length, fraction) of each underlying dataset."""
        if not isinstance(self.subset, (list, tuple)):
            return [(0, len(self._data_source), float(self.subset))]
        spans, start = [], 0
        for ds, frac in zip(self._data_source.datasets, self.subset):
            spans.append((start, len(ds), float(frac)))
            start += len(ds)
        return spans

    def __iter__(self) -> Iterator[int]:
        seed = 0 if self.deterministic else np.random.randint(0, 2 ** 63 - 1)
        rng = np.random.default_rng(seed)
        indices: List[int] = []
        for start, length, frac in self._spans():
            chosen = rng.permutation(length)[:int(length * frac)] + start
            indices.extend(chosen.tolist())
        random.shuffle(indices)
        return iter(indices)

    def __len__(self) -> int:
        return sum(int(length * frac) for _, length, frac in self._spans())

"""Sample-entry snapshots (own copy of
nicr_mtsa_tpu/data/preprocessing/clone.py): copy chosen entries before
later steps change them. ``CloneEntries`` puts the copies into one
nested dict (skipped by the multiscale fan-out and kept per sample by
the collate function); ``FlatCloneEntries`` puts each copy back at the
top level under a renamed key (the ``*_fullres`` keys)."""
from copy import deepcopy

from .base import PreprocessingBase

DEFAULT_CLONE_KEY = '_no_preprocessing'


def clone_entries(sample, keys_to_clone, ignore_missing_keys=False):
    """Deep copies of the `keys_to_clone` entries; an unknown key raises
    KeyError unless `ignore_missing_keys`, which drops it."""
    wanted = list(keys_to_clone)
    if ignore_missing_keys:
        wanted = [k for k in wanted if k in sample]
    return {k: deepcopy(sample[k]) for k in wanted}


class CloneEntries(PreprocessingBase):
    """Copies of entries in ONE nested dict at ``clone_key``."""

    def __init__(self, keys_to_clone=None, ignore_missing_keys=False,
                 clone_key=DEFAULT_CLONE_KEY):
        self._keys_to_clone = keys_to_clone
        self._ignore_missing_keys = ignore_missing_keys
        self._clone_key = clone_key
        super().__init__(
            fixed_parameters={'clone_key': clone_key,
                              'ignore_missing_keys': ignore_missing_keys},
            multiscale_processing=False)

    @property
    def clone_key(self):
        return self._clone_key

    def _preprocess(self, sample, **kwargs):
        wanted = tuple(self._keys_to_clone or sample.keys())
        sample[self._clone_key] = clone_entries(sample, wanted,
                                                self._ignore_missing_keys)
        return sample, {'cloned_keys': wanted}


class FlatCloneEntries(PreprocessingBase):
    """Copies of entries at the top level as ``<prefix><key><suffix>``."""

    def __init__(self, keys_to_clone=None, ignore_missing_keys=False,
                 key_prefix=None, key_suffix=None):
        if not key_prefix and not key_suffix:
            raise ValueError('FlatCloneEntries needs a prefix or a suffix: '
                             'the copies would overwrite their originals')
        self._keys_to_clone = keys_to_clone
        self._ignore_missing_keys = ignore_missing_keys
        self._fmt = (key_prefix or '') + '{}' + (key_suffix or '')
        super().__init__(
            fixed_parameters={'key_prefix': key_prefix or '',
                              'key_suffix': key_suffix or '',
                              'ignore_missing_keys': ignore_missing_keys},
            multiscale_processing=False)

    def _preprocess(self, sample, **kwargs):
        wanted = tuple(self._keys_to_clone or sample.keys())
        renamed = {self._fmt.format(k): v for k, v in clone_entries(
            sample, wanted, self._ignore_missing_keys).items()}
        sample.update(renamed)
        return sample, {'added_keys': list(renamed)}

"""Preprocessor base: dispatch, multiscale fan-out, provenance (own copy
of nicr_mtsa_tpu/data/preprocessing/base.py).

- ``__call__(sample)`` runs ``_preprocess`` on the sample, then (with
  ``multiscale_processing``) on every nested ``_down_<k>`` sub-sample
  with ``downscale=k``, and appends one provenance record (fixed and
  dynamic parameters) to the sample's ``_applied_preprocessing`` list.
- The provenance is read downstream: postprocessing crops the valid
  region that the Resize record names before the full-resolution
  resize.

Preprocessors run on the host, on numpy arrays, one sample at a time
(in the loader's worker threads)."""
import abc
from typing import Any, Dict, Iterator, Optional, Tuple

from .._types import AppliedPreprocessingMeta, PreprocessingParameterDict
from ..fullres import APPLIED_PREPROCESSING_KEY

MULTI_DOWNSCALE_KEY_FMT = '_down_{}'

_DOWNSCALE_PREFIX = MULTI_DOWNSCALE_KEY_FMT.format('')


def _downscale_of(key: str) -> Optional[int]:
    """Downscale factor k of a '_down_<k>' key, else None."""
    if not isinstance(key, str) or not key.startswith(_DOWNSCALE_PREFIX):
        return None
    tail = key[len(_DOWNSCALE_PREFIX):]
    return int(tail) if tail.isdigit() else None


def _iter_downscale_keys(sample: dict) -> Iterator[Tuple[str, int]]:
    for key in list(sample):
        k = _downscale_of(key)
        if k is not None:
            yield key, k


def get_applied_preprocessing_meta(sample: dict) -> AppliedPreprocessingMeta:
    """Provenance list of the sample, created on first access."""
    return sample.setdefault(APPLIED_PREPROCESSING_KEY,
                             AppliedPreprocessingMeta())


def add_to_applied_preprocessing_meta(sample: dict, **parameters: Any
                                      ) -> dict:
    get_applied_preprocessing_meta(sample).append(
        PreprocessingParameterDict(**parameters))
    return sample


class PreprocessingBase(abc.ABC):
    """One preprocessing step over the mutable sample dict."""

    def __init__(self, fixed_parameters: Optional[Dict[str, Any]] = None,
                 multiscale_processing: bool = False) -> None:
        self._multiscale_processing = multiscale_processing
        self._fixed_parameters = dict(
            type=type(self).__name__,
            multiscale_processing=multiscale_processing,
            **(fixed_parameters or {}))

    @property
    def fixed_parameters(self) -> Dict[str, Any]:
        return self._fixed_parameters

    @abc.abstractmethod
    def _preprocess(self, sample: dict, **kwargs
                    ) -> Tuple[dict, Dict[str, Any]]:
        ...

    def __repr__(self) -> str:
        inner = ', '.join(f'{k}: {v}'
                          for k, v in self.fixed_parameters.items())
        return f'{type(self).__name__}({inner})'

    def __call__(self, sample: dict, **kwargs) -> dict:
        sample, dynamic = self._preprocess(sample, **kwargs)
        per_scale: Dict[str, Any] = {}
        if self._multiscale_processing:
            for key, factor in _iter_downscale_keys(sample):
                sample[key], per_scale[key] = self._preprocess(
                    sample[key], downscale=factor, **kwargs)
        return add_to_applied_preprocessing_meta(
            sample, **self.fixed_parameters, **dynamic, **per_scale)


class Compose:
    """Sequential composition of preprocessors."""

    def __init__(self, transforms) -> None:
        self.transforms = list(transforms)

    def __call__(self, sample: dict) -> dict:
        for t in self.transforms:
            sample = t(sample)
        return sample

    def __repr__(self) -> str:
        return f"Compose([{', '.join(repr(t) for t in self.transforms)}])"

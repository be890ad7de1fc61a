"""Batch utilities (counterpart of nicr_mtsa_tpu/data/_utils.py).

`move_batch_to_device` turns a collated host batch into the port's
batch: every numpy leaf (through nested `_down_<k>` dicts and ragged
lists) becomes a tensor on the device, in the port's layout
(`to_port_layout`): 4-D arrays (B, H, W, C) go NCHW, and uint8, uint16,
uint32 and int64 maps, ids and tables become int32. Other entries
(provenance meta, strings, slices, per-sample dicts) pass through.
`map_leaves` is the walk over a batch that it shares with the
prefetcher (`feeder.py`)."""
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from ..utils.device import resolve_device
from ._types import CollateIgnoredDict

_TO_INT32 = (np.uint8, np.uint16, np.uint32, np.int64)


def infer_batch_size(batch: dict, key: Optional[str] = None) -> int:
    probe = batch[key] if key is not None \
        else batch.get('rgb', batch.get('depth', None))
    return probe.shape[0]


def transferable(value) -> bool:
    return isinstance(value, np.ndarray) and value.dtype != object


def map_leaves(tree, fn: Callable[[np.ndarray, bool], Any],
               skip: frozenset = frozenset(), in_dict: bool = False) -> Any:
    """`tree` with each numpy leaf `a` replaced by `fn(a, in_dict)`, where
    `in_dict` says whether the leaf lies inside a dict. It walks dicts
    (not the per-sample `CollateIgnoredDict`s; their keys in `skip` are
    kept as they are), lists and tuples, and rebuilds each with its own
    type; leaves visit in a fixed order."""
    if transferable(tree):
        return fn(tree, in_dict)
    if isinstance(tree, dict) and not isinstance(tree, CollateIgnoredDict):
        return {k: v if k in skip else map_leaves(v, fn, skip, True)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return type(tree)(map_leaves(v, fn, skip, in_dict) for v in tree)
    if isinstance(tree, tuple):
        items = [map_leaves(v, fn, skip, in_dict) for v in tree]
        return type(tree)(*items) if hasattr(tree, '_fields') \
            else type(tree)(items)
    return tree


def port_layout(a: np.ndarray):
    """(view, dtype) of one batch array in the port's layout: dense
    images (B, H, W, C) as an NCHW view, maps, ids and tables to become
    int32, other dtypes kept."""
    if a.ndim == 4:                              # (B, H, W, C) -> NCHW
        a = a.transpose(0, 3, 1, 2)
    return a, (np.dtype(np.int32) if a.dtype in _TO_INT32 else a.dtype)


def to_port_layout(a: np.ndarray) -> np.ndarray:
    """One batch array in the port's layout (a view where nothing
    changes)."""
    view, dtype = port_layout(a)
    return view if view.dtype == dtype else view.astype(dtype)


def to_tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """One port-layout array on `device`: on the card through pinned
    memory with a non-blocking copy (the caching host allocator keeps
    the pinned block until the copy has run)."""
    t = torch.from_numpy(np.ascontiguousarray(to_port_layout(a)))
    if device.type == 'cuda':
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def move_batch_to_device(batch: dict, device=None,
                         keys_to_ignore: Optional[Sequence[str]] = None
                         ) -> dict:
    """The host batch on `device` (default `cuda`) in the port's layout;
    `keys_to_ignore`, at any depth, stay as they are."""
    if not isinstance(batch, dict):
        raise TypeError(f'move_batch_to_device takes a dict batch, got '
                        f'{type(batch).__name__}')
    device = resolve_device(device)
    return map_leaves(batch, lambda a, _: to_tensor(a, device),
                      frozenset(keys_to_ignore or ()))

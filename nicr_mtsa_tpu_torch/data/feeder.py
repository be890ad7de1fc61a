"""Host -> device prefetcher on one card (counterpart of
nicr_mtsa_tpu/data/feeder.py `prefetch_to_device`).

`prefetch_to_device` keeps up to `size` batches in flight ahead of the
consumer. On the card each batch goes through a ring of `size + 1`
pinned staging slots, reused from batch to batch (a slot's buffers
grow only when a batch needs more bytes):

- the host copies the batch's arrays into its slot (dict batches, the
  collated samples, in the port's layout, as `move_batch_to_device`
  puts them; arrays outside a dict, such as the serving path's uint8
  frames, as they are);
- a dedicated copy stream copies the slot to new device tensors and
  records the slot's event;
- a slot is refilled only after its event has completed (the host
  waits on it), so no copy can read a slot that is being overwritten;
- when the consumer takes the batch, its current stream waits on the
  event, and every device tensor is recorded on that stream, so the
  caching allocator cannot hand the memory out again while the copy
  stream still owns it.

With `device='cpu'` it yields the same batches, as CPU tensors, in the
same order, without streams or staging."""
import collections
from typing import Any, Iterable, Iterator, List

import numpy as np
import torch

from ..utils.device import resolve_device
from ._utils import map_leaves, port_layout, to_tensor


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


class _Slot:
    """One staging slot: pinned byte buffers by leaf position, and the
    event recorded after the copies out of them."""

    def __init__(self) -> None:
        self.buffers: List[torch.Tensor] = []
        self.event = None

    def buffer(self, j: int, n_bytes: int) -> torch.Tensor:
        while len(self.buffers) <= j:
            self.buffers.append(torch.empty(0, dtype=torch.uint8))
        if self.buffers[j].numel() < n_bytes:
            self.buffers[j] = torch.empty(n_bytes, dtype=torch.uint8,
                                          pin_memory=True)
        return self.buffers[j][:n_bytes]


class _Staged:
    __slots__ = ('tree', 'tensors', 'event')

    def __init__(self, tree, tensors, event) -> None:
        self.tree, self.tensors, self.event = tree, tensors, event


class _Feeder:
    def __init__(self, n_slots: int, device: torch.device) -> None:
        self.device = device
        self.copy_stream = torch.cuda.Stream(device)
        self.slots = [_Slot() for _ in range(n_slots)]
        self.count = 0

    def _acquire(self, slot: _Slot) -> None:
        """Wait until the copies out of `slot` have run."""
        if slot.event is not None:
            slot.event.synchronize()

    def stage(self, host_batch) -> _Staged:
        slot = self.slots[self.count % len(self.slots)]
        self.count += 1
        self._acquire(slot)
        tensors: List[torch.Tensor] = []

        def copy(a: np.ndarray, in_dict: bool) -> torch.Tensor:
            src, dtype = port_layout(a) if in_dict else (a, a.dtype)
            pinned = slot.buffer(len(tensors), src.size * dtype.itemsize)
            np.copyto(pinned.numpy().view(dtype).reshape(src.shape), src,
                      casting='unsafe')
            dev = torch.empty(pinned.numel(), dtype=torch.uint8,
                              device=self.device)
            dev.copy_(pinned, non_blocking=True)
            tensors.append(dev.view(_torch_dtype(dtype)).view(src.shape))
            return tensors[-1]

        with torch.cuda.stream(self.copy_stream):
            tree = map_leaves(host_batch, copy)
            slot.event = torch.cuda.Event()
            slot.event.record(self.copy_stream)
        return _Staged(tree, tensors, slot.event)

    def hand_over(self, staged: _Staged):
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(staged.event)
        for t in staged.tensors:
            t.record_stream(stream)
        return staged.tree


_CPU = torch.device('cpu')


def _on_cpu(host_batch):
    """The batch as CPU tensors: for a dict batch what
    `move_batch_to_device(batch, 'cpu')` gives; arrays outside a dict
    as they are."""
    return map_leaves(host_batch, lambda a, in_dict: to_tensor(a, _CPU)
                      if in_dict else torch.from_numpy(a.copy()))


def prefetch_to_device(iterator: Iterable[Any], size: int = 2,
                       device=None) -> Iterator[Any]:
    """Yield the batches of `iterator` (pytrees of numpy arrays: dicts,
    lists, tuples) as tensors on `device` (default `cuda`), with up to
    `size` batches' copies in flight ahead of the consumer."""
    if size < 1:
        raise ValueError(f'prefetch size must be >= 1, got {size}')
    device = resolve_device(device)
    if device.type != 'cuda':
        for host_batch in iterator:
            yield _on_cpu(host_batch)
        return
    feeder = _Feeder(size + 1, device)
    window: collections.deque = collections.deque()
    it = iter(iterator)

    def fill():
        while len(window) < size:
            try:
                host_batch = next(it)
            except StopIteration:
                return
            window.append(feeder.stage(host_batch))

    fill()
    while window:
        staged = window.popleft()
        fill()           # start the next copies before the consumer runs
        yield feeder.hand_over(staged)

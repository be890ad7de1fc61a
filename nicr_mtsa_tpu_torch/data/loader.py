"""Threaded data loader (counterpart of nicr_mtsa_tpu/data/loader.py):
map-style dataset + sampler -> samples (and their preprocessing, run
inside the dataset's `__getitem__`) in a thread pool -> collate ->
optionally `move_batch_to_device`. At most `num_workers` batches are in
the making and `prefetch_batches` wait in a queue, so that host work
overlaps the device's within a bounded memory. Batches come in sampler
order; an exception in a worker is raised in the consumer."""
import collections
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Optional, Sequence

from ._collate import mt_collate
from ._utils import move_batch_to_device


class DataLoader:
    def __init__(
        self,
        dataset: Sequence,
        batch_size: int = 1,
        sampler: Optional[Iterable[int]] = None,
        num_workers: int = 2,
        collate_fn: Callable = mt_collate,
        drop_last: bool = False,
        prefetch_batches: int = 2,
        to_device: bool = False,
        device=None,
    ) -> None:
        """`sampler`: the order of the samples (pass a shuffling one,
        such as `RandomSamplerSubset`, to shuffle), by default the
        dataset's; `to_device`: each batch ends in
        `move_batch_to_device(batch, device)` (default device `cuda`)."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler
        self.num_workers = max(0, num_workers)
        self.collate_fn = collate_fn
        self.drop_last = drop_last
        self.prefetch_batches = prefetch_batches
        self.to_device = to_device
        self.device = device

    def _indices(self):
        if self.sampler is not None:
            return list(iter(self.sampler))
        return list(range(len(self.dataset)))

    def _batches(self):
        indices = self._indices()
        for start in range(0, len(indices), self.batch_size):
            chunk = indices[start:start + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                return
            yield chunk

    def __len__(self):
        n = (len(self.sampler) if self.sampler is not None
             else len(self.dataset))
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _load_batch(self, chunk):
        batch = self.collate_fn([self.dataset[i] for i in chunk])
        if self.to_device:
            batch = move_batch_to_device(batch, self.device)
        return batch

    def __iter__(self):
        if self.num_workers == 0:
            for chunk in self._batches():
                yield self._load_batch(chunk)
            return

        out_q: 'queue.Queue' = queue.Queue(maxsize=self.prefetch_batches)
        chunks = list(self._batches())
        stop = threading.Event()

        def put(item) -> bool:
            """Queue item unless the consumer has left; False then."""
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    # num_workers batches in the making, handed on in order
                    pending = collections.deque()
                    try:
                        for chunk in chunks:
                            pending.append(pool.submit(self._load_batch,
                                                       chunk))
                            if len(pending) > self.num_workers \
                                    and not put(pending.popleft().result()):
                                return
                        while pending:
                            if not put(pending.popleft().result()):
                                return
                    finally:
                        for f in pending:
                            f.cancel()
            except Exception as e:        # handed to the consumer
                put(e)
            finally:
                put(None)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            thread.join(timeout=60)

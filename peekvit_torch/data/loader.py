"""Batched, threaded data loader and device prefetch (counterpart of
peekvit_tpu/data/loader.py).

- ``DataLoader``: the seeded per-epoch shuffle, ``drop_last``,
  ``shard=(rank, world)`` and a thread pool that decodes a few batches
  ahead, yielding NHWC float32 images and int32 labels as numpy arrays;
  one seed gives the JAX loader's batches, bit for bit. With workers, a
  dataset that has a native whole-batch path (``ImageFolder.native_batch``)
  is decoded through it, two batches in flight.
- ``prefetch_to_device``: ``size`` batches in flight to the card. Each is
  copied into pinned host memory and sent with ``non_blocking`` copies on
  a side stream; the consumer's stream waits on the copy's event before
  it uses the batch (the tensors are recorded on that stream, so their
  memory is not reused early). On the CPU the arrays become tensors
  without a copy.
- ``BackgroundIterator``: an iterator run in a daemon thread behind a
  bounded queue.
"""

from __future__ import annotations

import collections
import concurrent.futures
import threading
from typing import Iterator, Optional

import numpy as np
import torch


class DataLoader:
    """Map-style loader: shuffling, batching, optional parallel fetch.

    Yields ``(batch_x, batch_y)`` numpy arrays, deterministic given
    ``seed`` and the epoch (``set_epoch``).
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 num_workers: int = 0, drop_last: bool = False, seed: int = 0,
                 shard: Optional[tuple] = None):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.num_workers = int(num_workers)
        self.drop_last = drop_last
        self.seed = seed
        # shard=(rank, world): this process loads its 1/world of every epoch
        # (DistributedSampler: the same seeded shuffle on every rank,
        # wrap-padded to a multiple of world, then strided by rank);
        # batch_size stays the per-rank size
        if shard is not None:
            rank, world = int(shard[0]), int(shard[1])
            if not 0 <= rank < world:
                raise ValueError(f"shard rank {rank} not in [0, {world})")
            shard = (rank, world)
        self.shard = shard
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.shard is not None:
            n = -(-n // self.shard[1])  # the wrap-padded shard's size
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng((self.seed, self._epoch))
            rng.shuffle(idx)
        if self.shard is not None:
            rank, world = self.shard
            pad = (-len(idx)) % world
            if pad:
                idx = np.concatenate([idx, idx[:pad]])
            idx = idx[rank::world]
        return idx

    def _collate(self, items):
        xs, ys = zip(*items)
        return (np.stack([np.asarray(x, dtype=np.float32) for x in xs]),
                np.asarray(ys, dtype=np.int32))

    def __iter__(self) -> Iterator:
        idx = self._indices()
        batches = [idx[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(len(self))]

        # the C++ whole-batch path (an ImageFolder with the eval recipe):
        # the decode threads live in native code, one GIL release a batch
        native_fn = getattr(self.dataset, "native_batch", None)
        if native_fn is not None and self.num_workers > 0:
            probe = native_fn(batches[0][:1], num_threads=1) if batches else None
            if probe is not None:
                def fetch_native(b):
                    x, y = native_fn(b, num_threads=self.num_workers)
                    return x, y.astype(np.int32)

                yield from _pipelined(batches, fetch_native, workers=2)
                return

        def fetch(b):
            return self._collate([self.dataset[int(i)] for i in b])

        if self.num_workers <= 0:
            for b in batches:
                yield fetch(b)
            return
        yield from _pipelined(batches, fetch, workers=self.num_workers)


def _pipelined(batches, fetch, workers: int):
    """``fetch`` over the batches in a thread pool, 2 * workers batches in
    flight, in order."""
    pool = concurrent.futures.ThreadPoolExecutor(workers)
    try:
        pending = collections.deque()
        it = iter(batches)
        for b in it:
            pending.append(pool.submit(fetch, b))
            if len(pending) >= 2 * workers:
                break
        for b in it:
            yield pending.popleft().result()
            pending.append(pool.submit(fetch, b))
        while pending:
            yield pending.popleft().result()
    finally:
        pool.shutdown(wait=False, cancel_futures=True)


def _host_tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))


def prefetch_to_device(iterator, size: int = 2, device="cuda"):
    """The batches (tuples of arrays or tensors) of ``iterator`` as tensors
    on ``device``, ``size`` of them in flight. ``device`` defaults to the
    card and raises where there is none (``resolve_device``)."""
    from peekvit_torch.models.registry import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        for batch in iterator:
            yield tuple(_host_tensor(a).to(dev) for a in batch)
        return
    stream = torch.cuda.Stream(dev)

    def put(batch):
        host = [_host_tensor(a) for a in batch]
        host = [t if t.device.type == "cuda" or t.is_pinned() else t.pin_memory()
                for t in host]
        with torch.cuda.stream(stream):
            out = tuple(t.to(dev, non_blocking=True) for t in host)
            ready = torch.cuda.Event()
            ready.record(stream)
        return out, ready

    def take(item):
        out, ready = item
        consumer = torch.cuda.current_stream(dev)
        consumer.wait_event(ready)
        for t in out:
            t.record_stream(consumer)
        return out

    queue = collections.deque()
    it = iter(iterator)
    for item in it:
        queue.append(put(item))
        if len(queue) == size:
            break
    for item in it:
        yield take(queue.popleft())
        queue.append(put(item))
    while queue:
        yield take(queue.popleft())


class BackgroundIterator:
    """An iterator run in a daemon thread behind a bounded queue, to
    overlap host-side augmentation with the device's steps."""

    _SENTINEL = object()

    def __init__(self, iterator, maxsize: int = 4):
        import queue

        self._q = queue.Queue(maxsize=maxsize)
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._fill, args=(iterator,), daemon=True)
        self._thread.start()

    def _fill(self, iterator):
        try:
            for item in iterator:
                self._q.put(item)
        except BaseException as e:  # raised again on next()
            self._err = e
        finally:
            self._q.put(self._SENTINEL)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._SENTINEL:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

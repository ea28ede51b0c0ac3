"""Prefetching host data loader.

Counterpart of `latent_diffusion_speech_tpu/data/loader.py::DataLoader`,
its serial and threaded modes: numpy batches are assembled ahead of the
training step by a producer thread (items over a small thread pool when the
dataset declares `thread_safe_items`).  The per-epoch permutation is a pure
function of (seed, epoch), and `skip_batches` skips the start of the next
epoch without loading it, so a resumed run replays the exact batch stream.
The JAX package's spawn-process workers, native batched reads and
length-sorted batching are not ported (ROADMAP.md).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np

__all__ = ["DataLoader"]

PREFETCH = 2  # batches assembled ahead of the training step


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = True,
        num_threads: int = 2,
        seed: int = 0,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_threads = num_threads
        self.seed = seed
        self.epoch = 0
        self._skip_next = 0
        self._pool = None  # item thread pool, made at the first threaded batch

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None

    def set_epoch(self, epoch: int) -> None:
        """Select the (seed, epoch)-keyed shuffle for the next iteration; the
        dataset's augmentation draws follow if it has set_epoch too."""
        self.epoch = int(epoch)
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def skip_batches(self, n: int) -> None:
        """Skip the first n batches of the NEXT iteration (mid-epoch resume);
        skipped batches are never loaded, only their indices are drawn."""
        self._skip_next = max(0, int(n))

    def _batches(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng([self.seed, self.epoch]).shuffle(idx)
        n_full = len(idx) // self.batch_size
        for b in range(n_full):
            yield idx[b * self.batch_size : (b + 1) * self.batch_size]
        if not self.drop_last and len(idx) % self.batch_size:
            yield idx[n_full * self.batch_size :]

    def _make_batch(self, indices):
        # threads only for datasets whose items draw from (seed, epoch,
        # index)-keyed generators: a shared generator would interleave draws
        if self.num_threads > 1 and getattr(self.dataset, "thread_safe_items", False):
            if self._pool is None:
                from concurrent.futures import ThreadPoolExecutor

                self._pool = ThreadPoolExecutor(self.num_threads)
            items = list(self._pool.map(lambda i: self.dataset[int(i)], indices))
        else:
            items = [self.dataset[int(i)] for i in indices]
        return {k: np.stack([it[k] for it in items]) for k in items[0]}

    def __iter__(self) -> Iterator:
        skip, self._skip_next = self._skip_next, 0
        q: queue.Queue = queue.Queue(maxsize=PREFETCH)
        sentinel = object()
        stop = threading.Event()  # set when the consumer stops early

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for bi, indices in enumerate(self._batches()):
                    if bi >= skip and not put(self._make_batch(indices)):
                        return
            except BaseException as e:  # noqa: BLE001 — re-raised in the consumer
                put(e)
                return
            put(sentinel)

        threading.Thread(target=producer, daemon=True).start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                if isinstance(item, BaseException):
                    # a failed batch fails the epoch, it does not truncate it
                    raise item
                yield item
        finally:
            stop.set()

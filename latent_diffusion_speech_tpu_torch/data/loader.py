"""Prefetching host data loader.

Counterpart of `latent_diffusion_speech_tpu/data/loader.py::DataLoader`:
numpy batches are assembled ahead of the training step, in one of two modes:

- threads (default): a producer thread, items over a small thread pool when
  the dataset declares `thread_safe_items`;
- processes (`num_workers > 0`): N 'spawn' worker processes each assemble
  WHOLE batches (items + collate), fed batch index lists over a window of
  `num_workers + prefetch` jobs and collected in order, so the batch stream
  is the threaded one.  The epoch rides with every job.  A worker that dies
  surfaces as `BrokenProcessPool` (never a hang) and fails the epoch.

`length_sorted` batches items of similar `dataset.item_lengths()` together:
the (seed, epoch) shuffle, a stable sort inside pools of
`pool_factor * batch_size` items, then a shuffle of the batch order with the
same generator, so pad-to-bucket batches hug the true lengths.  Every order is
a pure function of (seed, epoch), and `skip_batches` skips the start of the
next epoch without loading it, so a resumed run replays the exact batch
stream.

A dataset with `fast_batch` (the native batched reader) assembles each
batch in one call when no `collate` is given, in both modes; an OSError
from it (an unreadable file) turns the fast path off and the batch is
assembled from items, as in JAX.  A reader that fails to build raises.
`device_put` (the JAX hook's counterpart) runs on each finished batch in
the producer thread (thread mode) or as it is collected (process mode):
the diffusion trainer pins the batch there, so its copy to the card can
overlap.

Imports numpy only: a worker imports this module and the dataset's.
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from typing import Callable, Iterator, Optional

import numpy as np

__all__ = ["DataLoader"]

# -- process-worker plumbing (module level, so a 'spawn' child imports it) --
_W: dict = {}


def _collate_items(items, collate):
    """The collate shared by the in-process and worker paths."""
    if collate is not None:
        return collate(items)
    return {k: np.stack([it[k] for it in items]) for k in items[0]}


def _worker_init(dataset, collate, fast) -> None:
    _W["dataset"], _W["collate"], _W["fast"], _W["epoch"] = dataset, collate, fast, None


def _worker_make_batch(job):
    """One batch in a worker.  job = (epoch, indices): the dataset was
    pickled once when the pool started, so the parent's `set_epoch` reaches
    the worker's copy through the job."""
    epoch, indices = job
    dataset = _W["dataset"]
    if _W["epoch"] != epoch and hasattr(dataset, "set_epoch"):
        dataset.set_epoch(epoch)
        _W["epoch"] = epoch
    indices = [int(i) for i in indices]
    if _W["fast"]:
        try:
            return dataset.fast_batch(indices)
        except OSError:  # an unreadable file: items from here on, as the thread mode does
            _W["fast"] = False
    return _collate_items([dataset[i] for i in indices], _W["collate"])


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        collate: Optional[Callable] = None,
        shuffle: bool = True,
        drop_last: bool = True,
        prefetch: int = 2,
        num_threads: int = 2,
        seed: int = 0,
        num_workers: int = 0,
        length_sorted: bool = False,
        pool_factor: int = 50,
        device_put: Optional[Callable] = None,
    ):
        """collate: items -> batch (default: stack every key, or the
        dataset's `fast_batch`); prefetch: batches assembled ahead;
        num_workers > 0: spawn worker processes; length_sorted: needs
        `dataset.item_lengths()`; device_put: batch -> batch, applied to
        every batch before it is yielded."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate = collate
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.num_threads = num_threads
        self.seed = seed
        self.num_workers = int(num_workers)
        self.length_sorted = bool(length_sorted)
        self.pool_factor = int(pool_factor)
        self.device_put = device_put
        self._fast = collate is None and hasattr(dataset, "fast_batch")
        self.epoch = 0
        self._skip_next = 0
        self._pool = None  # item thread pool, made at the first threaded batch
        self._proc_pool = None  # worker processes, made at the first worker batch
        self._lengths = None
        if self.length_sorted:
            if not hasattr(dataset, "item_lengths"):
                raise ValueError("length_sorted=True needs dataset.item_lengths()")
            self._lengths = np.asarray(dataset.item_lengths(), np.int64)

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None
        if self._proc_pool is not None:
            self._proc_pool.shutdown(wait=True, cancel_futures=True)
            self._proc_pool = None

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
        rng = np.random.default_rng([self.seed, self.epoch])
        if self.shuffle:
            rng.shuffle(idx)
        if self.length_sorted:
            pool = max(self.batch_size, self.pool_factor * self.batch_size)
            sorted_idx = np.concatenate([
                idx[s : s + pool][np.argsort(self._lengths[idx[s : s + pool]], kind="stable")]
                for s in range(0, len(idx), pool)
            ])
            n_full = len(sorted_idx) // self.batch_size
            batches = [sorted_idx[b * self.batch_size : (b + 1) * self.batch_size] for b in range(n_full)]
            tail = sorted_idx[n_full * self.batch_size :]
            if self.shuffle:
                rng.shuffle(batches)
            yield from batches
            if not self.drop_last and len(tail):
                yield tail
            return
        n_full = len(idx) // self.batch_size
        for b in range(n_full):
            yield idx[b * self.batch_size : (b + 1) * self.batch_size]
        if not self.drop_last and len(idx) % self.batch_size:
            yield idx[n_full * self.batch_size :]

    def _make_batch(self, indices):
        if self._fast:
            try:
                return self.dataset.fast_batch([int(i) for i in indices])
            except OSError:  # an unreadable file: items from here on
                self._fast = False
        # threads only for datasets whose items draw from (seed, epoch,
        # index)-keyed generators: a shared generator would interleave draws
        if self.num_threads > 1 and getattr(self.dataset, "thread_safe_items", False):
            if self._pool is None:
                from concurrent.futures import ThreadPoolExecutor

                self._pool = ThreadPoolExecutor(self.num_threads)
            items = list(self._pool.map(lambda i: self.dataset[int(i)], indices))
        else:
            items = [self.dataset[int(i)] for i in indices]
        return _collate_items(items, self.collate)

    def _put(self, batch):
        return self.device_put(batch) if self.device_put is not None else batch

    def __iter__(self) -> Iterator:
        skip, self._skip_next = self._skip_next, 0
        if self.num_workers > 0:
            return self._iter_procs(skip)
        return self._iter_threaded(skip)

    def _iter_procs(self, skip: int) -> Iterator:
        if self._proc_pool is None:
            import multiprocessing as mp
            from concurrent.futures import ProcessPoolExecutor

            # 'spawn': a child inherits no CUDA context; the dataset and the
            # collate are pickled once, into the initializer
            self._proc_pool = ProcessPoolExecutor(
                max_workers=self.num_workers, mp_context=mp.get_context("spawn"),
                initializer=_worker_init, initargs=(self.dataset, self.collate, self._fast),
            )
        pool, window, pending = self._proc_pool, self.num_workers + self.prefetch, deque()
        try:
            for bi, indices in enumerate(self._batches()):
                if bi < skip:
                    continue
                pending.append(pool.submit(_worker_make_batch, (self.epoch, indices)))
                if len(pending) >= window:
                    yield self._put(pending.popleft().result())
            while pending:
                yield self._put(pending.popleft().result())
        except GeneratorExit:  # the consumer stopped early: the workers stay for the next epoch
            for job in pending:
                job.cancel()
            raise
        except BaseException:
            self.close()  # a failed batch fails the epoch
            raise

    def _iter_threaded(self, skip: int) -> Iterator:
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
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
                    if bi >= skip and not put(self._put(self._make_batch(indices))):
                        return
            except BaseException as e:  # noqa: BLE001 — re-raised in the consumer
                put(e)
                return
            put(sentinel)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
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
            # the producer finishes its batch in flight and returns: none is
            # left inside the native reader when the process exits
            stop.set()
            thread.join()

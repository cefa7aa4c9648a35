"""Prefetching data loader (host input pipeline).

Replaces torch DataLoader workers (reference second/pytorch/train.py:
262-270): a thread pool maps dataset.__getitem__ over shuffled indices
and a background thread assembles fixed-shape batches into a bounded
prefetch queue.  The hot per-sample work (native voxelizer, vectorized
numpy augmentation) releases the GIL, so threads scale; shapes are
static so batches stack with no collate logic beyond merge_second_batch.

The port's copy of ``second_tpu/data/loader.py``. ``mode="process"``
forks; a fork after CUDA is initialised is safe only while the children
never touch CUDA (they run the numpy/C++ prep only), and the port's
``train()`` picks threads on CUDA (see ``train/__main__.py``).
"""

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..parallel import mesh
from .preprocess import merge_second_batch


_WORKER_DATASET = None


def _init_worker(seed_base):
    # dataset arrives via fork (copy-on-write); reseed numpy per worker
    # like the reference's worker_init_fn (train.py:70-73)
    import os

    np.random.seed((seed_base + os.getpid()) % (2**31))


def _worker_getitem(idx):
    return _WORKER_DATASET[int(idx)]


def shard_batches(indices, batch_size, drop_last, rank=0, world_size=1):
    """The dataset indices of each batch of ``rank``: the global batches
    of ``batch_size`` cut from ``indices`` (the last one short unless
    ``drop_last``), of which ``rank`` takes its slice
    (``parallel.mesh.shard_slice``). A short last batch leaves a rank
    less, or an empty slice; every rank gets one entry per global
    batch."""
    rows = mesh.shard_slice(batch_size, rank, world_size)
    batches = [indices[i:i + batch_size]
               for i in range(0, len(indices), batch_size)]
    if drop_last:
        batches = [b for b in batches if len(b) == batch_size]
    return [b[rows] for b in batches]


class DataLoader:
    def __init__(self, dataset, batch_size, shuffle=True, num_workers=4,
                 drop_last=True, prefetch=4, seed=None, mode="thread",
                 rank=0, world_size=1):
        """mode: "thread" (default) or "process" (fork pool; higher
        throughput for Python-heavy prep, requires fork-safe usage).

        rank, world_size: under a process group every rank iterates the
        same global batches of ``batch_size`` (the same permutation: pass
        the same ``seed`` on every rank) and yields its own slice of each
        (:func:`shard_batches`); an empty slice is skipped."""
        self._dataset = dataset
        self._batch_size = batch_size
        self._rank, self._world_size = rank, world_size
        self._shuffle = shuffle
        self._num_workers = max(num_workers, 1)
        self._drop_last = drop_last
        self._prefetch = prefetch
        self._rng = np.random.RandomState(seed)
        self._mode = mode
        self._pool = None
        if mode == "process":
            import multiprocessing as mp

            global _WORKER_DATASET
            _WORKER_DATASET = dataset
            try:
                ctx = mp.get_context("fork")
                self._pool = ctx.Pool(
                    self._num_workers, initializer=_init_worker,
                    initargs=(seed or 0,))
            except (ValueError, OSError) as e:  # no fork on this platform
                import logging

                logging.getLogger(__name__).warning(
                    "process-mode loader unavailable (%s); "
                    "falling back to threads", e)
                self._mode = "thread"

    def __len__(self):
        n = len(self._dataset)
        if self._drop_last:
            return n // self._batch_size
        return -(-n // self._batch_size)

    def __iter__(self):
        indices = np.arange(len(self._dataset))
        if self._shuffle:
            self._rng.shuffle(indices)
        batches = [b for b in shard_batches(
            indices, self._batch_size, self._drop_last, self._rank,
            self._world_size) if len(b)]

        q = queue.Queue(maxsize=self._prefetch)
        stop = threading.Event()

        def producer():
            try:
                if self._pool is not None:
                    pending = [
                        self._pool.map_async(_worker_getitem, b)
                        for b in batches[: self._prefetch]
                    ]
                    next_submit = self._prefetch
                    for i in range(len(batches)):
                        if stop.is_set():
                            return
                        examples = pending[i].get()
                        if next_submit < len(batches):
                            pending.append(self._pool.map_async(
                                _worker_getitem, batches[next_submit]))
                            next_submit += 1
                        q.put(merge_second_batch(examples))
                    q.put(None)
                    return
                with ThreadPoolExecutor(self._num_workers) as pool:
                    for batch_idx in batches:
                        if stop.is_set():
                            return
                        examples = list(
                            pool.map(self._dataset.__getitem__, batch_idx))
                        q.put(merge_second_batch(examples))
                    q.put(None)
            except BaseException as e:  # surface worker errors
                q.put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()

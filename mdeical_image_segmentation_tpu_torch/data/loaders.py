"""Batch loaders of the volumetric pipeline (the JAX package's
``data/loaders.py``), numpy only.

``VolumeLoader`` is the JAX package's torchless DataLoader: shuffling from
``RandomState(seed + epoch)``, collation into stacked numpy arrays, a
``drop_last`` mode that wrap-pads a dataset smaller than one batch instead
of yielding nothing, optional worker threads per batch, and a daemon
prefetch thread that stops when its consumer abandons the iterator.  The
trainer takes any iterable of (input, target[, weight]) batches as a loader,
so in-memory datasets need no files.  ``get_train_loaders`` and
``get_test_loaders`` (HDF5 datasets and the volume transforms) raise until
those are ported.
"""

from __future__ import annotations

import collections.abc
import queue
import threading
from typing import Any, Callable, Dict, Iterator, Sequence

import numpy as np

DATA_ITEM = "ROADMAP.md queue 1, item 18 (HDF5 datasets and volume transforms)"


class ConcatDataset:
    """Concatenation of indexable datasets."""

    def __init__(self, datasets: Sequence[Any]):
        if not datasets:
            raise ValueError("datasets should not be an empty iterable")
        self.datasets = list(datasets)
        self.cumulative_sizes = np.cumsum([len(d) for d in self.datasets])

    def __len__(self) -> int:
        return int(self.cumulative_sizes[-1])

    def __getitem__(self, idx: int):
        dataset_idx = int(np.searchsorted(self.cumulative_sizes, idx,
                                          side="right"))
        sample_idx = idx - (0 if dataset_idx == 0 else
                            int(self.cumulative_sizes[dataset_idx - 1]))
        return self.datasets[dataset_idx][sample_idx]


def default_prediction_collate(batch):
    """Stack arrays; keep tuples of slices; recurse into sequences."""
    if isinstance(batch[0], np.ndarray):
        return np.stack(batch, 0)
    if isinstance(batch[0], tuple) and isinstance(batch[0][0], slice):
        return batch
    if isinstance(batch[0], collections.abc.Sequence):
        return [default_prediction_collate(samples)
                for samples in zip(*batch)]
    raise TypeError(f"batch must contain arrays or slice; found "
                    f"{type(batch[0])}")


class VolumeLoader:
    """Minimal DataLoader over tuple-sample datasets with thread prefetch."""

    def __init__(self, dataset, batch_size: int = 1, *, shuffle: bool = False,
                 seed: int = 0,
                 collate_fn: Callable = default_prediction_collate,
                 prefetch: int = 2, drop_last: bool = False,
                 num_workers: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.collate_fn = collate_fn
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.num_workers = num_workers
        self._pool = None
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return max(n // self.batch_size, 1) if n else 0
        return -(-n // self.batch_size)

    def close(self):
        """Release the worker thread pool."""
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None

    def __iter__(self) -> Iterator[Any]:
        n = len(self.dataset)
        if self.shuffle:
            order = np.random.RandomState(self.seed + self._epoch
                                          ).permutation(n)
        else:
            order = np.arange(n)
        self._epoch += 1
        batches = [order[i:i + self.batch_size]
                   for i in range(0, n, self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            if len(batches) > 1:
                batches.pop()
            else:  # smaller than one batch: wrap-pad to a full one
                reps = -(-self.batch_size // n)
                batches[0] = np.tile(order, reps)[:self.batch_size]

        if self.num_workers > 0 and self._pool is None:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(max_workers=self.num_workers)

        def assemble(idx):
            if self._pool is not None:
                samples = list(self._pool.map(
                    lambda i: self.dataset[int(i)], idx))
            else:
                samples = [self.dataset[int(i)] for i in idx]
            return self.collate_fn(samples)

        if self.prefetch <= 0:
            for idx in batches:
                yield assemble(idx)
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = object()
        cancel = threading.Event()  # set when the consumer abandons us

        def _put(item) -> bool:
            """A bounded put that gives up once the iterator is abandoned,
            so the thread never blocks forever on a full queue."""
            while not cancel.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            # hand assembly failures to the consumer
            try:
                for idx in batches:
                    if cancel.is_set() or not _put(assemble(idx)):
                        return
                _put(stop)
            except BaseException as exc:  # noqa: BLE001 - re-raised below
                _put(exc)

        threading.Thread(target=producer, daemon=True).start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # on exhaustion and on abandonment alike: release the producer
            cancel.set()


def get_train_loaders(config: Dict[str, Any], n_devices: int = 1):
    raise NotImplementedError(f"get_train_loaders is not ported yet "
                              f"({DATA_ITEM}); pass the trainer in-memory "
                              "loaders")


def get_test_loaders(config: Dict[str, Any], n_devices: int = 1):
    raise NotImplementedError(f"get_test_loaders is not ported yet "
                              f"({DATA_ITEM})")

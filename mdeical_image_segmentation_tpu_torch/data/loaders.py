"""Batch loaders of the volumetric pipeline (the JAX package's
``data/loaders.py``), numpy only.

``VolumeLoader`` is the JAX package's torchless DataLoader: shuffling from
``RandomState(seed + epoch)``, collation into stacked numpy arrays, a
``drop_last`` mode that wrap-pads a dataset smaller than one batch instead
of yielding nothing, optional worker threads per batch, and a daemon
prefetch thread that stops when its consumer abandons the iterator.  The
trainer takes any iterable of (input, target[, weight]) batches as a loader,
so in-memory datasets need no files.

``get_train_loaders`` and ``get_test_loaders`` assemble them from a config's
``loaders`` section over the HDF5 datasets (``data/hdf5.py``), found by name
in ``DATASETS``.  With ``device_cache: true`` and a device, the train loader
keeps the volumes on the device and samples there
(``data/device_cache.py``); a pipeline or dataset it cannot take falls back
to the host loader with a warning, as in the JAX package.
"""

from __future__ import annotations

import collections.abc
import os
import queue
import threading
from typing import Any, Callable, Dict, Iterator, Sequence

import numpy as np

from ..configs.registry import Registry
from ..logging_utils import get_logger

logger = get_logger("Dataset")

DATASETS = Registry("dataset")


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


def _register_builtin_datasets():
    from .dsb import DSB2018Dataset
    from .hdf5 import LazyHDF5Dataset, StandardHDF5Dataset

    for cls in (StandardHDF5Dataset, LazyHDF5Dataset, DSB2018Dataset):
        if cls.__name__ not in DATASETS:
            DATASETS.register(cls.__name__)(cls)


def _dataset_class(loaders_config: Dict[str, Any]):
    _register_builtin_datasets()
    name = loaders_config.get("dataset")
    if name is None:
        name = "StandardHDF5Dataset"
        logger.warning(f"loaders config names no dataset class; defaulting "
                       f"to '{name}'")
    return DATASETS.get(name)


def get_train_loaders(config: Dict[str, Any], n_devices: int = 1,
                      device=None) -> Dict[str, Any]:
    """``{'train': loader, 'val': loader}`` from ``config['loaders']``: the
    batch is ``batch_size`` x ``n_devices``; the train loader shuffles and
    drops a short tail; both use ``num_workers`` threads per batch and
    prefetch 2 batches when they have workers.  ``device_cache: true`` with
    a ``device`` makes the train loader a ``DeviceCachedVolumeLoader`` on
    it (``device_cache_dtype``, ``device_cache_budget_gb``), or the host
    loader with a warning where that loader cannot run."""
    if "loaders" not in config:
        raise KeyError("config is missing its 'loaders' section")
    loaders_config = config["loaders"]
    logger.info("assembling train/val loaders")
    dataset_class = _dataset_class(loaders_config)

    # the leakage guard compares the expanded file lists: a val file listed
    # inside a train directory is caught
    from .volume_utils import traverse_h5_paths

    def files(phase):
        return {os.path.realpath(p) for p in
                traverse_h5_paths(loaders_config[phase]["file_paths"])}

    shared = files("train") & files("val")
    if shared:
        raise ValueError("train and val file_paths intersect — the val "
                         f"volumes would leak into training: "
                         f"{sorted(shared)}")

    train_datasets = dataset_class.create_datasets(loaders_config,
                                                   phase="train")
    val_datasets = dataset_class.create_datasets(loaders_config, phase="val")

    batch_size = loaders_config.get("batch_size", 1)
    if n_devices > 1:
        logger.info(f"{n_devices} devices available. Using batch_size = "
                    f"{n_devices} * {batch_size}")
        batch_size = batch_size * n_devices
    num_workers = loaders_config.get("num_workers", 1)
    logger.info(f"train/val loaders: {num_workers} worker threads")
    prefetch = 2 if num_workers else 0

    train_loader = None
    if loaders_config.get("device_cache") and device is None:
        logger.warning("device_cache requested but no device was given (a "
                       "bare get_train_loaders call) — using the host loader")
    elif loaders_config.get("device_cache"):
        from .device_cache import (
            DeviceCachedVolumeLoader,
            DeviceCacheUnsupported,
        )

        try:
            train_loader = DeviceCachedVolumeLoader(
                train_datasets, batch_size=batch_size, device=device,
                seed=config.get("seed", 0),
                cache_dtype=loaders_config.get("device_cache_dtype",
                                               "float32"),
                budget_gb=float(loaders_config.get("device_cache_budget_gb",
                                                   4.0)))
        except DeviceCacheUnsupported as e:
            logger.warning(f"device_cache requested but unsupported ({e}); "
                           "falling back to the host loader")
    if train_loader is None:
        train_loader = VolumeLoader(ConcatDataset(train_datasets),
                                    batch_size=batch_size, shuffle=True,
                                    prefetch=prefetch, drop_last=True,
                                    num_workers=num_workers)
    return {
        "train": train_loader,
        "val": VolumeLoader(ConcatDataset(val_datasets),
                            batch_size=batch_size, shuffle=False,
                            prefetch=prefetch, num_workers=num_workers),
    }


def get_test_loaders(config: Dict[str, Any], n_devices: int = 1
                     ) -> Iterator[VolumeLoader]:
    """A generator of one test loader per file of
    ``config['loaders']['test']``, each collating with its dataset's
    ``prediction_collate``."""
    if "loaders" not in config:
        raise KeyError("config is missing its 'loaders' section")
    loaders_config = config["loaders"]
    logger.info("assembling test loaders")
    dataset_class = _dataset_class(loaders_config)
    test_datasets = dataset_class.create_datasets(loaders_config,
                                                  phase="test")
    batch_size = loaders_config.get("batch_size", 1)
    if n_devices > 1:
        batch_size = batch_size * n_devices
    for test_dataset in test_datasets:
        logger.info(f"test volume: {test_dataset.file_path}")
        collate_fn = getattr(test_dataset, "prediction_collate",
                             default_prediction_collate)
        yield VolumeLoader(test_dataset, batch_size=batch_size,
                           collate_fn=collate_fn)

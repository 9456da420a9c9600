"""Batch collation and host-side batch loading (the JAX package's
``data/collate.py``).

``SliceCollator`` stacks per-sample ``image`` / ``mask`` into a batch dict
``{"images", "labels"}``, the keys the model wrapper and the trainer take;
arrays stay channels-last numpy, and the trainer copies them to the device.

``BatchLoader``: deterministic or shuffled epoch order
(``RandomState(seed + epoch)`` permutations), a fixed batch size with
drop-last when shuffling, wrap padding of a short batch, and an optional
background thread (``prefetch``) and decode pool (``num_workers``) that
overlap batch assembly with device compute; ``process_shard`` makes a
loader hand out one process's rows of each global batch.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np


class SliceCollator:
    """Stack samples to {"images": (N,H,W,C), "labels": (N,H,W,1)}."""

    def __call__(self, batch: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
        images = np.stack([s["image"] for s in batch], axis=0)
        masks = np.stack([s["mask"] for s in batch], axis=0)
        return {"images": images, "labels": masks}


# aliases under the reference's class names
DRIVEDataCollator = SliceCollator
BUSIDataCollator = SliceCollator


class BatchLoader:
    """Minimal epoch iterator over an indexable dataset.

    - fixed ``batch_size`` with drop-last when shuffling (training) so every
      step has identical shapes; padded final batch kept for eval
      (``drop_last=False`` pads by wrapping).
    - ``prefetch > 0`` runs collation in a daemon thread, keeping up to
      ``prefetch`` ready batches — double-buffering against device compute.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        *,
        shuffle: bool = False,
        seed: int = 0,
        drop_last: Optional[bool] = None,
        collator: Optional[SliceCollator] = None,
        prefetch: int = 2,
        num_workers: int = 0,
        process_shard: Optional[tuple] = None,
    ):
        """``process_shard=(index, count)`` makes this loader yield only
        this process's rows of each *global* batch: ``batch_size`` stays
        the global batch, the epoch permutation is the same on every
        process, and each assembles rows ``[index·local : (index+1)·local]``
        (``parallel.shard_batch``'s rows)."""
        if process_shard is not None:
            index, count = process_shard
            if not 0 <= index < count:
                raise ValueError(f"process_shard {process_shard}: the index "
                                 "must lie in [0, count)")
            if batch_size % count:
                raise ValueError(f"global batch {batch_size} not divisible "
                                 f"by {count} processes")
        self.process_shard = process_shard
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = shuffle if drop_last is None else drop_last
        self.collator = collator or SliceCollator()
        self.prefetch = prefetch
        self.num_workers = num_workers
        self._pool = None
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            # never zero: a dataset smaller than the batch still yields one
            # wrap-padded batch per epoch
            return max(n // self.batch_size, 1 if n else 0)
        return -(-n // self.batch_size)

    def _index_batches(self) -> List[np.ndarray]:
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self._epoch)
            order = rng.permutation(n)
        else:
            order = np.arange(n)
        batches = []
        for start in range(0, n, self.batch_size):
            idx = order[start : start + self.batch_size]
            if len(idx) < self.batch_size:
                if self.drop_last and batches:
                    break
                # pad by wrapping so shapes stay static; callers can use
                # `valid` to mask padded rows out of metrics.  Tile the
                # epoch order so even batch_size > 2·len(dataset) fills up.
                # With drop_last this only triggers for the dataset-smaller-
                # than-batch case above (guaranteeing one batch per epoch).
                need = self.batch_size - len(idx)
                pad = np.tile(order, -(-need // max(n, 1)))[:need]
                idx = np.concatenate([idx, pad])
            batches.append(idx)
        if self.process_shard is not None:
            index, count = self.process_shard
            local = self.batch_size // count
            batches = [b[index * local:(index + 1) * local] for b in batches]
        return batches

    def close(self):
        """Release the worker thread pool (also runs on GC)."""
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _assemble(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        if self.num_workers > 0:
            if self._pool is None:
                from concurrent.futures import ThreadPoolExecutor

                self._pool = ThreadPoolExecutor(max_workers=self.num_workers)
            samples = list(self._pool.map(lambda i: self.dataset[int(i)], idx))
        else:
            samples = [self.dataset[int(i)] for i in idx]
        return self.collator(samples)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        batches = self._index_batches()
        self._epoch += 1
        if self.prefetch <= 0:
            for idx in batches:
                yield self._assemble(idx)
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = object()
        cancel = threading.Event()  # set when the consumer abandons us

        def _put(item) -> bool:
            """Bounded put that gives up when the iterator was abandoned —
            otherwise a discarded iterator (e.g. a single next() peek) pins
            this thread on a full queue forever, holding decoded batches."""
            while not cancel.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            # propagate assembly failures to the consumer instead of
            # silently ending the epoch on truncated data
            try:
                for idx in batches:
                    if cancel.is_set() or not _put(self._assemble(idx)):
                        return
                _put(stop)
            except BaseException as exc:  # noqa: BLE001
                _put(exc)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # runs on StopIteration AND on GeneratorExit (abandoned
            # iterator): unblocks the producer so it can exit
            cancel.set()

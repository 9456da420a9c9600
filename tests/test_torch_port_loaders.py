"""The port's batch loaders (``data/loaders.py``) and logging utilities
(``logging_utils.py``) against the JAX package's: the same batches in the
same order from the same seed, the same wrap-padding, the same image
panels; and the port's own contracts (the prefetch thread stops when its
iterator is abandoned, the JSONL metric file)."""

import json
import threading
import time

import numpy as np
import pytest

from mdeical_image_segmentation_tpu import logging_utils as jax_log
from mdeical_image_segmentation_tpu.data import loaders as jax_loaders
from mdeical_image_segmentation_tpu_torch import logging_utils
from mdeical_image_segmentation_tpu_torch.data import loaders
from mdeical_image_segmentation_tpu_torch.train import (
    logging_utils as train_logging,
)


class _Samples:
    def __init__(self, n, offset=0):
        self.n, self.offset = n, offset

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        v = np.full((2, 3, 1), i + self.offset, np.float32)
        return v, v * 2


def _batches(loader):
    return [tuple(np.asarray(a) for a in b) for b in loader]


@pytest.mark.parametrize("n,bs,shuffle,drop_last,prefetch,workers", [
    (7, 2, True, False, 2, 0),
    (7, 2, True, True, 0, 0),
    (3, 5, True, True, 2, 0),   # smaller than one batch: wrap-padded
    (6, 3, False, False, 1, 2),
])
def test_volume_loader_matches_jax(n, bs, shuffle, drop_last, prefetch,
                                   workers):
    kw = dict(batch_size=bs, shuffle=shuffle, seed=5, drop_last=drop_last,
              prefetch=prefetch, num_workers=workers)
    ours = loaders.VolumeLoader(_Samples(n), **kw)
    theirs = jax_loaders.VolumeLoader(_Samples(n), **kw)
    assert len(ours) == len(theirs)
    for _ in range(2):  # the shuffle follows RandomState(seed + epoch)
        a, b = _batches(ours), _batches(theirs)
        assert len(a) == len(b) == len(ours)
        for x, y in zip(a, b):
            for u, v in zip(x, y):
                np.testing.assert_array_equal(u, v)
    ours.close()
    theirs.close()


def test_concat_dataset_and_collate_match_jax():
    parts = [_Samples(3), _Samples(2, 10), _Samples(4, 20)]
    ours = loaders.ConcatDataset(parts)
    theirs = jax_loaders.ConcatDataset(parts)
    assert len(ours) == len(theirs) == 9
    for i in range(9):
        np.testing.assert_array_equal(ours[i][0], theirs[i][0])
    with pytest.raises(ValueError):
        loaders.ConcatDataset([])
    slices = [(slice(0, 2), slice(1, 3))] * 2
    assert loaders.default_prediction_collate(slices) == slices
    nested = [(np.ones(2), np.zeros(3)), (np.ones(2), np.zeros(3))]
    got = loaders.default_prediction_collate(nested)
    want = jax_loaders.default_prediction_collate(nested)
    for u, v in zip(got, want):
        np.testing.assert_array_equal(u, v)
    with pytest.raises(TypeError, match="arrays or slice"):
        loaders.default_prediction_collate([1, 2])


def test_abandoned_iterator_stops_its_prefetch_thread():
    before = threading.active_count()
    loader = loaders.VolumeLoader(_Samples(50), batch_size=1, prefetch=1)
    it = iter(loader)
    next(it)
    it.close()  # the consumer walks away with the queue full
    deadline = time.time() + 5
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


def test_assembly_errors_reach_the_consumer():
    class Broken(_Samples):
        def __getitem__(self, i):
            if i == 2:
                raise OSError("unreadable patch")
            return super().__getitem__(i)

    with pytest.raises(OSError, match="unreadable"):
        list(loaders.VolumeLoader(Broken(4), batch_size=1, prefetch=2))


def test_running_average_and_formatter_match_jax():
    ours, theirs = logging_utils.RunningAverage(), jax_log.RunningAverage()
    for v, n in ((1.0, 2), (4.0, 1), (0.5, 3)):
        ours.update(v, n)
        theirs.update(v, n)
    assert (ours.avg, ours.count) == (theirs.avg, theirs.count)
    batch = np.random.default_rng(0).random((2, 5, 4, 3, 2)).astype(
        np.float32)
    for cfg in (None, {"name": "DefaultTensorboardFormatter",
                       "skip_last_target": True}):
        got = logging_utils.get_tensorboard_formatter(cfg)("targets", batch)
        want = jax_log.get_tensorboard_formatter(cfg)("targets", batch)
        assert [t for t, _ in got] == [t for t, _ in want]
        for (_, a), (_, b) in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert train_logging.MetricWriter is logging_utils.MetricWriter


def test_metric_writer_appends_jsonl(tmp_path):
    writer = logging_utils.MetricWriter(str(tmp_path / "logs"))
    writer.scalar("train_loss_avg", 0.5, 3)
    writer.scalars({"lr": 1e-3, "name": "skipped"}, 4)
    writer.image("val_/inputs", np.full((4, 5), 0.25), 4)
    writer.close()
    rows = [json.loads(line) for line in open(tmp_path / "logs" /
                                              "metrics.jsonl")]
    assert [(r["tag"], r["value"], r["step"]) for r in rows] == [
        ("train_loss_avg", 0.5, 3), ("lr", 1e-3, 4),
        ("val_/inputs/mean", 0.25, 4)]
    null = logging_utils.NullMetricWriter()
    null.scalar("x", 1.0, 0)
    null.close()
    assert null.log_dir is None

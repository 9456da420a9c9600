"""Logging and observability for the port (the JAX package's
``logging_utils``):

- ``get_logger``: memoized stdout loggers with the thread-name format;
- ``RunningAverage``: a streaming mean for loss and score logging;
- ``TensorboardFormatter``: middle-z-slice image panels, min-max normalized,
  one per (sample, channel);
- ``MetricWriter``: scalars appended to a JSONL file, mirrored to
  TensorBoard event files when the ``tensorboard`` package imports (images
  go to TensorBoard as PNGs, to the JSONL file as their mean);
  ``NullMetricWriter`` writes nothing.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

_loggers: Dict[str, logging.Logger] = {}


def get_logger(name: str, level=logging.INFO) -> logging.Logger:
    """Memoized stdout logger with the thread-name format."""
    if name not in _loggers:
        logger = logging.getLogger(name)
        logger.setLevel(level)
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(
            logging.Formatter(
                "%(asctime)s [%(threadName)s] %(levelname)s %(name)s - %(message)s"
            )
        )
        logger.addHandler(handler)
        logger.propagate = False
        _loggers[name] = logger
    return _loggers[name]


class RunningAverage:
    """Streaming weighted average."""

    def __init__(self):
        self.count = 0
        self.sum = 0.0
        self.avg = 0.0

    def update(self, value: float, n: int = 1):
        self.count += n
        self.sum += float(value) * n
        self.avg = self.sum / self.count


class TensorboardFormatter:
    """Middle-slice image panels of channels-last batches (N, [D,] H, W, C):
    a list of (tag, H x W image) pairs, min-max normalized."""

    def __init__(self, skip_last_target: bool = False):
        self.skip_last_target = skip_last_target

    @staticmethod
    def _normalize(img: np.ndarray) -> np.ndarray:
        value_range = img.max() - img.min()
        return (img - img.min()) / (value_range + 1e-10)

    def __call__(self, name: str, batch: np.ndarray
                 ) -> List[Tuple[str, np.ndarray]]:
        batch = np.asarray(batch)
        if self.skip_last_target and name == "targets":
            batch = batch[..., :-1]
        if batch.ndim == 5:  # (N, D, H, W, C) → middle z slice
            batch = batch[:, batch.shape[1] // 2]
        if batch.ndim != 4:
            raise ValueError(f"expected (N, H, W, C), got {batch.shape}")
        return [(f"{name}/batch_{b}/channel_{c}",
                 self._normalize(batch[b, ..., c]))
                for b in range(batch.shape[0])
                for c in range(batch.shape[-1])]


def get_tensorboard_formatter(formatter_config: Optional[dict]
                              ) -> TensorboardFormatter:
    if formatter_config is None:
        return TensorboardFormatter()
    cfg = dict(formatter_config)
    cfg.pop("name", None)
    return TensorboardFormatter(**cfg)


class MetricWriter:
    """Scalars → ``metrics.jsonl`` (always) + TensorBoard events (when the
    ``tensorboard`` package imports)."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = None
        try:
            from tensorboard.compat.proto.event_pb2 import Event
            from tensorboard.compat.proto.summary_pb2 import Summary
            from tensorboard.summary.writer.event_file_writer import (
                EventFileWriter,
            )
        except ImportError:
            return
        self._tb = EventFileWriter(log_dir)
        self._Summary = Summary
        self._Event = Event

    def _event(self, value, step: int) -> None:
        self._tb.add_event(self._Event(summary=self._Summary(value=[value]),
                                       step=int(step), wall_time=time.time()))

    def scalar(self, tag: str, value: float, step: int):
        self._jsonl.write(json.dumps({"tag": tag, "value": float(value),
                                      "step": int(step),
                                      "time": time.time()}) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            self._event(self._Summary.Value(tag=tag,
                                            simple_value=float(value)), step)

    def scalars(self, logs: Dict[str, float], step: int):
        for k, v in logs.items():
            if isinstance(v, (int, float, np.floating, np.integer)):
                self.scalar(k, float(v), step)

    def image(self, tag: str, img: np.ndarray, step: int):
        """The JSONL file records the image's mean; TensorBoard gets the
        panel as a grey or RGB PNG."""
        self.scalar(f"{tag}/mean", float(np.mean(img)), step)
        if self._tb is None:
            return
        from .utils import png

        arr = np.asarray(img)
        if arr.ndim == 3 and arr.shape[-1] == 1:
            arr = arr[..., 0]
        if arr.dtype != np.uint8:  # formatter output is in [0, 1]
            arr = (np.clip(arr.astype(np.float64), 0.0, 1.0) * 255
                   ).astype(np.uint8)
        image_pb = self._Summary.Image(
            height=int(arr.shape[0]), width=int(arr.shape[1]),
            colorspace=3 if arr.ndim == 3 else 1,
            encoded_image_string=png.encode(arr))
        self._event(self._Summary.Value(tag=tag, image=image_pb), step)

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


class NullMetricWriter:
    """A writer that writes nothing."""

    log_dir = None

    def scalar(self, tag, value, step):
        pass

    def scalars(self, logs, step):
        pass

    def image(self, tag, img, step):
        pass

    def close(self):
        pass

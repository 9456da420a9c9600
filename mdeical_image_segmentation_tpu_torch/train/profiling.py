"""Profiling and tracing (the JAX package's ``train/profiling.py``):

- ``trace(logdir)``: ``torch.profiler`` over the enclosed region, the
  CPU's ops and, on a machine with a card, its kernels, written as a Chrome
  trace (``trace_<pid>.json``, for chrome://tracing or Perfetto) into
  ``logdir``;
- ``ProfiledSection(name)``: a named range in that trace
  (``record_function``) and, on the card, an NVTX range;
- ``StepTimer``: per-step times that do not serialise the device: ``tick``
  after each step is issued, ``synced_lap`` now and then waits for the
  work issued so far and records the mean ms a step since the last lap.
  On the card it times with CUDA events on the current stream, on the CPU
  with the host clock;
- ``device_memory_summary()``: the allocator's bytes in use, peak and the
  card's total, per card (``torch.cuda.memory_stats``).

The 2D trainer traces steps ``profile_start_step`` to ``+
profile_num_steps`` when ``TrainingArguments.profile_dir`` is set.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir: str):
    """``torch.profiler`` over the enclosed region; the Chrome trace is
    written into ``logdir`` when it ends."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(logdir,
                                          f"trace_{os.getpid()}.json"))


class ProfiledSection:
    """A named range: ``with ProfiledSection("forward"): ...``."""

    def __init__(self, name: str):
        self.name = name
        self._record = torch.profiler.record_function(name)

    def __enter__(self):
        self._record.__enter__()
        if torch.cuda.is_available():
            torch.cuda.nvtx.range_push(self.name)
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_available():
            torch.cuda.nvtx.range_pop()
        return self._record.__exit__(*exc)


class StepTimer:
    """Step timing that keeps the device busy.

    Per step::

        timer.tick()            # right after issuing the step
        ...
        timer.synced_lap()      # now and then: waits, records

    ``tick`` alone notes issue-to-issue intervals on the host;
    ``synced_lap`` waits for the work issued so far and gives the mean ms
    a step over the steps since the last lap: on the card the CUDA-event
    time between the two points of the stream, on the CPU the host clock.
    ``device`` is the card by default (an error without one), ``"cpu"``
    when asked.
    """

    def __init__(self, window: int = 1000,
                 device: Union[str, torch.device] = "cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("StepTimer(device='cuda') needs a CUDA card; "
                               "pass device='cpu' on the CPU")
        self.window = window
        self._ticks: List[float] = []
        self._last_sync = None  # a CUDA event on the card, else a time
        self._synced_steps = 0
        self.synced_ms: List[float] = []

    def _mark(self):
        if self.device.type == "cuda":
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            return event
        return time.perf_counter()

    def tick(self):
        self._ticks.append(time.perf_counter())
        if len(self._ticks) > self.window:
            self._ticks = self._ticks[-self.window:]
        if self._last_sync is None:
            self._last_sync = self._mark()
            self._synced_steps = 0
        self._synced_steps += 1

    def synced_lap(self, value: Optional[Any] = None) -> Optional[float]:
        """Wait for the work issued so far; the mean ms a step since the
        last lap (None at the first).  ``value`` is accepted for the JAX
        package's signature: the stream, not one tensor, is waited for."""
        now = self._mark()
        if self.device.type == "cuda":
            now.synchronize()
        if self._last_sync is None or self._synced_steps == 0:
            self._last_sync = now
            return None
        elapsed = (self._last_sync.elapsed_time(now)
                   if self.device.type == "cuda"
                   else (now - self._last_sync) * 1e3)
        ms = elapsed / self._synced_steps
        self.synced_ms.append(ms)
        if len(self.synced_ms) > self.window:
            self.synced_ms = self.synced_ms[-self.window:]
        self._last_sync = now
        self._synced_steps = 0
        return ms

    def summary(self) -> Dict[str, float]:
        if not self.synced_ms:
            return {}
        arr = np.asarray(self.synced_ms)
        return {
            "ms_per_step_mean": float(arr.mean()),
            "ms_per_step_p50": float(np.percentile(arr, 50)),
            "ms_per_step_p90": float(np.percentile(arr, 90)),
        }


def device_memory_summary() -> List[Dict[str, Any]]:
    """Per card: the caching allocator's bytes in use and their peak, and
    the card's memory; an empty list on a machine without a card."""
    out = []
    for i in range(torch.cuda.device_count() if torch.cuda.is_available()
                   else 0):
        stats = torch.cuda.memory_stats(i)
        out.append({
            "device": f"cuda:{i}",
            "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        })
    return out

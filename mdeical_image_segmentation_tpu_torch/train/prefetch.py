"""Host batches onto the device one batch ahead, for both trainers.

A batch is a tuple or a dict of numpy arrays (``None`` entries pass
through).  On a CUDA device batch k + 1 is copied from pinned memory on a
side stream before batch k is handed out; the consumer's stream waits for
the copy's event, and each tensor is recorded on that stream so the
allocator does not reuse its memory early.  On the CPU the arrays become
tensors in place.
"""

from __future__ import annotations

from typing import Any, Iterable, Iterator, Optional

import numpy as np
import torch


def _map(batch, fn):
    if isinstance(batch, dict):
        return {k: fn(v) for k, v in batch.items()}
    return tuple(fn(v) for v in batch)


def _values(batch):
    return batch.values() if isinstance(batch, dict) else batch


def _to_device(batch, device: torch.device,
               stream: Optional["torch.cuda.Stream"]):
    if stream is None:
        return _map(batch, lambda a: None if a is None else
                    torch.as_tensor(np.asarray(a), device=device)), None
    with torch.cuda.stream(stream):
        out = _map(batch, lambda a: None if a is None else
                   torch.from_numpy(np.ascontiguousarray(a)).pin_memory().to(
                       device, non_blocking=True))
        done = torch.cuda.Event()
        done.record(stream)
    return out, done


def _ready(batch, done: Optional["torch.cuda.Event"], device: torch.device):
    if done is not None:
        current = torch.cuda.current_stream(device)
        current.wait_event(done)
        for t in _values(batch):
            if t is not None:
                t.record_stream(current)
    return batch


def device_batches(batches: Iterable[Any], device: torch.device,
                   stream: Optional["torch.cuda.Stream"] = None
                   ) -> Iterator[Any]:
    """Yield ``batches`` on ``device``, each copy issued one batch ahead on
    ``stream`` (a CUDA side stream; ``None`` on the CPU)."""
    pending = None
    for batch in batches:
        nxt = _to_device(batch, device, stream)
        if pending is not None:
            yield _ready(*pending, device)
        pending = nxt
    if pending is not None:
        yield _ready(*pending, device)

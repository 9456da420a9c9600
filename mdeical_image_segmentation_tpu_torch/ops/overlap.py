"""Overlap-add of patch predictions into running sum and count maps, for
sliding-window inference (the JAX package's ``ops/overlap.py``).

``overlap_add_into(acc, cnt, patches, starts, valid)`` adds each patch i,
weighted by ``valid[i]``, at its (z, y, x) start into the (D, H, W, C) sum
map and adds ``valid[i]`` to the same region of the count map; ``valid``
masks the padded entries of a tail batch, so batch shapes stay fixed.  The
maps are float32 whatever the patches' dtype (a bf16 or uint8 count stops
resolving integers past 256 overlaps) and are updated IN PLACE (the port
keeps one pair of maps per volume instead of a new pair per batch); the
function returns them.

Dispatch is by the device of ``acc`` alone: a CUDA tensor launches the
kernel in ``csrc/overlap_add.cu`` (or raises), a CPU tensor runs the plain
sequential version.  ``patches`` may be any strided view (the predictor
passes the halo-stripped network output, read in place).  ``starts`` and
``valid`` are small host-side arrays (numpy, or CPU tensors); the wrapper
reads them on the host to find each launch's bounding box and hands them to
the kernel by value, so it copies nothing to the device and never waits for
it.  It launches once per ``CHUNK`` patches, in patch order;
``overlap_add_into.launches`` counts the launches, and
``.launches_by_dtype`` splits them by the patches' dtype.
"""

from __future__ import annotations

import collections
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_PATCHES = 1024  # patches per call
CHUNK = 128         # patches per launch: the kernel's parameter table


def _host(starts, valid, p: int) -> Tuple[np.ndarray, np.ndarray]:
    if isinstance(starts, torch.Tensor):
        starts = starts.detach().cpu().numpy()
    starts = np.ascontiguousarray(starts, dtype=np.int32).reshape(-1, 3)
    if valid is None:
        valid = np.ones((p,), np.float32)
    elif isinstance(valid, torch.Tensor):
        valid = valid.detach().cpu().float().numpy()
    valid = np.ascontiguousarray(valid, dtype=np.float32).reshape(-1)
    if starts.shape[0] != p or valid.shape[0] != p:
        raise ValueError(f"{p} patches but starts {starts.shape} and valid "
                         f"{valid.shape}")
    return starts, valid


def _check_bounds(acc, patches, starts) -> None:
    vol = np.asarray(acc.shape[:3])
    ext = np.asarray(patches.shape[1:4])
    if (starts < 0).any() or (starts + ext > vol).any():
        raise ValueError(f"a patch of {tuple(ext)} at starts {starts.tolist()} "
                         f"leaves the volume {tuple(vol)}")


def overlap_add_into_reference(acc: torch.Tensor, cnt: torch.Tensor,
                               patches: torch.Tensor, starts, valid=None,
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential ``acc[region] += w·patch``, ``cnt[region] += w`` in patch
    order, fp32, in place."""
    p, pd, ph, pw, _ = patches.shape
    starts, valid = _host(starts, valid, p)
    _check_bounds(acc, patches, starts)
    for i in range(p):
        z, y, x = (int(v) for v in starts[i])
        w = torch.tensor(valid[i], dtype=torch.float32, device=acc.device)
        region = (slice(z, z + pd), slice(y, y + ph), slice(x, x + pw))
        acc[region] += patches[i].float() * w
        cnt[region] += w
    return acc, cnt


def overlap_add_into(acc: torch.Tensor, cnt: torch.Tensor,
                     patches: torch.Tensor, starts, valid=None,
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """acc, cnt (D, H, W, C) float32; patches (P, pd, ph, pw, C) float32 or
    bfloat16; starts (P, 3) ints; valid (P,) weights (None: all 1).  Updates
    acc and cnt in place and returns them."""
    if acc.device.type == "cpu":
        return overlap_add_into_reference(acc, cnt, patches, starts, valid)
    if not acc.is_cuda:
        raise ValueError(f"overlap_add_into runs on cuda or cpu, "
                         f"not {acc.device}")
    if acc.ndim != 4 or patches.ndim != 5 or cnt.shape != acc.shape:
        raise ValueError(f"acc/cnt (D, H, W, C) and patches (P, pd, ph, pw, "
                         f"C) expected, got {tuple(acc.shape)}, "
                         f"{tuple(cnt.shape)}, {tuple(patches.shape)}")
    for name, t in (("acc", acc), ("cnt", cnt)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError(f"{name} must be contiguous float32")
        if t.device != acc.device:
            raise ValueError(f"{name} is on {t.device}, acc on {acc.device}")
    if patches.device != acc.device:
        raise ValueError(f"patches must be on {acc.device}")
    if patches.dtype not in _DTYPE_CODES:
        raise TypeError(f"patches must be float32 or bfloat16, "
                        f"got {patches.dtype}")
    p, pd, ph, pw, c = patches.shape
    if c != acc.shape[-1] or not 0 < p <= MAX_PATCHES:
        raise ValueError(f"{p} patches of {c} channels for maps of "
                         f"{acc.shape[-1]} (at most {MAX_PATCHES} patches)")
    starts, valid = _host(starts, valid, p)
    _check_bounds(acc, patches, starts)
    ext = np.asarray([pd, ph, pw])
    d, h, w = acc.shape[:3]
    strides = patches.stride()
    step = strides[0] * patches.element_size()
    dev = acc.get_device()
    fn = _build.kernel("tpuseg_overlap_add")
    stream = _build.current_stream(dev)
    for i in range(0, p, CHUNK):
        st, wt = starts[i:i + CHUNK], valid[i:i + CHUNK]
        lo = st.min(axis=0)
        box = (st + ext).max(axis=0) - lo
        rc = fn(acc.data_ptr(), cnt.data_ptr(), patches.data_ptr() + i * step,
                st.ctypes.data, wt.ctypes.data, len(st), pd, ph, pw, c,
                *strides, d, h, w, *lo.tolist(), *box.tolist(),
                _DTYPE_CODES[patches.dtype], dev, stream)
        _build.check(rc, "overlap_add launch")
        overlap_add_into.launches += 1
        overlap_add_into.launches_by_dtype[patches.dtype] += 1
    return acc, cnt


overlap_add_into.launches = 0
overlap_add_into.launches_by_dtype = collections.Counter()


def overlap_add(patches: torch.Tensor, starts,
                volume_shape: Sequence[int],
                valid: Optional[Sequence[float]] = None,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Accumulate a patch set into fresh zero float32 maps (the patches may
    stay bf16; the adds upcast)."""
    c = patches.shape[-1]
    shape = (*tuple(volume_shape), c)
    acc = torch.zeros(shape, dtype=torch.float32, device=patches.device)
    cnt = torch.zeros(shape, dtype=torch.float32, device=patches.device)
    return overlap_add_into(acc, cnt, patches, starts, valid)

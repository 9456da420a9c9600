"""zarr v2 arrays to numpy, for the orbax checkpoint reader: orbax stores
each leaf of a checkpoint as a zarr v2 array, in an OCDBT database
(``utils/ocdbt.py``) or in a directory of its own.

An array ``<path>`` is the JSON ``<path>/.zarray`` (``shape``, ``chunks``,
``dtype``, ``compressor``, ``fill_value``, ``order``, ``filters``,
``dimension_separator``) and one value per chunk of its grid, under
``<path>/<i>.<j>...`` (``"/"`` joins the indices where the separator says
so; a 0-d array's one chunk is ``<path>/0``).  Every chunk holds a whole
chunk in C order, the chunks at the far edges padded past the array's end;
the padding is cut off here.

Read: the numeric numpy dtypes (``<f4``, ``<f8``, ``<i4``, ``<i8``,
``|b1`` and the others of kinds b, i, u, f, c), ``zstd`` or no compressor,
C order, no filters.  A missing chunk is filled with ``fill_value``, and
raises where that is null (orbax writes every chunk).  Another compressor,
a filter, F order or another dtype (``bfloat16``, which no trainer of the
JAX package writes, strings, records) raises ``ZarrError`` naming ROADMAP
item 19b.
"""

from __future__ import annotations

import itertools
import json
import math
from typing import Callable, Optional

import numpy as np

from . import zstd

ITEM = "ROADMAP item 19b"


class ZarrError(ValueError):
    pass


def _dtype(spec, path: str) -> np.dtype:
    try:
        dtype = np.dtype(spec) if isinstance(spec, str) else None
    except TypeError:
        dtype = None
    if dtype is None or dtype.kind not in "biufc" or dtype.fields:
        raise ZarrError(f"'{path}': dtype {spec!r} is not read ({ITEM})")
    return dtype


def _fill(value, dtype: np.dtype):
    if isinstance(value, str):  # "NaN", "Infinity", "-Infinity"
        value = float(value.replace("Infinity", "inf"))
    return np.asarray(value).astype(dtype)


def read_array(get: Callable[[str], Optional[bytes]], path: str) -> np.ndarray:
    """The array at ``path``; ``get(key)`` gives the bytes stored under a
    key, or None where there are none."""
    raw = get(f"{path}/.zarray")
    if raw is None:
        raise ZarrError(f"no zarr array at '{path}' (no .zarray)")
    meta = json.loads(raw)
    if meta.get("zarr_format") != 2:
        raise ZarrError(f"'{path}': zarr_format {meta.get('zarr_format')}, "
                        f"2 is read ({ITEM})")
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(shape) != len(chunks) or any(c < 1 for c in chunks):
        raise ZarrError(f"'{path}': chunks {chunks} for shape {shape}")
    dtype = _dtype(meta["dtype"], path)
    compressor = meta.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise ZarrError(f"'{path}': compressor {compressor.get('id')!r} is "
                        f"not read ({ITEM})")
    if meta.get("filters"):
        raise ZarrError(f"'{path}': filters {meta['filters']} are not read "
                        f"({ITEM})")
    if meta.get("order", "C") != "C":
        raise ZarrError(f"'{path}': order {meta['order']!r} is not read "
                        f"({ITEM})")
    sep = meta.get("dimension_separator", ".")
    if sep not in (".", "/"):
        raise ZarrError(f"'{path}': dimension_separator {sep!r}")
    fill = meta.get("fill_value")
    out = np.empty(shape, dtype)
    chunk_bytes = math.prod(chunks) * dtype.itemsize
    grid = [range(-(-s // c)) for s, c in zip(shape, chunks)]
    for index in itertools.product(*grid):
        key = f"{path}/{sep.join(map(str, index)) if index else '0'}"
        where = tuple(slice(i * c, min((i + 1) * c, s))
                      for i, c, s in zip(index, chunks, shape))
        data = get(key)
        if data is None:
            if fill is None:
                raise ZarrError(f"'{key}': missing chunk and no fill_value "
                                f"({ITEM})")
            out[where] = _fill(fill, dtype)
            continue
        if compressor is not None:
            try:
                data = zstd.decompress(data)
            except ValueError as e:
                raise ZarrError(f"'{key}': {e}") from None
        if len(data) != chunk_bytes:
            raise ZarrError(f"'{key}': {len(data)} bytes, a chunk of "
                            f"{chunks} {dtype} is {chunk_bytes}")
        chunk = np.frombuffer(data, dtype).reshape(chunks)
        out[where] = chunk[tuple(slice(0, w.stop - w.start) for w in where)]
    return out

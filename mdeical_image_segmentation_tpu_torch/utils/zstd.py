"""Zstandard decompression for the orbax checkpoint reader: tensorstore
stores OCDBT B-tree nodes and zarr chunks as zstd frames, and neither the
card's machine nor Python's standard library has a zstd module.

The decoder is the host C of ``csrc/zstd_decompress.c`` (RFC 8878's whole
frame format except dictionaries), compiled with the host C compiler at the
first decode and called through ctypes, as ``csrc/lzf_decompress.c`` is
for the HDF5 reader.  ``decompress`` takes one or more frames back to back
(skippable frames are skipped) and raises ``ValueError`` for a corrupt or
truncated frame, a dictionary, a checksum that does not match or an output
that differs from a frame's stated size.
"""

from __future__ import annotations

import ctypes

import numpy as np

MAGIC = b"\x28\xb5\x2f\xfd"

_ERRORS = {
    -1: "the output does not fit its buffer",
    -2: "corrupt or truncated zstd data",
    -3: "a zstd frame that needs a dictionary (dictionaries are not read)",
    -4: "zstd content checksum mismatch",
    -5: "a zstd frame's output differs from its stated content size",
    -6: "not a zstd frame (unknown magic number)",
    -7: "a zstd frame with a reserved bit set",
    -8: "out of memory",
}


def _lib():
    from ..ops import _build

    lib = _build.host_library("zstd_decompress.c")
    if lib.tpuseg_zstd_decompress.restype is not ctypes.c_int64:
        for fn, extra in ((lib.tpuseg_zstd_bound, []),
                          (lib.tpuseg_zstd_decompress,
                           [ctypes.c_void_p, ctypes.c_int64])):
            fn.argtypes = [ctypes.c_char_p, ctypes.c_int64] + extra
            fn.restype = ctypes.c_int64
    return lib


def _check(n: int) -> int:
    if n < 0:
        raise ValueError(_ERRORS.get(n, f"zstd error {n}"))
    return n


def decompress(data: bytes) -> bytes:
    """The content of the zstd frames in ``data``, concatenated."""
    data = bytes(data)
    lib = _lib()
    bound = _check(lib.tpuseg_zstd_bound(data, len(data)))
    out = np.empty(max(bound, 1), np.uint8)
    n = _check(lib.tpuseg_zstd_decompress(data, len(data), out.ctypes.data,
                                          bound))
    return out[:n].tobytes()

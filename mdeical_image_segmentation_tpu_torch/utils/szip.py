"""szip decompression for the HDF5 reader's szip filter (id 4): the card's
machine has no libaec, and the standard library no szip module.

The decoder is the host C of ``csrc/szip_decompress.c`` (CCSDS 121.0-B's
adaptive Rice coder with the NN preprocessor, framed as libaec's szip
interface frames it), compiled with the host C compiler at the first
decode and called through ctypes, as ``csrc/zstd_decompress.c`` is for the
orbax reader.  HDF5's filter stores a chunk as the decoded size (4 bytes,
little-endian) before the coded stream, and keeps the coder's parameters in
the filter's four client values: the options mask (EC or NN, LSB or MSB),
pixels per block, bits per pixel and pixels per scanline.
"""

from __future__ import annotations

import ctypes
import struct
from typing import Sequence

import numpy as np

SZ_EC_OPTION_MASK, SZ_LSB_OPTION_MASK = 4, 8
SZ_MSB_OPTION_MASK, SZ_NN_OPTION_MASK = 16, 32

_ERRORS = {
    -1: "the szip stream ends before the chunk is decoded",
    -2: "corrupt szip data",
    -3: "szip parameters this decoder does not take",
    -4: "out of memory",
}


def _fn():
    from ..ops import _build

    fn = _build.host_library("szip_decompress.c").tpuseg_szip_decompress
    if fn.restype is not ctypes.c_int64:
        fn.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
                       ctypes.c_int64] + [ctypes.c_int32] * 4
        fn.restype = ctypes.c_int64
    return fn


def decode(stream: bytes, out_len: int, mask: int, pixels_per_block: int,
           bits_per_pixel: int, pixels_per_scanline: int) -> bytes:
    """``out_len`` bytes decoded from the coded ``stream``; raises
    ``ValueError`` for a corrupt or short stream."""
    stream = bytes(stream)
    out = np.empty(max(out_len, 1), np.uint8)
    n = _fn()(stream, len(stream), out.ctypes.data, out_len, mask,
              pixels_per_block, bits_per_pixel, pixels_per_scanline)
    if n < 0:
        raise ValueError(_ERRORS.get(n, f"szip error {n}"))
    return out[:out_len].tobytes()


def hdf5_chunk(data: bytes, cd: Sequence[int]) -> bytes:
    """One chunk as HDF5's szip filter stored it (the decoded size, then
    the stream), with the filter's client values ``cd``."""
    if len(data) < 4 or len(cd) < 4:
        raise ValueError("an szip chunk needs its size and 4 client values")
    size = struct.unpack_from("<I", data)[0]
    return decode(memoryview(data)[4:], size, *cd[:4])

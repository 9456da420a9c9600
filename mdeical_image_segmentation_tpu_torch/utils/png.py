"""A PNG codec on the standard library (``zlib``, ``struct``), numpy and a
small C unfilter.

It takes the place of PIL on the serving and 2D data paths, where the JAX
package calls ``Image.open(path).convert("L" | "RGB")`` and
``Image.fromarray(mask).save``, and of imageio on the DSB path
(``data/dsb.py``).

- ``decode``: PNGs of every colour type and bit depth the format allows:
  grey (1, 2, 4, 8, 16 bits), RGB (8, 16), palette (1, 2, 4, 8), grey +
  alpha and RGBA (8, 16), with all five row filters, plain or
  Adam7-interlaced (each of the seven reduced images unfiltered at its own
  width, then scattered onto its grid).  The rows are unfiltered in C
  (``csrc/png_unfilter.c``, built with the host C compiler at the first
  decode and loaded with ctypes; without a compiler the first decode
  raises).
- ``convert``: to "L" or "RGB" exactly as PIL's ``convert`` does on what
  ``Image.open`` gives: L = (R*19595 + G*38470 + B*7471 + 0x8000) >> 16,
  alpha dropped, palette entries looked up first (a tRNS chunk changes
  neither); sub-byte grey scaled to 0..255; 16-bit grey clipped to 255
  (PIL's "I;16"), the other 16-bit types cut to their high byte.
- ``encode``: 8-bit grey (or grey+alpha, RGB, RGBA by channel count), one
  IDAT, filter 0 on every row.

A bit depth the format does not allow for the colour type, an unknown
interlace method, or a broken stream raises ``PngError``, which the server
answers with a 400.
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from dataclasses import dataclass
from typing import Optional

import numpy as np

from .image_base import ImageError, luma, unpack_bits

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}
_COLOUR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}  # channels -> colour type
# Adam7's passes: (first column, first row, column step, row step)
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


class PngError(ImageError):
    """A PNG this codec does not take, or a corrupt one."""


@dataclass
class PngImage:
    # (H, W, channels) samples as stored: uint16 at depth 16, else uint8
    # (sub-byte samples unpacked, unscaled); palette indices for type 3
    pixels: np.ndarray
    colour_type: int
    palette: Optional[np.ndarray] = None  # (256, 3) uint8 for type 3
    depth: int = 8


def _chunks(data: bytes):
    if data[:8] != SIGNATURE:
        raise PngError("not a PNG file (bad signature)")
    pos = 8
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length or pos + 12 + length > len(data):
            raise PngError(f"truncated {ctype!r} chunk")
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(ctype + body) != crc:
            raise PngError(f"CRC mismatch in {ctype!r} chunk")
        yield ctype, body
        if ctype == b"IEND":
            return
        pos += 12 + length
    raise PngError("missing IEND chunk")


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """(h, stride) uint8 rows of the decompressed image data, unfiltered by
    ``csrc/png_unfilter.c``."""
    if len(raw) < h * (stride + 1):
        raise PngError("image data shorter than the header says")
    fn = _unfilter_fn()
    src = np.frombuffer(raw, np.uint8, h * (stride + 1))
    out = np.empty((h, stride), np.uint8)
    bad = fn(src.ctypes.data, out.ctypes.data, h, stride, bpp)
    if bad:
        row = bad - 1
        raise PngError(f"unknown row filter type {raw[row * (stride + 1)]}")
    return out


def _unfilter_fn():
    from ..ops import _build

    fn = _build.host_library("png_unfilter.c").tpuseg_png_unfilter
    if fn.restype is not ctypes.c_int64:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int64] * 3
        fn.restype = ctypes.c_int64
    return fn


def _samples(rows: np.ndarray, h: int, w: int, ch: int, depth: int
             ) -> np.ndarray:
    """(H, W, ch) samples of unfiltered rows: big-endian uint16 at depth 16,
    sub-byte samples unpacked (the last byte of a row may be padding)."""
    if depth == 8:
        return rows.reshape(h, w, ch)
    if depth == 16:
        return rows.view(">u2").astype(np.uint16).reshape(h, w, ch)
    return unpack_bits(rows, depth, w)[..., None]


def decode(data: bytes) -> PngImage:
    """Decode PNG bytes (see the module docstring for what is taken)."""
    header = None
    palette = None
    idat = []
    for ctype, body in _chunks(data):
        if ctype == b"IHDR":
            if len(body) != 13:
                raise PngError("bad IHDR chunk")
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            if len(body) % 3 or len(body) > 768:
                raise PngError("bad PLTE chunk")
            palette = np.zeros((256, 3), np.uint8)
            entries = np.frombuffer(body, np.uint8).reshape(-1, 3)
            palette[:len(entries)] = entries
        elif ctype == b"IDAT":
            idat.append(body)
    if header is None:
        raise PngError("missing IHDR chunk")
    w, h, depth, colour_type, compression, filt, interlace = header
    if colour_type not in _CHANNELS:
        raise PngError(f"unsupported PNG colour type {colour_type}")
    if depth not in _DEPTHS[colour_type]:
        raise PngError(f"bad PNG bit depth {depth} for colour type "
                       f"{colour_type}")
    if interlace not in (0, 1):
        raise PngError(f"unknown PNG interlace method {interlace}")
    if compression != 0 or filt != 0:
        raise PngError("unknown PNG compression or filter method")
    if colour_type == 3 and palette is None:
        raise PngError("palette image without a PLTE chunk")
    if w == 0 or h == 0:
        raise PngError("empty PNG image")
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise PngError(f"corrupt image data: {e}") from None
    ch = _CHANNELS[colour_type]
    bits = ch * depth
    bpp = max(bits // 8, 1)
    if interlace == 0:
        rows = _unfilter(raw, h, -(-w * bits // 8), bpp)
        return PngImage(_samples(rows, h, w, ch, depth), colour_type,
                        palette, depth)
    # Adam7: seven reduced images, each unfiltered at its own width and
    # scattered onto its grid
    out = np.empty((h, w, ch), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy in ADAM7:
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw <= 0 or ph <= 0:
            continue
        stride = -(-pw * bits // 8)
        size = ph * (stride + 1)
        if pos + size > len(raw):
            raise PngError("interlaced image data shorter than the header "
                           "says")
        rows = _unfilter(raw[pos:pos + size], ph, stride, bpp)
        out[y0::dy, x0::dx] = _samples(rows, ph, pw, ch, depth)
        pos += size
    return PngImage(out, colour_type, palette, depth)


def _to_8bit(img: PngImage) -> np.ndarray:
    """The samples as PIL's ``Image.open`` holds them in 8 bits: sub-byte
    grey scaled to 0..255, 16-bit grey ("I;16") clipped to 255, the other
    16-bit types cut to the high byte; palette indices as they are."""
    px, ct, depth = img.pixels, img.colour_type, img.depth
    if depth == 16:
        if ct == 0:
            return np.minimum(px, 255).astype(np.uint8)
        return (px >> 8).astype(np.uint8)
    if depth < 8 and ct == 0:
        return px * np.uint8(255 // ((1 << depth) - 1))
    return px


def convert(img: PngImage, mode: str) -> np.ndarray:
    """PIL ``convert(mode)`` for mode "L" (→ (H, W)) or "RGB" (→ (H, W, 3))."""
    px, ct = _to_8bit(img), img.colour_type
    if ct == 3:
        rgb = img.palette[px[..., 0]]
    elif ct in (2, 6):
        rgb = px[..., :3]
    else:  # grey, grey + alpha
        grey = px[..., 0]
        if mode == "L":
            return grey
        if mode == "RGB":
            return np.repeat(grey[..., None], 3, axis=-1)
        raise ValueError(f"convert to {mode!r}: expected 'L' or 'RGB'")
    if mode == "L":
        return luma(rgb)
    if mode == "RGB":
        return np.ascontiguousarray(rgb)
    raise ValueError(f"convert to {mode!r}: expected 'L' or 'RGB'")


def read(path: str, mode: str) -> np.ndarray:
    """Decode the PNG at ``path`` and convert it to ``mode``."""
    with open(path, "rb") as f:
        return convert(decode(f.read()), mode)


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body)))


def encode(arr: np.ndarray) -> bytes:
    """8-bit PNG bytes of a uint8 (H, W) or (H, W, 1..4) array."""
    arr = np.asarray(arr)
    if arr.dtype != np.uint8:
        raise ValueError(f"encode takes uint8, got {arr.dtype}")
    if arr.ndim == 2:
        arr = arr[..., None]
    if arr.ndim != 3 or arr.shape[-1] not in _COLOUR_TYPE:
        raise ValueError(f"encode takes (H, W[, 1..4]), got {arr.shape}")
    h, w, ch = arr.shape
    rows = np.concatenate(
        [np.zeros((h, 1), np.uint8), arr.reshape(h, w * ch)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOUR_TYPE[ch], 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write(path: str, arr: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode(arr))

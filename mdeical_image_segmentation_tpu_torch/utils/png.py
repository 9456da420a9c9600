"""A PNG codec on the standard library (``zlib``, ``struct``) and numpy.

It takes the place of PIL on the serving path, where the JAX package calls
``Image.open(path).convert("L" | "RGB")`` and ``Image.fromarray(mask).save``.

- ``decode``: 8-bit, non-interlaced PNGs of colour types 0 (grey), 2 (RGB),
  3 (palette), 4 (grey + alpha) and 6 (RGBA), with all five row filters.
- ``convert``: to "L" or "RGB" exactly as PIL's ``convert`` does:
  L = (R*19595 + G*38470 + B*7471 + 0x8000) >> 16, alpha dropped, palette
  entries looked up first.
- ``encode``: 8-bit grey (or grey+alpha, RGB, RGBA by channel count), one
  IDAT, filter 0 on every row.

Anything else (16-bit or sub-byte depths, interlacing, a broken stream)
raises ``PngError``, which the server answers with a 400.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass
from typing import Optional

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_COLOUR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}  # channels -> colour type


class PngError(ValueError):
    """A PNG this codec does not take, or a corrupt one."""


@dataclass
class PngImage:
    pixels: np.ndarray        # (H, W, channels) uint8; palette indices for type 3
    colour_type: int
    palette: Optional[np.ndarray] = None  # (256, 3) uint8 for type 3


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


def _unfilter_average(line: bytes, prev: bytes, bpp: int) -> bytearray:
    cur = bytearray(line)
    for i in range(min(bpp, len(cur))):
        cur[i] = (cur[i] + (prev[i] >> 1)) & 0xFF
    for i in range(bpp, len(cur)):
        cur[i] = (cur[i] + ((cur[i - bpp] + prev[i]) >> 1)) & 0xFF
    return cur


def _unfilter_paeth(line: bytes, prev: bytes, bpp: int) -> bytearray:
    cur = bytearray(line)
    for i in range(min(bpp, len(cur))):  # a = c = 0: the predictor is b
        cur[i] = (cur[i] + prev[i]) & 0xFF
    for i in range(bpp, len(cur)):
        a, b, c = cur[i - bpp], prev[i], prev[i - bpp]
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF
    return cur


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    if len(raw) < h * (stride + 1):
        raise PngError("image data shorter than the header says")
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for r in range(h):
        pos = r * (stride + 1)
        ftype = raw[pos]
        line = np.frombuffer(raw, np.uint8, stride, pos + 1)
        if ftype == 0:
            cur = line
        elif ftype == 1:  # Sub: running sum per byte lane, mod 256
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif ftype == 2:  # Up
            cur = line + prev
        elif ftype == 3:
            cur = np.frombuffer(
                _unfilter_average(line.tobytes(), prev.tobytes(), bpp),
                np.uint8)
        elif ftype == 4:
            cur = np.frombuffer(
                _unfilter_paeth(line.tobytes(), prev.tobytes(), bpp),
                np.uint8)
        else:
            raise PngError(f"unknown row filter type {ftype}")
        out[r] = cur
        prev = out[r]
    return out


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
    if depth != 8:
        raise PngError(f"unsupported PNG bit depth {depth}: only 8-bit "
                       "images are taken")
    if interlace != 0:
        raise PngError("interlaced PNGs are not supported")
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
    rows = _unfilter(raw, h, w * ch, ch)
    return PngImage(rows.reshape(h, w, ch), colour_type, palette)


def _luma(rgb: np.ndarray) -> np.ndarray:
    r, g, b = (rgb[..., i].astype(np.uint32) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(np.uint8)


def convert(img: PngImage, mode: str) -> np.ndarray:
    """PIL ``convert(mode)`` for mode "L" (→ (H, W)) or "RGB" (→ (H, W, 3))."""
    px, ct = img.pixels, img.colour_type
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
        return _luma(rgb)
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

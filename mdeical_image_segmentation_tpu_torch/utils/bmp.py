"""A BMP decoder on numpy: the image as PIL's ``Image.open`` holds it
(imageio's pillow plugin reads the same).

- Headers: BITMAPCOREHEADER (12 bytes, 3-byte palette entries) and the
  INFO family (40, 52, 56, 64, 108 = V4, 124 = V5), the bit masks of
  BI_BITFIELDS after a 40-byte header or inside a longer one.
- Pixels: 1-, 4- and 8-bit palette ("P"; "1" for the black-and-white pair,
  "L" for an 8-bit identity grey palette, as PIL's grey check gives), 16-bit
  5-5-5 (BI_RGB) and 5-6-5 or 5-5-5 bit fields (each channel c * 255 //
  max), 24-bit, 32-bit BI_RGB (the fourth byte dropped) and the 32-bit
  bit-field layouts PIL takes ("RGBA" where the alpha mask is set).
- RLE8 and RLE4 as PIL's decoder reads them: runs clipped to the row, end
  of line padding the row with index 0, absolute runs aligned to a 16-bit
  word of the file, and a delta escape reading four bytes of which the last
  two are its (right, up).
- Rows bottom-up (a positive height) or top-down, each padded to 4 bytes.
"""

from __future__ import annotations

import struct

import numpy as np

from .image_base import (Decoded, ImageError, palette256, refused,
                         unpack_bits)

SIGNATURE = b"BM"
_BITFIELDS = {  # PIL's bit-field layouts: (bits, masks) → channel order
    (32, (0xFF0000, 0xFF00, 0xFF, 0x0)): "BGRX",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0x0)): "XBGR",
    (32, (0xFF000000, 0xFF00, 0xFF, 0x0)): "BGXR",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)): "ABGR",
    (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)): "RGBA",
    (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)): "BGRA",
    (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)): "BGAR",
    (32, (0x0, 0x0, 0x0, 0x0)): "BGRA",
    (24, (0xFF0000, 0xFF00, 0xFF)): "BGR",
    (16, (0xF800, 0x7E0, 0x1F)): "BGR;16",
    (16, (0x7C00, 0x3E0, 0x1F)): "BGR;15",
}


def _rle(data: bytes, pos: int, w: int, h: int, rle4: bool) -> np.ndarray:
    """(h, w) indices in file row order, PIL's ``BmpRleDecoder``."""
    out = bytearray()
    x, total, n = 0, w * h, len(data)
    while len(out) < total and pos + 1 < n:
        count, byte = data[pos], data[pos + 1]
        pos += 2
        if count:  # a run, clipped to the row
            count = max(0, min(count, w - x))
            if rle4:
                pair = (byte >> 4, byte & 15)
                out += bytes(pair[i % 2] for i in range(count))
            else:
                out += bytes([byte]) * count
            x += count
        elif byte == 0:  # end of line
            out += bytes(-len(out) % w)
            x = 0
        elif byte == 1:  # end of bitmap
            break
        elif byte == 2:  # delta: PIL reads two bytes, then (right, up)
            if pos + 4 > n:
                break
            right, up = data[pos + 2], data[pos + 3]
            pos += 4
            out += bytes(right + up * w)
            x = len(out) % w
        else:  # an absolute run of `byte` pixels
            nbytes = byte // 2 if rle4 else byte
            run = data[pos:pos + nbytes]
            pos += len(run)
            if rle4:
                out += bytes(v for b in run for v in (b >> 4, b & 15))
            else:
                out += run
            if len(run) < nbytes:
                break
            x += byte
            if pos % 2:
                pos += 1
    if len(out) < total:
        raise ImageError("BMP RLE data ends before the image does")
    return np.frombuffer(bytes(out[:total]), np.uint8).reshape(h, w)


def _scale(v: np.ndarray, bits: int) -> np.ndarray:
    return (v.astype(np.uint32) * 255 // ((1 << bits) - 1)).astype(np.uint8)


def _packed(rows: np.ndarray, layout: str, w: int) -> np.ndarray:
    """(h, w, 3 or 4) uint8 of rows of packed pixels in PIL's raw
    ``layout``."""
    h = rows.shape[0]
    if layout in ("BGR;15", "BGR;16"):
        v = rows[:, :2 * w].reshape(h, w, 2).astype(np.uint16)
        v = v[..., 0] | (v[..., 1] << 8)
        g_bits = 6 if layout == "BGR;16" else 5
        r = _scale(v >> (5 + g_bits), 5)
        g = _scale((v >> 5) & ((1 << g_bits) - 1), g_bits)
        b = _scale(v & 31, 5)
        return np.stack([r, g, b], axis=-1)
    n = 3 if layout == "BGR" else 4
    px = rows[:, :n * w].reshape(h, w, n)
    idx = [layout.index(c) for c in ("RGBA" if "A" in layout else "RGB")]
    return np.ascontiguousarray(px[..., idx])


def decode(data: bytes) -> Decoded:
    if data[:2] != SIGNATURE or len(data) < 26:
        raise ImageError("not a BMP file (bad signature)")
    (offset,) = struct.unpack_from("<I", data, 10)
    (hsize,) = struct.unpack_from("<I", data, 14)
    pos = 18
    if hsize == 12:
        w, h, _, bits = struct.unpack_from("<HHHH", data, pos)
        compression, colors, entry = 0, 0, 3
        top_down = False
    elif hsize in (40, 52, 56, 64, 108, 124):
        w, h_raw, _, bits, compression = struct.unpack_from("<iIHHI", data,
                                                            pos)
        (colors,) = struct.unpack_from("<I", data, pos + 28)
        top_down = data[pos + 7] == 0xFF
        h = 2 ** 32 - h_raw if top_down else h_raw
        entry = 4
    else:
        raise refused(f"BMP header of {hsize} bytes")
    pos = 14 + hsize
    masks = ()
    if hsize != 12 and compression == 3:
        if hsize >= 56:
            masks = struct.unpack_from("<IIII", data, 54)
        elif hsize == 52:
            masks = struct.unpack_from("<III", data, 54) + (0,)
        else:  # three masks after a 40-byte header
            masks = struct.unpack_from("<III", data, pos) + (0,)
            pos += 12
    colors = colors or (1 << bits)
    if offset == 14 + hsize and bits <= 8:
        offset += 4 * colors
    if w <= 0 or h <= 0 or h > 1 << 16:
        raise ImageError(f"BMP of {w} x {h} pixels")
    stride = ((w * bits + 31) >> 3) & ~3

    if bits in (1, 4, 8):
        if not 0 < colors <= 65536:
            raise ImageError(f"BMP palette of {colors} entries")
        raw = np.frombuffer(data[pos:pos + entry * colors], np.uint8)
        if raw.size != entry * colors:
            raise ImageError("truncated BMP palette")
        pal = raw.reshape(colors, entry)[:, 2::-1]  # BGR(X) → RGB
        want = (np.array([0, 255]) if colors == 2
                else np.arange(colors) % 256)
        grey = bool((pal == want[:, None]).all())
        mode = ("1" if colors == 2 else "L") if grey else "P"
        if mode != "P" and bits != (1 if mode == "1" else 8):
            raise refused(f"{bits}-bit BMP with a {colors}-entry grey "
                          "palette")
        if compression in (1, 2):
            if (compression == 1) != (bits == 8) or mode == "1":
                raise refused(f"BMP RLE{4 * (3 - compression)} at {bits} "
                              "bits")
            idx = _rle(data, offset, w, h, compression == 2)
        elif compression == 0:
            if len(data) < offset + stride * h:
                raise ImageError("truncated BMP pixel data")
            rows = np.frombuffer(data, np.uint8, stride * h, offset).reshape(
                h, stride)
            idx = unpack_bits(rows, bits, w) if bits < 8 else rows[:, :w]
        else:
            raise refused(f"BMP compression {compression} at {bits} bits")
        if not top_down:
            idx = idx[::-1]
        idx = np.ascontiguousarray(idx)
        if mode == "1":
            return Decoded("1", idx != 0)
        if mode == "L":
            return Decoded("L", idx)
        return Decoded("P", idx, palette256(pal))

    if compression == 3:
        key = (bits, masks if bits == 32 else masks[:3])
        layout = _BITFIELDS.get(key)
        if layout is None:
            raise refused(f"BMP bit fields {masks} at {bits} bits")
    elif compression == 0 and bits in (16, 24, 32):
        layout = {16: "BGR;15", 24: "BGR", 32: "BGRX"}[bits]
    else:
        raise refused(f"BMP compression {compression} at {bits} bits")
    if len(data) < offset + stride * h:
        raise ImageError("truncated BMP pixel data")
    rows = np.frombuffer(data, np.uint8, stride * h, offset).reshape(h, stride)
    px = _packed(rows, layout, w)
    if not top_down:
        px = px[::-1]
    px = np.ascontiguousarray(px)
    return Decoded("RGBA" if px.shape[-1] == 4 else "RGB", px)

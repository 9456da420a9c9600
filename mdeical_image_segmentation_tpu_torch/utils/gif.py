"""A GIF decoder on numpy and the host C of ``csrc/lzw_decode.c``: the first
image of the stream as PIL's ``Image.open`` holds it (imageio's pillow
plugin reads the same frame).

- The colour table is the image's local one, else the global one; a table
  whose entry i is (i, i, i) throughout is no palette (PIL's
  ``_is_palette_needed``), so the image opens as "L" and its indices are
  its grey (a global table stays beside such a local one, and PIL's
  ``convert("RGB")`` applies it).  No table at all is "L" too.  Otherwise the mode is "P", the
  palette padded with black to 256 entries.
- LZW: LSB-first codes over the concatenated sub-blocks, widening to 12
  bits, clear and end codes, a full table kept until the next clear, the
  KwKwK case (``csrc/lzw_decode.c``).
- The 4-pass interlace (rows 0, 8, ...; 4, 12, ...; 2, 6, ...; 1, 3, ...).
- The canvas is the logical screen, grown to hold an image placed past its
  edge; outside the image it holds the Graphic Control Extension's
  transparency index if there is one, else 0.
"""

from __future__ import annotations

import numpy as np

from .image_base import Decoded, ImageError, gif_lzw_decode, palette256

SIGNATURES = (b"GIF87a", b"GIF89a")


def _table(data: bytes, pos: int, bits: int):
    """(the colour table of 2^bits entries or None if it is the identity
    grey, the position after it)."""
    n = 3 << bits
    raw = data[pos:pos + n]
    if len(raw) != n:
        raise ImageError("truncated GIF colour table")
    entries = np.frombuffer(raw, np.uint8).reshape(-1, 3)
    grey = np.arange(len(entries)) % 256
    identity = bool((entries == grey[:, None]).all())
    return (None if identity else palette256(entries)), pos + n


def _sub_blocks(data: bytes, pos: int):
    """(the concatenated sub-blocks at ``pos``, the position after the
    terminator)."""
    parts = []
    while True:
        if pos >= len(data):
            raise ImageError("truncated GIF data")
        n = data[pos]
        pos += 1
        if n == 0:
            return b"".join(parts), pos
        parts.append(data[pos:pos + n])
        pos += n


def _interlaced_rows(h: int) -> np.ndarray:
    return np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8),
                           np.arange(2, h, 4), np.arange(1, h, 2)])


def decode(data: bytes) -> Decoded:
    if data[:6] not in SIGNATURES or len(data) < 13:
        raise ImageError("not a GIF file (bad signature)")
    sw, sh = int.from_bytes(data[6:8], "little"), int.from_bytes(data[8:10],
                                                                  "little")
    flags = data[10]
    pos = 13
    global_palette = None
    if flags & 0x80:
        global_palette, pos = _table(data, pos, (flags & 7) + 1)
    transparency = None
    while True:
        if pos >= len(data) or data[pos] == 0x3B:
            raise ImageError("GIF without an image")
        block = data[pos]
        pos += 1
        if block == 0x21:  # an extension: its label, then sub-blocks
            label = data[pos]
            body, pos = _sub_blocks(data, pos + 1)
            if label == 0xF9 and len(body) >= 4 and body[0] & 1:
                transparency = body[3]
            continue
        if block != 0x2C:
            raise ImageError(f"unknown GIF block 0x{block:02x}")
        x0, y0, w, h = np.frombuffer(data[pos:pos + 8], "<u2").astype(int)
        iflags = data[pos + 8]
        pos += 9
        palette = kept = global_palette
        if iflags & 0x80:
            palette, pos = _table(data, pos, (iflags & 7) + 1)
        min_code_size = data[pos]
        lzw, pos = _sub_blocks(data, pos + 1)
        break
    size = (max(sh, y0 + h), max(sw, x0 + w))
    indices = np.frombuffer(gif_lzw_decode(lzw, min_code_size, w * h),
                            np.uint8)
    if indices.size < w * h:
        raise ImageError(f"GIF image data ends after {indices.size} of "
                         f"{w * h} pixels")
    frame = indices.reshape(h, w)
    if iflags & 0x40:
        unlaced = np.empty_like(frame)
        unlaced[_interlaced_rows(h)] = frame
        frame = unlaced
    canvas = np.full(size, 0 if transparency is None else transparency,
                     np.uint8)
    canvas[y0:y0 + h, x0:x0 + w] = frame
    if palette is None:  # PIL's "L" keeps the global table beside it
        return Decoded("L", canvas, kept)
    return Decoded("P", canvas, palette)

"""A TIFF decoder on the standard library (``struct``, ``zlib``), numpy and
the host C of ``csrc/lzw_decode.c``.

It gives the two readings the JAX package makes of a TIFF:

- ``decode``: what PIL's ``Image.open`` holds (``utils/image.py`` converts
  it as ``convert("L" | "RGB")`` does).  IFD 0 only.  PIL's mode follows its
  table of (byte order, photometric, sample format, bits, extra samples):
  MinIsWhite grey of 1-8 bits inverted (not at 16 bits), 2- and 4-bit grey
  scaled to 0..255, a palette's 16-bit ColorMap entries cut to their high
  byte, 16-bit colour cut to its high byte, associated alpha ("RGBa")
  un-premultiplied.  The predictor is undone only for LZW and deflate
  (libtiff's codecs that carry one), and the Orientation tag is applied
  (PIL's TIFF loader transposes by it).  Big-endian compressed float32 comes
  out byte-swapped, as PIL's unpacker leaves libtiff's native-order output;
  big-endian BigTIFF is refused, as PIL does not open it.
- ``imread``: what ``imageio.imread(path)`` gives for a ``.tif`` path, where
  imageio reads with its vendored tifffile: the samples as stored (no
  inversion, palette indices, 16 bits kept, 1 bit as bool), planar images as
  (S, H, W), the predictor undone for every codec, no orientation, and the
  first series: every page whose shape equals IFD 0's, stacked on a new
  first axis when there is more than one.

Containers: both byte orders, classic TIFF and BigTIFF, strips (the last one
short) and tiles, PlanarConfiguration 1 and 2.  Compression 1 (none), 5 (LZW,
MSB-first with early change), 8 and 32946 (deflate) and 32773 (PackBits);
predictor 1 and 2 (at 8 and 16 bits, wrapping).  Photometric 0, 1, 2 and 3;
1-, 2-, 4-, 8- and 16-bit grey, 8- and 16-bit RGB with their extra samples,
float32 grey.  Everything else (CCITT, JPEG and the other codecs, predictor
3, photometric other than 0-3 (YCbCr, CMYK, ...), FillOrder 2, old-style
LZW, signed or other sample types, series metadata of tifffile, ImageJ or
OME) raises ``ImageError`` naming ROADMAP item 20c, in both readings.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

from .image_base import (Decoded, ImageError, packbits_decode, palette256,
                         refused, tiff_lzw_decode, unpack_bits,
                         unpremultiply)

SIGNATURES = (b"II*\0", b"MM\0*", b"II+\0", b"MM\0+")
# none, LZW, deflate (two codes), PackBits
CODECS = frozenset({1, 5, 8, 32946, 32773})
_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 5: "II", 6: "b", 7: "B", 8: "h",
          9: "i", 10: "ii", 11: "f", 12: "d", 13: "I", 16: "Q", 17: "q",
          18: "Q"}
# PIL's extra-sample layouts it opens: 8-bit and 16-bit RGB
_RGB_EXTRA = {8: {(), (0,), (0, 0), (0, 0, 0), (1,), (1, 0), (1, 0, 0),
                  (2,), (2, 0), (2, 0, 0)},
              16: {(), (0,), (1,), (2,)}}


@dataclass
class Page:
    order: str
    tags: Dict[int, Tuple] = field(default_factory=dict)

    def get(self, tag: int, default=None):
        v = self.tags.get(tag)
        return default if v is None else v

    def one(self, tag: int, default=None):
        v = self.tags.get(tag)
        return default if v is None else v[0]

    @property
    def size(self) -> Tuple[int, int]:
        return self.one(257), self.one(256)

    @property
    def spp(self) -> int:
        return self.one(277, 1)

    @property
    def bits(self) -> Tuple[int, ...]:
        bits = tuple(self.get(258, (1,)))
        if len(bits) == 1 and self.spp > 1:
            bits *= self.spp
        return bits[:self.spp]

    @property
    def planar(self) -> int:
        return self.one(284, 1)

    @property
    def compression(self) -> int:
        return self.one(259, 1)


def _parse(data: bytes) -> Tuple[bool, List[Page]]:
    """(BigTIFF?, the chain of IFDs) of TIFF bytes."""
    if data[:4] not in SIGNATURES:
        raise ImageError("not a TIFF file (bad signature)")
    o = "<" if data[:2] == b"II" else ">"
    big = data[2:4] in (b"+\0", b"\0+")
    if big:
        head = struct.unpack_from(o + "HHQ", data, 4)
        if head[:2] != (8, 0):
            raise ImageError("bad BigTIFF header")
        at, count_fmt, entry, off_fmt, inline = head[2], "Q", "HHQ", "Q", 8
    else:
        at = struct.unpack_from(o + "I", data, 4)[0]
        count_fmt, entry, off_fmt, inline = "H", "HHI", "I", 4
    pages, seen = [], set()
    try:
        while at and at not in seen:
            seen.add(at)
            (n,) = struct.unpack_from(o + count_fmt, data, at)
            pos = at + struct.calcsize(o + count_fmt)
            page = Page(o)
            for _ in range(n):
                tag, typ, count = struct.unpack_from(o + entry, data, pos)
                pos += struct.calcsize(o + entry)
                fmt = _TYPES.get(typ)
                if fmt is not None:
                    size = struct.calcsize(o + fmt) * count
                    if size <= inline:
                        where = pos
                    else:
                        (where,) = struct.unpack_from(o + off_fmt, data, pos)
                    if typ == 2:
                        page.tags[tag] = (bytes(data[where:where + count]),)
                    else:
                        page.tags[tag] = struct.unpack_from(
                            o + fmt * count, data, where)
                pos += inline
            pages.append(page)
            (at,) = struct.unpack_from(o + off_fmt, data, pos)
    except struct.error:
        raise ImageError("truncated TIFF directory") from None
    if not pages:
        raise ImageError("TIFF without an image directory")
    return big, pages


def _check_codec(page: Page) -> None:
    if page.compression not in CODECS:
        raise refused(f"TIFF compression {page.compression}")
    if page.one(266, 1) != 1:
        raise refused("TIFF FillOrder 2")
    predictor = page.one(317, 1)
    if predictor not in (1, 2):
        raise refused(f"TIFF predictor {predictor}")
    if predictor == 2 and page.bits[0] not in (8, 16):
        raise refused(f"TIFF predictor 2 on {page.bits[0]}-bit samples")


def _dtype(page: Page) -> np.dtype:
    """tifffile's sample dtype; every sample alike."""
    bits = page.bits
    fmts = set(page.get(339, (1,))[:page.spp])
    if len(set(bits)) != 1 or len(fmts) != 1:
        raise refused(f"TIFF samples of mixed types ({bits}, {fmts})")
    b, fmt = bits[0], fmts.pop()
    if fmt == 1 and b in (1, 2, 4, 8):
        return np.dtype(bool if b == 1 else np.uint8)
    if fmt == 1 and b == 16:
        return np.dtype(np.uint16)
    if fmt == 3 and b == 32:
        return np.dtype(np.float32)
    raise refused(f"TIFF {b}-bit samples of sample format {fmt}")


def _decompress(page: Page, chunk: bytes, out_len: int) -> bytes:
    c = page.compression
    if c == 5:
        if len(chunk) >= 2 and chunk[0] == 0 and chunk[1] & 1:
            raise refused("old-style (LSB-first) TIFF LZW")
        return tiff_lzw_decode(chunk, out_len)
    if c in (8, 32946):
        try:
            return zlib.decompressobj().decompress(chunk, out_len)
        except zlib.error as e:
            raise ImageError(f"corrupt deflate data in a TIFF: {e}") from None
    if c == 32773:
        return packbits_decode(chunk, out_len)
    return chunk[:out_len]


def _unpack(raw: bytes, rows: int, cols: int, samples: int, bits: int,
            dtype: np.dtype, order: str) -> np.ndarray:
    """(rows, cols, samples) values of decompressed rows (each padded to a
    byte); a short chunk raises."""
    row_bytes = -(-cols * samples * bits // 8)
    if len(raw) < rows * row_bytes:
        raise ImageError("TIFF strip or tile shorter than its rows")
    if bits >= 8:
        dt = dtype.newbyteorder(order) if dtype.itemsize > 1 else dtype
        a = np.frombuffer(raw, dt, rows * cols * samples)
        return a.astype(dtype).reshape(rows, cols, samples)
    packed = np.frombuffer(raw, np.uint8, rows * row_bytes).reshape(
        rows, row_bytes)
    return unpack_bits(packed, bits, cols * samples).reshape(rows, cols,
                                                             samples)


def samples(data: bytes, page: Page, predictor: bool) -> np.ndarray:
    """(planes, H, W, samples per plane) of one IFD as stored (1-bit as 0 /
    1 uint8), the predictor undone if ``predictor``."""
    _check_codec(page)
    dtype = _dtype(page)
    h, w = page.size
    s, bits = page.spp, page.bits[0]
    planes, sp = (s, 1) if page.planar == 2 and s > 1 else (1, s)
    unpack_dtype = np.dtype(np.uint8) if dtype == bool else dtype
    out = np.zeros((planes, h, w, sp), unpack_dtype)
    if 324 in page.tags:
        th, tw = page.one(323), page.one(322)
        across, down = -(-w // tw), -(-h // th)
        offsets, counts = page.get(324), page.get(325, ())
        grid = [(p, (i // across) * th, (i % across) * tw, th, tw)
                for p in range(planes) for i in range(across * down)]
    else:
        rps = min(page.one(278, h) or h, h)
        per = -(-h // rps)
        offsets, counts = page.get(273, ()), page.get(279, ())
        grid = [(p, i * rps, 0, min(rps, h - i * rps), w)
                for p in range(planes) for i in range(per)]
    if len(offsets) < len(grid) or len(counts) < len(grid):
        raise ImageError("TIFF with fewer strips or tiles than its size "
                         "needs")
    do_predict = predictor and page.one(317, 1) == 2
    for (p, y, x, rows, cols), off, n in zip(grid, offsets, counts):
        row_bytes = -(-cols * sp * bits // 8)
        raw = _decompress(page, bytes(data[off:off + n]), rows * row_bytes)
        block = _unpack(raw, rows, cols, sp, bits, unpack_dtype, page.order)
        if do_predict:
            block = np.cumsum(block, axis=1, dtype=block.dtype)
        rows, cols = min(rows, h - y), min(cols, w - x)
        out[p, y:y + rows, x:x + cols] = block[:rows, :cols]
    return out


def _contig(planes: np.ndarray) -> np.ndarray:
    """(planes, H, W, sp) → (H, W, S)."""
    if planes.shape[0] == 1:
        return planes[0]
    return np.ascontiguousarray(np.moveaxis(planes[..., 0], 0, -1))


_ORIENT = {2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1],
           4: lambda a: a[::-1], 5: lambda a: a.swapaxes(0, 1),
           6: lambda a: np.rot90(a, -1),
           7: lambda a: a[::-1, ::-1].swapaxes(0, 1),
           8: lambda a: np.rot90(a, 1)}


def decode(data: bytes) -> Decoded:
    """IFD 0 as PIL's ``Image.open`` holds it (see the module docstring)."""
    big, pages = _parse(data)
    page = pages[0]
    if big and page.order == ">":
        raise refused("big-endian BigTIFF (PIL does not open it)")
    photo = page.one(262, 0)
    bits, s = page.bits, page.spp
    b = bits[0]
    fmt = page.get(339, (1,))[:s]
    float32 = set(fmt) == {3} and b == 32
    if not float32 and set(fmt) != {1}:
        raise refused(f"TIFF sample format {fmt}")
    extra = tuple(page.get(338, ()))
    if page.planar == 2 and s > 1 and b != 8:
        raise refused(f"planar {b}-bit TIFF through PIL")
    codec_predicts = page.compression in (5, 8, 32946)
    px = _contig(samples(data, page, codec_predicts))
    if photo in (0, 1) and s == 1 and not extra:
        g = px[..., 0]
        if float32:
            if page.order == ">" and page.compression != 1:
                g = g.byteswap()  # libtiff's native order read as big-endian
            mode = "F"
        elif b == 1:
            g, mode = (g == 0) if photo == 0 else (g != 0), "1"
        elif b in (2, 4, 8):
            scale = 255 // ((1 << b) - 1)
            g = (g * np.uint8(scale)).astype(np.uint8)
            mode = "L"
            if photo == 0:
                g = 255 - g
        elif b == 16:
            mode = "I;16"
        else:
            raise refused(f"{b}-bit grey TIFF")
        img = Decoded(mode, g)
    elif photo == 1 and s == 2 and bits == (8, 8) and extra == (2,):
        img = Decoded("LA", px)
    elif photo == 2 and s == 3 + len(extra) and not float32 \
            and len(set(bits)) == 1 and extra in _RGB_EXTRA.get(b, ()):
        if b == 16:
            px = (px >> 8).astype(np.uint8)
        if extra[:1] == (1,):
            img = Decoded("RGBA", unpremultiply(px[..., :4]))
        elif extra[:1] == (2,):
            img = Decoded("RGBA", np.ascontiguousarray(px[..., :4]))
        else:
            img = Decoded("RGB", np.ascontiguousarray(px[..., :3]))
    elif photo == 3 and s == 1 and not extra and b in (1, 2, 4, 8):
        cmap = np.asarray(page.get(320, ()), np.uint16)
        if cmap.size != 3 << b:
            raise ImageError("TIFF palette image without a full ColorMap")
        entries = (cmap.reshape(3, -1).T >> 8).astype(np.uint8)
        img = Decoded("P", px[..., 0], palette256(entries))
    else:
        raise refused(f"TIFF of photometric {photo}, {s} samples of "
                      f"{bits} bits, extra samples {extra}")
    turn = _ORIENT.get(page.one(274, 1))
    if turn is not None:
        img.pixels = np.ascontiguousarray(turn(img.pixels))
    return img


_SERIES_META = (b'{"shape":', b"shape=(", b"ImageJ=")


def _tifffile_shape(page: Page) -> Tuple[int, ...]:
    h, w = page.size
    s = page.spp
    if page.one(262) == 2 or s > 1:
        return (s, h, w) if page.planar == 2 else (h, w, s)
    return (h, w)


def imread(data: bytes) -> np.ndarray:
    """What ``imageio.imread`` gives for a ``.tif`` path (see the module
    docstring)."""
    _, pages = _parse(data)
    desc = pages[0].one(270, b"")
    if desc.startswith(_SERIES_META) or b"<OME" in desc[:512]:
        raise refused("TIFF series metadata (tifffile, ImageJ or OME)")
    _check_codec(pages[0])
    photo = pages[0].one(262)
    if photo not in (None, 0, 1, 2, 3):
        raise refused(f"TIFF of photometric {photo}")
    shape = _tifffile_shape(pages[0])
    series = [p for p in pages if _tifffile_shape(p) == shape
              and p.compression in CODECS]
    out = []
    for page in series:
        dtype = _dtype(page)
        planes = samples(data, page, True)
        a = planes[..., 0] if page.planar == 2 and page.spp > 1 else \
            planes[0]
        if len(shape) == 2:
            a = a[..., 0]
        out.append(a.astype(dtype) if dtype == bool else a)
    return out[0] if len(out) == 1 else np.stack(out)

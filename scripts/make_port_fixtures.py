"""Write the HDF5, PNG, TIFF, GIF, BMP and JPEG fixtures the port's readers
are held against, and their manifest.

    python scripts/make_port_fixtures.py [--out tests/fixtures]
        [--only orbax|item20]

Needs h5py, imageio and PIL (the CPU tests' machine has them; the card's
machine does not, which is why the manifest exists).  Writes:

- ``h5_latest/*.h5``: one tiny file per case of the reader's matrix
  (superblocks 0, 2 and 3; every layout and chunk index; LZF, Fletcher-32,
  scale-offset, gzip + shuffle; bool, float16, an enum and the integer and
  float types; compact, dense, ``track_order``, nested and soft-linked
  groups; a paged file-space superblock extension) and
  ``phantom_latest.h5``: an (80, 340, 340) uint8 volume of seeded
  constant-intensity spheres, ``libver="latest"``, shuffle + gzip, chunks
  under a version-2 B-tree index (every axis unlimited).
- ``h5_item20/*``: the files that need external links, virtual datasets,
  szip, n-bit, external raw storage and committed datatypes: the phantom
  as a VDS over two gzip halves, through an external link to
  ``h5_latest/phantom_latest.h5``, with szip (NN, 8 pixels a block) and as
  12-bit n-bit samples (x 16 in a uint16 of precision 12 at bit 4, then
  deflate), and a tiny file per case (``--only item20`` rewrites just
  these and their manifest entry).
- ``png_extra/dsb_c{1,3,4}/images/*.png``: PNGs imageio decodes to 1, 3
  and 4 channels: palette at 1, 2, 4 and 8 bits with and without tRNS;
  1-, 2- and 4-bit grey; 16-bit RGB, grey + alpha and RGBA; each also
  Adam7-interlaced (PIL writes no interlaced PNGs, so this script encodes
  every PNG itself).
- ``image_formats/{dsb_c1,dsb_c3,dsb_c4,misc}/images/*``: TIFF, GIF and
  BMP files of every variant the port reads, small (32x48, a few larger),
  grouped by what ``imageio.imread`` makes of them ((H, W), (H, W, 3),
  (H, W, 4), other shapes): PIL writes what it can (libtiff's LZW,
  deflate, PackBits and predictor 2, BigTIFF, multi-page, palette,
  16-bit, float, "1"; GIF; BMP 1, L, P and RGB) and this script encodes
  the rest (tiles, planar, big-endian, MinIsWhite, associated alpha,
  orientation, GIFs with local tables, offset frames and full LZW tables,
  BMP core / V4 / V5 headers, bit fields, RLE8 / RLE4, top-down rows);
  ``image_formats/drive/``: a seeded synthetic retina at DRIVE's 565x584
  as an LZW + predictor-2 and a deflate + predictor-2 TIFF, with its
  vessel (manual) and field-of-view GIF masks.
- ``image_formats/jpeg_{c1,c3,misc}/images/*.jpg``: JPEGs PIL writes
  (libjpeg-turbo: 4:4:4, 4:2:2 and 4:2:0; baseline, optimized and
  progressive; restart markers; qualities 1-100; ``keep_rgb``; sizes 1x1
  to 37x53; an EXIF Orientation 6) and ``encode_jpeg`` writes (multi-scan
  baseline, SOF1, RGB by component ids); ``image_formats/jpeg_drive/``:
  the synthetic retina as five DRIVE-sized JPEG variants and its vessel
  mask as a grey JPEG.
- ``manifest.json``: for every dataset reachable from each file's root (soft
  links followed) its shape, dtype and the SHA-256 of its C-order bytes as
  h5py reads it, and each group's ``keys()``; for every image, the same of
  what ``imageio.imread`` and PIL's ``convert("L")`` / ``convert("RGB")``
  give (None where PIL does not open it), with a note where their reading
  is not what the file's tags ask (``IMAGE_NOTES``).

Everything comes from ``numpy.random.default_rng`` with fixed seeds, so a
rerun writes the same arrays (h5py may lay the bytes out differently).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import struct
import zlib

import numpy as np

SEED = 20
PHANTOM_SHAPE = (80, 340, 340)
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


# -- PNG ---------------------------------------------------------------------


def _filter_row(ftype: int, cur: bytes, prev: bytes, bpp: int) -> bytes:
    out = bytearray(len(cur))
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        if ftype == 0:
            pred = 0
        elif ftype == 1:
            pred = a
        elif ftype == 2:
            pred = b
        elif ftype == 3:
            pred = (a + b) >> 1
        else:
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (cur[i] - pred) & 0xFF
    return bytes(out)


def _pack_rows(samples: np.ndarray, depth: int) -> np.ndarray:
    """(H, W, ch) sample values → (H, stride) bytes, one image row each."""
    h, w, ch = samples.shape
    if depth == 8:
        return samples.astype(np.uint8).reshape(h, w * ch)
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, w * ch * 2)
    bits = ((samples.reshape(h, w * ch, 1).astype(np.uint8)
             >> np.arange(depth - 1, -1, -1, dtype=np.uint8)) & 1)
    return np.packbits(bits.reshape(h, -1), axis=1)


def _filtered(samples: np.ndarray, depth: int, filters) -> bytes:
    """Rows of one (reduced) image, row r filtered by filters[r % n]."""
    h, w, ch = samples.shape
    if h == 0 or w == 0:
        return b""
    rows = _pack_rows(samples, depth)
    bpp = max(ch * depth // 8, 1)
    out, prev = [], bytes(rows.shape[1])
    for r in range(h):
        cur = rows[r].tobytes()
        ftype = filters[r % len(filters)]
        out.append(bytes([ftype]) + _filter_row(ftype, cur, prev, bpp))
        prev = cur
    return b"".join(out)


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body)))


def encode_png(samples: np.ndarray, colour_type: int, depth: int,
               palette: np.ndarray = None, trns: bytes = None,
               interlace: bool = False, filters=(0, 1, 2, 3, 4)) -> bytes:
    """PNG bytes of ``samples`` (H, W, channels), of any colour type and
    depth the format allows, plain or Adam7-interlaced (each pass's rows
    filtered on their own, as the format asks)."""
    h, w, _ = samples.shape
    if interlace:
        data = b"".join(_filtered(samples[y0::dy, x0::dx], depth, filters)
                        for x0, y0, dx, dy in ADAM7)
    else:
        data = _filtered(samples, depth, filters)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, colour_type, 0, 0, int(interlace)))
    if palette is not None:
        out += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    return out + _chunk(b"IDAT", zlib.compress(data)) + _chunk(b"IEND", b"")


def png_cases(rng, h: int = 32, w: int = 48):
    """{name: (PNG bytes, imageio's channel count)}: the palette, sub-byte
    and 16-bit colour PNGs, each plain and interlaced."""
    cases = {}
    for depth in (1, 2, 4, 8):
        n = min(1 << depth, 200)
        palette = rng.integers(0, 256, (n, 3), dtype=np.uint8)
        idx = rng.integers(0, n, (h, w, 1))
        cases[f"palette{depth}"] = (3, dict(samples=idx, colour_type=3,
                                            depth=depth, palette=palette))
        alpha = rng.integers(0, 256, n // 2 + 1, dtype=np.uint8).tobytes()
        cases[f"palette{depth}_trns"] = (3, dict(
            samples=idx, colour_type=3, depth=depth, palette=palette,
            trns=alpha))
    for depth in (1, 2, 4):
        cases[f"grey{depth}"] = (1, dict(
            samples=rng.integers(0, 1 << depth, (h, w, 1)), colour_type=0,
            depth=depth))
    cases["rgb16"] = (3, dict(samples=rng.integers(0, 1 << 16, (h, w, 3)),
                              colour_type=2, depth=16))
    cases["grey_alpha16"] = (4, dict(
        samples=rng.integers(0, 1 << 16, (h, w, 2)), colour_type=4,
        depth=16))
    cases["rgba16"] = (4, dict(samples=rng.integers(0, 1 << 16, (h, w, 4)),
                               colour_type=6, depth=16))
    out = {}
    for name, (ch, kw) in cases.items():
        out[name] = (encode_png(**kw), ch)
        out[f"{name}_adam7"] = (encode_png(interlace=True, **kw), ch)
    return out


# -- TIFF --------------------------------------------------------------------

TIFF_TYPES = {1: "B", 2: "s", 3: "H", 4: "I", 16: "Q"}


def lzw_encode_tiff(data: bytes) -> bytes:
    """TIFF LZW: codes MSB-first, 256 = clear, 257 = end, one bit wider as
    the decoder's next free code reaches 2^bits - 1 (early change), a clear
    before the table fills."""
    out, acc, nacc, bits = bytearray(), 0, 0, 9

    def put(code):
        nonlocal acc, nacc
        acc = (acc << bits) | code
        nacc += bits
        while nacc >= 8:
            nacc -= 8
            out.append((acc >> nacc) & 0xFF)
        acc &= (1 << nacc) - 1

    table, nxt, w = {bytes([i]): i for i in range(256)}, 258, b""
    put(256)
    for b in data:
        wc = w + bytes([b])
        if wc in table:
            w = wc
            continue
        put(table[w])
        table[wc] = nxt
        nxt += 1
        if nxt >= (1 << bits) and bits < 12:
            bits += 1
        if nxt >= 4094:
            put(256)
            table, nxt, bits = {bytes([i]): i for i in range(256)}, 258, 9
        w = bytes([b])
    if w:
        put(table[w])
        nxt += 1
        if nxt >= (1 << bits) and bits < 12:
            bits += 1
    put(257)
    if nacc:
        out.append((acc << (8 - nacc)) & 0xFF)
    return bytes(out)


def packbits_encode(data: bytes) -> bytes:
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j + 1 < n and data[j + 1] == data[i] and j - i < 127:
            j += 1
        if j > i:  # a run of j - i + 1 equal bytes
            out += bytes([(257 - (j - i + 1)) & 0xFF, data[i]])
            i = j + 1
            continue
        j = i + 1
        while j < n and j - i < 128 and not (j + 1 < n
                                             and data[j + 1] == data[j]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def _tiff_rows(block: np.ndarray, bits: int, order: str) -> bytes:
    """(rows, cols, samples) → bytes, each row padded to a byte."""
    if bits >= 8:
        dt = block.dtype.newbyteorder(order) if block.dtype.itemsize > 1 \
            else block.dtype
        return np.ascontiguousarray(block.astype(dt)).tobytes()
    r, c, s = block.shape
    shifts = np.arange(bits - 1, -1, -1, dtype=np.uint8)
    b = (block.reshape(r, c * s, 1).astype(np.uint8) >> shifts) & 1
    return np.packbits(b.reshape(r, -1), axis=1).tobytes()


def _difference(block: np.ndarray) -> np.ndarray:
    """Predictor 2: each sample less its left neighbour, wrapping."""
    out = block.copy()
    out[:, 1:] = block[:, 1:] - block[:, :-1]
    return out


def tiff_page(samples, bits, photometric, compression=1, predictor=1,
              planar=1, rowsperstrip=None, tile=None, sampleformat=None,
              extrasamples=None, colormap=None, tags=(), order="<",
              raw=None):
    """One IFD's (tags, data chunks) for (H, W, S) ``samples``: strips of
    ``rowsperstrip`` rows (the last one short) or ``tile`` = (rows, cols)
    tiles (edge tiles padded), planar 1 or 2, the predictor applied before
    the compression (1, 5, 8, 32946, 32773; ``raw`` passes a stream as it
    is, for the refused codecs).  ``tags``: extra (tag, type, values)."""
    h, w, s = samples.shape
    planes = [samples] if planar == 1 else [samples[..., i:i + 1]
                                            for i in range(s)]
    if tile:
        th, tw = tile
        ph, pw = -(-h // th) * th, -(-w // tw) * tw
        blocks = []
        for p in planes:
            padded = np.zeros((ph, pw, p.shape[2]), p.dtype)
            padded[:h, :w] = p
            blocks += [padded[y:y + th, x:x + tw] for y in range(0, ph, th)
                       for x in range(0, pw, tw)]
    else:
        rps = rowsperstrip or h
        blocks = [p[y:y + rps] for p in planes for y in range(0, h, rps)]
    chunks = []
    for block in blocks:
        if predictor == 2:
            block = _difference(block)
        data = _tiff_rows(block, bits, order)
        if raw is not None:
            data = raw
        elif compression == 5:
            data = lzw_encode_tiff(data)
        elif compression in (8, 32946):
            data = zlib.compress(data)
        elif compression == 32773:
            data = packbits_encode(data)
        chunks.append(data)
    n = len(chunks)
    entries = [(256, 4, [w]), (257, 4, [h]), (258, 3, [bits] * s),
               (259, 3, [compression]), (262, 3, [photometric]),
               (277, 3, [s]), (284, 3, [planar])]
    if tile:
        entries += [(322, 3, [tile[1]]), (323, 3, [tile[0]]),
                    (324, "offsets", n), (325, 4, [len(c) for c in chunks])]
    else:
        entries += [(273, "offsets", n), (278, 4, [rowsperstrip or h]),
                    (279, 4, [len(c) for c in chunks])]
    if predictor != 1:
        entries.append((317, 3, [predictor]))
    if colormap is not None:
        entries.append((320, 3, list(np.asarray(colormap).reshape(-1))))
    if extrasamples is not None:
        entries.append((338, 3, list(extrasamples)))
    if sampleformat is not None:
        entries.append((339, 3, [sampleformat] * s))
    entries += list(tags)
    return entries, chunks


def encode_tiff(pages, order="<", bigtiff=False) -> bytes:
    """A TIFF file of ``tiff_page`` IFDs: header, each page's data, then
    its IFD and the IFD's out-of-line values."""
    o = order
    head = (b"II" if o == "<" else b"MM")
    if bigtiff:
        out = bytearray(head + struct.pack(o + "HHHQ", 43, 8, 0, 0))
        link_at, entry_size, inline = 8, 20, 8
        count_fmt, ecount_fmt, off_fmt = "Q", "Q", "Q"
    else:
        out = bytearray(head + struct.pack(o + "HI", 42, 0))
        link_at, entry_size, inline = 4, 12, 4
        count_fmt, ecount_fmt, off_fmt = "H", "I", "I"
    for entries, chunks in pages:
        offsets = []
        for c in chunks:
            offsets.append(len(out))
            out += c
            if len(out) % 2:
                out += b"\0"
        resolved = []
        for tag, typ, vals in sorted(entries, key=lambda e: e[0]):
            if typ == "offsets":
                typ, vals = (16 if bigtiff else 4), offsets
            resolved.append((tag, typ, vals))
        ifd_at = len(out)
        struct.pack_into(o + off_fmt, out, link_at, ifd_at)
        n = len(resolved)
        body_end = ifd_at + struct.calcsize(o + count_fmt) + n * entry_size \
            + struct.calcsize(o + off_fmt)
        ifd, extra = bytearray(struct.pack(o + count_fmt, n)), bytearray()
        for tag, typ, vals in resolved:
            fmt = TIFF_TYPES[typ]
            if typ == 2:
                payload, count = vals, len(vals)
            else:
                payload = struct.pack(o + fmt * len(vals), *vals)
                count = len(vals)
            if len(payload) <= inline:
                value = payload.ljust(inline, b"\0")
            else:
                value = struct.pack(o + off_fmt, body_end + len(extra))
                extra += payload
                if len(extra) % 2:
                    extra += b"\0"
            ifd += struct.pack(o + "HH" + ecount_fmt, tag, typ, count) + value
        link_at = ifd_at + len(ifd)
        ifd += struct.pack(o + off_fmt, 0)
        out += ifd + extra
    return bytes(out)


# -- GIF ---------------------------------------------------------------------


def lzw_encode_gif(indices: bytes, min_code_size: int,
                   clear_when_full: bool = True) -> bytes:
    """GIF LZW: codes LSB-first, one bit wider once the decoder's next free
    code reaches 2^bits; at 4096 codes a clear, or (``clear_when_full``
    False) no new codes until the end: the deferred clear."""
    clear, end = 1 << min_code_size, (1 << min_code_size) + 1
    out, acc, nacc = bytearray(), 0, 0
    bits = min_code_size + 1

    def put(code):
        nonlocal acc, nacc
        acc |= code << nacc
        nacc += bits
        while nacc >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nacc -= 8

    def fresh():
        return {bytes([i]): i for i in range(clear)}, clear + 2

    table, nxt = fresh()
    put(clear)
    w = b""
    for b in indices:
        wc = w + bytes([b])
        if wc in table:
            w = wc
            continue
        put(table[w])
        if nxt < 4096:
            table[wc] = nxt
            nxt += 1
            if nxt > (1 << bits) and bits < 12:
                bits += 1
        elif clear_when_full:
            put(clear)
            table, nxt = fresh()
            bits = min_code_size + 1
        w = bytes([b])
    if w:
        put(table[w])
        if nxt < 4096:
            nxt += 1
            if nxt > (1 << bits) and bits < 12:
                bits += 1
    put(end)
    if nacc:
        out.append(acc & 0xFF)
    return bytes(out)


def _gif_blocks(data: bytes) -> bytes:
    return b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                    for i in range(0, len(data), 255)) + b"\0"


def _gif_table(palette) -> tuple:
    """(the table bytes padded to a power of two, its size field)."""
    pal = np.asarray(palette, np.uint8).reshape(-1, 3)
    bits = max(1, int(np.ceil(np.log2(max(len(pal), 2)))))
    padded = np.zeros((1 << bits, 3), np.uint8)
    padded[:len(pal)] = pal
    return padded.tobytes(), bits - 1


def encode_gif(frames, screen, global_palette=None, version=b"GIF89a"):
    """GIF bytes.  ``frames``: dicts of ``indices`` (h, w), and optionally
    ``pos`` (x, y), ``palette`` (a local table), ``interlace``,
    ``transparency`` (a Graphic Control Extension), ``min_code_size``,
    ``clear_when_full``."""
    sw, sh = screen
    flags, table = 0, b""
    if global_palette is not None:
        table, size = _gif_table(global_palette)
        flags = 0x80 | (size << 4) | size
    out = bytearray(version + struct.pack("<HHBBB", sw, sh, flags, 0, 0)
                    + table)
    out += b"!\xfe" + _gif_blocks(b"tpuseg fixture")  # a comment block
    for fr in frames:
        idx = np.asarray(fr["indices"], np.uint8)
        h, w = idx.shape
        x, y = fr.get("pos", (0, 0))
        if "transparency" in fr:
            out += b"!\xf9\x04" + struct.pack("<BHB", 1, 0,
                                              fr["transparency"]) + b"\0"
        iflags, local = 0, b""
        if fr.get("palette") is not None:
            local, size = _gif_table(fr["palette"])
            iflags = 0x80 | size
        if fr.get("interlace"):
            iflags |= 0x40
            rows = np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8),
                                   np.arange(2, h, 4), np.arange(1, h, 2)])
            idx = idx[rows]
        mcs = fr.get("min_code_size", 8)
        out += b"," + struct.pack("<HHHHB", x, y, w, h, iflags) + local
        out += bytes([mcs]) + _gif_blocks(lzw_encode_gif(
            idx.tobytes(), mcs, fr.get("clear_when_full", True)))
    return bytes(out + b";")


# -- BMP ---------------------------------------------------------------------


def _bmp_rle(idx: np.ndarray, rle4: bool) -> bytes:
    """RLE8 / RLE4 of bottom-up rows: runs of equal pixels, absolute runs
    (even lengths only at 4 bits) of the rest, an end of line per row."""
    out = bytearray()
    for row in idx[::-1]:
        row = [int(v) for v in row]
        i, n = 0, len(row)
        while i < n:
            j = i + 1
            if rle4:  # runs alternate two nibbles: count equal pairs
                while j < n and j - i < 255 and row[j] == row[i + (j - i) % 2]:
                    j += 1
            else:
                while j < n and j - i < 255 and row[j] == row[i]:
                    j += 1
            if j - i >= 3 or n - i < 3:
                hi, lo = row[i], row[i + 1] if j - i > 1 else 0
                out += bytes([j - i, (hi << 4 | lo) if rle4 else hi])
                i = j
                continue
            k = min(n, i + 254)  # an absolute run until the next run
            j = i + 3
            while j < k and not (j + 2 < n and row[j] == row[j + 1]
                                 == row[j + 2]):
                j += 1
            if rle4 and (j - i) % 2:  # PIL reads len // 2 bytes
                j += 1 if j < n else -1
            if j - i < (4 if rle4 else 3):  # too short: single runs
                out += bytes([1, row[i] << 4 if rle4 else row[i]])
                i += 1
                continue
            run = row[i:j]
            if rle4:
                body = bytes(run[t] << 4 | run[t + 1]
                             for t in range(0, len(run), 2))
            else:
                body = bytes(run)
            out += bytes([0, len(run)]) + body
            if len(body) % 2:
                out += b"\0"
            i = j
        out += b"\0\0"
    return bytes(out + b"\0\1")


def encode_bmp(pixels, bits, palette=None, header=40, compression=0,
               masks=None, top_down=False) -> bytes:
    """BMP bytes.  ``pixels``: (h, w) indices for 1-8 bits, else (h, w, 3
    or 4) RGB(A) uint8 packed by ``masks`` (16 and 32 bits; default 5-5-5
    and BGRX) or as BGR (24).  ``header`` 12 (core, 3-byte palette
    entries), 40, 108 (V4) or 124 (V5); compression 0, 1 (RLE8), 2 (RLE4)
    or 3 (bit fields: the masks after a 40-byte header, else inside it)."""
    px = np.asarray(pixels)
    h, w = px.shape[:2]
    stride = ((w * bits + 31) >> 3) & ~3
    if compression in (1, 2):
        body = _bmp_rle(px, compression == 2)
    else:
        rows = np.zeros((h, stride), np.uint8)
        if bits <= 8:
            b = ((px[..., None].astype(np.uint8)
                  >> np.arange(bits - 1, -1, -1, dtype=np.uint8)) & 1)
            packed = np.packbits(b.reshape(h, -1), axis=1)
            rows[:, :packed.shape[1]] = packed
        elif bits == 24:
            rows[:, :3 * w] = px[..., 2::-1].reshape(h, 3 * w)
        else:
            ms = masks or ((0x7C00, 0x3E0, 0x1F, 0) if bits == 16
                           else (0xFF0000, 0xFF00, 0xFF, 0))
            v = np.zeros((h, w), np.uint64)
            for c, m in enumerate(ms):
                if m:
                    shift = (m & -m).bit_length() - 1
                    top = m >> shift
                    val = px[..., c].astype(np.uint64) * top // 255 \
                        if c < px.shape[-1] else np.uint64(top)
                    v |= (val << np.uint64(shift)) & np.uint64(m)
            dt = "<u2" if bits == 16 else "<u4"
            rows[:, :bits // 8 * w] = v.astype(dt).view(np.uint8).reshape(
                h, -1)
        if not top_down:
            rows = rows[::-1]
        body = rows.tobytes()
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        height = (-h) & 0xFFFFFFFF if top_down else h
        n_colors = 0 if palette is None else len(palette)
        info = struct.pack("<IiIHHIIiiII", header, w, height, 1, bits,
                           compression, len(body), 2835, 2835, n_colors, 0)
        if header > 40:
            ms = tuple(masks or (0, 0, 0, 0)) + (0,) * 4
            info += struct.pack("<IIII", *ms[:4])
            info += bytes(header - len(info))
    extra = b""
    if compression == 3 and header == 40:
        extra = struct.pack("<III", *masks[:3])
    pal = b""
    if palette is not None:
        pal = np.asarray(palette, np.uint8).reshape(-1, 3)[:, ::-1]
        if header != 12:
            pal = np.concatenate([pal, np.zeros((len(pal), 1), np.uint8)], 1)
        pal = pal.tobytes()
    offset = 14 + len(info) + len(extra) + len(pal)
    return (b"BM" + struct.pack("<IHHI", offset + len(body), 0, 0, offset)
            + info + extra + pal + body)


# -- the TIFF, GIF and BMP matrix -----------------------------------------------

DRIVE_SIZE = (584, 565)  # DRIVE's published images: 565 wide, 584 high


def retina(seed: int = SEED):
    """A seeded synthetic fundus at DRIVE's size: (RGB uint8 image, vessel
    mask 0/255, field-of-view mask 0/255)."""
    rng = np.random.default_rng(seed)
    h, w = DRIVE_SIZE
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    cy, cx = h / 2, w / 2
    fov = ((yy - cy) ** 2 + (xx - cx) ** 2) <= 270 ** 2
    disc_y, disc_x = cy + rng.uniform(-40, 40), cx + 150
    shade = 1 - 0.35 * np.hypot(yy - cy, xx - cx) / 270
    base = np.stack([170 * shade, 80 * shade, 40 * shade], -1)
    base += 70 * np.exp(-((yy - disc_y) ** 2 + (xx - disc_x) ** 2)
                        / 900)[..., None]
    vessels = np.zeros((h, w), bool)
    for _ in range(14):
        y, x = disc_y, disc_x
        angle, width = rng.uniform(0, 2 * np.pi), rng.uniform(1.5, 4.5)
        for _ in range(400):
            angle += rng.normal(0, 0.08)
            y, x = y + 1.5 * np.sin(angle), x + 1.5 * np.cos(angle)
            if not (0 <= y < h and 0 <= x < w):
                break
            y0, y1 = int(max(y - 5, 0)), int(min(y + 6, h))
            x0, x1 = int(max(x - 5, 0)), int(min(x + 6, w))
            vessels[y0:y1, x0:x1] |= ((yy[y0:y1, x0:x1] - y) ** 2
                                      + (xx[y0:y1, x0:x1] - x) ** 2
                                      <= width ** 2)
            width = max(1.0, width * 0.997)
    vessels &= fov
    base[vessels] *= 0.55
    base += rng.integers(-1, 2, base.shape)
    image = np.where(fov[..., None], np.clip(base, 0, 255), 0)
    return (image.astype(np.uint8), (vessels * 255).astype(np.uint8),
            (fov * 255).astype(np.uint8))


def _pil_saver(Image, arr, mode=None, palette=None, append=None, **kw):
    """A writer of ``arr`` through PIL (converted to ``mode``, given
    ``palette``, with the ``append`` arrays as more pages), saved with
    ``kw``."""
    def write(path):
        im = Image.fromarray(arr) if mode is None else Image.fromarray(
            arr).convert(mode)
        if palette is not None:
            im.putpalette(palette)
        extra = {} if append is None else {
            "save_all": True,
            "append_images": [Image.fromarray(a) for a in append]}
        im.save(path, **kw, **extra)
    return write


def _bytes_saver(data: bytes):
    def write(path):
        with open(path, "wb") as f:
            f.write(data)
    return write


def image_cases(Image, rng, h: int = 32, w: int = 48):
    """{directory/name: writer(path)}: every TIFF, GIF and BMP variant the
    port reads, PIL writing what it can and this script the rest, each in
    the directory of what ``imageio.imread`` makes of it (``dsb_c1``: (H, W),
    ``dsb_c3`` / ``dsb_c4``: (H, W, 3 / 4); ``misc``: other shapes and
    sizes), and the full-size DRIVE files under ``drive``."""
    rgb = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    rgba = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    g8 = rng.integers(0, 256, (h, w), dtype=np.uint8)
    g16 = rng.integers(0, 65536, (h, w)).astype(np.uint16)
    f32 = (rng.standard_normal((h, w)) * 120 + 60).astype(np.float32)
    f32_odd = f32.copy()
    f32_odd[0, :3] = (np.nan, np.inf, -np.inf)
    bits1 = rng.integers(0, 2, (h, w)).astype(bool)
    mask = np.where(rng.random((h, w)) > 0.6, 255, 0).astype(np.uint8)
    pal = rng.integers(0, 256, (256, 3), dtype=np.uint8)
    idx = rng.integers(0, 200, (h, w))
    smooth = (np.add.outer(np.arange(h) // 5, np.arange(w) // 7) % 16)
    rle_idx = np.where(smooth > 8, idx % 5, smooth)
    grey_pal = np.repeat(np.arange(256)[:, None], 3, 1)
    cmap16 = rng.integers(0, 65536, (3, 256))
    T, c = tiff_page, {}

    def tif(*pages, order="<", big=False):
        return _bytes_saver(encode_tiff(list(pages), order, big))

    # TIFF, written by PIL (libtiff for the codecs)
    for comp, tag in ((None, "raw"), ("tiff_lzw", "lzw"),
                      ("packbits", "packbits")):
        c[f"dsb_c3/pil_rgb_{tag}.tif"] = _pil_saver(Image, rgb,
                                                    compression=comp)
        c[f"dsb_c1/pil_L_{tag}.tif"] = _pil_saver(Image, g8, compression=comp)
    for comp, tag in (("tiff_lzw", "lzw"), ("tiff_adobe_deflate", "deflate")):
        c[f"dsb_c3/pil_rgb_{tag}_pred2.tif"] = _pil_saver(
            Image, rgb, compression=comp, tiffinfo={317: 2})
        c[f"dsb_c1/pil_I16_{tag}_pred2.tif"] = _pil_saver(
            Image, g16, compression=comp, tiffinfo={317: 2})
    c["dsb_c1/pil_1_raw.tif"] = _pil_saver(Image, bits1)
    c["dsb_c1/pil_1_lzw.tif"] = _pil_saver(Image, bits1,
                                           compression="tiff_lzw")
    c["dsb_c1/pil_I16_raw.tif"] = _pil_saver(Image, g16)
    c["dsb_c1/pil_F_raw.tif"] = _pil_saver(Image, f32)
    c["dsb_c1/pil_F_deflate.tif"] = _pil_saver(
        Image, f32, compression="tiff_adobe_deflate")
    c["misc/pil_F_nan_inf.tif"] = _pil_saver(Image, f32_odd)
    c["dsb_c1/pil_P_lzw.tif"] = _pil_saver(Image, g8, "P",
                                           palette=list(pal.reshape(-1)),
                                           compression="tiff_lzw")
    c["dsb_c4/pil_rgba_lzw.tif"] = _pil_saver(Image, rgba,
                                              compression="tiff_lzw")
    c["misc/pil_LA_raw.tif"] = _pil_saver(Image, rgba, "LA")
    c["dsb_c3/pil_bigtiff.tif"] = _pil_saver(Image, rgb, big_tiff=True)
    c["dsb_c3/pil_bigtiff_lzw.tif"] = _pil_saver(Image, rgb, big_tiff=True,
                                                 compression="tiff_lzw")
    c["misc/pil_two_pages.tif"] = _pil_saver(Image, g8, append=[g8[::-1]])
    c["dsb_c3/pil_rgb_then_L.tif"] = _pil_saver(Image, rgb, append=[g8])
    # TIFF, encoded here
    c["dsb_c3/tiled_raw.tif"] = tif(T(rgb, 8, 2, tile=(16, 32)))
    c["dsb_c3/tiled_lzw_pred2.tif"] = tif(T(rgb, 8, 2, 5, 2, tile=(16, 32)))
    c["dsb_c1/tiled_L_deflate.tif"] = tif(T(g8[..., None], 8, 1, 8,
                                            tile=(16, 16)))
    c["dsb_c3/strips_short_last_32946.tif"] = tif(T(rgb, 8, 2, 32946, 2,
                                                    rowsperstrip=5))
    c["misc/planar2_raw.tif"] = tif(T(rgb, 8, 2, planar=2, rowsperstrip=5))
    c["misc/planar2_lzw_pred2.tif"] = tif(T(rgb, 8, 2, 5, 2, planar=2,
                                            rowsperstrip=7))
    c["misc/planar2_tiled_deflate.tif"] = tif(T(rgb, 8, 2, 8, planar=2,
                                                tile=(16, 32)))
    c["dsb_c3/mm_rgb_lzw_pred2.tif"] = tif(
        T(rgb, 8, 2, 5, 2, rowsperstrip=7, order=">"), order=">")
    c["dsb_c1/mm_I16_deflate_pred2.tif"] = tif(
        T(g16[..., None], 16, 1, 8, 2, order=">"), order=">")
    c["dsb_c1/mm_I16_raw.tif"] = tif(T(g16[..., None], 16, 1, order=">"),
                                     order=">")
    c["dsb_c1/mm_F_raw.tif"] = tif(T(f32[..., None], 32, 1, sampleformat=3,
                                     order=">"), order=">")
    # PIL reads libtiff's native-order output as big-endian: byte-swapped
    c["dsb_c1/mm_F_deflate.tif"] = tif(T(f32[..., None], 32, 1, 8,
                                         sampleformat=3, order=">"),
                                       order=">")
    # PIL does not open a big-endian BigTIFF; imageio does
    c["dsb_c3/mm_bigtiff_lzw.tif"] = tif(T(rgb, 8, 2, 5, order=">"),
                                         order=">", big=True)
    c["dsb_c3/bigtiff_tiled_lzw_pred2.tif"] = tif(
        T(rgb, 8, 2, 5, 2, tile=(16, 16)), big=True)
    c["dsb_c1/miniswhite_L.tif"] = tif(T(g8[..., None], 8, 0))
    c["dsb_c1/miniswhite_1_packbits.tif"] = tif(T(bits1[..., None], 1, 0,
                                                  32773))
    c["dsb_c1/miniswhite_I16_lzw.tif"] = tif(T(g16[..., None], 16, 0, 5))
    c["dsb_c1/miniswhite_4bit.tif"] = tif(T(smooth[..., None].astype(
        np.uint8), 4, 0, rowsperstrip=3))
    c["dsb_c1/grey2_packbits.tif"] = tif(T((idx % 4)[..., None].astype(
        np.uint8), 2, 1, 32773))
    c["dsb_c1/grey4_lzw.tif"] = tif(T(smooth[..., None].astype(np.uint8), 4,
                                      1, 5, rowsperstrip=3))
    c["dsb_c1/palette4_deflate.tif"] = tif(T(
        smooth[..., None].astype(np.uint8), 4, 3, 8,
        colormap=cmap16[:, :16]))
    c["dsb_c1/palette8_raw.tif"] = tif(T(idx[..., None].astype(np.uint8), 8,
                                         3, colormap=cmap16))
    c["dsb_c1/no_photometric_tag.tif"] = tif(
        ([e for e in T(g8[..., None], 8, 1)[0] if e[0] != 262],
         T(g8[..., None], 8, 1)[1]))
    # the predictor on codecs without one: PIL ignores it, imageio undoes it
    c["dsb_c1/packbits_pred2.tif"] = tif(T(g8[..., None], 8, 1, 32773, 2))
    c["dsb_c1/raw_pred2.tif"] = tif(T(g8[..., None], 8, 1, 1, 2))
    c["dsb_c4/assoc_alpha.tif"] = tif(T(rgba, 8, 2, 8, extrasamples=[1]))
    c["dsb_c4/assoc_alpha16_lzw.tif"] = tif(T(
        rgba.astype(np.uint16) * 257 + 7, 16, 2, 5, 2, extrasamples=[1]))
    c["dsb_c4/unassoc_alpha_packbits.tif"] = tif(T(rgba, 8, 2, 32773,
                                                   extrasamples=[2]))
    c["dsb_c4/rgbx_extra0.tif"] = tif(T(rgba, 8, 2, 5, extrasamples=[0]))
    c["dsb_c3/rgb16_lzw_pred2.tif"] = tif(T(
        rgb.astype(np.uint16) * 257 + 3, 16, 2, 5, 2))
    # PIL applies the Orientation tag, imageio does not
    c["dsb_c3/orientation3.tif"] = tif(T(rgb, 8, 2, tags=[(274, 3, [3])]))
    c["dsb_c3/orientation6_lzw.tif"] = tif(T(rgb, 8, 2, 5,
                                             tags=[(274, 3, [6])]))
    # GIF, written by PIL (interlaced by default)
    c["dsb_c3/pil_mask.gif"] = _pil_saver(Image, mask)
    c["dsb_c3/pil_mask_not_interlaced.gif"] = _pil_saver(Image, mask,
                                                         interlace=False)
    c["dsb_c1/pil_L.gif"] = _pil_saver(Image, g8)
    c["dsb_c1/pil_L_transparency.gif"] = _pil_saver(Image, g8,
                                                    transparency=3)
    c["dsb_c3/pil_P.gif"] = _pil_saver(Image, g8, "P",
                                       palette=list(pal.reshape(-1)))
    c["dsb_c3/pil_P_transparency.gif"] = _pil_saver(
        Image, g8, "P", palette=list(pal.reshape(-1)), transparency=5)
    c["dsb_c3/pil_rgb.gif"] = _pil_saver(Image, rgb)
    # GIF, encoded here
    g = encode_gif
    c["dsb_c3/local_table.gif"] = _bytes_saver(g([{"indices": idx,
                                                  "palette": pal}], (w, h)))
    c["dsb_c3/local_over_global.gif"] = _bytes_saver(g(
        [{"indices": idx, "palette": pal[::-1], "interlace": True}], (w, h),
        pal))
    c["dsb_c3/offset_frame_transparency.gif"] = _bytes_saver(g(
        [{"indices": idx[:20, :30], "pos": (7, 5), "transparency": 9,
          "interlace": True}], (w, h), pal))
    c["dsb_c3/offset_frame.gif"] = _bytes_saver(g(
        [{"indices": idx[:20, :30], "pos": (7, 5)}], (w, h), pal))
    c["misc/frame_past_screen.gif"] = _bytes_saver(g(
        [{"indices": idx, "pos": (5, 3)}], (w, h), pal))
    c["dsb_c1/grey_local_under_global.gif"] = _bytes_saver(g(
        [{"indices": idx, "palette": grey_pal}], (w, h), pal))
    c["dsb_c1/no_colour_table.gif"] = _bytes_saver(g([{"indices": idx}],
                                                     (w, h)))
    c["dsb_c3/min_code_size2.gif"] = _bytes_saver(g(
        [{"indices": idx % 4, "min_code_size": 2}], (w, h), pal[:4]))
    c["dsb_c3/two_frames.gif"] = _bytes_saver(g(
        [{"indices": idx}, {"indices": idx[::-1], "transparency": 1}],
        (w, h), pal))
    c["dsb_c3/gif87a_runs.gif"] = _bytes_saver(g(
        [{"indices": np.repeat(smooth, 1, 0)}], (w, h), pal[:16],
        version=b"GIF87a"))
    noise = rng.integers(0, 256, (128, 128))
    c["misc/table_full_deferred_clear.gif"] = _bytes_saver(g(
        [{"indices": noise, "clear_when_full": False}], (128, 128), pal))
    c["misc/table_full_clear.gif"] = _bytes_saver(g(
        [{"indices": noise}], (128, 128), pal))
    # BMP, written by PIL
    c["dsb_c1/pil_1.bmp"] = _pil_saver(Image, bits1)
    c["dsb_c1/pil_L.bmp"] = _pil_saver(Image, g8)
    c["dsb_c3/pil_P.bmp"] = _pil_saver(Image, g8, "P",
                                       palette=list(pal.reshape(-1)))
    c["dsb_c3/pil_rgb.bmp"] = _pil_saver(Image, rgb)
    # BMP, encoded here
    b = encode_bmp
    c["dsb_c3/core_24.bmp"] = _bytes_saver(b(rgb, 24, header=12))
    c["dsb_c3/core_pal8.bmp"] = _bytes_saver(b(idx, 8, pal[:200],
                                               header=12))
    c["dsb_c3/pal1.bmp"] = _bytes_saver(b(idx % 2, 1, pal[:2]))
    c["dsb_c3/pal4.bmp"] = _bytes_saver(b(smooth, 4, pal[:16]))
    c["dsb_c3/pal8_200_used.bmp"] = _bytes_saver(b(idx, 8, pal[:200]))
    c["dsb_c1/grey8.bmp"] = _bytes_saver(b(idx, 8, grey_pal))
    c["dsb_c3/rgb555.bmp"] = _bytes_saver(b(rgb, 16))
    c["dsb_c3/bitfields565.bmp"] = _bytes_saver(b(
        rgb, 16, compression=3, masks=(0xF800, 0x7E0, 0x1F)))
    c["dsb_c3/rgb32.bmp"] = _bytes_saver(b(rgb, 32))
    c["dsb_c3/bitfields32_xbgr.bmp"] = _bytes_saver(b(
        rgb, 32, compression=3, masks=(0xFF000000, 0xFF0000, 0xFF00)))
    c["dsb_c3/v5_bitfields32.bmp"] = _bytes_saver(b(
        rgb, 32, header=124, compression=3, masks=(0xFF0000, 0xFF00, 0xFF,
                                                   0)))
    c["dsb_c4/v4_bitfields32_alpha.bmp"] = _bytes_saver(b(
        rgba, 32, header=108, compression=3,
        masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000)))
    c["dsb_c3/rle8.bmp"] = _bytes_saver(b(rle_idx, 8, pal[:200],
                                          compression=1))
    c["dsb_c3/rle4.bmp"] = _bytes_saver(b(rle_idx, 4, pal[:16],
                                          compression=2))
    c["dsb_c3/top_down_24.bmp"] = _bytes_saver(b(rgb, 24, top_down=True))
    c["dsb_c3/top_down_pal8.bmp"] = _bytes_saver(b(idx, 8, pal,
                                                   top_down=True))
    c["misc/odd_size_24.bmp"] = _bytes_saver(b(rgb[:7, :13], 24))
    # DRIVE at its published size: the images, a manual and an FOV mask
    image, vessels, fov = retina()
    c["drive/21_training.tif"] = _pil_saver(Image, image,
                                            compression="tiff_lzw",
                                            tiffinfo={317: 2})
    c["drive/22_training.tif"] = _pil_saver(
        Image, image[:, ::-1], compression="tiff_adobe_deflate",
        tiffinfo={317: 2})
    c["drive/21_manual1.gif"] = _pil_saver(Image, vessels)
    c["drive/21_training_mask.gif"] = _pil_saver(Image, fov)
    return c


# cases where PIL's or imageio's reading is not what the file's tags ask,
# recorded beside their entries (the port follows PIL and imageio)
IMAGE_NOTES = {
    "misc/pil_two_pages.tif": "imageio stacks same-shaped pages: (2, H, W)",
    "misc/planar2_raw.tif": "imageio keeps planar samples first: (3, H, W)",
    "misc/planar2_lzw_pred2.tif": "imageio: (3, H, W)",
    "misc/planar2_tiled_deflate.tif": "imageio: (3, H, W)",
    "dsb_c1/mm_F_deflate.tif": "PIL reads the floats byte-swapped",
    "dsb_c3/mm_bigtiff_lzw.tif": "PIL does not open a big-endian BigTIFF",
    "dsb_c1/packbits_pred2.tif": "PIL ignores predictor 2 on PackBits, "
                                 "imageio undoes it",
    "dsb_c1/raw_pred2.tif": "PIL ignores predictor 2 uncompressed, "
                            "imageio undoes it",
    "dsb_c1/no_photometric_tag.tif": "PIL reads a missing photometric as "
                                     "MinIsWhite",
    "dsb_c1/miniswhite_I16_lzw.tif": "PIL does not invert 16-bit "
                                     "MinIsWhite",
    "dsb_c1/palette8_raw.tif": "imageio gives the palette indices",
    "dsb_c3/orientation3.tif": "PIL applies the Orientation tag, imageio "
                               "does not",
    "dsb_c3/orientation6_lzw.tif": "PIL applies the Orientation tag "
                                   "(W, H), imageio does not",
    "dsb_c1/grey_local_under_global.gif": "PIL's convert('RGB') of this "
                                          "'L' frame applies the global "
                                          "table",
}


# -- JPEG ----------------------------------------------------------------------

_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
_DCT8 = np.array([[np.sqrt((1 if u == 0 else 2) / 8)
                   * np.cos((2 * x + 1) * u * np.pi / 16) for x in range(8)]
                  for u in range(8)])


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


class _BitWriter:
    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, value: int, bits: int):
        self.acc = (self.acc << bits) | (value & ((1 << bits) - 1))
        self.n += bits
        while self.n >= 8:
            byte = (self.acc >> (self.n - 8)) & 0xFF
            self.out += b"\xff\x00" if byte == 0xFF else bytes([byte])
            self.n -= 8

    def flush(self) -> bytes:
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)  # pad with 1s
        data, self.out, self.acc = bytes(self.out), bytearray(), 0
        return data


def _category(v: int):
    """(size, the v's bits) of a DC difference or an AC value."""
    s = int(abs(v)).bit_length()
    return s, (v if v >= 0 else v - 1 + (1 << s))


def encode_jpeg(pixels, sampling=None, scans=None, restart=0, sof=0xC0,
                ids=None, jfif=True, ycc=True, qscale=1) -> bytes:
    """A sequential Huffman JPEG of ``pixels`` ((H, W) grey or (H, W, 3) RGB,
    stored as YCbCr, or as RGB with ``ycc`` off), the writer PIL has no
    options for: ``scans`` lists each scan's components (one scan of all by
    default; one scan a component is multi-scan baseline), ``sampling``
    each component's (h, v), ``restart`` MCUs between RSTn markers, ``sof``
    0xC0 or 0xC1, component ``ids``, a JFIF APP0 marker or none.
    Fixed-length Huffman codes over the symbols each table codes; chroma
    averaged over its sampling cells."""
    px = np.asarray(pixels, np.float64)
    if px.ndim == 2:
        planes = [px]
    elif not ycc:
        planes = [px[..., 0], px[..., 1], px[..., 2]]
    else:
        r, g, b = px[..., 0], px[..., 1], px[..., 2]
        planes = [0.299 * r + 0.587 * g + 0.114 * b,
                  128 - 0.168736 * r - 0.331264 * g + 0.5 * b,
                  128 + 0.5 * r - 0.418688 * g - 0.081312 * b]
    n = len(planes)
    h, w = px.shape[:2]
    sampling = sampling or [(1, 1)] * n
    ids = ids or list(range(1, n + 1))
    scans = scans or [tuple(range(n))]
    maxh = max(s[0] for s in sampling)
    maxv = max(s[1] for s in sampling)
    mcus_x, mcus_y = -(-w // (8 * maxh)), -(-h // (8 * maxv))
    q = [np.clip((2 + np.arange(64) // 3) * qscale, 1, 255).astype(int),
         np.clip((3 + np.arange(64) // 2) * qscale, 1, 255).astype(int)]
    coefs = []  # per component: (block rows, block cols, 64) in zig-zag
    for c, (plane, (sh, sv)) in enumerate(zip(planes, sampling)):
        fy, fx = maxv // sv, maxh // sh
        ch, cw = -(-h * sv // maxv), -(-w * sh // maxh)
        padded = np.pad(plane, ((0, ch * fy - h), (0, cw * fx - w)),
                        mode="edge")
        down = padded.reshape(ch, fy, cw, fx).mean(axis=(1, 3))
        rows, cols = mcus_y * sv, mcus_x * sh
        full = np.pad(np.round(down) - 128,
                      ((0, rows * 8 - ch), (0, cols * 8 - cw)), mode="edge")
        blocks = full.reshape(rows, 8, cols, 8).transpose(0, 2, 1, 3)
        dct = _DCT8 @ blocks @ _DCT8.T
        quant = np.round(dct.reshape(rows, cols, 64)
                         / q[min(c, 1)][_ZIGZAG.argsort()][None, None])
        coefs.append(quant.reshape(rows, cols, 64)[..., _ZIGZAG].astype(int))

    def scan_blocks(comps):
        """Each MCU's (component, block) list, in scan order."""
        if len(comps) == 1:
            c = comps[0]
            sh, sv = sampling[c]
            bh = -(-(-(-h * sv // maxv)) // 8)
            bw = -(-(-(-w * sh // maxh)) // 8)
            return [[(c, coefs[c][y, x])] for y in range(bh)
                    for x in range(bw)]
        return [[(c, coefs[c][my * sampling[c][1] + y,
                              mx * sampling[c][0] + x])
                 for c in comps for y in range(sampling[c][1])
                 for x in range(sampling[c][0])]
                for my in range(mcus_y) for mx in range(mcus_x)]

    def symbols(mcus):
        """Each MCU's (component, [(dc?, symbol, size, bits)])."""
        out, pred = [], {}
        for i, mcu in enumerate(mcus):
            if restart and i % restart == 0:
                pred = {}
            items = []
            for c, blk in mcu:
                diff = blk[0] - pred.get(c, 0)
                pred[c] = blk[0]
                s, bits = _category(diff)
                items.append((c, True, s, s, bits))
                run, last = 0, max([k for k in range(1, 64) if blk[k]] or [0])
                for k in range(1, last + 1):
                    if blk[k] == 0:
                        run += 1
                        continue
                    while run > 15:
                        items.append((c, False, 0xF0, 0, 0))
                        run -= 16
                    s, bits = _category(blk[k])
                    items.append((c, False, (run << 4) | s, s, bits))
                    run = 0
                if last < 63:
                    items.append((c, False, 0x00, 0, 0))
            out.append(items)
        return out

    def tables(syms):
        """{(dc?, table): {symbol: (code, length)}}: fixed-length codes."""
        used = {}
        for items in syms:
            for c, dc, sym, _, _ in items:
                used.setdefault((dc, min(c, 1)), set()).add(sym)
        return {k: {s: (i, max(1, len(v).bit_length()))
                    for i, s in enumerate(sorted(v))}
                for k, v in used.items()}

    out = bytearray(b"\xff\xd8")
    if jfif:
        out += _segment(0xE0, b"JFIF\0\x01\x01\0\0\x01\0\x01\0\0")
    for t in range(min(n, 2)):
        out += _segment(0xDB, bytes([t]) + bytes(q[t].tolist()))
    out += _segment(sof, struct.pack(">BHHB", 8, h, w, n) + b"".join(
        bytes([ids[c], (sampling[c][0] << 4) | sampling[c][1], min(c, 1)])
        for c in range(n)))
    if restart:
        out += _segment(0xDD, struct.pack(">H", restart))
    for comps in scans:
        mcus = scan_blocks(list(comps))
        syms = symbols(mcus)
        codes = tables(syms)
        for (dc, t), table in sorted(codes.items()):
            length = next(iter(table.values()))[1]
            counts = [0] * 16
            counts[length - 1] = len(table)
            out += _segment(0xC4, bytes([(0 if dc else 16) | t] + counts)
                            + bytes(sorted(table)))
        out += _segment(0xDA, bytes([len(comps)]) + b"".join(
            bytes([ids[c], (min(c, 1) << 4) | min(c, 1)]) for c in comps)
            + b"\x00\x3f\x00")
        bw = _BitWriter()
        for i, items in enumerate(syms):
            if restart and i and i % restart == 0:
                out += bw.flush() + bytes([0xFF, 0xD0 + (i // restart - 1) % 8])
            for c, dc, sym, s, bits in items:
                code, length = codes[(dc, min(c, 1))][sym]
                bw.put(code, length)
                if s:
                    bw.put(bits, s)
        out += bw.flush()
    return bytes(out + b"\xff\xd9")


def jpeg_cases(Image, rng):
    """{directory/name: writer(path)}: the JPEG variants the port reads,
    PIL writing all it can (``encode_jpeg`` the multi-scan baseline and
    SOF1 files): ``jpeg_c1`` / ``jpeg_c3`` hold 32x48 grey and colour files
    (what ``imageio.imread`` gives as (H, W) and (H, W, 3)), ``jpeg_misc``
    other sizes and an EXIF Orientation 6, ``jpeg_drive`` the DRIVE-sized
    files of the card's run."""
    h, w = 32, 48
    yy, xx = np.mgrid[0:h, 0:w]
    waves = np.stack([128 + 90 * np.sin(xx / (4 + k) + k)
                      * np.cos(yy / (3 + k) - k) for k in range(3)], -1)
    rgb = np.clip(waves + rng.normal(0, 18, waves.shape), 0, 255).astype(
        np.uint8)
    grey = rgb[..., 1].copy()
    c = {}
    coding = {"baseline": {}, "optimized": {"optimize": True},
              "progressive": {"progressive": True}}
    for sub, tag in ((0, "444"), (1, "422"), (2, "420")):
        for name, kw in coding.items():
            c[f"jpeg_c3/{name}_{tag}.jpg"] = _pil_saver(
                Image, rgb, quality=85, subsampling=sub, **kw)
    for q in (1, 10, 25, 50, 75, 90, 95, 100):
        c[f"jpeg_c3/quality{q:03d}.jpg"] = _pil_saver(Image, rgb, quality=q)
    c["jpeg_c3/restart_blocks3.jpg"] = _pil_saver(
        Image, rgb, restart_marker_blocks=3)
    c["jpeg_c3/restart_rows1_progressive_422.jpg"] = _pil_saver(
        Image, rgb, restart_marker_rows=1, progressive=True, subsampling=1)
    c["jpeg_c3/keep_rgb_444.jpg"] = _pil_saver(Image, rgb, keep_rgb=True,
                                               subsampling=0)
    c["jpeg_c3/keep_rgb_progressive.jpg"] = _pil_saver(
        Image, rgb, keep_rgb=True, subsampling=0, progressive=True)
    c["jpeg_c3/multiscan_baseline_420.jpg"] = _bytes_saver(encode_jpeg(
        rgb, [(2, 2), (1, 1), (1, 1)], [(0,), (1,), (2,)], restart=2))
    c["jpeg_c3/extended_sof1_422.jpg"] = _bytes_saver(encode_jpeg(
        rgb, [(2, 1), (1, 1), (1, 1)], [(0, 1, 2)], sof=0xC1))
    c["jpeg_c3/rgb_ids_no_marker.jpg"] = _bytes_saver(encode_jpeg(
        rgb, ids=[82, 71, 66], jfif=False, ycc=False))
    for name, kw in {**coding, "quality1": {"quality": 1},
                     "quality100": {"quality": 100},
                     "restart_blocks2": {"restart_marker_blocks": 2}}.items():
        c[f"jpeg_c1/{name}.jpg"] = _pil_saver(Image, grey, **kw)
    for sh, sw in ((1, 1), (7, 9), (17, 33), (37, 53)):
        c[f"jpeg_misc/{sh}x{sw}_420.jpg"] = _pil_saver(
            Image, rgb[:sh, :sw] if sh <= h else np.resize(rgb, (sh, sw, 3)),
            quality=90)
        c[f"jpeg_misc/{sh}x{sw}_422_progressive.jpg"] = _pil_saver(
            Image, np.resize(rgb, (sh, sw, 3)), quality=90, subsampling=1,
            progressive=True)
        c[f"jpeg_misc/{sh}x{sw}_grey.jpg"] = _pil_saver(
            Image, np.resize(grey, (sh, sw)), quality=90)

    def orientation6(path):
        exif = Image.Exif()
        exif[0x0112] = 6
        Image.fromarray(np.resize(rgb, (37, 53, 3))).save(path, exif=exif)

    c["jpeg_misc/37x53_exif_orientation6.jpg"] = orientation6
    image, vessels, _ = retina()
    drive = {"baseline_420_q75": {"quality": 75},
             "q95_444": {"quality": 95, "subsampling": 0},
             "progressive_422": {"progressive": True, "subsampling": 1},
             "optimized_420": {"optimize": True},
             "restart_rows1_420": {"restart_marker_rows": 1}}
    for name, kw in drive.items():
        c[f"jpeg_drive/{name}.jpg"] = _pil_saver(Image, image, **kw)
    c["jpeg_drive/grey_manual.jpg"] = _pil_saver(Image, vessels, quality=90)
    return c


# -- orbax --------------------------------------------------------------------

ORBAX_SEED = SEED + 4
ORBAX_VOLUMES = {"train": (8, 64, 64), "val": (8, 32, 64)}  # 4, 2 patches
ORBAX_RESUME_STEPS = 3
# each run: the JAX trainer's parallel section and the data axis it trains
# on (the loaders' global batch is batch_size x the data axis)
ORBAX_RUNS = {
    "tp": ({"model_axis": 4, "tensor_parallel": True}, 2),
    "zero1": ({"zero1": True}, 8),
}
ZSTD_LEVELS = (1, 3, 9, 19)
# tensorstore OCDBT probes: config and what is written
OCDBT_PROBES = {
    "plain_deep": {"compression": None, "max_decoded_node_bytes": 64,
                   "max_inline_value_bytes": 8},
    "zstd_deep": {"compression": {"id": "zstd", "level": 5},
                  "max_decoded_node_bytes": 96, "max_inline_value_bytes": 4},
    "versions": {"compression": None, "max_decoded_node_bytes": 128,
                 "max_inline_value_bytes": 8, "version_tree_arity_log2": 2},
}


def orbax_config(train: str, val: str, checkpoint_dir: str, parallel=None,
                 batch_size: int = 1, **trainer) -> dict:
    """The 3D config of the orbax fixtures (``tests/test_trainer3d.py``'s):
    UNet3D f_maps 8, 2 levels, BCEDice, Adam 2e-3, ReduceLROnPlateau."""
    def phase(path):
        return {"transformer": {
                    "raw": [{"name": "Standardize"},
                            {"name": "ToTensor", "expand_dims": True}],
                    "label": [{"name": "ToTensor", "expand_dims": True}]},
                "slice_builder": {"name": "SliceBuilder",
                                  "patch_shape": [8, 32, 32],
                                  "stride_shape": [8, 32, 32],
                                  "skip_shape_check": True},
                "file_paths": [path]}

    cfg = {"model": {"name": "UNet3D", "in_channels": 1, "out_channels": 1,
                     "f_maps": 8, "num_levels": 2, "final_sigmoid": True},
           "loss": {"name": "BCEDiceLoss"},
           "eval_metric": {"name": "MeanIoU"},
           "optimizer": {"name": "Adam", "learning_rate": 2e-3},
           "lr_scheduler": {"name": "ReduceLROnPlateau", "mode": "max",
                            "factor": 0.5, "patience": 2},
           "trainer": {"checkpoint_dir": checkpoint_dir, "max_num_epochs": 10,
                       "max_num_iterations": 4, "validate_after_iters": 2,
                       "log_after_iters": 1, **trainer},
           "loaders": {"dataset": "StandardHDF5Dataset",
                       "batch_size": batch_size,
                       "train": phase(train), "val": phase(val)}}
    if parallel:
        cfg["parallel"] = parallel
    return cfg


def logged(run_dir: str, tag: str) -> dict:
    """{step: value} of a tag in a run's ``logs/*/metrics.jsonl``."""
    rows = {}
    for base, _, files in os.walk(os.path.join(run_dir, "logs")):
        if "metrics.jsonl" in files:
            with open(os.path.join(base, "metrics.jsonl")) as f:
                for line in f:
                    r = json.loads(line)
                    if r["tag"] == tag:
                        rows[str(r["step"])] = r["value"]
    return rows


def tree_entries(tree, prefix: str = "") -> dict:
    """Each leaf of a restored tree by its ``.``-joined path: an array's
    shape, dtype and SHA-256, a number's type and value, ``{}`` and None
    as themselves."""
    out = {}
    items = (tree.items() if isinstance(tree, dict) else
             enumerate(tree) if isinstance(tree, (list, tuple)) else None)
    if items is None:
        if tree is None:
            return {prefix: {"none": True}}
        if isinstance(tree, (bool, int, float)):
            return {prefix: {"number": type(tree).__name__, "value": tree}}
        return {prefix: entry(np.asarray(tree))}
    items = list(items)
    if not items:
        return {prefix: {"empty": True}}
    for k, v in items:
        out.update(tree_entries(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def _jax_cpu(devices: int = 8):
    """JAX on ``devices`` CPU devices, the JAX package importable."""
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            f"{flags} --xla_force_host_platform_device_count={devices}"
        ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    return jax


def _orbax_trees(jax, root: str) -> list:
    """``OrbaxCheckpointer.save`` trees: every dtype the trainers write and
    a few more, 0-d and scalar leaves, empty dicts, None, tuples, arrays
    sharded over the 8-device mesh (orbax chunks them finer than the mesh,
    always into even grids); also the same tree in the layout without
    OCDBT (one directory per leaf)."""
    import jax.numpy as jnp
    import orbax.checkpoint as ocp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from mdeical_image_segmentation_tpu.train.orbax_ckpt import (
        OrbaxCheckpointer,
    )

    rng = np.random.default_rng(ORBAX_SEED)
    mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("data", "model"))

    def put(a, spec):
        return jax.device_put(jnp.asarray(a), NamedSharding(mesh, spec))

    tree = {
        "f4": rng.standard_normal((3, 5)).astype(np.float32),
        "f8": rng.standard_normal(7),
        "i4": rng.integers(-9, 9, (2, 3, 4)).astype(np.int32),
        "i8": rng.integers(-2 ** 40, 2 ** 40, 6),
        "b1": rng.random(9) > 0.5,
        "u1": rng.integers(0, 255, 10).astype(np.uint8),
        "f2": rng.standard_normal(4).astype(np.float16),
        "zero_d": np.asarray(3.25, np.float32),
        "int_scalar": 7,
        "float_scalar": -1.5,
        "empty": {},
        "none": None,
        "tuple": (np.arange(4, dtype=np.int32), {"x": np.ones(2)}),
        "nested": {"a": {"b": rng.standard_normal((2, 2)).astype(np.float32)}},
        # a ZeRO-1 moment's layout: (4, 3, 3, 8, 16) over 'data'
        "rows": put(rng.standard_normal((4, 3, 3, 8, 16)).astype(np.float32),
                    P("data")),
        # a TP kernel's layout: (3, 3, 3, 8, 16) over 'model', 4 chunks
        "tp_kernel": put(
            rng.standard_normal((3, 3, 3, 8, 16)).astype(np.float32),
            P(None, None, None, None, "model")),
    }
    OrbaxCheckpointer(os.path.join(root, "trees")).save(tree, is_best=True)
    ocp.Checkpointer(ocp.PyTreeCheckpointHandler(use_ocdbt=False)).save(
        os.path.join(root, "trees_plain", "last"), tree)
    return ["trees", "trees_plain"]


def _ocdbt_probes(root: str) -> dict:
    """tensorstore OCDBT databases: uncompressed and zstd nodes, interior
    nodes of height >= 2, out-of-line and empty values, shared key
    prefixes, many versions (older ones in version tree nodes) and a
    deleted key; their keys and values as tensorstore reads them."""
    import tensorstore as ts

    out = {}
    rng = np.random.default_rng(ORBAX_SEED + 1)
    for name, config in OCDBT_PROBES.items():
        path = os.path.join(root, "ocdbt", name)
        kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{path}",
                              "config": config}).result()
        if name == "versions":
            for i in range(40):
                kv.write(b"shared/prefix/key%03d" % i,
                         bytes(rng.integers(0, 255, i % 13,
                                            dtype=np.uint8))).result()
            kv.delete_range(ts.KvStore.KeyRange(
                b"shared/prefix/key005", b"shared/prefix/key006")).result()
            kv.write(b"shared/prefix/key007", b"x" * 19).result()
        else:
            with ts.Transaction() as txn:
                t = kv.with_transaction(txn)
                for i in range(60):
                    t.write(b"model.params.enc%d/%s" % (i % 7, b"%02d" % i),
                            bytes(rng.integers(0, 255, (i * 7) % 23,
                                               dtype=np.uint8))).result()
                t.write(b"z", b"").result()
                t.write(b"", b"empty key").result()
        kv = ts.KvStore.open({"driver": "ocdbt",
                              "base": f"file://{path}"}).result()
        out[f"ocdbt/{name}"] = {
            k.hex(): {"length": len(v), "sha256": hashlib.sha256(v).hexdigest()}
            for k in kv.list().result()
            for v in [kv.read(k).result().value]}
    return out


ZARR_ARRAYS = {
    # name: shape, chunks, dtype, dimension_separator, chunks written
    "uneven_dot": ((7, 10, 3), (3, 4, 2), "<f4", ".", None),
    "uneven_slash": ((5, 6), (2, 4), "<i8", "/", None),
    "bool_edge": ((9,), (4,), "|b1", ".", None),
    "fill_missing": ((6, 6), (4, 4), "<f8", ".", (slice(0, 4), slice(0, 4))),
}


def _zarr_arrays(root: str) -> dict:
    """zarr v2 arrays tensorstore writes into an OCDBT database, with chunk
    grids the shape does not divide (edge chunks stored padded), both
    dimension separators and a fill value standing for unwritten chunks;
    each array as tensorstore reads it."""
    import tensorstore as ts

    rng = np.random.default_rng(ORBAX_SEED + 4)
    path = os.path.join(root, "zarr")
    out = {}
    for name, (shape, chunks, dtype, sep, region) in ZARR_ARRAYS.items():
        meta = {"shape": list(shape), "chunks": list(chunks), "dtype": dtype,
                "compressor": {"id": "zstd", "level": 1},
                "dimension_separator": sep}
        if region is not None:
            meta["fill_value"] = 1.5
        arr = ts.open({"driver": "zarr", "path": name,
                       "kvstore": {"driver": "ocdbt",
                                   "base": f"file://{path}"},
                       "metadata": meta}, create=True).result()
        data = (rng.standard_normal(shape) * 100).astype(np.dtype(dtype))
        if region is None:
            arr.write(data).result()
        else:
            arr[region].write(data[region]).result()
        out[f"zarr/{name}"] = entry(np.asarray(arr.read().result()))
    return out


def _zstd_frames(root: str) -> dict:
    """zstd frames tensorstore's zarr driver writes: a chunk over 128 KiB
    (several blocks) at each level of ``ZSTD_LEVELS``, a constant chunk
    (RLE), a random chunk (raw blocks) and a compressible one (Huffman
    literals and FSE sequences); each frame's decoded length and hash as
    tensorstore reads the chunk."""
    import tensorstore as ts

    rng = np.random.default_rng(ORBAX_SEED + 2)
    cases = {
        "const": np.full(40000, 3.0, np.float32),
        "random": rng.integers(0, 2 ** 32, 2000, dtype=np.uint32),
        "weights": (rng.standard_normal(4000) * 0.05).astype(np.float32),
        # 256 KiB of runs of small integers: several blocks
        "big": np.repeat(rng.integers(0, 60, 8192), 8).astype(np.int32),
    }
    out = {}
    d = os.path.join(root, "zstd")
    os.makedirs(d, exist_ok=True)
    for name, data in cases.items():
        for level in (ZSTD_LEVELS if name == "big" else (3,)):
            tmp = os.path.join(root, "_zarr_tmp")
            spec = {"driver": "zarr", "kvstore": f"file://{tmp}",
                    "metadata": {"compressor": {"id": "zstd",
                                                "level": level},
                                 "shape": list(data.shape),
                                 "chunks": list(data.shape),
                                 "dtype": data.dtype.str}}
            arr = ts.open(spec, create=True, delete_existing=True).result()
            arr.write(data).result()
            back = np.asarray(arr.read().result())
            with open(os.path.join(tmp, "0"), "rb") as f:
                frame = f.read()
            key = f"zstd/{name}_l{level}.zst"
            with open(os.path.join(root, key), "wb") as f:
                f.write(frame)
            raw = np.ascontiguousarray(back).tobytes()
            out[key] = {"length": len(raw),
                        "sha256": hashlib.sha256(raw).hexdigest()}
            import shutil

            shutil.rmtree(tmp)
    return out


def _orbax_runs(jax, root: str) -> dict:
    """The JAX trainer's own orbax checkpoints (``<run>/orbax/{last,
    best}``) of a tensor-parallel run on the (2, 4) mesh and a ZeRO-1 run
    over 8 data devices, 4 steps on seeded volumes, and each one resumed
    by the JAX trainer (in a copy) for ``ORBAX_RESUME_STEPS`` steps: the
    logged train losses."""
    import shutil

    import h5py

    from mdeical_image_segmentation_tpu.train.orbax_ckpt import (
        OrbaxCheckpointer,
    )
    from mdeical_image_segmentation_tpu.train.trainer3d import create_trainer
    from mdeical_image_segmentation_tpu.transforms import volume

    rng = np.random.default_rng(ORBAX_SEED + 3)
    vol_dir = os.path.join(root, "volumes")
    os.makedirs(vol_dir, exist_ok=True)
    paths = {}
    for name, shape in ORBAX_VOLUMES.items():
        raw = rng.integers(0, 256, shape, dtype=np.uint8)
        paths[name] = os.path.join(vol_dir, f"{name}.h5")
        with h5py.File(paths[name], "w") as f:
            f.create_dataset("raw", data=raw)
            f.create_dataset("label", data=(raw > 150).astype(np.uint8),
                             compression="gzip")
    runs = {}
    for name, (parallel, n_data) in ORBAX_RUNS.items():
        ckpt = os.path.join(root, name)
        shutil.rmtree(ckpt, ignore_errors=True)
        volume.GLOBAL_RANDOM_STATE = np.random.RandomState(47)
        trainer = create_trainer(orbax_config(paths["train"], paths["val"],
                                              ckpt, parallel))
        trainer.fit()
        shutil.rmtree(os.path.join(ckpt, "logs"), ignore_errors=True)
        copy = os.path.join(root, f"_{name}_resume")
        shutil.rmtree(copy, ignore_errors=True)
        shutil.copytree(ckpt, copy)
        start = int(OrbaxCheckpointer(os.path.join(ckpt, "orbax")).restore()[
            "num_iterations"])
        volume.GLOBAL_RANDOM_STATE = np.random.RandomState(47)
        # the resumed run steps at iterations start, start + 1, ... and
        # stops once past max_num_iterations
        resumed = create_trainer(orbax_config(
            paths["train"], paths["val"], os.path.join(copy, "elsewhere"),
            parallel, resume=os.path.join(copy, "orbax"),
            max_num_iterations=start + ORBAX_RESUME_STEPS - 2,
            validate_after_iters=1000))
        resumed.fit()
        if name != "tp":  # one run keeps its best (a copy of last)
            shutil.rmtree(os.path.join(ckpt, "orbax", "best"))
        runs[name] = {"parallel": parallel, "data_axis": n_data,
                      "checkpoint": f"{name}/orbax",
                      "num_iterations": start,
                      "resumed_train_loss_avg": logged(copy, "train_loss_avg")}
        shutil.rmtree(copy)
    return runs


def orbax_worker(rank: int, port: int, root: str) -> int:
    """One of two JAX processes (4 CPU devices each) saving one tree with
    arrays sharded over both: a checkpoint whose root manifest points
    into ``ocdbt.process_0`` and ``ocdbt.process_1``."""
    jax = _jax_cpu(4)
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(f"localhost:{port}", num_processes=2,
                               process_id=rank)
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from mdeical_image_segmentation_tpu.train.orbax_ckpt import (
        OrbaxCheckpointer,
    )

    mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("data", "model"))
    whole = np.arange(8 * 6 * 16, dtype=np.float32).reshape(8, 6, 16)
    leaves = {}
    for name, spec in (("rows", P("data")), ("both", P("data", None, "model"))):
        sharding = NamedSharding(mesh, spec)
        leaves[name] = jax.make_array_from_callback(
            whole.shape, sharding, lambda idx: whole[idx])
    leaves["count"] = jax.device_put(jnp.asarray(5, jnp.int32),
                                     NamedSharding(mesh, P()))
    OrbaxCheckpointer(os.path.join(root, "two_process")).save(
        {"params": leaves, "step": 12}, is_best=True)
    jax.distributed.shutdown()
    return 0


def _two_process(root: str) -> bool:
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--orbax-worker", str(rank), "--port",
                               str(port), "--out", root], env=env)
             for rank in range(2)]
    try:
        rcs = [p.wait(timeout=180) for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        rcs = [None, None]
    ok = rcs == [0, 0]
    print(f"two-process orbax checkpoint: {'written' if ok else rcs}")
    return ok


def jax_restore(jax, path: str, best: bool):
    """The JAX package's ``OrbaxCheckpointer(path).restore(best=best)``,
    jax.Arrays as numpy.  A checkpoint whose arrays were sharded over
    processes that are not this one's is restored against a template of
    numpy arrays made from orbax's own metadata of it (without one orbax
    wants the writers' shardings)."""
    import orbax.checkpoint as ocp

    from mdeical_image_segmentation_tpu.train.orbax_ckpt import (
        OrbaxCheckpointer,
    )

    checkpointer = OrbaxCheckpointer(path)
    try:
        tree = checkpointer.restore(best=best)
    except ValueError:
        meta = ocp.PyTreeCheckpointer().metadata(checkpointer._path(best))
        meta = getattr(meta, "item_metadata", meta)
        meta = getattr(meta, "tree", meta)
        tree = checkpointer.restore(best=best, template=jax.tree_util.tree_map(
            lambda m: np.zeros(m.shape, m.dtype), meta))
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) if isinstance(x, jax.Array) else x, tree)


def orbax_fixtures(out: str) -> dict:
    """Everything under ``<out>/orbax`` and its manifest entry."""
    import shutil

    jax = _jax_cpu()
    from mdeical_image_segmentation_tpu.train.orbax_ckpt import (
        OrbaxCheckpointer,
    )

    root = os.path.join(out, "orbax")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    manifest = {"runs": _orbax_runs(jax, root)}
    names = [r["checkpoint"] for r in manifest["runs"].values()]
    names += _orbax_trees(jax, root)
    if _two_process(root):
        names.append("two_process")
    checkpoints = {}
    for name in names:
        for best in (False, True):
            if not OrbaxCheckpointer(os.path.join(root, name)).exists(best):
                continue
            tree = jax_restore(jax, os.path.join(root, name), best)
            checkpoints[f"{name}/{'best' if best else 'last'}"] = \
                tree_entries(tree)
    manifest["checkpoints"] = checkpoints
    manifest["ocdbt"] = _ocdbt_probes(root)
    manifest["zstd"] = _zstd_frames(root)
    manifest["zarr"] = _zarr_arrays(root)
    return manifest

# -- HDF5 --------------------------------------------------------------------


def _early_dcpl(h5py):
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_alloc_time(h5py.h5d.ALLOC_TIME_EARLY)
    return dcpl


def _compact(h5py, f, name, data):
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_layout(h5py.h5d.COMPACT)
    h5py.h5d.create(f.id, name.encode(), h5py.h5t.py_create(data.dtype),
                    h5py.h5s.create_simple(data.shape), dcpl=dcpl).write(
        h5py.h5s.ALL, h5py.h5s.ALL, data)


def phantom(shape=PHANTOM_SHAPE, seed: int = SEED, n: int = 24):
    """A uint8 volume of ``n`` seeded spheres, each of one intensity."""
    rng = np.random.default_rng(seed)
    vol = np.zeros(shape, np.uint8)
    grid = np.ogrid[tuple(slice(0, s) for s in shape)]
    for _ in range(n):
        centre = [rng.uniform(0, s) for s in shape]
        radius = rng.uniform(8, 40)
        value = rng.integers(40, 250)
        d2 = sum((g - c) ** 2 for g, c in zip(grid, centre))
        vol[d2 <= radius ** 2] = value
    return vol


def h5_cases(h5py, rng):
    """{file name: (libver, track_order, writer(f))}."""
    vol = rng.standard_normal((6, 10, 11)).astype("<f4") * 100
    ints = rng.integers(0, 1000, (6, 10, 11)).astype("<i2")

    def chunked(**kw):
        return lambda f: f.create_dataset("x", data=vol, **kw)

    def paged(f):  # 1200 chunks: a paged fixed array, two pages written
        ds = f.create_dataset("x", shape=(40, 60), dtype="<u2",
                              chunks=(1, 2), fillvalue=3)
        ds[0:2, 0:4] = np.arange(8).reshape(2, 4)
        ds[39, 50:60] = 9

    def sparse(f):  # an extensible array mostly unwritten
        ds = f.create_dataset("x", shape=(400, 6), dtype="<i2",
                              chunks=(2, 3), maxshape=(None, 6),
                              fillvalue=-7, compression="lzf")
        ds[0:2, 3:6] = 1
        ds[57, :] = np.arange(6)
        ds[399, 0] = 5

    def dtypes(f):
        for o in "<>":
            for k, n in [("u", 1), ("u", 2), ("u", 4), ("u", 8), ("i", 1),
                         ("i", 2), ("i", 4), ("i", 8), ("f", 2), ("f", 4),
                         ("f", 8)]:
                dt = np.dtype(f"{o}{k}{n}")
                if k == "f":
                    a = rng.standard_normal((3, 4, 5)) * 10
                else:
                    info = np.iinfo(dt)
                    a = rng.integers(info.min, info.max, (3, 4, 5),
                                     endpoint=True, dtype=dt.newbyteorder("="))
                f.create_dataset(f"{'le' if o == '<' else 'be'}_{k}{n}",
                                 data=np.asarray(a, dt), chunks=(2, 2, 5),
                                 compression="gzip")
        f.create_dataset("label_bool", data=vol > 0)
        f.create_dataset("label_bool_chunked", data=vol > 50,
                         chunks=(3, 5, 11), compression="gzip")
        f.create_dataset("enum_i2", data=np.array([0, 42, 1], "<i2"),
                         dtype=h5py.enum_dtype({"RED": 0, "GREEN": 1,
                                                "BLUE": 42}, basetype="<i2"))

    def groups(n, nested=True):
        def write(f):
            for i in range(n):
                f.create_dataset(f"d{(7 * i) % n:02d}", data=np.arange(i + 2))
            if nested:
                g = f.create_group("nested", track_order=True)
                for i in range(n):
                    g.create_dataset(f"z{n - i:02d}", data=np.full(3, i))
                inner = g.create_group("inner")
                inner.create_dataset("deep", data=np.eye(3))
                f["soft_abs"] = h5py.SoftLink("/nested/inner/deep")
                g["soft_rel"] = h5py.SoftLink("inner")
        return write

    return {
        "sb0_default_chunked.h5": ("earliest", False, chunked(
            chunks=(2, 5, 4), compression="gzip")),
        "sb2_v108_chunked.h5": ("v108", False, chunked(chunks=(2, 5, 4))),
        "sb3_v110_earray.h5": ("v110", False, chunked(
            chunks=(2, 5, 4), maxshape=(None, 10, 11))),
        "latest_contiguous.h5": ("latest", False, chunked()),
        "latest_compact.h5": ("latest", False,
                              lambda f: _compact(h5py, f, "x", ints)),
        "latest_single.h5": ("latest", False, chunked(chunks=vol.shape)),
        "latest_single_gzip.h5": ("latest", False, chunked(
            chunks=vol.shape, compression="gzip")),
        "latest_implicit.h5": ("latest", False, chunked(
            chunks=(2, 5, 4), dcpl=_early_dcpl(h5py))),
        "latest_farray.h5": ("latest", False, chunked(
            chunks=(2, 5, 4), compression="gzip", shuffle=True)),
        "latest_farray_paged.h5": ("latest", False, paged),
        "latest_earray.h5": ("latest", False, chunked(
            chunks=(2, 5, 4), maxshape=(6, None, 11))),
        "latest_earray_sparse.h5": ("latest", False, sparse),
        "latest_bt2.h5": ("latest", False, chunked(
            chunks=(2, 5, 4), maxshape=(None, None, 11),
            compression="gzip")),
        "latest_bt2_deep.h5": ("latest", False, lambda f: f.create_dataset(
            "x", data=np.arange(800, dtype="<f8").reshape(50, 16),
            chunks=(1, 4), maxshape=(None, None))),
        "filter_lzf.h5": ("latest", False, chunked(
            chunks=(2, 5, 4), compression="lzf", shuffle=True)),
        "filter_fletcher32.h5": ("latest", False, chunked(
            chunks=(2, 5, 4), fletcher32=True)),
        "filter_scaleoffset_int.h5": ("latest", False, lambda f:
                                      f.create_dataset(
                                          "x", data=ints, chunks=(2, 5, 4),
                                          scaleoffset=True)),
        "filter_scaleoffset_float.h5": ("latest", False, chunked(
            chunks=(2, 5, 4), scaleoffset=2, compression="gzip")),
        "filter_gzip_shuffle_default.h5": ("earliest", False, chunked(
            chunks=(2, 5, 4), compression="gzip", compression_opts=9,
            shuffle=True, fletcher32=True)),
        "dtypes_latest.h5": ("latest", False, dtypes),
        "groups_compact.h5": ("latest", False, groups(3)),
        "groups_dense.h5": ("latest", False, groups(12)),
        "groups_track_order.h5": ("latest", True, groups(12)),
        "groups_default_track_root.h5": ("earliest", True, groups(5)),
        "superblock_ext_paged.h5": ("latest", False, chunked(
            chunks=(2, 5, 4), compression="gzip")),
    }


def _dcpl_filters(h5py, chunks, *filters):
    """A dataset creation property list, chunked, with each (filter id,
    flags, client values) in pipeline order."""
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_chunk(tuple(chunks))
    for fid, flags, values in filters:
        dcpl.set_filter(fid, flags, values)
    return dcpl


def _low_level(h5py, f, name: str, data, tid, dcpl=None):
    """``data`` written to a new dataset of file type ``tid`` (HDF5
    converts it)."""
    ds = h5py.h5d.create(f.id, name.encode(), tid,
                         h5py.h5s.create_simple(data.shape), dcpl=dcpl)
    ds.write(h5py.h5s.ALL, h5py.h5s.ALL, np.ascontiguousarray(data))


def _virtual_blocks(h5py, f, name, shape, vsel, src_file, src_dset,
                    src_shape, ssel, fill):
    """A virtual dataset of one mapping whose selections are hyperslabs
    (start, count, stride, block) on both sides."""
    vspace = h5py.h5s.create_simple(tuple(shape))
    vspace.select_hyperslab(vsel[0], vsel[1], stride=vsel[2], block=vsel[3])
    sspace = h5py.h5s.create_simple(tuple(src_shape))
    sspace.select_hyperslab(ssel[0], ssel[1], stride=ssel[2], block=ssel[3])
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_fill_value(np.asarray(fill))
    dcpl.set_virtual(vspace, src_file.encode(), src_dset.encode(), sspace)
    vspace.select_all()
    h5py.h5d.create(f.id, name.encode(), h5py.h5t.py_create(
        np.asarray(fill).dtype), vspace, dcpl=dcpl)


def int_bits_type(h5py, base, precision: int, offset: int):
    """An integer file type of ``precision`` bits at bit ``offset``."""
    tid = base.copy()
    tid.set_precision(precision)
    tid.set_offset(offset)
    return tid


def reduced_float_type(h5py):
    """HDF5's n-bit example float: 4 bytes, precision 20 at bit 7, sign at
    26, a 6-bit exponent at 20 (bias 31), a 13-bit mantissa at 7; h5py
    reads it as float32."""
    tid = h5py.h5t.IEEE_F32LE.copy()
    tid.set_fields(26, 20, 6, 7, 13)
    tid.set_offset(7)       # the size grows to 5 ...
    tid.set_precision(20)
    tid.set_size(4)         # ... and comes back to 4
    tid.set_ebias(31)
    return tid


def item20_fixtures(h5py, out: str) -> dict:
    """``h5_item20/``: the HDF5 files that need external links, virtual
    datasets, szip, n-bit, external raw storage and committed datatypes,
    the phantom of ``h5_latest`` through each (for ``chip_smoke.py``'s
    phase 30) and a tiny file per case; returns the manifest section."""
    d = os.path.join(out, "h5_item20")
    os.makedirs(d, exist_ok=True)
    for name in os.listdir(d):
        os.remove(os.path.join(d, name))
    vol = phantom()
    half = vol.shape[0] // 2
    chunks = (half, vol.shape[1] // 4, vol.shape[2] // 4)  # (40, 85, 85)
    rng = np.random.default_rng(SEED + 4)

    def path(name):
        return os.path.join(d, name)

    # the phantom as a VDS over two gzip halves in two source files
    for part, sl in (("a", slice(0, half)), ("b", slice(half, None))):
        with h5py.File(path(f"phantom_vds_{part}.h5"), "w") as f:
            f.create_dataset("raw", data=vol[sl], chunks=chunks,
                             compression="gzip")
    layout = h5py.VirtualLayout(shape=vol.shape, dtype=vol.dtype)
    layout[:half] = h5py.VirtualSource("phantom_vds_a.h5", "raw",
                                       shape=(half,) + vol.shape[1:])
    layout[half:] = h5py.VirtualSource("phantom_vds_b.h5", "raw",
                                       shape=(vol.shape[0] - half,)
                                       + vol.shape[1:])
    with h5py.File(path("phantom_vds.h5"), "w", libver="latest") as f:
        f.create_virtual_dataset("raw", layout, fillvalue=0)
    # an external link to the latest phantom, relative to this directory
    with h5py.File(path("phantom_ext.h5"), "w") as f:
        f["raw"] = h5py.ExternalLink("../h5_latest/phantom_latest.h5", "/raw")
    with h5py.File(path("phantom_szip.h5"), "w") as f:
        f.create_dataset("raw", data=vol, chunks=chunks,
                         compression="szip", compression_opts=("nn", 8))
    # 12-bit samples: the phantom x 16 in a uint16 of precision 12 at bit
    # 4, n-bit then deflate 4
    with h5py.File(path("phantom_nbit.h5"), "w") as f:
        _low_level(h5py, f, "raw", vol.astype("<u2") * 16,
                   int_bits_type(h5py, h5py.h5t.STD_U16LE, 12, 4),
                   _dcpl_filters(h5py, chunks,
                                 (h5py.h5z.FILTER_NBIT, 0, ()),
                                 (h5py.h5z.FILTER_DEFLATE, 0, (4,))))

    # one tiny file per case
    small = rng.integers(0, 200, (6, 10, 12)).astype("<i2")
    with h5py.File(path("tiny_src.h5"), "w") as f:
        f.create_dataset("x", data=small, chunks=(3, 5, 6),
                         compression="gzip")
        g = f.create_group("grp")
        g.create_dataset("y", data=np.arange(7.0))
        g["to_x"] = h5py.SoftLink("/x")
        f["onward"] = h5py.ExternalLink("tiny_chain_end.h5", "/z")
    with h5py.File(path("tiny_chain_end.h5"), "w") as f:
        f.create_dataset("z", data=np.arange(-4, 5, dtype="<i8"))
    with h5py.File(path("ext_relative.h5"), "w") as f:
        f["x"] = h5py.ExternalLink("tiny_src.h5", "/x")
        f.create_dataset("local", data=np.arange(3, dtype="u1"))
    with h5py.File(path("ext_absolute.h5"), "w", libver="latest") as f:
        # a directory that exists nowhere: the library then looks for the
        # last component beside this file
        f["x"] = h5py.ExternalLink("/nonexistent/fixtures/tiny_src.h5", "x")
    with h5py.File(path("ext_group.h5"), "w") as f:
        f["g"] = h5py.ExternalLink("tiny_src.h5", "/grp")
    with h5py.File(path("ext_chain.h5"), "w", libver="latest") as f:
        # external -> soft -> external: tiny_src.h5's /grp/to_x and /onward
        f["via_soft"] = h5py.ExternalLink("tiny_src.h5", "/grp/to_x")
        f["via_two_files"] = h5py.ExternalLink("tiny_src.h5", "/onward")
        f["soft_to_ext"] = h5py.SoftLink("/via_two_files")
    with h5py.File(path("vds_self_strided.h5"), "w") as f:
        base = np.arange(8 * 12, dtype="<f4").reshape(8, 12)
        f.create_dataset("base", data=base)
        lay = h5py.VirtualLayout(shape=(4, 9), dtype="<f4")
        src = h5py.VirtualSource(".", "base", shape=base.shape)
        lay[:, 0:3] = src[0:8:2, 0:3]       # strided rows
        lay[:, 4:9:2] = src[1:5, 9:12]      # strided virtual columns
        lay[1:3, 0:2] = src[6:8, 10:12]     # overlaps the first mapping
        f.create_virtual_dataset("v", lay, fillvalue=-1.5)
    with h5py.File(path("vds_blocks.h5"), "w", libver="latest") as f:
        base = np.arange(6 * 16, dtype="<i4").reshape(6, 16)
        f.create_dataset("base", data=base)
        # blocks of 2 columns every 4 of the source into blocks of 2
        # every 3 of the virtual dataset
        _virtual_blocks(h5py, f, "v", (6, 12), ((0, 0), (1, 4), (1, 3),
                                                (6, 2)),
                        ".", "base", base.shape,
                        ((0, 0), (1, 4), (1, 4), (6, 2)), np.int32(7))
    with h5py.File(path("committed_type.h5"), "w", libver="latest") as f:
        f["le_f4"] = np.dtype("<f4")
        f["be_i2"] = np.dtype(">i2")
        f.create_dataset("x", data=small.astype("<f4") / 8,
                         dtype=f["le_f4"])
        f.create_dataset("y", data=small, dtype=f["be_i2"], chunks=(3, 5, 6),
                         compression="gzip")
    with h5py.File(path("nbit_small.h5"), "w") as f:
        signed = rng.integers(-300, 300, (5, 8, 9)).astype("<i2")
        _low_level(h5py, f, "signed_i2_p10", signed,
                   int_bits_type(h5py, h5py.h5t.STD_I16LE, 10, 3),
                   _dcpl_filters(h5py, (2, 8, 9),
                                 (h5py.h5z.FILTER_NBIT, 0, ())))
        floats = (rng.standard_normal((5, 8, 9)) * 50).astype("<f4")
        _low_level(h5py, f, "float_p20", floats, reduced_float_type(h5py),
                   _dcpl_filters(h5py, (5, 4, 9),
                                 (h5py.h5z.FILTER_NBIT, 0, ())))
    with h5py.File(path("szip_small.h5"), "w") as f:
        for dt, opt in (("<u2", ("nn", 8)), (">i4", ("ec", 16)),
                        ("<f8", ("nn", 32))):
            a = (np.cumsum(rng.standard_normal((6, 10, 12)), axis=-1)
                 * 40).astype(dt)
            order = "be" if dt[0] == ">" else "le"
            f.create_dataset(f"{opt[0]}{opt[1]}_{dt[1:]}_{order}", data=a,
                             chunks=(4, 6, 12), compression="szip",
                             compression_opts=opt)
    here = os.getcwd()
    os.chdir(d)  # external raw files are named relative to the working
    # directory, where the library writes them and looks for them
    try:
        with h5py.File("efl_two.h5", "w") as f:
            f.create_dataset("x", data=small, external=[
                ("efl_two_a.bin", 16, 40), ("efl_two_b.bin", 8,
                                            small.nbytes - 40)])
        return {name: h5_manifest(h5py, name)
                for name in sorted(os.listdir(d)) if name.endswith(".h5")}
    finally:
        os.chdir(here)


def sha256(a: np.ndarray) -> str:
    """Of the C-order bytes; a bool array's as 0 and 1 (PIL's 1-bit images
    hold True as 255)."""
    if a.dtype == bool:
        a = np.frombuffer(np.ascontiguousarray(a).tobytes(), np.uint8) != 0
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def entry(a: np.ndarray) -> dict:
    return {"shape": list(a.shape), "dtype": a.dtype.str, "sha256": sha256(a)}


def h5_manifest(h5py, path: str) -> dict:
    """Every dataset reachable from the root by keys() (soft links
    followed), and each group's keys()."""
    datasets, groups = {}, {}
    with h5py.File(path, "r") as f:
        def walk(g, prefix):
            groups[prefix or "/"] = list(g.keys())
            for k in g.keys():
                obj = g[k]
                if isinstance(obj, h5py.Datatype):
                    continue  # a committed datatype holds no data
                if isinstance(obj, h5py.Group):
                    walk(obj, f"{prefix}/{k}")
                else:
                    datasets[f"{prefix}/{k}"] = entry(obj[()])
        walk(f, "")
    return {"datasets": datasets, "groups": groups}


def image_manifest(path: str) -> dict:
    """What PIL's ``convert("L")`` / ``convert("RGB")`` (None where PIL does
    not open the file) and ``imageio.imread`` give for the image at
    ``path``."""
    import imageio
    from PIL import Image

    out = {}
    for m in ("L", "RGB"):
        try:
            with Image.open(path) as im:
                out["pil_" + m] = entry(np.asarray(im.convert(m)))
        except OSError:
            out["pil_" + m] = None
    out["imageio"] = entry(np.asarray(imageio.imread(path)))
    return out


def main(argv=None) -> int:
    import h5py

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=os.path.join(here, "tests",
                                                      "fixtures"))
    parser.add_argument("--only", choices=("orbax", "item20"),
                        help="rewrite only these fixtures and their "
                        "manifest entry")
    parser.add_argument("--orbax-worker", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--port", type=int, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.orbax_worker is not None:
        return orbax_worker(args.orbax_worker, args.port,
                            os.path.join(args.out))
    manifest_path = os.path.join(args.out, "manifest.json")
    if args.only is not None:
        with open(manifest_path) as f:
            manifest = json.load(f)
        if args.only == "orbax":
            manifest["orbax"] = orbax_fixtures(args.out)
        else:
            manifest["h5_item20"] = item20_fixtures(h5py, args.out)
        return _write_manifest(manifest, manifest_path, args.out)
    manifest = {"h5_latest": {}, "png_extra": {}, "image_formats": {}}
    h5_dir = os.path.join(args.out, "h5_latest")
    os.makedirs(h5_dir, exist_ok=True)
    rng = np.random.default_rng(SEED)
    for name, (libver, track, write) in h5_cases(h5py, rng).items():
        path = os.path.join(h5_dir, name)
        kw = ({"fs_strategy": "page", "fs_page_size": 4096}
              if "paged" in name and "superblock" in name else {})
        with h5py.File(path, "w", libver=libver, track_order=track,
                       **kw) as f:
            write(f)
        manifest["h5_latest"][name] = h5_manifest(h5py, path)
    path = os.path.join(h5_dir, "phantom_latest.h5")
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("raw", data=phantom(), chunks=(40, 85, 85),
                         maxshape=(None, None, None), shuffle=True,
                         compression="gzip")
    manifest["h5_latest"]["phantom_latest.h5"] = h5_manifest(h5py, path)
    manifest["h5_item20"] = item20_fixtures(h5py, args.out)
    rng = np.random.default_rng(SEED + 1)
    for name, (data, ch) in png_cases(rng).items():
        d = os.path.join(args.out, "png_extra", f"dsb_c{ch}", "images")
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"{name}.png")
        with open(path, "wb") as f:
            f.write(data)
        manifest["png_extra"][f"dsb_c{ch}/images/{name}.png"] = \
            image_manifest(path)
    from PIL import Image

    cases = image_cases(Image, np.random.default_rng(SEED + 2))
    cases.update(jpeg_cases(Image, np.random.default_rng(SEED + 3)))
    for name, write in cases.items():
        group, base = name.split("/")
        sub = "" if group in ("drive", "jpeg_drive") else "images"
        d = os.path.join(args.out, "image_formats", group, sub)
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, base)
        write(path)
        key = "/".join(p for p in (group, sub, base) if p)
        manifest["image_formats"][key] = image_manifest(path)
        if name in IMAGE_NOTES:
            manifest["image_formats"][key]["note"] = IMAGE_NOTES[name]
    manifest["orbax"] = orbax_fixtures(args.out)
    return _write_manifest(manifest, manifest_path, args.out)


def _write_manifest(manifest: dict, path: str, out: str) -> int:
    with open(path, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(os.path.getsize(os.path.join(r, n))
                for r, _, names in os.walk(out) for n in names)
    print(f"wrote {out}: {total} bytes")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

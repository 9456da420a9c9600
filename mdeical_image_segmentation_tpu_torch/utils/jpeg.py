"""A JPEG decoder: the markers parsed here, the scans, the inverse DCT,
upsampling and colour conversion in the host C of ``csrc/jpeg_decode.c``.
It gives the pixels PIL's ``Image.open`` holds, which libjpeg-turbo 3.1
decodes under PIL's defaults (islow IDCT, fancy upsampling, no block
smoothing needed), to the bit.

- Frames: SOF0 (baseline), SOF1 (extended Huffman, 8-bit) and SOF2
  (progressive: DC first and refinement, AC first with EOB runs, AC
  refinement), interleaved or not, one scan or many; restart intervals.
- One component is mode "L".  Three are mode "RGB": YCbCr converted, or
  RGB as stored, as libjpeg's ``default_decompress_parms`` decides from the
  JFIF APP0 marker, the Adobe APP14 transform and the component ids.
- Sampling: luma 1x1, 2x1 or 2x2, chroma 1x1 (4:4:4, 4:2:2, 4:2:0).
- A sequential scan whose Huffman table slot 0 or 1 was never defined
  (Motion-JPEG frames) takes Annex K's standard table, as libjpeg-turbo's
  Huffman decoder does (its progressive one raises).
- EXIF orientation is not applied (PIL and imageio do not apply it either).

Arithmetic coding, lossless and hierarchical frames, 12- and 16-bit
samples, four components (CMYK, YCCK), other sampling factors and
progressive files whose scans leave low coefficients unrefined (libjpeg
smooths those blocks) raise ``ImageError`` naming ROADMAP item 20c.  A
corrupt or truncated stream raises ``ImageError`` too.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .image_base import Decoded, ImageError, refused

SIGNATURE = b"\xff\xd8\xff"

_SOF_REFUSED = {
    0xC3: "lossless JPEG (SOF3)",
    0xC5: "hierarchical JPEG (SOF5)",
    0xC6: "hierarchical JPEG (SOF6)",
    0xC7: "hierarchical lossless JPEG (SOF7)",
    0xC8: "JPEG extension frame (JPG)",
    0xC9: "arithmetic-coded JPEG (SOF9)",
    0xCA: "arithmetic-coded progressive JPEG (SOF10)",
    0xCB: "arithmetic-coded lossless JPEG (SOF11)",
    0xCD: "hierarchical arithmetic-coded JPEG (SOF13)",
    0xCE: "hierarchical arithmetic-coded JPEG (SOF14)",
    0xCF: "hierarchical arithmetic-coded lossless JPEG (SOF15)",
}
# the quantiser positions libjpeg's smoothing_ok() reads (zig-zag 0-9)
_SMOOTH_Q = (0, 1, 8, 16, 9, 2, 3, 10, 17, 24)
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
# ITU-T T.81 Annex K.3's Huffman tables as DHT bodies (DC and AC, slot 0
# luminance, slot 1 chrominance): what libjpeg-turbo's jinit_huff_decoder
# installs (std_huff_tables) in the slots a sequential file leaves empty
_STD_DHT = bytes.fromhex(
    "0000010501010101010100000000000000000102030405060708090a0b1000020103"
    "03020403050504040000017d01020300041105122131410613516107227114328191"
    "a1082342b1c11552d1f02433627282090a161718191a25262728292a343536373839"
    "3a434445464748494a535455565758595a636465666768696a737475767778797a83"
    "8485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9ba"
    "c2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6"
    "f7f8f9fa0100030101010101010101010000000000000102030405060708090a0b11"
    "00020102040403040705040400010277000102031104052131061241510761711322"
    "328108144291a1b1c109233352f0156272d10a162434e125f11718191a262728292a"
    "35363738393a434445464748494a535455565758595a636465666768696a73747576"
    "7778797a82838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4"
    "b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2"
    "f3f4f5f6f7f8f9fa")
_C_ERRORS = {-1: "truncated JPEG scan", -2: "corrupt JPEG data (bad Huffman "
             "code)", -3: "corrupt JPEG data (restart marker)",
             -4: "corrupt JPEG Huffman table", -5: "corrupt JPEG data (DC "
             "overflow)", -6: "out of memory decoding a JPEG"}


def _lib():
    from ..ops import _build

    lib = _build.host_library("jpeg_decode.c")
    if lib.tpuseg_jpeg_scan.restype is not ctypes.c_int64:
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.tpuseg_jpeg_scan.argtypes = [p, i64, i64, p, p, p, p]
        lib.tpuseg_jpeg_scan.restype = i64
        lib.tpuseg_jpeg_output.argtypes = [p, p, i32, p, i32, i32, i32, p]
        lib.tpuseg_jpeg_output.restype = i32
    return lib


class _Frame:
    def __init__(self, sof: int, body: bytes):
        if len(body) < 6:
            raise ImageError("corrupt JPEG frame header")
        precision, self.height, self.width, n = (
            body[0], (body[1] << 8) | body[2], (body[3] << 8) | body[4],
            body[5])
        if len(body) != 6 + 3 * n:
            raise ImageError("corrupt JPEG frame header (length)")
        if precision != 8:
            raise refused(f"{precision}-bit JPEG")
        if self.height == 0 or self.width == 0 or n == 0:
            raise ImageError("empty JPEG image (zero size or DNL height)")
        if n == 4:
            raise refused("four-component (CMYK / YCCK) JPEG")
        if n not in (1, 3):
            raise refused(f"{n}-component JPEG")
        self.progressive = sof == 0xC2
        self.ids, self.h, self.v, self.tq = [], [], [], []
        for i in range(n):
            cid, hv, tq = body[6 + 3 * i:9 + 3 * i]
            h, v = hv >> 4, hv & 15
            if not (1 <= h <= 4 and 1 <= v <= 4) or tq > 3:
                raise ImageError("corrupt JPEG frame header (sampling or "
                                 "table)")
            self.ids.append(cid)
            self.h.append(h)
            self.v.append(v)
            self.tq.append(tq)
        if len(set(self.ids)) != n:
            raise ImageError("corrupt JPEG frame header (repeated component "
                             "id)")
        if n == 3 and ((self.h[0], self.v[0]) not in ((1, 1), (2, 1), (2, 2))
                       or self.h[1:] != [1, 1] or self.v[1:] != [1, 1]):
            raise refused("JPEG sampling " + ", ".join(
                f"{h}x{v}" for h, v in zip(self.h, self.v)))
        self.maxh, self.maxv = max(self.h), max(self.v)
        self.mcus_x = -(-self.width // (8 * self.maxh))
        self.mcus_y = -(-self.height // (8 * self.maxv))
        # every component's plane covers the interleaved MCU grid
        self.stride = [self.mcus_x * h for h in self.h]
        rows = [self.mcus_y * v for v in self.v]
        self.offset = np.cumsum([0] + [s * r for s, r in
                                       zip(self.stride, rows)]).tolist()
        self.coefs = np.zeros((self.offset[-1], 64), np.int16)
        self.latched = [None] * n  # quantisation tables, at the first scan
        self.coef_bits = np.full((n, 64), -1, np.int64)  # progressive state
        self.single_scan = False  # a sequential first scan of every component


def _scan(data: bytes, body: bytes, pos: int, frame: _Frame, tables: dict,
          restart: int, scans_done: int) -> int:
    """Decode one scan whose data starts at ``pos``; the position of the
    marker after it."""
    n = body[0] if body else 0
    if n < 1 or n > 4 or len(body) != 4 + 2 * n:
        raise ImageError("corrupt JPEG scan header")
    comps = []
    for i in range(n):
        cid, t = body[1 + 2 * i], body[2 + 2 * i]
        if cid not in frame.ids:
            raise ImageError("corrupt JPEG scan header (component id)")
        ci = frame.ids.index(cid)
        if ci in [c[0] for c in comps]:
            raise ImageError("corrupt JPEG scan header (repeated component)")
        comps.append((ci, t >> 4, t & 15))
    ss, se, a = body[1 + 2 * n], body[2 + 2 * n], body[3 + 2 * n]
    ah, al = a >> 4, a & 15
    if frame.progressive:
        dc = ss == 0
        if ((dc and se != 0) or (not dc and (ss > se or se > 63 or n != 1))
                or (ah != 0 and al != ah - 1) or al > 13):
            raise ImageError("corrupt JPEG progression (scan parameters)")
        for ci, _, _ in comps:
            bits = frame.coef_bits[ci]
            if not dc and bits[0] < 0:
                raise ImageError("corrupt JPEG progression (AC before DC)")
            expected = np.maximum(bits[ss:se + 1], 0)
            if (expected != ah).any():
                raise ImageError("corrupt JPEG progression (refinement "
                                 "order)")
            bits[ss:se + 1] = al
    elif frame.single_scan:
        raise ImageError("corrupt JPEG: a scan after a sequential scan of "
                         "every component")
    else:
        ss, se, ah, al = 0, 63, 0, 0  # libjpeg ignores them (a warning)
        frame.single_scan = scans_done == 0 and n == len(frame.ids)
    need_dc = not frame.progressive or (ss == 0 and ah == 0)
    need_ac = not frame.progressive or ss > 0
    for ci, td, ta in comps:
        for kind, slot, needed in (("dc", td, need_dc), ("ac", ta, need_ac)):
            if not needed or slot in tables[kind]:
                continue
            if slot > 1 or frame.progressive:
                raise ImageError("corrupt JPEG: a scan uses an undefined "
                                 "Huffman table")
            std = {"dc": {}, "ac": {}}
            _dht(_STD_DHT, std)
            tables[kind][slot] = std[kind][slot]
        if frame.latched[ci] is None:
            tq = frame.tq[ci]
            if tq not in tables["q"]:
                raise ImageError("corrupt JPEG: a quantisation table is "
                                 "missing")
            frame.latched[ci] = tables["q"][tq].copy()
    if n == 1:
        ci = comps[0][0]
        w = -(-frame.width * frame.h[ci] // frame.maxh)
        h = -(-frame.height * frame.v[ci] // frame.maxv)
        mcus = (-(-w // 8), -(-h // 8))
        hv = [(1, 1)]
    else:
        mcus = (frame.mcus_x, frame.mcus_y)
        hv = [(frame.h[ci], frame.v[ci]) for ci, _, _ in comps]
    desc = [n, ss, se, ah, al, int(frame.progressive), restart, *mcus]
    for (ci, td, ta), (h, v) in zip(comps, hv):
        desc += [frame.offset[ci], frame.stride[ci], h, v, td, ta, ci]
    desc = np.array(desc, np.int32)
    counts = np.zeros((8, 16), np.uint8)
    values = np.zeros((8, 256), np.uint8)
    for k, (c, vals) in tables["dc"].items():
        counts[k], values[k, :len(vals)] = c, vals
    for k, (c, vals) in tables["ac"].items():
        counts[4 + k], values[4 + k, :len(vals)] = c, vals
    src = np.frombuffer(data, np.uint8)
    end = _lib().tpuseg_jpeg_scan(
        src.ctypes.data, len(src), pos, desc.ctypes.data, counts.ctypes.data,
        values.ctypes.data, frame.coefs.ctypes.data)
    if end < 0:
        raise ImageError(_C_ERRORS.get(end, "corrupt JPEG data"))
    return int(end)


def _next_marker(data: bytes, pos: int):
    """libjpeg's next_marker: skip bytes to an FF, fill FFs, FF/00 pairs;
    (marker code, position after it)."""
    n = len(data)
    while True:
        while pos < n and data[pos] != 0xFF:
            pos += 1
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            raise ImageError("truncated JPEG file (no EOI)")
        if data[pos] != 0:
            return data[pos], pos + 1
        pos += 1


def _segment(data: bytes, pos: int):
    length = int.from_bytes(data[pos:pos + 2], "big")
    if length < 2 or pos + length > len(data):
        raise ImageError("truncated JPEG marker segment")
    return data[pos + 2:pos + length], pos + length


def _dht(body: bytes, tables: dict):
    p = 0
    while p < len(body):
        if p + 17 > len(body):
            raise ImageError("corrupt JPEG Huffman table")
        index = body[p]
        counts = np.frombuffer(body[p + 1:p + 17], np.uint8)
        total = int(counts.sum())
        if index & 0xEC or total > 256 or p + 17 + total > len(body):
            raise ImageError("corrupt JPEG Huffman table")
        vals = np.frombuffer(body[p + 17:p + 17 + total], np.uint8)
        tables["ac" if index & 0x10 else "dc"][index & 3] = (counts, vals)
        p += 17 + total


def _dqt(body: bytes, tables: dict):
    p = 0
    while p < len(body):
        index = body[p]
        prec, slot = index >> 4, index & 15
        size = 64 * (prec + 1)
        if prec > 1 or slot > 3 or p + 1 + size > len(body):
            raise ImageError("corrupt JPEG quantisation table")
        raw = np.frombuffer(body[p + 1:p + 1 + size],
                            np.uint8 if prec == 0 else ">u2")
        q = np.zeros(64, np.int64)
        q[_ZIGZAG] = raw
        # libjpeg's ISLOW_MULT_TYPE is a short
        tables["q"][slot] = q.astype(np.uint16).view(np.int16)
        p += 1 + size


def _dac(body: bytes):
    """Arithmetic conditioning: no effect on Huffman scans, but libjpeg
    refuses the values its get_dac refuses."""
    if len(body) % 2:
        raise ImageError("corrupt JPEG arithmetic conditioning")
    for index, value in zip(body[::2], body[1::2]):
        if index >= 32 or (index < 16 and (value & 15) > (value >> 4)):
            raise ImageError("corrupt JPEG arithmetic conditioning")


def _transform(frame: _Frame, jfif: bool, adobe) -> int:
    """0 grey, 1 YCbCr -> RGB, 2 RGB as stored (default_decompress_parms)."""
    if len(frame.ids) == 1:
        return 0
    if jfif:
        return 1
    if adobe is not None:
        return 2 if adobe == 0 else 1
    if frame.ids == [82, 71, 66]:  # 'R', 'G', 'B'
        return 2
    return 1


def _check_smoothing(frame: _Frame):
    """libjpeg smooths the blocks of a progressive file whose scans leave any
    of coefficients 1-9 unrefined (jdcoefct.c's smoothing_ok); refused."""
    if not frame.progressive or any(q is None for q in frame.latched):
        return
    if any((q[list(_SMOOTH_Q)] == 0).any() for q in frame.latched):
        return
    bits = frame.coef_bits
    if (bits[:, 0] < 0).any():
        return
    if (bits[:, 1:10] != 0).any():
        raise refused("progressive JPEG whose scans leave low coefficients "
                      "unrefined (block smoothing)")


def decode(data: bytes) -> Decoded:
    if not data.startswith(SIGNATURE):
        raise ImageError("not a JPEG file (no SOI and marker)")
    tables = {"dc": {}, "ac": {}, "q": {}}
    frame, restart, scans, jfif, adobe = None, 0, 0, False, None
    pos = 2
    while True:
        marker, pos = _next_marker(data, pos)
        if marker == 0xD9:  # EOI
            break
        if 0xD0 <= marker <= 0xD7 or (marker == 0x01 and scans):
            continue  # RSTn, TEM: no body (PIL's header parser refuses TEM)
        if marker == 0xD8:
            raise ImageError("corrupt JPEG: a second SOI")
        body, pos = _segment(data, pos)
        if marker in (0xC0, 0xC1, 0xC2):
            if frame is not None:
                raise ImageError("corrupt JPEG: a second frame header")
            frame = _Frame(marker, body)
        elif marker in _SOF_REFUSED:
            raise refused(_SOF_REFUSED[marker])
        elif marker == 0xC4:
            _dht(body, tables)
        elif marker == 0xDB:
            _dqt(body, tables)
        elif marker == 0xCC:
            _dac(body)
        elif marker == 0xDD:
            if len(body) != 2:
                raise ImageError("corrupt JPEG restart interval")
            restart = (body[0] << 8) | body[1]
        elif marker == 0xDA:
            if frame is None:
                raise ImageError("corrupt JPEG: a scan before the frame "
                                 "header")
            pos = _scan(data, body, pos, frame, tables, restart, scans)
            scans += 1
        elif marker == 0xE0:
            jfif = jfif or (len(body) >= 14 and body[:5] == b"JFIF\0")
        elif marker == 0xEE:
            if len(body) >= 12 and body[:5] == b"Adobe":
                adobe = body[11]
        elif not (0xE1 <= marker <= 0xEF or marker in (0xFE, 0xDC)):
            raise ImageError(f"corrupt JPEG: unknown marker 0x{marker:02X}")
    if frame is None or scans == 0:
        raise ImageError("JPEG file without an image")
    _check_smoothing(frame)
    n = len(frame.ids)
    comps = np.array([[frame.offset[i], frame.stride[i], frame.h[i],
                       frame.v[i]] for i in range(n)], np.int32)
    qt = np.stack([q if q is not None else np.zeros(64, np.int16)
                   for q in frame.latched])
    out = np.empty((frame.height, frame.width, n), np.uint8)
    rc = _lib().tpuseg_jpeg_output(
        frame.coefs.ctypes.data, comps.ctypes.data, n, qt.ctypes.data,
        frame.width, frame.height, _transform(frame, jfif, adobe),
        out.ctypes.data)
    if rc:
        raise ImageError(_C_ERRORS.get(rc, "corrupt JPEG data"))
    if n == 1:
        return Decoded("L", out.reshape(frame.height, frame.width))
    return Decoded("RGB", out)

"""The port's PNG decoder (``utils/png.py``) against PIL, and its C unfilter
(``csrc/png_unfilter.c``) against the Python loop it replaced, kept here as
the reference.  Every comparison is exact: a decoder either gives PIL's
bytes or is wrong."""

import io
import struct
import time
import zlib

import numpy as np
import pytest
from PIL import Image

from mdeical_image_segmentation_tpu_torch.ops import _build
from mdeical_image_segmentation_tpu_torch.utils import png

_CT_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


# -- the Python reference: the loop the decoder ran before the C unfilter ----

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


def python_unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for r in range(h):
        pos = r * (stride + 1)
        ftype = raw[pos]
        line = np.frombuffer(raw, np.uint8, stride, pos + 1)
        if ftype == 0:
            cur = line
        elif ftype == 1:
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif ftype == 2:
            cur = line + prev
        elif ftype == 3:
            cur = np.frombuffer(
                _unfilter_average(line.tobytes(), prev.tobytes(), bpp),
                np.uint8)
        else:
            cur = np.frombuffer(
                _unfilter_paeth(line.tobytes(), prev.tobytes(), bpp),
                np.uint8)
        out[r] = cur
        prev = out[r]
    return out


# -- a PNG writer with any colour type, depth and per-row filter -------------

def _filter_row(ftype, cur, prev, bpp):
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


def _pack_rows(samples, depth):
    """(H, W, ch) sample values → (H, stride) bytes of one image row each."""
    h, w, ch = samples.shape
    if depth == 8:
        return samples.astype(np.uint8).reshape(h, w * ch)
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, w * ch * 2)
    bits = ((samples.reshape(h, w * ch, 1).astype(np.uint8)
             >> np.arange(depth - 1, -1, -1, dtype=np.uint8)) & 1)
    return np.packbits(bits.reshape(h, -1), axis=1)


def make_png(samples, colour_type, depth, filters, palette=None):
    """PNG bytes of ``samples`` (H, W, ch) with row r filtered by
    ``filters[r % len(filters)]``."""
    h, w, ch = samples.shape
    rows = _pack_rows(samples, depth)
    bpp = max(ch * depth // 8, 1)
    data, prev = [], bytes(rows.shape[1])
    for r in range(h):
        cur = rows[r].tobytes()
        ftype = filters[r % len(filters)]
        data.append(bytes([ftype]) + _filter_row(ftype, cur, prev, bpp))
        prev = cur

    def chunk(t, body):
        return (struct.pack(">I", len(body)) + t + body
                + struct.pack(">I", zlib.crc32(t + body)))

    out = b"\x89PNG\r\n\x1a\n" + chunk(
        b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour_type, 0, 0, 0))
    if palette is not None:
        out += chunk(b"PLTE", palette.tobytes())
    return out + chunk(b"IDAT", zlib.compress(b"".join(data))) + chunk(
        b"IEND", b"")


_CASES = ([(0, d) for d in (1, 2, 4, 8, 16)] + [(2, 8), (2, 16)]
          + [(3, d) for d in (1, 2, 4, 8)] + [(4, 8), (4, 16), (6, 8),
                                              (6, 16)])


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,),
                                     (4, 3, 0, 1, 2)])
@pytest.mark.parametrize("colour_type,depth", _CASES)
def test_decode_and_convert_match_pil(colour_type, depth, filters):
    """Every colour type at every bit depth the format allows, each row
    filter alone and mixed, odd widths (sub-byte rows end in padding)."""
    rng = np.random.default_rng(colour_type * 100 + depth + 7 * filters[0])
    ch = _CT_CHANNELS[colour_type]
    h, w = 7, 13
    palette = None
    if colour_type == 3:
        n = min(1 << depth, 40)
        palette = rng.integers(0, 256, (n, 3), dtype=np.uint8)
        samples = rng.integers(0, n, (h, w, 1))
    else:
        samples = rng.integers(0, 1 << depth, (h, w, ch))
    data = make_png(samples, colour_type, depth, filters, palette)
    img = png.decode(data)
    np.testing.assert_array_equal(img.pixels, samples)
    pil = Image.open(io.BytesIO(data))
    for mode in ("L", "RGB"):
        np.testing.assert_array_equal(png.convert(img, mode),
                                      np.asarray(pil.convert(mode)),
                                      err_msg=f"{pil.mode} -> {mode}")


@pytest.mark.parametrize("bpp,stride", [(1, 1), (1, 13), (2, 26), (3, 39),
                                        (4, 52), (6, 78), (8, 104)])
def test_c_unfilter_equals_the_python_loop(bpp, stride):
    """Random filtered bytes (any byte string is a valid filtered row) with
    every filter type, row by row."""
    rng = np.random.default_rng(bpp * 31 + stride)
    h = 23
    body = rng.integers(0, 256, (h, stride), dtype=np.uint8)
    ftypes = np.asarray([r % 5 for r in range(h)], np.uint8)
    rng.shuffle(ftypes)
    raw = np.concatenate([ftypes[:, None], body], axis=1).tobytes()
    np.testing.assert_array_equal(png._unfilter(raw, h, stride, bpp),
                                  python_unfilter(raw, h, stride, bpp))


def test_paeth_rgb_384_decodes_20x_faster_than_the_python_loop():
    """The decode time of ROADMAP F1's worst case (384² RGB, Paeth on every
    row), the C unfilter against the Python loop, on the CPU running the
    test."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[:384, :384]
    rgb = np.stack([(xx + yy) % 256, (3 * xx) % 256,
                    rng.integers(0, 256, (384, 384))], -1)
    data = make_png(rgb, 2, 8, (4,))
    png.decode(data)  # builds the library
    t0 = time.perf_counter()
    for _ in range(5):
        img = png.decode(data)
    c_ms = (time.perf_counter() - t0) / 5 * 1e3
    raw = zlib.decompress(data[data.index(b"IDAT") + 4:-16])
    t0 = time.perf_counter()
    rows = python_unfilter(raw, 384, 384 * 3, 3)
    py_ms = (time.perf_counter() - t0) * 1e3
    np.testing.assert_array_equal(img.pixels.reshape(384, -1), rows)
    print(f"384x384 RGB Paeth: decode {c_ms:.2f} ms, python unfilter "
          f"{py_ms:.1f} ms ({py_ms / c_ms:.0f}x)")
    assert py_ms >= 20 * c_ms


def test_unknown_filter_and_bad_depth_raise_png_error():
    data = bytearray(make_png(np.zeros((3, 4, 1), np.uint8), 0, 8, (0,)))
    raw = zlib.decompress(bytes(data[data.index(b"IDAT") + 4:-16]))
    bad = bytearray(raw)
    bad[5] = 7  # row 1's filter type
    with pytest.raises(png.PngError, match="unknown row filter type 7"):
        png._unfilter(bytes(bad), 3, 4, 1)
    with pytest.raises(png.PngError, match="bit depth 16 for colour type 3"):
        png.decode(make_png(np.zeros((2, 2, 1), np.uint16), 3, 16, (0,),
                            np.zeros((1, 3), np.uint8)))


def test_missing_compiler_raises_before_building(monkeypatch, tmp_path):
    """No fallback: without a C compiler the unfilter cannot be built, and
    the decoder says so."""
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    with pytest.raises(RuntimeError, match="no C compiler"):
        _build.find_cc()
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_host_libs", {})
    with pytest.raises(RuntimeError, match="no C compiler"):
        png.decode(make_png(np.zeros((2, 2, 1), np.uint8), 0, 8, (3,)))

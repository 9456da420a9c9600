"""What the port's image decoders share (``utils/png.py``, ``tiff.py``,
``gif.py``, ``bmp.py``, ``jpeg.py``; ``utils/image.py`` picks among them).

- ``ImageError``: the one base of every decoder's error (``PngError``
  included), which the server answers with a 400.
- ``Decoded``: an image as PIL's ``Image.open`` holds it, by PIL's mode
  ("1", "L", "LA", "P", "I;16", "F", "RGB", "RGBA"), and ``convert``: PIL's
  ``convert("L" | "RGB")`` of it.
- ``as_imageio``: what ``imageio.imread`` returns for such an image when
  its pillow plugin reads it (GIF, BMP, JPEG): a palette applied, "1" as
  bool.
- The host C of ``csrc/lzw_decode.c`` (LZW, PackBits), built at first use.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import numpy as np

FORMATS_ITEM = "ROADMAP.md queue 1, item 20c"


class ImageError(ValueError):
    """An image file the port's decoders do not take, or a corrupt one."""


def refused(what: str) -> ImageError:
    """The error for a variant the decoders do not read yet."""
    return ImageError(f"{what} is not read yet ({FORMATS_ITEM})")


@dataclass
class Decoded:
    mode: str
    # (H, W): "1" bool, "L" / "P" (indices) uint8, "I;16" uint16, "F"
    # float32; (H, W, C) uint8 for "LA", "RGB", "RGBA"
    pixels: np.ndarray
    # (256, 3) uint8 for "P"; on an "L" GIF, the global table PIL keeps
    palette: Optional[np.ndarray] = None


def palette256(entries) -> np.ndarray:
    """(256, 3) uint8: the given RGB entries, the rest black (PIL's palette
    past its last entry)."""
    out = np.zeros((256, 3), np.uint8)
    entries = np.asarray(entries, np.uint8).reshape(-1, 3)[:256]
    out[:len(entries)] = entries
    return out


def luma(rgb: np.ndarray) -> np.ndarray:
    """PIL's L of RGB: (R*19595 + G*38470 + B*7471 + 0x8000) >> 16."""
    r, g, b = (rgb[..., i].astype(np.uint32) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(np.uint8)


def _grey(img: Decoded) -> Optional[np.ndarray]:
    """The 8-bit grey of a one-channel mode (None for the colour modes)."""
    px = img.pixels
    if img.mode == "1":
        return np.where(px, np.uint8(255), np.uint8(0))
    if img.mode == "L":
        return px
    if img.mode == "LA":
        return px[..., 0]
    if img.mode == "I;16":
        return np.minimum(px, 255).astype(np.uint8)
    if img.mode == "F":  # truncated toward zero, clipped; NaN is 0
        f = np.clip(np.where(np.isnan(px), np.float32(0), px), 0, 255)
        return np.trunc(f).astype(np.uint8)
    return None


def convert(img: Decoded, mode: str) -> np.ndarray:
    """PIL's ``convert(mode)`` for mode "L" (→ (H, W)) or "RGB"
    (→ (H, W, 3)), alpha dropped."""
    if mode not in ("L", "RGB"):
        raise ValueError(f"convert to {mode!r}: expected 'L' or 'RGB'")
    grey = _grey(img)
    if grey is not None:
        if mode == "L":
            return grey
        if img.palette is not None:  # PIL's "L" GIF under a global table
            return img.palette[grey]
        return np.repeat(grey[..., None], 3, axis=-1)
    if img.mode == "P":
        rgb = img.palette[img.pixels]
    elif img.mode in ("RGB", "RGBA"):
        rgb = img.pixels[..., :3]
    else:
        raise ValueError(f"unknown image mode {img.mode!r}")
    return luma(rgb) if mode == "L" else np.ascontiguousarray(rgb)


def as_imageio(img: Decoded) -> np.ndarray:
    """``imageio.imread`` through its pillow plugin: a palette image as RGB,
    every other mode as PIL holds it ("1" as bool)."""
    if img.mode == "P":
        return img.palette[img.pixels]
    return img.pixels


def unpack_bits(rows: np.ndarray, bits: int, n: int) -> np.ndarray:
    """The first ``n`` ``bits``-wide values (MSB first) of each row of a
    (rows, bytes) uint8 array, as (rows, n) uint8 (1, 2 or 4 bits)."""
    b = np.unpackbits(rows, axis=1)[:, :n * bits]
    weights = (1 << np.arange(bits - 1, -1, -1)).astype(np.uint8)
    return (b.reshape(rows.shape[0], n, bits) @ weights).astype(np.uint8)


def unpremultiply(rgba: np.ndarray) -> np.ndarray:
    """PIL's "RGBa" unpacking of associated alpha: each colour
    min(255, c * 255 // a), all four 0 where a = 0."""
    a = rgba[..., 3:4].astype(np.uint32)
    c = rgba[..., :3].astype(np.uint32)
    safe = np.maximum(a, 1)
    rgb = np.where(a == 0, 0, np.minimum(c * 255 // safe, 255))
    return np.concatenate([rgb, a], axis=-1).astype(np.uint8)


# -- host C ------------------------------------------------------------------


def _c(name: str, nargs: int):
    from ..ops import _build

    fn = getattr(_build.host_library("lzw_decode.c"), name)
    if fn.restype is not ctypes.c_int64:
        args = [ctypes.c_void_p, ctypes.c_int64]
        if nargs == 5:
            args.append(ctypes.c_int64)
        fn.argtypes = args + [ctypes.c_void_p, ctypes.c_int64]
        fn.restype = ctypes.c_int64
    return fn


def _run(fn, data: bytes, out_len: int, *extra) -> bytes:
    src = np.frombuffer(data, np.uint8)
    out = np.zeros(max(out_len, 1), np.uint8)
    n = fn(src.ctypes.data, len(src), *extra, out.ctypes.data, out_len)
    if n < 0:
        raise ImageError(f"corrupt {fn.__name__[7:].replace('_', ' ')} "
                         "stream")
    return out[:n].tobytes()


def tiff_lzw_decode(data: bytes, out_len: int) -> bytes:
    """At most ``out_len`` bytes of a TIFF LZW strip or tile (MSB-first,
    early change)."""
    return _run(_c("tpuseg_tiff_lzw_decode", 4), data, out_len)


def gif_lzw_decode(data: bytes, min_code_size: int, out_len: int) -> bytes:
    """At most ``out_len`` indices of a GIF image's LZW data (the
    sub-blocks concatenated)."""
    return _run(_c("tpuseg_gif_lzw_decode", 5), data, out_len, min_code_size)


def packbits_decode(data: bytes, out_len: int) -> bytes:
    return _run(_c("tpuseg_packbits_decode", 4), data, out_len)

"""The port's one entry point for reading image files, in place of PIL's
``Image.open(path).convert(mode)`` (the 2D datasets, the server) and of
``imageio.imread(path)`` (DSB2018).

The decoder is picked by the file's first bytes, never by its name:
``\\x89PNG`` PNG (``utils/png.py``), ``II*\\0`` / ``MM\\0*`` and BigTIFF's
``II+\\0`` / ``MM\\0+`` TIFF (``utils/tiff.py``), ``GIF87a`` / ``GIF89a``
GIF (``utils/gif.py``), ``BM`` BMP (``utils/bmp.py``) and ``\\xff\\xd8\\xff``
JPEG (``utils/jpeg.py``).  Any other file, and the variants of these
formats the decoders do not read yet, raise ``ImageError`` naming ROADMAP
item 20c.
"""

from __future__ import annotations

import numpy as np

from . import bmp, gif, jpeg, png, tiff
from .image_base import FORMATS_ITEM, ImageError, as_imageio, convert

__all__ = ["ImageError", "kind", "read", "imread"]
_DECODERS = {"tiff": tiff.decode, "gif": gif.decode, "bmp": bmp.decode,
             "jpeg": jpeg.decode}


def kind(data: bytes) -> str:
    """"png", "tiff", "gif", "bmp" or "jpeg" by the leading bytes; else
    raises."""
    if data.startswith(png.SIGNATURE):
        return "png"
    if data[:4] in tiff.SIGNATURES:
        return "tiff"
    if data[:6] in gif.SIGNATURES:
        return "gif"
    if data.startswith(bmp.SIGNATURE):
        return "bmp"
    if data.startswith(jpeg.SIGNATURE):
        return "jpeg"
    raise ImageError("not a PNG, TIFF, GIF, BMP or JPEG file: read are PNG, "
                     f"TIFF, GIF, BMP and JPEG ({FORMATS_ITEM})")


def read(path: str, mode: str) -> np.ndarray:
    """PIL's ``Image.open(path).convert(mode)`` for mode "L" (→ (H, W)
    uint8) or "RGB" (→ (H, W, 3) uint8)."""
    with open(path, "rb") as f:
        data = f.read()
    k = kind(data)
    if k == "png":
        return png.convert(png.decode(data), mode)
    return convert(_DECODERS[k](data), mode)


def _png_imread(data: bytes) -> np.ndarray:
    """imageio's reading of a PNG: (H, W) for grey, else (H, W, C); palette
    images as RGB, 1-bit grey as bool, 2- and 4-bit grey scaled to 0..255,
    16-bit grey kept, 16-bit colour cut to its high byte and 16-bit grey +
    alpha as RGBA, the grey repeated."""
    img = png.decode(data)
    px, ct = img.pixels, img.colour_type
    if ct == 3:  # palette: RGB, tRNS or not
        return img.palette[px[..., 0]]
    if img.depth == 16 and ct != 0:  # the high byte; grey + alpha as RGBA
        high = (px >> 8).astype(np.uint8)
        if ct == 4:
            return np.concatenate([np.repeat(high[..., :1], 3, axis=-1),
                                   high[..., 1:]], axis=-1)
        return high
    if img.depth == 1:
        return px[..., 0] != 0
    if img.depth < 8:  # 2- and 4-bit grey scaled to 0..255
        return png.convert(img, "L")
    return px[..., 0] if px.shape[-1] == 1 else px


def imread(path: str) -> np.ndarray:
    """What ``imageio.imread(path)`` returns for a file under its own
    extension: PNG, GIF, BMP and JPEG through imageio's pillow plugin (a
    palette applied, "1" as bool; a JPEG as decoded, (H, W) grey or (H, W,
    3)), TIFF through its vendored tifffile (``tiff.imread``)."""
    with open(path, "rb") as f:
        data = f.read()
    k = kind(data)
    if k == "png":
        return _png_imread(data)
    if k == "tiff":
        return tiff.imread(data)
    return as_imageio(_DECODERS[k](data))

"""The port's PNG paths on the PNGs PIL and imageio read for the JAX
package and the port refused before: Adam7-interlaced PNGs of every colour
type and bit depth (``png.decode`` / ``png.read`` equal to PIL's
``Image.open(p).convert("L" | "RGB")``, odd sizes whose reduced images are
empty or one pixel wide included), and the DSB reader (``data/dsb.py``) on
palette (1-8 bits, with and without tRNS), 1-, 2- and 4-bit grey and
16-bit RGB, grey + alpha and RGBA PNGs, plain and interlaced: equal to the
JAX package's ``DSB2018Dataset`` (imageio) to the bit, dtypes included.
The committed fixtures (``scripts/make_port_fixtures.py``) are re-read
with imageio and PIL against their manifest, which chip_smoke.py holds
the port to on the card."""

import io
import json
import os

import numpy as np
import pytest
from PIL import Image

from mdeical_image_segmentation_tpu_torch.data import dsb
from mdeical_image_segmentation_tpu_torch.utils import image, png

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "fixtures")
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
CASES = ([(0, d) for d in (1, 2, 4, 8, 16)] + [(2, 8), (2, 16)]
         + [(3, d) for d in (1, 2, 4, 8)] + [(4, 8), (4, 16), (6, 8),
                                             (6, 16)])
TRANSFORMER = {"raw": [{"name": "Standardize"},
                       {"name": "ToTensor", "expand_dims": True}],
               "label": [{"name": "ToTensor", "expand_dims": True}]}


def _script():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_port_fixtures", os.path.join(HERE, "..", "scripts",
                                           "make_port_fixtures.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _manifest():
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        return json.load(f)["png_extra"]


@pytest.mark.parametrize("colour_type,depth", CASES)
def test_interlaced_pngs_match_pil(colour_type, depth):
    script = _script()
    rng = np.random.default_rng(colour_type * 100 + depth)
    for h, w in [(13, 11), (1, 1), (3, 2), (9, 17)]:
        palette = None
        if colour_type == 3:
            n = min(1 << depth, 40)
            palette = rng.integers(0, 256, (n, 3), dtype=np.uint8)
            samples = rng.integers(0, n, (h, w, 1))
        else:
            samples = rng.integers(0, 1 << depth,
                                   (h, w, CHANNELS[colour_type]))
        data = script.encode_png(samples, colour_type, depth, palette,
                                 interlace=True)
        img = png.decode(data)
        np.testing.assert_array_equal(img.pixels, samples)
        pil = Image.open(io.BytesIO(data))
        assert pil.info.get("interlace") == 1
        for mode in ("L", "RGB"):
            np.testing.assert_array_equal(png.convert(img, mode),
                                          np.asarray(pil.convert(mode)),
                                          err_msg=f"{pil.mode} -> {mode}")


def test_short_interlaced_data_raises():
    script = _script()
    data = script.encode_png(np.zeros((9, 9, 1), np.uint8), 0, 8)
    at = data.index(b"IHDR") + 4 + 12  # the interlace byte
    body = bytearray(data[at - 12 - 4:at + 1])
    body[-1] = 1
    import struct
    import zlib

    forged = (data[:at - 12 - 4] + bytes(body)
              + struct.pack(">I", zlib.crc32(bytes(body))) + data[at + 5:])
    with pytest.raises(png.PngError, match="interlaced image data shorter"):
        png.decode(forged)


@pytest.mark.parametrize("name", sorted(_manifest()))
def test_png_fixtures_match_the_manifest(name):
    """imageio and PIL give the manifest's arrays for each committed PNG,
    and so do the port's DSB reader and ``png.read``."""
    script = _script()
    path = os.path.join(FIXTURES, "png_extra", name)
    want = _manifest()[name]
    assert script.image_manifest(path) == want
    assert script.entry(image.imread(path)) == want["imageio"]
    for mode in ("L", "RGB"):
        assert script.entry(png.read(path, mode)) == want[f"pil_{mode}"]


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("expand_dims", [True, False])
def test_dsb_dataset_equals_jax_on_the_new_pngs(channels, expand_dims):
    from mdeical_image_segmentation_tpu.data import dsb as jax_dsb

    root = os.path.join(FIXTURES, "png_extra", f"dsb_c{channels}")
    ours = dsb.DSB2018Dataset(root, "test", TRANSFORMER, expand_dims)
    theirs = jax_dsb.DSB2018Dataset(root, "test", TRANSFORMER, expand_dims)
    assert ours.paths == theirs.paths and len(ours) >= 4
    for a, b in zip(ours.images, theirs.images):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    if expand_dims:  # the transforms take the C(Z)HW layout
        for i in range(len(ours)):
            (u, p), (v, q) = ours[i], theirs[i]
            assert p == q and u.dtype == v.dtype
            np.testing.assert_array_equal(u, v)

"""The port's TIFF, GIF and BMP readers (``utils/image.py`` over
``utils/tiff.py``, ``gif.py``, ``bmp.py`` and ``csrc/lzw_decode.c``) against
PIL and imageio, which the JAX package reads them with.

- Every committed fixture of ``tests/fixtures/image_formats``
  (``scripts/make_port_fixtures.py``): ``image.read(p, "L" | "RGB")`` equal
  to PIL's ``Image.open(p).convert(mode)`` and ``image.imread(p)`` to
  ``imageio.imread(p)``, dtypes and shapes included, and both equal to the
  manifest the card's run is held to.
- A TIFF matrix written here (byte order x BigTIFF x strips, tiles and
  planar x codec), GIF interlace at every row count up to 17 and LZW at
  every code size, PIL's RLE decoder's quirks: the same.
- LZW and PackBits round trips through the C decoders.
- ``DRIVEDataset`` over a TIFF + GIF DRIVE layout, ``_build_input`` of the
  server and ``DSB2018Dataset`` over the fixture directories, each equal to
  the JAX package's.
- The JPEG variants the port refuses (arithmetic coding, lossless and
  hierarchical frames, 12 bits, CMYK, other sampling factors, unrefined
  progressive scans) and every refused TIFF variant
  raise ``ImageError`` naming ROADMAP item 20c, and the server answers
  them with a 400.  (The JPEGs it reads: ``test_torch_port_jpeg.py``.)
"""

import io
import json
import os
import types
import warnings

import imageio
import numpy as np
import pytest
from PIL import Image

from mdeical_image_segmentation_tpu.data import dsb as jax_dsb
from mdeical_image_segmentation_tpu.data import png2d as jax_png2d
from mdeical_image_segmentation_tpu.serve.app import (
    SegmentationServer as JaxServer,
)
from mdeical_image_segmentation_tpu_torch.data import dsb, png2d
from mdeical_image_segmentation_tpu_torch.serve import (
    ModelEntry,
    ModelRegistry,
    SegmentationServer,
)
from mdeical_image_segmentation_tpu_torch.utils import image, image_base

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "fixtures")
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


SCRIPT = _script()


def _manifest():
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        return json.load(f)["image_formats"]


def _reference(path: str) -> dict:
    """PIL's two conversions and imageio's read (None where they fail)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out = {}
        for mode in ("L", "RGB"):
            try:
                with Image.open(path) as im:
                    out[mode] = np.asarray(im.convert(mode))
            except (OSError, ValueError):
                out[mode] = None
        try:
            out["imageio"] = np.asarray(imageio.imread(path))
        except (OSError, ValueError):
            out["imageio"] = None
    return out


def _same(got, want) -> None:
    assert got.dtype == want.dtype and got.shape == want.shape, (
        got.dtype, got.shape, want.dtype, want.shape)
    np.testing.assert_array_equal(got, want)


def _check_against_pil_and_imageio(path: str) -> None:
    """Equal where PIL and imageio read the file, ImageError where not."""
    ref = _reference(path)
    for mode in ("L", "RGB"):
        if ref[mode] is None:
            with pytest.raises(image.ImageError):
                image.read(path, mode)
        else:
            _same(image.read(path, mode), ref[mode])
    if ref["imageio"] is None:
        with pytest.raises(image.ImageError):
            image.imread(path)
    else:
        _same(image.imread(path), ref["imageio"])


@pytest.fixture(scope="module")
def fixture_references():
    """PIL and imageio over every committed fixture, once."""
    return {name: _reference(os.path.join(FIXTURES, "image_formats", name))
            for name in _manifest()}


@pytest.mark.parametrize("name", sorted(_manifest()))
def test_fixtures_equal_pil_imageio_and_the_manifest(name,
                                                     fixture_references):
    path = os.path.join(FIXTURES, "image_formats", name)
    want, ref = _manifest()[name], fixture_references[name]
    for mode in ("L", "RGB"):
        if want[f"pil_{mode}"] is None:
            assert ref[mode] is None
            with pytest.raises(image.ImageError, match="item 20c"):
                image.read(path, mode)
            continue
        assert SCRIPT.entry(ref[mode]) == want[f"pil_{mode}"]
        got = image.read(path, mode)
        _same(got, ref[mode])
        assert SCRIPT.entry(got) == want[f"pil_{mode}"]
    assert SCRIPT.entry(ref["imageio"]) == want["imageio"]
    got = image.imread(path)
    _same(got, ref["imageio"])
    assert SCRIPT.entry(got) == want["imageio"]


def test_fixture_matrix_is_whole():
    """The committed matrix holds each format's variants and the four
    full-size DRIVE files, under about 1.5 MB."""
    names = _manifest()
    by_ext = {e: [n for n in names if n.endswith(e)]
              for e in (".tif", ".gif", ".bmp")}
    assert len(by_ext[".tif"]) >= 50 and len(by_ext[".gif"]) >= 15
    assert len(by_ext[".bmp"]) >= 20
    drive = sorted(n for n in names if n.startswith("drive/"))
    assert drive == ["drive/21_manual1.gif", "drive/21_training.tif",
                     "drive/21_training_mask.gif", "drive/22_training.tif"]
    for n in ("drive/21_training.tif", "drive/21_manual1.gif"):
        assert names[n]["pil_RGB"]["shape"] == [584, 565, 3]
    total = sum(os.path.getsize(os.path.join(FIXTURES, "image_formats", n))
                for n in names)
    assert total < 1_600_000


# -- a TIFF matrix written here ----------------------------------------------

LAYOUTS = {"strips": dict(rowsperstrip=5), "tiles": dict(tile=(16, 32)),
           "planar": dict(planar=2, rowsperstrip=7)}


@pytest.mark.parametrize("codec", [1, 5, 8, 32946, 32773])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("big", [False, True])
@pytest.mark.parametrize("order", ["<", ">"])
def test_tiff_matrix(tmp_path, order, big, layout, codec):
    rng = np.random.default_rng(codec + 7 * big + (order == ">"))
    rgb = rng.integers(0, 256, (37, 45, 3), dtype=np.uint8)
    rgb[:, 20:] = rgb[:, 20:21]  # runs, for PackBits and LZW
    predictor = 2 if codec in (5, 8, 32946) else 1
    data = SCRIPT.encode_tiff([SCRIPT.tiff_page(
        rgb, 8, 2, codec, predictor, order=order, **LAYOUTS[layout])],
        order, big)
    path = str(tmp_path / "m.tif")
    with open(path, "wb") as f:
        f.write(data)
    _check_against_pil_and_imageio(path)


@pytest.mark.parametrize("bits,photometric", [(1, 0), (1, 1), (2, 1),
                                              (4, 0), (8, 0), (16, 1),
                                              (16, 0), (4, 3), (8, 3)])
def test_tiff_grey_and_palette_depths(tmp_path, bits, photometric):
    rng = np.random.default_rng(bits * 10 + photometric)
    h, w = 13, 19  # rows not a whole number of bytes below 8 bits
    px = rng.integers(0, 1 << bits, (h, w, 1))
    px = px.astype(np.uint16 if bits == 16 else np.uint8)
    cmap = rng.integers(0, 65536, (3, 1 << bits)) if photometric == 3 \
        else None
    for codec in (1, 5, 32773):
        path = str(tmp_path / f"g{codec}.tif")
        with open(path, "wb") as f:
            f.write(SCRIPT.encode_tiff([SCRIPT.tiff_page(
                px, bits, photometric, codec, rowsperstrip=4,
                colormap=cmap)]))
        _check_against_pil_and_imageio(path)


@pytest.mark.parametrize("orientation", range(1, 9))
def test_tiff_orientation_applied_as_pil_does(tmp_path, orientation):
    rgb = np.random.default_rng(orientation).integers(
        0, 256, (5, 7, 3), dtype=np.uint8)
    path = str(tmp_path / "o.tif")
    with open(path, "wb") as f:
        f.write(SCRIPT.encode_tiff([SCRIPT.tiff_page(
            rgb, 8, 2, 5, tags=[(274, 3, [orientation])])]))
    _check_against_pil_and_imageio(path)


# -- GIF and BMP edge cases --------------------------------------------------


@pytest.mark.parametrize("h", range(1, 18))
def test_gif_interlace_every_row_count(tmp_path, h):
    rng = np.random.default_rng(h)
    idx = rng.integers(0, 7, (h, 5))
    path = str(tmp_path / "i.gif")
    with open(path, "wb") as f:
        f.write(SCRIPT.encode_gif([{"indices": idx, "interlace": True}],
                                  (5, h), rng.integers(0, 256, (7, 3))))
    _check_against_pil_and_imageio(path)


@pytest.mark.parametrize("min_code_size", range(2, 9))
def test_gif_lzw_at_every_code_size(tmp_path, min_code_size):
    rng = np.random.default_rng(min_code_size)
    n = 1 << min_code_size
    idx = rng.integers(0, n, (60, 90))
    idx[10:30] = idx[10:11]  # repeated rows: long strings, KwKwK
    path = str(tmp_path / "c.gif")
    with open(path, "wb") as f:
        f.write(SCRIPT.encode_gif(
            [{"indices": idx, "min_code_size": min_code_size,
              "clear_when_full": min_code_size % 2 == 0}], (90, 60),
            rng.integers(0, 256, (n, 3))))
    _check_against_pil_and_imageio(path)


def _bmp_rle_file(body: bytes, w: int, h: int, bits: int) -> bytes:
    pal = np.random.default_rng(1).integers(0, 256, (1 << bits, 4),
                                            dtype=np.uint8)
    info = np.array([40, w, h], "<i4").tobytes() + np.array(
        [1, bits], "<u2").tobytes() + np.array(
        [1 if bits == 8 else 2, len(body), 0, 0, 1 << bits, 0],
        "<i4").tobytes()
    offset = 14 + 40 + pal.size
    return (b"BM" + np.array([offset + len(body), 0, offset],
                             "<u4").tobytes()[:4] + b"\0\0\0\0"
            + np.array([offset], "<u4").tobytes() + info + pal.tobytes()
            + body)


@pytest.mark.parametrize("case", ["delta", "odd_absolute_rle4",
                                  "run_past_the_row", "early_end"])
def test_bmp_rle_as_pil_decodes_it(tmp_path, case):
    """PIL's RLE reader, quirks included: a delta escape reads four bytes,
    an odd absolute RLE4 run drops its last pixel, runs are clipped to the
    row, an end of bitmap leaves the rest 0."""
    bits = 4 if "rle4" in case else 8
    body = {
        "delta": b"\x03\x05\x00\x02\x09\x09\x02\x01\x00\x00\x04\x07",
        "odd_absolute_rle4": b"\x00\x05\x12\x34\x56\x00\x00\x00\x06\x77",
        "run_past_the_row": b"\x09\x03\x00\x00\x02\x04",
        "early_end": b"\x02\x06\x00\x00\x00\x01",
    }[case]
    path = str(tmp_path / "r.bmp")
    with open(path, "wb") as f:
        f.write(_bmp_rle_file(body + b"\x00\x00" * 6 + b"\x00\x01", 6, 4,
                              bits))
    _check_against_pil_and_imageio(path)


# -- the C decoders ----------------------------------------------------------


@pytest.mark.parametrize("n,alphabet", [(0, 2), (1, 2), (700, 3),
                                        (20000, 256), (60000, 5)])
def test_lzw_and_packbits_round_trip(n, alphabet):
    data = np.random.default_rng(n).integers(0, alphabet, n).astype(
        np.uint8).tobytes()
    assert image_base.tiff_lzw_decode(SCRIPT.lzw_encode_tiff(data),
                                      n) == data
    assert image_base.packbits_decode(SCRIPT.packbits_encode(data),
                                      n) == data
    for mcs in (2, 8) if alphabet <= 4 else (8,):
        for full in (True, False):
            enc = SCRIPT.lzw_encode_gif(data, mcs, full)
            assert image_base.gif_lzw_decode(enc, mcs, n) == data


def test_corrupt_lzw_raises():
    with pytest.raises(image.ImageError, match="corrupt"):
        # a clear, then code 300 where a literal must come
        image_base.tiff_lzw_decode(b"\x80\x4b\x00", 10)


# -- the JAX package's readers on these files --------------------------------


@pytest.fixture(scope="module")
def drive_dir(tmp_path_factory):
    """A DRIVE layout of TIFF images (LZW, deflate, PackBits, raw) and GIF
    manual masks."""
    root = tmp_path_factory.mktemp("drive")
    os.makedirs(root / "images")
    os.makedirs(root / "labels")
    rng = np.random.default_rng(20)
    codecs = ("tiff_lzw", "tiff_adobe_deflate", "packbits", None)
    for i in range(12):
        rgb = rng.integers(0, 256, (29, 23, 3), dtype=np.uint8)
        kw = {"compression": codecs[i % 4]}
        if i % 4 < 2:
            kw["tiffinfo"] = {317: 2}
        Image.fromarray(rgb).save(root / "images" / f"{21 + i}_training.tif",
                                  **kw)
        vessels = np.where(rng.random((29, 23)) > 0.7, 255, 0)
        Image.fromarray(vessels.astype(np.uint8)).save(
            root / "labels" / f"{21 + i}_manual1.gif")
    return str(root)


@pytest.mark.parametrize("mode", ["train", "eval", "test"])
def test_drive_dataset_equals_jax_on_tiff_and_gif(drive_dir, mode):
    ours = png2d.DRIVEDataset(drive_dir, mode, resolution=16)
    theirs = jax_png2d.DRIVEDataset(drive_dir, mode, resolution=16)
    assert ours.images_path == theirs.images_path and len(ours) > 0
    assert ours.masks_path == theirs.masks_path
    for i in range(len(ours)):
        a, b = ours[i], theirs[i]
        for k in ("image", "mask"):
            _same(a[k], b[k])
        assert 0 < a["mask"].mean() < 1


SERVED = ["dsb_c3/images/pil_rgb_lzw_pred2.tif", "dsb_c1/images/pil_I16_raw.tif",
          "dsb_c3/images/pil_mask.gif", "dsb_c3/images/rle8.bmp",
          "dsb_c1/images/pil_1.bmp", "drive/21_training.tif"]


@pytest.mark.parametrize("name", SERVED)
@pytest.mark.parametrize("channels", [1, 3])
def test_build_input_equals_jax(name, channels):
    path = os.path.join(FIXTURES, "image_formats", name)
    entry = types.SimpleNamespace(in_channels=channels, resolution=24,
                                  input_mode="float32")
    got, hw = SegmentationServer._build_input(None, path, entry)
    want, want_hw = JaxServer._build_input(None, path, entry)
    assert hw == want_hw and got.dtype == np.uint8
    _same(got.astype(np.float32) / 255.0, want)


@pytest.mark.parametrize("group", ["dsb_c1", "dsb_c3", "dsb_c4", "misc"])
@pytest.mark.parametrize("expand_dims", [True, False])
def test_dsb_dataset_equals_jax(group, expand_dims):
    root = os.path.join(FIXTURES, "image_formats", group)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        theirs = jax_dsb.DSB2018Dataset(root, "test", TRANSFORMER,
                                        expand_dims)
    ours = dsb.DSB2018Dataset(root, "test", TRANSFORMER, expand_dims)
    assert ours.paths == theirs.paths and len(ours) >= 4
    for a, b in zip(ours.images, theirs.images):
        _same(a, b)


# -- what still raises -------------------------------------------------------


def _refused_tiffs():
    """{name: TIFF bytes} of the variants the reader refuses."""
    px = np.random.default_rng(0).integers(0, 256, (8, 8, 3), dtype=np.uint8)
    g = px[..., :1]
    T, enc = SCRIPT.tiff_page, SCRIPT.encode_tiff
    out = {f"compression{c}": enc([T(g, 8, 1, c, raw=b"\0" * 64)])
           for c in (2, 3, 4, 6, 7)}
    out["predictor3"] = enc([T(g.astype(np.float32), 32, 1, 8, 3,
                               sampleformat=3)])
    out["ycbcr"] = enc([T(px, 8, 6)])
    out["cmyk"] = enc([T(np.concatenate([px, g], -1), 8, 5)])
    out["fillorder2"] = enc([T(g, 8, 1, tags=[(266, 3, [2])])])
    out["old_style_lzw"] = enc([T(g, 8, 1, 5, raw=b"\x00\x01" + b"\0" * 30)])
    out["signed16"] = enc([T(g.astype(np.uint16), 16, 1, sampleformat=2)])
    return out


def _jpeg_bytes(px, mode=None, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(px, mode).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _patched(data: bytes, marker: int, offset: int, value: int) -> bytes:
    """``data`` with byte ``offset`` of the first ``marker`` segment's body
    set to ``value``."""
    at = data.index(bytes([0xFF, marker])) + 4 + offset
    return data[:at] + bytes([value]) + data[at + 1:]


def _refused_jpegs():
    """{name: JPEG bytes} of the variants the reader refuses: PIL's own
    output with a marker or field changed where PIL writes no such file."""
    rng = np.random.default_rng(1)
    rgb = rng.integers(0, 256, (16, 24, 3), dtype=np.uint8)
    base = _jpeg_bytes(rgb, subsampling=0)
    out = {f"jpeg_sof{n}": base.replace(b"\xff\xc0", bytes([0xFF, 0xC0 + n]),
                                        1)
           for n in (3, 5, 9, 10, 11, 13)}
    out["jpeg_12bit"] = _patched(base, 0xC0, 0, 12)
    out["jpeg_cmyk"] = _jpeg_bytes(np.concatenate([rgb, rgb[..., :1]], -1),
                                   "CMYK")
    for name, comp, hv in (("jpeg_440", 0, 0x12), ("jpeg_411", 0, 0x41),
                           ("jpeg_chroma_2x2", 1, 0x22)):
        out[name] = _patched(base, 0xC0, 7 + 3 * comp, hv)
    # a progressive file cut after its first AC scans: libjpeg smooths it
    prog = _jpeg_bytes(rgb[..., 0], progressive=True)
    sos = [i for i in range(len(prog) - 1) if prog[i:i + 2] == b"\xff\xda"]
    out["jpeg_unrefined_progressive"] = prog[:sos[3]] + b"\xff\xd9"
    return out


REFUSED = sorted(_refused_tiffs()) + sorted(_refused_jpegs())


def _write_refused(tmp_path, name: str) -> str:
    jpeg = name.startswith("jpeg")
    path = str(tmp_path / (f"{name}.jpg" if jpeg else f"{name}.tif"))
    with open(path, "wb") as f:
        f.write((_refused_jpegs() if jpeg else _refused_tiffs())[name])
    return path


@pytest.fixture(scope="module")
def refusing_server(tmp_path_factory):
    reg = ModelRegistry()
    reg.register(ModelEntry(name="half", forward=lambda x: x[..., 0] // 2,
                            in_channels=1, resolution=8))
    srv = SegmentationServer(reg, output_dir=str(
        tmp_path_factory.mktemp("masks")), max_batch=2, max_wait_ms=1.0)
    yield srv
    srv.engine.stop()


@pytest.mark.parametrize("name", REFUSED)
def test_refused_files_raise_naming_item_20c_and_the_server_answers_400(
        tmp_path, name, refusing_server):
    path = _write_refused(tmp_path, name)
    for mode in ("L", "RGB"):
        with pytest.raises(image.ImageError, match="item 20c"):
            image.read(path, mode)
    with pytest.raises(image.ImageError, match="item 20c"):
        image.imread(path)
    reply = refusing_server.handle_predict({"image_path": path})
    assert reply["status"] == 400 and "item 20c" in reply["response"]


def test_server_serves_tiff_gif_and_bmp(refusing_server):
    for name in SERVED[:4]:
        path = os.path.join(FIXTURES, "image_formats", name)
        reply = refusing_server.handle_predict({"image_path": path,
                                                "return": "mask"})
        assert reply["status"] == 200, reply
        want = image.read(path, "L")
        got = np.asarray(reply["response"], np.uint8)
        assert got.shape == (8, 8)
        np.testing.assert_array_equal(
            got, png2d.nearest_resize(want, (8, 8)) // 2)


def test_png_errors_are_image_errors():
    from mdeical_image_segmentation_tpu_torch.utils import png

    assert issubclass(png.PngError, image.ImageError)
    with pytest.raises(image.ImageError, match="bad signature"):
        png.decode(b"\x89PNX" + b"\0" * 20)
    with pytest.raises(image.ImageError,
                       match="not a PNG, TIFF, GIF, BMP or JPEG"):
        image.kind(b"P6\n")

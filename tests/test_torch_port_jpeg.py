"""The port's JPEG reader (``utils/jpeg.py`` over ``csrc/jpeg_decode.c``)
against PIL 12 on libjpeg-turbo 3.1 and imageio, which the JAX package
reads JPEGs with, to the bit.

- The committed JPEG fixtures are held to PIL, imageio and the manifest by
  ``test_torch_port_image_formats.py``'s fixture test; here, that the set
  is whole.
- A matrix PIL writes here: grey and colour, 4:4:4 / 4:2:2 / 4:2:0,
  baseline / optimized / progressive / restart markers, sizes 1x1 to
  37x53, qualities 1-100.
- Each place a bit is likely to go wrong, on its own: the bottom and right
  edges of 4:2:0 at every size up to 18x18, h2v2's context rows across
  iMCU rows, progressive AC refinement, restart markers inside
  progressive scans, multi-scan (non-interleaved) baseline and SOF1
  (``encode_jpeg``), the colour space from the JFIF / Adobe markers and
  the component ids, IDCT values past libjpeg-turbo's 16-bit lanes, fill
  bytes and junk between segments, EXIF orientation (not applied).
- Truncated and corrupt streams raise ``ImageError``, never an image where
  PIL raises.
- ``DRIVEDataset`` / ``BUSIDataset`` over JPEG directories,
  ``_build_input`` and ``DSB2018Dataset`` equal to the JAX package's; the
  server answers JPEG requests.
"""

import io
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
from mdeical_image_segmentation_tpu_torch.ops import _build
from mdeical_image_segmentation_tpu_torch.serve import (
    ModelEntry,
    ModelRegistry,
    SegmentationServer,
)
from mdeical_image_segmentation_tpu_torch.utils import image, jpeg

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "fixtures", "image_formats")
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
    import json

    with open(os.path.join(HERE, "fixtures", "manifest.json")) as f:
        return {k: v for k, v in json.load(f)["image_formats"].items()
                if k.endswith(".jpg")}


def _content(h, w, channels, seed, noise=18.0):
    """Waves plus noise: smooth parts, edges and busy blocks."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    waves = np.stack([128 + 90 * np.sin(xx / (3 + k) + k)
                      * np.cos(yy / (2 + k) - k) for k in range(channels)],
                     -1)
    px = np.clip(waves + rng.normal(0, noise, waves.shape), 0, 255)
    px = px.astype(np.uint8)
    return px[..., 0] if channels == 1 else px


def _encode(px, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(px).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _pil(data: bytes, mode=None):
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im if mode is None else im.convert(mode))


def _same(got, want) -> None:
    assert got.dtype == want.dtype and got.shape == want.shape, (
        got.dtype, got.shape, want.dtype, want.shape)
    np.testing.assert_array_equal(got, want)


def _check_file(path: str) -> None:
    """``read`` "L" / "RGB" equal to PIL's ``convert``, ``imread`` to
    imageio's."""
    for mode in ("L", "RGB"):
        with Image.open(path) as im:
            _same(image.read(path, mode), np.asarray(im.convert(mode)))
    _same(image.imread(path), np.asarray(imageio.imread(path)))


def _check_bytes(data: bytes) -> None:
    """The decoded pixels equal PIL's."""
    _same(jpeg.decode(data).pixels, _pil(data))


def _markers(data: bytes) -> list:
    """The codes of the markers outside entropy-coded data, in order, with
    each SOS's (Ss, Se, Ah, Al)."""
    out, pos = [], 2
    while pos < len(data) - 1:
        if data[pos] != 0xFF or data[pos + 1] in (0x00, 0xFF):
            pos += 1
            continue
        m = data[pos + 1]
        if m == 0xD9 or 0xD0 <= m <= 0xD7:
            out.append((m, None))
            pos += 2
            continue
        n = int.from_bytes(data[pos + 2:pos + 4], "big")
        body = data[pos + 4:pos + 2 + n]
        out.append((m, (body[-3], body[-2], body[-1] >> 4, body[-1] & 15)
                    if m == 0xDA else None))
        pos += 2 + n
    return out


# -- the fixtures and the kind -------------------------------------------------


def test_kind_is_jpeg_by_the_leading_bytes():
    assert image.kind(b"\xff\xd8\xff\xe0" + b"\0" * 8) == "jpeg"
    with pytest.raises(image.ImageError, match="read are PNG, TIFF, GIF, "
                       "BMP and JPEG"):
        image.kind(b"\xff\xd8\x00")


def test_fixture_set_is_whole():
    """Every variant the fixtures promise, and the DRIVE-sized set."""
    names = _manifest()
    c3 = {n.split("/")[-1] for n in names if n.startswith("jpeg_c3/")}
    for coding in ("baseline", "optimized", "progressive"):
        assert {f"{coding}_{s}.jpg" for s in ("444", "422", "420")} <= c3
    assert {"quality001.jpg", "quality100.jpg", "keep_rgb_444.jpg",
            "restart_blocks3.jpg", "multiscan_baseline_420.jpg",
            "extended_sof1_422.jpg", "rgb_ids_no_marker.jpg"} <= c3
    drive = sorted(n for n in names if n.startswith("jpeg_drive/"))
    assert len(drive) == 6
    for n in drive:
        shape = [584, 565] + ([] if "grey" in n else [3])
        assert names[n]["imageio"]["shape"] == shape
    assert names["jpeg_misc/images/37x53_exif_orientation6.jpg"][
        "imageio"]["shape"] == [37, 53, 3]
    assert sum(os.path.getsize(os.path.join(FIXTURES, n))
               for n in names) < 400_000


def test_the_decoder_is_built_c():
    jpeg.decode(_encode(_content(8, 8, 3, 0)))
    assert _build.host_library_path("jpeg_decode.c").exists()


# -- a matrix PIL writes -------------------------------------------------------

SIZES = [(1, 1), (7, 9), (17, 33), (37, 53)]
CODINGS = {"baseline": {}, "optimized": {"optimize": True},
           "progressive": {"progressive": True},
           "restart": {"restart_marker_blocks": 2}}


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("coding", sorted(CODINGS))
@pytest.mark.parametrize("subsampling", [0, 1, 2, None])
def test_pil_matrix(tmp_path, subsampling, coding, size):
    """``subsampling`` None is a grey file."""
    channels = 1 if subsampling is None else 3
    px = _content(*size, channels, seed=size[0] * 7 + size[1])
    kw = dict(CODINGS[coding], quality=88)
    if subsampling is not None:
        kw["subsampling"] = subsampling
    path = str(tmp_path / "m.jpg")
    Image.fromarray(px).save(path, **kw)
    _check_file(path)


@pytest.mark.parametrize("subsampling", [0, 1, 2])
def test_every_quality(subsampling):
    px = _content(37, 53, 3, seed=subsampling)
    for q in range(1, 101):
        _check_bytes(_encode(px, quality=q, subsampling=subsampling))


@pytest.mark.parametrize("noise", [0.0, 60.0])
def test_keep_rgb(noise):
    """Adobe APP14 transform 0, components 'R', 'G', 'B': no colour
    conversion."""
    px = _content(21, 30, 3, seed=4, noise=noise)
    for kw in ({}, {"progressive": True}, {"restart_marker_blocks": 2}):
        data = _encode(px, keep_rgb=True, **kw)
        assert b"Adobe" in data and b"JFIF" not in data
        _check_bytes(data)


# -- each edge case on its own ------------------------------------------------


def test_420_bottom_and_right_edges_at_every_size_to_18():
    for h in range(1, 19):
        for w in range(1, 19):
            px = _content(h, w, 3, seed=h * 19 + w, noise=40.0)
            _check_bytes(_encode(px, quality=92, subsampling=2))


def test_h2v2_context_rows_cross_imcu_rows():
    """Rows 15 and 16 of 4:2:0 sit in two iMCU rows; fancy upsampling
    reads the chroma row across the boundary.  Two files that differ only
    below row 16 decode row 15 differently in PIL, and the port follows
    both."""
    top = _content(16, 40, 3, seed=5)
    outs = []
    for seed in (6, 7):
        px = np.concatenate([top, _content(24, 40, 3, seed=seed, noise=80)])
        data = _encode(px, quality=95, subsampling=2)
        _check_bytes(data)
        outs.append(_pil(data))
    assert not np.array_equal(outs[0][15], outs[1][15])
    assert np.array_equal(outs[0][:8], outs[1][:8])


@pytest.mark.parametrize("channels", [1, 3])
def test_progressive_ac_refinement(channels):
    """PIL's progression refines AC coefficients (scans with Ah > 0), at
    busy and smooth content, where EOB runs cross many blocks."""
    for noise in (0.0, 25.0, 90.0):
        data = _encode(_content(45, 61, channels, seed=8, noise=noise),
                       quality=97, progressive=True)
        scans = [p for m, p in _markers(data) if m == 0xDA]
        assert any(ss > 0 and ah > 0 for ss, _, ah, _ in scans)
        assert any(ss == 0 and ah > 0 for ss, _, ah, _ in scans)
        _check_bytes(data)


@pytest.mark.parametrize("subsampling", [0, 1, 2])
def test_restart_markers_inside_progressive_scans(subsampling):
    px = _content(40, 50, 3, seed=9, noise=30)
    for kw in ({"restart_marker_blocks": 1}, {"restart_marker_rows": 1},
               {"restart_marker_blocks": 5}):
        data = _encode(px, progressive=True, subsampling=subsampling, **kw)
        codes = [m for m, _ in _markers(data)]
        assert sum(0xD0 <= m <= 0xD7 for m in codes) > 8
        assert 0xDD in codes
        _check_bytes(data)


@pytest.mark.parametrize("sampling", [(1, 1), (2, 1), (2, 2)])
def test_multiscan_baseline_and_sof1(sampling):
    """Non-interleaved sequential scans (one a component, or luma then
    both chroma) address each component's own block grid, not the MCU
    grid; SOF1 decodes as SOF0; restart markers in every scan."""
    for h, w in ((9, 13), (23, 37), (40, 48)):
        px = _content(h, w, 3, seed=h + w, noise=30)
        samp = [sampling, (1, 1), (1, 1)]
        for scans in ([(0, 1, 2)], [(0,), (1,), (2,)], [(0,), (1, 2)],
                      [(2,), (0,), (1,)]):
            for sof, restart in ((0xC0, 0), (0xC1, 3)):
                _check_bytes(SCRIPT.encode_jpeg(px, samp, scans, restart,
                                                sof))
    grey = _content(19, 27, 1, seed=2)
    for samp in ((1, 1), (2, 2), (3, 1)):  # one component: no upsampling
        _check_bytes(SCRIPT.encode_jpeg(grey, [samp], restart=1, sof=0xC1))


def _with_adobe(data: bytes, transform: int) -> bytes:
    seg = b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00" + bytes([transform])
    return data[:2] + seg + data[2:]


def test_colour_space_from_markers_and_ids():
    """libjpeg's default_decompress_parms: JFIF means YCbCr; else the Adobe
    transform (0 RGB, 1 YCbCr); else ids 'R', 'G', 'B' mean RGB; else
    YCbCr."""
    px = _content(17, 23, 3, seed=11, noise=30)
    e = SCRIPT.encode_jpeg
    cases = {
        "ycc ids, JFIF": e(px),
        "ycc ids, none": e(px, jfif=False),
        "RGB ids, none": e(px, ids=[82, 71, 66], jfif=False, ycc=False),
        "RGB ids, JFIF": e(px, ids=[82, 71, 66], jfif=True, ycc=False),
        "Adobe 0": _with_adobe(e(px, jfif=False, ycc=False), 0),
        "Adobe 1": _with_adobe(e(px, jfif=False), 1),
        "Adobe 2": _with_adobe(e(px, jfif=False), 2),
        "Adobe 0 beside JFIF": _with_adobe(e(px, ycc=False), 0),
        "ids 9, 8, 7": e(px, ids=[9, 8, 7], jfif=False),
    }
    for name, data in cases.items():
        _check_bytes(data)
    as_stored = jpeg.decode(cases["RGB ids, none"]).pixels
    assert np.abs(as_stored.astype(int) - px).mean() < 8
    assert not np.array_equal(jpeg.decode(cases["RGB ids, JFIF"]).pixels,
                              as_stored)


def test_idct_past_the_16_bit_lanes():
    """Quantisers that push the IDCT out of range: libjpeg-turbo's SIMD
    IDCT saturates where jidctint.c's table wraps; the port gives the SIMD
    bits PIL gives."""
    rng = np.random.default_rng(12)
    px = rng.integers(0, 256, (24, 24, 3), dtype=np.uint8)
    for q in (40, 120, 255):
        table = [min(255, q + (i * 7) % 60) for i in range(64)]
        data = _encode(px, qtables=[table, table], subsampling=0)
        _check_bytes(data)
    big = [255] * 64
    _check_bytes(_encode(px[..., 0], qtables=[big]))


def _without_dht(data: bytes) -> bytes:
    kept, pos = bytearray(data[:2]), 2
    while data[pos + 1] != 0xDA:
        n = 2 + int.from_bytes(data[pos + 2:pos + 4], "big")
        if data[pos + 1] != 0xC4:
            kept += data[pos:pos + n]
        pos += n
    return bytes(kept) + data[pos:]


@pytest.mark.parametrize("channels", [1, 3])
def test_missing_huffman_tables_are_annex_k(channels):
    """A Motion-JPEG frame carries no DHT: libjpeg-turbo's sequential
    decoder installs Annex K's tables for slots 0 and 1, which PIL's
    baseline writer uses; a scan on an undefined slot 2 raises, and so does
    a progressive file without its tables (PIL raises too)."""
    data = _encode(_content(19, 29, channels, seed=21), restart_marker_blocks=2)
    bare = _without_dht(data)
    assert b"\xff\xc4" not in bare[:bare.index(b"\xff\xda")]
    _check_bytes(bare)
    sos = bare.index(b"\xff\xda")
    slot2 = bytearray(bare)
    slot2[sos + 6] = 0x22  # the first component's DC and AC tables: slot 2
    with pytest.raises(image.ImageError, match="undefined Huffman table"):
        jpeg.decode(bytes(slot2))
    progressive = _without_dht(_encode(_content(19, 29, channels, seed=21),
                                       progressive=True))
    with pytest.raises(OSError):
        _pil(progressive)
    with pytest.raises(image.ImageError, match="undefined Huffman table"):
        jpeg.decode(progressive)


def test_fill_bytes_and_junk_between_segments():
    px = _content(18, 26, 3, seed=13)
    data = _encode(px)
    sos = data.index(b"\xff\xda")
    dqt = data.index(b"\xff\xdb")
    filled = data[:sos] + b"\xff\xff\xff" + data[sos:]
    junk = data[:dqt] + b"\x00\x12\x34" + data[dqt:]
    eoi = data[:-2] + b"\xff\xff\xd9"
    trailer = data + b"garbage after EOI"
    com = data[:2] + b"\xff\xfe\x00\x05abc" + data[2:]
    dac = data[:dqt] + b"\xff\xcc\x00\x06\x01\x10\x15\x05" + data[dqt:]
    for d in (filled, junk, eoi, trailer, com, dac):
        _check_bytes(d)


def test_exif_orientation_is_not_applied():
    path = os.path.join(FIXTURES, "jpeg_misc", "images",
                        "37x53_exif_orientation6.jpg")
    with Image.open(path) as im:
        assert im.getexif().get(0x0112) == 6
    _check_file(path)
    assert image.read(path, "RGB").shape == (37, 53, 3)


# -- truncated and corrupt streams -------------------------------------------


@pytest.mark.parametrize("coding", ["baseline", "progressive", "restart"])
def test_truncated_streams_raise(coding):
    data = _encode(_content(33, 41, 3, seed=14), **CODINGS[coding])
    for cut in list(range(3, 40, 3)) + list(range(40, len(data) - 1,
                                                  max(1, len(data) // 40))):
        part = data[:cut]
        with pytest.raises(OSError):
            _pil(part)
        with pytest.raises(image.ImageError):
            jpeg.decode(part)


def test_corrupt_streams_raise():
    data = _encode(_content(20, 20, 3, seed=15), restart_marker_blocks=1)
    dht = data.index(b"\xff\xc4")
    # a DC table whose 16 one-bit codes overflow the code space
    bad_table = (data[:dht + 5] + bytes([3]) + data[dht + 6:])
    # the second restart marker out of order
    rst = [i for i in range(len(data) - 1) if data[i] == 0xFF
           and 0xD0 <= data[i + 1] <= 0xD7]
    swapped = bytearray(data)
    swapped[rst[1] + 1] = 0xD5
    # the scan's data cut short, EOI kept
    sos = data.index(b"\xff\xda")
    short = data[:sos + 40] + b"\xff\xd9"
    # zero width
    sof = data.index(b"\xff\xc0")
    empty = data[:sof + 7] + b"\0\0" + data[sof + 9:]
    # no EOI after the frame's tables: the scan is missing
    no_scan = data[:sos] + b"\xff\xd9"
    # arithmetic conditioning libjpeg refuses: DC L 5 > U 0
    bad_dac = data[:sof] + b"\xff\xcc\x00\x04\x01\x05" + data[sof:]
    for d in (bad_table, empty, no_scan, bad_dac):  # PIL raises too
        with pytest.raises(OSError):
            _pil(d)
        with pytest.raises(image.ImageError):
            jpeg.decode(d)
    # libjpeg warns and PIL returns an image; the port raises
    for d in (bytes(swapped), short):
        _pil(d)
        with pytest.raises(image.ImageError):
            jpeg.decode(d)
    with pytest.raises(image.ImageError, match="not a JPEG"):
        jpeg.decode(b"\xff\xd8\x00" + data[3:])


def test_never_an_image_where_pil_raises():
    """Single-byte changes all over small baseline, progressive and restart
    files: where PIL raises, the port raises ``ImageError``; where the port
    decodes, it gives PIL's pixels."""
    rng = np.random.default_rng(16)
    raised = agreed = 0
    for kw in ({}, {"progressive": True}, {"restart_marker_blocks": 1}):
        data = _encode(rng.integers(0, 256, (15, 17, 3), dtype=np.uint8),
                       **kw)
        for _ in range(120):
            d = bytearray(data)
            d[rng.integers(3, len(d))] = rng.integers(0, 256)
            d = bytes(d)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                try:
                    want = _pil(d, "RGB")
                except Exception:
                    want = None
            try:
                got = image.convert(jpeg.decode(d), "RGB")
            except image.ImageError:
                raised += 1
                continue
            assert want is not None
            _same(got, want)
            agreed += 1
    assert raised > 20 and agreed > 20


# -- the datasets and the server ----------------------------------------------


@pytest.fixture(scope="module")
def jpeg_layouts(tmp_path_factory):
    """A DRIVE layout (RGB JPEG images, grey JPEG manuals) and a BUSI
    layout (grey JPEG images and masks) of 12 pairs each."""
    root = tmp_path_factory.mktemp("jpeg_layouts")
    codings = list(CODINGS.values())
    for sub in ("drive/images", "drive/labels", "busi/images", "busi/mask/0"):
        os.makedirs(root / sub)
    rng = np.random.default_rng(17)
    for i in range(12):
        rgb = _content(29, 23, 3, seed=100 + i)
        kw = dict(codings[i % 4], subsampling=i % 3)
        Image.fromarray(rgb).save(root / "drive/images" / f"{21 + i}.jpg",
                                  **kw)
        mask = np.where(rng.random((29, 23)) > 0.7, 255, 0).astype(np.uint8)
        Image.fromarray(mask).save(root / "drive/labels" / f"{21 + i}.jpg",
                                   quality=90)
        Image.fromarray(rgb[..., 1]).save(root / "busi/images" / f"{i}.jpg",
                                          **codings[i % 4])
        Image.fromarray(mask).save(root / "busi/mask/0" / f"{i}.jpg")
    return str(root)


@pytest.mark.parametrize("layout", ["drive", "busi"])
@pytest.mark.parametrize("mode", ["train", "eval", "test"])
def test_2d_datasets_equal_jax_on_jpeg(jpeg_layouts, layout, mode):
    cls, jax_cls = ((png2d.DRIVEDataset, jax_png2d.DRIVEDataset)
                    if layout == "drive" else
                    (png2d.BUSIDataset, jax_png2d.BUSIDataset))
    root = os.path.join(jpeg_layouts, layout)
    ours, theirs = cls(root, mode, resolution=16), jax_cls(root, mode,
                                                            resolution=16)
    assert ours.images_path == theirs.images_path and len(ours) > 0
    for i in range(len(ours)):
        a, b = ours[i], theirs[i]
        for k in ("image", "mask"):
            _same(a[k], b[k])
        assert 0 < a["mask"].mean() < 1


SERVED = ["jpeg_c3/images/progressive_420.jpg",
          "jpeg_c3/images/keep_rgb_444.jpg", "jpeg_c1/images/restart_blocks2.jpg",
          "jpeg_misc/images/7x9_422_progressive.jpg",
          "jpeg_drive/baseline_420_q75.jpg", "jpeg_drive/grey_manual.jpg"]


@pytest.mark.parametrize("name", SERVED)
@pytest.mark.parametrize("channels", [1, 3])
def test_build_input_equals_jax(name, channels):
    path = os.path.join(FIXTURES, name)
    entry = types.SimpleNamespace(in_channels=channels, resolution=24,
                                  input_mode="float32")
    got, hw = SegmentationServer._build_input(None, path, entry)
    want, want_hw = JaxServer._build_input(None, path, entry)
    assert hw == want_hw and got.dtype == np.uint8
    _same(got.astype(np.float32) / 255.0, want)


@pytest.mark.parametrize("group", ["jpeg_c1", "jpeg_c3", "jpeg_misc"])
@pytest.mark.parametrize("expand_dims", [True, False])
def test_dsb_dataset_equals_jax(group, expand_dims):
    root = os.path.join(FIXTURES, group)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        theirs = jax_dsb.DSB2018Dataset(root, "test", TRANSFORMER,
                                        expand_dims)
    ours = dsb.DSB2018Dataset(root, "test", TRANSFORMER, expand_dims)
    assert ours.paths == theirs.paths and len(ours) >= 6
    for a, b in zip(ours.images, theirs.images):
        _same(a, b)


def test_server_serves_jpeg(tmp_path):
    reg = ModelRegistry()
    reg.register(ModelEntry(name="half", forward=lambda x: x[..., 0] // 2,
                            in_channels=1, resolution=8))
    srv = SegmentationServer(reg, output_dir=str(tmp_path), max_batch=2,
                             max_wait_ms=1.0)
    try:
        for name in SERVED:
            path = os.path.join(FIXTURES, name)
            reply = srv.handle_predict({"image_path": path, "return": "mask"})
            assert reply["status"] == 200, reply
            want = png2d.nearest_resize(image.read(path, "L"), (8, 8)) // 2
            _same(np.asarray(reply["response"], np.uint8), want)
    finally:
        srv.engine.stop()

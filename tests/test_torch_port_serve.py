"""The port's serving path on the CPU: the same JAX-saved bundle served by
the port and by the JAX package, the batching engine, HTTP round trips, and
the stdlib PNG codec against PIL."""

import base64
import dataclasses
import http.client
import io
import json
import struct
import threading
import zlib

import numpy as np
import pytest
from PIL import Image

import jax
import jax.numpy as jnp

from mdeical_image_segmentation_tpu.models import UNetConfig as JaxUNetConfig
from mdeical_image_segmentation_tpu.models import UNetModel as JaxUNetModel
from mdeical_image_segmentation_tpu.serve import ModelRegistry as JaxRegistry
from mdeical_image_segmentation_tpu_torch.cli import serve as serve_cli
from mdeical_image_segmentation_tpu_torch.serve import (
    BatchingInferenceEngine,
    ModelEntry,
    ModelRegistry,
    SegmentationServer,
)
from mdeical_image_segmentation_tpu_torch.utils import png

RES = 32
PROB_TOL = 1e-5    # float32 probabilities, port vs JAX
TIE_BAND = 1e-4    # masks may differ only where p is this close to 0.5


def _bundle(root, out_channels):
    jm = JaxUNetModel(JaxUNetConfig(in_channels=1, out_channels=out_channels,
                                    unet_type="UNet", base_features=4))
    variables = jm.init(jax.random.PRNGKey(out_channels),
                        jnp.zeros((1, RES, RES, 1)))
    path = str(root / f"bundle_{out_channels}")
    jm.save_pretrained(path, variables)
    return path


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_serve")
    return {c: _bundle(root, c) for c in (1, 2)}


@pytest.fixture(scope="module")
def port_registry(bundles):
    reg = ModelRegistry()
    reg.register_unet2d("bin", bundles[1], resolution=RES, device="cpu",
                        max_batch=4)
    reg.register_unet2d("two", bundles[2], resolution=RES, device="cpu",
                        max_batch=4)
    return reg


def _masks_agree(a, b, probs, out_channels):
    """Equal except where the decision is a near tie."""
    differ = a != b
    if out_channels == 1:
        margin = np.abs(probs[..., 0] - 0.5)
    else:
        top2 = np.sort(probs, axis=-1)[..., -2:]
        margin = (top2[..., 1] - top2[..., 0]) / 2
    assert np.all(margin[differ] < TIE_BAND), int(differ.sum())


@pytest.mark.parametrize("out_channels,name", [(1, "bin"), (2, "two")])
def test_port_and_jax_serve_the_same_bundle(bundles, port_registry,
                                            out_channels, name):
    jreg = JaxRegistry()
    jreg.register_unet2d(name, bundles[out_channels], resolution=RES)
    jax_entry, entry = jreg.get(name), port_registry.get(name)

    x = np.random.default_rng(out_channels).random((3, RES, RES, 1),
                                                   dtype=np.float32)
    p_jax = jax_entry.probs_forward(x)
    p = entry.probs_forward(x)
    assert p.shape == p_jax.shape == (3, RES, RES, out_channels)
    np.testing.assert_allclose(p, p_jax, rtol=0, atol=PROB_TOL)

    xu8 = (x * 255).astype(np.uint8)
    m_jax, m = jax_entry.forward(xu8), entry.forward(xu8)
    assert m.dtype == np.uint8 and m.shape == m_jax.shape == (3, RES, RES)
    _masks_agree(m, m_jax, entry.probs_forward(xu8.astype(np.float32) / 255),
                 out_channels)


@pytest.mark.parametrize("pad", [True, False])
def test_engine_results_do_not_depend_on_pow2_padding(port_registry, pad):
    entry = port_registry.get("bin")
    sizes = []

    def recording_dispatch(x):
        sizes.append(x.shape[0])
        return entry.dispatch(x)

    reg = ModelRegistry()
    reg.register(dataclasses.replace(entry, dispatch=recording_dispatch))
    rng = np.random.default_rng(7)
    images = [rng.integers(0, 256, (RES, RES, 1), dtype=np.uint8)
              for _ in range(3)]
    engine = BatchingInferenceEngine(reg, max_batch=4, max_wait_ms=300.0,
                                     pad_to_pow2=pad)
    results = [None] * 3

    def call(i):
        results[i] = engine.infer("bin", images[i], timeout=60)

    threads = [threading.Thread(target=call, args=(i,)) for i in range(3)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        engine.stop()
    assert not any(t.is_alive() for t in threads)
    assert engine.occupancy()["bin"]["requests"] == 3
    if pad:
        assert all(s & (s - 1) == 0 for s in sizes), sizes
    else:
        assert sum(sizes) == 3, sizes
    for img, got in zip(images, results):
        want = entry.forward(img[None])[0]
        probs = entry.probs_forward(img[None].astype(np.float32) / 255)[0]
        _masks_agree(got, want, probs, 1)


def test_engine_serial_path_pads_and_unpads():
    """An entry without dispatch/fetch takes the engine's serial path: one
    forward per coalesced batch, padded to a power of two, results unpadded
    in request order."""
    seen = []

    def forward(x):
        seen.append(x.shape[0])
        return x[..., 0] // 2

    reg = ModelRegistry()
    reg.register(ModelEntry(name="double", forward=forward, in_channels=1,
                            resolution=4))
    engine = BatchingInferenceEngine(reg, max_batch=4, max_wait_ms=300.0)
    images = [np.full((4, 4, 1), 10 * i, np.uint8) for i in range(3)]
    results = [None] * 3

    def call(i):
        results[i] = engine.infer(None, images[i], timeout=60)

    threads = [threading.Thread(target=call, args=(i,)) for i in range(3)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        engine.stop()
    assert not any(t.is_alive() for t in threads)
    assert all(s & (s - 1) == 0 for s in seen) and seen
    for i, r in enumerate(results):
        np.testing.assert_array_equal(r, np.full((4, 4), 5 * i, np.uint8))


def test_tta_probabilities_match_jax(bundles):
    """tta=True: the mirror flip ensemble (4 passes) averaged in logit space
    before the sigmoid, as in the JAX package."""
    jreg, reg = JaxRegistry(), ModelRegistry()
    jreg.register_unet2d("t", bundles[1], resolution=RES, tta=True)
    reg.register_unet2d("t", bundles[1], resolution=RES, tta=True,
                        device="cpu", max_batch=1)
    x = np.random.default_rng(11).random((2, RES, RES, 1), dtype=np.float32)
    np.testing.assert_allclose(reg.get("t").probs_forward(x),
                               jreg.get("t").probs_forward(x),
                               rtol=0, atol=PROB_TOL)


# -- HTTP ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def server(port_registry, tmp_path_factory):
    root = tmp_path_factory.mktemp("port_http")
    srv = SegmentationServer(port_registry, output_dir=str(root / "masks"),
                             max_batch=4, max_wait_ms=10.0)
    httpd = srv.start(host="127.0.0.1", port=0)
    yield srv, httpd.server_address[1], root
    srv.stop()


def _post(port, payload):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("POST", "/", json.dumps(payload),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    body = json.loads(resp.read())
    conn.close()
    return resp.status, body


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", path)
    resp = conn.getresponse()
    body = json.loads(resp.read())
    conn.close()
    return resp.status, body


def test_http_png_mask_and_path_modes(server):
    srv, port, root = server
    img = np.random.default_rng(3).integers(0, 256, (40, 36), dtype=np.uint8)
    path = str(root / "scan.png")
    png.write(path, img)

    status, body = _post(port, {"image_path": path, "return": "mask"})
    assert status == 200 and body["model"] == "bin"
    mask = np.asarray(body["response"], np.uint8)
    assert mask.shape == (RES, RES) and set(np.unique(mask)) <= {0, 1}

    status, body = _post(port, {"image_path": path, "return": "png"})
    assert status == 200
    decoded = np.asarray(Image.open(io.BytesIO(
        base64.b64decode(body["response"]))))
    np.testing.assert_array_equal(decoded, mask)

    status, body = _post(port, {"image_path": path, "model": "two"})
    assert status == 200
    written = np.asarray(Image.open(body["response"]))
    assert written.shape == (RES, RES) and set(np.unique(written)) <= {0, 255}

    status, stats = _get(port, "/stats")
    assert status == 200 and stats["count"] >= 3 and "p50_ms" in stats
    assert stats["batch_occupancy"]["bin"]["requests"] >= 2


def test_http_error_paths(server):
    _, port, root = server
    status, body = _post(port, {"image_path": str(root / "missing.png")})
    assert status == 404
    deep = str(root / "deep.png")  # 16-bit grey: decoded and served
    Image.fromarray(np.full((8, 8), 1000, np.uint16)).save(deep)
    status, body = _post(port, {"image_path": deep, "return": "mask"})
    assert status == 200 and np.asarray(body["response"]).shape == (RES, RES)
    bad = str(root / "bad_depth.png")
    with open(bad, "wb") as f:
        f.write(_with_ihdr_byte(png.encode(np.zeros((8, 8), np.uint8)), 8, 3))
    status, body = _post(port, {"image_path": bad})
    assert status == 400 and "bit depth 3" in body["response"]
    status, body = _post(port, {"image_path": deep, "model": "nope"})
    assert status == 400
    status, body = _get(port, "/models")
    assert body == {"models": ["bin", "two"], "default": "bin"}


def test_unported_entry_points_raise(bundles):
    reg = ModelRegistry()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        reg.register_unet2d("q", bundles[1], device="cpu", quantize="int8")
    for fn in (reg.register_exported, reg.register_sam):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            fn("x", "y")
    # 3D serving is ported (test_torch_port_predictor.py); the 3D models
    # that are not yet still raise, naming their ROADMAP item
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        reg.register_unet3d("x", "y", {"name": "ResidualUNetSE3D"},
                            device="cpu")
    with pytest.raises(SystemExit, match="ROADMAP"):
        serve_cli.main(["--exported", "name=a,path=b"])
    with pytest.raises(SystemExit, match="ROADMAP"):
        serve_cli.main(["--sam", "name=a,path=b"])


def test_cli_refuses_cuda_without_a_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        serve_cli.main(["--device", "cuda", "--demo"])


# -- PNG codec against PIL ------------------------------------------------------


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filter_row(ftype, cur, prev, bpp):
    out = bytearray(len(cur))
    for i, x in enumerate(cur):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[ftype]
        out[i] = (x - pred) & 0xFF
    return bytes(out)


def _png_with_filter(pixels, colour_type, ftype, palette=None):
    """PNG bytes whose rows all use row filter ``ftype``."""
    h, w = pixels.shape[:2]
    bpp = pixels.reshape(h, w, -1).shape[-1]
    rows, prev = [], bytes(w * bpp)
    for r in range(h):
        cur = pixels[r].tobytes()
        rows.append(bytes([ftype]) + _filter_row(ftype, cur, prev, bpp))
        prev = cur

    def chunk(t, body):
        return (struct.pack(">I", len(body)) + t + body
                + struct.pack(">I", zlib.crc32(t + body)))

    out = b"\x89PNG\r\n\x1a\n" + chunk(
        b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour_type, 0, 0, 0))
    if palette is not None:
        out += chunk(b"PLTE", palette.tobytes())
    return out + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(
        b"IEND", b"")


_CT_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("colour_type", [0, 2, 3, 4, 6])
def test_decode_and_convert_match_pil(colour_type, ftype):
    rng = np.random.default_rng(colour_type * 10 + ftype)
    ch = _CT_CHANNELS[colour_type]
    palette = None
    if colour_type == 3:
        palette = rng.integers(0, 256, (40, 3), dtype=np.uint8)
        pixels = rng.integers(0, 40, (9, 11, 1), dtype=np.uint8)
    else:
        pixels = rng.integers(0, 256, (9, 11, ch), dtype=np.uint8)
    data = _png_with_filter(pixels, colour_type, ftype, palette)
    img = png.decode(data)
    for mode in ("L", "RGB"):
        want = np.asarray(Image.open(io.BytesIO(data)).convert(mode))
        np.testing.assert_array_equal(png.convert(img, mode), want,
                                      err_msg=mode)


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P"])
def test_decode_pil_written_pngs(mode):
    """PIL picks its own (adaptive) row filters."""
    rng = np.random.default_rng(1)
    arr = rng.integers(0, 256, (23, 17, 4), dtype=np.uint8)
    img = Image.fromarray(arr, "RGBA").convert(mode)
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    ours = png.decode(buf.getvalue())
    for target in ("L", "RGB"):
        np.testing.assert_array_equal(png.convert(ours, target),
                                      np.asarray(img.convert(target)))


@pytest.mark.parametrize("shape", [(5, 7), (5, 7, 1), (4, 3, 3), (4, 3, 4)])
def test_encoded_pngs_decode_identically_in_pil(shape):
    arr = np.random.default_rng(2).integers(0, 256, shape, dtype=np.uint8)
    got = np.asarray(Image.open(io.BytesIO(png.encode(arr))))
    np.testing.assert_array_equal(got, arr.reshape(got.shape))


def _with_ihdr_byte(good: bytes, index: int, value: int) -> bytes:
    ihdr = bytearray(good[16:29])
    ihdr[index] = value
    body = b"IHDR" + bytes(ihdr)
    return good[:12] + body + struct.pack(">I", zlib.crc32(body)) + good[33:]


def test_unsupported_pngs_raise_png_error():
    good = png.encode(np.zeros((4, 4), np.uint8))
    with pytest.raises(png.PngError, match="bit depth"):
        png.decode(_with_ihdr_byte(good, 8, 3))  # no PNG has 3-bit grey
    interlaced = _with_ihdr_byte(good, 12, 1)  # interlace method: Adam7
    with pytest.raises(png.PngError, match="interlaced"):
        png.decode(interlaced)
    corrupt = bytearray(good)
    corrupt[20] ^= 0xFF
    with pytest.raises(png.PngError, match="CRC"):
        png.decode(bytes(corrupt))
    with pytest.raises(png.PngError, match="signature"):
        png.decode(b"GIF89a")

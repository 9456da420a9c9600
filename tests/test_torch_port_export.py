"""The port's exported artifacts (``export.py``, ``cli/export.py``,
``ModelRegistry.register_exported``) on the CPU, mirroring the JAX
package's ``tests/test_export.py`` on the same JAX-saved bundles: the
artifact at several batches of one symbolic-batch program against the
port's live forward (1e-6) and the JAX package's own artifact (1e-5), the
logits variant, the 3D activated output, meta and files, HTTP serving, the
rejections, and the CLI."""

import http.client
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from mdeical_image_segmentation_tpu.export import export_bundle as jax_export
from mdeical_image_segmentation_tpu.export import load_exported as jax_load
from mdeical_image_segmentation_tpu.models import (
    UNet3DConfig as JaxUNet3DConfig,
)
from mdeical_image_segmentation_tpu.models import (
    UNet3DForMedicalSegmentation as JaxUNet3D,
)
from mdeical_image_segmentation_tpu.models import UNetConfig as JaxUNetConfig
from mdeical_image_segmentation_tpu.models import UNetModel as JaxUNetModel
from mdeical_image_segmentation_tpu_torch.export import (
    ARTIFACT_FILE,
    META_FILE,
    detect_bundle_kind,
    export_bundle,
    load_exported,
)
from mdeical_image_segmentation_tpu_torch.models import (
    UNet3DForMedicalSegmentation,
    UNetModel,
)
from mdeical_image_segmentation_tpu_torch.serve import (
    ModelRegistry,
    SegmentationServer,
)

RES = (32, 32)
PATCH = (8, 16, 16)
LIVE_TOL = 1e-6   # the artifact against the port's live forward
JAX_TOL = 1e-5    # the artifact against the JAX package's artifact


@pytest.fixture(scope="module")
def bundle2d(tmp_path_factory):
    root = tmp_path_factory.mktemp("exp")
    path = str(root / "unet2d")
    model = JaxUNetModel(JaxUNetConfig(in_channels=1, out_channels=1,
                                       unet_type="UNet", base_features=4))
    variables = model.init(jax.random.PRNGKey(0),
                           jnp.zeros((1,) + RES + (1,)))
    model.save_pretrained(path, variables)
    probs = jax_load(jax_export(path, str(root / "jax_probs"),
                                resolution=RES, platforms=("cpu",)))
    logits = jax_load(jax_export(path, str(root / "jax_logits"),
                                 resolution=RES, platforms=("cpu",),
                                 output="logits", batch=2))
    return {"path": path, "jax_probs": probs, "jax_logits": logits}


@pytest.fixture(scope="module")
def bundle3d(tmp_path_factory):
    root = tmp_path_factory.mktemp("exp3")
    path = str(root / "unet3d")
    model = JaxUNet3D(JaxUNet3DConfig(unet_type="UNet3D", in_channels=1,
                                      out_channels=1, f_maps=8, num_levels=2,
                                      num_groups=4, final_sigmoid=True))
    variables = model.init(jax.random.PRNGKey(0),
                           jnp.zeros((1,) + PATCH + (1,)))
    model.save_pretrained(path, variables)
    art = jax_load(jax_export(path, str(root / "jax3d"), patch_shape=PATCH,
                              platforms=("cpu",)))
    return {"path": path, "jax": art}


@pytest.fixture(scope="module")
def artifact2d(bundle2d, tmp_path_factory):
    return export_bundle(bundle2d["path"],
                         str(tmp_path_factory.mktemp("art2d") / "art"),
                         resolution=RES, device="cpu")


def _close(got, want, tol):
    err = float(np.abs(got - want).max())
    assert err <= tol, err


def test_detect_bundle_kind(bundle2d, bundle3d):
    assert detect_bundle_kind(bundle2d["path"]) == "2d"
    assert detect_bundle_kind(bundle3d["path"]) == "3d"


def test_export_2d_symbolic_batch_matches_live(bundle2d, artifact2d):
    loaded = load_exported(artifact2d, device="cpu")
    assert loaded.meta["input_shape"] == ["b", 32, 32, 1]
    ops = {str(n.target) for n in loaded.program.graph.nodes}
    assert "tpuseg.fused_double2d_y.default" in ops
    live = UNetModel.from_pretrained(bundle2d["path"],
                                     device="cpu").for_inference()
    rs = np.random.RandomState(0)
    for b in (1, 3):  # two batches through ONE symbolic-batch program
        x = rs.rand(b, *RES, 1).astype(np.float32)
        got = loaded(x)
        with torch.no_grad():
            want = torch.sigmoid(live(torch.from_numpy(x)).logits).numpy()
        _close(got, want, LIVE_TOL)
        _close(got, bundle2d["jax_probs"](x), JAX_TOL)


def test_export_logits_variant(bundle2d, tmp_path):
    out = export_bundle(bundle2d["path"], str(tmp_path / "art"),
                        resolution=RES, device="cpu", output="logits",
                        batch=2)
    loaded = load_exported(out, device="cpu")
    assert loaded.meta["output"] == "logits"
    assert loaded.meta["input_shape"][0] == 2
    x = np.random.RandomState(1).rand(2, *RES, 1).astype(np.float32)
    live = UNetModel.from_pretrained(bundle2d["path"], device="cpu")
    with torch.no_grad():
        want = live(torch.from_numpy(x)).logits.numpy()
    _close(loaded(x), want, LIVE_TOL)
    _close(loaded(x), bundle2d["jax_logits"](x), JAX_TOL)
    with pytest.raises(Exception):  # the batch is pinned
        loaded(np.concatenate([x, x]))


def test_export_3d_activated_output(bundle3d, tmp_path):
    out = export_bundle(bundle3d["path"], str(tmp_path / "art"),
                        patch_shape=PATCH, device="cpu")
    loaded = load_exported(out, device="cpu")
    ops = {str(n.target) for n in loaded.program.graph.nodes}
    assert {"tpuseg.fused_conv3d.default",
            "tpuseg.gn_channel_sums.default"} <= ops
    x = np.random.RandomState(2).rand(2, *PATCH, 1).astype(np.float32)
    live = UNet3DForMedicalSegmentation.from_pretrained(bundle3d["path"],
                                                        device="cpu")
    with torch.no_grad():
        want = live(torch.from_numpy(x)).logits.numpy()  # activated (quirk)
    got = loaded(x)
    _close(got, want, LIVE_TOL)
    _close(got, bundle3d["jax"](x), JAX_TOL)
    assert loaded.meta["kind"] == "3d"


def test_export_bf16_compute_dtype_equals_the_bf16_serving_copy(
        bundle2d, tmp_path):
    out = export_bundle(bundle2d["path"], str(tmp_path / "art"),
                        resolution=RES, device="cpu",
                        compute_dtype="bfloat16")
    x = np.random.RandomState(4).rand(2, *RES, 1).astype(np.float32)
    live = UNetModel.from_pretrained(bundle2d["path"], device="cpu")
    live.config.compute_dtype = "bfloat16"
    live.compute_dtype = torch.bfloat16
    live.for_inference()
    with torch.no_grad():
        want = torch.sigmoid(live(torch.from_numpy(x)).logits).numpy()
    np.testing.assert_array_equal(load_exported(out, device="cpu")(x), want)


def test_meta_and_artifact_files(artifact2d):
    meta = json.load(open(os.path.join(artifact2d, META_FILE)))
    blob = open(os.path.join(artifact2d, ARTIFACT_FILE), "rb").read()
    assert meta["artifact_bytes"] == len(blob)
    assert meta["device"] == "cpu" and meta["torch_version"] == (
        torch.__version__)
    assert meta["unet_type"] == "UNet" and meta["output"] == "probs"
    assert set(meta) == {"kind", "unet_type", "in_channels", "out_channels",
                         "input_shape", "input_dtype", "output", "device",
                         "torch_version", "artifact_bytes"}


def test_serve_exported_artifact_http(bundle2d, artifact2d, tmp_path):
    """An artifact serves over HTTP with no model code in the registry
    path; the mask is the JAX artifact's probabilities thresholded."""
    registry = ModelRegistry()
    registry.register_exported("aot", artifact2d, device="cpu", max_batch=4)
    entry = registry.get("aot")
    assert entry.resolution == 32 and entry.in_channels == 1

    srv = SegmentationServer(registry, output_dir=str(tmp_path / "masks"),
                             max_batch=4, max_wait_ms=5.0)
    httpd = srv.start(host="127.0.0.1", port=0)
    port = httpd.server_address[1]
    try:
        img = (np.random.RandomState(3).rand(32, 32) * 255).astype(np.uint8)
        img_path = str(tmp_path / "img.png")
        Image.fromarray(img).save(img_path)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("POST", "/",
                     json.dumps({"image_path": img_path, "return": "mask"}),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        body = json.loads(resp.read())
        conn.close()
        assert resp.status == 200
        mask = np.asarray(body["response"])
        assert mask.shape == (32, 32) and set(np.unique(mask)) <= {0, 1}
        p = bundle2d["jax_probs"](img[None, ..., None].astype(np.float32)
                                  / 255.0)[0, ..., 0]
        decided = np.abs(p - 0.5) > 1e-4
        np.testing.assert_array_equal(mask[decided], (p > 0.5)[decided])
    finally:
        srv.stop()


def test_register_exported_rejects_wrong_artifacts(bundle2d, bundle3d,
                                                   artifact2d, tmp_path):
    registry = ModelRegistry()
    out3d = export_bundle(bundle3d["path"], str(tmp_path / "a3"),
                          patch_shape=PATCH, device="cpu")
    with pytest.raises(ValueError, match="kind"):
        registry.register_exported("x", out3d, device="cpu")
    logits = export_bundle(bundle2d["path"], str(tmp_path / "al"),
                           resolution=RES, device="cpu", output="logits")
    with pytest.raises(ValueError, match="probab"):
        registry.register_exported("x", logits, device="cpu")
    pinned = export_bundle(bundle2d["path"], str(tmp_path / "ap"),
                           resolution=RES, device="cpu", batch=4)
    with pytest.raises(ValueError, match="batch"):
        registry.register_exported("x", pinned, device="cpu")
    wide = export_bundle(bundle2d["path"], str(tmp_path / "aw"),
                         resolution=(32, 48), device="cpu")
    with pytest.raises(ValueError, match="non-square"):
        registry.register_exported("x", wide, device="cpu")
    # an artifact keeps the device it was traced on
    with pytest.raises(ValueError, match="traced for device 'cpu'"):
        load_exported(artifact2d, device="meta")
    assert registry.names() == []


def test_cli_main(bundle2d, tmp_path, capsys, monkeypatch):
    from mdeical_image_segmentation_tpu_torch import serve as serve_pkg
    from mdeical_image_segmentation_tpu_torch.cli import serve as serve_cli
    from mdeical_image_segmentation_tpu_torch.cli.export import main

    out = str(tmp_path / "cli_art")
    main(["--model_dir", bundle2d["path"], "--output", out,
          "--resolution", "32", "32", "--device", "cpu"])
    meta = json.loads(capsys.readouterr().out.strip())
    assert meta["kind"] == "2d" and meta["device"] == "cpu"
    assert os.path.exists(os.path.join(out, ARTIFACT_FILE))
    served = {}
    monkeypatch.setattr(serve_pkg, "serve",
                        lambda registry, **kw: served.update(reg=registry))
    serve_cli.main(["--exported", f"name=aot,path={out},threshold=0.4",
                    "--device", "cpu", "--max_batch", "2"])
    assert served["reg"].names() == ["aot"]

"""The port's 3D inference path on the CPU against the JAX package: the
sliding-window ``StandardPredictor._device_accumulate`` on the same patch
batches, the in-memory patch batches against the JAX HDF5 test dataset and
loader, the volume and image helpers it rests on, and ``register_unet3d``
serving a slice.

Tolerances: sum maps within rtol = atol = 1e-4 (the port's model matches
the JAX model to ~1e-5 in float32, see test_torch_port_unet3d.py); count
maps, patch windows, padded patches and resize index maps are equal;
served probabilities within 1e-4."""

import base64
import http.client
import json

import h5py
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mdeical_image_segmentation_tpu.data import StandardHDF5Dataset, VolumeLoader
from mdeical_image_segmentation_tpu.data import slice_builder as jax_sb
from mdeical_image_segmentation_tpu.data import volume_utils as jax_vu
from mdeical_image_segmentation_tpu.infer import StandardPredictor as JaxPredictor
from mdeical_image_segmentation_tpu.models import get_model as jax_get_model
from mdeical_image_segmentation_tpu.ops import image as jax_image
from mdeical_image_segmentation_tpu.serve import ModelRegistry as JaxRegistry
from mdeical_image_segmentation_tpu.train import save_checkpoint as jax_save
from mdeical_image_segmentation_tpu_torch.data import slice_builder, volume_utils
from mdeical_image_segmentation_tpu_torch.data.loaders import get_test_loaders
from mdeical_image_segmentation_tpu_torch.infer import (
    StandardPredictor,
    get_predictor,
)
from mdeical_image_segmentation_tpu_torch.models import get_model
from mdeical_image_segmentation_tpu_torch.ops import image, overlap
from mdeical_image_segmentation_tpu_torch.serve import (
    ModelRegistry,
    SegmentationServer,
)
from mdeical_image_segmentation_tpu_torch.utils import png
from mdeical_image_segmentation_tpu_torch.utils.param_bridge import (
    flax_to_state_dict,
)

TOL = 1e-4
MODEL = {"name": "UNet3D", "in_channels": 1, "out_channels": 2, "f_maps": 8,
         "num_levels": 2, "layer_order": "gcr", "final_sigmoid": False}
PATCH, HALO = (4, 64, 64), (2, 8, 8)
VOLUME = (6, 96, 112)  # 2 x 2 x 2 windows with tail overlap: 8 patches


@pytest.fixture(scope="module")
def models():
    jm = jax_get_model(MODEL)
    variables = jm.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, 8, 80, 80, 1)), False)
    model = get_model(MODEL)
    model.load_state_dict(flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, variables)))
    return jm, variables, model


@pytest.fixture(scope="module")
def raw():
    return np.random.default_rng(0).standard_normal(VOLUME).astype(
        np.float32)


SLICES = {"name": "SliceBuilder", "patch_shape": list(PATCH),
          "stride_shape": list(PATCH), "halo_shape": list(HALO)}


def _batches(raw, batch_size):
    return list(volume_utils.padded_patch_batches(raw, SLICES, batch_size))


def test_patch_batches_match_the_jax_dataset_and_loader(tmp_path, raw):
    path = str(tmp_path / "vol.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("raw", data=raw)
    ds = StandardHDF5Dataset(
        path, "test", dict(SLICES), {"raw": [{"name": "ToTensor",
                                     "expand_dims": True}]},
        global_normalization=False)
    theirs = list(VolumeLoader(ds, batch_size=3, prefetch=0))
    ours = _batches(raw, 3)
    assert [len(b[1]) for b in ours] == [3, 3, 2]
    assert len(ours) == len(theirs)
    for (x, idx), (tx, tidx) in zip(ours, theirs):
        np.testing.assert_array_equal(x, np.asarray(tx))
        assert [tuple(i) for i in idx] == [tuple(i) for i in tidx]


@pytest.mark.parametrize("shape,patch,stride", [
    ((10, 100, 90), (4, 64, 64), (3, 20, 64)),
    ((8, 64, 64), (8, 64, 64), (8, 64, 64)),
    ((2, 9, 70, 65), (4, 64, 64), (4, 32, 32)),  # with a channel axis
])
def test_slice_builder_matches_jax(shape, patch, stride):
    arr = np.zeros(shape, np.float32)
    ours = slice_builder.SliceBuilder(arr, arr, None, patch, stride)
    theirs = jax_sb.SliceBuilder(arr, arr, None, patch, stride)
    assert ours.raw_slices == theirs.raw_slices
    assert ours.label_slices == theirs.label_slices
    built = slice_builder.get_slice_builder(
        arr, None, None, {"name": "SliceBuilder", "patch_shape": patch,
                          "stride_shape": stride, "halo_shape": [0, 0, 0]})
    assert built.raw_slices == theirs.raw_slices


def test_volume_utils_match_jax(raw):
    np.testing.assert_array_equal(volume_utils.mirror_pad(raw, HALO),
                                  jax_vu.mirror_pad(raw, HALO))
    padded = volume_utils.mirror_pad(raw, HALO)
    np.testing.assert_array_equal(volume_utils.remove_padding(padded, HALO),
                                  raw)
    idx = (slice(2, 6), slice(0, 64), slice(48, 112))
    assert (volume_utils.create_padded_indexes(idx, HALO)
            == jax_vu.create_padded_indexes(idx, HALO))
    ours, theirs = (volume_utils.calculate_stats(raw),
                    jax_vu.calculate_stats(raw))
    assert ours == theirs


@pytest.mark.parametrize("in_size,out_size", [(58, 117), (29, 58), (4, 8),
                                              (7, 5), (3, 10)])
def test_nearest_interpolation_matches_jax(in_size, out_size):
    x = np.random.default_rng(in_size).standard_normal(
        (1, 3, in_size, 2, 2)).astype(np.float32)
    out = (3, out_size, 4)
    ours = image.interpolate_nearest_nd(torch.from_numpy(x), out)
    theirs = jax_image.interpolate_nearest_nd(jnp.asarray(x), out)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


@pytest.mark.parametrize("shape", [(1, 8, 117, 234, 3), (2, 5, 9, 7, 1)])
def test_pools_match_jax(shape):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    for ours, theirs in ((image.max_pool_nd, jax_image.max_pool_nd),
                         (image.avg_pool_nd, jax_image.avg_pool_nd)):
        np.testing.assert_allclose(
            ours(torch.from_numpy(x), 2).numpy(),
            np.asarray(theirs(jnp.asarray(x), 2)), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("batch_size,tta,channel,act", [
    (4, None, None, False),     # 8 patches: two full batches
    (3, None, None, True),      # a padded tail batch, probabilities
    (3, "mirror", 1, False),    # flip ensemble, one channel kept
    (5, "mirror-hw", None, False),
])
def test_device_accumulate_matches_jax(models, raw, batch_size, tta,
                                       channel, act):
    jm, variables, model = models
    batches = _batches(raw, batch_size)
    kw = dict(tta=tta, prediction_channel=channel, apply_activation=act)
    jax_pred = JaxPredictor(jm, variables, None, out_channels=2, **kw)
    ja, jc = jax_pred._device_accumulate(iter(batches), VOLUME, HALO)
    pred = StandardPredictor(model, None, out_channels=2, **kw)
    before = overlap.overlap_add_into.launches
    acc, cnt = pred._device_accumulate(iter(batches), VOLUME, HALO)
    assert overlap.overlap_add_into.launches == before  # CPU: plain version
    np.testing.assert_array_equal(cnt, jc)
    assert cnt.min() >= 1  # every voxel covered
    np.testing.assert_allclose(acc, ja, rtol=TOL, atol=TOL)


def test_get_predictor_reads_the_predict_config(models):
    _, _, model = models
    cfg = {"model": MODEL, "predictor": {
        "name": "StandardPredictor", "save_segmentation": False,
        "accumulate_on_device": True, "tta": "mirror"}}
    pred = get_predictor(model, "out", cfg)
    assert isinstance(pred, StandardPredictor) and pred.tta == "mirror"
    assert pred.out_channels == 2 and pred.device == torch.device("cpu")
    # int8 PTQ is ported (test_torch_port_quant_models.py): the keys reach
    # the predictor; an unknown scheme raises
    q = get_predictor(model, "out", {**cfg, "predictor": {
        "quantize": "int8", "calib_batches": 3}})
    assert q.quantize == "int8" and q.calib_batches == 3
    with pytest.raises(ValueError, match="expected 'int8'"):
        get_predictor(model, "out", {**cfg, "predictor": {"quantize": "int4"}})
    with pytest.raises(NotImplementedError, match="item 20"):
        get_predictor(model, "out", {**cfg, "predictor": {
            "name": "LazyPredictor"}})
    with pytest.raises(NotImplementedError, match="item 20"):
        list(get_test_loaders({"loaders": {"dataset": "LazyHDF5Dataset",
                                           "test": {"file_paths": []}}}))
    with pytest.raises(ValueError, match="unknown predictor config keys"):
        get_predictor(model, "out", {**cfg, "predictor": {"typo": 1}})


@pytest.fixture(scope="module")
def unet3d_checkpoint(models, tmp_path_factory):
    _, variables, _ = models
    root = tmp_path_factory.mktemp("ckpt3d")
    return jax_save({"model_state_dict": {"params": variables["params"],
                                          "batch_stats": {}},
                     "best_eval_score": 0.0}, False, str(root))


def test_register_unet3d_serves_a_slice_like_jax(unet3d_checkpoint):
    res = 32
    jreg = JaxRegistry()
    jreg.register_unet3d("v", unet3d_checkpoint, MODEL, resolution=res)
    reg = ModelRegistry()
    reg.register_unet3d("v", unet3d_checkpoint, MODEL, resolution=res,
                        device="cpu", max_batch=2)
    x = np.random.default_rng(2).random((2, res, res, 1)).astype(np.float32)
    p_jax = np.asarray(jreg.get("v").forward(x))
    p = reg.get("v").probs_forward(x)
    assert p.shape == (2, res, res, 2)
    np.testing.assert_allclose(p, p_jax, rtol=TOL, atol=TOL)
    xu8 = (x * 255).astype(np.uint8)
    mask = reg.get("v").forward(xu8)
    want = reg.get("v").probs_forward(xu8.astype(np.float32) / 255).argmax(-1)
    np.testing.assert_array_equal(mask, want)


def test_register_unet3d_http_round_trip(unet3d_checkpoint, tmp_path):
    res = 32
    reg = ModelRegistry()
    reg.register_unet3d("v", unet3d_checkpoint, MODEL, resolution=res,
                        device="cpu", max_batch=2)
    img = (np.random.default_rng(3).random((40, 50)) * 255).astype(np.uint8)
    path = str(tmp_path / "slice.png")
    png.write(path, img)
    srv = SegmentationServer(reg, output_dir=str(tmp_path / "masks"),
                             max_batch=2)
    port = srv.start(host="127.0.0.1", port=0).server_address[1]
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("POST", "/", json.dumps({"image_path": path,
                                              "return": "png"}),
                     {"Content-Type": "application/json"})
        reply = json.loads(conn.getresponse().read())
        conn.close()
    finally:
        srv.stop()
    assert reply["status"] == 200, reply
    mask = png.convert(png.decode(base64.b64decode(reply["response"])), "L")
    assert mask.shape == (res, res) and mask.max() <= 1

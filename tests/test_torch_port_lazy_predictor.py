"""The port's ``LazyPredictor`` over ``LazyHDF5Dataset`` against the JAX
package's, through each package's ``get_test_loaders`` and
``get_predictor`` on the same h5py-written volume (16x48x48, 8 windows of
8x24x24 with a 2/4/4 halo, batches of 2) and a tiny UNet3D (f_maps 4, 2
levels, 'gcr', 2 output channels) whose weights the parameter bridge
carries from the JAX variables.

- The averaged maps within 1e-5 (the same float32 sums; the models agree to
  ~1e-6), the file without the ``normalization`` map; with
  ``save_segmentation`` both files hold only ``segmentation``, equal.
- The padded memo ``raw_padded_2x4x4`` the port appends to the input file
  is what the JAX package's ``LazyHDF5Dataset`` reads, and the reverse: the
  same patches, to the bit, and neither package writes a second memo.
- The port's Lazy map equals its Standard map (within 1e-6), and a Lazy
  call with the memo present (on a 16x96x96 volume) holds less than half
  the float32 map's bytes at its ``tracemalloc`` peak (the maps live in
  files)."""

import os
import shutil
import tracemalloc

import h5py
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from mdeical_image_segmentation_tpu.data import hdf5 as jax_hdf5
from mdeical_image_segmentation_tpu.data import loaders as jax_loaders
from mdeical_image_segmentation_tpu.infer import predictor as jax_predictor
from mdeical_image_segmentation_tpu.models import get_model as jax_get_model
from mdeical_image_segmentation_tpu_torch.data import hdf5 as port_hdf5
from mdeical_image_segmentation_tpu_torch.data import loaders
from mdeical_image_segmentation_tpu_torch.infer import predictor
from mdeical_image_segmentation_tpu_torch.models import get_model
from mdeical_image_segmentation_tpu_torch.utils.param_bridge import (
    flax_to_state_dict,
)

TOL = 1e-5
MODEL = {"name": "UNet3D", "in_channels": 1, "out_channels": 2, "f_maps": 4,
         "num_levels": 2, "num_groups": 2, "layer_order": "gcr",
         "final_sigmoid": False}
VOLUME = (16, 48, 48)
SLICES = {"name": "SliceBuilder", "patch_shape": [8, 24, 24],
          "stride_shape": [8, 24, 24], "halo_shape": [2, 4, 4],
          "skip_shape_check": True}
MEMO = "raw_padded_2x4x4"


def _config(path, out_dir, **predictor_kw):
    return {"model": MODEL, "output_dir": out_dir,
            "predictor": {"name": "LazyPredictor", **predictor_kw},
            "loaders": {"dataset": "LazyHDF5Dataset", "batch_size": 2,
                        "test": {"file_paths": [path],
                                 "slice_builder": dict(SLICES),
                                 "transformer": {"raw": [
                                     {"name": "Standardize"},
                                     {"name": "ToTensor",
                                      "expand_dims": True}]}}}}


def _run_port(model, cfg):
    pred = predictor.get_predictor(model, cfg["output_dir"], cfg)
    return [pred(loader) for loader in loaders.get_test_loaders(cfg)]


def _run_jax(jm, variables, cfg):
    pred = jax_predictor.get_predictor(jm, variables, cfg["output_dir"], cfg)
    return [pred(loader) for loader in jax_loaders.get_test_loaders(cfg)]


def _read(path):
    with h5py.File(path, "r") as f:
        return {k: f[k][()] for k in f.keys()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("lazy")
    jm = jax_get_model(MODEL)
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 12, 32, 32, 1)),
                        False)
    model = get_model(MODEL)
    model.load_state_dict(flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, variables)))
    raw = np.random.default_rng(0).standard_normal(VOLUME).astype(np.float32)
    files = {}
    for who in ("jax", "port"):
        os.makedirs(root / who)
        files[who] = str(root / who / "vol.h5")
        with h5py.File(files[who], "w") as f:
            f.create_dataset("raw", data=raw, compression="gzip")
    out = {}
    for seg in (False, True):
        tag = "seg" if seg else "map"
        (out["jax", tag],) = _run_jax(jm, variables, _config(
            files["jax"], str(root / f"jax_{tag}"), save_segmentation=seg))
        (out["port", tag],) = _run_port(model, _config(
            files["port"], str(root / f"port_{tag}"), save_segmentation=seg))
    return {"model": model, "files": files, "out": out}


def test_lazy_maps_match_jax(runs):
    want = _read(runs["out"]["jax", "map"])
    got = _read(runs["out"]["port", "map"])
    assert list(got) == list(want) == ["predictions"]
    assert got["predictions"].shape == (2,) + VOLUME
    assert got["predictions"].dtype == np.float32
    np.testing.assert_allclose(got["predictions"], want["predictions"],
                               rtol=TOL, atol=TOL)
    with h5py.File(runs["out"]["port", "map"], "r") as f:
        assert f["predictions"].compression == "gzip"
    # the scratch maps are gone
    assert os.listdir(os.path.dirname(runs["out"]["port", "map"])) == [
        "vol_predictions.h5"]


def test_lazy_segmentation_matches_jax(runs):
    want = _read(runs["out"]["jax", "seg"])
    got = _read(runs["out"]["port", "seg"])
    assert list(got) == list(want) == ["segmentation"]
    assert got["segmentation"].dtype == np.uint16
    np.testing.assert_array_equal(got["segmentation"], want["segmentation"])
    maps = _read(runs["out"]["port", "map"])["predictions"]
    np.testing.assert_array_equal(got["segmentation"],
                                  np.argmax(maps, axis=0))


@pytest.mark.parametrize("reader", ["jax_reads_port", "port_reads_jax"])
def test_padded_memo_is_read_across_packages(runs, reader):
    files = runs["files"]
    for path in files.values():
        with h5py.File(path, "r") as f:
            assert sorted(f.keys()) == ["raw", MEMO]
            memo = f[MEMO][()]
        pad = SLICES["halo_shape"]
        assert memo.shape == tuple(n + 2 * h for n, h in zip(VOLUME, pad))
    cls, path = ((jax_hdf5.LazyHDF5Dataset, files["port"])
                 if reader == "jax_reads_port"
                 else (port_hdf5.LazyHDF5Dataset, files["jax"]))
    other = (port_hdf5.LazyHDF5Dataset if reader == "jax_reads_port"
             else jax_hdf5.LazyHDF5Dataset)
    kw = dict(phase="test", slice_builder_config=dict(SLICES),
              transformer_config={"raw": [{"name": "ToTensor",
                                           "expand_dims": True}]})
    before = os.path.getsize(path)
    ours = cls(file_path=path, **kw)
    theirs = other(file_path=files["jax" if reader == "jax_reads_port"
                                     else "port"], **kw)
    assert len(ours) == len(theirs) == 8
    for i in range(len(ours)):
        (a, ia), (b, ib) = ours[i], theirs[i]
        assert ia == ib
        np.testing.assert_array_equal(a, b)
    assert os.path.getsize(path) == before  # read, not written again


def test_lazy_equals_standard_in_the_port(runs, tmp_path):
    path = str(tmp_path / "vol.h5")
    shutil.copy(runs["files"]["port"], path)
    cfg = _config(path, str(tmp_path / "std"))
    cfg["predictor"]["name"] = "StandardPredictor"
    cfg["loaders"]["dataset"] = "StandardHDF5Dataset"
    (std,) = _run_port(runs["model"], cfg)
    np.testing.assert_allclose(
        _read(std)["predictions"],
        _read(runs["out"]["port", "map"])["predictions"], rtol=1e-6,
        atol=1e-6)


def test_lazy_call_keeps_the_maps_out_of_memory(runs, tmp_path):
    """With the memo present, a Lazy call's tracemalloc peak (numpy and
    Python allocations, zlib's deflate state among them; the model's
    tensors are torch's) stays under half the float32 map's bytes.  The
    volume is 16x96x96 (32 windows), so that the map, not the constant
    per-chunk and per-patch buffers, is what a whole-map design would
    add."""
    path = str(tmp_path / "big.h5")
    volume = (16, 96, 96)
    with h5py.File(path, "w") as f:
        f.create_dataset("raw", data=np.random.default_rng(1).standard_normal(
            volume).astype(np.float32), compression="gzip")
    cfg = _config(path, str(tmp_path / "out"))
    (first,) = _run_port(runs["model"], cfg)  # writes the memo
    want = _read(first)["predictions"]
    pred = predictor.get_predictor(runs["model"], cfg["output_dir"], cfg)
    (loader,) = loaders.get_test_loaders(cfg)
    map_bytes = 2 * int(np.prod(volume)) * 4
    tracemalloc.start()
    try:
        tracemalloc.reset_peak()
        out = pred(loader)
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    np.testing.assert_array_equal(_read(out)["predictions"], want)
    assert peak < map_bytes / 2, (peak, map_bytes)

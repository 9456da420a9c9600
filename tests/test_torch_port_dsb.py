"""The port's DSB2018 path (``data/dsb.py``, ``DSB2018Predictor``,
``dsb_save_batch``) against the JAX package's on seeded PNGs.

- ``DSB2018Dataset`` reads 8-bit grey, 16-bit grey, grey + alpha, RGB and
  RGBA PNGs (written with PIL) into the arrays the JAX package's imageio
  gives, dtypes included, and lays them out the same way (with and without
  ``expand_dims``), masks too; a GIF, TIFF or JPEG file reads as imageio
  reads it (palette, sub-byte and 16-bit colour PNGs are held in
  ``test_torch_port_png_extra.py``, the TIFF, GIF and BMP matrix in
  ``test_torch_port_image_formats.py``, JPEG in
  ``test_torch_port_jpeg.py``).
- ``DSB2018Predictor`` with a UNet2D (f_maps 8, 2 levels, 'gcr') whose
  weights the parameter bridge carries from the JAX variables: each
  ``<name>_predictions.h5`` holds ``predictions`` within 1e-5 of the JAX
  package's and ``segmentation`` (the connected components of p > 0.5,
  uint16) equal, for grey images and RGBA ones (4 input channels)."""

import os

import h5py
import numpy as np
import pytest
from PIL import Image

import jax
import jax.numpy as jnp

from mdeical_image_segmentation_tpu.data import dsb as jax_dsb
from mdeical_image_segmentation_tpu.data import loaders as jax_loaders
from mdeical_image_segmentation_tpu.infer import predictor as jax_predictor
from mdeical_image_segmentation_tpu.models import get_model as jax_get_model
from mdeical_image_segmentation_tpu_torch.data import dsb, loaders
from mdeical_image_segmentation_tpu_torch.infer import predictor
from mdeical_image_segmentation_tpu_torch.models import get_model
from mdeical_image_segmentation_tpu_torch.utils.param_bridge import (
    flax_to_state_dict,
)

TOL = 1e-5
SIZE = (32, 48)
TRANSFORMER = {"raw": [{"name": "Standardize"},
                       {"name": "ToTensor", "expand_dims": True}],
               "label": [{"name": "ToTensor", "expand_dims": True}]}


def _image(kind, rng):
    h, w = SIZE
    u8 = lambda *s: rng.integers(0, 256, (h, w) + s, dtype=np.uint8)  # noqa: E731
    if kind == "grey8":
        return Image.fromarray(u8())
    if kind == "grey16":
        return Image.fromarray(rng.integers(0, 65536, (h, w),
                                            dtype=np.uint16))
    if kind == "grey_alpha":
        return Image.fromarray(u8(2), "LA")
    if kind == "rgb":
        return Image.fromarray(u8(3), "RGB")
    return Image.fromarray(u8(4), "RGBA")


def _dsb_dir(root, kind, n=3, masks=False, seed=0):
    rng = np.random.default_rng(seed)
    os.makedirs(root / "images")
    for i in range(n):
        _image(kind, rng).save(root / "images" / f"im{i}.png")
    if masks:
        os.makedirs(root / "masks")
        for i in range(n):
            Image.fromarray((rng.random(SIZE) > 0.6).astype(np.uint8)).save(
                root / "masks" / f"im{i}.png")
    return str(root)


@pytest.mark.parametrize("kind", ["grey8", "grey16", "grey_alpha", "rgb",
                                  "rgba"])
@pytest.mark.parametrize("expand_dims", [True, False])
def test_images_read_as_imageio_reads_them(tmp_path, kind, expand_dims):
    root = _dsb_dir(tmp_path, kind, masks=True, seed=len(kind))
    for phase in ("test", "val"):
        ours = dsb.DSB2018Dataset(root, phase, TRANSFORMER, expand_dims)
        theirs = jax_dsb.DSB2018Dataset(root, phase, TRANSFORMER,
                                        expand_dims)
        assert ours.paths == theirs.paths and len(ours) == len(theirs) == 3
        for a, b in zip(ours.images, theirs.images):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
        if phase == "val":
            for a, b in zip(ours.masks, theirs.masks):
                np.testing.assert_array_equal(a, b)
        if expand_dims:  # the transforms take the C(Z)HW layout
            for i in range(3):
                for u, v in zip(ours[i], theirs[i]):
                    if isinstance(v, str):
                        assert u == v
                    else:
                        np.testing.assert_array_equal(u, v)


# palette and 1-bit PNGs read since (tests/test_torch_port_png_extra.py),
# GIF and TIFF since (tests/test_torch_port_image_formats.py) and JPEG since
# (tests/test_torch_port_jpeg.py): all three read into imageio's arrays
@pytest.mark.parametrize("what", ["jpeg", "gif", "tiff"])
def test_other_images_raise_naming_what_they_are(tmp_path, what):
    os.makedirs(tmp_path / "images")
    img = Image.fromarray(np.random.default_rng(0).integers(
        0, 256, SIZE, dtype=np.uint8))
    ext = {"jpeg": "jpg", "gif": "gif", "tiff": "tif"}[what]
    img.save(tmp_path / "images" / f"a.{ext}")
    ours = dsb.DSB2018Dataset(str(tmp_path), "test", TRANSFORMER)
    theirs = jax_dsb.DSB2018Dataset(str(tmp_path), "test", TRANSFORMER)
    (a,), (b,) = ours.images, theirs.images
    assert a.dtype == b.dtype and a.shape == b.shape == (1, *SIZE)
    np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def nets():
    out = {}
    for channels in (1, 4):
        cfg = {"name": "UNet2D", "in_channels": channels, "out_channels": 1,
               "f_maps": 8, "num_levels": 2, "num_groups": 4,
               "layer_order": "gcr", "final_sigmoid": True}
        jm = jax_get_model(cfg)
        variables = jm.init(jax.random.PRNGKey(channels),
                            jnp.zeros((1,) + SIZE + (channels,)), False)
        model = get_model(cfg)
        model.load_state_dict(flax_to_state_dict(
            jax.tree_util.tree_map(np.asarray, variables)))
        out[channels] = (cfg, jm, variables, model)
    return out


@pytest.mark.parametrize("kind", ["grey8", "rgba"])
def test_predictor_files_match_jax(tmp_path, nets, kind):
    root = _dsb_dir(tmp_path / "dsb", kind, n=3, seed=5)
    model_cfg, jm, variables, model = nets[4 if kind == "rgba" else 1]
    written = {}
    for who in ("jax", "port"):
        out_dir = str(tmp_path / who)
        os.makedirs(out_dir)
        cfg = {"model": model_cfg, "predictor": {"name": "DSB2018Predictor"},
               "loaders": {"dataset": "DSB2018Dataset", "batch_size": 2,
                           "test": {"file_paths": [root],
                                    "transformer": TRANSFORMER}}}
        if who == "jax":
            pred = jax_predictor.get_predictor(jm, variables, out_dir, cfg)
            for loader in jax_loaders.get_test_loaders(cfg):
                pred(loader)
        else:
            pred = predictor.get_predictor(model, out_dir, cfg)
            (loader,) = loaders.get_test_loaders(cfg)
            written[who] = pred(loader)
        assert sorted(os.listdir(out_dir)) == [
            f"im{i}_predictions.h5" for i in range(3)]
    assert sorted(written["port"]) == sorted(
        str(tmp_path / "port" / f"im{i}_predictions.h5") for i in range(3))
    for i in range(3):
        name = f"im{i}_predictions.h5"
        with h5py.File(tmp_path / "jax" / name, "r") as f, h5py.File(
                tmp_path / "port" / name, "r") as g:
            assert sorted(g.keys()) == sorted(f.keys()) == [
                "predictions", "segmentation"]
            assert g["predictions"].shape == SIZE
            np.testing.assert_allclose(g["predictions"][()],
                                       f["predictions"][()], rtol=TOL,
                                       atol=TOL)
            seg = g["segmentation"][()]
            assert seg.dtype == np.uint16 and seg.max() > 1
            np.testing.assert_array_equal(seg, f["segmentation"][()])


def test_save_batch_surfaces_worker_errors(tmp_path, nets):
    """A write that fails in the pool (the output directory is missing)
    raises from the predictor's call."""
    root = _dsb_dir(tmp_path / "dsb", "grey8", n=2)
    model_cfg, _, _, model = nets[1]
    cfg = {"model": model_cfg, "predictor": {"name": "DSB2018Predictor"},
           "loaders": {"dataset": "DSB2018Dataset", "batch_size": 2,
                       "test": {"file_paths": [root],
                                "transformer": TRANSFORMER}}}
    pred = predictor.get_predictor(model, str(tmp_path / "missing"), cfg)
    (loader,) = loaders.get_test_loaders(cfg)
    with pytest.raises(FileNotFoundError):
        pred(loader)

"""The port's HDF5 volume data path against the JAX package's, on files
h5py writes: ``FilterSliceBuilder`` (the same kept windows and rescue
draws, weight slices filtered with the others), ``traverse_h5_paths``, the
HDF5 datasets in every phase (a weight map, a channel axis, global
normalization, halo padding), and ``get_train_loaders`` /
``get_test_loaders`` over ``configs/unet3d_train.yml``'s and
``configs/unet3d_predict.yml``'s pipelines — the same batches, bit for bit,
with both ``GLOBAL_RANDOM_STATE``s reset to ``RandomState(47)``.  Also the
port's own contracts: ``device_cache: true`` on the yml's pipeline falls
back to the host loader, ``LazyHDF5Dataset`` and ``DSB2018Dataset``
through the loaders, the train/val leakage guard,
unreadable files skipped.  The in-memory batches ``chip_smoke.py`` holds
the prediction file against equal the test loader's."""

import os

import h5py
import numpy as np
import pytest
import yaml

from mdeical_image_segmentation_tpu.data import hdf5 as jax_hdf5
from mdeical_image_segmentation_tpu.data import loaders as jax_loaders
from mdeical_image_segmentation_tpu.data import slice_builder as jax_sb
from mdeical_image_segmentation_tpu.data import volume_utils as jax_vu
from mdeical_image_segmentation_tpu.transforms import volume as jax_volume
from mdeical_image_segmentation_tpu_torch.data import hdf5 as port_hdf5
from mdeical_image_segmentation_tpu_torch.data import loaders, slice_builder
from mdeical_image_segmentation_tpu_torch.data import volume_utils
from mdeical_image_segmentation_tpu_torch.transforms import volume

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reset_global_states():
    volume.GLOBAL_RANDOM_STATE = np.random.RandomState(47)
    jax_volume.GLOBAL_RANDOM_STATE = np.random.RandomState(47)


def _yml(name):
    with open(os.path.join(REPO, "configs", name)) as f:
        return yaml.safe_load(f)


def _volume(shape, seed, channels=None):
    rng = np.random.default_rng(seed)
    raw = rng.standard_normal(((channels,) if channels else ()) + shape
                              ).astype(np.float32)
    base = raw if channels is None else raw[0]
    smooth = sum(np.roll(base, s, axis=a) for a in range(3)
                 for s in (-1, 0, 1))
    label = (smooth > np.percentile(smooth, 30)).astype(np.uint8)
    label[..., :shape[-1] // 3] = 0  # a background third: filtered away
    label[rng.random(shape) < 0.05] = 2  # an ignore class
    return raw, label


def _write(path, raw, label=None, weight=None, **kw):
    with h5py.File(path, "w") as f:
        f.create_dataset("raw", data=raw, **kw)
        if label is not None:
            f.create_dataset("label", data=label, **kw)
        if weight is not None:
            f.create_dataset("weight", data=weight, **kw)
    return path


@pytest.mark.parametrize("threshold,slack,ignore", [
    (0.6, 0.01, None), (0.9, 0.5, None), (0.75, 0.3, 2), (0.0, 0.0, 1),
])
def test_filter_slice_builder_matches_jax(threshold, slack, ignore):
    raw, label = _volume((10, 40, 44), seed=1)
    weight = raw.copy()
    kw = dict(patch_shape=(4, 16, 16), stride_shape=(3, 8, 8),
              threshold=threshold, slack_acceptance=slack,
              ignore_index=ignore, skip_shape_check=True)
    ours = slice_builder.FilterSliceBuilder(raw, label, weight, **kw)
    theirs = jax_sb.FilterSliceBuilder(raw, label, weight, **kw)
    assert ours.raw_slices == theirs.raw_slices
    assert ours.label_slices == theirs.label_slices
    assert ours.weight_slices == theirs.weight_slices
    assert 0 < len(ours.raw_slices) < len(slice_builder.SliceBuilder(
        raw, label, None, **{k: kw[k] for k in ("patch_shape", "stride_shape",
                                                "skip_shape_check")}
    ).raw_slices) or threshold == 0.0
    via_config = slice_builder.get_slice_builder(
        raw, label, None, {"name": "FilterSliceBuilder", **kw})
    assert via_config.raw_slices == ours.raw_slices
    no_label = slice_builder.FilterSliceBuilder(raw, None, None, **kw)
    assert no_label.raw_slices == jax_sb.FilterSliceBuilder(
        raw, None, None, **kw).raw_slices


def test_traverse_h5_paths_matches_jax(tmp_path):
    for name in ("a.h5", "b.hdf5", "c.hdf", "d.hd5", "e.txt"):
        (tmp_path / name).write_bytes(b"")
    paths = [str(tmp_path), str(tmp_path / "e.txt"), "/not/there.h5"]
    assert (volume_utils.traverse_h5_paths(paths)
            == jax_vu.traverse_h5_paths(paths))
    with pytest.raises(TypeError, match="list"):
        volume_utils.traverse_h5_paths(str(tmp_path))


def _assert_batches_equal(ours, theirs):
    ours, theirs = list(ours), list(theirs)
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            if isinstance(v, np.ndarray):
                assert u.dtype == v.dtype and u.shape == v.shape
                np.testing.assert_array_equal(u, v)
            else:  # slice tuples, or lists of them
                assert list(u) == list(v)


DATASET_CASES = {
    "train-weight": dict(phase="train", weight=True, norm=False, ch=None),
    "val-global-norm": dict(phase="val", weight=False, norm=True, ch=None),
    "train-channels": dict(phase="train", weight=False, norm=False, ch=2),
    "test-halo": dict(phase="test", weight=False, norm=True, ch=None),
    "test-channels": dict(phase="test", weight=False, norm=False, ch=2),
}


@pytest.mark.parametrize("case", DATASET_CASES)
def test_hdf5_dataset_matches_jax(tmp_path, case):
    c = DATASET_CASES[case]
    raw, label = _volume((9, 40, 36), seed=3, channels=c["ch"])
    weight = np.abs(raw if c["ch"] is None else raw[0]) if c["weight"] else None
    path = _write(str(tmp_path / "v.h5"), raw, label, weight,
                  compression="gzip", chunks=True)
    sb = {"name": "FilterSliceBuilder" if c["phase"] == "train"
          else "SliceBuilder", "patch_shape": [4, 16, 16],
          "stride_shape": [4, 16, 16] if c["phase"] == "test" else [3, 8, 8],
          "threshold": 0.5, "skip_shape_check": True}
    if c["phase"] == "test":
        sb["halo_shape"] = [1, 4, 4]
        tcfg = {"raw": [{"name": "Standardize"},
                        {"name": "ToTensor", "expand_dims": True}]}
    else:
        tcfg = {"raw": [{"name": "Standardize"}, {"name": "RandomFlip"},
                        {"name": "RandomRotate90"},
                        {"name": "ToTensor", "expand_dims": True}],
                "label": [{"name": "RandomFlip"}, {"name": "RandomRotate90"},
                          {"name": "ToTensor", "expand_dims": True}],
                "weight": [{"name": "RandomFlip"},
                           {"name": "RandomRotate90"},
                           {"name": "ToTensor", "expand_dims": True}]}
    kw = dict(weight_internal_path="weight" if c["weight"] else None,
              global_normalization=c["norm"])
    _reset_global_states()
    ours = port_hdf5.StandardHDF5Dataset(path, c["phase"], dict(sb), tcfg,
                                         **kw)
    theirs = jax_hdf5.StandardHDF5Dataset(path, c["phase"], dict(sb), tcfg,
                                          **kw)
    assert len(ours) == len(theirs) > 0
    assert ours.volume_shape() == theirs.volume_shape()
    assert ours.raw_slices == theirs.raw_slices
    _assert_batches_equal([ours[i] for i in range(len(ours))],
                          [theirs[i] for i in range(len(theirs))])
    with pytest.raises(StopIteration):
        ours[len(ours)]


def _train_config(tmp_path, n_train=2):
    """configs/unet3d_train.yml's loaders (its whole transformer pipeline)
    over small h5py-written volumes, patch 8x32x32."""
    cfg = _yml("unet3d_train.yml")
    files = []
    for i in range(n_train):
        raw, label = _volume((10, 50, 48), seed=10 + i)
        files.append(_write(str(tmp_path / f"train{i}.h5"), raw, label,
                            compression="gzip", chunks=True))
    vdir = tmp_path / "val"
    vdir.mkdir()
    raw, label = _volume((8, 32, 64), seed=20)
    _write(str(vdir / "val.h5"), raw, label)
    lc = cfg["loaders"]
    lc["train"]["file_paths"] = files
    lc["val"]["file_paths"] = [str(vdir)]
    for phase, patch, stride in (("train", [8, 32, 32], [2, 9, 8]),
                                 ("val", [8, 32, 32], [8, 32, 32])):
        lc[phase]["slice_builder"].update(patch_shape=patch,
                                          stride_shape=stride,
                                          skip_shape_check=True)
    return cfg


def test_train_loaders_match_jax(tmp_path):
    """Two epochs of the shuffled train loader (worker threads, prefetch,
    drop_last) and the val loader: the same batches as the JAX loaders."""
    cfg = _train_config(tmp_path)
    _reset_global_states()
    ours = loaders.get_train_loaders(cfg)
    theirs = jax_loaders.get_train_loaders(cfg)
    assert ours["train"].num_workers == 4 and ours["train"].prefetch == 2
    assert ours["train"].drop_last and not ours["val"].drop_last
    assert len(ours["train"]) == len(theirs["train"]) >= 2
    for _ in range(2):
        _assert_batches_equal(ours["train"], theirs["train"])
    _assert_batches_equal(ours["val"], theirs["val"])
    cfg["loaders"]["batch_size"] = 2
    cfg["loaders"]["num_workers"] = 0
    _reset_global_states()
    ours = loaders.get_train_loaders(cfg, n_devices=2)
    theirs = jax_loaders.get_train_loaders(cfg, n_devices=2)
    assert ours["train"].batch_size == 4 and ours["train"].prefetch == 0
    _assert_batches_equal(ours["train"], theirs["train"])


def _test_config(tmp_path, shape=(9, 40, 70)):
    cfg = _yml("unet3d_predict.yml")
    raw, _ = _volume(shape, seed=30)
    path = _write(str(tmp_path / "test.h5"), raw, compression="gzip",
                  chunks=(3, 11, 13))
    lc = cfg["loaders"]
    lc["test"]["file_paths"] = [path, str(tmp_path / "missing.h5")]
    lc["test"]["slice_builder"].update(
        patch_shape=[4, 16, 32], stride_shape=[4, 16, 32],
        halo_shape=[1, 4, 8], skip_shape_check=True)
    return cfg, raw


def test_test_loaders_match_jax_and_the_in_memory_batches(tmp_path):
    """One loader per readable file (the missing one is skipped), batches
    of halo-padded standardized windows with their indices; they equal
    chip_smoke.standardized_patch_batches on the same volume."""
    import chip_smoke

    cfg, raw = _test_config(tmp_path)
    ours = list(loaders.get_test_loaders(cfg))
    theirs = list(jax_loaders.get_test_loaders(cfg))
    assert len(ours) == len(theirs) == 1
    assert ours[0].batch_size == 4
    _assert_batches_equal(ours[0], theirs[0])
    sb = cfg["loaders"]["test"]["slice_builder"]
    _assert_batches_equal(
        ours[0], chip_smoke.standardized_patch_batches(raw, sb, 4))


def test_unported_options_and_names_raise(tmp_path):
    """``device_cache`` on the yml's pipeline falls back to the host loader;
    ``LazyHDF5Dataset``'s train, val and test loaders give the JAX
    package's batches (the port's test loader writes the padded memo, the
    JAX one reads it); ``DSB2018Dataset`` builds from a directory of PNGs;
    an unknown name and a missing section raise."""
    from mdeical_image_segmentation_tpu_torch.data.dsb import DSB2018Dataset
    from mdeical_image_segmentation_tpu_torch.utils import png

    cfg = _train_config(tmp_path, n_train=1)
    # device_cache is ported (test_torch_port_device_cache.py): the yml's
    # pipeline (RandomRotate, ElasticDeformation) has no device form, so
    # it falls back to the host loader, as in the JAX package
    cfg["loaders"]["device_cache"] = True
    assert isinstance(loaders.get_train_loaders(cfg, device="cpu")["train"],
                      loaders.VolumeLoader)
    cfg["loaders"]["device_cache"] = False
    cfg["loaders"]["dataset"] = "LazyHDF5Dataset"
    _reset_global_states()
    ours = loaders.get_train_loaders(cfg)
    theirs = jax_loaders.get_train_loaders(cfg)
    assert isinstance(ours["train"].dataset.datasets[0],
                      port_hdf5.LazyHDF5Dataset)
    _assert_batches_equal(ours["train"], theirs["train"])
    _assert_batches_equal(ours["val"], theirs["val"])
    test_cfg, _ = _test_config(tmp_path)
    test_cfg["loaders"]["dataset"] = "LazyHDF5Dataset"
    (ours,) = loaders.get_test_loaders(test_cfg)
    (theirs,) = jax_loaders.get_test_loaders(test_cfg)
    _assert_batches_equal(ours, theirs)
    with h5py.File(str(tmp_path / "test.h5"), "r") as f:
        assert sorted(f.keys()) == ["raw", "raw_padded_1x4x8"]

    root = tmp_path / "dsb"
    for sub in ("images", "masks"):
        (root / sub).mkdir(parents=True)
    rng = np.random.default_rng(4)
    for i in range(3):
        png.write(str(root / "images" / f"i{i}.png"),
                  rng.integers(0, 256, (32, 48), dtype=np.uint8))
        png.write(str(root / "masks" / f"i{i}.png"),
                  (rng.random((32, 48)) > 0.5).astype(np.uint8))
    dsb = {"loaders": {"dataset": "DSB2018Dataset", "batch_size": 2,
                       "test": {"file_paths": [str(root)], "transformer": {
                           "raw": [{"name": "Standardize"},
                                   {"name": "ToTensor",
                                    "expand_dims": True}]}}}}
    (ours,) = loaders.get_test_loaders(dsb)
    (theirs,) = jax_loaders.get_test_loaders(dsb)
    assert isinstance(ours.dataset, DSB2018Dataset) and len(ours) == 2
    _assert_batches_equal(ours, theirs)
    with pytest.raises(KeyError, match="unknown dataset"):
        loaders.get_train_loaders({"loaders": {**cfg["loaders"],
                                               "dataset": "Nope"}})
    with pytest.raises(KeyError, match="loaders"):
        loaders.get_train_loaders({})


def test_leakage_guard_and_unreadable_files(tmp_path):
    cfg = _train_config(tmp_path, n_train=1)
    lc = cfg["loaders"]
    lc["val"]["file_paths"] = [str(tmp_path)]  # holds the train file
    with pytest.raises(ValueError, match="leak"):
        loaders.get_train_loaders(cfg)
    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / "corrupt.h5").write_bytes(b"\x89HDF\r\n\x1a\n" + b"\0" * 40)
    lc["val"]["file_paths"] = [str(bad), str(tmp_path / "val")]
    del lc["dataset"]  # the default, StandardHDF5Dataset
    _reset_global_states()
    ours = loaders.get_train_loaders(cfg)
    assert len(ours["val"].dataset.datasets) == 1  # the corrupt one skipped

"""The port's device-resident train loader (``data/device_cache.py``,
``loaders: {device_cache: true}``), case by case as the JAX package's
``tests/test_device_cache.py`` holds its own, on the CPU: patches equal the
host path's under per-patch Standardize, the global Standardize is baked
once, raw and label take the same flips and turns, the pointwise
augmentations fire, a small dataset is wrap-padded, unsupported pipelines
raise and fall back with a warning, the 3D trainer runs end to end on it;
and its coordinate stream equals the JAX loader's exactly.

Tolerances: per-patch standardization within 1e-5 (float32 sums in other
orders); everything else exact."""

import logging
import os

import h5py
import numpy as np
import pytest
import torch

from mdeical_image_segmentation_tpu.data import device_cache as jax_dc
from mdeical_image_segmentation_tpu.data import hdf5 as jax_hdf5
from mdeical_image_segmentation_tpu.parallel import mesh as jax_mesh
from mdeical_image_segmentation_tpu_torch.data import loaders
from mdeical_image_segmentation_tpu_torch.data.device_cache import (
    DeviceCachedVolumeLoader,
    DeviceCacheUnsupported,
)
from mdeical_image_segmentation_tpu_torch.data.hdf5 import (
    StandardHDF5Dataset,
)

PATCH = [8, 32, 32]
_TT = {"name": "ToTensor", "expand_dims": True}


@pytest.fixture(scope="module")
def volume(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("dc") / "train.h5")
    rs = np.random.RandomState(3)
    raw = rs.rand(16, 64, 64).astype(np.float32)
    with h5py.File(p, "w") as f:
        f.create_dataset("raw", data=raw)
        f.create_dataset("label", data=(raw > 0.6).astype(np.uint8))
    return p, raw


def _sb(patch=PATCH):
    return {"name": "SliceBuilder", "patch_shape": patch,
            "stride_shape": patch, "skip_shape_check": True}


def _dataset(path, raw_tf, label_tf, global_normalization=False,
             cls=StandardHDF5Dataset, patch=PATCH):
    return cls(file_path=path, phase="train", slice_builder_config=_sb(patch),
               transformer_config={"raw": raw_tf, "label": label_tf},
               global_normalization=global_normalization)


def _loader(ds, batch=8, **kw):
    return DeviceCachedVolumeLoader([ds], batch_size=batch, device="cpu",
                                    seed=0, **kw)


def _host_patch(vol, coord):
    _, z, y, x = coord
    return vol[z:z + PATCH[0], y:y + PATCH[1], x:x + PATCH[2]]


def test_patches_match_host_per_patch_standardize(volume):
    path, raw = volume
    ds = _dataset(path, [{"name": "Standardize"}, _TT], [_TT])
    loader = _loader(ds)
    assert loader._n == 8 and len(loader) == 1
    batches = list(loader)
    assert len(batches) == 1
    r, lab, w = batches[0]
    assert w is None and r.dtype == torch.float32
    assert lab.dtype == torch.float32 and r.shape == (8, 8, 32, 32, 1)
    order = np.random.RandomState(0).permutation(8)
    for b, i in enumerate(order):
        patch = _host_patch(raw, loader._coords[i])
        expect = (patch - patch.mean()) / max(patch.std(), 1e-10)
        np.testing.assert_allclose(r[b, ..., 0].numpy(), expect, rtol=1e-5,
                                   atol=1e-5)
        # the host dataset's own patch, label included
        host_raw, host_label = ds[int(i)]
        np.testing.assert_allclose(r[b].numpy(), host_raw, rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(lab[b].numpy(), host_label)


def test_global_standardize_baked_once(volume):
    path, raw = volume
    ds = _dataset(path, [{"name": "Standardize"}, _TT], [_TT],
                  global_normalization=True)
    loader = _loader(ds)
    vol_std = (raw - raw.mean()) / max(raw.std(), 1e-10)
    np.testing.assert_allclose(loader._raws[0, ..., 0].numpy(), vol_std,
                               rtol=1e-6, atol=1e-6)
    got = next(iter(loader))[0]
    order = np.random.RandomState(0).permutation(8)
    for b, i in enumerate(order):
        np.testing.assert_array_equal(
            got[b, ..., 0].numpy(),
            loader._raws[0, ..., 0].numpy()[
                tuple(slice(c, c + p) for c, p in zip(
                    loader._coords[i][1:], PATCH))])


def _orientations(patch):
    """The 8 flips x 4 quarter-turns in (H, W) of a (D, H, W) patch."""
    out = []
    for mask in range(8):
        m = patch
        for axis in range(3):
            if mask >> axis & 1:
                m = np.flip(m, axis)
        out += [np.rot90(m, k, (1, 2)) for k in range(4)]
    return out


def test_geometry_lock_raw_label(volume, tmp_path):
    """Raw and label take the same draws: with the label equal to the raw
    volume, every output pair is equal and is one of the 32 orientations
    of its host patch; over an epoch more than one orientation occurs."""
    _, raw = volume
    p = str(tmp_path / "mirror.h5")
    with h5py.File(p, "w") as f:
        f.create_dataset("raw", data=raw)
        f.create_dataset("label", data=raw)
    geo = [{"name": "RandomFlip", "axis_prob": 0.5},
           {"name": "RandomRotate90"}]
    loader = _loader(_dataset(p, geo + [_TT], geo + [_TT]))
    seen = set()
    for epoch in range(2):  # one batch of 8 an epoch
        order = np.random.RandomState(epoch).permutation(8)
        r, lab, _ = next(iter(loader))
        assert torch.equal(r, lab)
        for b, i in enumerate(order):
            options = _orientations(_host_patch(raw, loader._coords[i]))
            hits = [k for k, o in enumerate(options)
                    if np.array_equal(r[b, ..., 0].numpy(), o)]
            assert hits, f"epoch {epoch} patch {b}"
            seen.add(hits[0])
    assert len(seen) > 1, "the augmentations never fired"


@pytest.mark.parametrize("entry,check", [
    ({"name": "RandomContrast", "alpha": [0.5, 0.5], "mean": 0.25},
     lambda got, base: np.allclose(
         got, np.clip(0.25 + 0.5 * (base - 0.25), -1, 1), atol=1e-6)),
    ({"name": "AdditiveGaussianNoise", "scale": [0.3, 0.3]},
     lambda got, base: abs(np.std(got - base) - 0.3) < 0.01
     and abs(np.mean(got - base)) < 0.01),
    ({"name": "AdditivePoissonNoise", "lam": [2.0, 2.0]},
     lambda got, base: np.allclose(got - base, np.round(got - base),
                                   atol=1e-5)
     and abs(np.mean(got - base) - 2.0) < 0.05),
], ids=["contrast", "gaussian", "poisson"])
def test_pointwise_raw_augmentations_fire(volume, entry, check):
    """At execution_probability 1 with a fixed range, each pointwise
    augmentation changes every patch as its host transform does."""
    path, raw = volume
    ds = _dataset(path, [{**entry, "execution_probability": 1.0}, _TT], [_TT])
    loader = _loader(ds)
    r, lab, _ = next(iter(loader))
    assert torch.isfinite(r).all() and lab.shape == r.shape
    order = np.random.RandomState(0).permutation(8)
    for b, i in enumerate(order):
        base = _host_patch(raw, loader._coords[i])
        assert check(r[b, ..., 0].numpy().astype(np.float64), base), b


def test_wrap_pad_small_dataset(volume):
    path, _ = volume
    loader = _loader(_dataset(path, [{"name": "Standardize"}, _TT], [_TT]),
                     batch=16)  # 8 patches < batch 16
    batches = list(loader)
    assert len(batches) == 1 and len(loader) == 1
    assert batches[0][0].shape[0] == 16
    order = np.random.RandomState(0).permutation(8)
    np.testing.assert_array_equal(loader.epoch_batches(0)[0],
                                  loader._coords[np.tile(order, 2)])


def test_unsupported_pipelines_raise(volume, tmp_path):
    path, raw = volume
    with pytest.raises(DeviceCacheUnsupported, match="ElasticDeformation"):
        _loader(_dataset(
            path, [{"name": "ElasticDeformation", "spline_order": 3}, _TT],
            [{"name": "ElasticDeformation", "spline_order": 0}, _TT]))
    with pytest.raises(DeviceCacheUnsupported, match="differ"):
        _loader(_dataset(path, [{"name": "RandomFlip"}, _TT], [_TT]))
    rect = str(tmp_path / "rect.h5")
    with h5py.File(rect, "w") as f:
        f.create_dataset("raw", data=raw)
        f.create_dataset("label", data=(raw > 0.6).astype(np.uint8))
    rot = [{"name": "RandomRotate90"}, _TT]
    with pytest.raises(DeviceCacheUnsupported, match="square"):
        _loader(_dataset(rect, rot, rot, patch=[8, 16, 32]))
    with pytest.raises(DeviceCacheUnsupported, match="budget"):
        _loader(_dataset(path, [_TT], [_TT]), budget_gb=1e-4)


def _trainer_config(train_path, val_path, ckpt, device_cache=True):
    def phase(fp):
        return {"transformer": {"raw": [{"name": "Standardize"},
                                        {"name": "RandomFlip"}, _TT],
                                "label": [{"name": "RandomFlip"}, _TT]},
                "slice_builder": _sb(), "file_paths": [fp]}

    return {
        "device": "cpu",
        "model": {"name": "UNet3D", "in_channels": 1, "out_channels": 1,
                  "f_maps": 8, "num_levels": 2, "final_sigmoid": True},
        "loss": {"name": "BCEDiceLoss"},
        "eval_metric": {"name": "MeanIoU"},
        "optimizer": {"name": "Adam", "learning_rate": 2e-3},
        "trainer": {"checkpoint_dir": ckpt, "max_num_epochs": 4,
                    "max_num_iterations": 50, "validate_after_iters": 3,
                    "log_after_iters": 2},
        "loaders": {"dataset": "StandardHDF5Dataset", "batch_size": 4,
                    "num_workers": 0, "device_cache": device_cache,
                    "train": phase(train_path), "val": phase(val_path)},
    }


def _val_file(tmp_path, raw):
    val = str(tmp_path / "val.h5")
    with h5py.File(val, "w") as f:
        f.create_dataset("raw", data=raw[:8])
        f.create_dataset("label", data=(raw[:8] > 0.6).astype(np.uint8))
    return val


def test_trainer3d_device_cache_e2e(volume, tmp_path):
    from mdeical_image_segmentation_tpu_torch.train.trainer3d import (
        create_trainer,
    )

    path, raw = volume
    trainer = create_trainer(_trainer_config(path, _val_file(tmp_path, raw),
                                             str(tmp_path / "ckpt")))
    assert isinstance(trainer.loaders["train"], DeviceCachedVolumeLoader)
    steps = []
    orig = trainer._train_step

    def step(input, target, weight):
        steps.append((input.device.type, tuple(input.shape)))
        return orig(input, target, weight)

    trainer._train_step = step
    trainer.fit()
    # 8 patches / batch 4 = two steps an epoch, 4 epochs
    assert len(steps) == 8 and trainer.num_iterations >= 8
    assert set(steps) == {("cpu", (4, 8, 32, 32, 1))}
    assert os.path.exists(str(tmp_path / "ckpt" / "last_checkpoint.msgpack"))


class _Captured(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def test_get_train_loaders_fallback_warns(volume, tmp_path):
    path, raw = volume
    cfg = _trainer_config(path, _val_file(tmp_path, raw),
                          str(tmp_path / "ck"))
    cfg["loaders"]["train"]["transformer"]["raw"].insert(
        1, {"name": "ElasticDeformation", "spline_order": 3})
    handler = _Captured()
    loaders.logger.addHandler(handler)
    try:
        got = loaders.get_train_loaders(cfg, device="cpu")
        bare = loaders.get_train_loaders(cfg)
    finally:
        loaders.logger.removeHandler(handler)
    for result in (got, bare):
        assert isinstance(result["train"], loaders.VolumeLoader)
        assert not getattr(result["train"], "is_device_cached", False)
    assert any("falling back to the host loader" in m and
               "ElasticDeformation" in m for m in handler.messages)
    assert any("no device was given" in m for m in handler.messages)


def test_coordinate_stream_equals_the_jax_loader(volume, tmp_path):
    """Two volumes, two epochs, batch 3: the (volume, z, y, x) batches the
    port samples equal those the JAX loader hands its sampler."""
    path, raw = volume
    second = str(tmp_path / "second.h5")
    with h5py.File(second, "w") as f:
        f.create_dataset("raw", data=raw[:, :48, :40])
        f.create_dataset("label", data=(raw[:, :48, :40] > 0.6).astype(
            np.uint8))
    tf = [{"name": "Standardize"}, {"name": "RandomFlip"}, _TT]
    ltf = [{"name": "RandomFlip"}, _TT]
    ours = DeviceCachedVolumeLoader(
        [_dataset(p, tf, ltf, patch=[8, 16, 16]) for p in (path, second)],
        batch_size=3, device="cpu", seed=5)
    theirs = jax_dc.DeviceCachedVolumeLoader(
        [_dataset(p, tf, ltf, cls=jax_hdf5.StandardHDF5Dataset,
                  patch=[8, 16, 16]) for p in (path, second)],
        batch_size=3, mesh=jax_mesh.make_mesh(), seed=5)
    np.testing.assert_array_equal(ours._coords, theirs._coords)
    captured = []

    def record(raws, labels, coords, key):
        captured.append(np.asarray(coords))
        return raws[:0], labels[:0]

    theirs._sample = record
    for epoch in range(2):
        list(theirs)
        got = ours.epoch_batches(epoch)
        want, captured[:] = list(captured), []
        assert len(got) == len(want) == len(ours) > 1
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)

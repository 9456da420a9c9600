"""The port's volume transforms (``transforms/volume.py``, with
``transforms/skimage_compat.py``) against the JAX package's: each of the 25
registered transforms, and the ``Transformer`` pipelines of
``configs/unet3d_train.yml``, give the same bits (``np.array_equal``, same
dtype) for the same seed and input.  Both ``GLOBAL_RANDOM_STATE``s are
reset to ``RandomState(47)`` first, so both Transformers draw the same
shared raw/label seed; ElasticDeformation is forced to fire at a small
size, and fires by itself first at sample 10 of the yml's pipelines."""

import os
import random

import numpy as np
import pytest
import yaml

from mdeical_image_segmentation_tpu.transforms import skimage_compat as jax_sk
from mdeical_image_segmentation_tpu.transforms import volume as jax_volume
from mdeical_image_segmentation_tpu_torch.transforms import skimage_compat
from mdeical_image_segmentation_tpu_torch.transforms import volume

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (6, 14, 12)


def _raw(seed=0, shape=SHAPE):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _labels(seed=0, shape=SHAPE, n=4):
    return np.random.default_rng(seed).integers(0, n, shape).astype(
        np.int64)


def _blobs(shape=SHAPE):
    m = np.zeros(shape, np.int64)
    m[1:4, 2:7, 3:8] = 1
    m[2:6, 8:13, 1:5] = 2
    m[0, 0, 0] = 3
    return m


# (name, constructor kwargs, input, calls): one case per registered
# transform, more where an option changes the code path
CASES = [
    ("Compose", None, _raw(), 1),
    ("RandomFlip", {}, _raw(), 4),
    ("RandomFlip", {"axis_prob": 0.2}, np.stack([_raw(1), _raw(2)]), 3),
    ("RandomRotate90", {}, _raw(), 4),
    ("RandomRotate90", {}, np.stack([_raw(1), _raw(2)]), 3),
    ("RandomRotate", {"axes": [[2, 1]], "angle_spectrum": 30,
                      "mode": "reflect"}, _raw(), 3),
    ("RandomRotate", {"order": 3, "mode": "constant"},
     np.stack([_raw(3), _raw(4)]), 2),
    ("RandomRotate", {"axes": [[2, 1]], "mode": "reflect"},
     _labels().astype(np.float32), 2),
    ("RandomContrast", {"execution_probability": 1.0}, _raw(), 3),
    ("ElasticDeformation", {"spline_order": 3, "execution_probability": 1.0},
     _raw(), 2),
    ("ElasticDeformation", {"spline_order": 0, "execution_probability": 1.0},
     _labels().astype(np.float32), 2),
    ("ElasticDeformation", {"spline_order": 1, "execution_probability": 1.0,
                            "apply_3d": False, "alpha": 30, "sigma": 3},
     _raw(5), 1),
    ("ElasticDeformation", {"spline_order": 1, "execution_probability": 1.0},
     np.stack([_raw(6), _raw(7)]), 1),
    ("CropToFixed", {"size": (8, 10)}, _raw(), 3),
    ("CropToFixed", {"size": (20, 9), "centered": True},
     np.stack([_raw(1), _raw(2)]), 1),
    ("CropToFixed", {"size": (16, 16)}, _raw(), 1),
    ("StandardLabelToBoundary", {}, _blobs(), 1),
    ("StandardLabelToBoundary", {"mode": "inner", "foreground": True,
                                 "ignore_index": 3, "append_label": True},
     _blobs(), 1),
    ("StandardLabelToBoundary", {"mode": "outer"}, _blobs(), 1),
    ("BlobsToMask", {"boundary": True, "append_label": True}, _blobs(), 1),
    ("BlobsToMask", {"boundary": True, "cross_entropy": True}, _blobs(), 1),
    ("RandomLabelToAffinities", {"max_offset": 4}, _labels(), 4),
    ("LabelToAffinities", {"offsets": [1, 2], "z_offsets": [1, 1],
                           "aggregate_affinities": True}, _labels(), 1),
    ("LabelToAffinities", {"offsets": [1, 3], "ignore_index": 2,
                           "append_label": True}, _labels(), 1),
    ("LabelToZAffinities", {"offsets": [1, 2]}, _labels(), 1),
    ("LabelToBoundaryAndAffinities", {"xy_offsets": [1, 2],
                                      "z_offsets": [1, 1]}, _blobs(), 1),
    ("LabelToMaskAndAffinities", {"xy_offsets": [1], "z_offsets": [1]},
     _labels(), 1),
    ("Standardize", {}, _raw(), 1),
    ("Standardize", {"mean": 0.5, "std": 2.0}, _raw(), 1),
    ("Standardize", {"channelwise": True}, np.stack([_raw(1), _raw(2)]), 1),
    ("PercentileNormalizer", {}, _raw(), 1),
    ("PercentileNormalizer", {"channelwise": True, "pmin": 5, "pmax": 95},
     np.stack([_raw(1), _raw(2)]), 1),
    ("Normalize", {}, _raw(), 1),
    ("Normalize", {"min_value": -1.0, "max_value": 2.0, "norm01": True},
     _raw(), 1),
    ("Normalize", {"channelwise": True, "min_value": [-1.0, "None"],
                   "max_value": ["None", 1.5]},
     np.stack([_raw(1), _raw(2)]), 1),
    ("AdditiveGaussianNoise", {"execution_probability": 1.0}, _raw(), 2),
    ("AdditivePoissonNoise", {"execution_probability": 1.0}, _raw(), 2),
    ("ToTensor", {"expand_dims": True}, _raw(), 1),
    ("ToTensor", {"expand_dims": False, "dtype": np.int64}, _labels(), 1),
    ("ToTensor", {"expand_dims": False}, np.stack([_raw(1), _raw(2)]), 1),
    ("Relabel", {}, _blobs(), 1),
    ("Relabel", {"append_original": True, "ignore_label": 3}, _blobs(), 1),
    ("Relabel", {"run_cc": False}, _labels() * 3, 1),
    ("Identity", {}, _raw(), 1),
    ("RgbToLabel", None,
     np.random.default_rng(0).integers(0, 256, (5, 6, 3)).astype(np.uint8),
     1),
    ("LabelToTensor", None, np.stack([_labels(1), _labels(2)]), 1),
    ("GaussianBlur3D", {"execution_probability": 1.0}, _raw(), 2),
    ("GaussianBlur3D", {"execution_probability": 1.0},
     (_labels() * 40).astype(np.uint8), 1),
]


def test_every_registered_transform_has_a_case():
    assert sorted(volume.TRANSFORMS.names()) == sorted(
        jax_volume.TRANSFORMS.names())
    assert len(list(volume.TRANSFORMS.names())) == 25
    assert {c[0] for c in CASES} == set(volume.TRANSFORMS.names())


def _build(module, name, kwargs, seed):
    cls = module.TRANSFORMS.get(name)
    if name == "Compose":
        return cls([module.Standardize(), module.RandomFlip(
            np.random.RandomState(seed))])
    if kwargs is None:
        return cls()
    return cls(random_state=np.random.RandomState(seed), **kwargs)


def _assert_same(got, want):
    assert type(got) is type(want)
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,kwargs,m,calls", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_transform_gives_the_same_bits(name, kwargs, m, calls):
    ours = _build(volume, name, kwargs, seed=11)
    theirs = _build(jax_volume, name, kwargs, seed=11)
    for call in range(calls):
        random.seed(call)  # GaussianBlur3D draws from Python's random
        got = ours(np.copy(m))
        random.seed(call)
        want = theirs(np.copy(m))
        _assert_same(got, want)


def test_skimage_compat_matches_jax():
    lab = _blobs()
    for conn in (1, 2, 3):
        _assert_same(skimage_compat.label(lab > 0, connectivity=conn),
                     jax_sk.label(lab > 0, connectivity=conn))
        for mode in ("thick", "inner", "outer"):
            _assert_same(skimage_compat.find_boundaries(lab, conn, mode),
                         jax_sk.find_boundaries(lab, conn, mode))
    _assert_same(skimage_compat.label(lab, return_num=True)[1],
                 jax_sk.label(lab, return_num=True)[1])
    for img in (_raw(), (_labels() * 60).astype(np.uint8)):
        _assert_same(skimage_compat.gaussian(img, 1.5),
                     jax_sk.gaussian(img, 1.5))
    with pytest.raises(ValueError, match="mode"):
        skimage_compat.find_boundaries(lab, mode="sideways")


def _pipelines():
    with open(os.path.join(REPO, "configs", "unet3d_train.yml")) as f:
        cfg = yaml.safe_load(f)
    return cfg["loaders"]["train"]["transformer"], cfg["loaders"]["val"][
        "transformer"]


class _CountingState:
    """A RandomState that counts its ``randn`` draws (the displacement
    fields of a firing ElasticDeformation)."""

    def __init__(self, rs):
        self.rs, self.randn_calls = rs, 0

    def uniform(self, *args, **kwargs):
        return self.rs.uniform(*args, **kwargs)

    def randn(self, *args):
        self.randn_calls += 1
        return self.rs.randn(*args)


def test_train_yml_transformer_pipelines_give_the_same_bits():
    """11 samples through the yml's train pipelines (RandomFlip,
    RandomRotate90, RandomRotate, ElasticDeformation, ...) and its val
    pipelines, both packages' global states reset to RandomState(47): the
    shared seed, the raw/label geometry lock and the first elastic firing,
    at sample 10 (the draws after it depend on the volume's size), all
    agree."""
    volume.GLOBAL_RANDOM_STATE = np.random.RandomState(47)
    jax_volume.GLOBAL_RANDOM_STATE = np.random.RandomState(47)
    train_cfg, val_cfg = _pipelines()
    stats = {"pmin": None, "pmax": None, "mean": None, "std": None}
    ours = volume.Transformer(train_cfg, stats)
    theirs = jax_volume.Transformer(train_cfg, stats)
    assert ours.seed == theirs.seed
    pipes = [(ours.raw_transform(), theirs.raw_transform()),
             (ours.label_transform(), theirs.label_transform())]
    elastic = [t for t in pipes[0][0].transforms
               if isinstance(t, volume.ElasticDeformation)][0]
    elastic.random_state = _CountingState(elastic.random_state)
    fired = []
    for sample in range(11):
        raw = _raw(sample, (8, 20, 18))
        label = (raw > 0.2).astype(np.uint8)
        before = elastic.random_state.randn_calls
        for (p_ours, p_theirs), m in zip(pipes, (raw, label)):
            _assert_same(p_ours(np.copy(m)), p_theirs(np.copy(m)))
        if elastic.random_state.randn_calls > before:
            fired.append(sample)
    assert fired == [10]
    ours_val = volume.Transformer(val_cfg, stats)
    theirs_val = jax_volume.Transformer(val_cfg, stats)
    assert ours_val.seed == theirs_val.seed
    raw = _raw(99, (8, 20, 18))
    _assert_same(ours_val.raw_transform()(raw), theirs_val.raw_transform()(raw))
    _assert_same(ours_val.label_transform()(raw > 0),
                 theirs_val.label_transform()(raw > 0))

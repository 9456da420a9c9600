"""The port's bundle I/O against flax: ``utils/flax_msgpack`` reads what
``flax.serialization`` writes (leaf for leaf, bit for bit) and writes bytes
flax reads back; ``utils/param_bridge`` maps the flax tree to the port's
state_dict and back exactly."""

import os

import numpy as np
import pytest
import torch

import flax
import jax
import jax.numpy as jnp

from mdeical_image_segmentation_tpu.models import UNetConfig as JaxUNetConfig
from mdeical_image_segmentation_tpu.models import UNetModel as JaxUNetModel
from mdeical_image_segmentation_tpu_torch.models import UNetConfig, UNetModel
from mdeical_image_segmentation_tpu_torch.utils import flax_msgpack
from mdeical_image_segmentation_tpu_torch.utils.param_bridge import (
    flax_to_state_dict,
    state_dict_to_flax,
)

KW = dict(in_channels=3, out_channels=2, unet_type="UNet", base_features=4)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.fixture(scope="module")
def jax_bundle(tmp_path_factory):
    jm = JaxUNetModel(JaxUNetConfig(**KW))
    variables = jm.init(jax.random.PRNGKey(3), jnp.zeros((1, 32, 32, 3)))
    path = str(tmp_path_factory.mktemp("bundle") / "jax")
    jm.save_pretrained(path, variables)
    return path, jm, variables


def test_reader_matches_flax_leaf_for_leaf(jax_bundle):
    path, _, _ = jax_bundle
    with open(os.path.join(path, "params.msgpack"), "rb") as f:
        data = f.read()
    ours = dict(_leaves(flax_msgpack.from_bytes(data)))
    theirs = dict(_leaves(flax.serialization.msgpack_restore(data)))
    assert list(ours) == list(theirs) and len(ours) == 46
    for k, v in theirs.items():
        assert ours[k].dtype == v.dtype and ours[k].shape == v.shape, k
        assert ours[k].tobytes() == v.tobytes(), k


def test_writer_is_byte_identical_to_flax(jax_bundle):
    path, _, _ = jax_bundle
    with open(os.path.join(path, "params.msgpack"), "rb") as f:
        data = f.read()
    assert flax_msgpack.to_bytes(flax_msgpack.from_bytes(data)) == data


def test_port_bundle_loads_in_jax(jax_bundle, tmp_path):
    _, jm, _ = jax_bundle
    model = UNetModel(UNetConfig(**KW), device="cpu",
                      generator=torch.Generator().manual_seed(5))
    model.save_pretrained(str(tmp_path))
    jm2, variables = JaxUNetModel.from_pretrained(str(tmp_path))
    assert jm2.config.to_dict() == jm.config.to_dict()
    x = np.random.default_rng(0).random((1, 32, 32, 3), dtype=np.float32)
    want = np.asarray(jm2.apply(variables, jnp.asarray(x)).logits)
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).logits.numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_jax_torch_jax_round_trip_is_exact(jax_bundle):
    _, _, variables = jax_bundle
    back = state_dict_to_flax(flax_to_state_dict(variables))
    want = dict(_leaves(jax.tree_util.tree_map(np.asarray, variables)))
    got = dict(_leaves(back))
    assert sorted(got) == sorted(want)  # tree_map sorts keys
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))


def test_bridge_layouts():
    """conv HWIO -> OIHW; ConvTranspose (kh, kw, I, O) -> (I, O, kh, kw) with
    the spatial taps flipped (the inverse of utils/torch_import.py)."""
    k = np.arange(2 * 2 * 3 * 5, dtype=np.float32).reshape(2, 2, 3, 5)
    c = np.arange(3 * 3 * 3 * 5, dtype=np.float32).reshape(3, 3, 3, 5)
    sd = flax_to_state_dict({"params": {
        "UpSample_0": {"TorchConvTranspose_0": {"ConvTranspose_0": {
            "kernel": k, "bias": np.zeros(5, np.float32)}}},
        "TorchConv_0": {"Conv_0": {"kernel": c,
                                   "bias": np.ones(5, np.float32)}},
    }})
    wt = sd["UpSample_0.TorchConvTranspose_0.weight"].numpy()
    assert wt.shape == (3, 5, 2, 2)
    assert wt[1, 4, 0, 1] == k[1, 0, 1, 4]
    wc = sd["TorchConv_0.weight"].numpy()
    assert wc.shape == (5, 3, 3, 3) and wc[4, 2, 0, 1] == c[0, 1, 2, 4]


def test_msgpack_scalars_and_containers_match_flax():
    tree = {
        "ints": {"a": 0, "b": 127, "c": 128, "d": 70000, "e": 2 ** 40,
                 "f": -1, "g": -33, "h": -40000, "i": -2 ** 40},
        "floats": {"x": 1.5, "y": -0.0},
        "flags": {"t": True, "f": False, "n": None},
        "text": {"short": "ab", "long": "x" * 300},
        "np": {"f32": np.float32(2.5), "i64": np.int64(-7),
               "u8": np.arange(20, dtype=np.uint8).reshape(4, 5),
               "big": np.zeros(70000, np.float32), "empty": np.zeros((0, 3))},
        "many": {f"k{i}": i for i in range(20)},
    }
    data = flax.serialization.to_bytes(tree)
    assert flax_msgpack.to_bytes(tree) == data
    back = flax_msgpack.from_bytes(data)
    assert back["ints"] == tree["ints"] and back["text"] == tree["text"]
    assert back["flags"] == tree["flags"] and back["floats"] == tree["floats"]
    assert back["np"]["f32"] == np.float32(2.5)
    assert isinstance(back["np"]["i64"], np.int64)
    np.testing.assert_array_equal(back["np"]["u8"], tree["np"]["u8"])


def test_bfloat16_leaves_read_as_float32():
    v = jnp.asarray([1.0, -2.5, 3.140625, 1e-3], jnp.bfloat16)
    data = flax.serialization.msgpack_serialize({"w": v})
    got = flax_msgpack.from_bytes(data)["w"]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(v.astype(jnp.float32)))

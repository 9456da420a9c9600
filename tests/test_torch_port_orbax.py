"""The port's read-only ``OrbaxCheckpointer`` (``train/orbax_ckpt.py`` over
``utils/ocdbt.py``, ``utils/zarr2.py`` and ``utils/zstd.py``) against the
JAX package's ``OrbaxCheckpointer.restore()`` on orbax 0.11.32, leaf for
leaf and to the bit.

- Every committed checkpoint of ``tests/fixtures/orbax``, ``last`` and,
  where written, ``best``: the JAX trainer's own tensor-parallel and
  ZeRO-1 checkpoints (UNet3D f_maps 8, 2 levels, Adam), ``save`` trees of
  every dtype with 0-d and scalar leaves, empty dicts, None, tuples and
  sharded arrays, the layout without OCDBT, and a checkpoint two JAX
  processes wrote (one OCDBT database each, under one root).  The JAX
  side restores in this process (one module-scoped pass); the tree is the
  msgpack loader's: sequences as dicts keyed ``"0"``, ``"1"``, ...,
  scalars as numpy scalars, ``jax.Array`` as numpy.  The manifest, which
  holds the same restore made when the fixtures were written, agrees.
- ``restore(template=)`` gives the template's types and dtypes; a missing
  checkpoint raises ``IOError``; ``exists``; zarr v3 and unknown leaf
  types raise naming ROADMAP item 19b.
"""

import hashlib
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from mdeical_image_segmentation_tpu_torch.train import orbax_ckpt
from mdeical_image_segmentation_tpu_torch.train.orbax_ckpt import (
    OrbaxCheckpointer,
)
from torch_port_model_axis_cases import ORBAX, fixture_script

HERE = os.path.dirname(os.path.abspath(__file__))


def _manifest():
    with open(os.path.join(HERE, "fixtures", "manifest.json")) as f:
        return json.load(f)["orbax"]


CHECKPOINTS = sorted(_manifest()["checkpoints"])


@pytest.fixture(scope="module")
def jax_trees():
    """The JAX package's restore of every committed checkpoint."""
    script = fixture_script()
    out = {}
    for name in CHECKPOINTS:
        d, which = name.rsplit("/", 1)
        out[name] = script.jax_restore(jax, os.path.join(ORBAX, d),
                                       which == "best")
    return out


def _flat(tree, prefix=""):
    """Leaves by their ``.``-joined path, sequences by index."""
    items = (tree.items() if isinstance(tree, dict) else
             enumerate(tree) if isinstance(tree, (list, tuple)) else None)
    if items is None:
        return {prefix: tree}
    items = list(items)
    if not items:
        return {prefix: {}}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def _sha(a):
    a = np.ascontiguousarray(a)
    if a.dtype == bool:
        a = np.frombuffer(a.tobytes(), np.uint8) != 0
    return hashlib.sha256(a.tobytes()).hexdigest()


def _restore(name):
    d, which = name.rsplit("/", 1)
    return OrbaxCheckpointer(os.path.join(ORBAX, d)).restore(
        best=which == "best")


@pytest.mark.parametrize("name", CHECKPOINTS)
def test_restore_equals_jax_to_the_bit(jax_trees, name):
    got, want = _flat(_restore(name)), _flat(jax_trees[name])
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if w is None:
            assert g is None, k
        elif isinstance(w, dict):
            assert g == {} == w, k
        elif isinstance(w, (int, float)):
            # JAX gives Python numbers, the port numpy scalars of the
            # stored dtype
            assert isinstance(g, np.generic), k
            assert g == w and g.dtype.kind == np.asarray(w).dtype.kind, k
        else:
            # an array; a 0-d one where JAX restored a scalar leaf against
            # a template (the two-process checkpoint)
            assert isinstance(g, np.ndarray) or w.ndim == 0, k
            w, g = np.asarray(w), np.asarray(g)
            assert (g.shape, g.dtype) == (w.shape, w.dtype), k
            assert g.tobytes() == w.tobytes(), k


@pytest.mark.parametrize("name", CHECKPOINTS)
def test_restore_equals_the_manifest(name):
    got = _flat(_restore(name))
    entries = _manifest()["checkpoints"][name]
    assert sorted(got) == sorted(entries)
    for k, e in entries.items():
        g = got[k]
        if "none" in e:
            assert g is None, k
        elif "empty" in e:
            assert g == {}, k
        elif "number" in e:
            assert g == e["value"], k
        else:
            g = np.asarray(g)
            assert [list(g.shape), g.dtype.str, _sha(g)] == [
                e["shape"], e["dtype"], e["sha256"]], k


def test_trainer_tree_has_the_msgpack_loaders_shape():
    tree = _restore("tp/orbax/last")
    assert sorted(tree) == ["best_eval_score", "model_state_dict",
                            "num_epochs", "num_iterations",
                            "optimizer_state_dict"]
    assert tree["model_state_dict"]["batch_stats"] == {}
    opt = tree["optimizer_state_dict"]
    assert opt["inner_state"]["1"] is None
    assert {"count", "mu", "nu"} <= set(opt["inner_state"]["0"])
    assert isinstance(tree["num_iterations"], np.integer)
    assert isinstance(tree["best_eval_score"], np.floating)


def test_template_gives_its_types():
    template = {"f4": torch.zeros(3, 5, dtype=torch.float64),
                "i8": np.zeros(6, np.int32), "int_scalar": 0,
                "float_scalar": np.float32(0), "none": None,
                "tuple": (np.zeros(4, np.int64), {"x": torch.zeros(2)})}
    got = OrbaxCheckpointer(os.path.join(ORBAX, "trees")).restore(
        template=template)
    whole = _restore("trees/last")
    assert got["f4"].dtype == torch.float64
    assert torch.equal(got["f4"], torch.as_tensor(whole["f4"]).double())
    assert got["i8"].dtype == np.int32
    assert got["int_scalar"] == 7 and type(got["int_scalar"]) is int
    assert type(got["float_scalar"]) is np.float32
    assert got["none"] is None
    assert isinstance(got["tuple"], tuple)
    assert got["tuple"][0].dtype == np.int64
    assert torch.equal(got["tuple"][1]["x"], torch.ones(2))
    with pytest.raises(KeyError, match="absent"):
        OrbaxCheckpointer(os.path.join(ORBAX, "trees")).restore(
            template={"absent": 0})
    with pytest.raises(ValueError, match="shape"):
        OrbaxCheckpointer(os.path.join(ORBAX, "trees")).restore(
            template={"f4": np.zeros(3)})


def test_the_jax_contract(tmp_path):
    ck = OrbaxCheckpointer(os.path.join(ORBAX, "zero1", "orbax"))
    assert ck.exists() and not ck.exists(best=True)
    with pytest.raises(IOError, match="does not exist"):
        ck.restore(best=True)
    assert orbax_ckpt.is_checkpoint(os.path.join(ORBAX, "trees", "last"))
    assert not orbax_ckpt.is_checkpoint(str(tmp_path))


def _copy_trees(tmp_path, **meta):
    dst = tmp_path / "trees"
    shutil.copytree(os.path.join(ORBAX, "trees"), dst)
    path = dst / "last" / orbax_ckpt.METADATA
    data = json.loads(path.read_text())
    data.update(meta)
    path.write_text(json.dumps(data))
    return dst, data


def test_zarr3_and_unknown_leaf_types_raise(tmp_path):
    dst, _ = _copy_trees(tmp_path, use_zarr3=True)
    with pytest.raises(ValueError, match="19b"):
        OrbaxCheckpointer(str(dst)).restore()
    shutil.rmtree(dst)
    dst, data = _copy_trees(tmp_path)
    entry = next(iter(data["tree_metadata"].values()))
    entry["value_metadata"]["value_type"] = "string"
    (dst / "last" / orbax_ckpt.METADATA).write_text(json.dumps(data))
    with pytest.raises(ValueError, match="19b"):
        OrbaxCheckpointer(str(dst)).restore()

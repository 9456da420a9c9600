"""``train/dist_ckpt.py`` (the JAX package's ``train/orbax_ckpt.py`` on
``torch.distributed.checkpoint``; the card's machine has no orbax):

- the contract of ``OrbaxCheckpointer``: ``save`` writes ``last`` and,
  when best, ``best``; ``restore`` reads either back, as numpy without a
  template and into the template's tensors and arrays with one;
  ``exists``; a missing checkpoint raises ``IOError``, an orbax
  directory is refused with a pointer to ``train/orbax_ckpt.py``, which
  reads it;
- the commit is atomic: a save that fails part way leaves the previous
  ``last`` whole, and a stale temporary directory is swept;
- resume in a gloo world of 2: the 3D 'bcr' trainer saved by both ranks
  after step 2 and resumed from the directory takes a step 3 equal to
  the uninterrupted run's to the bit (loss, parameters, BatchNorm
  statistics and Adam moments), on both ranks, which both read the one
  committed directory.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_port_dp_worker as W
from mdeical_image_segmentation_tpu.models import get_model as jax_get_model
from mdeical_image_segmentation_tpu.train import checkpoint as jax_ckpt
from mdeical_image_segmentation_tpu.train import optimizers as jax_opt
from mdeical_image_segmentation_tpu_torch.train import dist_ckpt
from mdeical_image_segmentation_tpu_torch.train.dist_ckpt import (
    DistCheckpointer,
)


def _state(v: float):
    return {"num_epochs": 2, "num_iterations": 7, "best_eval_score": v,
            "model_state_dict": {
                "params": {"conv": {"kernel": np.full((2, 3), v,
                                                      np.float32)}},
                "batch_stats": {}},
            "optimizer_state_dict": {
                "count": np.int32(7), "hyperparams": {
                    "learning_rate": np.float32(1e-3)},
                "inner_state": {"0": {}, "1": {"mu": torch.full((4,), v)}},
                "torch_optimizer": "Adam"}}


def test_last_best_exists_and_restore(tmp_path):
    ckpt = DistCheckpointer(str(tmp_path / "run"))
    assert not ckpt.exists() and not ckpt.exists(best=True)
    with pytest.raises(IOError, match="does not exist"):
        ckpt.restore()
    assert ckpt.save(_state(0.5), is_best=True) == str(
        tmp_path / "run" / "last")
    ckpt.save(_state(0.25))
    assert ckpt.exists() and ckpt.exists(best=True)
    assert sorted(os.listdir(tmp_path / "run")) == ["best", "last"]
    last, best = ckpt.restore(), ckpt.restore(best=True)
    for tree, v in ((last, 0.25), (best, 0.5)):
        assert tree["best_eval_score"] == v and tree["num_iterations"] == 7
        kernel = tree["model_state_dict"]["params"]["conv"]["kernel"]
        assert isinstance(kernel, np.ndarray) and (kernel == v).all()
        assert tree["model_state_dict"]["batch_stats"] == {}
        opt = tree["optimizer_state_dict"]
        assert opt["inner_state"]["0"] == {} and opt["count"] == 7
        assert opt["torch_optimizer"] == "Adam"
        np.testing.assert_array_equal(opt["inner_state"]["1"]["mu"],
                                      np.full(4, v, np.float32))
    template = _state(0.0)
    filled = ckpt.restore(template=template, best=True)
    mu = template["optimizer_state_dict"]["inner_state"]["1"]["mu"]
    assert filled["optimizer_state_dict"]["inner_state"]["1"]["mu"] is mu
    assert torch.equal(mu, torch.full((4,), 0.5))
    assert isinstance(filled["optimizer_state_dict"]["count"], np.int32)
    with pytest.raises(ValueError, match="holds '/'"):
        ckpt.save({"a/b": 1})


def test_commit_is_atomic(tmp_path, monkeypatch):
    ckpt = DistCheckpointer(str(tmp_path))
    ckpt.save(_state(0.5))
    real = dist_ckpt.dcp.save

    def torn(state, checkpoint_id, **kw):  # writes, then dies
        real(state, checkpoint_id=checkpoint_id, **kw)
        raise OSError("preempted")

    monkeypatch.setattr(dist_ckpt.dcp, "save", torn)
    with pytest.raises(OSError, match="preempted"):
        ckpt.save(_state(0.75))
    assert ckpt.restore()["best_eval_score"] == 0.5  # the old one, whole
    monkeypatch.setattr(dist_ckpt.dcp, "save", real)
    assert os.path.isdir(tmp_path / "last.tmp")  # the torn write
    ckpt.save(_state(0.75))
    assert ckpt.restore()["best_eval_score"] == 0.75
    assert sorted(os.listdir(tmp_path)) == ["last"]


def test_orbax_directory_raises(tmp_path):
    last = tmp_path / "orbax" / "last"
    last.mkdir(parents=True)
    for name in ("_CHECKPOINT_METADATA", "manifest.ocdbt"):
        (last / name).write_text("{}")
    with pytest.raises(ValueError, match="train/orbax_ckpt.py"):
        DistCheckpointer(str(tmp_path / "orbax")).restore()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dist_ckpt"))
    jm = jax_get_model(W.CFG_3D["bcr"]["model"])
    x = jnp.asarray(W.train_batches_3d()[0][0][:1])
    variables = jax.jit(jm.init, static_argnums=2)(jax.random.PRNGKey(0), x,
                                                    True)
    jax_ckpt.save_checkpoint(
        {"num_epochs": 0, "num_iterations": 0,
         "model_state_dict": dict(variables), "best_eval_score": 0.0,
         "optimizer_state_dict": jax_opt.create_optimizer(
             W.OPTIMIZER_3D).init(variables["params"])},
        False, os.path.dirname(W.init_path(out, "bcr")))
    return W.results(W.spawn("ckpt", out), "ckpt", out)


def test_resume_in_a_world_of_two_is_bit_equal(ranks):
    for r in ranks:
        assert len(r["full"]["losses"]) == 3
        assert len(r["first"]["losses"]) == 2
        assert r["exists"] == (True, True) and r["resumed_at"] == 2
        assert r["first"]["losses"] == r["full"]["losses"][:2]
        assert r["resumed"]["losses"] == r["full"]["losses"][2:]
        full, resumed = r["full_state"], r["resumed_state"]
        keys = [k for k in full if k.startswith(
            ("model_state_dict/", "optimizer_state_dict/"))]
        assert any("batch_stats" in k for k in keys)
        assert any("/mu/" in k for k in keys)
        assert keys == [k for k in resumed if k in keys]
        for k in keys:
            np.testing.assert_array_equal(resumed[k], full[k], err_msg=k)
    assert ranks[0]["full_state"].keys() == ranks[1]["full_state"].keys()
    for k, v in ranks[0]["full_state"].items():
        np.testing.assert_array_equal(ranks[1]["full_state"][k], v,
                                      err_msg=k)


def test_both_ranks_see_one_committed_checkpoint(ranks):
    files = ranks[0]["dcp_files"]
    assert files == ranks[1]["dcp_files"]
    assert not [f for f in files if ".tmp" in f or ".old" in f]
    for d in ("last", "best"):
        assert f"{d}/.metadata" in files
        parts = [f for f in files if f.startswith(d + "/")
                 and f.endswith(".distcp")]
        assert parts, files

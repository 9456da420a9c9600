"""The port's process group and data axis (``parallel/distributed.py``,
``parallel/mesh.py``) and its global-batch statistics, on a gloo world of
2 on the CPU launched from the environment (``COORDINATOR_ADDRESS``,
``NUM_PROCESSES``, ``PROCESS_ID``), each rank holding half the rows of
one seeded global batch (``torch_port_dp_worker.primitive_inputs``):

- ``initialize``: a second call changes nothing; ``process_info``,
  ``is_primary`` and the mesh's shape per rank; without a card, asking for
  NCCL or the card raises (it never falls back to gloo or the CPU);
- ``shard_batch`` (this rank's rows; a batch that does not divide whole),
  ``replicate`` (rank 0's tree), ``device_prefetch``, ``gather_rows``;
- BatchNorm's forward and backward over the split rows against the
  port's BatchNorm of the global batch in one process: outputs, the
  statistics and dx within ``STAT_TOL``, the ranks' scale and bias
  gradients summing to the global ones;
- each ratio loss on the split rows (the whole ``segmentation_loss`` at
  176², ``DiceLoss``, ``GeneralizedDiceLoss``, ``BCEDiceLoss``, the
  weighted ``CrossEntropyLoss`` and ``WeightedCrossEntropyLoss``) against
  the JAX package's on the global batch: the ranks' mean loss within
  ``LOSS_TOL``, and each rank's input gradient, divided by the world
  size (DDP's average restores it), within ``LOSS_TOL`` of the global
  gradient's rows; on a tail that every rank holds whole (outside
  ``rows_split``) the loss and gradient are the global ones, with no
  all-reduce;
- ``device_cache`` refuses a multi-process run; process-sharded
  ``VolumeLoader`` rows.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_port_dp_worker as W
from mdeical_image_segmentation_tpu.losses import losses3d as jax_losses3d
from mdeical_image_segmentation_tpu.losses.losses2d import (
    segmentation_loss as jax_segmentation_loss,
)
from mdeical_image_segmentation_tpu_torch.data.loaders import VolumeLoader
from mdeical_image_segmentation_tpu_torch.ops import batchnorm
from mdeical_image_segmentation_tpu_torch.parallel import (
    distributed,
    make_mesh,
)

LOSS_TOL = 1e-4
STAT_TOL = 1e-5


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("primitives"))
    procs = W.spawn("primitives", out, via_env=True)
    return W.results(procs, "primitives", out)


@pytest.fixture(scope="module")
def inputs():
    return W.primitive_inputs()


def _jax_losses():
    return {"segmentation": jax_segmentation_loss,
            "dice": jax_losses3d.DiceLoss(),
            "gdl": jax_losses3d.GeneralizedDiceLoss(),
            "bce_dice": jax_losses3d.BCEDiceLoss(),
            "ce": jax_losses3d.CrossEntropyLoss(weight=[0.3, 1.0, 2.0],
                                                ignore_index=1),
            "wce": jax_losses3d.WeightedCrossEntropyLoss()}


def test_initialize_is_idempotent_and_reads_the_environment(ranks):
    for rank, r in enumerate(ranks):
        assert r["same_group"] and r["backend"] == "gloo"
        assert r["info"] == {"process_index": rank, "process_count": 2,
                             "local_devices": 1, "global_devices": 2}
        assert r["primary"] == (rank == 0)
        assert r["shape"] == {"data": 2, "model": 1} and r["rank"] == rank


def test_initialize_never_falls_back():
    """Without a card: the card, or NCCL, raise before any process group
    is made; in one process with no group, rank 0 is primary."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA card"):
        distributed.initialize("localhost:1", 1, 0)
    with pytest.raises(RuntimeError, match="NCCL"):
        distributed.initialize("localhost:1", 1, 0, device="cpu",
                               backend="nccl")
    with pytest.raises(ValueError, match="backend"):
        distributed.initialize("localhost:1", 1, 0, device="cpu",
                               backend="mpi")
    assert not torch.distributed.is_initialized()
    assert distributed.is_primary()
    assert distributed.process_info()["process_count"] == 1
    with pytest.raises(RuntimeError, match="CUDA card"):
        make_mesh()
    with pytest.raises(ValueError, match="one process per device"):
        make_mesh(n_data=2, device="cpu")
    with pytest.raises(ValueError, match="one process per device"):
        make_mesh(n_model=2, device="cpu")
    assert make_mesh(device="cpu").size == 1


def test_mesh_helpers(ranks, inputs):
    x = inputs["x"]
    for rank, r in enumerate(ranks):
        np.testing.assert_array_equal(r["shard"], x[2 * rank:2 * rank + 2])
        np.testing.assert_array_equal(r["tail"], x[:3])  # 3 rows: whole
        np.testing.assert_array_equal(r["gathered"], x)
        rep = r["replicated"]
        assert torch.equal(rep["a"], torch.zeros(2))  # rank 0's values
        np.testing.assert_array_equal(rep["b"], np.zeros(3))
        assert rep["c"] == [0, "r0"]
        assert len(r["prefetch"]) == 2
        np.testing.assert_array_equal(r["prefetch"][0],
                                      x[2 * rank:2 * rank + 2])
        np.testing.assert_array_equal(r["prefetch"][1], x[:3])
        assert "single-process" in r["device_cache"]


def test_batchnorm_takes_global_batch_statistics(ranks, inputs):
    x = torch.from_numpy(inputs["bn_x"]).requires_grad_(True)
    w = torch.from_numpy(inputs["bn_w"]).requires_grad_(True)
    b = torch.from_numpy(inputs["bn_b"]).requires_grad_(True)
    y, mean, var = batchnorm.batch_norm_train(x, w, b, 1e-5)
    (y * torch.from_numpy(inputs["bn_g"])).sum().backward()
    want = {"y": y.detach().numpy(), "dx": x.grad.numpy()}
    for rank, r in enumerate(ranks):
        got = r["bn"]
        rows = slice(2 * rank, 2 * rank + 2)
        for k in ("y", "dx"):
            assert np.abs(got[k] - want[k][rows]).max() <= STAT_TOL * np.abs(
                want[k]).max(), k
        np.testing.assert_allclose(got["mean"], mean.numpy(), rtol=STAT_TOL,
                                   atol=STAT_TOL)
        np.testing.assert_allclose(got["var"], var.numpy(), rtol=STAT_TOL)
    for k, g in (("dw", w.grad), ("db", b.grad)):
        np.testing.assert_allclose(sum(r["bn"][k] for r in ranks), g.numpy(),
                                   rtol=STAT_TOL, atol=STAT_TOL)


@pytest.mark.parametrize("name", ["segmentation", "dice", "gdl", "bce_dice",
                                  "ce", "wce"])
def test_ratio_losses_are_global(ranks, inputs, name):
    fn = _jax_losses()[name]
    logits = jnp.asarray(inputs[f"{name}_logits"])
    target = jnp.asarray(inputs[f"{name}_target"])
    want, grad = jax.jit(jax.value_and_grad(lambda lg: fn(lg, target)))(
        logits)
    want, grad = float(want), np.asarray(grad)
    np.testing.assert_allclose(np.mean([r["losses"][name, True][0]
                                        for r in ranks]), want,
                               rtol=LOSS_TOL)
    scale = np.abs(grad).max()
    for rank, r in enumerate(ranks):
        rows = slice(2 * rank, 2 * rank + 2)
        value, g = r["losses"][name, True]
        assert np.abs(g / len(ranks) - grad[rows]).max() <= (
            LOSS_TOL * scale), name
        # a tail every rank holds whole: no all-reduce
        value, g = r["losses"][name, False]
        np.testing.assert_allclose(value, want, rtol=LOSS_TOL)
        assert np.abs(g - grad).max() <= LOSS_TOL * scale, name


def test_volume_loader_process_shard():
    ds = [(np.full((1,), i, np.float32),) for i in range(7)]
    whole = [b[0][:, 0] for b in VolumeLoader(ds, 4, shuffle=True, seed=2,
                                              prefetch=0, drop_last=True)]
    for rank in range(2):
        got = [b[0][:, 0] for b in VolumeLoader(
            ds, 4, shuffle=True, seed=2, prefetch=0, drop_last=True,
            process_shard=(rank, 2))]
        assert len(got) == len(whole) == 1
        np.testing.assert_array_equal(got[0],
                                      whole[0][2 * rank:2 * rank + 2])
    with pytest.raises(ValueError, match="drop_last"):
        VolumeLoader(ds, 4, process_shard=(0, 2))

"""Spatially sharded 3D training of the port (``parallel/spatial.py``, the
cross-shard GroupNorm of ``ops/norm.py``, ``UNetTrainer``'s spatial mode)
against the JAX package's, on the CPU: the port's gloo world of 2
(``torch_port_dp_worker.py``'s ``scenario_spatial``, its cases in
``torch_port_spatial_cases.py``) and its world of 1 (this process, no
process group) against the JAX package on a 2-device sub-mesh, from the
same weights (the port's seeded initialization, carried to JAX by the
parameter bridge) on the same seeded volumes.

Held (float32):

- the sharded forward, per-slab and cross-shard statistics, and the input
  gradient of sum(output · cotangent), which crosses the ranks through the
  halo exchange's backward, against ``jax.vjp`` of the JAX package's
  (per-slab statistics: against ``jax.grad`` of its single-device
  emulation, ``_emulated_per_shard``, where the JAX package's own sharded
  gradient strays in the last rows): within rtol 1e-5 plus ``FWD_TOL``
  1e-5 of the tensor's max |value|.
  That is the two frameworks' own fp32 floor: the same model's unsharded
  forward and input gradient differ by 2.3e-6 and 2.1e-6 of their max
  |value| (3.9e-6 and 2.5e-5 absolute, the convolutions summing in other
  orders), so an absolute 1e-6 holds for neither;
- one SGD step of the mean of the per-slab MSEs in both modes: the loss
  within rtol 1e-5, the parameters within rtol 3e-4 / atol 1e-6 (the JAX
  package's own test's tolerance); the cross-shard forward, step loss and
  parameters of the world of 2 against the world of 1 (mesh-width
  invariance) within the same;
- a ResidualUNet3D 'cr' (no statistics): the sharded interior against the
  monolithic forward, rtol 1e-5 / atol 1e-6;
- the JAX package's error cases and messages: an indivisible extent, a
  halo of a whole slab, a halo that does not divide by the pooling factor;
- the windowed plain versions of kernels 3a and 3d against masked sums;
- ``create_trainer`` with the ``parallel:`` keys on HDF5 files for two
  steps against the JAX ``UNetTrainer`` in spatial mode: the logged train
  and validation losses and score within 1e-5 relative, the parameters
  within ``PARAM_TOL`` 1e-4 of each tensor's max |value| (two steps of
  BCEDiceLoss at lr 0.05 carry the gradients' floor into the weights;
  the data-parallel tests' bound); the loaders are not process-sharded
  (each rank's step sees the whole volume) and ``rows_split`` is off
  while the loss runs (BCEDiceLoss's Dice is the per-slab one, as in
  JAX); only rank 0 writes.
"""

import functools
import os

import h5py
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh

import torch_port_dp_worker as W
import torch_port_spatial_cases as S
from mdeical_image_segmentation_tpu import logging_utils as jax_log
from mdeical_image_segmentation_tpu.data.loaders import (
    get_train_loaders as jax_loaders,
)
from mdeical_image_segmentation_tpu.losses import losses3d as jax_losses
from mdeical_image_segmentation_tpu.metrics import metrics3d as jax_metrics
from mdeical_image_segmentation_tpu.models import get_model as jax_get_model
from mdeical_image_segmentation_tpu.parallel import mesh as jax_mesh
from mdeical_image_segmentation_tpu.parallel.spatial import (
    make_spatial_train_step as jax_step,
)
from mdeical_image_segmentation_tpu.parallel.spatial import (
    spatial_sharded_apply as jax_apply,
)
from mdeical_image_segmentation_tpu.train import checkpoint as jax_ckpt
from mdeical_image_segmentation_tpu.train import optimizers as jax_opt
from mdeical_image_segmentation_tpu.train import trainer3d as jax_trainer
from mdeical_image_segmentation_tpu_torch.models import get_model
from mdeical_image_segmentation_tpu_torch.ops import norm
from mdeical_image_segmentation_tpu_torch.utils.param_bridge import (
    state_dict_to_flax,
)

RTOL, ATOL = 1e-5, 1e-6
FWD_TOL = 1e-5
P_RTOL = 3e-4
PARAM_TOL = 1e-4
LOSS_RTOL = 1e-5


def _init(cfg, amplify=1.0):
    """The port's seeded weights of ``cfg`` (conv kernels times
    ``amplify``, so a deep enough signal survives, as the JAX test does):
    the state dict and its flax tree (numpy)."""
    model = get_model(cfg, generator=torch.Generator().manual_seed(0))
    sd = {k: v * amplify if v.ndim == 5 else v
          for k, v in model.state_dict().items()}
    return sd, state_dict_to_flax(sd)


def _write_inputs(out, variables):
    for name, (sd, _) in variables.items():
        torch.save(sd, S.weights_path(out, name))
    train, val = S.train_volumes()
    for name, raw in (("train", train), ("val", val)):
        with h5py.File(os.path.join(out, f"{name}.h5"), "w") as f:
            f.create_dataset("raw", data=raw)
            f.create_dataset("label", data=(raw > 0.5).astype(np.uint8))
    params = variables["gcr"][1]["params"]
    jax_ckpt.save_checkpoint(
        {"num_epochs": 0, "num_iterations": 0,
         "model_state_dict": {"params": params, "batch_stats": {}},
         "best_eval_score": 0.0,
         "optimizer_state_dict": jax_opt.create_optimizer(
             S.TRAIN_CFG["optimizer"]).init(params)},
        False, os.path.join(out, "init_ckpt"))


def _flat(tree, prefix=""):
    return S._flat(jax.device_get(tree), prefix)


def _emulated_per_shard(model, var, n=2, axis=2):
    """sum(output · cotangent) of the per-slab objective on one device, as
    the JAX package's own test emulates it (``_emulated_loss``): split, pad
    from the real neighbours (reflect at the volume's edges), apply, crop.
    The JAX package's shard_map gradient of it differs in the volume's last
    5 rows (up to 1.7e-2) while the port's world of 2 equals this."""
    halo = S.HALO
    take = jax.lax.slice_in_dim

    def loss(v, c):
        shards, cots = jnp.split(v, n, axis), jnp.split(c, n, axis)
        total = 0.0
        for i, s in enumerate(shards):
            e = s.shape[axis]
            left = (take(shards[i - 1], e - halo, None, axis=axis) if i > 0
                    else jnp.flip(take(s, 1, halo + 1, axis=axis), axis))
            right = (take(shards[i + 1], 0, halo, axis=axis) if i < n - 1
                     else jnp.flip(take(s, e - halo - 1, e - 1, axis=axis),
                                   axis))
            y = model.apply(var, jnp.concatenate([left, s, right], axis),
                            False)
            total = total + jnp.sum(take(y, halo, halo + e, axis=axis)
                                    * cots[i])
        return total

    return loss


def _jax_runs(out, variables):
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))
    vol, labels, cot = (jnp.asarray(a) for a in S.inputs())
    model = jax_get_model(S.GCR)
    var = variables["gcr"][1]
    res = {"forward": {}, "grad": {}, "step": {}}
    for mode in S.MODES:
        def fwd(v, mode=mode):
            return jax_apply(model, var, v, mesh, halo=S.HALO, shard_axis=2,
                             cross_shard_norm=mode)

        if mode:
            @jax.jit
            def fwd_and_grad(v, c, fwd=fwd):
                y, vjp = jax.vjp(fwd, v)
                return y, vjp(c)[0]

            y, g = fwd_and_grad(vol, cot)
        else:
            y = jax.jit(fwd)(vol)
            g = jax.jit(jax.grad(_emulated_per_shard(model, var)))(vol, cot)
        res["forward"][mode], res["grad"][mode] = np.asarray(y), np.asarray(g)
        opt = optax.sgd(S.LR)
        step = jax_step(model, lambda o, t: jnp.mean(jnp.square(o - t)), opt,
                        mesh, halo=S.HALO, shard_axis=2, train=False,
                        donate=False, cross_shard_norm=mode)
        params, _, loss = step(var["params"], opt.init(var["params"]), vol,
                               labels, jax.random.PRNGKey(1))
        res["step"][mode] = (float(loss), _flat(params))
    errors = {}
    bad = {"indivisible": dict(volume=jnp.zeros((1, 8, 63, 16, 1)), halo=4),
           "oversized": dict(volume=vol, halo=32),
           "pool_factor": dict(volume=vol, halo=7, cross_shard_norm=True)}
    for name, kw in bad.items():
        volume = kw.pop("volume")
        try:  # traced, not run: the checks fire while tracing
            jax.jit(functools.partial(jax_apply, model, var, mesh=mesh,
                                      shard_axis=2, **kw))(volume)
            errors[name] = None
        except (AssertionError, ValueError) as e:
            errors[name] = str(e)
    res["errors"] = errors
    res["trainer"] = _jax_trainer(out)
    return res


def _jax_trainer(out):
    cfg = S.trainer_config(out, os.path.join(out, "trainer_jax"))
    t = jax_trainer.UNetTrainer(
        model=jax_get_model(cfg["model"]),
        optimizer=jax_opt.create_optimizer(cfg["optimizer"]),
        lr_scheduler=None,
        loss_criterion=jax_losses.get_loss_criterion(cfg),
        eval_criterion=jax_metrics.get_evaluation_metric(cfg),
        loaders=jax_loaders(cfg, n_devices=1, mesh=None),
        checkpoint_dir=cfg["trainer"]["checkpoint_dir"],
        tensorboard_formatter=jax_log.TensorboardFormatter(),
        pre_trained=cfg["trainer"]["pre_trained"],
        mesh=jax_mesh.make_mesh(devices=jax.devices()[:2]),
        base_lr=S.LR, **S.TRAINER,
        **{k: v for k, v in cfg["parallel"].items()})
    t.fit()
    run_dir = cfg["trainer"]["checkpoint_dir"]
    return {"params": _flat(t._state["params"]),
            "logged": {tag: S._logged(run_dir, tag)
                       for tag in ("train_loss_avg", "val_loss_avg",
                                   "val_eval_score_avg")}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX, the port's world of 1, [rank 0, rank 1] of its world of 2)."""
    out = str(tmp_path_factory.mktemp("spatial"))
    variables = {"gcr": _init(S.GCR), "res": _init(S.RES_CR, 3.0)}
    _write_inputs(out, variables)
    procs = W.spawn("spatial", out)
    try:
        one = {"forward": S.forward_and_grad(S._model(S.GCR, out, "gcr"),
                                             True)[0],
               "step": S.sgd_step(S._model(S.GCR, out, "gcr"), True)}
        model = S._model(S.RES_CR, out, "res")
        with torch.no_grad():
            one["residual_mono"] = model(torch.from_numpy(
                S.inputs()[0])).numpy()
        jax_res = _jax_runs(out, variables)
    except BaseException:
        for p in procs:
            p.kill()
        raise
    return jax_res, one, W.results(procs, "spatial", out)


def _volume(ranks, key, mode):
    """The ranks' slabs of ``key`` joined along H."""
    return np.concatenate([r[key][mode] for r in ranks], axis=2)


def _close_params(got, want):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=P_RTOL, atol=ATOL,
                                   err_msg=k)


def _close_scaled(got, want, tol=FWD_TOL):
    """Within rtol 1e-5 plus ``tol`` of max |want|."""
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=tol * float(np.abs(want).max()))


@pytest.mark.parametrize("mode", S.MODES, ids=["per_shard", "cross_shard"])
def test_forward_matches_jax(runs, mode):
    jax_res, _, ranks = runs
    _close_scaled(_volume(ranks, "forward", mode), jax_res["forward"][mode])


@pytest.mark.parametrize("mode", S.MODES, ids=["per_shard", "cross_shard"])
def test_input_gradient_matches_jax_grad(runs, mode):
    jax_res, _, ranks = runs
    _close_scaled(_volume(ranks, "grad", mode), jax_res["grad"][mode])


@pytest.mark.parametrize("mode", S.MODES, ids=["per_shard", "cross_shard"])
def test_sgd_step_matches_jax(runs, mode):
    jax_res, _, ranks = runs
    want_loss, want = jax_res["step"][mode]
    for r in ranks:
        loss, params = r["step"][mode]
        np.testing.assert_allclose(loss, want_loss, rtol=LOSS_RTOL)
        _close_params(params, want)


def test_cross_shard_is_mesh_width_invariant(runs):
    """World 2 = world 1: the forward, and the step's loss and
    parameters."""
    _, one, ranks = runs
    _close_scaled(_volume(ranks, "forward", True), one["forward"])
    for r in ranks:
        loss, params = r["step"][True]
        np.testing.assert_allclose(loss, one["step"][0], rtol=LOSS_RTOL)
        _close_params(params, one["step"][1])


def test_residual_interior_equals_monolithic(runs):
    """ResidualUNet3D 'cr' (no statistics): every row but the volume's
    outer 24, where the slab's reflect-pad meets the monolithic zero-pad,
    equals the monolithic forward, the shard boundary at row 32
    included."""
    _, one, ranks = runs
    sharded = np.concatenate([r["residual"] for r in ranks], axis=2)
    mono = one["residual_mono"]
    assert np.abs(mono).std() > 1e-3  # non-vacuous
    np.testing.assert_allclose(sharded[:, :, 24:40], mono[:, :, 24:40],
                               rtol=RTOL, atol=ATOL)
    assert np.abs(sharded[:, :, :4] - mono[:, :, :4]).max() > 0


def test_error_cases_match_jax(runs):
    jax_res, _, ranks = runs
    for r in ranks:
        assert r["errors"] == jax_res["errors"]
    assert all(jax_res["errors"].values())
    assert "divisible by the pooling factor" in jax_res["errors"][
        "pool_factor"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("axis,lo,hi", [(2, 4, 20), (1, 1, 3), (3, 0, 5)])
def test_windowed_plain_3a_3d_match_masked_sums(dtype, axis, lo, hi):
    rng = np.random.default_rng(axis)
    shape = (2, 4, 24, 6, 8)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                         ).to(dtype)
    g = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                         ).to(dtype)
    a, c, d = (torch.from_numpy(rng.standard_normal((2, 8)).astype(
        np.float32)) for _ in range(3))
    mask = np.zeros(shape[axis], bool)
    mask[lo:hi] = True
    mask = mask.reshape([-1 if i == axis else 1 for i in range(5)])
    xf, gf = x.float().numpy(), g.float().numpy()
    s1, s2 = norm.gn_channel_sums(x, window=(axis, lo, hi))
    np.testing.assert_allclose(s1.numpy(), (xf * mask).sum((1, 2, 3)),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(s2.numpy(), (xf * xf * mask).sum((1, 2, 3)),
                               rtol=1e-5, atol=1e-4)
    dx = norm.gn_bwd_dx(x, g, a, c, d, window=(axis, lo, hi))
    an, cn, dn = (t.numpy()[:, None, None, None] for t in (a, c, d))
    want = np.where(mask, (gf * an + xf * cn) + dn, gf * an)
    np.testing.assert_array_equal(dx.float().numpy(),
                                  torch.from_numpy(want.astype(np.float32))
                                  .to(dtype).float().numpy())
    # the full window is the unwindowed call
    full = (axis, 0, shape[axis])
    assert torch.equal(norm.gn_bwd_dx(x, g, a, c, d, full),
                       norm.gn_bwd_dx(x, g, a, c, d))
    with pytest.raises(ValueError, match="window"):
        norm.gn_channel_sums(x, window=(axis, hi, lo))


def test_trainer_matches_jax(runs):
    jax_res, _, ranks = runs
    want = jax_res["trainer"]
    for r in ranks:
        t = r["trainer"]
        assert len(t["losses"]) == 2
        assert t["losses"] == ranks[0]["trainer"]["losses"]
        for k, w in want["params"].items():
            np.testing.assert_allclose(
                t["params"][k], w, rtol=0,
                atol=PARAM_TOL * float(np.abs(w).max()), err_msg=k)
    logged = ranks[0]["trainer"]["logged"]
    for tag, rows in want["logged"].items():
        assert rows.keys() == logged[tag].keys() and rows, tag
        for step, v in rows.items():
            np.testing.assert_allclose(logged[tag][step], v,
                                       rtol=LOSS_RTOL, err_msg=tag)


def test_trainer_spatial_mode_wiring(runs):
    """The ``parallel:`` keys reach the trainer; no DDP; the loaders are
    not process-sharded (each rank's step sees the whole volume); no
    ``rows_split`` while the loss runs; only rank 0 writes."""
    _, _, ranks = runs
    for rank, r in enumerate(ranks):
        t = r["trainer"]
        assert t["spatial"] == (S.HALO, 2, True)
        assert not t["ddp"] and t["process_shard"] is None
        assert t["batch_rows"] == [S.SHAPE] * 2
        # the two steps and the validation
        assert t["split_in_loss"] == [False] * 3
        assert bool(t["files"]) == (rank == 0)
        assert not r["trainer"]["logged"]["train_loss_avg"] or rank == 0
    assert "last_checkpoint.msgpack" in ranks[0]["trainer"]["files"]


def test_trainer_spatial_mode_checks(tmp_path):
    """The JAX trainer's asserts, as errors: 3D only, no BatchNorm orders,
    no per-voxel weights, spatial excludes TP and ZeRO-1; TP and ZeRO-1
    alone build, and on a mesh of 1 take no effect, as in JAX."""
    from mdeical_image_segmentation_tpu_torch import logging_utils
    from mdeical_image_segmentation_tpu_torch.train import trainer3d

    def trainer(cfg, **kw):
        model = get_model(cfg, generator=torch.Generator().manual_seed(0))
        return trainer3d.UNetTrainer(
            model=model, optimizer=torch.optim.SGD(model.parameters(), lr=0.1),
            lr_scheduler=None, loss_criterion=torch.nn.MSELoss(),
            eval_criterion=None, loaders={"train": [], "val": []},
            checkpoint_dir=str(tmp_path), max_num_epochs=1,
            max_num_iterations=1,
            tensorboard_formatter=logging_utils.TensorboardFormatter(), **kw)

    spatial = dict(spatial_halo=S.HALO, spatial_cross_shard_norm=True)
    for kw, err, match in (
            (dict(tensor_parallel=True), ValueError, "mutually exclusive"),
            (dict(zero1=True), ValueError, "mutually exclusive")):
        with pytest.raises(err, match=match):
            trainer(S.GCR, **spatial, **kw)
    for kw in (dict(tensor_parallel=True), dict(zero1=True)):
        t = trainer(S.GCR, **kw)
        assert not t.tensor_parallel and not t.zero1
    with pytest.raises(ValueError, match="BatchNorm orders"):
        trainer({**S.GCR, "layer_order": "bcr"}, **spatial)
    with pytest.raises(ValueError, match="3D-only"):
        trainer({**S.GCR, "name": "UNet2D"}, **spatial)
    t = trainer(S.GCR, **spatial)
    assert t._ddp is t.model and t._spatial_step is not None
    x = torch.zeros(S.SHAPE)
    with pytest.raises(ValueError, match="per-voxel weights"):
        t._train_step(x, x, x)

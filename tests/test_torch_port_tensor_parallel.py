"""Channel tensor parallelism of the port (``parallel/tensor.py``, the
model axis of ``parallel/mesh.py``, ``UNetTrainer`` with ``parallel:
{model_axis, tensor_parallel}``, sharded ``DistCheckpointer`` state)
against the JAX package's (``parallel/tensor.py``), on the CPU: the port's
gloo world of 2 on a model axis of 2 (``torch_port_dp_worker.py``'s
``scenario_tp``, its cases in ``torch_port_model_axis_cases.py``) against
the JAX package on a (1, 2) sub-mesh, from the same weights on the same
inputs.

Held:

- the specs: the port's ``tp_param_specs`` equal JAX's on the bridged tree
  of three families (the 2D UNet, UNet3D 'gcr', ResidualUNetSE3D with its
  transposed convs and Dense gates), dim for dim through
  ``param_bridge.flax_dim``;
- the 2D UNet of ``tests/test_tensor_parallel.py`` (base 8, 32², eval
  mode): the sharded forward on both ranks against JAX's replicated and TP
  forward within rtol 1e-4 / atol 1e-5, each rank's gradient blocks of
  mean(logits²) against ``jax.grad`` within rtol 5e-4 / atol 1e-6 (the
  JAX test's tolerances); every conv with an even out-channel count holds
  half of it;
- ``create_trainer`` with ``parallel: {model_axis: 2, tensor_parallel:
  true}`` (UNet3D 'gcr', f_maps 8, 2 levels, SGD, two steps) against the
  JAX ``UNetTrainer`` with ``tensor_parallel=True``: the logged losses and
  score within 1e-5 relative, the whole parameters within ``PARAM_TOL``
  1e-4 of each tensor's max |value| (the spatial test's bound); both
  ranks write their blocks of the sharded checkpoint into the run's one
  directory, one of them the logs;
- a ``DistCheckpointer`` round trip: 2 steps, the sharded save, a resumed
  trainer's step 3 equal to the uninterrupted run's to the bit (losses,
  whole parameters, Adam moments); a template of ``DTensor`` blocks
  restored from it equal to the saved blocks;
- the JAX package's own orbax checkpoint of a TP run
  (``tests/fixtures/orbax/tp``) resumed by ``create_trainer`` with
  ``tensor_parallel`` on the model axis of 2: each rank's parameter
  blocks and Adam moments the slice of what the JAX package restores from
  it, to the bit, and the counters equal.
"""

import os

import h5py
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_port_dp_worker as W
import torch_port_model_axis_cases as M
from mdeical_image_segmentation_tpu import logging_utils as jax_log
from mdeical_image_segmentation_tpu.data.loaders import (
    get_train_loaders as jax_loaders,
)
from mdeical_image_segmentation_tpu.losses import losses3d as jax_losses
from mdeical_image_segmentation_tpu.metrics import metrics3d as jax_metrics
from mdeical_image_segmentation_tpu.models import UNetConfig as JaxConfig
from mdeical_image_segmentation_tpu.models import UNetModel as JaxUNet
from mdeical_image_segmentation_tpu.models import get_model as jax_get_model
from mdeical_image_segmentation_tpu.parallel import mesh as jax_mesh
from mdeical_image_segmentation_tpu.parallel.tensor import (
    shard_params_tp as jax_shard,
)
from mdeical_image_segmentation_tpu.parallel.tensor import (
    tp_param_specs as jax_specs,
)
from mdeical_image_segmentation_tpu.train import checkpoint as jax_ckpt
from mdeical_image_segmentation_tpu.train import optimizers as jax_opt
from mdeical_image_segmentation_tpu.train import trainer3d as jax_trainer
from mdeical_image_segmentation_tpu_torch.models import (
    UNetConfig,
    UNetModel,
    get_model,
)
from mdeical_image_segmentation_tpu_torch.parallel import tp_param_specs
from mdeical_image_segmentation_tpu_torch.train import save_checkpoint
from mdeical_image_segmentation_tpu_torch.utils.param_bridge import (
    flax_dim,
    flax_to_state_dict,
    state_dict_to_flax,
)

FWD_RTOL, FWD_ATOL = 1e-4, 1e-5
GRAD_RTOL, GRAD_ATOL = 5e-4, 1e-6
LOSS_RTOL = 1e-5
PARAM_TOL = 1e-4

FAMILIES = {
    "unet2d": lambda: UNetModel(UNetConfig(**M.UNET_KW), device="cpu",
                                generator=torch.Generator().manual_seed(0)
                                ).module,
    "unet3d_gcr": lambda: get_model(M.GCR),
    "residual_se3d": lambda: get_model({
        "name": "ResidualUNetSE3D", "in_channels": 1, "out_channels": 2,
        "f_maps": 8, "num_levels": 3, "num_groups": 4,
        "layer_order": "gcr"}),
}


def _flat_specs(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_specs(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = tuple(v)
    return out


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_specs_match_jax_through_the_layout_map(family):
    model = FAMILIES[family]()
    tree = state_dict_to_flax(model.state_dict())["params"]
    want = _flat_specs(jax_specs(tree, jax_mesh.make_mesh(4, 2)))
    got = tp_param_specs(model, 2)
    assert len(got) == len(want)
    for key, spec in got.items():
        # the flax leaf of the port's parameter, by the bridge's mapping
        path, = W.flat(state_dict_to_flax(
            {key: torch.zeros((1,) * len(spec))})["params"])
        mapped = [None] * len(spec)
        for d, axis in enumerate(spec):
            mapped[flax_dim(key, d, len(spec))] = axis
        assert tuple(mapped) == want[path] + (None,) * (
            len(spec) - len(want[path])), key
    sharded = sum("model" in s for s in got.values())
    assert 0 < sharded < len(got)


def _write_inputs(out):
    """The 2D UNet's JAX-initialized weights (the port's state dict), the
    3D runs' volumes and the seeded 'gcr' weights as msgpack checkpoints
    (the trainer run's and the round trip's)."""
    jm = JaxUNet(JaxConfig(**M.UNET_KW))
    x = jnp.asarray(M.forward_input())
    variables = jax.device_get(jm.init(jax.random.PRNGKey(0), x))
    torch.save(flax_to_state_dict(variables), M.init_2d_path(out))
    train, val = M.train_volumes()
    for name, raw in (("train", train), ("val", val)):
        with h5py.File(os.path.join(out, f"{name}.h5"), "w") as f:
            f.create_dataset("raw", data=raw)
            f.create_dataset("label", data=(raw > 0.5).astype(np.uint8))
    params = state_dict_to_flax(get_model(
        M.GCR, generator=torch.Generator().manual_seed(0)).state_dict())[
            "params"]
    jax_ckpt.save_checkpoint(
        {"num_epochs": 0, "num_iterations": 0,
         "model_state_dict": {"params": params, "batch_stats": {}},
         "best_eval_score": 0.0,
         "optimizer_state_dict": jax_opt.create_optimizer(
             {"name": "SGD", "learning_rate": M.LR_3D}).init(params)},
        False, os.path.join(out, "init_ckpt"))
    model = get_model(W.CFG_3D["gcr"]["model"],
                      generator=torch.Generator().manual_seed(0))
    save_checkpoint({"model_state_dict": state_dict_to_flax(
        model.state_dict()), "best_eval_score": 0.0, "num_iterations": 0},
        False, os.path.dirname(W.init_path(out, "gcr")))
    return jm, variables, x


def _jax_2d(jm, variables, x):
    """JAX's replicated and TP forward and the gradients of mean(logits²)
    (eval mode)."""
    mesh = jax_mesh.make_mesh(1, 2, devices=jax.devices()[:2])

    def loss(p):
        return jnp.mean(jnp.square(jm.apply({"params": p}, x,
                                            train=False).logits))

    ref = np.asarray(jm.apply(variables, x, train=False).logits)
    params_tp = jax_shard(variables["params"], mesh)
    fwd_tp = np.asarray(jax.jit(lambda p: jm.apply(
        {"params": p}, x, train=False).logits)(params_tp))
    grads = W.flat(jax.device_get(jax.grad(loss)(variables["params"])))
    return {"ref": ref, "tp": fwd_tp, "grads": grads}


def _jax_trainer(out):
    cfg = M.train_config(out, os.path.join(out, "trainer_jax"))
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
        mesh=jax_mesh.make_mesh(n_model=2, devices=jax.devices()[:2]),
        base_lr=M.LR_3D, tensor_parallel=True, **M.TRAINER_3D)
    t.fit()
    run_dir = cfg["trainer"]["checkpoint_dir"]
    return {"params": W.flat(jax.device_get(t._state["params"])),
            "logged": {tag: M.logged(run_dir, tag)
                       for tag in ("train_loss_avg", "val_loss_avg",
                                   "val_eval_score_avg")}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX's 2D results, JAX's trainer run, [rank 0, rank 1])."""
    out = str(tmp_path_factory.mktemp("tensor_parallel"))
    jm, variables, x = _write_inputs(out)
    procs = W.spawn("tp", out)
    try:
        jax_2d = _jax_2d(jm, variables, x)
        jax_run = _jax_trainer(out)
    except BaseException:
        for p in procs:
            p.kill()
        raise
    return jax_2d, jax_run, W.results(procs, "tp", out)


def test_ranks_sit_on_the_model_axis(runs):
    _, _, ranks = runs
    for r, rank in zip(ranks, range(2)):
        assert r["mesh"] == ({"data": 1, "model": 2}, 0, rank)
        t = r["trainer"]
        assert t["mesh"] == {"data": 1, "model": 2} and t["tp"]
        assert not t["ddp"]  # a data axis of 1: no DDP


def test_forward_matches_jax_replicated_and_tp(runs):
    jax_2d, _, ranks = runs
    for r in ranks:
        got = r["unet2d"]["logits"]
        np.testing.assert_allclose(got, jax_2d["ref"], rtol=FWD_RTOL,
                                   atol=FWD_ATOL)
        np.testing.assert_allclose(got, jax_2d["tp"], rtol=FWD_RTOL,
                                   atol=FWD_ATOL)


def test_gradients_match_jax_block_for_block(runs):
    jax_2d, _, ranks = runs
    for rank, r in enumerate(ranks):
        res = r["unet2d"]
        blocks = {}
        for key, d in res["dims"].items():
            ndim = len(res["shapes"][key])
            blocks[key] = flax_dim(key, d, ndim)
        for path, got in res["grads"].items():
            want = jax_2d["grads"][path]
            if got.shape != want.shape:  # this rank's block of the out dim
                n = got.shape[-1]
                want = want[..., rank * n:(rank + 1) * n]
            np.testing.assert_allclose(got, want, rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL, err_msg=path)
        assert blocks


def test_each_rank_holds_half_of_every_even_conv(runs):
    _, _, ranks = runs
    whole = {k: tuple(v.shape) for k, v in FAMILIES["unet2d"]()
             .named_parameters()}
    for r in ranks:
        shapes, dims = r["unet2d"]["shapes"], r["unet2d"]["dims"]
        for key, shape in whole.items():
            if key.endswith("weight") and len(shape) == 4:
                out_dim = 1 if "ConvTranspose" in key else 0
                if shape[out_dim] % 2 == 0:
                    assert dims[key] == out_dim, key
                    assert shapes[key][out_dim] == shape[out_dim] // 2, key
                else:  # the 1-channel head stays whole
                    assert key not in dims and shapes[key] == shape, key


def test_trainer_logs_match_jax(runs):
    _, jax_run, ranks = runs
    got = ranks[0]["trainer"]["logged"]
    for tag, want in jax_run["logged"].items():
        assert sorted(got[tag]) == sorted(want), tag
        for step, v in want.items():
            assert abs(got[tag][step] - v) <= LOSS_RTOL * abs(v), (tag, step)
    # the ranks compute one replicated loss
    assert ranks[0]["trainer"]["losses"] == ranks[1]["trainer"]["losses"]


def test_trainer_parameters_match_jax(runs):
    _, jax_run, ranks = runs
    for r in ranks:
        got = r["trainer"]["params"]
        assert got.keys() == jax_run["params"].keys()
        for k, want in jax_run["params"].items():
            np.testing.assert_allclose(
                got[k], want, rtol=0,
                atol=PARAM_TOL * float(np.abs(want).max()), err_msg=k)


def test_trainer_writes_its_blocks_of_a_sharded_checkpoint(runs):
    _, _, ranks = runs
    files = [r["trainer"]["files"] for r in ranks]
    # the ranks' one run directory: one writer of logs, no msgpack
    assert len({f.split("/")[1] for f in files[0]
                if f.startswith("logs/")}) == 1
    assert not any(f.endswith(".msgpack") for f in files[0])
    for d in ("last", "best"):
        assert f"dist_ckpt/{d}/.metadata" in files[0]
        parts = [f for f in files[0] if f.startswith(f"dist_ckpt/{d}/")
                 and f.endswith(".distcp")]
        assert len(parts) == 2, parts  # one file a rank


def test_dcp_round_trip_resumes_to_the_bit(runs):
    _, _, ranks = runs
    for r in ranks:
        rt = r["round_trip"]
        assert len(rt["full"]["losses"]) == 3
        assert rt["resumed_at"] == 2
        assert rt["first"]["losses"] == rt["full"]["losses"][:2]
        assert rt["resumed"]["losses"] == rt["full"]["losses"][2:]
        for part in ("params", "moments"):
            full, resumed = (rt["full_state"][part],
                             rt["resumed_state"][part])
            assert full.keys() == resumed.keys() and full
            for k in full:
                np.testing.assert_array_equal(resumed[k], full[k],
                                              err_msg=k)


def test_sharded_template_restores_its_blocks(runs):
    _, _, ranks = runs
    for r in ranks:
        assert r["round_trip"]["template"]["blocks"] > 0
        assert r["round_trip"]["template"]["equal"]


def orbax_whole(run):
    """What the JAX package restores from the orbax checkpoint of the
    fixture run ``run``: the parameters and Adam moments as numpy state
    dicts of the port's names, Adam's count, the counters."""
    tree = M.fixture_script().jax_restore(
        jax, os.path.join(M.ORBAX, run, "orbax"), False)

    def adam(t):
        items = (t.items() if isinstance(t, dict) else enumerate(t)
                 if isinstance(t, (list, tuple)) else ())
        if isinstance(t, dict) and {"count", "mu", "nu"} <= set(t):
            return t
        return next((a for _, v in items for a in [adam(v)] if a), None)

    def numpy(params):
        return {k: v.numpy() for k, v in flax_to_state_dict(params).items()}

    moments = adam(tree["optimizer_state_dict"])
    return {"params": numpy(tree["model_state_dict"]["params"]),
            "mu": numpy(moments["mu"]), "nu": numpy(moments["nu"]),
            "count": float(moments["count"]),
            "counters": (tree["num_iterations"], tree["num_epochs"],
                         tree["best_eval_score"])}


def test_jax_orbax_checkpoint_resumes_sliced_to_each_rank(runs):
    _, _, ranks = runs
    whole = orbax_whole("tp")
    for rank, r in enumerate(ranks):
        res = r["orbax"]
        assert res["tensor_parallel"] and not res["zero1"]
        assert res["mesh"] == (0, 1, rank, 2)
        assert M.check_orbax_blocks(res, whole) >= 4

"""The port's 3D training path against the JAX package's: model loss
gradients against ``jax.grad`` (weights carried across by the parameter
bridge), the port's ``UNetTrainer`` against the JAX ``UNetTrainer`` from
the same initial checkpoint on the same in-memory batches, Adam
checkpoints moving between the two packages (msgpack both ways; the JAX
trainer's orbax checkpoints of TP and ZeRO-1 runs into the port), and the
trainer's own
contracts (checkpoints, resume, the lr floor, preemption, dropout in
training mode).

Tolerances (float32 on the CPU): model gradients within 1e-4 of each
parameter's max |gradient|, or of 1e-3 of the model's largest gradient if
that is more (the same sums in other orders, amplified where GroupNorm's
E[x²] − mean² cancels, and gradients that are zero up to rounding); the
logged train and validation losses of 4 trainer steps within 1e-4 relative
(Adam moves a weight by ±lr whatever its gradient's size, so the weights
whose gradient is rounding noise take different steps in the two packages;
the loss barely sees those weights); checkpoints restore bit for bit."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mdeical_image_segmentation_tpu import logging_utils as jax_log
from mdeical_image_segmentation_tpu.losses import losses3d as jax_losses
from mdeical_image_segmentation_tpu.metrics import metrics3d as jax_metrics
from mdeical_image_segmentation_tpu.models import get_model as jax_get_model
from mdeical_image_segmentation_tpu.parallel import mesh as jax_mesh
from mdeical_image_segmentation_tpu.train import checkpoint as jax_ckpt
from mdeical_image_segmentation_tpu.train import optimizers as jax_opt
from mdeical_image_segmentation_tpu.train import trainer3d as jax_trainer
from mdeical_image_segmentation_tpu_torch import logging_utils
from mdeical_image_segmentation_tpu_torch.losses import get_loss_criterion
from mdeical_image_segmentation_tpu_torch.metrics import (
    get_evaluation_metric,
)
from mdeical_image_segmentation_tpu_torch.models import get_model
from mdeical_image_segmentation_tpu_torch.models import blocks3d
from mdeical_image_segmentation_tpu_torch.parallel import make_mesh
from mdeical_image_segmentation_tpu_torch.train import (
    checkpoint as ckpt,
)
from mdeical_image_segmentation_tpu_torch.train import optimizers, trainer3d
from mdeical_image_segmentation_tpu_torch.utils.param_bridge import (
    flax_to_state_dict,
)

GRAD_TOL = 1e-4
LOSS_TOL = 1e-4

CFG = {
    "model": {"name": "UNet3D", "in_channels": 1, "out_channels": 1,
              "f_maps": 4, "num_levels": 2, "num_groups": 4,
              "layer_order": "gcr", "final_sigmoid": True},
    "loss": {"name": "BCEDiceLoss"},
    "eval_metric": {"name": "MeanIoU"},
    "optimizer": {"name": "Adam", "learning_rate": 2e-3,
                  "weight_decay": 1e-5},
    "lr_scheduler": {"name": "ReduceLROnPlateau", "mode": "max",
                     "factor": 0.5, "patience": 2},
}
TRAINER = dict(max_num_epochs=1, max_num_iterations=3, validate_after_iters=2,
               log_after_iters=1, base_lr=2e-3)


def _batches(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = rng.random((2, 8, 16, 16, 1)).astype(np.float32)
        out.append((x, (x > 0.6).astype(np.float32)))
    return out


def _logged(run_dir, tag):
    rows = {}
    for root, _, files in os.walk(os.path.join(run_dir, "logs")):
        for f in files:
            if f == "metrics.jsonl":
                for line in open(os.path.join(root, f)):
                    r = json.loads(line)
                    if r["tag"] == tag:
                        rows[r["step"]] = r["value"]
    return rows


def _jax_trainer(run_dir, cfg=CFG, **kw):
    lr = cfg["optimizer"]["learning_rate"]
    return jax_trainer.UNetTrainer(
        model=jax_get_model(cfg["model"]),
        optimizer=jax_opt.create_optimizer(cfg["optimizer"]),
        lr_scheduler=jax_opt.create_lr_scheduler(cfg["lr_scheduler"], lr),
        loss_criterion=jax_losses.get_loss_criterion(cfg),
        eval_criterion=jax_metrics.get_evaluation_metric(cfg),
        loaders={"train": _batches(4, 1), "val": _batches(1, 2)},
        checkpoint_dir=run_dir,
        tensorboard_formatter=jax_log.TensorboardFormatter(),
        mesh=jax_mesh.make_mesh(devices=jax.devices()[:1]),
        **{**TRAINER, **kw})


def _port_trainer(run_dir, cfg=CFG, **kw):
    model = get_model(cfg["model"],
                      generator=torch.Generator().manual_seed(0))
    lr = cfg["optimizer"]["learning_rate"]
    return trainer3d.UNetTrainer(
        model=model,
        optimizer=optimizers.create_optimizer(cfg["optimizer"],
                                              model.parameters()),
        lr_scheduler=optimizers.create_lr_scheduler(cfg["lr_scheduler"], lr),
        loss_criterion=get_loss_criterion(cfg),
        eval_criterion=get_evaluation_metric(cfg),
        loaders={"train": _batches(4, 1), "val": _batches(1, 2)},
        checkpoint_dir=run_dir,
        tensorboard_formatter=logging_utils.TensorboardFormatter(),
        **{**TRAINER, **kw})


def _init_checkpoint(root):
    """A JAX-initialized checkpoint both trainers start from."""
    jm = jax_get_model(CFG["model"])
    x = jnp.asarray(_batches(1, 1)[0][0][:1])
    params = jm.init(jax.random.PRNGKey(0), x, True)["params"]
    opt_state = jax_opt.create_optimizer(CFG["optimizer"]).init(params)
    return jax_ckpt.save_checkpoint(
        {"num_epochs": 0, "num_iterations": 0,
         "model_state_dict": {"params": params, "batch_stats": {}},
         "best_eval_score": 0.0, "optimizer_state_dict": opt_state},
        False, str(root / "init"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One JAX and one port fit() from the same JAX-initialized checkpoint:
    4 steps, validation and checkpoints at iterations 2 and 4."""
    root = tmp_path_factory.mktemp("trainer3d")
    init = _init_checkpoint(root)
    jax_dir, port_dir = str(root / "jax"), str(root / "port")
    jt = _jax_trainer(jax_dir, pre_trained=init)
    jt.fit()
    pt = _port_trainer(port_dir, pre_trained=init)
    pt.fit()
    return jt, pt, jax_dir, port_dir


def test_trainer_losses_match_jax(runs):
    jt, pt, jax_dir, port_dir = runs
    assert jt.num_iterations == pt.num_iterations == 4
    for tag in ("train_loss_avg", "val_loss_avg"):
        want, got = _logged(jax_dir, tag), _logged(port_dir, tag)
        assert sorted(got) == sorted(want) and want, tag
        for step in want:
            np.testing.assert_allclose(got[step], want[step], rtol=LOSS_TOL,
                                       err_msg=f"{tag} at {step}")
    assert sorted(_logged(port_dir, "learning_rate")) == [2, 4]
    for name in (ckpt.LAST_NAME, ckpt.BEST_NAME):
        assert os.path.exists(os.path.join(port_dir, name))


def test_jax_adam_checkpoint_resumes_in_the_port(runs, tmp_path):
    """The JAX trainer's last checkpoint (inject_hyperparams(chain(
    add_decayed_weights, adam))) restores params, Adam moments, step and
    counters into the port bit for bit."""
    jt, _, jax_dir, _ = runs
    path = os.path.join(jax_dir, ckpt.LAST_NAME)
    pt = _port_trainer(str(tmp_path), resume=path)
    assert pt.checkpoint_dir == jax_dir
    assert (pt.num_iterations, pt.num_epochs) == (4, 1)
    assert pt.best_eval_score == jt.best_eval_score
    state = jax.device_get(jt._state)
    sd = pt.model.state_dict()
    for k, v in flax_to_state_dict(state["params"]).items():
        assert torch.equal(sd[k], v), k
    adam = state["opt_state"].inner_state[1][0]
    mu, nu = flax_to_state_dict(adam.mu), flax_to_state_dict(adam.nu)
    for name, p in pt.model.named_parameters():
        st = pt.optimizer.state[p]
        assert int(st["step"]) == int(adam.count) == 4
        assert torch.equal(st["exp_avg"], mu[name]), name
        assert torch.equal(st["exp_avg_sq"], nu[name]), name


@pytest.mark.parametrize("run", ["tp", "zero1"])
def test_jax_orbax_checkpoint_resumes_in_the_port(tmp_path, run):
    """The JAX trainer's own orbax checkpoint of a tensor-parallel run on
    the (2, 4) CPU mesh or a ZeRO-1 run over 8 data devices
    (``tests/fixtures/orbax``) resumed by the port's ``create_trainer`` in
    a world of 1: params, Adam moments, step and counters equal to what
    the JAX package restores, to the bit; the next 3 logged train losses
    within ``LOSS_TOL`` of the JAX package's own resume of the checkpoint
    (on its mesh, global batch batch_size x the data axis, which the port
    takes whole)."""
    from test_torch_port_tensor_parallel import orbax_whole
    from torch_port_model_axis_cases import ORBAX, fixture_script

    from mdeical_image_segmentation_tpu_torch.transforms import volume

    script = fixture_script()
    with open(os.path.join(os.path.dirname(ORBAX), "manifest.json")) as f:
        want = json.load(f)["orbax"]["runs"][run]
    copy = str(tmp_path / run)
    shutil.copytree(os.path.join(ORBAX, run), copy)
    start = want["num_iterations"]
    cfg = script.orbax_config(
        os.path.join(ORBAX, "volumes", "train.h5"),
        os.path.join(ORBAX, "volumes", "val.h5"), str(tmp_path / "other"),
        batch_size=want["data_axis"], resume=os.path.join(copy, "orbax"),
        max_num_iterations=start + script.ORBAX_RESUME_STEPS - 2,
        validate_after_iters=1000)
    cfg["device"] = "cpu"
    volume.GLOBAL_RANDOM_STATE = np.random.RandomState(47)
    t = trainer3d.create_trainer(cfg)
    assert t.checkpoint_dir == copy
    whole = orbax_whole(run)
    assert (t.num_iterations, t.num_epochs, t.best_eval_score) == whole[
        "counters"]
    sd = t.model.state_dict()
    for name, p in t.model.named_parameters():
        assert np.array_equal(sd[name].numpy(), whole["params"][name]), name
        st = t.optimizer.state[p]
        assert float(st["step"]) == whole["count"]
        assert np.array_equal(st["exp_avg"].numpy(), whole["mu"][name]), name
        assert np.array_equal(st["exp_avg_sq"].numpy(),
                              whole["nu"][name]), name
    t.fit()
    got = script.logged(copy, "train_loss_avg")
    assert sorted(got, key=int) == sorted(want["resumed_train_loss_avg"],
                                          key=int)
    assert len(got) == script.ORBAX_RESUME_STEPS
    for step, loss in want["resumed_train_loss_avg"].items():
        np.testing.assert_allclose(got[step], loss, rtol=LOSS_TOL,
                                   err_msg=f"step {step}")


def test_port_adam_checkpoint_resumes_in_jax(runs, tmp_path):
    """The port's last checkpoint loads into the JAX trainer, whose template
    check passes, with params and Adam moments equal to the port's."""
    _, pt, _, port_dir = runs
    jt = _jax_trainer(str(tmp_path),
                      resume=os.path.join(port_dir, ckpt.LAST_NAME))
    jt._init_state(_batches(1, 1)[0][0])
    assert jt.num_iterations == 4
    state = jax.device_get(jt._state)
    sd = pt.model.state_dict()
    for k, v in flax_to_state_dict(state["params"]).items():
        assert torch.equal(sd[k], v), k
    adam = state["opt_state"].inner_state[1][0]
    assert int(adam.count) == int(state["opt_state"].count) == 4
    mu = flax_to_state_dict(adam.mu)
    for name, p in pt.model.named_parameters():
        assert torch.equal(pt.optimizer.state[p]["exp_avg"], mu[name]), name


def test_resume_continues_and_lr_floor_stops(runs, tmp_path):
    _, _, _, port_dir = runs
    resumed = _port_trainer(str(tmp_path / "elsewhere"),
                            resume=os.path.join(port_dir, ckpt.LAST_NAME),
                            max_num_iterations=5, max_num_epochs=3,
                            validate_after_iters=100)
    resumed.fit()
    assert resumed.num_iterations == 6  # steps at iterations 4, 5 and 6
    floor = _port_trainer(str(tmp_path / "floor"), base_lr=1e-7,
                          max_num_iterations=100, max_num_epochs=5)
    floor.scheduler = None
    floor.fit()
    assert floor.num_iterations == 1  # one step, then the floor stops it


def test_preemption_checkpoints_and_stops(tmp_path):
    t = _port_trainer(str(tmp_path), validate_after_iters=100,
                      max_num_iterations=100, max_num_epochs=5)
    t.install_preemption_handler(signals=())
    t.request_stop()
    t.fit()
    assert t.num_iterations == 1
    saved = ckpt.load_checkpoint(os.path.join(str(tmp_path), ckpt.LAST_NAME))
    assert saved["num_iterations"] == 1 and saved["num_epochs"] == 1


@pytest.mark.parametrize("cfg", [
    CFG["model"],
    {"name": "ResidualUNet3D", "in_channels": 2, "out_channels": 2,
     "f_maps": 8, "num_levels": 3, "layer_order": "gcr"},
], ids=["UNet3D", "ResidualUNet3D"])
def test_loss_grads_match_jax_grad(cfg):
    """BCEDice loss gradients of every parameter, through the fused 'gcr'
    Function (and, in ResidualUNet3D, the GroupNorm module's), against
    ``jax.grad``.  ResidualUNet3D takes two input channels: with one, its
    1x1 shortcut makes GroupNorm channels whose E[x²] − mean² cancels."""
    rng = np.random.default_rng(3)
    c = cfg["in_channels"]
    x = (rng.standard_normal((2, 8, 16, 12, c)) + 0.5).astype(np.float32)
    t = (rng.random((2, 8, 16, 12, cfg["out_channels"])) > 0.5).astype(
        np.float32)
    jm = jax_get_model(cfg)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x), False)["params"]
    loss = jax_losses.BCEDiceLoss()
    want = jax.grad(lambda p: loss(jm.apply({"params": p}, jnp.asarray(x),
                                            True), jnp.asarray(t)))(params)
    model = get_model(cfg)
    model.load_state_dict(flax_to_state_dict({"params": params}))
    model.train()
    get_loss_criterion({"loss": {"name": "BCEDiceLoss"}})(
        model(torch.from_numpy(x)), torch.from_numpy(t)).backward()
    grads = dict(model.named_parameters())
    want = flax_to_state_dict({"params": want})
    # a gradient that is rounding noise (the first GroupNorm's scale, whose
    # output the next GroupNorm renormalizes: ~1e-8) is held to 1e-3 of the
    # model's largest gradient instead of its own
    floor = 1e-3 * max(float(w.abs().max()) for w in want.values())
    for name, w in want.items():
        g = grads[name].grad
        assert g is not None, name
        np.testing.assert_allclose(
            g.numpy(), w.numpy(), rtol=0,
            atol=GRAD_TOL * max(float(w.abs().max()), floor), err_msg=name)


@pytest.mark.parametrize("order,channel", [("gcrd", False), ("gcrD", True)])
def test_dropout_is_active_in_training_mode_only(order, channel):
    """'d' drops elements, 'D' whole (sample, channel) feature maps (the
    JAX package's broadcast nn.Dropout), kept values scaled by 1/(1 − p);
    the identity in eval mode, which a block starts in."""
    m = blocks3d.SingleConv(4, 16, order=order, dropout_prob=0.25)
    # seeded weights: the block's conv is allocated empty, and leftover
    # memory there can hold NaNs, which no two forwards compare equal on
    m.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.rand(4, 3, 8, 8, 4) + 1.0
    assert not m.training
    with torch.no_grad():
        ref = m(x)
        m.train()
        blocks3d.set_dropout_generator(m, torch.Generator().manual_seed(0))
        y = m(x)
        blocks3d.set_dropout_generator(m, torch.Generator().manual_seed(0))
        assert torch.equal(m(x), y)  # drawn from the given generator
    kept = y != 0
    torch.testing.assert_close(y[kept], ref[kept] / 0.75)
    dropped = ~kept & (ref != 0)
    if channel:
        maps = dropped.reshape(4, -1, 16)
        live = (ref != 0).reshape(4, -1, 16)
        # a map is dropped whole or not at all
        assert torch.equal(maps.any(1), (maps == live).all(1) & live.any(1))
        share = maps.any(1).float().mean().item()
    else:
        share = dropped.sum().item() / (ref != 0).sum().item()
    assert 0.1 < share < 0.4


def test_models_keep_dropout_prob_and_start_in_eval_mode():
    m = get_model({**CFG["model"], "layer_order": "gcrd",
                   "dropout_prob": [0.2, 0.3]})
    assert not m.training
    block = m.encoder1.basic_module
    assert (block.SingleConv1.dropout.p, block.SingleConv2.dropout.p) == (
        0.2, 0.3)
    m.train()
    assert block.SingleConv1.dropout.training


def test_unported_options_raise(tmp_path):
    # ZeRO-1 and the model axis are ported (test_torch_port_zero1.py,
    # test_torch_port_tensor_parallel.py); as in JAX, zero1 takes effect
    # only on a data axis of more than 1, and a model axis needs its
    # processes
    t = _port_trainer(str(tmp_path / "zero1"), zero1=True)
    assert not t.zero1 and not t.tensor_parallel
    with pytest.raises(ValueError, match="one process per device"):
        make_mesh(n_model=2, device="cpu")
    # a directory that is neither an orbax checkpoint (last/_METADATA) nor
    # a torch.distributed.checkpoint one raises, saying what it holds
    (tmp_path / "orbax" / "last").mkdir(parents=True)
    (tmp_path / "orbax" / "last" / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(ValueError, match="neither.*_CHECKPOINT_METADATA"):
        _port_trainer(str(tmp_path / "run"), resume=str(tmp_path / "orbax"))
    # device_cache is ported (test_torch_port_device_cache.py); a config
    # without the train and val sections still cannot build its loaders
    with pytest.raises(KeyError):
        trainer3d.create_trainer({**CFG, "device": "cpu", "loaders": {
            "device_cache": True}})


@pytest.mark.parametrize("optimizer", ["NAdam", "LBFGS"])
def test_optax_optimizers_and_instance_metrics_train_as_in_jax(tmp_path,
                                                               optimizer):
    """A fit() with one of the optimizers written after optax's rules and an
    instance metric as eval_metric (scored on the host): the logged losses
    within LOSS_TOL and the validation scores equal to JAX's; LBFGS raises
    optax's TypeError from both trainers' first step."""
    cfg = {**CFG, "optimizer": {"name": optimizer, "learning_rate": 2e-3,
                                "weight_decay": 1e-5},
           "eval_metric": {"name": "BoundaryAdaptedRandError",
                           "thresholds": [0.3, 0.5]}}
    # the JAX trainer restores an Adam-shaped optimizer state with
    # pre_trained, which LBFGS's is not: it starts from its own weights
    kw = dict(max_num_iterations=2)
    if optimizer != "LBFGS":
        kw["pre_trained"] = _init_checkpoint(tmp_path)
    jt = _jax_trainer(str(tmp_path / "jax"), cfg, **kw)
    pt = _port_trainer(str(tmp_path / "port"), cfg, **kw)
    if optimizer == "LBFGS":
        for t in (jt, pt):
            with pytest.raises(TypeError, match="'value', 'grad', and "
                               "'value_fn'"):
                t.fit()
        return
    jt.fit()
    pt.fit()
    for tag in ("train_loss_avg", "val_loss_avg"):
        want = _logged(str(tmp_path / "jax"), tag)
        got = _logged(str(tmp_path / "port"), tag)
        assert sorted(got) == sorted(want) and want, tag
        for step in want:
            assert got[step] == pytest.approx(want[step], rel=LOSS_TOL)
    want = _logged(str(tmp_path / "jax"), "val_eval_score_avg")
    got = _logged(str(tmp_path / "port"), "val_eval_score_avg")
    assert want and got == pytest.approx(want, rel=1e-12)

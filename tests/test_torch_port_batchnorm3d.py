"""BatchNorm layer orders ('b') of the port's 3D family against flax's
``nn.BatchNorm`` in the JAX package's ``SingleConv`` (momentum 0.9, eps
1e-5, batch statistics in training mode, running statistics in eval mode),
with the flax ``params`` and ``batch_stats`` carried across by the
parameter bridge; and the 3D trainer carrying ``batch_stats`` through its
checkpoints.

Tolerances (float32 on the CPU): outputs and running statistics within
1e-5 of max |value|, loss within 1e-5 relative."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mdeical_image_segmentation_tpu.models import get_model as jax_get_model
from mdeical_image_segmentation_tpu_torch import logging_utils
from mdeical_image_segmentation_tpu_torch.losses import get_loss_criterion
from mdeical_image_segmentation_tpu_torch.metrics import (
    get_evaluation_metric,
)
from mdeical_image_segmentation_tpu_torch.models import get_model
from mdeical_image_segmentation_tpu_torch.train import checkpoint as ckpt
from mdeical_image_segmentation_tpu_torch.train import optimizers, trainer3d
from mdeical_image_segmentation_tpu_torch.utils.param_bridge import (
    flax_to_state_dict,
    state_dict_to_flax,
)

TOL = 1e-5


def _cfg(order, name="UNet3D"):
    return {"name": name, "in_channels": 1, "out_channels": 1, "f_maps": 8,
            "num_levels": 2, "layer_order": order}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, dict(tree))


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _stats_equal(sd, want_stats):
    got = state_dict_to_flax(sd)["batch_stats"]
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want_stats))
    assert sorted(map(str, flat_got)) == sorted(map(str, flat_want))
    for k, w in flat_want.items():
        _close(np.asarray(flat_got[k]), np.asarray(w), str(k))


@pytest.mark.parametrize("order", ["bcr", "cbr", "cbe"])
def test_train_forward_stats_and_eval_match_flax(order):
    """One training forward from flax's initial variables: the logits and
    the updated ``batch_stats``; then the eval forward with those
    statistics, which leaves them alone."""
    cfg = _cfg(order)
    rng = np.random.default_rng(len(order))
    x = (2 * rng.standard_normal((2, 8, 16, 12, 1)) + 1).astype(np.float32)
    jm = jax_get_model(cfg)
    variables = _np(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), False))
    assert variables.get("batch_stats")
    model = get_model(cfg)
    model.load_state_dict(flax_to_state_dict(variables))

    y_jax, upd = jm.apply(variables, jnp.asarray(x), True,
                          mutable=["batch_stats"])
    model.train()
    with torch.no_grad():
        y = model(torch.from_numpy(x)).numpy()
    _close(y, np.asarray(y_jax), "train forward")
    new_stats = _np(upd["batch_stats"])
    _stats_equal(model.state_dict(), new_stats)

    model.eval()
    y_eval_jax = np.asarray(jm.apply({"params": variables["params"],
                                      "batch_stats": new_stats},
                                     jnp.asarray(x), False))
    with torch.no_grad():
        y_eval = model(torch.from_numpy(x)).numpy()
    _close(y_eval, y_eval_jax, "eval forward")
    _stats_equal(model.state_dict(), new_stats)


@pytest.mark.parametrize("name", ["UNet3D", "ResidualUNet3D", "UNet2D"])
def test_batch_stats_after_one_training_step(name):
    """A BCEDice step's forward updates the running statistics once, as the
    JAX step's ``mutable=['batch_stats']`` does, and the loss agrees."""
    from mdeical_image_segmentation_tpu.losses import losses3d as jax_losses

    cfg = _cfg("cbr", name)
    spatial = (8, 16, 16) if name != "UNet2D" else (16, 16)
    rng = np.random.default_rng(7)
    x = rng.random((2, *spatial, 1)).astype(np.float32)
    t = (x > 0.5).astype(np.float32)
    jm = jax_get_model(cfg)
    variables = _np(jm.init(jax.random.PRNGKey(2), jnp.asarray(x), False))

    def loss_fn(p):
        out, upd = jm.apply({"params": p,
                             "batch_stats": variables["batch_stats"]},
                            jnp.asarray(x), True, mutable=["batch_stats"])
        return jax_losses.BCEDiceLoss()(out, jnp.asarray(t)), upd

    (want_loss, upd), _ = jax.value_and_grad(loss_fn, has_aux=True)(
        variables["params"])
    model = get_model(cfg)
    model.load_state_dict(flax_to_state_dict(variables))
    model.train()
    loss = get_loss_criterion({"loss": {"name": "BCEDiceLoss"}})(
        model(torch.from_numpy(x)), torch.from_numpy(t))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=TOL)
    _stats_equal(model.state_dict(), _np(upd["batch_stats"]))


def test_trainer_checkpoints_carry_batch_stats(tmp_path):
    """The 3D trainer writes the running statistics as ``batch_stats`` and a
    ``pre_trained`` / ``resume`` load restores them bit for bit."""
    cfg = {"model": _cfg("bcr"), "loss": {"name": "BCEDiceLoss"},
           "eval_metric": {"name": "MeanIoU"},
           "optimizer": {"name": "Adam", "learning_rate": 1e-3}}
    rng = np.random.default_rng(0)
    batches = [(x, (x > 0.5).astype(np.float32)) for x in
               (rng.random((2, 8, 16, 16, 1)).astype(np.float32)
                for _ in range(2))]

    def make(run_dir, **kw):
        model = get_model(cfg["model"],
                          generator=torch.Generator().manual_seed(0))
        return trainer3d.UNetTrainer(
            model=model,
            optimizer=optimizers.create_optimizer(cfg["optimizer"],
                                                  model.parameters()),
            lr_scheduler=None, loss_criterion=get_loss_criterion(cfg),
            eval_criterion=get_evaluation_metric(cfg),
            loaders={"train": batches, "val": batches[:1]},
            checkpoint_dir=run_dir, max_num_epochs=1, max_num_iterations=2,
            validate_after_iters=2, log_after_iters=100,
            tensorboard_formatter=logging_utils.TensorboardFormatter(), **kw)

    t = make(str(tmp_path / "a"))
    t.fit()
    saved = ckpt.load_checkpoint(str(tmp_path / "a" / ckpt.LAST_NAME))
    stats = saved["model_state_dict"]["batch_stats"]
    assert stats and "BatchNorm_0" in stats["encoder0"]["basic_module"][
        "SingleConv1"]
    sd = t.model.state_dict()
    for key in ("pre_trained", "resume"):
        other = make(str(tmp_path / key),
                     **{key: str(tmp_path / "a" / ckpt.LAST_NAME)})
        for k, v in other.model.state_dict().items():
            assert torch.equal(v, sd[k]), (key, k)
    assert any("running_mean" in k for k in sd)


def test_register_unet3d_serves_a_batchnorm_checkpoint(tmp_path):
    """``register_unet3d`` loads the checkpoint's ``batch_stats`` (it
    refused them before) and serves with the running statistics."""
    from mdeical_image_segmentation_tpu_torch.serve.app import ModelRegistry

    cfg = _cfg("cbr")
    model = get_model(cfg, generator=torch.Generator().manual_seed(3))
    model.train()
    with torch.no_grad():  # move the running statistics off their init
        model(torch.rand(2, 8, 16, 16, 1))
    path = ckpt.save_checkpoint(
        {"model_state_dict": state_dict_to_flax(model.state_dict())}, False,
        str(tmp_path))
    registry = ModelRegistry()
    registry.register_unet3d("bn", path, cfg, resolution=16, device="cpu",
                             max_batch=1)
    entry = registry.get("bn")
    model.eval()
    x = np.random.default_rng(0).random((1, 16, 16, 1)).astype(np.float32)
    with torch.no_grad():
        x3 = torch.from_numpy(x)[:, None].expand(-1, 2, -1, -1, -1)
        want = torch.sigmoid(model(x3.contiguous())[:, 1]).numpy()
    np.testing.assert_allclose(entry.probs_forward(x), want, rtol=1e-6,
                               atol=1e-6)

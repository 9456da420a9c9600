"""The 2D members of the port's 3D family (``UNet2D``, ``ResidualUNet2D``:
``is3d`` False, (N, H, W, C), no fused path) against the JAX package's,
with the flax weights carried across by the parameter bridge; and the 3D
trainer and predictor squeezing the depth axis of their (N, 1, H, W, C)
batches for them, as the JAX package's do.

Tolerances (float32 on the CPU): logits within 1e-5 of max |y|, the
BCEDice loss within 1e-5 relative, and the gradients within 1e-5 relative
in L2 over all leaves."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mdeical_image_segmentation_tpu.losses import losses3d as jax_losses
from mdeical_image_segmentation_tpu.models import get_model as jax_get_model
from mdeical_image_segmentation_tpu_torch import logging_utils
from mdeical_image_segmentation_tpu_torch.infer.predictor import (
    StandardPredictor,
)
from mdeical_image_segmentation_tpu_torch.losses import get_loss_criterion
from mdeical_image_segmentation_tpu_torch.metrics import (
    get_evaluation_metric,
)
from mdeical_image_segmentation_tpu_torch.models import SingleConv, get_model
from mdeical_image_segmentation_tpu_torch.train import optimizers, trainer3d
from mdeical_image_segmentation_tpu_torch.utils.param_bridge import (
    flax_to_state_dict,
)

TOL = 1e-5


@pytest.mark.parametrize("order", ["gcr", "cr"])
@pytest.mark.parametrize("name,levels,channels", [
    ("UNet2D", 3, 1), ("ResidualUNet2D", 3, 2)])
def test_forward_and_step_match_jax(name, levels, channels, order):
    cfg = {"name": name, "in_channels": channels, "out_channels": 2,
           "f_maps": 8, "num_levels": levels, "layer_order": order}
    rng = np.random.default_rng(levels + len(order))
    # odd sizes: floor pooling and the nearest / deconv resizes
    x = (rng.standard_normal((2, 22, 18, channels)) + 0.5).astype(
        np.float32)
    t = (rng.random((2, 22, 18, 2)) > 0.5).astype(np.float32)
    jm = jax_get_model(cfg)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), False)["params"]
    y_jax = np.asarray(jm.apply({"params": params}, jnp.asarray(x), False))
    loss = jax_losses.BCEDiceLoss()
    want_loss, want = jax.value_and_grad(
        lambda p: loss(jm.apply({"params": p}, jnp.asarray(x), True),
                       jnp.asarray(t)))(params)

    model = get_model(cfg)
    assert not model.is3d
    assert not any(m.fused for m in model.modules()
                   if isinstance(m, SingleConv))
    model.load_state_dict(flax_to_state_dict({"params": params}))
    with torch.no_grad():
        y = model(torch.from_numpy(x)).numpy()
    assert y.shape == y_jax.shape == (2, 22, 18, 2)
    np.testing.assert_allclose(y, y_jax, rtol=0,
                               atol=TOL * np.abs(y_jax).max())
    model.train()
    got = get_loss_criterion({"loss": {"name": "BCEDiceLoss"}})(
        model(torch.from_numpy(x)), torch.from_numpy(t))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want_loss), rtol=TOL)
    want = flax_to_state_dict({"params": want})
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert sorted(grads) == sorted(want)
    num = sum(float(((grads[n] - w) ** 2).sum()) for n, w in want.items())
    den = sum(float((w ** 2).sum()) for w in want.values())
    assert (num / den) ** 0.5 < TOL


CFG = {"name": "UNet2D", "in_channels": 1, "out_channels": 1, "f_maps": 8,
       "num_levels": 2, "final_sigmoid": True}


def test_trainer_squeezes_the_depth_axis(tmp_path):
    """(N, 1, H, W, C) batches train a 2D model; the loss is the 2D model's
    on the squeezed batch."""
    rng = np.random.default_rng(0)
    x = rng.random((2, 1, 16, 16, 1)).astype(np.float32)
    batches = [(x, (x > 0.5).astype(np.float32))]
    cfg = {"loss": {"name": "BCEDiceLoss"}, "eval_metric": {"name": "MeanIoU"}}
    model = get_model(CFG, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want = get_loss_criterion(cfg)(
            model(torch.from_numpy(x[:, 0])).unsqueeze(1),
            torch.from_numpy(batches[0][1])).item()
    t = trainer3d.UNetTrainer(
        model=model,
        optimizer=optimizers.create_optimizer(
            {"name": "Adam", "learning_rate": 1e-3}, model.parameters()),
        lr_scheduler=None, loss_criterion=get_loss_criterion(cfg),
        eval_criterion=get_evaluation_metric(cfg),
        loaders={"train": batches, "val": batches},
        checkpoint_dir=str(tmp_path), max_num_epochs=1, max_num_iterations=1,
        validate_after_iters=1, log_after_iters=1,
        tensorboard_formatter=logging_utils.TensorboardFormatter())
    losses = []
    orig = t._train_step
    t._train_step = lambda *a: (lambda r: (losses.append(r[0].item()), r)[1])(
        orig(*a))
    t.fit()
    assert len(losses) == 1
    np.testing.assert_allclose(losses[0], want, rtol=1e-6)


def test_predictor_squeezes_the_depth_axis():
    model = get_model(CFG, generator=torch.Generator().manual_seed(1))
    pred = StandardPredictor(model, None, 1, device="cpu")
    x = torch.rand(2, 1, 16, 16, 1)
    out, n = pred._predict_batch_device(x)
    assert n == 2 and out.shape == (2, 1, 16, 16, 1)
    with torch.no_grad():
        want = model(x[:, 0])
    assert torch.equal(out[:, 0], want)
    tta = StandardPredictor(model, None, 1, device="cpu", tta="mirror")
    out_tta, _ = tta._predict_batch_device(x)
    with torch.no_grad():
        flips = [model(x[:, 0].flip(dims)).flip(dims) for dims in
                 ((), (1,), (2,), (1, 2))]
    torch.testing.assert_close(out_tta[:, 0], sum(flips) / 4)

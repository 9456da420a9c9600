"""The port's SSIM / MS-SSIM and the hybrid UNet-3+ loss against the JAX
package's, values and gradients, in float32 at 176² (the smallest size the
5-level MS-SSIM takes), 177×190 (odd sizes: the ``s % 2`` pad at every
level) and 256².  Values agree within 1e-5 relative (VALUE_TOL), gradients
within 1e-4 of their max |value| (GRAD_TOL): the same arithmetic in
another summation order.  Also the ReLU on ``cs``, the size guard, and the
3D registry's ``SegmentationLoss`` wrapper."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mdeical_image_segmentation_tpu.losses import losses2d as jax_losses
from mdeical_image_segmentation_tpu.losses import losses3d as jax_losses3d
from mdeical_image_segmentation_tpu.ops import msssim as jax_msssim
from mdeical_image_segmentation_tpu_torch.losses import losses2d, losses3d
from mdeical_image_segmentation_tpu_torch.ops import msssim

VALUE_TOL = 1e-5
GRAD_TOL = 1e-4
SIZES = [(176, 176), (177, 190), (256, 256)]


def _pair(hw, channels=1, seed=0):
    """(logits, binary targets) of a smooth random field, NHWC, float32."""
    rng = np.random.default_rng(seed)
    h, w = hw
    logits = rng.standard_normal((2, h // 8 + 1, w // 8 + 1, channels))
    logits = np.repeat(np.repeat(logits, 8, 1), 8, 2)[:, :h, :w]
    logits = (logits + 0.5 * rng.standard_normal((2, h, w, channels)))
    targets = (rng.random((2, h, w, channels)) < 0.3 + 0.4 * (logits > 0))
    return logits.astype(np.float32), targets.astype(np.float32)


def _check(jax_fn, port_fn, *arrays):
    """Value and gradient in the first argument, both packages."""
    want, jgrad = jax.jit(jax.value_and_grad(jax_fn))(
        *map(jnp.asarray, arrays))
    t = [torch.from_numpy(a) for a in arrays]
    t[0].requires_grad_()
    got = port_fn(*t)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want),
                               rtol=VALUE_TOL)
    jgrad = np.asarray(jgrad)
    err = np.abs(t[0].grad.numpy() - jgrad).max() / np.abs(jgrad).max()
    assert err <= GRAD_TOL, err


@pytest.mark.parametrize("hw", SIZES)
def test_ms_ssim_matches_jax(hw):
    x, y = _pair(hw, channels=3)
    x = 1.0 / (1.0 + np.exp(-x))
    _check(lambda a, b: jax_msssim.ms_ssim(a, b),
           lambda a, b: msssim.ms_ssim(a, b), x, y)


@pytest.mark.parametrize("hw", [(64, 64), (177, 190)])
def test_ssim_matches_jax(hw):
    x, y = _pair(hw, channels=2, seed=1)
    x = 1.0 / (1.0 + np.exp(-x))
    _check(lambda a, b: jax_msssim.ssim(a, b),
           lambda a, b: msssim.ssim(a, b), x, y)
    per_image = msssim.ssim(torch.from_numpy(x), torch.from_numpy(y),
                            size_average=False)
    want = np.asarray(jax_msssim.ssim(jnp.asarray(x), jnp.asarray(y),
                                      size_average=False))
    assert per_image.shape == want.shape == (2, 2)
    np.testing.assert_allclose(per_image.numpy(), want, rtol=VALUE_TOL)


@pytest.mark.parametrize("hw", SIZES)
@pytest.mark.parametrize("name", ["segmentation_loss", "msssim_loss",
                                  "f1_loss", "iou_loss"])
def test_losses_match_jax(name, hw):
    logits, targets = _pair(hw, seed=2)
    _check(getattr(jax_losses, name), getattr(losses2d, name), logits,
           targets)


def test_cs_is_relud():
    """Anti-correlated images give a negative contrast term at the first
    levels, which the ReLU clamps to 0 (and so MS-SSIM to 0) in both."""
    x, _ = _pair((176, 176), seed=3)
    x = 1.0 / (1.0 + np.exp(-x))
    y = 1.0 - x
    want = float(jax_msssim.ms_ssim(jnp.asarray(x), jnp.asarray(y)))
    got = float(msssim.ms_ssim(torch.from_numpy(x), torch.from_numpy(y)))
    assert want == 0.0 and got == 0.0


def test_size_guard():
    x = torch.zeros(1, 160, 300, 1)
    with pytest.raises(ValueError, match="too small"):
        msssim.ms_ssim(x, x)
    with pytest.raises(ValueError, match="too small"):
        jax_msssim.ms_ssim(jnp.zeros((1, 160, 300, 1)),
                           jnp.zeros((1, 160, 300, 1)))
    msssim.ms_ssim(torch.zeros(1, 161, 161, 1), torch.zeros(1, 161, 161, 1))


def test_segmentation_loss_in_the_3d_registry():
    """``SegmentationLoss`` squeezes a singleton depth axis of (N, 1, H, W,
    C) inputs, as the JAX wrapper does, and refuses a deeper volume."""
    logits, targets = _pair((176, 176), seed=4)
    crit = losses3d.get_loss_criterion({"loss": {"name": "SegmentationLoss"}})
    assert isinstance(crit, losses3d.SegmentationLoss)
    jcrit = jax_losses3d.get_loss_criterion(
        {"loss": {"name": "SegmentationLoss"}})
    _check(lambda a, b: jcrit(a, b), lambda a, b: crit(a, b),
           logits[:, None], targets[:, None])
    _check(lambda a, b: jcrit(a, b), lambda a, b: crit(a, b),
           logits, targets)
    with pytest.raises(ValueError, match="depth-2"):
        crit(torch.zeros(1, 2, 176, 176, 1), torch.zeros(1, 2, 176, 176, 1))

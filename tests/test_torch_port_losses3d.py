"""The port's 3D losses (``mdeical_image_segmentation_tpu_torch.losses.
losses3d``) and ``expand_as_one_hot`` against the JAX package's, on the
same numpy inputs from a fixed seed, through ``get_loss_criterion`` with
the same configs.

Tolerance: float32 values within rtol = atol = 1e-5 (the same sums in other
orders); gradients with respect to the input within 1e-5 of their max
|value|."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mdeical_image_segmentation_tpu.losses import losses3d as jax_losses
from mdeical_image_segmentation_tpu.utils.onehot import (
    expand_as_one_hot as jax_one_hot,
)
from mdeical_image_segmentation_tpu_torch.losses import losses3d
from mdeical_image_segmentation_tpu_torch.utils.onehot import (
    expand_as_one_hot,
)

TOL = 1e-5
SHAPE = (2, 4, 6, 5)  # (N, D, H, W); channels are appended


def _dense(c, seed, kind="logits"):
    rng = np.random.default_rng(seed)
    if kind == "logits":
        return (2 * rng.standard_normal(SHAPE + (c,))).astype(np.float32)
    if kind == "binary":
        return (rng.random(SHAPE + (c,)) > 0.6).astype(np.float32)
    return rng.random(SHAPE + (c,)).astype(np.float32)


def _labels(c, seed, ignore=None):
    rng = np.random.default_rng(seed)
    t = rng.integers(0, c, SHAPE)
    if ignore is not None:
        t = np.where(rng.random(SHAPE) < 0.2, ignore, t)
    return t.astype(np.int64)


# (loss config, channels, target kind, extra weights?)
CASES = {
    "bce": ({"name": "BCEWithLogitsLoss"}, 1, "binary"),
    "bce_pos_weight": ({"name": "BCEWithLogitsLoss", "pos_weight": [2.5]},
                       1, "binary"),
    "bce_dice": ({"name": "BCEDiceLoss", "alpha": 0.7, "beta": 1.3}, 2,
                 "binary"),
    "dice_sigmoid": ({"name": "DiceLoss"}, 3, "binary"),
    "dice_softmax_weight": ({"name": "DiceLoss", "normalization": "softmax",
                             "weight": [0.2, 0.3, 0.5]}, 3, "binary"),
    "dice_none": ({"name": "DiceLoss", "normalization": "none"}, 2, "prob"),
    "gdl_one_channel": ({"name": "GeneralizedDiceLoss"}, 1, "binary"),
    "gdl_softmax": ({"name": "GeneralizedDiceLoss",
                     "normalization": "softmax"}, 3, "binary"),
    "ce": ({"name": "CrossEntropyLoss"}, 4, "labels"),
    "ce_weight_ignore": ({"name": "CrossEntropyLoss", "weight":
                          [0.1, 0.2, 0.3, 0.4], "ignore_index": 7}, 4,
                         "labels_ignore"),
    "wce": ({"name": "WeightedCrossEntropyLoss"}, 3, "labels"),
    "pixelwise_ce": ({"name": "PixelWiseCrossEntropyLoss"}, 3, "pixelwise"),
    # built directly: through the config, ignore_index also adds the
    # MaskingLossWrapper, which takes no weights (in both packages)
    "pixelwise_ce_ignore": (None, 3, "pixelwise_ignore"),
    "mse": ({"name": "MSELoss"}, 2, "prob"),
    "l1": ({"name": "L1Loss"}, 2, "prob"),
    "smooth_l1": ({"name": "SmoothL1Loss"}, 2, "prob"),
    "weighted_smooth_l1": ({"name": "WeightedSmoothL1Loss", "threshold": 0.4,
                            "initial_weight": 3.0}, 2, "prob"),
    "weighted_smooth_l1_above": ({"name": "WeightedSmoothL1Loss",
                                  "threshold": 0.4, "initial_weight": 3.0,
                                  "apply_below_threshold": False}, 2, "prob"),
    "masking_wrapper": ({"name": "DiceLoss", "ignore_index": -1}, 2,
                        "binary_ignore"),
    "skip_last_target": ({"name": "BCEWithLogitsLoss",
                          "skip_last_target": True}, 1, "binary_extra"),
}


def _case_arrays(key):
    cfg, c, kind = CASES[key]
    seed = len(key)
    x = _dense(c, seed)
    extra = ()
    if kind == "binary":
        t = _dense(c, seed + 1, "binary")
    elif kind == "binary_ignore":
        t = _dense(c, seed + 1, "binary")
        t = np.where(_dense(c, seed + 2, "prob") < 0.2, -1.0, t)
    elif kind == "binary_extra":
        t = _dense(c + 1, seed + 1, "binary")
    elif kind == "prob":
        x = _dense(c, seed, "prob")
        t = _dense(c, seed + 1, "prob")
    elif kind in ("labels", "labels_ignore"):
        t = _labels(c, seed + 1, 7 if kind == "labels_ignore" else None)
    else:  # pixelwise
        t = _labels(c, seed + 1, 7 if kind == "pixelwise_ignore" else None)
        extra = (np.random.default_rng(seed).random(SHAPE)
                 .astype(np.float32),)
    return cfg, x, t, extra


@pytest.mark.parametrize("key", sorted(CASES))
def test_loss_and_input_grad_match_jax(key):
    cfg, x, t, extra = _case_arrays(key)
    if cfg is None:
        jax_loss = jax_losses.PixelWiseCrossEntropyLoss(ignore_index=7)
        port_loss = losses3d.PixelWiseCrossEntropyLoss(ignore_index=7)
    else:
        jax_loss = jax_losses.get_loss_criterion({"loss": dict(cfg)})
        port_loss = losses3d.get_loss_criterion({"loss": dict(cfg)})
    want, want_g = jax.value_and_grad(
        lambda a: jax_loss(a, jnp.asarray(t), *map(jnp.asarray, extra)))(
        jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    got = port_loss(tx, torch.from_numpy(t), *map(torch.from_numpy, extra))
    assert got.ndim == 0 and got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), rtol=TOL, atol=TOL)
    (got_g,) = torch.autograd.grad(got, tx)
    want_g = np.asarray(want_g)
    np.testing.assert_allclose(got_g.numpy(), want_g, rtol=0,
                               atol=TOL * max(np.abs(want_g).max(), 1e-12))


def test_wrappers_follow_the_jax_composition_rules():
    masked = losses3d.get_loss_criterion(
        {"loss": {"name": "DiceLoss", "ignore_index": -1}})
    assert isinstance(masked, losses3d.MaskingLossWrapper)
    ce = losses3d.get_loss_criterion(
        {"loss": {"name": "CrossEntropyLoss", "ignore_index": -1}})
    assert isinstance(ce, losses3d.CrossEntropyLoss)
    assert ce.ignore_index == -1
    assert losses3d.get_loss_criterion(
        {"loss": {"name": "CrossEntropyLoss"}}).ignore_index == -100
    skip = losses3d.get_loss_criterion(
        {"loss": {"name": "MSELoss", "skip_last_target": True}})
    assert isinstance(skip, losses3d.SkipLastTargetChannelWrapper)
    with pytest.raises(ValueError, match="singleton"):
        skip(torch.zeros(1, 2, 2, 2, 1), torch.zeros(1, 2, 2, 2, 1))
    bce_dice = losses3d.get_loss_criterion({"loss": {"name": "BCEDiceLoss"}})
    assert (bce_dice.alpha, bce_dice.beta) == (1.0, 1.0)


def test_unknown_and_unported_losses_raise():
    with pytest.raises(RuntimeError, match="Unsupported loss"):
        losses3d.get_loss_criterion({"loss": {"name": "FocalLoss"}})
    with pytest.raises(NotImplementedError, match="item 14"):
        losses3d.get_loss_criterion({"loss": {"name": "SegmentationLoss"}})
    with pytest.raises(KeyError, match="loss function"):
        losses3d.get_loss_criterion({})


@pytest.mark.parametrize("ignore", [None, -1, 2])
def test_expand_as_one_hot_matches_jax(ignore):
    t = _labels(4, 3, ignore)
    if ignore is not None and ignore >= 0:
        t = np.where(t == 3, ignore, t)
    want = np.asarray(jax_one_hot(jnp.asarray(t), 4, ignore_index=ignore))
    got = expand_as_one_hot(torch.from_numpy(t), 4, ignore_index=ignore)
    assert got.dtype == torch.float32 and got.shape == SHAPE + (4,)
    np.testing.assert_array_equal(got.numpy(), want)

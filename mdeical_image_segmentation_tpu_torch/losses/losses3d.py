"""Config-driven 3D loss registry (the JAX package's ``losses/losses3d.py``).

Dense inputs and targets are channels-last (N, *spatial, C); class-id
targets of the cross-entropy family are integer tensors (N, *spatial).
Every loss is a stateless callable ``loss(input, target)`` (or
``loss(input, target, weights)`` for ``PixelWiseCrossEntropyLoss``) that
returns a 0-d tensor and is differentiable in ``input``.

``get_loss_criterion(config)`` builds the loss from ``config['loss']`` with
the JAX package's defaults and wrapper rules: ``ignore_index`` wraps a
non-CE loss in ``MaskingLossWrapper``; ``skip_last_target`` adds
``SkipLastTargetChannelWrapper``.  ``SegmentationLoss`` is the 2D hybrid
F1 + MS-SSIM + IoU for 2D-variant models.

Under data parallelism (the batch's rows split over the ranks by
``parallel.rows_split``) the ratio losses are ratios of the global batch's
sums, as the JAX package computes them over its sharded batch: the Dice
family's per-channel sums and the weighted cross-entropy's numerator,
denominator and class volumes are all-reduced, differentiably, before the
ratio.  Per-element means (BCE, the pixel-wise CE, MSE, L1, smooth L1)
need nothing: with equal rows on every rank, DDP's average of the ranks'
gradients is the global mean's.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F

from ..parallel.mesh import global_sum
from .losses2d import segmentation_loss

Loss = Callable[..., torch.Tensor]


def _tensor(v) -> Optional[torch.Tensor]:
    return None if v is None else torch.as_tensor(v, dtype=torch.float32)


def flatten(x: torch.Tensor) -> torch.Tensor:
    """(N, *spatial, C) → (C, N · prod(spatial))."""
    return torch.movedim(x, -1, 0).reshape(x.shape[-1], -1)


def compute_per_channel_dice(probs: torch.Tensor, target: torch.Tensor,
                             epsilon: float = 1e-6,
                             weight: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """V-Net dice per channel with the squared denominator; ``probs`` are
    already normalized."""
    if probs.shape != target.shape:
        raise ValueError(f"probs {tuple(probs.shape)} and target "
                         f"{tuple(target.shape)} differ in shape")
    p = flatten(probs)
    t = flatten(target).float()
    intersect, pp, tt = global_sum(torch.stack(
        [(p * t).sum(-1), (p * p).sum(-1), (t * t).sum(-1)]))
    if weight is not None:
        intersect = weight.to(p.device) * intersect
    denominator = pp + tt
    return 2.0 * (intersect / torch.clamp(denominator, min=epsilon))


def _normalizer(normalization: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if normalization == "sigmoid":
        return torch.sigmoid
    if normalization == "softmax":
        return lambda x: torch.softmax(x, dim=-1)
    if normalization == "none":
        return lambda x: x
    raise ValueError(f"unknown normalization {normalization!r}")


class DiceLoss:
    """1 − mean per-channel V-Net dice."""

    def __init__(self, weight=None, normalization: str = "sigmoid"):
        self.weight = _tensor(weight)
        self.normalization = _normalizer(normalization)

    def __call__(self, input: torch.Tensor, target: torch.Tensor
                 ) -> torch.Tensor:
        probs = self.normalization(input)
        return 1.0 - compute_per_channel_dice(probs, target,
                                              weight=self.weight).mean()


class GeneralizedDiceLoss:
    """GDL with inverse-square-volume class weights; a 1-channel input
    expands to foreground and background."""

    def __init__(self, normalization: str = "sigmoid", epsilon: float = 1e-6):
        self.normalization = _normalizer(normalization)
        self.epsilon = epsilon

    def __call__(self, input: torch.Tensor, target: torch.Tensor
                 ) -> torch.Tensor:
        if input.shape != target.shape:
            raise ValueError("input and target differ in shape")
        p = flatten(self.normalization(input))
        t = flatten(target).float()
        if p.shape[0] == 1:
            p = torch.cat([p, 1.0 - p], dim=0)
            t = torch.cat([t, 1.0 - t], dim=0)
        ts, pt, p_t = global_sum(torch.stack(
            [t.sum(-1), (p * t).sum(-1), (p + t).sum(-1)]))
        w = (1.0 / torch.clamp(ts.square(), min=self.epsilon)).detach()
        intersect = (pt * w).sum()
        denominator = torch.clamp(p_t * w, min=self.epsilon).sum()
        return 1.0 - 2.0 * intersect / denominator


class BCEWithLogitsLoss:
    """torch ``BCEWithLogitsLoss(pos_weight)``, mean reduction, written as
    the JAX package writes it (log-sigmoid of x and of −x)."""

    def __init__(self, pos_weight=None):
        self.pos_weight = _tensor(pos_weight)

    def __call__(self, input: torch.Tensor, target: torch.Tensor
                 ) -> torch.Tensor:
        x, t = input, target.to(input.dtype)
        log_sig = F.logsigmoid(x)
        log_one_minus = F.logsigmoid(-x)
        if self.pos_weight is not None:
            pw = self.pos_weight.to(x.device)
            loss = -(pw * t * log_sig + (1.0 - t) * log_one_minus)
        else:
            loss = -(t * log_sig + (1.0 - t) * log_one_minus)
        return loss.mean()


class BCEDiceLoss:
    """alpha · BCE + beta · Dice."""

    def __init__(self, alpha: float = 1.0, beta: float = 1.0):
        self.alpha = alpha
        self.beta = beta
        self.bce = BCEWithLogitsLoss()
        self.dice = DiceLoss()

    def __call__(self, input: torch.Tensor, target: torch.Tensor
                 ) -> torch.Tensor:
        return (self.alpha * self.bce(input, target)
                + self.beta * self.dice(input, target))


class CrossEntropyLoss:
    """torch ``CrossEntropyLoss(weight, ignore_index)`` on channels-last
    logits (N, *sp, C) and integer targets (N, *sp): the weighted mean over
    the elements not ignored."""

    def __init__(self, weight=None, ignore_index: int = -100):
        self.weight = _tensor(weight)
        self.ignore_index = ignore_index

    def __call__(self, input: torch.Tensor, target: torch.Tensor
                 ) -> torch.Tensor:
        logp = torch.log_softmax(input, dim=-1)
        t = target.long()
        valid = t != self.ignore_index
        safe_t = torch.where(valid, t, 0)
        picked = torch.gather(logp, -1, safe_t[..., None])[..., 0]
        if self.weight is not None:
            w = self.weight.to(input.device)[safe_t] * valid
        else:
            w = valid.to(input.dtype)
        num, den = global_sum(torch.stack([(picked * w).sum(), w.sum()]))
        return -num / torch.clamp(den, min=1e-12)


class WeightedCrossEntropyLoss:
    """CE with per-class weights (1 − p̂_c) / p̂_c from the softmax volume,
    detached."""

    def __init__(self, ignore_index: int = -1):
        self.ignore_index = ignore_index

    def __call__(self, input: torch.Tensor, target: torch.Tensor
                 ) -> torch.Tensor:
        probs = flatten(torch.softmax(input, dim=-1))
        neg, pos = global_sum(torch.stack(
            [(1.0 - probs).sum(-1), probs.sum(-1)]))
        class_weights = (neg / pos).detach()
        return CrossEntropyLoss(class_weights, self.ignore_index)(input,
                                                                  target)


class PixelWiseCrossEntropyLoss:
    """Per-voxel weighted CE with one-hot targets; ``weights`` has the
    target's shape (N, *sp)."""

    def __init__(self, ignore_index: Optional[int] = None):
        self.ignore_index = ignore_index

    def __call__(self, input: torch.Tensor, target: torch.Tensor,
                 weights: torch.Tensor) -> torch.Tensor:
        if target.shape != weights.shape:
            raise ValueError("target and weights differ in shape")
        logp = torch.log_softmax(input, dim=-1)
        t = target.long()
        if self.ignore_index is not None:
            mask = t == self.ignore_index
            t = torch.where(mask, 0, t)
        else:
            mask = torch.zeros_like(t, dtype=torch.bool)
        onehot = F.one_hot(t, input.shape[-1]).to(input.dtype)
        onehot = onehot * (~mask)[..., None]
        return (-weights[..., None] * onehot * logp).mean()


class MSELoss:
    def __call__(self, input, target):
        return (input - target).square().mean()


class L1Loss:
    def __call__(self, input, target):
        return (input - target).abs().mean()


def _smooth_l1(diff: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    a = diff.abs()
    return torch.where(a < beta, 0.5 * a * a / beta, a - 0.5 * beta)


class SmoothL1Loss:
    def __call__(self, input, target):
        return _smooth_l1(input - target).mean()


class WeightedSmoothL1Loss:
    """Smooth-L1 scaled by ``initial_weight`` below (or above) a target
    threshold."""

    def __init__(self, threshold: float, initial_weight: float,
                 apply_below_threshold: bool = True):
        self.threshold = threshold
        self.weight = initial_weight
        self.apply_below_threshold = apply_below_threshold

    def __call__(self, input, target):
        l1 = _smooth_l1(input - target)
        if self.apply_below_threshold:
            mask = target < self.threshold
        else:
            mask = target >= self.threshold
        return torch.where(mask, l1 * self.weight, l1).mean()


class MaskingLossWrapper:
    """Zero input and target where the target is ``ignore_index``."""

    def __init__(self, loss: Loss, ignore_index: int):
        if ignore_index is None:
            raise ValueError("ignore_index cannot be None")
        self.loss = loss
        self.ignore_index = ignore_index

    def __call__(self, input, target):
        mask = (target != self.ignore_index).to(input.dtype)
        return self.loss(input * mask, target * mask)


class SkipLastTargetChannelWrapper:
    """Drop the last target channel before the loss."""

    def __init__(self, loss: Loss, squeeze_channel: bool = False):
        self.loss = loss
        self.squeeze_channel = squeeze_channel

    def __call__(self, input, target, weight=None):
        if target.shape[-1] <= 1:
            raise ValueError("Target tensor has a singleton channel "
                             "dimension, cannot remove channel")
        target = target[..., :-1]
        if self.squeeze_channel:
            target = target.squeeze(-1)
        if weight is not None:
            return self.loss(input, target, weight)
        return self.loss(input, target)


class SegmentationLoss:
    """The 2D hybrid F1 + MS-SSIM + IoU in the 3D registry, for 2D-variant
    models: a singleton depth axis of (N, 1, H, W, C) inputs and targets is
    squeezed out before the planar MS-SSIM; a deeper volume raises."""

    def __call__(self, input, target):
        if input.ndim == 5:
            if input.shape[1] != 1:
                raise ValueError(
                    "SegmentationLoss is 2D (F1 + MS-SSIM + IoU); got a "
                    f"depth-{input.shape[1]} volume — use a 2D-variant "
                    "model (UNet2D/ResidualUNet2D) or a volumetric loss")
            input = input.squeeze(1)
        if target.ndim == 5:
            target = target.squeeze(1)
        return segmentation_loss(input, target)


def _create_loss(name: str, loss_config: Dict[str, Any], weight,
                 ignore_index, pos_weight) -> Loss:
    if name == "BCEWithLogitsLoss":
        return BCEWithLogitsLoss(pos_weight=pos_weight)
    if name == "BCEDiceLoss":
        return BCEDiceLoss(alpha=loss_config.get("alpha", 1.0),
                           beta=loss_config.get("beta", 1.0))
    if name == "CrossEntropyLoss":
        return CrossEntropyLoss(
            weight=weight,
            ignore_index=ignore_index if ignore_index is not None else -100)
    if name == "WeightedCrossEntropyLoss":
        return WeightedCrossEntropyLoss(
            ignore_index=ignore_index if ignore_index is not None else -100)
    if name == "PixelWiseCrossEntropyLoss":
        return PixelWiseCrossEntropyLoss(ignore_index=ignore_index)
    if name == "GeneralizedDiceLoss":
        return GeneralizedDiceLoss(
            normalization=loss_config.get("normalization", "sigmoid"))
    if name == "DiceLoss":
        return DiceLoss(weight=weight, normalization=loss_config.get(
            "normalization", "sigmoid"))
    if name == "MSELoss":
        return MSELoss()
    if name == "SmoothL1Loss":
        return SmoothL1Loss()
    if name == "L1Loss":
        return L1Loss()
    if name == "WeightedSmoothL1Loss":
        return WeightedSmoothL1Loss(
            threshold=loss_config["threshold"],
            initial_weight=loss_config["initial_weight"],
            apply_below_threshold=loss_config.get("apply_below_threshold",
                                                  True))
    if name == "SegmentationLoss":
        return SegmentationLoss()
    raise RuntimeError(f"Unsupported loss function: '{name}'")


def get_loss_criterion(config: Dict[str, Any]) -> Loss:
    """The loss of ``config['loss']``, with the wrappers its keys ask for."""
    if "loss" not in config:
        raise KeyError("Could not find loss function configuration")
    loss_config = dict(config["loss"])
    name = loss_config.pop("name")
    ignore_index = loss_config.pop("ignore_index", None)
    skip_last_target = loss_config.pop("skip_last_target", False)
    weight = _tensor(loss_config.pop("weight", None))
    pos_weight = _tensor(loss_config.pop("pos_weight", None))

    loss = _create_loss(name, loss_config, weight, ignore_index, pos_weight)
    if not (ignore_index is None
            or name in ("CrossEntropyLoss", "WeightedCrossEntropyLoss")):
        loss = MaskingLossWrapper(loss, ignore_index)
    if skip_last_target:
        loss = SkipLastTargetChannelWrapper(
            loss, loss_config.get("squeeze_channel", False))
    return loss

"""Optimizer and LR-scheduler factories (the JAX package's
``train/optimizers.py``), on ``torch.optim``.

``create_optimizer(optimizer_config, params)`` takes the same config as the
JAX package (name, learning_rate, weight_decay, betas, momentum, nesterov).
The JAX package's Adam is ``chain(add_decayed_weights(wd), adam)``: weight
decay coupled as L2 (g += wd·p) before the moments, eps 1e-8 outside the
square root; that is ``torch.optim.Adam(weight_decay=wd)``.  AdamW is
decoupled in both (optax ``adamw``: p −= lr·(update + wd·p)); SGD is coupled
L2 plus optional (Nesterov) momentum in both.  An unknown name is Adam, as
in the JAX package.  The other ten names raise until they are ported.

The schedulers are the JAX package's host-side controllers with torch
``lr_scheduler`` semantics (``step()`` / ``step(metric)`` returns the new
rate); the trainer writes ``current_lr`` into the optimizer's param groups
with ``set_learning_rate`` before each step.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterable, Optional, Sequence

import torch

OPTIMIZERS_ITEM = "ROADMAP.md queue 1, item 8 (optimizers)"
NOT_PORTED = ("Adadelta", "Adagrad", "SparseAdam", "Adamax", "ASGD", "LBFGS",
              "NAdam", "RAdam", "RMSprop", "Rprop")


def create_optimizer(optimizer_config: Dict[str, Any],
                     params: Iterable[torch.nn.Parameter]
                     ) -> torch.optim.Optimizer:
    cfg = dict(optimizer_config)
    name = cfg.get("name", "Adam")
    learning_rate = cfg.get("learning_rate", 1e-3)
    weight_decay = cfg.get("weight_decay", 0.0)
    betas = tuple(cfg.get("betas", (0.9, 0.999)))
    if name in NOT_PORTED:
        raise NotImplementedError(f"optimizer {name!r} is not ported yet "
                                  f"({OPTIMIZERS_ITEM})")
    if name == "AdamW":
        return torch.optim.AdamW(params, lr=learning_rate, betas=betas,
                                 eps=1e-8, weight_decay=weight_decay)
    if name == "SGD":
        return torch.optim.SGD(params, lr=learning_rate,
                               momentum=cfg.get("momentum", 0) or 0.0,
                               nesterov=cfg.get("nesterov", False),
                               weight_decay=weight_decay)
    return torch.optim.Adam(params, lr=learning_rate, betas=betas, eps=1e-8,
                            weight_decay=weight_decay)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Write ``lr`` into every param group."""
    for group in optimizer.param_groups:
        group["lr"] = lr


def get_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


# ---------------------------------------------------------------------------
# LR schedulers (torch.optim.lr_scheduler semantics, host-side controllers)
# ---------------------------------------------------------------------------


class LRScheduler:
    """Base: tracks ``current_lr``; ``step()`` advances one scheduler epoch."""

    def __init__(self, base_lr: float):
        self.base_lr = base_lr
        self.current_lr = base_lr
        self.last_epoch = 0

    def step(self, metric: Optional[float] = None) -> float:
        self.last_epoch += 1
        self.current_lr = self._compute_lr()
        return self.current_lr

    def _compute_lr(self) -> float:
        return self.current_lr


class StepLR(LRScheduler):
    def __init__(self, base_lr, step_size: int, gamma: float = 0.1):
        super().__init__(base_lr)
        self.step_size = step_size
        self.gamma = gamma

    def _compute_lr(self):
        return self.base_lr * self.gamma ** (self.last_epoch // self.step_size)


class MultiStepLR(LRScheduler):
    def __init__(self, base_lr, milestones: Sequence[int], gamma: float = 0.1):
        super().__init__(base_lr)
        self.milestones = sorted(milestones)
        self.gamma = gamma

    def _compute_lr(self):
        n = sum(1 for m in self.milestones if m <= self.last_epoch)
        return self.base_lr * self.gamma ** n


class ExponentialLR(LRScheduler):
    def __init__(self, base_lr, gamma: float):
        super().__init__(base_lr)
        self.gamma = gamma

    def _compute_lr(self):
        return self.base_lr * self.gamma ** self.last_epoch


class CosineAnnealingLR(LRScheduler):
    def __init__(self, base_lr, T_max: int, eta_min: float = 0.0):
        super().__init__(base_lr)
        self.T_max = T_max
        self.eta_min = eta_min

    def _compute_lr(self):
        return self.eta_min + 0.5 * (self.base_lr - self.eta_min) * (
            1 + math.cos(math.pi * self.last_epoch / self.T_max))


class LambdaLR(LRScheduler):
    def __init__(self, base_lr, lr_lambda: Callable[[int], float]):
        super().__init__(base_lr)
        self.lr_lambda = lr_lambda

    def _compute_lr(self):
        return self.base_lr * self.lr_lambda(self.last_epoch)


class ReduceLROnPlateau(LRScheduler):
    """torch ``ReduceLROnPlateau``, stepped with the eval score after every
    validation."""

    def __init__(self, base_lr, mode: str = "min", factor: float = 0.1,
                 patience: int = 10, threshold: float = 1e-4,
                 threshold_mode: str = "rel", min_lr: float = 0.0,
                 cooldown: int = 0):
        super().__init__(base_lr)
        if mode not in ("min", "max"):
            raise ValueError(f"mode {mode!r}: 'min' or 'max'")
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.min_lr = min_lr
        self.cooldown = cooldown
        self.cooldown_counter = 0
        self.num_bad_epochs = 0
        self.best: Optional[float] = None

    def _is_better(self, metric: float) -> bool:
        # torch's _is_better, including its sign behaviour for negative
        # metrics: rel/min → metric < best·(1 − threshold); rel/max →
        # metric > best·(1 + threshold); abs → best ∓ threshold
        if self.best is None:
            return True
        if self.threshold_mode == "rel":
            if self.mode == "min":
                return metric < self.best * (1.0 - self.threshold)
            return metric > self.best * (1.0 + self.threshold)
        if self.mode == "min":
            return metric < self.best - self.threshold
        return metric > self.best + self.threshold

    def step(self, metric: Optional[float] = None) -> float:
        if metric is None:
            raise ValueError("ReduceLROnPlateau.step requires a metric")
        self.last_epoch += 1
        if self._is_better(metric):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        if self.num_bad_epochs > self.patience:
            self.current_lr = max(self.current_lr * self.factor, self.min_lr)
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0
        return self.current_lr


SCHEDULERS = {
    "StepLR": StepLR,
    "MultiStepLR": MultiStepLR,
    "ExponentialLR": ExponentialLR,
    "CosineAnnealingLR": CosineAnnealingLR,
    "LambdaLR": LambdaLR,
    "ReduceLROnPlateau": ReduceLROnPlateau,
}


def create_lr_scheduler(lr_config: Optional[Dict[str, Any]],
                        base_lr: float) -> Optional[LRScheduler]:
    """Name + keyword arguments → a scheduler; no config → None."""
    if lr_config is None:
        return None
    cfg = dict(lr_config)
    name = cfg.pop("name")
    try:
        cls = SCHEDULERS[name]
    except KeyError:
        raise RuntimeError(f"Unsupported lr scheduler: {name!r}") from None
    return cls(base_lr, **cfg)

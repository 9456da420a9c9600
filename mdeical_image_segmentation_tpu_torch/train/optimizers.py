"""Optimizer and LR-scheduler factories (the JAX package's
``train/optimizers.py``), with optax's update rules.

``create_optimizer(optimizer_config, params)`` takes the same config as the
JAX package (name, learning_rate, weight_decay, betas, momentum, nesterov,
rho, alpha, history_size) and gives the optimizer the JAX package builds
from it: the chain ``add_decayed_weights(wd)`` (L2 coupled into the
gradient, g += wd·p) before the named optax rule wherever the JAX package
puts it, then ``p += -lr·update``.  Where a ``torch.optim`` class computes
the same chain within float32 rounding (the tests hold each to optax), it
is used: Adam (also for "SparseAdam", which the JAX package maps to plain
Adam with no weight decay), AdamW (decoupled: p −= lr·(update + wd·p)), SGD
and "ASGD" (SGD with coupled L2; ASGD's averaging is not in the JAX
package).  Elsewhere optax's rule is written out below (``_OptaxRule``),
updating on the parameters' device:

- Adadelta: rho (0.9), eps 1e-6, the step scaled by the learning rate;
- Adagrad: the squares accumulated from 0.1, eps 1e-10 inside the
  reciprocal square root;
- Adamax, NAdam (optax's Nesterov Adam, not torch's momentum-decay NAdam)
  and RAdam (optax's threshold of 5 on the rectification term);
- RMSprop: decay ``alpha`` (0.99), eps 1e-8 outside the square root, no
  momentum; "Rprop" is RMSprop at decay 0.9 with the config's momentum as a
  trace of the rate-scaled steps, as the JAX package maps it.

LBFGS constructs (memory ``history_size``, default 100), and its first
step raises the ``TypeError`` optax's does there: the zoom line search
needs ``value``, ``grad`` and ``value_fn``, which the trainers do not pass.
An unknown name is Adam, as in the JAX package.

The schedulers are the JAX package's host-side controllers with torch
``lr_scheduler`` semantics (``step()`` / ``step(metric)`` returns the new
rate); the trainer writes ``current_lr`` into the optimizer's param groups
with ``set_learning_rate`` before each step.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterable, Optional, Sequence

import numpy as np
import torch


def create_optimizer(optimizer_config: Dict[str, Any],
                     params: Iterable[torch.nn.Parameter]
                     ) -> torch.optim.Optimizer:
    cfg = dict(optimizer_config)
    name = cfg.get("name", "Adam")
    learning_rate = cfg.get("learning_rate", 1e-3)
    weight_decay = cfg.get("weight_decay", 0.0)
    betas = tuple(cfg.get("betas", (0.9, 0.999)))
    momentum = cfg.get("momentum", 0) or 0.0
    if name == "AdamW":
        return torch.optim.AdamW(params, lr=learning_rate, betas=betas,
                                 eps=1e-8, weight_decay=weight_decay)
    if name in ("SGD", "ASGD"):
        return torch.optim.SGD(
            params, lr=learning_rate, weight_decay=weight_decay,
            momentum=momentum if name == "SGD" else 0.0,
            nesterov=cfg.get("nesterov", False) if name == "SGD" else False)
    if name == "SparseAdam":
        return torch.optim.Adam(params, lr=learning_rate, betas=betas,
                                eps=1e-8)
    if name == "Adadelta":
        return Adadelta(params, learning_rate, weight_decay,
                        rho=cfg.get("rho", 0.9))
    if name == "Adagrad":
        return Adagrad(params, learning_rate, weight_decay)
    if name in ("Adamax", "NAdam", "RAdam"):
        cls = {"Adamax": Adamax, "NAdam": NAdam, "RAdam": RAdam}[name]
        return cls(params, learning_rate, weight_decay, betas=betas)
    if name == "RMSprop":
        return RMSprop(params, learning_rate, weight_decay,
                       decay=cfg.get("alpha", 0.99))
    if name == "Rprop":
        return RMSprop(params, learning_rate, weight_decay, decay=0.9,
                       momentum=momentum)
    if name == "LBFGS":
        return LBFGS(params, learning_rate,
                     history_size=cfg.get("history_size", 100))
    return torch.optim.Adam(params, lr=learning_rate, betas=betas, eps=1e-8,
                            weight_decay=weight_decay)


def _f32(x: float) -> float:
    """``x`` rounded to float32, as optax's scalars are."""
    return float(np.float32(x))


def _pow32(base: float, count: int) -> np.float32:
    """base**count as JAX computes a float32 to an int32 power: binary
    exponentiation, each product rounded to float32."""
    x, acc = np.float32(base), np.float32(1)
    while count > 0:
        if count & 1:
            acc = acc * x
        count >>= 1
        x = x * x
    return acc


def _bias(decay: float, count: int) -> float:
    """1 − decay**count in float32 (optax's bias correction)."""
    return _f32(np.float32(1) - _pow32(decay, count))


class _OptaxRule(torch.optim.Optimizer):
    """An optax chain ``[add_decayed_weights(wd)], rule,
    scale_by_learning_rate``: per parameter, g += wd·p, then the rule's
    update u from its state, then p += u·(−lr).  ``state["step"]`` counts
    the updates (a float32 scalar on the CPU, as torch's own optimizers
    keep it), so bias corrections need no device sync."""

    def __init__(self, params, lr: float, weight_decay: float = 0.0,
                 **hyper):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay,
                                      **hyper))

    def _init(self, p: torch.Tensor, group) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def _rule(self, g, state, group, count: int) -> torch.Tensor:
        raise NotImplementedError

    def _scaled(self, u, state, group) -> torch.Tensor:
        return u * -group["lr"]

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if group["weight_decay"]:
                    g = g + p * group["weight_decay"]
                state = self.state[p]
                if not state:
                    state.update(self._init(p, group))
                    state["step"] = torch.tensor(0.0)
                state["step"] += 1
                u = self._rule(g, state, group, int(state["step"]))
                p.add_(self._scaled(u, state, group))
        return loss


class Adadelta(_OptaxRule):
    """optax ``scale_by_adadelta(rho, eps=1e-6)``."""

    def __init__(self, params, lr, weight_decay=0.0, rho=0.9, eps=1e-6):
        super().__init__(params, lr, weight_decay, rho=rho, eps=eps)

    def _init(self, p, group):
        return {"e_g": torch.zeros_like(p), "e_x": torch.zeros_like(p)}

    def _rule(self, g, state, group, count):
        rho, eps = group["rho"], group["eps"]
        state["e_g"] = g * g * (1 - rho) + state["e_g"] * rho
        u = (torch.sqrt(state["e_x"] + eps)
             / torch.sqrt(state["e_g"] + eps)) * g
        state["e_x"] = u * u * (1 - rho) + state["e_x"] * rho
        return u


class Adagrad(_OptaxRule):
    """optax ``scale_by_rss(initial_accumulator_value=0.1, eps=1e-10)``."""

    def __init__(self, params, lr, weight_decay=0.0, initial=0.1,
                 eps=1e-10):
        super().__init__(params, lr, weight_decay, initial=initial, eps=eps)

    def _init(self, p, group):
        return {"sum_of_squares": torch.full_like(p, group["initial"])}

    def _rule(self, g, state, group, count):
        s = g * g + state["sum_of_squares"]
        state["sum_of_squares"] = s
        return torch.where(s > 0, torch.rsqrt(s + group["eps"]),
                           torch.zeros_like(s)) * g


class _Moments(_OptaxRule):
    """Adam's moments: mu = (1 − b1)·g + b1·mu, nu = (1 − b2)·g² + b2·nu."""

    def __init__(self, params, lr, weight_decay=0.0, betas=(0.9, 0.999),
                 eps=1e-8):
        super().__init__(params, lr, weight_decay, betas=tuple(betas),
                         eps=eps)

    def _init(self, p, group):
        return {"mu": torch.zeros_like(p), "nu": torch.zeros_like(p)}

    def _moments(self, g, state, group):
        b1, b2 = group["betas"]
        state["mu"] = g * (1 - b1) + state["mu"] * b1
        state["nu"] = g * g * (1 - b2) + state["nu"] * b2
        return state["mu"], state["nu"]


class NAdam(_Moments):
    """optax ``scale_by_adam(nesterov=True)``: the bias-corrected look-ahead
    b1·mu/(1 − b1^(t+1)) + (1 − b1)·g/(1 − b1^t) over sqrt(nu/(1 − b2^t))
    + eps."""

    def _rule(self, g, state, group, count):
        b1, b2 = group["betas"]
        mu, nu = self._moments(g, state, group)
        mu_hat = (mu / _bias(b1, count + 1) * b1
                  + g / _bias(b1, count) * (1 - b1))
        return mu_hat / (torch.sqrt(nu / _bias(b2, count)) + group["eps"])


class RAdam(_Moments):
    """optax ``scale_by_radam(threshold=5)``: the rectified Adam step where
    the variance's degrees of freedom ro_t reach 5, else the bias-corrected
    first moment alone."""

    def _rule(self, g, state, group, count):
        b1, b2 = group["betas"]
        mu, nu = self._moments(g, state, group)
        mu_hat = mu / _bias(b1, count)
        # ro in float32, as optax computes it from its int32 count
        ro_inf = np.float32(2.0 / (1.0 - b2) - 1.0)
        b2t = _pow32(b2, count)
        ro = ro_inf - np.float32(2) * np.float32(count) * b2t / (
            np.float32(1) - b2t)
        if ro < 5.0:
            return mu_hat
        r = _f32(np.sqrt((ro - 4) * (ro - 2) * ro_inf
                         / ((ro_inf - 4) * (ro_inf - 2) * ro)))
        return mu_hat * r / (torch.sqrt(nu / _bias(b2, count))
                             + group["eps"])


class Adamax(_OptaxRule):
    """optax ``scale_by_adamax``: the first moment bias-corrected over the
    infinity moment max(|g| + eps, b2·nu)."""

    def __init__(self, params, lr, weight_decay=0.0, betas=(0.9, 0.999),
                 eps=1e-8):
        super().__init__(params, lr, weight_decay, betas=tuple(betas),
                         eps=eps)

    def _init(self, p, group):
        return {"mu": torch.zeros_like(p), "nu": torch.zeros_like(p)}

    def _rule(self, g, state, group, count):
        b1, b2 = group["betas"]
        state["mu"] = g * (1 - b1) + state["mu"] * b1
        state["nu"] = torch.maximum(torch.abs(g) + group["eps"],
                                    state["nu"] * b2)
        return state["mu"] / _bias(b1, count) / state["nu"]


class RMSprop(_OptaxRule):
    """optax ``rmsprop(decay, eps=1e-8, eps_in_sqrt=False, momentum)``:
    g / (sqrt(nu) + eps) with nu = (1 − decay)·g² + decay·nu, scaled by
    −lr, then with momentum the trace t = that + momentum·t is the
    update."""

    def __init__(self, params, lr, weight_decay=0.0, decay=0.99, eps=1e-8,
                 momentum=0.0):
        super().__init__(params, lr, weight_decay, decay=decay, eps=eps,
                         momentum=momentum)

    def _init(self, p, group):
        state = {"nu": torch.zeros_like(p)}
        if group["momentum"]:
            state["trace"] = torch.zeros_like(p)
        return state

    def _rule(self, g, state, group, count):
        decay = group["decay"]
        state["nu"] = g * g * (1 - decay) + state["nu"] * decay
        return 1 / (torch.sqrt(state["nu"]) + group["eps"]) * g

    def _scaled(self, u, state, group):
        u = u * -group["lr"]
        if group["momentum"]:
            state["trace"] = u + state["trace"] * group["momentum"]
            u = state["trace"]
        return u


class LBFGS(torch.optim.Optimizer):
    """optax ``lbfgs(learning_rate, memory_size=history_size)`` as the JAX
    trainers drive it: it holds its memory size, and a step raises the
    ``TypeError`` of optax's zoom line search, which needs the loss
    (``value``), its gradient (``grad``) and a loss function
    (``value_fn``) that the trainers' update does not pass."""

    def __init__(self, params, lr: float, history_size: int = 100):
        super().__init__(params, dict(lr=lr, history_size=history_size))

    def step(self, closure=None):
        raise TypeError(
            "LBFGS.step() missing 3 required keyword-only arguments: "
            "'value', 'grad', and 'value_fn' (the zoom line search "
            "evaluates the loss along the search direction; the trainers "
            "pass the gradient only, as the JAX package's do)")


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

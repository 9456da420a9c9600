"""The port's optimizers and LR schedulers (``mdeical_image_segmentation_
tpu_torch.train.optimizers``) against the JAX package's (optax and its
host-side schedulers), from the same configs.

Trajectories: the same parameters and the same gradient rule (g = a·p + b,
elementwise, computed from each side's own parameters) for 6 steps; the
parameters must stay within rtol = atol = 1e-6 of optax's (fp32, the same
update algebra in another operation order: torch divides by
sqrt(v)/sqrt(1 − β2^t) + eps, optax by sqrt(v / (1 − β2^t)) + eps, which
near a gradient's sign change, where m and v are small, moves an update of
1e-2 by up to ~2e-7).  Schedulers: the same
rate at every step, to 1e-12."""

import numpy as np
import optax
import pytest
import torch

import jax.numpy as jnp

from mdeical_image_segmentation_tpu.train import optimizers as jax_opt
from mdeical_image_segmentation_tpu_torch.train import optimizers

STEPS = 6


def _problem(seed):
    rng = np.random.default_rng(seed)
    p = {"w": rng.standard_normal((3, 4)).astype(np.float32),
         "b": rng.standard_normal(5).astype(np.float32)}
    a = {k: (0.5 + rng.random(v.shape)).astype(np.float32)
         for k, v in p.items()}
    b = {k: rng.standard_normal(v.shape).astype(np.float32)
         for k, v in p.items()}
    return p, a, b


@pytest.mark.parametrize("cfg", [
    {"name": "Adam", "learning_rate": 1e-2},
    {"name": "Adam", "learning_rate": 2e-4, "weight_decay": 1e-5},
    {"name": "Adam", "learning_rate": 5e-2, "weight_decay": 1e-1,
     "betas": [0.8, 0.99]},
    {"name": "AdamW", "learning_rate": 1e-2, "weight_decay": 1e-1},
    {"name": "SGD", "learning_rate": 1e-2},
    {"name": "SGD", "learning_rate": 1e-2, "momentum": 0.9,
     "weight_decay": 1e-2},
    {"name": "SGD", "learning_rate": 1e-2, "momentum": 0.9, "nesterov": True},
    {"name": "NotAnOptimizer", "learning_rate": 1e-2},  # Adam, as in JAX
    # 6 steps take RAdam past its threshold (ro_t >= 5 from step 6)
    {"name": "RAdam", "learning_rate": 1e-2},
    {"name": "NAdam", "learning_rate": 1e-2, "betas": [0.8, 0.99]},
    {"name": "Adamax", "learning_rate": 1e-2},
    {"name": "Adagrad", "learning_rate": 1e-1},
    {"name": "Adadelta", "learning_rate": 1.0, "rho": 0.8},
    {"name": "RMSprop", "learning_rate": 1e-2},
    {"name": "Rprop", "learning_rate": 1e-2, "momentum": 0.9},
    {"name": "SparseAdam", "learning_rate": 1e-2, "weight_decay": 1e-1},
    {"name": "ASGD", "learning_rate": 1e-2},
], ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items()))
def test_trajectory_matches_optax(cfg):
    p0, a, b = _problem(len(str(cfg)))
    tx = jax_opt.create_optimizer(cfg)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in p0.items()}
    opt = optimizers.create_optimizer(cfg, list(tp.values()))
    for step in range(STEPS):
        grads = {k: a[k] * jp[k] + b[k] for k in jp}
        updates, state = tx.update(grads, state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, t in tp.items():
            t.grad = torch.from_numpy(a[k]) * t.detach() + torch.from_numpy(
                b[k])
        opt.step()
        for k in jp:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-6, err_msg=f"{k} step {step}")


def test_learning_rate_is_set_per_step():
    """The trainer writes the scheduler's rate before each step: the JAX
    package into the injected hyperparams, the port into the param
    groups."""
    p = torch.nn.Parameter(torch.ones(3))
    opt = optimizers.create_optimizer({"name": "SGD", "learning_rate": 0.1},
                                      [p])
    assert optimizers.get_learning_rate(opt) == 0.1
    optimizers.set_learning_rate(opt, 0.5)
    p.grad = torch.ones(3)
    opt.step()
    torch.testing.assert_close(p.detach(), torch.full((3,), 0.5))
    assert optimizers.get_learning_rate(opt) == 0.5


# each of the ten names with weight decay and its own knobs
TEN = {
    "Adadelta": {"rho": 0.85},
    "Adagrad": {},
    "SparseAdam": {"betas": [0.85, 0.995]},
    "Adamax": {"betas": [0.85, 0.995]},
    "ASGD": {},
    "LBFGS": {"history_size": 7},
    "NAdam": {"betas": [0.85, 0.995]},
    "RAdam": {"betas": [0.85, 0.995]},
    "RMSprop": {"alpha": 0.95},
    "Rprop": {"momentum": 0.5},
}


@pytest.mark.parametrize("name", list(TEN))
def test_unported_optimizers_raise_naming_item_8(name):
    """Each of the ten names the JAX package builds, 3 steps with weight
    decay (coupled L2 where the JAX package chains it; SparseAdam takes
    none there) against its optax chain, within 1e-6 relative; LBFGS
    raises optax's TypeError at step 1 in both."""
    cfg = {"name": name, "learning_rate": 3e-2, "weight_decay": 5e-2,
           **TEN[name]}
    p0, a, b = _problem(7)
    tx = jax_opt.create_optimizer(cfg)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in p0.items()}
    opt = optimizers.create_optimizer(cfg, list(tp.values()))
    assert opt.defaults["lr"] == 3e-2
    for step in range(3):
        grads = {k: a[k] * jp[k] + b[k] for k in jp}
        for k, t in tp.items():
            t.grad = torch.from_numpy(a[k]) * t.detach() + torch.from_numpy(
                b[k])
        if name == "LBFGS":
            assert opt.defaults["history_size"] == 7
            with pytest.raises(TypeError, match="'value', 'grad', and "
                               "'value_fn'"):
                tx.update(grads, state, jp)
            with pytest.raises(TypeError, match="'value', 'grad', and "
                               "'value_fn'"):
                opt.step()
            return
        updates, state = tx.update(grads, state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.step()
        for k in jp:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-6, err_msg=f"{k} step {step}")


def _metric(i):
    # rises, stalls, dips, rises again: exercises best / bad-epoch counting
    return [0.1, 0.2, 0.2, 0.19, 0.2, 0.2, 0.3, 0.3, 0.3, 0.29, 0.1,
            0.1, 0.1, 0.1, 0.1, 0.5, 0.5, 0.5, 0.5, 0.5, -0.2, -0.2,
            -0.1, -0.3, -0.3][i % 25]


@pytest.mark.parametrize("cfg", [
    {"name": "StepLR", "step_size": 3, "gamma": 0.5},
    {"name": "MultiStepLR", "milestones": [7, 2, 11], "gamma": 0.3},
    {"name": "ExponentialLR", "gamma": 0.9},
    {"name": "CosineAnnealingLR", "T_max": 10, "eta_min": 1e-5},
    {"name": "ReduceLROnPlateau", "mode": "max", "factor": 0.5,
     "patience": 2},
    {"name": "ReduceLROnPlateau", "mode": "min", "factor": 0.1,
     "patience": 1, "threshold_mode": "abs", "threshold": 0.05,
     "cooldown": 2, "min_lr": 1e-5},
], ids=lambda c: c["name"] + ("-" + c["mode"] if "mode" in c else ""))
def test_schedulers_match_jax(cfg):
    want = jax_opt.create_lr_scheduler(dict(cfg), 2e-3)
    got = optimizers.create_lr_scheduler(dict(cfg), 2e-3)
    plateau = cfg["name"] == "ReduceLROnPlateau"
    for i in range(25):
        args = (_metric(i),) if plateau else ()
        assert got.step(*args) == pytest.approx(want.step(*args), abs=1e-12)
        assert got.current_lr == pytest.approx(want.current_lr, abs=1e-12)


def test_lambda_scheduler_and_factory_errors():
    fn = lambda e: 0.95 ** e  # noqa: E731
    want = jax_opt.LambdaLR(1e-3, fn)
    got = optimizers.create_lr_scheduler({"name": "LambdaLR",
                                          "lr_lambda": fn}, 1e-3)
    for _ in range(10):
        assert got.step() == pytest.approx(want.step(), abs=1e-15)
    assert optimizers.create_lr_scheduler(None, 1e-3) is None
    with pytest.raises(RuntimeError, match="Unsupported lr scheduler"):
        optimizers.create_lr_scheduler({"name": "OneCycleLR"}, 1e-3)
    with pytest.raises(ValueError, match="requires a metric"):
        optimizers.ReduceLROnPlateau(1e-3).step()

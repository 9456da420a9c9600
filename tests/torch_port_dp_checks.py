"""The checks of ``test_torch_port_dp_train.py`` (3D) and
``test_torch_port_dp_train2d.py`` (2D), two files so that the test workers
run them side by side: the JAX package's trainers on a 2-device mesh, the
port's world of 1 here and its gloo world of 2
(``torch_port_dp_worker.py``), and what each test holds of them.

Data-parallel training of the port against the JAX package's: the JAX
``Trainer`` / ``UNetTrainer`` on ``make_mesh(n_data=2)`` (two of conftest's
virtual CPU devices, one GSPMD program over the global batch) against the
port's gloo world of 2 (two processes under DDP, each with its rows) and
its world of 1, from the same weights on the same global batches,
augmentation and dropout off:

- the 2D UNet-3+ (BatchNorm in ``UNetConv2`` / ``ConvBNReLU``) at 32²,
  global batch 4, criterion F1 + IoU (``segmentation_loss`` without its
  MS-SSIM term, which needs more than 160 px; the whole hybrid loss under
  data parallelism is held in ``test_torch_port_distributed.py``);
- the 3D UNet3D 'gcr' with ``DiceLoss`` and 'bcr' (BatchNorm) with
  ``BCEDiceLoss``, global batch 2, a validation batch of 2 and a tail of 1.

Held, against JAX: the losses of 3 steps within ``LOSS_TOL`` 1e-4; the
3D step-1 gradients (averaged over the ranks; ``jax.grad`` of the global
batch's loss) within ``GRAD_TOL`` 1e-4 of each parameter's max
|gradient|, or of the model's largest for a leaf under 1e-3 of it (the
gradient of a conv bias before a BatchNorm is rounding noise); the BatchNorm
running statistics within ``LOSS_TOL`` while the weights are the initial
ones and ``STATS_TOL`` after an update (test_torch_port_trainer_unet3plus.py
gives the JAX package's own spread); the eval metrics within ``EVAL_TOL``
1e-5, with a tail batch that does not divide over the ranks; the
parameters after 3 steps, equal on both ranks, within ``GRAD_TOL`` of each
tensor's max |value| plus the ±lr a step of Adam gives an element whose
gradient's sign rounding decides.  Against the world of 1: the 3D
trainers, the UNet-3+'s step in float64 (float32 resolves its gradients
in neither package at 32²) and a tail-only eval set.  Only rank 0 writes
checkpoints and logs.  A port that wrapped the model in DDP and nothing
else (per-rank BatchNorm statistics, a per-rank Dice) fails the losses at
step 1."""

import os

import numpy as np
import torch

import jax
import jax.numpy as jnp

import torch_port_dp_worker as W
from mdeical_image_segmentation_tpu import logging_utils as jax_log
from mdeical_image_segmentation_tpu.data import (
    SyntheticSliceDataset as JaxSynthetic,
)
from mdeical_image_segmentation_tpu.data.collate import (
    SliceCollator as JaxCollator,
)
from mdeical_image_segmentation_tpu.losses import losses3d as jax_losses
from mdeical_image_segmentation_tpu.losses.losses2d import (
    f1_loss as jax_f1,
)
from mdeical_image_segmentation_tpu.losses.losses2d import (
    iou_loss as jax_iou,
)
from mdeical_image_segmentation_tpu.metrics import metrics3d as jax_metrics
from mdeical_image_segmentation_tpu.models import UNetConfig as JaxUNetConfig
from mdeical_image_segmentation_tpu.models import UNetModel as JaxUNetModel
from mdeical_image_segmentation_tpu.models import get_model as jax_get_model
from mdeical_image_segmentation_tpu.parallel import mesh as jax_mesh
from mdeical_image_segmentation_tpu.train import checkpoint as jax_ckpt
from mdeical_image_segmentation_tpu.train import optimizers as jax_opt
from mdeical_image_segmentation_tpu.train import trainer3d as jax_trainer
from mdeical_image_segmentation_tpu.train import (
    TrainerCallback as JaxCallback,
)
from mdeical_image_segmentation_tpu.train import Trainer as JaxTrainer
from mdeical_image_segmentation_tpu.train import (
    TrainingArguments as JaxArgs,
)
from mdeical_image_segmentation_tpu_torch.models import UNetConfig, UNetModel
from mdeical_image_segmentation_tpu_torch.parallel import make_mesh
from mdeical_image_segmentation_tpu_torch.utils.param_bridge import (
    state_dict_to_flax,
)

LOSS_TOL = 1e-4
GRAD_TOL = 1e-4
EVAL_TOL = 1e-5
STATS_TOL = 2e-3
F64_TOL = 1e-6  # the world of 2 against the world of 1 in float64


def _jax_init_checkpoint(kind, out):
    """JAX-initialized weights (and statistics) every 3D run starts from."""
    jm = jax_get_model(W.CFG_3D[kind]["model"])
    x = jnp.asarray(W.train_batches_3d()[0][0][:1])
    variables = jax.jit(jm.init, static_argnums=2)(jax.random.PRNGKey(0), x,
                                                    True)
    params = variables["params"]
    path = jax_ckpt.save_checkpoint(
        {"num_epochs": 0, "num_iterations": 0,
         "model_state_dict": {"params": params,
                              "batch_stats": variables.get("batch_stats",
                                                           {})},
         "best_eval_score": 0.0,
         "optimizer_state_dict": jax_opt.create_optimizer(
             W.OPTIMIZER_3D).init(params)},
        False, os.path.dirname(W.init_path(out, kind)))
    assert path == W.init_path(out, kind)
    return jax.device_get(variables)


class _JaxLog(JaxCallback):
    def __init__(self):
        self.losses, self.stats = [], []

    def on_log(self, args, state, control, logs, **kw):
        self.losses.append(logs["loss"])
        self.stats.append(W.flat(jax.device_get(state.batch_stats)))

    def on_evaluate(self, *a, **kw):
        pass

    def on_step_end(self, *a, **kw):
        pass


def _jax_2d(out):
    """The JAX Trainer over 2 devices, from the port's initial weights."""
    model = UNetModel(UNetConfig(**W.U3P_KW), device="cpu",
                      generator=torch.Generator().manual_seed(0))
    variables = state_dict_to_flax(model.module.state_dict())  # numpy
    jm = JaxUNetModel(JaxUNetConfig(**W.U3P_KW))
    jm.criterion = lambda lg, t: jax_f1(lg, t) + jax_iou(lg, t)
    log = _JaxLog()
    per_device = W.BATCH_2D // W.WORLD
    jt = JaxTrainer(jm, JaxArgs(output_dir=os.path.join(out, "2d_jax"),
                                per_device_train_batch_size=per_device,
                                per_device_eval_batch_size=per_device,
                                **W.ARGS_2D),
                    JaxSynthetic(10, W.RES_2D, 3),
                    JaxSynthetic(5, W.RES_2D, 3, seed=7), callbacks=[log],
                    mesh=jax_mesh.make_mesh(n_data=W.WORLD))
    sample = JaxCollator()([jt.train_dataset[0]])["images"]
    jt._init_state(sample, jt._num_train_steps())
    jt.state = jt.state.replace(**{  # fresh arrays: the step donates them
        k: jax_mesh.replicate(jt.mesh, jax.tree_util.tree_map(jnp.asarray, v))
        for k, v in variables.items()})
    jt._compile_steps()
    res = {"eval0": jt.evaluate()}
    jt.train()
    res.update(losses=log.losses, stats=log.stats, eval=jt.evaluate(),
               params=W.flat(jax.device_get(jt.state.params)))
    return res


def _jax_3d(kind, out, variables):
    cfg = W.CFG_3D[kind]
    run_dir = os.path.join(out, f"{kind}_jax")
    lr = W.OPTIMIZER_3D["learning_rate"]
    jt = jax_trainer.UNetTrainer(
        model=jax_get_model(cfg["model"]),
        optimizer=jax_opt.create_optimizer(W.OPTIMIZER_3D),
        lr_scheduler=jax_opt.create_lr_scheduler(W.SCHEDULER_3D, lr),
        loss_criterion=jax_losses.get_loss_criterion(cfg),
        eval_criterion=jax_metrics.get_evaluation_metric(cfg),
        loaders={"train": W.train_batches_3d(), "val": W.val_batches_3d()},
        checkpoint_dir=run_dir,
        tensorboard_formatter=jax_log.TensorboardFormatter(),
        mesh=jax_mesh.make_mesh(n_data=W.WORLD),
        pre_trained=W.init_path(out, kind), **W.TRAINER_3D)
    jt.fit()
    jm, criterion = jt.model, jt.loss_criterion
    x, t = map(jnp.asarray, W.train_batches_3d()[0])

    @jax.jit
    def grad(params):
        def loss(p):
            out, _ = jm.apply({"params": p, "batch_stats": variables.get(
                "batch_stats", {})}, x, True, mutable=["batch_stats"])
            return criterion(out, t)
        return jax.grad(loss)(params)

    state = jax.device_get(jt._state)
    return {"grads": W.flat(jax.device_get(grad(variables["params"]))),
            "params": W.flat(state["params"]),
            "stats": W.flat(state["batch_stats"]),
            "best": jt.best_eval_score,
            "logged": {tag: W.logged(run_dir, tag) for tag in (
                "train_loss_avg", "val_loss_avg", "val_eval_score_avg",
                "train_eval_score_avg")}}


def make_runs(tmp_path_factory, kinds):
    """{kind: (JAX, the port's world of 1, [rank 0, rank 1] of its world of
    2)} for ``kinds`` ("2d", or the 3D "gcr" and "bcr").  The world of 2
    runs in two processes while this one runs the rest; the 2D world of 1
    is the float64 step and the tail set's evaluation (its trainer is held
    against JAX on one device in test_torch_port_trainer_unet3plus.py)."""
    out = str(tmp_path_factory.mktemp("dp_train"))
    kinds_3d = [k for k in kinds if k in W.CFG_3D]
    inits = {kind: _jax_init_checkpoint(kind, out) for kind in kinds_3d}
    scenario = "train3d" if kinds_3d else "train2d"
    procs = W.spawn(scenario, out)
    try:
        one = make_mesh(device="cpu")
        port1, jax_runs = {}, {}
        if "2d" in kinds:
            port1["2d"] = {
                "float64": W.step_2d_float64(one),
                "eval0_tail": W.trainer_2d(
                    os.path.join(out, "2d_world1"), one,
                    W.BATCH_2D).evaluate(W.tail_set_2d())}
            jax_runs["2d"] = _jax_2d(out)
        for kind in kinds_3d:
            port1[kind] = W.run_3d(kind, os.path.join(out, f"{kind}_world1"),
                                   one, W.init_path(out, kind))
            jax_runs[kind] = _jax_3d(kind, out, inits[kind])
    except BaseException:
        for p in procs:
            p.kill()
        raise
    ranks = W.results(procs, scenario, out)
    return {kind: (jax_runs[kind], port1[kind], [r[kind] for r in ranks])
            for kind in kinds}


def _close(got, want, tol, what):
    """Every leaf of ``got`` within ``tol`` of its ``want`` leaf's max
    |value|."""
    assert got.keys() == want.keys(), what
    for k, w in want.items():
        assert np.abs(got[k] - w).max() <= tol * np.abs(w).max(), (what, k)


def _grads_close(got, want, tol, what):
    """Gradients within ``tol`` of each leaf's max |value|; a leaf whose
    gradient is under 1e-3 of the model's largest is rounding noise (a
    conv bias before a BatchNorm, the scale of a norm whose output the next
    norm renormalizes) and is held against the largest, as
    test_torch_port_unet3plus_grads.py holds it."""
    top = max(float(np.abs(w).max()) for w in want.values())
    assert got.keys() == want.keys(), what
    for k, w in want.items():
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(
            got[k], w, rtol=0, atol=tol * (scale if scale >= 1e-3 * top
                                           else top),
            err_msg=f"{what} {k}")


def check_losses(runs, kind):
    """2D: each step's logged loss (the ranks' mean) on both ranks; 3D: the
    running train average and the validation loss rank 0 logs, and the
    world of 1's; each step's loss averaged over the ranks is the world of
    1's."""
    want, one, ranks = runs[kind]
    if kind == "2d":
        assert len(want["losses"]) == 3
        assert len(set(np.round(want["losses"], 6))) > 1
        for got in ranks:
            np.testing.assert_allclose(got["losses"], want["losses"],
                                       rtol=LOSS_TOL)
        return
    for tag in ("train_loss_avg", "val_loss_avg"):
        w = want["logged"][tag]
        assert w, tag
        for got in (one, ranks[0]):
            g = got["logged"][tag]
            assert sorted(g) == sorted(w), tag
            np.testing.assert_allclose([g[s] for s in sorted(w)],
                                       [w[s] for s in sorted(w)],
                                       rtol=LOSS_TOL, err_msg=tag)
    np.testing.assert_allclose(
        np.mean([r["losses"] for r in ranks], axis=0), one["losses"],
        rtol=LOSS_TOL)


def check_step1_gradients(runs, kind):
    """3D: the trainers' step-1 gradients (averaged over the ranks) against
    ``jax.grad`` of the global batch's loss and the world of 1's, within
    GRAD_TOL.  2D: the UNet-3+'s step in float64 (float32 resolves neither
    package's gradients at 32²: test_torch_port_unet3plus_grads.py holds
    the world of 1 there against JAX in float64), the world of 2 against
    the world of 1 within F64_TOL, its loss and running statistics too."""
    want, one, ranks = runs[kind]
    if kind == "2d":
        want = one["float64"]
        for got in (r["float64"] for r in ranks):
            np.testing.assert_allclose(got["loss"], want["loss"],
                                       rtol=F64_TOL)
            _close(got["stats"], want["stats"], F64_TOL, "stats")
            _grads_close(got["grads"], want["grads"], F64_TOL, "2d")
        return
    for got in (one, *ranks):
        _grads_close(got["grads"], want["grads"], GRAD_TOL, kind)


def check_batchnorm_statistics(runs, kind):
    """2D after each step: steps 1-2 run the initial weights (the first
    rate of the warmup is 0), within LOSS_TOL; step 3 after an update,
    within STATS_TOL.  'bcr' after its 3 steps, within STATS_TOL."""
    want, one, ranks = runs[kind]
    if kind == "2d":
        assert len(want["stats"]) == 3
        for got in ranks:
            for step, w in enumerate(want["stats"]):
                _close(got["stats"][step], w,
                       LOSS_TOL if step < 2 else STATS_TOL, f"step {step}")
        return
    assert want["stats"]
    for got in (one, *ranks):
        _close(got["stats"], want["stats"], STATS_TOL, kind)


def check_parameters(runs, kind):
    """Equal on both ranks; against JAX within GRAD_TOL of each tensor's
    max |value| plus the 3 steps of ±lr in which Adam moves an element
    whose gradient's sign rounding decides."""
    want, one, ranks = runs[kind]
    for k, v in ranks[0]["params"].items():
        np.testing.assert_array_equal(ranks[1]["params"][k], v, err_msg=k)
    lr = W.ARGS_2D["learning_rate"] if kind == "2d" else (
        W.OPTIMIZER_3D["learning_rate"])
    for got in (ranks[0],) if kind == "2d" else (one, ranks[0]):
        assert got["params"].keys() == want["params"].keys()
        for k, v in want["params"].items():
            np.testing.assert_allclose(
                got["params"][k], v, rtol=0,
                atol=GRAD_TOL * float(np.abs(v).max()) + 2 * 3 * lr,
                err_msg=k)


def check_eval_metrics(runs, kind):
    """2D: ``evaluate()`` at the initial weights (a batch of 4, then a tail
    of 1 that every rank computes whole) within EVAL_TOL, and its loss
    after the 3 steps within LOSS_TOL (the updates part the weights by
    rounding, as test_torch_port_trainer_unet3plus.py finds); 3D: the
    validation's score (a batch of 2 and a tail of 1) and the best score,
    the same on both ranks."""
    want, one, ranks = runs[kind]
    if kind == "2d":
        for got in ranks:
            assert got["eval0"].keys() == want["eval0"].keys()
            for k, w in want["eval0"].items():
                np.testing.assert_allclose(got["eval0"][k], w,
                                           rtol=EVAL_TOL, atol=EVAL_TOL,
                                           err_msg=k)
            np.testing.assert_allclose(got["eval"]["eval_loss"],
                                       want["eval"]["eval_loss"],
                                       rtol=LOSS_TOL)
        return
    w = want["logged"]["val_eval_score_avg"]
    assert w
    for got in (one, ranks[0]):
        g = got["logged"]["val_eval_score_avg"]
        assert sorted(g) == sorted(w)
        np.testing.assert_allclose([g[s] for s in sorted(w)],
                                   [w[s] for s in sorted(w)], rtol=EVAL_TOL,
                                   atol=EVAL_TOL)
    assert ranks[0]["best"] == ranks[1]["best"]
    np.testing.assert_allclose(ranks[0]["best"], want["best"], rtol=EVAL_TOL,
                               atol=EVAL_TOL)


def check_tail_batch_counts_once(runs):
    """An eval set of 3 slices is one global batch that 2 ranks cannot
    split: every rank computes it whole and its sums are not all-reduced
    (that would count it twice, and weigh a ratio's epsilon half as
    much): the world of 2 reads the world of 1's metrics."""
    _, one, ranks = runs["2d"]
    for got in ranks:
        for k, w in one["eval0_tail"].items():
            np.testing.assert_allclose(got["eval0_tail"][k], w,
                                       rtol=EVAL_TOL, atol=EVAL_TOL,
                                       err_msg=k)


def check_only_rank0_writes(runs, kind):
    _, _, ranks = runs[kind]
    assert ranks[1]["files"] == []
    want = ({"checkpoint-3/config.json", "checkpoint-3/params.msgpack",
             "logs/metrics.jsonl"} if kind == "2d"
            else {"last_checkpoint.msgpack", "best_checkpoint.msgpack"})
    assert want <= set(ranks[0]["files"]), ranks[0]["files"]
    assert any(f.endswith("metrics.jsonl") for f in ranks[0]["files"])


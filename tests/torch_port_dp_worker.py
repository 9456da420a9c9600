"""One rank of a gloo world of the port on the CPU, for the data-parallel
tests (``test_torch_port_distributed.py``, ``test_torch_port_dp_train.py``,
``test_torch_port_dp_train2d.py``, ``test_torch_port_dist_ckpt.py``), the
spatial one (``test_torch_port_spatial.py``, its cases in
``torch_port_spatial_cases.py``) and the model-axis ones
(``test_torch_port_tensor_parallel.py``, ``test_torch_port_zero1.py``, their
cases in ``torch_port_model_axis_cases.py``), and the setups they share.

    python tests/torch_port_dp_worker.py <scenario> <rank> <world> <port> <out>

joins the process group at ``localhost:<port>`` through
``parallel.distributed.initialize(device="cpu")``, runs ``<scenario>`` (a
function of this module named ``scenario_<name>``) and pickles what it
returns to ``<out>/<scenario>_rank<rank>.pkl``.  The scenarios import the
port only, never JAX.  ``spawn`` starts a world of them from a test,
``results`` waits for it and reads what each rank wrote.
"""

from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
if REPO not in sys.path:
    sys.path.insert(0, REPO)

WORLD = 2
TIMEOUT_S = 300

# -- 2D: UNet-3+ (BatchNorm in UNetConv2 and ConvBNReLU) ---------------------

RES_2D = 32
U3P_KW = dict(in_channels=3, out_channels=1, unet_type="UNet_3Plus")
# a global batch of 4: 2 rows a rank in the world of 2; 10 train slices
# (2 batches an epoch, drop-last), 5 eval slices (a batch of 4, then a tail
# of 1 that does not divide over 2 ranks)
BATCH_2D = 4
ARGS_2D = dict(max_steps=3, learning_rate=1e-4, warmup_ratio=0.4,
               max_grad_norm=0.05, weight_decay=0.01, logging_steps=1,
               eval_strategy="no", save_steps=3, augment=False, seed=3)

# -- 3D: UNet3D 'gcr' with DiceLoss, 'bcr' with BCEDiceLoss -----------------

CFG_3D = {
    "gcr": {
        "model": {"name": "UNet3D", "in_channels": 1, "out_channels": 1,
                  "f_maps": 4, "num_levels": 2, "num_groups": 2,
                  "layer_order": "gcr", "final_sigmoid": True},
        "loss": {"name": "DiceLoss"},
        "eval_metric": {"name": "DiceCoefficient"},
    },
    "bcr": {
        "model": {"name": "UNet3D", "in_channels": 1, "out_channels": 1,
                  "f_maps": 4, "num_levels": 2, "layer_order": "bcr",
                  "final_sigmoid": True},
        "loss": {"name": "BCEDiceLoss"},
        "eval_metric": {"name": "MeanIoU"},
    },
}
OPTIMIZER_3D = {"name": "Adam", "learning_rate": 1e-3, "weight_decay": 1e-5}
SCHEDULER_3D = {"name": "ReduceLROnPlateau", "mode": "max", "factor": 0.5,
                "patience": 2}
# 3 steps (iterations 1-3), validation and the checkpoint at iteration 2
TRAINER_3D = dict(max_num_epochs=1, max_num_iterations=2,
                  validate_after_iters=2, log_after_iters=1, base_lr=1e-3)


def init_path(out, kind):
    """Where the test writes the JAX-initialized checkpoint of ``kind``
    that every run starts from."""
    return os.path.join(out, f"init_{kind}", "last_checkpoint.msgpack")


def batches_3d(sizes, seed):
    """(input, target) global batches of ``sizes`` rows, 8x16x16x1; the
    rows alternate between mostly foreground and mostly background, so
    that a rank's own ratio or statistic is far from the global one."""
    rng = np.random.default_rng(seed)
    out = []
    for n in sizes:
        x = rng.random((n, 8, 16, 16, 1)).astype(np.float32)
        cut = np.where(np.arange(n) % 2 == 0, 0.3, 0.8).reshape(-1, 1, 1, 1,
                                                                1)
        out.append(((x + 0.5 * (cut < 0.5)).astype(np.float32),
                    (x > cut).astype(np.float32)))
    return out


def train_batches_3d():
    return batches_3d([2, 2, 2], 1)


def val_batches_3d():
    # a batch that divides over 2 ranks, then a tail of 1 that does not
    return batches_3d([2, 1], 2)


# -- helpers the scenarios and the tests share --------------------------------


def ratio_loss(logits, targets):
    """UNet-3+'s hybrid loss without its MS-SSIM term, which needs more
    than 160 px: the global-batch ratios F1 + IoU."""
    from mdeical_image_segmentation_tpu_torch.losses.losses2d import (
        f1_loss,
        iou_loss,
    )

    return f1_loss(logits, targets) + iou_loss(logits, targets)


def flat(tree, prefix=""):
    """A nested dict of arrays as {"a/b/c": numpy array}, copied."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + str(k)] = np.array(v)
    return out


def batch_2d_float64():
    """A global batch of 4 RGB slices and masks, float64."""
    rng = np.random.default_rng(11)
    x = rng.random((BATCH_2D, RES_2D, RES_2D, 3))
    return x, (x.mean(-1, keepdims=True) > 0.5).astype(np.float64)


def step_2d_float64(mesh):
    """The UNet-3+'s training-mode forward and backward of F1 + IoU in
    float64 (float32 does not resolve its gradients at 32²:
    test_torch_port_unet3plus_grads.py), this rank's rows of
    ``batch_2d_float64`` under DDP: the loss, the averaged gradients and
    the running statistics the forward leaves."""
    import torch

    from mdeical_image_segmentation_tpu_torch.models import (
        UNetConfig,
        UNetModel,
    )
    from mdeical_image_segmentation_tpu_torch.parallel import (
        mesh as mesh_lib,
    )
    from mdeical_image_segmentation_tpu_torch.utils.param_bridge import (
        state_dict_to_flax,
    )

    module = UNetModel(UNetConfig(**U3P_KW), device="cpu",
                       generator=torch.Generator().manual_seed(0)).module
    module.double().train()
    x, y = batch_2d_float64()
    n = BATCH_2D // mesh.size
    rows = slice(mesh.rank * n, (mesh.rank + 1) * n)
    ddp = mesh_lib.wrap_ddp(module, torch.device("cpu"))
    with mesh_lib.rows_split(mesh):
        loss = ratio_loss(ddp(torch.from_numpy(x[rows]), torch.Generator()),
                          torch.from_numpy(y[rows]))
        loss.backward()
    sd = state_dict_to_flax(module.state_dict())
    return {"loss": float(loss.detach()), "stats": flat(sd["batch_stats"]),
            "grads": flat(state_dict_to_flax(
                {k: p.grad for k, p in module.named_parameters()})[
                    "params"])}


def files_under(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def trainer_2d(out_dir, mesh, per_device, callbacks=()):
    """The port's Trainer on the UNet-3+ (criterion F1 + IoU) over
    ``mesh``, from the seed-0 weights."""
    import torch

    from mdeical_image_segmentation_tpu_torch.data import (
        SyntheticSliceDataset,
    )
    from mdeical_image_segmentation_tpu_torch.models import (
        UNetConfig,
        UNetModel,
    )
    from mdeical_image_segmentation_tpu_torch.train import (
        Trainer,
        TrainingArguments,
    )

    model = UNetModel(UNetConfig(**U3P_KW), device="cpu",
                      generator=torch.Generator().manual_seed(0))
    model.criterion = ratio_loss
    return Trainer(model, TrainingArguments(
        output_dir=out_dir, per_device_train_batch_size=per_device,
        per_device_eval_batch_size=per_device, **ARGS_2D),
        SyntheticSliceDataset(10, RES_2D, 3),
        SyntheticSliceDataset(5, RES_2D, 3, seed=7),
        callbacks=list(callbacks), mesh=mesh, device="cpu")


def tail_set_2d():
    """3 slices: one global batch of 3 rows, which 2 ranks cannot split."""
    from mdeical_image_segmentation_tpu_torch.data import (
        SyntheticSliceDataset,
    )

    return SyntheticSliceDataset(3, RES_2D, 3, seed=9)


def run_2d(out_dir, mesh, per_device):
    """The port's Trainer on the UNet-3+ over ``mesh``: ``evaluate()`` at
    the initial weights, losses and running statistics after every step,
    the parameters after 3 steps, ``evaluate()`` then, and the files
    written."""
    from mdeical_image_segmentation_tpu_torch.train import TrainerCallback
    from mdeical_image_segmentation_tpu_torch.utils.param_bridge import (
        state_dict_to_flax,
    )

    rec = {"losses": [], "stats": []}

    class Log(TrainerCallback):
        def on_log(self, args, state, control, logs, **kw):
            rec["losses"].append(logs["loss"])
            rec["stats"].append(flat(state_dict_to_flax(
                state.model.module.state_dict())["batch_stats"]))

    t = trainer_2d(out_dir, mesh, per_device, [Log()])
    # at the initial weights, the same in every run: a batch of 4, then a
    # tail of 1 that 2 ranks cannot split; then a set that is one tail
    rec["eval0"] = t.evaluate()
    rec["eval0_tail"] = t.evaluate(tail_set_2d())
    t.train()
    rec["eval"] = t.evaluate()
    rec["params"] = flat(state_dict_to_flax(
        t.model.module.state_dict())["params"])
    rec["files"] = files_under(out_dir)
    return rec


def port_trainer_3d(kind, run_dir, mesh, loaders=None, **kw):
    """The port's UNetTrainer of ``CFG_3D[kind]`` over ``mesh`` on the
    shared global batches (a loader of global batches: the trainer splits
    them), from ``pre_trained`` or ``resume`` in ``kw``."""
    from mdeical_image_segmentation_tpu_torch import logging_utils
    from mdeical_image_segmentation_tpu_torch.losses import (
        get_loss_criterion,
    )
    from mdeical_image_segmentation_tpu_torch.metrics import (
        get_evaluation_metric,
    )
    from mdeical_image_segmentation_tpu_torch.models import get_model
    from mdeical_image_segmentation_tpu_torch.train import (
        optimizers,
        trainer3d,
    )

    cfg = CFG_3D[kind]
    model = get_model(cfg["model"])
    return trainer3d.UNetTrainer(
        model=model,
        optimizer=optimizers.create_optimizer(OPTIMIZER_3D,
                                              model.parameters()),
        lr_scheduler=optimizers.create_lr_scheduler(
            SCHEDULER_3D, OPTIMIZER_3D["learning_rate"]),
        loss_criterion=get_loss_criterion(cfg),
        eval_criterion=get_evaluation_metric(cfg),
        loaders=loaders or {"train": train_batches_3d(),
                            "val": val_batches_3d()},
        checkpoint_dir=run_dir,
        tensorboard_formatter=logging_utils.TensorboardFormatter(),
        mesh=mesh, **{**TRAINER_3D, **kw})


def record_3d(trainer):
    """Wrap the trainer's step: each step's loss (this rank's) and the
    step-1 gradients, averaged over the ranks."""
    from mdeical_image_segmentation_tpu_torch.utils.param_bridge import (
        state_dict_to_flax,
    )

    rec = {"losses": []}
    step = trainer._train_step

    def recorded(input, target, weight):
        loss, output = step(input, target, weight)
        rec["losses"].append(float(loss))
        if "grads" not in rec:
            rec["grads"] = flat(state_dict_to_flax(
                {n: p.grad.clone() for n, p in
                 trainer.model.named_parameters()})["params"])
        return loss, output

    trainer._train_step = recorded
    return rec


def logged(run_dir, tag):
    """{step: value} of ``tag`` in the run's metrics.jsonl files."""
    import json

    rows = {}
    for root, _, files in os.walk(os.path.join(run_dir, "logs")):
        for f in files:
            if f == "metrics.jsonl":
                for line in open(os.path.join(root, f)):
                    r = json.loads(line)
                    if r["tag"] == tag:
                        rows[r["step"]] = r["value"]
    return rows


def run_3d(kind, run_dir, mesh, init):
    """``fit()`` of the port's UNetTrainer from the ``init`` checkpoint."""
    from mdeical_image_segmentation_tpu_torch.utils.param_bridge import (
        state_dict_to_flax,
    )

    t = port_trainer_3d(kind, run_dir, mesh, pre_trained=init)
    rec = record_3d(t)
    t.fit()
    sd = state_dict_to_flax(t.model.state_dict())
    rec.update(params=flat(sd["params"]),
               stats=flat(sd.get("batch_stats", {})),
               best=t.best_eval_score, files=files_under(run_dir),
               logged={tag: logged(run_dir, tag) for tag in (
                   "train_loss_avg", "val_loss_avg", "val_eval_score_avg",
                   "train_eval_score_avg")})
    return rec


# -- the scenarios ------------------------------------------------------------


def scenario_train2d(rank, world, out):
    """test_torch_port_dp_train2d.py: the 2D UNet-3+ over the world."""
    from mdeical_image_segmentation_tpu_torch.parallel import make_mesh

    mesh = make_mesh(device="cpu")
    res = run_2d(os.path.join(out, f"2d_rank{rank}"), mesh, BATCH_2D // world)
    res["float64"] = step_2d_float64(mesh)
    return {"2d": res}


def scenario_train3d(rank, world, out):
    """test_torch_port_dp_train.py: the 3D 'gcr' and 'bcr' trainers over
    the world."""
    from mdeical_image_segmentation_tpu_torch.parallel import make_mesh

    mesh = make_mesh(device="cpu")
    return {kind: run_3d(kind, os.path.join(out, f"{kind}_rank{rank}"), mesh,
                         init_path(out, kind)) for kind in CFG_3D}


def scenario_primitives(rank, world, out):
    """test_torch_port_distributed.py: process_info, the mesh helpers,
    BatchNorm and the ratio losses on this rank's rows of the global
    inputs that ``primitive_inputs`` makes."""
    import torch

    from mdeical_image_segmentation_tpu_torch.losses import losses3d
    from mdeical_image_segmentation_tpu_torch.losses.losses2d import (
        segmentation_loss,
    )
    from mdeical_image_segmentation_tpu_torch.ops import batchnorm
    from mdeical_image_segmentation_tpu_torch.parallel import (
        distributed,
        mesh as mesh_lib,
    )

    group = torch.distributed.group.WORLD
    distributed.initialize(device="cpu")  # the second call: no-op
    mesh = mesh_lib.make_mesh(device="cpu")
    res = {"same_group": torch.distributed.group.WORLD is group,
           "backend": torch.distributed.get_backend(),
           "info": distributed.process_info(),
           "primary": distributed.is_primary(),
           "shape": mesh.shape, "rank": mesh.rank}
    g = primitive_inputs()
    rows = slice(rank * g["n"] // world, (rank + 1) * g["n"] // world)
    res["shard"] = mesh_lib.shard_batch(mesh, {"x": g["x"]})["x"]
    res["tail"] = mesh_lib.shard_batch(mesh, {"x": g["x"][:3]})["x"]
    tree = {"a": torch.full((2,), float(rank)), "b": np.full(3, rank),
            "c": [rank, "r" + str(rank)]}
    res["replicated"] = mesh_lib.replicate(mesh, tree)
    res["prefetch"] = [b["x"].numpy() for b in mesh_lib.device_prefetch(
        [{"x": g["x"]}, {"x": g["x"][:3]}], mesh)]
    res["gathered"] = mesh_lib.gather_rows(
        mesh, torch.from_numpy(g["x"][rows])).numpy()
    from mdeical_image_segmentation_tpu_torch.data.device_cache import (
        DeviceCachedVolumeLoader,
        DeviceCacheUnsupported,
    )
    try:
        DeviceCachedVolumeLoader([object()], 2, "cpu")
    except DeviceCacheUnsupported as e:
        res["device_cache"] = str(e)

    # BatchNorm: forward, statistics and every gradient of this rank's rows
    x = torch.from_numpy(g["bn_x"][rows]).requires_grad_(True)
    w = torch.from_numpy(g["bn_w"]).requires_grad_(True)
    b = torch.from_numpy(g["bn_b"]).requires_grad_(True)
    with mesh_lib.rows_split(mesh):
        y, mean, var = batchnorm.batch_norm_train(x, w, b, 1e-5,
                                                  mesh_lib.split_mesh())
        (y * torch.from_numpy(g["bn_g"][rows])).sum().backward()
    res["bn"] = {"y": y.detach().numpy(), "mean": mean.numpy(),
                 "var": var.numpy(), "dx": x.grad.numpy(),
                 "dw": w.grad.numpy(), "db": b.grad.numpy()}

    # each ratio loss and its gradient on this rank's rows, split and
    # replicated (a tail every rank holds whole: no all-reduce)
    losses = {"segmentation": segmentation_loss,
              "dice": losses3d.DiceLoss(),
              "gdl": losses3d.GeneralizedDiceLoss(),
              "bce_dice": losses3d.BCEDiceLoss(),
              "ce": losses3d.CrossEntropyLoss(weight=[0.3, 1.0, 2.0],
                                              ignore_index=1),
              "wce": losses3d.WeightedCrossEntropyLoss()}
    res["losses"] = {}
    for name, fn in losses.items():
        logits, target = g[f"{name}_logits"], g[f"{name}_target"]
        for split in (True, False):
            sl = rows if split else slice(None)
            x = torch.from_numpy(logits[sl]).requires_grad_(True)
            with mesh_lib.rows_split(mesh if split else None):
                loss = fn(x, torch.from_numpy(target[sl]))
                loss.backward()
            res["losses"][name, split] = (float(loss), x.grad.numpy())
    return res


def scenario_spatial(rank, world, out):
    """test_torch_port_spatial.py: the spatially sharded forward, input
    gradient, steps and trainer over the world."""
    import torch_port_spatial_cases as S

    return S.port_runs(out, rank)


def scenario_tp(rank, world, out):
    """test_torch_port_tensor_parallel.py: a model axis of 2."""
    import torch_port_model_axis_cases as M
    from mdeical_image_segmentation_tpu_torch.parallel import make_mesh

    mesh = make_mesh(n_model=2, device="cpu")
    return {"mesh": (mesh.shape, mesh.rank, mesh.model_rank),
            "unet2d": M.unet2d_forward_and_grads(out, mesh),
            "trainer": M.run_trainer_3d(out, rank),
            "round_trip": M.dcp_round_trip(out, rank, mesh,
                                           tensor_parallel=True),
            "orbax": M.orbax_resume(out, rank, "tp", M.TP_PARALLEL)}


def scenario_zero1(rank, world, out):
    """test_torch_port_zero1.py: a data axis of 2, ZeRO-1 and not."""
    import torch_port_model_axis_cases as M
    from mdeical_image_segmentation_tpu_torch.parallel import make_mesh

    mesh = make_mesh(device="cpu")
    return {"zero1": M.run_2d(out, "zero1", mesh, zero1=True),
            "replicated": M.run_2d(out, "replicated", mesh),
            "orbax": M.orbax_resume(out, rank, "zero1", {"zero1": True})}


def scenario_tp_zero1(rank, world, out):
    """test_torch_port_zero1.py: a (2, 2) mesh, TP and ZeRO-1 together."""
    import torch_port_model_axis_cases as M
    from mdeical_image_segmentation_tpu_torch.parallel import make_mesh

    mesh = make_mesh(n_model=2, device="cpu")
    return {"mesh": (mesh.shape, mesh.rank, mesh.model_rank),
            "run": M.run_2d(out, "tp_zero1", mesh, zero1=True,
                            tensor_parallel=True)}


def primitive_inputs():
    """The global inputs of ``scenario_primitives``, from a seed.  The two
    halves of each batch differ (targets mostly foreground, then mostly
    background; inputs shifted), so that one rank's own ratio or statistic
    is far from the global batch's."""
    rng = np.random.default_rng(5)
    n = 4
    c = 3
    half = (np.arange(n) < n // 2)

    def rows(shape):  # broadcast a per-row value over ``shape``
        return half.reshape(-1, *([1] * (len(shape) - 1)))

    def target(shape):
        return (rng.random(shape) > np.where(rows(shape), 0.3, 0.9)).astype(
            np.float32)

    g = {"n": n, "x": rng.random((n, 2, 2), np.float32)}
    g["bn_x"] = (rng.standard_normal((n, 6, 5, c)) * 2 + 1
                 + 3 * rows((n, 6, 5, c))).astype(np.float32)
    g["bn_w"] = rng.random(c, np.float32) + 0.5
    g["bn_b"] = rng.random(c, np.float32)
    g["bn_g"] = rng.standard_normal((n, 6, 5, c)).astype(np.float32)
    shape = (n, 176, 176, 1)
    g["segmentation_logits"] = (rng.standard_normal(shape)
                                + rows(shape)).astype(np.float32)
    g["segmentation_target"] = target(shape)
    for name in ("dice", "gdl", "bce_dice"):
        shape = (n, 4, 6, 6, 2)
        g[f"{name}_logits"] = (rng.standard_normal(shape)
                               + rows(shape)).astype(np.float32)
        g[f"{name}_target"] = target(shape)
    for name in ("ce", "wce"):
        shape = (n, 4, 6, 6, 3)
        g[f"{name}_logits"] = (rng.standard_normal(shape)
                               + 2 * rows(shape) * (np.arange(3) == 0)
                               ).astype(np.float32)
        g[f"{name}_target"] = np.where(
            rows((n, 4, 6, 6)) & (rng.random((n, 4, 6, 6)) < 0.8), 0,
            rng.integers(0, 3, (n, 4, 6, 6)))
    return g


def scenario_ckpt(rank, world, out):
    """test_torch_port_dist_ckpt.py: the 3D 'bcr' trainer over the world on
    an epoch of 2 global batches, 3 steps uninterrupted; then 2 steps, a
    ``DistCheckpointer`` save by every rank, and a trainer resumed from its
    directory that takes step 3 (the first batch of the next epoch, as the
    uninterrupted run's step 3)."""
    from mdeical_image_segmentation_tpu_torch.parallel import make_mesh
    from mdeical_image_segmentation_tpu_torch.train.dist_ckpt import (
        DistCheckpointer,
    )

    mesh = make_mesh(device="cpu")
    init = init_path(out, "bcr")
    kw = dict(validate_after_iters=100, max_num_epochs=5)

    def trainer(name, iterations, **more):
        return port_trainer_3d(
            "bcr", os.path.join(out, f"{name}{rank}"), mesh,
            loaders={"train": train_batches_3d()[:2],
                     "val": val_batches_3d()},
            max_num_iterations=iterations, **kw, **more)

    res = {}
    full = trainer("full", 2, pre_trained=init)
    res["full"] = record_3d(full)
    full.fit()
    res["full_state"] = flat(full.checkpoint_state())
    first = trainer("first", 1, pre_trained=init)
    res["first"] = record_3d(first)
    first.fit()
    ckpt = DistCheckpointer(os.path.join(out, "dcp"))
    ckpt.save(first.checkpoint_state(), is_best=True)
    res["exists"] = (ckpt.exists(), ckpt.exists(best=True))
    # the saved counter is iteration 2: one step, then the stop
    resumed = trainer("resumed", 1, resume=os.path.join(out, "dcp"))
    res["resumed_at"] = resumed.num_iterations
    res["resumed"] = record_3d(resumed)
    resumed.fit()
    res["resumed_state"] = flat(resumed.checkpoint_state())
    res["dcp_files"] = files_under(os.path.join(out, "dcp"))
    return res


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(scenario, out, world=WORLD, via_env=False):
    """Start ``world`` ranks of ``scenario`` writing into ``out`` (their
    output into ``<scenario>_rank<rank>.log`` there); with ``via_env``
    they find the coordinator, their count and their rank in
    ``COORDINATOR_ADDRESS``, ``NUM_PROCESSES`` and ``PROCESS_ID``."""
    port = free_port()
    base = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    procs = []
    for rank in range(world):
        env = dict(base)
        if via_env:
            env.update(COORDINATOR_ADDRESS=f"localhost:{port}",
                       NUM_PROCESSES=str(world), PROCESS_ID=str(rank))
        # a file, not a pipe: a rank blocked on a full pipe would hold
        # the other in a collective
        with open(os.path.join(out, f"{scenario}_rank{rank}.log"),
                  "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), scenario,
                 str(rank), str(world), str(port), out],
                stdout=log, stderr=subprocess.STDOUT, cwd=REPO, env=env))
    return procs


def results(procs, scenario, out):
    """Wait for the ranks (killing them past ``TIMEOUT_S``) and read what
    each wrote; raises with a rank's output tail if one failed."""
    try:
        for p in procs:
            p.wait(timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    res = []
    for rank, p in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(out, f"{scenario}_rank{rank}.log")) as f:
                raise AssertionError(f"rank {rank} failed (rc="
                                     f"{p.returncode}):\n{f.read()[-4000:]}")
        with open(os.path.join(out, f"{scenario}_rank{rank}.pkl"),
                  "rb") as f:
            res.append(pickle.load(f))
    return res


def main(argv) -> int:
    scenario, rank, world, port, out = argv
    rank, world = int(rank), int(world)
    import torch

    torch.set_num_threads(2)
    from mdeical_image_segmentation_tpu_torch.parallel import distributed

    if "COORDINATOR_ADDRESS" in os.environ:
        distributed.initialize(device="cpu")
    else:
        distributed.initialize(f"localhost:{port}", world, rank,
                               device="cpu")
    try:
        res = globals()[f"scenario_{scenario}"](rank, world, out)
        with open(os.path.join(out, f"{scenario}_rank{rank}.pkl"),
                  "wb") as f:
            pickle.dump(res, f)
    finally:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

"""The 3D ``UNetTrainer`` of the port (the JAX package's
``train/trainer3d.py``), on one device or data-parallel.

The loop semantics are the JAX package's:

- ``fit()`` runs epochs up to ``max_num_epochs``; ``train()`` iterates the
  train loader, one optimizer step per batch;
- every ``validate_after_iters``: full validation, a scheduler step
  (``ReduceLROnPlateau`` gets the eval score, the others step blindly),
  best-score tracking, the last (and best) checkpoint;
- every ``log_after_iters``: the train eval score with the final activation
  applied, scalar and image logs;
- stop when ``max_num_iterations`` is exceeded or the rate drops below 1e-6;
- kept on purpose: validation scores the raw logits, while the train score
  activates first.

PyTorch in place of jit: the model is an ``nn.Module`` already holding its
weights (drawn from a seeded generator, or loaded by ``pre_trained`` /
``resume``) on the device the trainer runs on; ``model.train()`` /
``model.eval()`` replace the ``train`` flag; ``loss.backward()`` runs the
autograd Functions of the fused 'gcr' blocks and of GroupNorm, whose
backward are CUDA kernels on the card.  A bf16 model keeps float32
parameters: the loss is computed in float32 on its float32 output and Adam
updates the float32 parameters.  A model with BatchNorm carries its running
statistics in its buffers; checkpoints hold them as ``batch_stats``.  The
2D members of the family (``UNet2D``, ``ResidualUNet2D``) take the
(N, 1, H, W, C) batches with the depth axis squeezed, as the JAX trainer
does.  The train loss is summed on the device and read only at log and
validation boundaries and at the end of an epoch.  On a CUDA device the
next batch is copied from pinned memory on a side stream while the current
step runs; a device-cached train loader (``data/device_cache.py``,
``is_device_cached``) hands out batches already on the card, which are
taken as they are.

Loaders are any iterables of (input, target[, weight]) numpy batches,
channels-last (N, D, H, W, C).  ``create_trainer`` builds the trainer from a
config (``configs/config.py``) with the HDF5 loaders (``data/loaders.py``;
``loaders.device_cache`` keeps the train volumes on the card), on the card
unless ``device: cpu``.

Data parallelism (``mesh``; one process per device in a process group,
``parallel.distributed.initialize``): the model runs under DDP and each
rank trains on its rows of every global batch, from a loader that
assembles only them (``process_shard``, as ``create_trainer`` builds it)
or split from the global batches any other loader yields (a batch that
does not divide goes whole to every rank).  The step is the global
batch's: BatchNorm statistics and the ratio losses' sums are all-reduced
(``parallel.rows_split``).  Validation splits each global batch, gathers
the output rows and scores the whole batch on every rank, so every rank
picks the same best checkpoint; the train score is the primary's, on the
gathered batch.  Only the primary rank writes checkpoints and logs.

Spatial mode (``spatial_halo``; ``parallel: {spatial_halo,
spatial_shard_axis, spatial_cross_shard_norm}`` in a config): each batch
is one volume split over the ranks along ``spatial_shard_axis``
(``parallel/spatial.py``, the JAX package's ``make_spatial_train_step``):
every rank draws the same batch (the loaders are not process-sharded),
trains on its slab with a halo exchange, and the gradients are averaged
over the ranks (no DDP; no ``rows_split``, so a ratio loss is the
per-slab one, the mean of the per-slab criteria being the objective).
The step returns no output, so no train score is taken; validation runs
the whole forward on every rank.  3D 'gcr'/'cr' orders only, no
per-voxel weights.

The model axis (``parallel: {model_axis, tensor_parallel, zero1}``;
``mesh=make_mesh(n_model=...)``): the processes form a (data, model) mesh
(``parallel/mesh.py``) and everything above runs over its data axis.
``tensor_parallel`` (with a model axis over 1) shards the conv
out-channels over the model axis (``parallel/tensor.py``: kernel 2 runs on
each rank's block, the outputs are all-gathered), ``zero1`` (with a data
axis over 1) shards the optimizer state over the data axis
(``parallel/zero.py``); neither composes with spatial mode.  Both write
their checkpoints sharded (``train/dist_ckpt.py``, each rank its blocks)
into ``<checkpoint_dir>/dist_ckpt``, the directory ``resume`` then takes;
whatever it resumes from is read whole and sliced to this rank's blocks.
``resume`` takes a msgpack checkpoint file of either package, a
``train/dist_ckpt.py`` directory or the orbax directory a tensor-parallel
or ZeRO-1 run of the JAX package writes (``train/orbax_ckpt.py``), in
every mode.
"""

from __future__ import annotations

import os
from datetime import datetime
from typing import Any, Dict, Iterable, Optional

import torch

from ..models.blocks3d import set_dropout_generator
from ..models.layers2d import TorchBatchNorm
from ..parallel import mesh as mesh_lib
from ..parallel import tensor as tp
from ..parallel.distributed import is_primary
from ..parallel.spatial import make_spatial_train_step, shard_slab
from ..parallel.zero import Zero1Optimizer
from ..utils.param_bridge import flax_to_state_dict, state_dict_to_flax
from . import checkpoint as ckpt
from . import dist_ckpt, orbax_ckpt
from .dist_ckpt import DistCheckpointer
from .orbax_ckpt import OrbaxCheckpointer
from .logging_utils import (
    MetricWriter,
    NullMetricWriter,
    RunningAverage,
    get_logger,
)
from .optimizers import ReduceLROnPlateau, set_learning_rate
from .prefetch import device_batches

logger = get_logger("UNetTrainer")

DIST_DIR = "dist_ckpt"  # the sharded checkpoints of TP and ZeRO-1 runs


def get_number_of_learnable_parameters(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters() if p.requires_grad)


def config_device(config: Dict[str, Any]) -> torch.device:
    """The device a config asks for: ``"auto"`` (the default) and
    ``"cuda"`` mean the card, and raise without one; ``"cpu"`` runs on the
    CPU."""
    name = str(config.get("device", "auto"))
    if name == "cpu":
        return torch.device("cpu")
    if name == "auto" or name.startswith("cuda"):
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {name!r} needs a CUDA card and none "
                               "is available; set device: cpu (--device "
                               "cpu) to run on the CPU")
        return torch.device("cuda" if name == "auto" else name)
    raise ValueError(f"device {name!r}: 'auto', 'cuda' or 'cpu'")


def create_trainer(config: Dict[str, Any]) -> "UNetTrainer":
    """Model, loss, metric, loaders, optimizer, scheduler and trainer from a
    config: the model's weights drawn from a generator seeded with
    ``config['seed']`` (default 0), on ``config_device(config)``, trained
    over the data axis of the process group (one process without one):
    the loader batch is ``batch_size`` times the processes, and each
    process's train loader assembles only its rows.  ``parallel.model_axis``
    lays the processes out as a (data, model) mesh: the loader batch is
    ``batch_size`` times the data axis, and the ranks of one data index
    load the same rows.  With ``parallel.spatial_halo`` the processes split
    each volume instead: every one loads the whole batch of
    ``batch_size``."""
    from ..data.loaders import get_train_loaders
    from ..losses import get_loss_criterion
    from ..metrics import get_evaluation_metric
    from ..models import get_model
    from .logging_utils import get_tensorboard_formatter
    from .optimizers import create_lr_scheduler, create_optimizer

    par_cfg = config.get("parallel") or {}
    device = config_device(config)
    mesh = mesh_lib.make_mesh(n_model=int(par_cfg.get("model_axis", 1)),
                              device=device)
    # spatial mode: the processes split each volume, not the batch
    spatial = bool(par_cfg.get("spatial_halo"))
    if mesh.size > 1:
        logger.info(f"Using {mesh.size} processes for training ("
                    f"{'spatially sharded' if spatial else 'data-parallel'})")
    seed = config.get("seed", 0)
    # drawn on the CPU, so the card and the CPU start from the same weights
    model = get_model(config["model"],
                      generator=torch.Generator().manual_seed(seed))
    model = model.to(device)
    loss_criterion = get_loss_criterion(config)
    eval_criterion = get_evaluation_metric(config)
    loaders = get_train_loaders(
        config, n_devices=1 if spatial else mesh.size, device=device,
        process_shard=((mesh.rank, mesh.size)
                       if mesh.size > 1 and not spatial else None))
    optimizer_config = config["optimizer"]
    optimizer = create_optimizer(optimizer_config, model.parameters())
    base_lr = optimizer_config.get("learning_rate", 1e-3)
    lr_scheduler = create_lr_scheduler(config.get("lr_scheduler", None),
                                       base_lr)
    trainer_config = dict(config["trainer"])
    tensorboard_formatter = get_tensorboard_formatter(
        trainer_config.pop("tensorboard_formatter", None))
    resume = trainer_config.pop("resume", None)
    pre_trained = trainer_config.pop("pre_trained", None)
    return UNetTrainer(
        model=model, optimizer=optimizer, base_lr=base_lr,
        lr_scheduler=lr_scheduler, loss_criterion=loss_criterion,
        eval_criterion=eval_criterion, loaders=loaders,
        tensorboard_formatter=tensorboard_formatter, resume=resume,
        pre_trained=pre_trained, mesh=mesh, seed=seed,
        tensor_parallel=bool(par_cfg.get("tensor_parallel", False)),
        zero1=bool(par_cfg.get("zero1", False)),
        spatial_halo=par_cfg.get("spatial_halo"),
        spatial_shard_axis=int(par_cfg.get("spatial_shard_axis", 2)),
        spatial_cross_shard_norm=bool(par_cfg.get("spatial_cross_shard_norm",
                                                  False)),
        **trainer_config)


class UNetTrainer:
    def __init__(self, model: torch.nn.Module,
                 optimizer: torch.optim.Optimizer, lr_scheduler,
                 loss_criterion, eval_criterion,
                 loaders: Dict[str, Iterable], checkpoint_dir: str,
                 max_num_epochs: int, max_num_iterations: int,
                 validate_after_iters: int = 200, log_after_iters: int = 100,
                 validate_iters: Optional[int] = None,
                 num_iterations: int = 1, num_epoch: int = 0,
                 eval_score_higher_is_better: bool = True,
                 tensorboard_formatter=None,
                 skip_train_validation: bool = False,
                 resume: Optional[str] = None,
                 pre_trained: Optional[str] = None, mesh=None,
                 base_lr: float = 1e-3, seed: int = 0,
                 tensor_parallel: bool = False, zero1: bool = False,
                 spatial_halo: Optional[int] = None,
                 spatial_shard_axis: int = 2,
                 spatial_cross_shard_norm: bool = False, **kwargs):
        self.spatial_halo = int(spatial_halo) if spatial_halo else None
        self.spatial_shard_axis = int(spatial_shard_axis)
        self.spatial_cross_shard_norm = bool(spatial_cross_shard_norm)
        for name, value in (("tensor_parallel", tensor_parallel),
                            ("zero1", zero1)):
            if value and self.spatial_halo:
                raise ValueError(f"spatial_halo and {name} are mutually "
                                 "exclusive")
        if self.spatial_halo:
            if not getattr(model, "is3d", True):
                raise ValueError("spatial training is 3D-only")
            if any(isinstance(m, TorchBatchNorm) for m in model.modules()):
                raise ValueError(
                    "spatial training does not support BatchNorm orders "
                    "(global batch statistics across shards); use 'gcr'/'cr'")
        if tensorboard_formatter is None:
            raise ValueError("TensorboardFormatter must be provided")
        self.model = model
        self.optimizer = optimizer
        self.scheduler = lr_scheduler
        self.loss_criterion = loss_criterion
        self.eval_criterion = eval_criterion
        self.loaders = loaders
        if resume:
            # the run being resumed keeps its directory: logs and
            # checkpoints land next to its checkpoints
            checkpoint_dir = os.path.dirname(os.path.normpath(resume)) or (
                checkpoint_dir)
        self.checkpoint_dir = checkpoint_dir
        self.max_num_epochs = max_num_epochs
        self.max_num_iterations = max_num_iterations
        self.validate_after_iters = validate_after_iters
        self.log_after_iters = log_after_iters
        self.validate_iters = validate_iters
        self.eval_score_higher_is_better = eval_score_higher_is_better
        self.current_lr = base_lr
        self.seed = seed
        self.device = next(model.parameters()).device
        self.mesh = (mesh if mesh is not None
                     else mesh_lib.make_mesh(device=self.device))
        # as in JAX: each takes effect only on an axis of more than 1
        self.tensor_parallel = bool(tensor_parallel
                                    and self.mesh.model_size > 1)
        self.zero1 = bool(zero1 and self.mesh.size > 1)
        self._device_mesh = None  # the sharded checkpoints' DeviceMesh
        self.best_eval_score = (float("-inf") if eval_score_higher_is_better
                                else float("+inf"))
        logger.info(f"eval_score_higher_is_better: "
                    f"{eval_score_higher_is_better}")
        # only the primary rank writes logs and checkpoints
        self.writer = (MetricWriter(os.path.join(
            checkpoint_dir, "logs",
            datetime.now().strftime("%Y-%m-%d_%H-%M-%S")))
            if is_primary() else NullMetricWriter())
        self.tensorboard_formatter = tensorboard_formatter
        self.num_iterations = num_iterations
        self.num_epochs = num_epoch
        self.skip_train_validation = skip_train_validation
        self._preempted = False
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)
        # dropout masks of this rank's rows: a stream of its own
        set_dropout_generator(model, torch.Generator(
            device=self.device).manual_seed(
                seed + 1 + 1_000_003 * self.mesh.rank))
        logger.info(f"Number of learnable params "
                    f"{get_number_of_learnable_parameters(model)}")
        if resume is not None:
            self._restore(resume, with_state=True)
        elif pre_trained is not None:
            self._restore(pre_trained, with_state=False)
        # the whole state, restored or drawn, sliced to this rank's blocks
        if self.tensor_parallel:
            tp.shard_params_tp(model, self.mesh, optimizer)
        if self.zero1:
            self.optimizer = Zero1Optimizer(optimizer, model, self.mesh)
        self._split = False  # the current train batch's rows are split
        self._spatial_step = None
        if self.spatial_halo:
            # no DDP: the spatial step averages the gradients itself, after
            # a backward that issues its own collectives on the group
            self._ddp = model
            mesh_lib.replicate(self.mesh,
                               [p.detach() for p in model.parameters()])
            self._spatial_step = make_spatial_train_step(
                model, lambda out, y: self._loss(out, y, None), optimizer,
                self.mesh.group, halo=self.spatial_halo,
                shard_axis=self.spatial_shard_axis,
                cross_shard_norm=self.spatial_cross_shard_norm, seed=seed)
        else:
            self._ddp = mesh_lib.wrap_ddp(model, self.device,
                                          mesh=self.mesh)

    def request_stop(self):
        """Ask the training loop to checkpoint and stop at the next step."""
        self._preempted = True

    def install_preemption_handler(self, signals=None):
        """Route SIGTERM/SIGINT to a graceful checkpoint-and-stop."""
        import signal as _signal

        if signals is None:
            signals = (_signal.SIGTERM, _signal.SIGINT)
        for sig in signals:
            _signal.signal(sig, lambda *_: self.request_stop())
        logger.info(f"preemption handler installed for {signals}")

    # -- state ---------------------------------------------------------------

    def _restore(self, path: str, with_state: bool) -> None:
        """Load the params of a checkpoint (a msgpack file of the JAX
        package or the port, or a directory whose ``last`` is read: a JAX
        orbax checkpoint or a ``DistCheckpointer`` one); with
        ``with_state`` also the optimizer state, the counters and the best
        score."""
        logger.info(f"Loading {'checkpoint' if with_state else 'pre-trained'}"
                    f" '{path}'...")
        if not os.path.isdir(path):
            saved = ckpt.load_checkpoint(path)
        elif orbax_ckpt.is_checkpoint(os.path.join(path, orbax_ckpt.LAST_DIR)):
            saved = OrbaxCheckpointer(path).restore()
        elif dist_ckpt.is_checkpoint(os.path.join(path, dist_ckpt.LAST_DIR)):
            saved = DistCheckpointer(path).restore()
        else:
            last = os.path.join(path, orbax_ckpt.LAST_DIR)
            found = sorted(os.listdir(last if os.path.isdir(last) else path))
            raise ValueError(
                f"'{path}' is neither an orbax checkpoint directory "
                f"(last/{orbax_ckpt.METADATA}) nor a torch.distributed."
                f"checkpoint one (last/{dist_ckpt.METADATA}); "
                f"{'last/' if os.path.isdir(last) else ''} holds {found}")
        weights = saved["model_state_dict"]
        self.model.load_state_dict(
            {k: torch.as_tensor(v) for k, v in weights["state_dict"].items()}
            if "state_dict" in weights else flax_to_state_dict(weights))
        if not with_state:
            return
        ckpt.load_optimizer_state(self.optimizer, self.model,
                                  saved["optimizer_state_dict"])
        self.best_eval_score = float(saved["best_eval_score"])
        self.num_iterations = int(saved["num_iterations"])
        self.num_epochs = int(saved["num_epochs"])
        logger.info(f"Checkpoint loaded. Epoch: {self.num_epochs}. "
                    f"Iteration: {self.num_iterations}. "
                    f"Best val score: {self.best_eval_score}.")

    def checkpoint_state(self) -> Dict[str, Any]:
        """The tree a checkpoint holds (the JAX trainer's keys): counters,
        ``model_state_dict`` (flax ``params`` and ``batch_stats``), the best
        score and the optimizer state; ``DistCheckpointer(dir).save`` of it
        is a directory ``resume`` takes.  A tensor-parallel or ZeRO-1 run
        gives its sharded state (``sharded_checkpoint_state``)."""
        if self.tensor_parallel or self.zero1:
            return self.sharded_checkpoint_state()
        return {
            "num_epochs": self.num_epochs + 1,
            "num_iterations": self.num_iterations,
            "model_state_dict": {"batch_stats": {}, **state_dict_to_flax(
                self.model.state_dict())},
            "best_eval_score": self.best_eval_score,
            "optimizer_state_dict": ckpt.optimizer_state_tree(
                self.optimizer, self.model),
        }

    def sharded_checkpoint_state(self) -> Dict[str, Any]:
        """The tree a tensor-parallel or ZeRO-1 checkpoint holds, in the
        port's layout: the counters, ``model_state_dict.state_dict`` (the
        module's ``state_dict``) and ``optimizer_state_dict`` as
        ``train/checkpoint.py`` writes a torch optimizer's state by
        parameter name, each sharded tensor as this rank's block
        (``dist_ckpt.sharded``).  Every rank calls it."""
        if self._device_mesh is None:
            self._device_mesh = dist_ckpt.device_mesh(self.mesh)
        dmesh = self._device_mesh
        tp_dims = tp.sharded_dims(self.model)
        weights = {k: dist_ckpt.sharded(v, dmesh, None, tp_dims.get(k))
                   for k, v in self.model.state_dict().items()}
        if isinstance(self.optimizer, Zero1Optimizer):
            inner, slices = self.optimizer.inner, self.optimizer.named_slices()
        else:
            inner = self.optimizer
            slices = [(k, p, None) for k, p in self.model.named_parameters()]
        state = {}
        for name, s, dim in slices:
            entries = {
                k: (v.item() if k == "step" else
                    dist_ckpt.sharded(v, dmesh, dim, tp_dims.get(name)))
                for k, v in inner.state.get(s, {}).items() if v is not None}
            if entries:
                state[name] = entries
        return {
            "num_epochs": self.num_epochs + 1,
            "num_iterations": self.num_iterations,
            "model_state_dict": {"state_dict": weights},
            "best_eval_score": self.best_eval_score,
            "optimizer_state_dict": {
                "torch_optimizer": type(inner).__name__,
                "learning_rate": float(inner.param_groups[0]["lr"]),
                "state": state},
        }

    def _save_checkpoint(self, is_best: bool) -> None:
        if self.tensor_parallel or self.zero1:
            # every rank writes its blocks
            DistCheckpointer(os.path.join(self.checkpoint_dir, DIST_DIR)).save(
                self.checkpoint_state(), is_best=is_best)
            return
        if not is_primary():
            return  # the replicas are equal; one process writes
        path = os.path.join(self.checkpoint_dir, ckpt.LAST_NAME)
        logger.info(f"Saving checkpoint to '{path}'")
        ckpt.save_checkpoint(self.checkpoint_state(), is_best,
                             checkpoint_dir=self.checkpoint_dir)

    # -- batches -------------------------------------------------------------

    def _device_batches(self, loader: Iterable, whole_targets=False):
        """(input, target, weight, split) on the device, one batch ahead:
        batch k + 1's copy is issued before step k is handed out.  The
        rows are this rank's: a loader with a ``process_shard`` assembles
        only them, any other loader's global batches are split here
        (``split`` False: the batch did not divide, or one process).  With
        ``whole_targets`` the target and weight stay the global batch's.
        A device-cached loader's batches are on the device already."""
        if getattr(loader, "is_device_cached", False):
            return ((i, t, w, False) for i, t, w in loader)
        splits = []

        def host():
            sharded = getattr(loader, "process_shard", None) is not None
            for t in loader:
                b = (t[0], t[1], t[2] if len(t) > 2 else None)
                split = sharded or (self.mesh.size > 1
                                    and not self.spatial_halo
                                    and mesh_lib.divides(self.mesh, b))
                if split and not sharded:
                    rows = mesh_lib.shard_batch(self.mesh, b)
                    b = (rows[0],) + (b[1:] if whole_targets else rows[1:])
                splits.append(split)
                yield b

        return ((i, t, w, splits.pop(0)) for i, t, w in device_batches(
            host(), self.device, self._copy_stream))

    # -- steps ---------------------------------------------------------------

    def _apply_model(self, input: torch.Tensor, model=None) -> torch.Tensor:
        """The forward of ``model`` (the model by default; its DDP wrapper
        in training); a 2D model sees the depth axis squeezed and its
        output gets it back."""
        model = self.model if model is None else model
        if getattr(self.model, "is3d", True):
            return model(input)
        return model(input.squeeze(1)).unsqueeze(1)

    def _loss(self, output, target, weight):
        if weight is None:
            return self.loss_criterion(output, target)
        return self.loss_criterion(output, target, weight)

    def _train_step(self, input, target, weight):
        """One optimizer step on this rank's rows (``self._split``: split
        over the ranks, or the whole batch); returns the detached loss and
        output.  In spatial mode, on this rank's slab of the batch: the
        ranks' mean loss and no output."""
        self.model.train()
        if self._spatial_step is not None:
            if weight is not None:
                raise ValueError("per-voxel weights are unsupported in "
                                 "spatial mode")
            set_learning_rate(self.optimizer, self.current_lr)
            group, axis = self.mesh.group, self.spatial_shard_axis
            return self._spatial_step(shard_slab(input, group, axis),
                                      shard_slab(target, group, axis)), None
        self.optimizer.zero_grad(set_to_none=True)
        with mesh_lib.rows_split(self.mesh if self._split else None):
            output = self._apply_model(input, self._ddp)
            loss = self._loss(output, target, weight)
            loss.backward()
        set_learning_rate(self.optimizer, self.current_lr)
        self.optimizer.step()
        return loss.detach(), output.detach()

    # -- loop ----------------------------------------------------------------

    def fit(self):
        while self.num_epochs < self.max_num_epochs:
            if self.train():
                logger.info("Stopping criterion is satisfied. "
                            "Finishing training")
                return
            self.num_epochs += 1
        logger.info(f"Reached maximum number of epochs: "
                    f"{self.max_num_epochs}. Finishing training...")

    def train(self) -> bool:
        train_losses = RunningAverage()
        train_eval_scores = RunningAverage()
        # the loss stays on the device, summed per step, and is read only at
        # log / validation boundaries and at the end of the epoch: the
        # averages equal per-step updates (the batch size is static)
        loss_acc, loss_acc_n, loss_acc_steps = None, 0, 0

        def flush_losses():
            # averaged over the ranks: a ratio loss is the same on each, a
            # per-element mean this rank's rows'
            nonlocal loss_acc, loss_acc_n, loss_acc_steps
            if loss_acc_steps:
                train_losses.update(
                    float(mesh_lib.rank_mean(self.mesh, loss_acc))
                    / loss_acc_steps, loss_acc_n)
                loss_acc, loss_acc_n, loss_acc_steps = None, 0, 0

        for input, target, weight, split in self._device_batches(
                self.loaders["train"]):
            logger.info(f"Training iteration [{self.num_iterations}/"
                        f"{self.max_num_iterations}]. Epoch "
                        f"[{self.num_epochs}/{self.max_num_epochs - 1}]")
            self._split = split
            loss, output = self._train_step(input, target, weight)
            loss_acc = loss if loss_acc is None else loss_acc + loss
            loss_acc_n += input.shape[0] * (self.mesh.size if split else 1)
            loss_acc_steps += 1

            if self.num_iterations % self.validate_after_iters == 0:
                flush_losses()
                eval_score = self.validate()
                if isinstance(self.scheduler, ReduceLROnPlateau):
                    self.current_lr = self.scheduler.step(eval_score)
                elif self.scheduler is not None:
                    self.current_lr = self.scheduler.step()
                self.writer.scalar("learning_rate", self.current_lr,
                                   self.num_iterations)
                self._save_checkpoint(self._is_best_eval_score(eval_score))

            if self.num_iterations % self.log_after_iters == 0:
                flush_losses()
                if output is None:  # spatial mode: no output, no score
                    logger.info(f"Training stats. Loss: {train_losses.avg}.")
                    self._log_stats("train", train_losses.avg, None)
                else:
                    self._log_train(input, target, output, split,
                                    train_losses, train_eval_scores)

            if self._preempted:
                logger.info("Preemption requested: checkpointing and "
                            "stopping")
                self._save_checkpoint(is_best=False)
                return True
            if self.should_stop():
                return True
            self.num_iterations += 1
        flush_losses()
        return False

    def _log_train(self, input, target, output, split, train_losses,
                   train_eval_scores) -> None:
        """The train score and images of a log step (rank 0 on the
        gathered global batch when its rows are split)."""
        if split:
            input, target, output = (mesh_lib.gather_rows(self.mesh, v)
                                     for v in (input, target, output))
        if not self.skip_train_validation and is_primary():
            act = self.model.final_activation()
            scored = act(output) if act is not None else output
            train_eval_scores.update(
                float(self.eval_criterion(scored, target)), input.shape[0])
        logger.info(f"Training stats. Loss: {train_losses.avg}. "
                    f"Evaluation score: {train_eval_scores.avg}")
        self._log_stats("train", train_losses.avg, train_eval_scores.avg)
        if is_primary():
            self._log_images(input, target, output, "train_")

    def should_stop(self) -> bool:
        if self.max_num_iterations < self.num_iterations:
            logger.info(f"Maximum number of iterations "
                        f"{self.max_num_iterations} exceeded.")
            return True
        min_lr = 1e-6
        if self.current_lr < min_lr:
            logger.info(f"Learning rate below the minimum {min_lr}.")
            return True
        return False

    @torch.no_grad()
    def validate(self) -> float:
        logger.info("Validating...")
        val_losses = RunningAverage()
        val_scores = RunningAverage()
        self.model.eval()
        for i, (input, target, weight, split) in enumerate(
                self._device_batches(self.loaders["val"],
                                     whole_targets=True)):
            logger.info(f"Validation iteration {i}")
            output = self._apply_model(input)
            if split:  # every rank scores the whole batch
                input, output = (mesh_lib.gather_rows(self.mesh, v)
                                 for v in (input, output))
            loss = self._loss(output, target, weight)
            val_losses.update(float(loss), input.shape[0])
            if i % 100 == 0 and is_primary():
                self._log_images(input, target, output, "val_")
            # kept on purpose: the raw (un-activated) output is scored
            val_scores.update(float(self.eval_criterion(output, target)),
                              input.shape[0])
            if self.validate_iters is not None and self.validate_iters <= i:
                break
        self._log_stats("val", val_losses.avg, val_scores.avg)
        logger.info(f"Validation finished. Loss: {val_losses.avg}. "
                    f"Evaluation score: {val_scores.avg}")
        return val_scores.avg

    # -- helpers -------------------------------------------------------------

    def _is_best_eval_score(self, eval_score: float) -> bool:
        if self.eval_score_higher_is_better:
            is_best = eval_score > self.best_eval_score
        else:
            is_best = eval_score < self.best_eval_score
        if is_best:
            logger.info(f"Saving new best evaluation metric: {eval_score}")
            self.best_eval_score = eval_score
        return is_best

    def _log_stats(self, phase: str, loss_avg: float,
                   eval_score_avg: Optional[float]) -> None:
        self.writer.scalar(f"{phase}_loss_avg", loss_avg, self.num_iterations)
        if eval_score_avg is not None:
            self.writer.scalar(f"{phase}_eval_score_avg", eval_score_avg,
                               self.num_iterations)

    def _log_images(self, input, target, prediction, prefix: str = ""):
        act = self.model.final_activation()
        if act is not None:
            prediction = act(prediction)
        for name, batch in (("inputs", input), ("targets", target),
                            ("predictions", prediction)):
            if batch is None or batch.ndim < 4:
                continue
            if batch.ndim == 5:  # only the middle z slice is drawn
                batch = batch[:, batch.shape[1] // 2: batch.shape[1] // 2 + 1]
            for tag, image in self.tensorboard_formatter(
                    name, batch.float().cpu().numpy()):
                self.writer.image(prefix + tag, image, self.num_iterations)

"""The HF-Trainer-shaped 2D training runtime (the JAX package's
``train/trainer2d.py``), on one device or data-parallel.

``TrainingArguments`` (the reference CLI's names and defaults), ``Trainer``
with ``train()`` / ``evaluate()`` / ``save_model()``, a ``compute_metrics``
hook and callbacks.  The semantics are the JAX package's:

- AdamW (b1 0.9, b2 0.999, eps 1e-8, decoupled weight decay) at a rate
  set before every optimizer step from optax's schedule: with warmup,
  linear 0 → lr over ``int(warmup_ratio · optimizer steps)`` steps (the
  first step runs at rate 0), then lr → 0; without, lr → 0 from the
  first step;
- the gradients clipped to ``max_grad_norm`` as optax's
  ``clip_by_global_norm`` does (×max_norm/norm when norm ≥ max_norm, no
  epsilon);
- gradient accumulation as ``optax.MultiSteps``: k micro-steps averaged,
  clipped, one update and one schedule step every k-th call;
- the train loss summed on the device every step and read only at logging
  boundaries; ``training_loss`` averages every step;
- train-time augmentation on the device (``transforms.device2d``) from a
  generator seeded ``seed + 1``, CGM's dropout from one seeded ``seed + 2``;
- the model in training mode for steps (BatchNorm on batch statistics, its
  running statistics updated once per micro-step, as under
  ``optax.MultiSteps``) and in eval mode for evaluation (running
  statistics); a parameter that gets no gradient in a step (CGM's gate
  conv, behind an argmax) takes a zero one, so AdamW still decays it as
  optax does;
- streaming evaluation: two passes (the mean-of-sigmoided-predictions
  threshold, then thresholded IoU/Dice sums), one pass for a fixed
  ``eval_threshold``, argmax macro IoU/Dice for more than one class;
- ``checkpoint-N/`` bundles (``config.json`` + flax ``params.msgpack``
  with ``batch_stats`` for BatchNorm models) with ``save_total_limit``
  rotation.

PyTorch in place of jit: the model is a ``UNetModel`` holding float32
master weights on the device the trainer runs on (the card by default;
``device="cpu"`` when asked); ``loss.backward()`` runs ``double_conv2d``,
whose forward is kernel 1 on the card (the classic UNet; the UNet-3+
family runs cuDNN convs and PyTorch ops).  Host batches reach the card from
pinned memory on a side stream, one batch ahead; ``dataset_on_device``
keeps the train set on the card as uint8 and samples i.i.d. batches from a
device generator.

Data parallelism (``mesh``, ``parallel.make_mesh``; one process per device
in a process group, ``parallel.distributed.initialize``): the model runs
under DDP, each rank takes ``per_device_train_batch_size`` rows of every
global batch (the loader's ``process_shard``), and the step is the global
batch's as the JAX package's GSPMD step computes it: BatchNorm's
statistics and the ratio losses' sums are all-reduced
(``parallel.rows_split``), the augmentation draws are the global batch's,
the clip reads the averaged gradient.  Evaluation splits each global batch
over the ranks (a tail that does not divide goes whole to every rank) and
all-reduces its sums.  Only the primary rank writes checkpoints, metrics
and plots.

The model axis (``mesh=make_mesh(n_data, n_model)``): everything above
runs over the data axis (the global batch is ``per_device_train_batch_size
× n_data``; the ranks of one data index take the same rows and draw the
same augmentation and dropout streams).  ``tensor_parallel`` (with a model
axis over 1) shards the conv out-channels over the model axis
(``parallel/tensor.py``: a DoubleConvolution runs kernel 1's two convs
apart on each rank's block, the all-gather of z between them); the clip
reads the replicated model's global norm; ``save_model`` gathers the whole
weights.  ``zero1`` (with a data axis over 1) shards AdamW's state over
the data axis (``parallel/zero.py``).
``profile_dir`` traces steps ``profile_start_step`` to ``+
profile_num_steps`` with ``torch.profiler`` (``train/profiling.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import shutil
import time
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from ..data.collate import BatchLoader, SliceCollator
from ..metrics.metrics2d import (
    iou_dice_sums,
    multiclass_iou_dice_sums,
    plot_first_element,
    pred_mean_sum,
    quirky_sigmoid,
)
from ..parallel import mesh as mesh_lib
from ..parallel import tensor as tp
from ..parallel.distributed import is_primary
from ..parallel.zero import Zero1Optimizer
from ..transforms.device2d import (
    Augment2DConfig,
    AugmentDraws,
    apply_augment,
    draw_augment,
)
from . import profiling
from .callbacks import TrainerCallback, TrainerControl
from .logging_utils import MetricWriter, NullMetricWriter, get_logger
from .optimizers import set_learning_rate
from .prefetch import device_batches
from .train_state import TrainState, create_train_state

logger = get_logger(__name__)


@dataclasses.dataclass
class TrainingArguments:
    """The reference CLI surface as a dataclass: every field and default of
    the JAX package's ``TrainingArguments``.  ``bf16`` is carried for the
    CLI; the model's ``compute_dtype`` sets the precision."""

    output_dir: str = "output"
    eval_strategy: str = "steps"  # "no" | "steps" | "epoch"
    eval_steps: int = 100
    logging_steps: int = 100
    num_train_epochs: float = 5000
    max_steps: int = -1  # >0 overrides epochs
    per_device_train_batch_size: int = 5
    per_device_eval_batch_size: int = 5
    gradient_accumulation_steps: int = 1
    save_steps: int = 1000
    save_total_limit: int = 5
    warmup_ratio: float = 0.001
    learning_rate: float = 0.005
    weight_decay: float = 0.001
    max_grad_norm: float = 1.0  # HF's default clip; 0 disables
    metric_for_best_model: str = "iou"
    greater_is_better: bool = True
    seed: int = 42
    augment: bool = True
    # the train set on the device as uint8 (≤ 2 GB), i.i.d. batches drawn
    # there: no host-to-device copy per step
    dataset_on_device: bool = False
    dataloader_num_workers: int = 0
    dataloader_prefetch: int = 2
    eval_threshold: Optional[float] = None  # None → the mean threshold
    plot_eval: bool = False  # output.png of sample 0 at every eval
    log_dir: Optional[str] = None
    bf16: bool = False
    # shard conv out-channels (and their optimizer state) over the mesh's
    # model axis (parallel/tensor.py); needs a mesh with n_model > 1
    tensor_parallel: bool = False
    # ZeRO-1 (parallel/zero.py): AdamW's state sharded over the data axis
    zero1: bool = False
    profile_dir: Optional[str] = None  # torch.profiler trace of steps 10-13
    profile_start_step: int = 10
    profile_num_steps: int = 3

    def __post_init__(self):
        if self.eval_strategy not in ("no", "steps", "epoch"):
            # a typo ('step', 'epochs') would otherwise silently disable
            # evaluation: every consumer compares equality
            raise ValueError(
                f"eval_strategy must be 'no', 'steps' or 'epoch'; "
                f"got {self.eval_strategy!r}")


@dataclasses.dataclass
class TrainOutput:
    global_step: int
    training_loss: float
    metrics: Dict[str, float]


def linear_schedule(init: float, end: float, steps: int
                    ) -> Callable[[int], float]:
    """optax.linear_schedule: init → end over ``steps``, then end."""
    def rate(count: int) -> float:
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end
    return rate


def _checked_device(device: Union[str, torch.device]) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available; pass device='cpu' to train on the CPU")
    return device


class Trainer:
    """Trainer for the 2D model bundle (``UNetModel``) on one device or,
    over ``mesh``, data-parallel."""

    def __init__(self, model, args: TrainingArguments, train_dataset=None,
                 eval_dataset=None,
                 data_collator: Optional[SliceCollator] = None,
                 compute_metrics: Optional[Callable] = None,
                 callbacks: Optional[List[TrainerCallback]] = None,
                 mesh=None, device: Union[str, torch.device] = "cuda"):
        if any(p.dtype != torch.float32 or not p.requires_grad
               for p in model.parameters()):
            raise ValueError("the trainer updates float32 master weights "
                             "that require grad; a for_inference() copy "
                             "cannot be trained")
        self.device = _checked_device(device)
        self.mesh = (mesh if mesh is not None
                     else mesh_lib.make_mesh(device=self.device))
        self.model = model.to(self.device)
        # as in JAX: each takes effect only on an axis of more than 1
        self.tensor_parallel = bool(args.tensor_parallel
                                    and self.mesh.model_size > 1)
        self.zero1 = bool(args.zero1 and self.mesh.size > 1)
        if self.tensor_parallel:
            tp.shard_params_tp(self.model, self.mesh)
        # CGM's gate conv sits behind an argmax: it gets no gradient
        self._ddp = mesh_lib.wrap_ddp(self.model, self.device, (
            getattr(getattr(model, "config", None), "unet_type", "")
            == "UNet_3Plus_DeepSup_CGM"), mesh=self.mesh)
        self.args = args
        self.train_dataset = train_dataset
        self.eval_dataset = eval_dataset
        self.data_collator = data_collator or SliceCollator()
        self.compute_metrics = compute_metrics
        self.callbacks = callbacks or []
        self.control = TrainerControl()
        # only the primary rank writes logs and checkpoints
        self.writer = (MetricWriter(args.log_dir or os.path.join(
            args.output_dir, "logs")) if is_primary() else NullMetricWriter())
        self.state: Optional[TrainState] = None
        self._saved_checkpoints: List[str] = []
        self.best_metric: Optional[float] = None
        # global batches; each rank takes its per_device rows of them
        self.train_batch = args.per_device_train_batch_size * self.mesh.size
        self.eval_batch = args.per_device_eval_batch_size * self.mesh.size
        self._multiclass_eval = getattr(
            getattr(model, "config", None), "out_channels", 1) > 1
        self._aug_cfg = Augment2DConfig()
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)
        # the global gradient norm of the last optimizer step, before the
        # clip (a 0-d tensor on the device; read by whoever wants it)
        self.last_grad_norm: Optional[torch.Tensor] = None

    def install_preemption_handler(self, signals=None):
        """SIGTERM/SIGINT → save the model and stop at the next step."""
        import signal as _signal

        def _handler(*_):
            self.control.should_save = True
            self.control.should_stop = True

        for sig in signals or (_signal.SIGTERM, _signal.SIGINT):
            _signal.signal(sig, _handler)
        logger.info("preemption handler installed")

    # -- setup ---------------------------------------------------------------

    def _num_train_steps(self) -> int:
        if self.args.max_steps > 0:
            return self.args.max_steps
        if self.train_dataset is None:
            # eval-only: the count only sizes the schedule, never stepped
            return 1
        steps_per_epoch = max(len(self.train_dataset) // self.train_batch, 1)
        return int(self.args.num_train_epochs * steps_per_epoch)

    def _build_schedule(self, total_steps: int) -> Callable[[int], float]:
        # under accumulation the schedule advances every k-th call, so it
        # spans optimizer steps and reaches 0 at the end of training
        k = max(self.args.gradient_accumulation_steps, 1)
        opt_steps = -(-total_steps // k)
        warmup = int(self.args.warmup_ratio * opt_steps)
        lr = self.args.learning_rate
        if warmup <= 0:
            # HF's zero-warmup schedule starts at the full rate
            return linear_schedule(lr, 0.0, max(opt_steps, 1))
        up = linear_schedule(0.0, lr, warmup)
        down = linear_schedule(lr, 0.0, max(opt_steps - warmup, 1))
        return lambda count: up(count) if count < warmup else down(
            count - warmup)

    def _init_state(self, total_steps: int) -> None:
        schedule = self._build_schedule(total_steps)
        optimizer = torch.optim.AdamW(
            self.model.parameters(), lr=schedule(0), betas=(0.9, 0.999),
            eps=1e-8, weight_decay=self.args.weight_decay)
        if self.zero1:
            optimizer = Zero1Optimizer(optimizer, self.model, self.mesh)
        self.state = create_train_state(self.model, optimizer, schedule)
        # the same stream on every rank: the global batch's draws
        self._gen = torch.Generator(device=self.device).manual_seed(
            self.args.seed + 1)
        # dropout masks of this rank's rows: a stream of its own
        self._drop_gen = torch.Generator(device=self.device).manual_seed(
            self.args.seed + 2 + 1_000_003 * self.mesh.rank)

    # -- steps ---------------------------------------------------------------

    def _apply_update(self) -> None:
        """One optimizer step on the accumulated gradients: average them
        over the micro-steps, clip, set the scheduled rate, AdamW."""
        st, args = self.state, self.args
        params = [p for p in self.model.parameters() if p.requires_grad]
        for p in params:
            if p.grad is None:  # optax updates (and decays) it all the same
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        k = max(args.gradient_accumulation_steps, 1)
        if k > 1:
            torch._foreach_div_(grads, float(k))
        if self.tensor_parallel:
            norm = tp.grad_norm_squared(params, self.model).sqrt()
        else:
            norm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(grads)))
        self.last_grad_norm = norm
        if args.max_grad_norm and args.max_grad_norm > 0:
            scale = torch.where(norm < args.max_grad_norm,
                                torch.ones_like(norm), args.max_grad_norm / norm)
            torch._foreach_mul_(grads, scale)
        set_learning_rate(st.optimizer, st.schedule(st.opt_step))
        st.optimizer.step()
        st.optimizer.zero_grad(set_to_none=True)
        st.opt_step += 1

    def _rank_rows(self, n: int) -> slice:
        """This rank's ``n`` rows of a global batch."""
        return slice(self.mesh.rank * n, (self.mesh.rank + 1) * n)

    def _train_step(self, images: torch.Tensor, labels: torch.Tensor
                    ) -> torch.Tensor:
        """One micro-step on this rank's rows of the global batch (forward,
        backward; an update every k-th); returns the detached loss."""
        if self.args.augment:
            rows = self._rank_rows(images.shape[0])
            draws = draw_augment(self.train_batch, self._aug_cfg, self._gen)
            images, labels = apply_augment(images, labels, AugmentDraws(**{
                f.name: getattr(draws, f.name)[rows]
                for f in dataclasses.fields(draws)}))
        self.model.train()
        st = self.state
        k = max(self.args.gradient_accumulation_steps, 1)
        # the ranks' gradients are averaged at the micro-step of the update
        sync = (st.mini_step + 1 >= k
                or not hasattr(self._ddp, "no_sync"))
        with (contextlib.nullcontext() if sync else self._ddp.no_sync()), \
                mesh_lib.rows_split(self.mesh):
            loss = self._ddp(images, labels, generator=self._drop_gen).loss
            loss.backward()
        st.step += 1
        st.mini_step += 1
        if st.mini_step >= k:
            st.mini_step = 0
            self._apply_update()
        return loss.detach()

    def _train_step_resident(self, images_all: torch.Tensor,
                             labels_all: torch.Tensor) -> torch.Tensor:
        """A uint8 minibatch drawn i.i.d. on the device, normalized there:
        this rank's rows of the global batch's draw."""
        idx = torch.randint(0, images_all.shape[0], (self.train_batch,),
                            generator=self._gen, device=self.device)
        idx = idx[self._rank_rows(self.args.per_device_train_batch_size)]
        images = images_all[idx].float() / 255.0
        labels = labels_all[idx].float()
        return self._train_step(images, labels)

    @torch.inference_mode()
    def _eval_forward(self, batch):
        self.model.eval()
        return self.model(batch["images"], batch["labels"])

    # -- public API ----------------------------------------------------------

    def _maybe_residence(self):
        """The train set as device-resident uint8 tensors when enabled,
        else None (the streaming path)."""
        if not self.args.dataset_on_device:
            return None
        n = len(self.train_dataset)
        sample = self.train_dataset[0]
        bytes_total = n * (sample["image"].nbytes + sample["mask"].nbytes) // 4
        if bytes_total > 2 * 1024**3:
            logger.warning("dataset_on_device requested but the dataset "
                           "exceeds 2 GB uint8; using the streaming loader")
            return None
        logger.info(f"dataset-on-device: {n} samples, "
                    f"~{bytes_total / 1e6:.0f} MB uint8 on {self.device}")
        images = np.stack([
            np.clip(self.train_dataset[i]["image"] * 255, 0, 255)
            .astype(np.uint8) for i in range(n)])
        labels = np.stack([(self.train_dataset[i]["mask"] > 0.5)
                           .astype(np.uint8) for i in range(n)])
        return (torch.from_numpy(images).to(self.device),
                torch.from_numpy(labels).to(self.device))

    def _device_batches(self, loader):
        return device_batches(loader, self.device, self._copy_stream)

    def _flush_loss_interval(self) -> Optional[float]:
        """Read the device-side loss sum, averaged over the ranks (a ratio
        loss is the same on each; a per-element mean is this rank's rows');
        returns the interval mean (None for an empty interval) and folds it
        into the run totals."""
        if self._loss_n == 0:
            return None
        interval_sum = float(mesh_lib.rank_mean(self.mesh, self._loss_acc))
        self._total_loss += interval_sum
        self._total_n += self._loss_n
        mean = interval_sum / self._loss_n
        self._loss_acc, self._loss_n = None, 0
        return mean

    def _loop_bookkeeping(self, loss, global_step, total_steps,
                          t_start) -> bool:
        """Logging / eval / checkpoint / stop logic of both loops; returns
        True when training should stop."""
        # summed on the device every step (no host sync); read at logging
        # boundaries only, so training_loss averages every step
        self._loss_acc = loss if self._loss_acc is None else (
            self._loss_acc + loss)
        self._loss_n += 1
        if self.args.logging_steps and global_step % self.args.logging_steps == 0:
            mean = self._flush_loss_interval()
            elapsed = time.time() - t_start
            steps_run = global_step - self._start_step
            logs = {
                "loss": mean,
                "step": global_step,
                "steps_per_sec": steps_run / elapsed,
                "samples_per_sec": steps_run * self.train_batch / elapsed,
            }
            self.writer.scalars(
                {"train/loss": logs["loss"],
                 "train/samples_per_sec": logs["samples_per_sec"]},
                global_step)
            logger.info(f"step {global_step}: {logs}")
            for cb in self.callbacks:
                cb.on_log(self.args, self.state, self.control, logs)

        if (self.args.eval_strategy == "steps" and self.args.eval_steps
                and global_step % self.args.eval_steps == 0
                and self.eval_dataset is not None):
            self.evaluate()

        if self.args.save_steps and global_step % self.args.save_steps == 0:
            self._save_checkpoint(global_step)

        if self.control.should_save:
            self.control.should_save = False
            self.save_model()

        return global_step >= total_steps or self.control.should_stop

    def train(self) -> TrainOutput:
        if self.train_dataset is None:
            raise ValueError("no train_dataset")
        total_steps = self._num_train_steps()
        loader = BatchLoader(
            self.train_dataset, self.train_batch, shuffle=True,
            seed=self.args.seed, collator=self.data_collator,
            num_workers=self.args.dataloader_num_workers,
            prefetch=self.args.dataloader_prefetch,
            process_shard=((self.mesh.rank, self.mesh.size)
                           if self.mesh.size > 1 else None))
        # the JAX trainer draws one batch here to size its state, which
        # starts (and skips) epoch 0: drawn the same, the order stays its
        next(iter(loader))
        if self.state is None:
            self._init_state(total_steps)

        self._loss_acc, self._loss_n = None, 0
        self._total_loss, self._total_n = 0.0, 0
        global_step = self.state.step
        self._start_step = global_step
        t_start = time.time()

        logger.info(f"***** training: {total_steps} steps, global batch "
                    f"{self.train_batch} on {self.mesh.size} x "
                    f"{self.device} *****")
        resident = self._maybe_residence()
        done = False
        args = self.args
        profiler, tracing = contextlib.ExitStack(), False
        # resident sampling has no epochs: eval_strategy='epoch' maps to an
        # epoch-equivalent step cadence
        steps_per_epoch = max(1, -(-len(self.train_dataset)
                                   // self.train_batch))
        while not done:
            if resident is not None:
                while not done:
                    loss = self._train_step_resident(*resident)
                    global_step += 1
                    done = self._loop_bookkeeping(loss, global_step,
                                                  total_steps, t_start)
                    if (self.args.eval_strategy == "epoch"
                            and self.eval_dataset is not None
                            and global_step % steps_per_epoch == 0):
                        self.evaluate()
                break
            for batch in self._device_batches(loader):
                if (args.profile_dir and not tracing
                        and global_step == args.profile_start_step):
                    profiler.enter_context(profiling.trace(args.profile_dir))
                    tracing = True
                loss = self._train_step(batch["images"], batch["labels"])
                global_step += 1
                if tracing and global_step >= (args.profile_start_step
                                               + args.profile_num_steps):
                    loss.item()  # the traced steps' work is done
                    profiler.close()
                    tracing = False
                    logger.info(f"profiler trace written to "
                                f"{args.profile_dir}")
                if self._loop_bookkeeping(loss, global_step, total_steps,
                                          t_start):
                    done = True
                    break
            if (self.args.eval_strategy == "epoch"
                    and self.eval_dataset is not None):
                self.evaluate()

        profiler.close()
        self._flush_loss_interval()  # the partial tail interval
        train_loss = self._total_loss / max(self._total_n, 1)
        return TrainOutput(global_step, train_loss, {"train_loss": train_loss})

    def evaluate(self, eval_dataset=None) -> Dict[str, float]:
        dataset = eval_dataset or self.eval_dataset
        if dataset is None:
            raise ValueError("no eval_dataset")
        if self.state is None:
            self._init_state(max(self._num_train_steps(), 1))

        if self.compute_metrics is not None:
            metrics = self._evaluate_full_gather(dataset)
        else:
            metrics = self._evaluate_streaming(dataset)

        step = self.state.step
        self.writer.scalars(metrics, step)
        logger.info(f"eval @ {step}: {metrics}")

        key = f"eval_{self.args.metric_for_best_model}"
        if key in metrics:
            value = metrics[key]
            better = (self.best_metric is None
                      or (value > self.best_metric)
                      == self.args.greater_is_better)
            if better:
                self.best_metric = value
        for cb in self.callbacks:
            cb.on_evaluate(self.args, self.state, self.control, metrics)
        return metrics

    _EVAL_LOADER_CACHE_MAX = 4

    def _eval_loader(self, dataset) -> BatchLoader:
        # one loader per dataset (each owns a worker pool, and eval runs two
        # passes), in a small LRU whose evicted loaders are closed
        cache = getattr(self, "_eval_loader_cache", None)
        if cache is None:
            cache = self._eval_loader_cache = {}
        key = id(dataset)
        if key in cache:
            cache[key] = cache.pop(key)
        else:
            while len(cache) >= self._EVAL_LOADER_CACHE_MAX:
                _, old = cache.pop(next(iter(cache)))
                old.close()
            cache[key] = (
                dataset,  # keeps id(dataset) valid while cached
                BatchLoader(dataset, self.eval_batch, shuffle=False,
                            collator=self.data_collator,
                            num_workers=self.args.dataloader_num_workers,
                            prefetch=self.args.dataloader_prefetch),
            )
        return cache[key][1]

    def close_loaders(self) -> None:
        """Close all cached eval loaders (worker threads, pinned datasets)."""
        cache = getattr(self, "_eval_loader_cache", None) or {}
        for _, loader in cache.values():
            loader.close()
        cache.clear()

    def _eval_batches(self, dataset):
        """(device rows, their count, host batch, split) per global eval
        batch: the wrap-padded tail rows are dropped before the forward, so
        the batch-mean loss never sees a duplicate; then this rank's rows
        when the batch divides over the ranks (``split``), else the whole
        batch on every rank."""
        n_remaining = len(dataset)
        trimmed = []

        def host():
            nonlocal n_remaining
            for batch in self._eval_loader(dataset):
                n_valid = min(n_remaining, self.eval_batch)
                n_remaining -= n_valid
                if n_valid < self.eval_batch:
                    batch = {k: v[:n_valid] for k, v in batch.items()}
                split = (self.mesh.size > 1
                         and mesh_lib.divides(self.mesh, batch))
                rows = mesh_lib.shard_batch(self.mesh, batch)
                trimmed.append((len(rows["images"]), batch, split))
                yield rows

        for dev in self._device_batches(host()):
            n_rows, batch, split = trimmed.pop(0)
            yield dev, n_rows, batch, split

    def _plot(self, pred0: torch.Tensor, batch, threshold: float,
              binarize: bool = False) -> None:
        labs0 = np.asarray(batch["labels"][:1], np.float32)
        if labs0.ndim == 4 and labs0.shape[-1] == 1:
            labs0 = labs0[..., 0]
        p0 = pred0.float().cpu().numpy()
        if p0.ndim == 3 and p0.shape[-1] == 1:
            p0 = p0[..., 0]
        if binarize:  # class maps: foreground vs background
            p0, labs0 = (p0 > 0).astype(np.float32), (labs0 > 0).astype(
                np.float32)
        plot_first_element(p0[None], labs0, threshold=threshold,
                           save_path=os.path.join(self.args.output_dir,
                                                  "output.png"))

    def _eval_sums(self, dataset, sums_of) -> torch.Tensor:
        """One pass over ``dataset``: ``sums_of(out, dev, n, i, batch)``
        gives each batch's [loss · rows, Σ mean prediction, IoU sum, Dice
        sum, rows] over its ``n`` rows on this rank; the global totals.  A
        batch split over the ranks runs under ``rows_split`` and its sums
        are all-reduced; a tail that every rank computed whole is not."""
        acc = {split: torch.zeros(5, device=self.device)
               for split in (True, False)}
        for i, (dev, n, batch, split) in enumerate(
                self._eval_batches(dataset)):
            with mesh_lib.rows_split(self.mesh if split else None):
                out = self._eval_forward(dev)
            acc[split] = acc[split] + sums_of(out, dev, n, i, batch)
        return mesh_lib.all_sum(acc[True], self.mesh) + acc[False]

    def _evaluate_streaming(self, dataset) -> Dict[str, float]:
        """O(batch)-memory eval, sums kept on the device: pass 1 the loss
        and the global mean of the sigmoided predictions (the reference's
        dynamic threshold), pass 2 the thresholded per-sample IoU/Dice sums
        (one pass for a fixed threshold or a multi-class head)."""
        n_total = len(dataset)
        fixed_thr = self.args.eval_threshold
        plot = self.args.plot_eval and is_primary()
        zero = torch.zeros((), device=self.device)

        def row(loss, pred, iou, dice, n):
            return torch.stack([loss, pred, iou, dice, zero + n])

        if self._multiclass_eval:
            def multiclass(out, dev, n, i, batch):
                isum, dsum = multiclass_iou_dice_sums(out.logits,
                                                      dev["labels"], n)
                if i == 0 and plot:
                    self._plot(torch.argmax(out.logits[0], dim=-1), batch,
                               0.5, binarize=True)
                return row(out.loss * n, zero, isum, dsum, n)

            return self._eval_result(self._eval_sums(dataset, multiclass),
                                     n_total)

        if fixed_thr is None:
            first = self._eval_sums(dataset, lambda out, dev, n, i, b: row(
                out.loss * n, pred_mean_sum(out.logits, n), zero, zero, n))
            thr = float(first[1]) / max(float(first[4]), 1)
        else:
            thr = fixed_thr

        def metric(out, dev, n, i, batch):
            isum, dsum = iou_dice_sums(out.logits, dev["labels"], thr, n)
            if i == 0 and plot:
                self._plot(quirky_sigmoid(out.logits[0].float()), batch, thr)
            if fixed_thr is not None:  # the loss rides along
                return row(out.loss * n, zero, isum, dsum, n)
            return row(zero, zero, isum, dsum, 0)

        sums = self._eval_sums(dataset, metric)
        if fixed_thr is None:
            sums = torch.stack([first[0], first[1], sums[2], sums[3],
                                first[4]])
        return self._eval_result(sums, n_total)

    @staticmethod
    def _eval_result(sums: torch.Tensor, n_total: int) -> Dict[str, float]:
        loss_sum, _, iou_sum, dice_sum, n_seen = sums.tolist()
        return {
            "eval_iou": iou_sum / max(n_total, 1),
            "eval_dice": dice_sum / max(n_total, 1),
            "eval_loss": loss_sum / n_seen if n_seen else float("nan"),
        }

    def _evaluate_full_gather(self, dataset) -> Dict[str, float]:
        """For user ``compute_metrics`` hooks that need the full (logits,
        labels) arrays on the host: one process only."""
        if self.mesh.size > 1:
            raise ValueError("a compute_metrics hook needs every logit in "
                             "one process; under data parallelism use the "
                             "default streaming metrics")
        all_logits, all_labels, losses = [], [], []
        for dev, n_valid, batch, _ in self._eval_batches(dataset):
            out = self._eval_forward(dev)
            all_logits.append(out.logits.float().cpu().numpy())
            all_labels.append(batch["labels"])
            losses.append((float(out.loss), n_valid))
        logits = np.concatenate(all_logits, axis=0)
        labels = np.concatenate(all_labels, axis=0)
        metrics = self.compute_metrics(logits, labels)
        metrics = {f"eval_{k}": v for k, v in metrics.items()}
        n_seen = sum(t for _, t in losses)
        metrics["eval_loss"] = (sum(l * t for l, t in losses) / n_seen
                                if n_seen else float("nan"))
        return metrics

    # -- persistence ---------------------------------------------------------

    def save_model(self, path: Optional[str] = None):
        """The whole model, written by the primary; every rank calls it (a
        tensor-parallel model gathers its weights first)."""
        path = path or self.args.output_dir
        with tp.full_parameters(self.model):
            if not is_primary():
                return  # the replicas are equal; one process writes
            self.model.save_pretrained(path)
        logger.info(f"model saved to {path}")

    def _save_checkpoint(self, step: int):
        path = os.path.join(self.args.output_dir, f"checkpoint-{step}")
        self.save_model(path)
        if not is_primary():
            return
        self._saved_checkpoints.append(path)
        limit = self.args.save_total_limit
        while limit and len(self._saved_checkpoints) > limit:
            victim = self._saved_checkpoints.pop(0)
            shutil.rmtree(victim, ignore_errors=True)


class CustomTrainer(Trainer):
    """The reference trainer subclass's name; the loss-from-outputs
    behaviour is the default here."""

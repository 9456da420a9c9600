"""The HF-Trainer-shaped 2D training runtime (the JAX package's
``train/trainer2d.py``), on one device.

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
  generator seeded ``seed + 1``;
- streaming evaluation: two passes (the mean-of-sigmoided-predictions
  threshold, then thresholded IoU/Dice sums), one pass for a fixed
  ``eval_threshold``, argmax macro IoU/Dice for more than one class;
- ``checkpoint-N/`` bundles (``config.json`` + flax ``params.msgpack``)
  with ``save_total_limit`` rotation.

PyTorch in place of jit: the model is a ``UNetModel`` holding float32
master weights on the device the trainer runs on (the card by default;
``device="cpu"`` when asked); ``loss.backward()`` runs ``double_conv2d``,
whose forward is kernel 1 on the card.  Host batches reach the card from
pinned memory on a side stream, one batch ahead; ``dataset_on_device``
keeps the train set on the card as uint8 and samples i.i.d. batches from a
device generator.  The JAX scale-out options (``mesh``,
``tensor_parallel``, ``zero1``) and the profiler trace (``profile_dir``)
raise.
"""

from __future__ import annotations

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
from ..transforms.device2d import Augment2DConfig, augment_batch
from .callbacks import TrainerCallback, TrainerControl
from .logging_utils import MetricWriter, get_logger
from .optimizers import set_learning_rate
from .prefetch import device_batches
from .train_state import TrainState, create_train_state

logger = get_logger(__name__)

PARALLEL_ITEM = "ROADMAP.md queue 1, item 25 (parallel modes)"
TOOLING_ITEM = "ROADMAP.md queue 1, item 26 (tooling)"


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
    tensor_parallel: bool = False  # raises: item 25
    zero1: bool = False            # raises: item 25
    profile_dir: Optional[str] = None  # raises: item 26
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
    """Trainer for the 2D model bundle (``UNetModel``) on one device."""

    def __init__(self, model, args: TrainingArguments, train_dataset=None,
                 eval_dataset=None,
                 data_collator: Optional[SliceCollator] = None,
                 compute_metrics: Optional[Callable] = None,
                 callbacks: Optional[List[TrainerCallback]] = None,
                 mesh=None, device: Union[str, torch.device] = "cuda"):
        for name, value in (("mesh", mesh),
                            ("tensor_parallel", args.tensor_parallel),
                            ("zero1", args.zero1)):
            if value:
                raise NotImplementedError(
                    f"{name}: the port trains on one device so far "
                    f"({PARALLEL_ITEM})")
        if args.profile_dir:
            raise NotImplementedError(
                f"profile_dir: the profiler trace is not ported yet "
                f"({TOOLING_ITEM})")
        if any(p.dtype != torch.float32 or not p.requires_grad
               for p in model.parameters()):
            raise ValueError("the trainer updates float32 master weights "
                             "that require grad; a for_inference() copy "
                             "cannot be trained")
        self.device = _checked_device(device)
        self.model = model.to(self.device)
        self.args = args
        self.train_dataset = train_dataset
        self.eval_dataset = eval_dataset
        self.data_collator = data_collator or SliceCollator()
        self.compute_metrics = compute_metrics
        self.callbacks = callbacks or []
        self.control = TrainerControl()
        self.writer = MetricWriter(
            args.log_dir or os.path.join(args.output_dir, "logs"))
        self.state: Optional[TrainState] = None
        self._saved_checkpoints: List[str] = []
        self.best_metric: Optional[float] = None
        self.train_batch = args.per_device_train_batch_size
        self.eval_batch = args.per_device_eval_batch_size
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
        self.state = create_train_state(self.model, optimizer, schedule)
        self._gen = torch.Generator(device=self.device).manual_seed(
            self.args.seed + 1)

    # -- steps ---------------------------------------------------------------

    def _apply_update(self) -> None:
        """One optimizer step on the accumulated gradients: average them
        over the micro-steps, clip, set the scheduled rate, AdamW."""
        st, args = self.state, self.args
        grads = [p.grad for p in self.model.parameters() if p.grad is not None]
        k = max(args.gradient_accumulation_steps, 1)
        if k > 1:
            torch._foreach_div_(grads, float(k))
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        self.last_grad_norm = norm
        if args.max_grad_norm and args.max_grad_norm > 0:
            scale = torch.where(norm < args.max_grad_norm,
                                torch.ones_like(norm), args.max_grad_norm / norm)
            torch._foreach_mul_(grads, scale)
        set_learning_rate(st.optimizer, st.schedule(st.opt_step))
        st.optimizer.step()
        st.optimizer.zero_grad(set_to_none=True)
        st.opt_step += 1

    def _train_step(self, images: torch.Tensor, labels: torch.Tensor
                    ) -> torch.Tensor:
        """One micro-step (forward, backward; an update every k-th);
        returns the detached loss."""
        if self.args.augment:
            images, labels = augment_batch(images, labels, self._aug_cfg,
                                           self._gen)
        self.model.train()
        loss = self.model(images, labels).loss
        loss.backward()
        st = self.state
        st.step += 1
        st.mini_step += 1
        if st.mini_step >= max(self.args.gradient_accumulation_steps, 1):
            st.mini_step = 0
            self._apply_update()
        return loss.detach()

    def _train_step_resident(self, images_all: torch.Tensor,
                             labels_all: torch.Tensor) -> torch.Tensor:
        """A uint8 minibatch drawn i.i.d. on the device, normalized there."""
        idx = torch.randint(0, images_all.shape[0], (self.train_batch,),
                            generator=self._gen, device=self.device)
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
        """Read the device-side loss sum; returns the interval mean (None
        for an empty interval) and folds it into the run totals."""
        if self._loss_n == 0:
            return None
        interval_sum = float(self._loss_acc)
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
            prefetch=self.args.dataloader_prefetch)
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

        logger.info(f"***** training: {total_steps} steps, batch "
                    f"{self.train_batch} on {self.device} *****")
        resident = self._maybe_residence()
        done = False
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
                loss = self._train_step(batch["images"], batch["labels"])
                global_step += 1
                if self._loop_bookkeeping(loss, global_step, total_steps,
                                          t_start):
                    done = True
                    break
            if (self.args.eval_strategy == "epoch"
                    and self.eval_dataset is not None):
                self.evaluate()

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
        """(device batch trimmed to its valid rows, n_valid, host batch):
        the wrap-padded tail rows are dropped before the forward, so the
        batch-mean loss never sees a duplicate."""
        n_remaining = len(dataset)
        trimmed = []

        def host():
            nonlocal n_remaining
            for batch in self._eval_loader(dataset):
                n_valid = min(n_remaining, self.eval_batch)
                n_remaining -= n_valid
                if n_valid < self.eval_batch:
                    batch = {k: v[:n_valid] for k, v in batch.items()}
                trimmed.append((n_valid, batch))
                yield batch

        for dev in self._device_batches(host()):
            n_valid, batch = trimmed.pop(0)
            yield dev, n_valid, batch

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

    def _evaluate_streaming(self, dataset) -> Dict[str, float]:
        """O(batch)-memory eval, sums kept on the device: pass 1 the loss
        and the global mean of the sigmoided predictions (the reference's
        dynamic threshold), pass 2 the thresholded per-sample IoU/Dice sums
        (one pass for a fixed threshold or a multi-class head)."""
        n_total = len(dataset)
        fixed_thr = self.args.eval_threshold
        zero = torch.zeros((), device=self.device)
        loss_sum, pred_sum, iou_sum, dice_sum = zero, zero, zero, zero
        n_seen = 0
        plot = self.args.plot_eval

        if self._multiclass_eval:
            for i, (dev, n_valid, batch) in enumerate(
                    self._eval_batches(dataset)):
                out = self._eval_forward(dev)
                isum, dsum = multiclass_iou_dice_sums(out.logits,
                                                      dev["labels"], n_valid)
                loss_sum = loss_sum + out.loss * n_valid
                iou_sum, dice_sum = iou_sum + isum, dice_sum + dsum
                n_seen += n_valid
                if i == 0 and plot:
                    self._plot(torch.argmax(out.logits[0], dim=-1), batch,
                               0.5, binarize=True)
            return self._eval_result(iou_sum, dice_sum, loss_sum, n_total,
                                     n_seen)

        if fixed_thr is None:
            for dev, n_valid, _ in self._eval_batches(dataset):
                out = self._eval_forward(dev)
                loss_sum = loss_sum + out.loss * n_valid
                pred_sum = pred_sum + pred_mean_sum(out.logits, n_valid)
                n_seen += n_valid
            thr = float(pred_sum) / max(n_seen, 1)
        else:
            thr = fixed_thr

        for i, (dev, n_valid, batch) in enumerate(
                self._eval_batches(dataset)):
            out = self._eval_forward(dev)
            isum, dsum = iou_dice_sums(out.logits, dev["labels"], thr,
                                       n_valid)
            iou_sum, dice_sum = iou_sum + isum, dice_sum + dsum
            if fixed_thr is not None:  # the loss rides along
                loss_sum = loss_sum + out.loss * n_valid
                n_seen += n_valid
            if i == 0 and plot:
                self._plot(quirky_sigmoid(out.logits[0].float()), batch, thr)
        return self._eval_result(iou_sum, dice_sum, loss_sum, n_total, n_seen)

    @staticmethod
    def _eval_result(iou_sum, dice_sum, loss_sum, n_total, n_seen):
        return {
            "eval_iou": float(iou_sum) / max(n_total, 1),
            "eval_dice": float(dice_sum) / max(n_total, 1),
            "eval_loss": float(loss_sum) / n_seen if n_seen else float("nan"),
        }

    def _evaluate_full_gather(self, dataset) -> Dict[str, float]:
        """For user ``compute_metrics`` hooks that need the full (logits,
        labels) arrays on the host."""
        all_logits, all_labels, losses = [], [], []
        for dev, n_valid, batch in self._eval_batches(dataset):
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
        path = path or self.args.output_dir
        self.model.save_pretrained(path)
        logger.info(f"model saved to {path}")

    def _save_checkpoint(self, step: int):
        path = os.path.join(self.args.output_dir, f"checkpoint-{step}")
        self.save_model(path)
        self._saved_checkpoints.append(path)
        limit = self.args.save_total_limit
        while limit and len(self._saved_checkpoints) > limit:
            victim = self._saved_checkpoints.pop(0)
            shutil.rmtree(victim, ignore_errors=True)


class CustomTrainer(Trainer):
    """The reference trainer subclass's name; the loss-from-outputs
    behaviour is the default here."""

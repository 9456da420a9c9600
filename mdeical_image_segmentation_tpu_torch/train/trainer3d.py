"""The 3D ``UNetTrainer`` of the port (the JAX package's
``train/trainer3d.py``), on one device.

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
backward are CUDA kernels on the card.  The
train loss is summed on the device and read only at log and validation
boundaries and at the end of an epoch.  On a CUDA device the next batch is
copied from pinned memory on a side stream while the current step runs.

Loaders are any iterables of (input, target[, weight]) numpy batches,
channels-last (N, D, H, W, C); ``create_trainer`` (the YAML config, HDF5
loaders) waits for the data slice.  The TPU scale-out options (``mesh``,
``tensor_parallel``, ``zero1``, ``spatial_halo``) and orbax checkpoints
raise.
"""

from __future__ import annotations

import os
from datetime import datetime
from typing import Any, Dict, Iterable, Optional

import torch

from ..models.blocks3d import set_dropout_generator
from ..utils.param_bridge import flax_to_state_dict, state_dict_to_flax
from . import checkpoint as ckpt
from .logging_utils import MetricWriter, RunningAverage, get_logger
from .optimizers import ReduceLROnPlateau, set_learning_rate
from .prefetch import device_batches

logger = get_logger("UNetTrainer")

PARALLEL_ITEM = "ROADMAP.md queue 1, item 25 (parallel modes)"
CREATE_TRAINER_ITEM = ("ROADMAP.md queue 1, items 18 and 19 (HDF5 loaders "
                       "and the config-driven trainer)")


def get_number_of_learnable_parameters(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters() if p.requires_grad)


def create_trainer(config: Dict[str, Any]) -> "UNetTrainer":
    raise NotImplementedError(
        f"create_trainer is not ported yet ({CREATE_TRAINER_ITEM}); build "
        "UNetTrainer from get_model, get_loss_criterion, "
        "get_evaluation_metric, create_optimizer and create_lr_scheduler "
        "with in-memory loaders")


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
        for name, value in (("mesh", mesh),
                            ("tensor_parallel", tensor_parallel),
                            ("zero1", zero1), ("spatial_halo", spatial_halo),
                            ("spatial_cross_shard_norm",
                             spatial_cross_shard_norm)):
            if value:
                raise NotImplementedError(
                    f"{name}: the port trains on one device so far "
                    f"({PARALLEL_ITEM})")
        if resume is not None and os.path.isdir(resume):
            raise NotImplementedError(
                f"resume from an orbax directory {resume!r}: only msgpack "
                f"checkpoints are ported ({PARALLEL_ITEM})")
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
        self.best_eval_score = (float("-inf") if eval_score_higher_is_better
                                else float("+inf"))
        logger.info(f"eval_score_higher_is_better: "
                    f"{eval_score_higher_is_better}")
        self.writer = MetricWriter(os.path.join(
            checkpoint_dir, "logs",
            datetime.now().strftime("%Y-%m-%d_%H-%M-%S")))
        self.tensorboard_formatter = tensorboard_formatter
        self.num_iterations = num_iterations
        self.num_epochs = num_epoch
        self.skip_train_validation = skip_train_validation
        self._preempted = False
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)
        set_dropout_generator(model, torch.Generator(
            device=self.device).manual_seed(seed + 1))
        logger.info(f"Number of learnable params "
                    f"{get_number_of_learnable_parameters(model)}")
        if resume is not None:
            self._restore(resume, with_state=True)
        elif pre_trained is not None:
            self._restore(pre_trained, with_state=False)

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
        """Load the params of a checkpoint (the JAX package's or the
        port's); with ``with_state`` also the optimizer state, the counters
        and the best score."""
        logger.info(f"Loading {'checkpoint' if with_state else 'pre-trained'}"
                    f" '{path}'...")
        saved = ckpt.load_checkpoint(path)
        self.model.load_state_dict(
            flax_to_state_dict(saved["model_state_dict"]["params"]))
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

    def _save_checkpoint(self, is_best: bool) -> None:
        path = os.path.join(self.checkpoint_dir, ckpt.LAST_NAME)
        logger.info(f"Saving checkpoint to '{path}'")
        ckpt.save_checkpoint({
            "num_epochs": self.num_epochs + 1,
            "num_iterations": self.num_iterations,
            "model_state_dict": {
                "params": state_dict_to_flax(self.model.state_dict())[
                    "params"],
                "batch_stats": {}},
            "best_eval_score": self.best_eval_score,
            "optimizer_state_dict": ckpt.optimizer_state_tree(
                self.optimizer, self.model),
        }, is_best, checkpoint_dir=self.checkpoint_dir)

    # -- batches -------------------------------------------------------------

    def _device_batches(self, loader: Iterable):
        """Device batches one ahead: batch k + 1's copy is issued before
        step k is handed out."""
        return device_batches(
            ((t[0], t[1], t[2] if len(t) > 2 else None) for t in loader),
            self.device, self._copy_stream)

    # -- steps ---------------------------------------------------------------

    def _loss(self, output, target, weight):
        if weight is None:
            return self.loss_criterion(output, target)
        return self.loss_criterion(output, target, weight)

    def _train_step(self, input, target, weight):
        """One optimizer step; returns the detached loss and output."""
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        output = self.model(input)
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
            nonlocal loss_acc, loss_acc_n, loss_acc_steps
            if loss_acc_steps:
                train_losses.update(float(loss_acc) / loss_acc_steps,
                                    loss_acc_n)
                loss_acc, loss_acc_n, loss_acc_steps = None, 0, 0

        for input, target, weight in self._device_batches(
                self.loaders["train"]):
            logger.info(f"Training iteration [{self.num_iterations}/"
                        f"{self.max_num_iterations}]. Epoch "
                        f"[{self.num_epochs}/{self.max_num_epochs - 1}]")
            loss, output = self._train_step(input, target, weight)
            loss_acc = loss if loss_acc is None else loss_acc + loss
            loss_acc_n += input.shape[0]
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
                if not self.skip_train_validation:
                    act = self.model.final_activation()
                    scored = act(output) if act is not None else output
                    train_eval_scores.update(
                        float(self.eval_criterion(scored, target)),
                        input.shape[0])
                logger.info(f"Training stats. Loss: {train_losses.avg}. "
                            f"Evaluation score: {train_eval_scores.avg}")
                self._log_stats("train", train_losses.avg,
                                train_eval_scores.avg)
                self._log_images(input, target, output, "train_")

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
        for i, (input, target, weight) in enumerate(
                self._device_batches(self.loaders["val"])):
            logger.info(f"Validation iteration {i}")
            output = self.model(input)
            loss = self._loss(output, target, weight)
            val_losses.update(float(loss), input.shape[0])
            if i % 100 == 0:
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

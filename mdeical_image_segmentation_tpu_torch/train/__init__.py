"""Training runtime of the port (the JAX package's ``train``): checkpoint
I/O, optimizers and schedulers, the 2D ``Trainer`` and the 3D
``UNetTrainer``."""

from .callbacks import BestIoUCallback, TrainerCallback, TrainerControl
from .checkpoint import (
    BEST_NAME,
    LAST_NAME,
    load_checkpoint,
    load_optimizer_state,
    optimizer_state_tree,
    save_checkpoint,
)
from .train_state import TrainState, create_train_state
from .trainer2d import CustomTrainer, Trainer, TrainingArguments, TrainOutput

__all__ = ["BEST_NAME", "BestIoUCallback", "CustomTrainer", "LAST_NAME",
           "TrainOutput", "TrainState", "Trainer", "TrainerCallback",
           "TrainerControl", "TrainingArguments", "create_train_state",
           "load_checkpoint", "load_optimizer_state", "optimizer_state_tree",
           "save_checkpoint"]

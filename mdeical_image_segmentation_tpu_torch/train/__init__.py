"""Training runtime of the port (the JAX package's ``train``): checkpoint
I/O, optimizers and schedulers, and the 3D ``UNetTrainer``."""

from .checkpoint import (
    BEST_NAME,
    LAST_NAME,
    load_checkpoint,
    load_optimizer_state,
    optimizer_state_tree,
    save_checkpoint,
)

__all__ = ["BEST_NAME", "LAST_NAME", "load_checkpoint",
           "load_optimizer_state", "optimizer_state_tree", "save_checkpoint"]

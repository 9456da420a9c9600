"""Training runtime of the port (the JAX package's ``train``; checkpoint
I/O so far)."""

from .checkpoint import (
    BEST_NAME,
    LAST_NAME,
    load_checkpoint,
    save_checkpoint,
)

__all__ = ["BEST_NAME", "LAST_NAME", "load_checkpoint", "save_checkpoint"]

"""The 2D trainer's state (the JAX package's ``train/train_state.py``).

The JAX ``TrainState`` is one pytree (step, params, batch stats, optimizer
state) threaded through a jitted step.  Here the model and the optimizer
hold their tensors themselves, so the state is a small mutable record of
them, the step counters and the learning-rate schedule.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass
class TrainState:
    step: int                          # train steps (micro-steps) taken
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]   # optimizer steps taken → rate
    opt_step: int = 0                  # optimizer updates taken
    mini_step: int = 0                 # micro-steps since the last update


def create_train_state(model: torch.nn.Module,
                       optimizer: torch.optim.Optimizer,
                       schedule: Callable[[int], float]) -> TrainState:
    """A fresh state at step 0 around a model that already holds its
    weights."""
    return TrainState(step=0, model=model, optimizer=optimizer,
                      schedule=schedule)

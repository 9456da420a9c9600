"""Trainer callbacks, HF ``TrainerCallback``-shaped (the JAX package's
``train/callbacks.py``).  ``BestIoUCallback`` tracks ``eval_iou`` and asks
for a model save when it improves."""

from __future__ import annotations

from typing import Any, Dict, Optional


class TrainerControl:
    def __init__(self):
        self.should_save = False
        self.should_stop = False


class TrainerCallback:
    def on_evaluate(self, args, state, control: TrainerControl,
                    metrics: Dict[str, float], **kw):
        pass

    def on_log(self, args, state, control: TrainerControl,
               logs: Dict[str, Any], **kw):
        pass

    def on_step_end(self, args, state, control: TrainerControl, **kw):
        pass


class BestIoUCallback(TrainerCallback):
    """Save the model whenever the eval IoU improves."""

    def __init__(self, metric_name: str = "eval_iou"):
        self.metric_name = metric_name
        self.best: Optional[float] = None

    def on_evaluate(self, args, state, control, metrics, **kw):
        value = metrics.get(self.metric_name)
        if value is None:
            return
        if self.best is None or value > self.best:
            self.best = value
            control.should_save = True

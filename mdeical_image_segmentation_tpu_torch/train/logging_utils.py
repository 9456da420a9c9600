"""The logging utilities under the ``train`` package, as in the JAX package
(they live at the package root so leaf modules import them without the
trainer)."""

from ..logging_utils import (  # noqa: F401
    MetricWriter,
    NullMetricWriter,
    RunningAverage,
    TensorboardFormatter,
    get_logger,
    get_tensorboard_formatter,
)

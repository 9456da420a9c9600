"""Evaluation metrics of the port (the JAX package's ``metrics``; the 3D
registry)."""

from .metrics3d import get_evaluation_metric

__all__ = ["get_evaluation_metric"]

"""Losses of the port (the JAX package's ``losses``; the 3D registry)."""

from .losses3d import get_loss_criterion

__all__ = ["get_loss_criterion"]

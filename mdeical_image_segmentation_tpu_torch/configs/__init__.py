"""Configuration helpers of the port (the JAX package's ``configs``; the
name registry so far)."""

from .registry import Registry

__all__ = ["Registry"]

"""Inference of the port (the JAX package's ``infer``): the sliding-window
StandardPredictor's on-device patch chain."""

from .predictor import PREDICTORS, StandardPredictor, get_predictor

__all__ = ["PREDICTORS", "StandardPredictor", "get_predictor"]

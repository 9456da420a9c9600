"""Inference of the port (the JAX package's ``infer``): the sliding-window
predictors (the StandardPredictor's on-device patch chain, the disk-backed
LazyPredictor) and the DSB2018 2D predictor."""

from .predictor import (
    PREDICTORS,
    DSB2018Predictor,
    LazyPredictor,
    StandardPredictor,
    dsb_save_batch,
    get_predictor,
)

__all__ = ["DSB2018Predictor", "LazyPredictor", "PREDICTORS",
           "StandardPredictor", "dsb_save_batch", "get_predictor"]

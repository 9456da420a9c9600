"""Config-driven 3D evaluation metric registry (the JAX package's
``metrics/metrics3d.py``).

Dense inputs are channels-last (N, D, H, W, C) tensors or numpy arrays and
integer targets (N, D, H, W).  ``DiceCoefficient`` stays on the tensor's
device; ``MeanIoU``, ``PSNR`` and ``MSE`` pull to host numpy, as in the JAX
package.  The instance metrics (the AdaptedRand and AveragePrecision
families) are registered names that raise until their connected-component
and matching helpers are ported.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np
import torch

from ..configs.registry import Registry
from ..losses.losses3d import compute_per_channel_dice
from ..utils.onehot import expand_as_one_hot

EVAL_METRICS = Registry("eval_metric")
INSTANCE_METRICS_ITEM = ("ROADMAP.md queue 1, item 17 (transforms/"
                         "skimage_compat, metrics/seg_compat and seg_metrics)")


def convert_to_numpy(*inputs):
    """Host numpy arrays of tensors (bfloat16 as float32) or arrays."""
    def one(i):
        if not isinstance(i, torch.Tensor):
            return np.asarray(i)
        i = i.detach().cpu()
        return (i.float() if i.dtype == torch.bfloat16 else i).numpy()
    return tuple(one(i) for i in inputs)


@EVAL_METRICS.register("DiceCoefficient")
class DiceCoefficient:
    """Mean per-channel dice on probabilities."""

    def __init__(self, epsilon: float = 1e-6, **kwargs):
        self.epsilon = epsilon

    def __call__(self, input, target) -> torch.Tensor:
        return compute_per_channel_dice(torch.as_tensor(input),
                                        torch.as_tensor(target),
                                        epsilon=self.epsilon).mean()


@EVAL_METRICS.register("MeanIoU")
class MeanIoU:
    """Per-class IoU after argmax / 0.5-threshold binarization, averaged over
    the classes, then over the batch."""

    def __init__(self, skip_channels: Sequence[int] = (), ignore_index=None,
                 **kwargs):
        self.ignore_index = ignore_index
        self.skip_channels = skip_channels

    def __call__(self, input, target) -> float:
        input, target = convert_to_numpy(input, target)
        if input.ndim != 5:
            raise ValueError("expected (N, D, H, W, C) probability maps, got "
                             f"{input.shape}")
        n_classes = input.shape[-1]
        if target.ndim == 4:
            target = expand_as_one_hot(
                torch.from_numpy(target), n_classes,
                ignore_index=self.ignore_index).numpy()
        if input.shape != target.shape:
            raise ValueError(f"input {input.shape} and target {target.shape}")

        per_batch_iou = []
        for _input, _target in zip(input, target):
            binary_prediction = self._binarize_predictions(_input, n_classes)
            if self.ignore_index is not None:
                mask = _target == self.ignore_index
                binary_prediction = np.where(mask, 0, binary_prediction)
                _target = np.where(mask, 0, _target)
            binary_prediction = binary_prediction.astype(np.uint8)
            _target = _target.astype(np.uint8)
            per_channel_iou = [
                self._jaccard_index(binary_prediction[..., c], _target[..., c])
                for c in range(n_classes) if c not in self.skip_channels
            ]
            if not per_channel_iou:
                raise ValueError("All channels were ignored from the "
                                 "computation")
            per_batch_iou.append(np.mean(per_channel_iou))
        return float(np.mean(per_batch_iou))

    @staticmethod
    def _binarize_predictions(input, n_classes):
        if n_classes == 1:
            return (input > 0.5).astype(np.int64)
        max_index = np.argmax(input, axis=-1)
        return (np.arange(n_classes) == max_index[..., None]).astype(np.uint8)

    @staticmethod
    def _jaccard_index(prediction, target):
        union = np.sum(prediction | target).astype(np.float64)
        return float(np.sum(prediction & target) / max(union, 1e-8))


def _data_range(image_true: np.ndarray) -> float:
    if np.issubdtype(image_true.dtype, np.integer):
        info = np.iinfo(image_true.dtype)
        return float(info.max) - float(info.min)
    # float images: the (-1, 1) range, or (0, 1) when non-negative
    return 2.0 if image_true.min() < 0 else 1.0


def mean_squared_error(image0, image1) -> float:
    image0 = np.asarray(image0, dtype=np.float64)
    image1 = np.asarray(image1, dtype=np.float64)
    return float(np.mean((image0 - image1) ** 2))


def peak_signal_noise_ratio(image_true, image_test, *,
                            data_range=None) -> float:
    if data_range is None:
        data_range = _data_range(image_true)
    err = mean_squared_error(image_true, image_test)
    if err == 0:
        return float("inf")
    return float(10 * np.log10((data_range ** 2) / err))


@EVAL_METRICS.register("PSNR")
class PSNR:
    def __init__(self, **kwargs):
        pass

    def __call__(self, input, target) -> float:
        input, target = convert_to_numpy(input, target)
        return peak_signal_noise_ratio(target, input)


@EVAL_METRICS.register("MSE")
class MSE:
    def __init__(self, **kwargs):
        pass

    def __call__(self, input, target) -> float:
        input, target = convert_to_numpy(input, target)
        return mean_squared_error(input, target)


def _not_ported(name: str):
    def build(**kwargs):
        raise NotImplementedError(f"eval metric {name!r} is not ported yet "
                                  f"({INSTANCE_METRICS_ITEM})")
    return build


for _name in ("AdaptedRandError", "BoundaryAdaptedRandError",
              "GenericAdaptedRandError", "GenericAveragePrecision",
              "BlobsAveragePrecision", "BlobsBoundaryAveragePrecision",
              "BoundaryAveragePrecision"):
    EVAL_METRICS.register(_name)(_not_ported(_name))


def get_evaluation_metric(config: Dict[str, Any]):
    """The metric of ``config['eval_metric']``."""
    if "eval_metric" not in config:
        raise KeyError("Could not find evaluation metric configuration")
    metric_config = config["eval_metric"]
    return EVAL_METRICS.get(metric_config["name"])(**metric_config)

"""Config-driven 3D evaluation metric registry (the JAX package's
``metrics/metrics3d.py``).

Dense inputs are channels-last (N, D, H, W, C) tensors or numpy arrays and
integer targets (N, D, H, W).  ``DiceCoefficient`` stays on the tensor's
device; ``MeanIoU``, ``PSNR``, ``MSE`` and the instance metrics pull to
host numpy, as in the JAX package.  The instance metrics turn the network
output into candidate segmentations (thresholds, inversions, connected
components of ``transforms/skimage_compat.label``) and score each against
the target: the AdaptedRand family keeps each sample's lowest error
(``metrics/seg_compat.py``), the AveragePrecision family its best DSB
average precision or accuracy (``metrics/seg_metrics.py``), and both
average over the batch.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np
import torch

from ..configs.registry import Registry
from ..logging_utils import get_logger
from ..losses.losses3d import compute_per_channel_dice
from ..transforms.skimage_compat import label as cc_label
from ..utils.onehot import expand_as_one_hot
from .seg_compat import (
    adapted_rand_error,
    mean_squared_error,
    peak_signal_noise_ratio,
)
from .seg_metrics import Accuracy, AveragePrecision

logger = get_logger("EvalMetric")

EVAL_METRICS = Registry("eval_metric")


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


@EVAL_METRICS.register("AdaptedRandError")
class AdaptedRandError:
    """SNEMI3D Adapted Rand error over a batch: the output's candidate
    segmentations each scored against the target, the lowest error of a
    sample kept, averaged over the batch."""

    def __init__(self, use_last_target: bool = False, ignore_index=None,
                 **kwargs):
        self.use_last_target = use_last_target
        self.ignore_index = ignore_index

    def __call__(self, input, target) -> float:
        input, target = convert_to_numpy(input, target)
        # the target channel asked for, (N, D, H, W)
        target = target[..., -1] if self.use_last_target else target[..., 0]
        target = target.astype(np.int32)
        if self.ignore_index is not None:
            target[target == self.ignore_index] = 0

        per_batch_arand = []
        for _input, _target in zip(input, target):
            if np.all(_target == _target.flat[0]):
                logger.info("Skipping ARandError computation: only 1 label "
                            "present in the ground truth")
                per_batch_arand.append(0.0)
                continue
            segm = self.input_to_segm(_input)  # (C, D, H, W)
            if segm.ndim != 4:
                raise ValueError(f"candidate segmentations {segm.shape}: "
                                 "want (C, D, H, W)")
            per_channel_arand = [adapted_rand_error(_target, channel_segm)[0]
                                 for channel_segm in segm]
            per_batch_arand.append(np.min(per_channel_arand))

        mean_arand = float(np.mean(per_batch_arand))
        logger.info(f"ARand: {mean_arand}")
        return mean_arand

    def input_to_segm(self, input):
        """(D, H, W, C) output → (C, D, H, W) candidate segmentations."""
        return np.moveaxis(input, -1, 0)


def _components(mask: np.ndarray) -> np.ndarray:
    return cc_label(mask.astype(np.uint8), background=0, connectivity=1)


def _thresholds(thresholds, default):
    if thresholds is None:
        return default
    if not isinstance(thresholds, list):
        raise ValueError(f"thresholds {thresholds!r}: a list")
    return thresholds


@EVAL_METRICS.register("BoundaryAdaptedRandError")
class BoundaryAdaptedRandError(AdaptedRandError):
    """Boundary maps thresholded, inverted and split into connected
    components: the candidate segmentations."""

    def __init__(self, thresholds=None, use_last_target=True,
                 ignore_index=None, input_channel=None, invert_pmaps=True,
                 **kwargs):
        super().__init__(use_last_target=use_last_target,
                         ignore_index=ignore_index, **kwargs)
        self.thresholds = _thresholds(thresholds, [0.3, 0.4, 0.5, 0.6])
        self.input_channel = input_channel
        self.invert_pmaps = invert_pmaps

    def input_to_segm(self, input):
        input = np.moveaxis(input, -1, 0)  # (C, D, H, W)
        if self.input_channel is not None:
            input = np.expand_dims(input[self.input_channel], axis=0)
        segs = []
        for predictions in input:
            for th in self.thresholds:
                predictions_th = predictions > th
                if self.invert_pmaps:
                    predictions_th = np.logical_not(predictions_th)
                segs.append(_components(predictions_th))
        return np.stack(segs)


@EVAL_METRICS.register("GenericAdaptedRandError")
class GenericAdaptedRandError(AdaptedRandError):
    """The chosen channels (some inverted) thresholded and split into
    connected components."""

    def __init__(self, input_channels, thresholds=None, use_last_target=True,
                 ignore_index=None, invert_channels=None, **kwargs):
        super().__init__(use_last_target=use_last_target,
                         ignore_index=ignore_index, **kwargs)
        if not isinstance(input_channels, (list, tuple)):
            raise ValueError(f"input_channels {input_channels!r}: a list")
        self.input_channels = input_channels
        self.thresholds = _thresholds(thresholds, [0.3, 0.4, 0.5, 0.6])
        self.invert_channels = invert_channels or []

    def input_to_segm(self, input):
        input = np.moveaxis(input, -1, 0)
        results = []
        for i in self.input_channels:
            c = input[i]
            if i in self.invert_channels:
                c = 1 - c
            results.append(c)
        return np.stack([_components(predictions > th)
                         for predictions in results
                         for th in self.thresholds])


@EVAL_METRICS.register("GenericAveragePrecision")
class GenericAveragePrecision:
    """Average precision (or accuracy) of instance matches: the best over a
    sample's candidate segmentations, averaged over the batch."""

    def __init__(self, min_instance_size=None, use_last_target=False,
                 metric="ap", **kwargs):
        if metric not in ("ap", "acc"):
            raise ValueError(f"metric {metric!r}: 'ap' or 'acc'")
        self.min_instance_size = min_instance_size
        self.use_last_target = use_last_target
        self.metric = AveragePrecision() if metric == "ap" else Accuracy(0.5)

    def __call__(self, input, target) -> float:
        multi_head = isinstance(input, tuple)
        if multi_head:
            input1, input2 = convert_to_numpy(*input)
        else:
            (input1,) = convert_to_numpy(input)
            input2 = input1
        (target,) = convert_to_numpy(target)
        if target.ndim == 5:
            target = (target[..., -1] if self.use_last_target
                      else target[..., 0])

        batch_aps = []
        for i_batch, (inp1, inp2, tar) in enumerate(zip(input1, input2,
                                                        target)):
            segs = self.input_to_seg((inp1, inp2) if multi_head else inp1,
                                     tar)
            if segs.ndim != 4:
                raise ValueError(f"candidate segmentations {segs.shape}: "
                                 "want (C, D, H, W)")
            tar = self._filter_instances(self.target_to_seg(tar))
            segs_aps = [self.metric(self._filter_instances(seg), tar)
                        for seg in segs]
            logger.info(f"Batch: {i_batch}. Max Average Precision for "
                        f"channel: {np.argmax(segs_aps)}")
            batch_aps.append(np.max(segs_aps))
        return float(np.mean(batch_aps))

    def _filter_instances(self, input):
        if self.min_instance_size is not None:
            # a copy: ``input`` may be a view of the caller's labels
            input = np.array(input)
            labels, counts = np.unique(input, return_counts=True)
            for lab, count in zip(labels, counts):
                if count < self.min_instance_size:
                    input[input == lab] = 0
        return input

    def input_to_seg(self, input, target=None):
        raise NotImplementedError(f"{type(self).__name__} makes no "
                                  "candidate segmentations; use a subclass")

    def target_to_seg(self, target):
        return target


@EVAL_METRICS.register("BlobsAveragePrecision")
class BlobsAveragePrecision(GenericAveragePrecision):
    """Candidates from a foreground map channel above each threshold."""

    def __init__(self, thresholds=None, metric="ap", min_instance_size=None,
                 input_channel=0, **kwargs):
        super().__init__(min_instance_size=min_instance_size,
                         use_last_target=True, metric=metric)
        self.thresholds = _thresholds(thresholds, [0.4, 0.5, 0.6, 0.7, 0.8])
        self.input_channel = input_channel

    def input_to_seg(self, input, target=None):
        input = np.moveaxis(input, -1, 0)[self.input_channel]
        return np.stack([_components(input > th) for th in self.thresholds])


@EVAL_METRICS.register("BlobsBoundaryAveragePrecision")
class BlobsBoundaryAveragePrecision(GenericAveragePrecision):
    """Candidates from (P_mask − P_boundary) above each threshold."""

    def __init__(self, thresholds=None, metric="ap", min_instance_size=None,
                 **kwargs):
        super().__init__(min_instance_size=min_instance_size,
                         use_last_target=True, metric=metric)
        self.thresholds = _thresholds(thresholds, [0.3, 0.4, 0.5, 0.6, 0.7])

    def input_to_seg(self, input, target=None):
        input = np.moveaxis(input, -1, 0)
        input = input[0] - input[1]
        return np.stack([_components(input > th) for th in self.thresholds])


@EVAL_METRICS.register("BoundaryAveragePrecision")
class BoundaryAveragePrecision(GenericAveragePrecision):
    """Candidates from a boundary map channel at or below each threshold."""

    def __init__(self, thresholds=None, min_instance_size=None,
                 input_channel=0, **kwargs):
        super().__init__(min_instance_size=min_instance_size,
                         use_last_target=True)
        self.thresholds = _thresholds(thresholds, [0.3, 0.4, 0.5, 0.6])
        self.input_channel = input_channel

    def input_to_seg(self, input, target=None):
        input = np.moveaxis(input, -1, 0)[self.input_channel]
        return np.stack([_components(np.logical_not(input > th))
                         for th in self.thresholds])


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


def get_evaluation_metric(config: Dict[str, Any]):
    """The metric of ``config['eval_metric']``."""
    if "eval_metric" not in config:
        raise KeyError("Could not find evaluation metric configuration")
    metric_config = config["eval_metric"]
    return EVAL_METRICS.get(metric_config["name"])(**metric_config)

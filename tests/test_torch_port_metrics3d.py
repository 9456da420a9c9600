"""The port's 3D evaluation metrics (``mdeical_image_segmentation_tpu_torch.
metrics.metrics3d``) against the JAX package's, on the same numpy inputs
from a fixed seed, built through ``get_evaluation_metric``.

Tolerance: DiceCoefficient within rtol = atol = 1e-6 (fp32 sums in other
orders); MeanIoU, PSNR and MSE are the same host numpy in both packages and
must be equal."""

import numpy as np
import pytest
import torch

from mdeical_image_segmentation_tpu.metrics import metrics3d as jax_metrics
from mdeical_image_segmentation_tpu_torch.metrics import metrics3d

SHAPE = (2, 4, 6, 5)


def _probs(c, seed):
    return np.random.default_rng(seed).random(SHAPE + (c,)).astype(np.float32)


def _both(cfg):
    return (jax_metrics.get_evaluation_metric({"eval_metric": dict(cfg)}),
            metrics3d.get_evaluation_metric({"eval_metric": dict(cfg)}))


@pytest.mark.parametrize("c", [1, 3])
def test_dice_coefficient_matches_jax(c):
    x, t = _probs(c, 1), (_probs(c, 2) > 0.5).astype(np.float32)
    want, port = _both({"name": "DiceCoefficient"})
    got = port(torch.from_numpy(x), torch.from_numpy(t))
    assert isinstance(got, torch.Tensor) and got.ndim == 0
    np.testing.assert_allclose(got.item(), float(want(x, t)), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("case", ["one_class", "multi_class_dense",
                                  "labels_4d", "labels_ignore",
                                  "skip_channels"])
def test_mean_iou_matches_jax(case):
    rng = np.random.default_rng(len(case))
    cfg = {"name": "MeanIoU"}
    if case == "one_class":
        x, t = _probs(1, 3), (_probs(1, 4) > 0.4).astype(np.float32)
    elif case == "multi_class_dense":
        x = _probs(3, 5)
        t = np.eye(3, dtype=np.float32)[rng.integers(0, 3, SHAPE)]
    elif case == "labels_4d":
        x, t = _probs(3, 6), rng.integers(0, 3, SHAPE)
    elif case == "labels_ignore":
        x = _probs(3, 7)
        t = np.where(rng.random(SHAPE) < 0.2, -1, rng.integers(0, 3, SHAPE))
        cfg["ignore_index"] = -1
    else:
        x, t = _probs(3, 8), rng.integers(0, 3, SHAPE)
        cfg["skip_channels"] = [0]
    want, port = _both(cfg)
    expected = want(x, t)
    assert port(x, t) == expected
    assert port(torch.from_numpy(x), torch.from_numpy(t)) == expected


@pytest.mark.parametrize("name", ["PSNR", "MSE"])
@pytest.mark.parametrize("signed", [False, True])
def test_psnr_and_mse_match_jax(name, signed):
    x, t = _probs(1, 9), _probs(1, 10)
    if signed:
        t = t - 0.5
    want, port = _both({"name": name})
    assert port(torch.from_numpy(x), torch.from_numpy(t)) == want(x, t)


def test_psnr_of_integer_images_uses_their_dtype_range():
    a = np.array([[0, 255], [128, 3]], np.uint8)
    b = np.array([[1, 250], [128, 3]], np.uint8)
    want, port = _both({"name": "PSNR"})
    assert port(torch.from_numpy(b), torch.from_numpy(a)) == want(b, a)


@pytest.mark.parametrize("name", [
    "AdaptedRandError", "BoundaryAdaptedRandError", "GenericAdaptedRandError",
    "GenericAveragePrecision", "BlobsAveragePrecision",
    "BlobsBoundaryAveragePrecision", "BoundaryAveragePrecision"])
def test_instance_metrics_raise_naming_their_item(name):
    assert name in metrics3d.EVAL_METRICS
    with pytest.raises(NotImplementedError, match="item 17"):
        metrics3d.get_evaluation_metric({"eval_metric": {"name": name}})


def test_unknown_metric_and_missing_section_raise():
    with pytest.raises(KeyError, match="unknown eval_metric"):
        metrics3d.get_evaluation_metric({"eval_metric": {"name": "Hausdorff"}})
    with pytest.raises(KeyError, match="evaluation metric"):
        metrics3d.get_evaluation_metric({})

"""The port's 3D evaluation metrics (``mdeical_image_segmentation_tpu_torch.
metrics.metrics3d``) against the JAX package's, on the same numpy inputs
from a fixed seed, built through ``get_evaluation_metric``.

Tolerance: DiceCoefficient within rtol = atol = 1e-6 (fp32 sums in other
orders); MeanIoU, PSNR, MSE and the instance metrics (AdaptedRand and
AveragePrecision families, connected components on the host) are the same
host numpy in both packages and must agree within 1e-12."""

import numpy as np
import pytest
import torch
from scipy import ndimage

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


def _instance_batch(seed):
    """Channels-last (2, 6, 12, 10, 2) smooth probability maps, their
    (2, 6, 12, 10, 1) connected-component labels as the target, and the
    labels of each channel as float candidate segmentations."""
    rng = np.random.default_rng(seed)
    field = ndimage.gaussian_filter(rng.random((2, 6, 12, 10, 2)),
                                    sigma=(0, 1, 1.5, 1.5, 0))
    lo, hi = field.min(), field.max()
    probs = ((field - lo) / (hi - lo)).astype(np.float32)
    target = np.stack([ndimage.label(p[..., 0] > 0.55)[0] for p in probs])
    segs = np.stack([np.stack([ndimage.label(p[..., c] > 0.5)[0]
                               for c in range(2)], -1) for p in probs])
    return probs, target[..., None], segs.astype(np.float32)


INSTANCE = {
    "AdaptedRandError": {},
    "BoundaryAdaptedRandError": {"thresholds": [0.3, 0.45, 0.6]},
    "GenericAdaptedRandError": {"input_channels": [0, 1],
                                "invert_channels": [1]},
    "GenericAveragePrecision": {},
    "BlobsAveragePrecision": {"min_instance_size": 3, "metric": "acc"},
    "BlobsBoundaryAveragePrecision": {"thresholds": [0.0, 0.1, 0.2]},
    "BoundaryAveragePrecision": {"thresholds": [0.3, 0.38]},
}


@pytest.mark.parametrize("name", list(INSTANCE))
def test_instance_metrics_raise_naming_their_item(name):
    """Each instance metric against the JAX package's on the same
    channels-last batch, tensors or arrays (AdaptedRandError scores label
    maps, BoundaryAveragePrecision boundary maps, the others probability
    maps); GenericAveragePrecision has no candidate segmentations of its
    own and raises in both."""
    probs, target, segs = _instance_batch(3)
    x = {"AdaptedRandError": segs,
         "BoundaryAveragePrecision": 1 - probs}.get(name, probs)
    want, port = _both({"name": name, **INSTANCE[name]})
    if name == "GenericAveragePrecision":
        for metric in (want, port):
            with pytest.raises(NotImplementedError):
                metric(x, target)
        return
    expected = want(x, target)
    assert 0 < expected <= 1
    got = port(torch.from_numpy(x), torch.from_numpy(target))
    assert isinstance(got, float)
    assert got == pytest.approx(expected, rel=1e-12, abs=1e-12)
    assert port(x, target) == pytest.approx(expected, rel=1e-12, abs=1e-12)


def test_unknown_metric_and_missing_section_raise():
    with pytest.raises(KeyError, match="unknown eval_metric"):
        metrics3d.get_evaluation_metric({"eval_metric": {"name": "Hausdorff"}})
    with pytest.raises(KeyError, match="evaluation metric"):
        metrics3d.get_evaluation_metric({})

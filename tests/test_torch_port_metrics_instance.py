"""The port's segmentation and surface metrics (``metrics/seg_compat.py``,
``metrics/seg_metrics.py``, ``metrics/surface.py``) against the JAX
package's on seeded instance volumes: contingency tables equal, every score
within 1e-12, and the empty-mask behaviour the same (the surface distances
raise RuntimeError, Dice and Jaccard of two empty masks are 0)."""

import numpy as np
import pytest
from scipy import ndimage

from mdeical_image_segmentation_tpu.metrics import seg_compat as jax_compat
from mdeical_image_segmentation_tpu.metrics import seg_metrics as jax_seg
from mdeical_image_segmentation_tpu.metrics import surface as jax_surface
from mdeical_image_segmentation_tpu_torch import metrics
from mdeical_image_segmentation_tpu_torch.metrics import (
    seg_compat,
    seg_metrics,
    surface,
)

TOL = 1e-12


def _instances(seed, shape=(8, 24, 20), level=0.55):
    """Connected components of a smoothed seeded field above ``level``."""
    rng = np.random.default_rng(seed)
    field = ndimage.gaussian_filter(rng.random(shape), sigma=1.5)
    field = (field - field.min()) / (field.max() - field.min())
    return ndimage.label(field > level)[0]


PAIRS = [(1, 2), (3, 3), (4, 5)]  # seeds of (truth, prediction); 3, 3: equal


@pytest.mark.parametrize("seeds", PAIRS)
def test_contingency_and_adapted_rand_match_jax(seeds):
    gt, seg = _instances(seeds[0]), _instances(seeds[1], level=0.5)
    for kw in ({}, {"ignore_labels": (0,)}, {"normalize": True}):
        np.testing.assert_array_equal(
            seg_compat.contingency_table(gt, seg, **kw),
            jax_compat.contingency_table(gt, seg, **kw))
    for alpha in (0.5, 0.1, 1.0):
        np.testing.assert_allclose(
            seg_compat.adapted_rand_error(gt, seg, alpha=alpha),
            jax_compat.adapted_rand_error(gt, seg, alpha=alpha),
            rtol=TOL, atol=TOL)
    with pytest.raises(ValueError, match="alpha"):
        seg_compat.adapted_rand_error(gt, seg, alpha=1.5)


@pytest.mark.parametrize("dtype", ["u1", "i2", "f4", "f8"])
def test_psnr_and_mse_match_jax(dtype):
    rng = np.random.default_rng(len(dtype))
    a = (rng.random((6, 9)) * (200 if dtype[0] in "ui" else 1)).astype(dtype)
    b = (a * 0.9).astype(dtype)
    if dtype == "f8":
        a, b = a - 0.5, b - 0.5  # a signed float image: data range 2
    assert seg_compat.mean_squared_error(a, b) == jax_compat.mean_squared_error(
        a, b)
    assert seg_compat.peak_signal_noise_ratio(a, b) == (
        jax_compat.peak_signal_noise_ratio(a, b))
    assert seg_compat.peak_signal_noise_ratio(a, a) == float("inf")


@pytest.mark.parametrize("seeds", PAIRS)
def test_instance_matching_matches_jax(seeds):
    gt, seg = _instances(seeds[0]), _instances(seeds[1], level=0.5)
    ours = seg_metrics.SegmentationMetrics(gt, seg)
    theirs = jax_seg.SegmentationMetrics(gt, seg)
    np.testing.assert_array_equal(ours.iou_matrix, theirs.iou_matrix)
    for th in (0.1, 0.3, 0.5, 0.8):
        assert ours.metrics(th) == theirs.metrics(th)
        assert seg_metrics.Accuracy(th)(seg, gt) == jax_seg.Accuracy(th)(
            seg, gt)
    assert seg_metrics.AveragePrecision()(seg, gt) == pytest.approx(
        jax_seg.AveragePrecision()(seg, gt), rel=TOL, abs=TOL)
    for f in ("precision", "recall", "accuracy", "f1"):
        for counts in ((3, 1, 2), (0, 4, 1)):
            assert getattr(seg_metrics, f)(*counts) == getattr(jax_seg, f)(
                *counts)


@pytest.mark.parametrize("seeds", PAIRS)
def test_surface_metrics_match_jax(seeds):
    gt = _instances(seeds[0]) > 0
    pred = _instances(seeds[1], level=0.5) > 0
    for name in ("hd95", "asd", "assd"):
        for spacing in (None, (2.0, 1.0, 0.5)):
            got = getattr(surface, name)(pred, gt, voxelspacing=spacing)
            want = getattr(jax_surface, name)(pred, gt, voxelspacing=spacing)
            assert got == pytest.approx(want, rel=TOL, abs=TOL), name
    assert surface.dc(pred, gt) == jax_surface.dc(pred, gt)
    assert surface.jc(pred, gt) == jax_surface.jc(pred, gt)
    np.testing.assert_allclose(
        surface.calculate_metric_percase(pred, gt),
        jax_surface.calculate_metric_percase(pred, gt), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("empty", ["result", "reference", "both"])
def test_empty_masks_behave_as_in_jax(empty):
    mask = _instances(7) > 0
    none = np.zeros_like(mask)
    pred, gt = {"result": (none, mask), "reference": (mask, none),
                "both": (none, none)}[empty]
    for pkg in (surface, jax_surface):
        for name in ("hd95", "asd", "assd"):
            with pytest.raises(RuntimeError, match="empty"):
                getattr(pkg, name)(pred, gt)
        with pytest.raises(RuntimeError, match="empty"):
            pkg.calculate_metric_percase(pred, gt)
    assert surface.dc(pred, gt) == jax_surface.dc(pred, gt)
    assert surface.jc(pred, gt) == jax_surface.jc(pred, gt)
    if empty == "both":
        assert surface.dc(pred, gt) == 0.0 and surface.jc(pred, gt) == 0.0


def test_metrics_package_exports_the_jax_names():
    from mdeical_image_segmentation_tpu import metrics as jax_metrics

    # the JAX package's 2D helpers that take JAX arrays (dice_jax,
    # iou_jax) and its matplotlib plot have no counterpart in the port
    jax_only = {"dice_jax", "iou_jax", "plot_first_element"}
    assert set(jax_metrics.__all__) - jax_only <= set(metrics.__all__)
    for name in metrics.__all__:
        assert getattr(metrics, name) is not None

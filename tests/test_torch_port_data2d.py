"""The port's 2D losses, metrics, on-device augmentation and PNG data path
against the JAX package's, on inputs made from numpy with fixed seeds.
Tolerances: float32 reductions and the sigmoid's exp within 1e-6 relative
(LOSS_TOL; the same terms summed in a different order, exp rounded
differently); the host metrics, augmented masks, batch orders, splits and
dataset items exactly."""

import math
import os

import numpy as np
import pytest
import torch
from PIL import Image
from sklearn.model_selection import train_test_split as sk_split

import jax
import jax.numpy as jnp

from mdeical_image_segmentation_tpu.data import collate as jax_collate
from mdeical_image_segmentation_tpu.data import png2d as jax_png2d
from mdeical_image_segmentation_tpu.losses import losses2d as jax_losses
from mdeical_image_segmentation_tpu.metrics import metrics2d as jax_metrics
from mdeical_image_segmentation_tpu.transforms import device2d as jax_aug
from mdeical_image_segmentation_tpu_torch.data import collate, png2d
from mdeical_image_segmentation_tpu_torch.losses import losses2d
from mdeical_image_segmentation_tpu_torch.metrics import metrics2d
from mdeical_image_segmentation_tpu_torch.transforms import device2d
from mdeical_image_segmentation_tpu_torch.utils import png

LOSS_TOL = 1e-6


def _logits_labels(seed, shape=(3, 16, 16, 1)):
    rng = np.random.default_rng(seed)
    logits = (2.0 * rng.standard_normal(shape)).astype(np.float32)
    labels = (rng.random(shape) > 0.6).astype(np.float32)
    return logits, labels


# -- losses --------------------------------------------------------------------

@pytest.mark.parametrize("name", ["bce_with_logits", "f1_loss", "iou_loss"])
def test_binary_losses_match_jax(name):
    logits, labels = _logits_labels(1)
    logits[0, 0, 0, 0] = 60.0  # the stable BCE form at a large logit
    logits[0, 0, 1, 0] = -60.0
    want = float(getattr(jax_losses, name)(jnp.asarray(logits),
                                           jnp.asarray(labels)))
    got = getattr(losses2d, name)(torch.from_numpy(logits),
                                  torch.from_numpy(labels))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=LOSS_TOL)


@pytest.mark.parametrize("with_channel", [False, True])
def test_cross_entropy_matches_jax(with_channel):
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    labels = rng.integers(0, 4, (2, 8, 8)).astype(np.int32)
    if with_channel:  # (N, H, W, 1) class maps
        labels = labels[..., None]
    want = float(jax_losses.cross_entropy(jnp.asarray(logits),
                                          jnp.asarray(labels)))
    got = float(losses2d.cross_entropy(torch.from_numpy(logits),
                                       torch.from_numpy(labels)))
    np.testing.assert_allclose(got, want, rtol=LOSS_TOL)


def test_hybrid_losses_raise_until_their_slice():
    """Ported with their slice (6): below MS-SSIM's 161 px the hybrid
    losses raise the JAX package's size error; at 176² they match it."""
    x = torch.zeros(1, 8, 8, 1)
    for fn in (losses2d.msssim_loss, losses2d.segmentation_loss):
        with pytest.raises(ValueError, match="too small"):
            fn(x, x)
    rng = np.random.default_rng(9)
    logits = rng.standard_normal((1, 176, 176, 1)).astype(np.float32)
    labels = (rng.random((1, 176, 176, 1)) < 0.5).astype(np.float32)
    for name in ("msssim_loss", "segmentation_loss"):
        want = float(getattr(jax_losses, name)(jnp.asarray(logits),
                                               jnp.asarray(labels)))
        got = float(getattr(losses2d, name)(torch.from_numpy(logits),
                                            torch.from_numpy(labels)))
        np.testing.assert_allclose(got, want, rtol=LOSS_TOL)


# -- metrics -------------------------------------------------------------------

@pytest.mark.parametrize("threshold", [None, 0.5])
def test_host_metrics_match_jax(threshold, tmp_path):
    logits, labels = _logits_labels(3)
    want = jax_metrics.compute_metrics(logits, labels, threshold=threshold)
    got = metrics2d.compute_metrics(logits, labels, threshold=threshold,
                                    plot_path=str(tmp_path / "out.png"))
    assert got == want
    assert metrics2d.iou_score(logits, labels) == jax_metrics.iou_score(
        logits, labels)
    assert metrics2d.dice_coef(logits, labels) == jax_metrics.dice_coef(
        logits, labels)


def test_plot_writes_two_thresholded_panels(tmp_path):
    a = np.zeros((2, 6, 5), np.float32)
    a[0, 1:3, 1:4] = 0.9
    b = np.zeros((2, 6, 5), np.float32)
    b[0, 4, 0] = 0.7
    metrics2d.plot_first_element(a, b, threshold=0.5,
                                 save_path=str(tmp_path / "p.png"))
    img = png.read(str(tmp_path / "p.png"), "L")
    assert img.shape == (6, 5 + 8 + 5)
    np.testing.assert_array_equal(img[:, :5] > 0, a[0] > 0.5)
    np.testing.assert_array_equal(img[:, 13:] > 0, b[0] > 0.5)
    assert not img[:, 5:13].any()


@pytest.mark.parametrize("threshold", [None, 0.4])
def test_device_metrics_match_jax(threshold):
    logits, labels = _logits_labels(4)
    tl, tt = torch.from_numpy(logits), torch.from_numpy(labels)
    jl, jt = jnp.asarray(logits), jnp.asarray(labels)
    np.testing.assert_allclose(float(metrics2d.iou(tl, tt, threshold)),
                               float(jax_metrics.iou_jax(jl, jt, threshold)),
                               rtol=LOSS_TOL)
    np.testing.assert_allclose(float(metrics2d.dice(tl, tt, threshold)),
                               float(jax_metrics.dice_jax(jl, jt, threshold)),
                               rtol=LOSS_TOL)
    np.testing.assert_allclose(
        metrics2d.quirky_sigmoid(tl).numpy(),
        np.asarray(jax_metrics.quirky_sigmoid_jax(jl)), rtol=LOSS_TOL)


@pytest.mark.parametrize("n_valid", [3, 2, 1])
def test_streaming_sums_mask_padded_rows_like_jax(n_valid):
    """The wrap-padded tail rows (index ≥ n_valid) add nothing; the mean
    threshold from the summed per-sample means equals the global mean."""
    logits, labels = _logits_labels(5)
    tl, tt = torch.from_numpy(logits), torch.from_numpy(labels)
    jl, jt = jnp.asarray(logits), jnp.asarray(labels)
    got = float(metrics2d.pred_mean_sum(tl, n_valid))
    want = float(jax_metrics.pred_mean_sum_jax(jl, jnp.int32(n_valid)))
    np.testing.assert_allclose(got, want, rtol=LOSS_TOL)
    thr = got / n_valid
    np.testing.assert_allclose(
        thr, metrics2d.quirky_sigmoid(tl[:n_valid]).mean().item(), rtol=1e-6)
    gi, gd = metrics2d.iou_dice_sums(tl, tt, thr, n_valid)
    wi, wd = jax_metrics.iou_dice_sums_jax(jl, jt, jnp.float32(thr),
                                           jnp.int32(n_valid))
    np.testing.assert_allclose([float(gi), float(gd)],
                               [float(wi), float(wd)], rtol=LOSS_TOL)
    host = jax_metrics.compute_metrics(logits[:n_valid], labels[:n_valid],
                                       threshold=thr)
    np.testing.assert_allclose(float(gi) / n_valid, host["iou"], rtol=1e-5)
    np.testing.assert_allclose(float(gd) / n_valid, host["dice"], rtol=1e-5)


@pytest.mark.parametrize("n_valid", [4, 2])
def test_multiclass_sums_match_jax(n_valid):
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((4, 8, 8, 3)).astype(np.float32)
    labels = rng.integers(0, 3, (4, 8, 8, 1)).astype(np.int32)
    gi, gd = metrics2d.multiclass_iou_dice_sums(
        torch.from_numpy(logits), torch.from_numpy(labels), n_valid)
    wi, wd = jax_metrics.multiclass_iou_dice_sums_jax(
        jnp.asarray(logits), jnp.asarray(labels), jnp.int32(n_valid))
    np.testing.assert_allclose([float(gi), float(gd)],
                               [float(wi), float(wd)], rtol=LOSS_TOL)
    assert metrics2d.compute_metrics_multiclass(
        logits, labels) == pytest.approx(
        jax_metrics.compute_metrics_multiclass(logits, labels), rel=1e-6)


# -- augmentation --------------------------------------------------------------

def _jax_draws(key, n, cfg):
    """The decisions ``jax_aug._augment_one`` draws from each sample key,
    drawn the same way here."""
    keys = jax.random.split(key, n)
    rows = []
    for k in keys:
        kh, kv, kr, krk, kt, kb, ka, kbv = jax.random.split(k, 8)
        k90 = int(jax.random.randint(krk, (), 0, 4)) if float(
            jax.random.uniform(kr)) < cfg.p_rot90 else 0
        rows.append((
            float(jax.random.uniform(kh)) < cfg.p_hflip,
            float(jax.random.uniform(kv)) < cfg.p_vflip, k90,
            float(jax.random.uniform(kt)) < cfg.p_transpose,
            float(jax.random.uniform(kb)) < cfg.p_brightness_contrast,
            1.0 + float(jax.random.uniform(ka, (), minval=-cfg.contrast_limit,
                                           maxval=cfg.contrast_limit)),
            float(jax.random.uniform(kbv, (), minval=-cfg.brightness_limit,
                                     maxval=cfg.brightness_limit))))
    cols = list(zip(*rows))
    return device2d.AugmentDraws(
        hflip=torch.tensor(cols[0]), vflip=torch.tensor(cols[1]),
        k90=torch.tensor(cols[2], dtype=torch.int64),
        transpose=torch.tensor(cols[3]),
        brightness_contrast=torch.tensor(cols[4]),
        alpha=torch.tensor(cols[5], dtype=torch.float32),
        beta=torch.tensor(cols[6], dtype=torch.float32))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("mask_channels", [1, 0])
def test_augment_from_jax_draws_equals_jax(seed, mask_channels):
    """16 samples a seed, so every op fires and every k90 occurs over the
    seeds; (N, H, W) class maps as well as (N, H, W, 1) masks."""
    cfg = jax_aug.Augment2DConfig()
    rng = np.random.default_rng(seed)
    images = rng.random((16, 8, 8, 2), dtype=np.float32)
    labels = rng.integers(0, 3, (16, 8, 8, 1)).astype(np.float32)
    if not mask_channels:
        labels = labels[..., 0]
    key = jax.random.PRNGKey(seed)
    want_i, want_l = jax_aug.augment_batch(key, jnp.asarray(images),
                                           jnp.asarray(labels), cfg)
    draws = _jax_draws(key, 16, cfg)
    got_i, got_l = device2d.apply_augment(torch.from_numpy(images),
                                          torch.from_numpy(labels), draws)
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    np.testing.assert_allclose(got_i.numpy(), np.asarray(want_i), rtol=0,
                               atol=1e-7)


@pytest.mark.parametrize("op,k", [("hflip", 0), ("vflip", 0), ("k90", 1),
                                  ("k90", 2), ("k90", 3), ("transpose", 0)])
def test_each_geometric_op_alone_equals_numpy(op, k):
    x = np.arange(2 * 5 * 5 * 1, dtype=np.float32).reshape(2, 5, 5, 1)
    n = 2
    draws = device2d.AugmentDraws(
        hflip=torch.zeros(n, dtype=torch.bool),
        vflip=torch.zeros(n, dtype=torch.bool),
        k90=torch.zeros(n, dtype=torch.int64),
        transpose=torch.zeros(n, dtype=torch.bool),
        brightness_contrast=torch.zeros(n, dtype=torch.bool),
        alpha=torch.ones(n), beta=torch.zeros(n))
    if op == "k90":
        draws.k90[0] = k
    else:
        getattr(draws, op)[0] = True
    want = {"hflip": np.flip(x[0], 1), "vflip": np.flip(x[0], 0),
            "k90": np.rot90(x[0], k, axes=(0, 1)),
            "transpose": np.swapaxes(x[0], 0, 1)}[op]
    got_i, got_l = device2d.apply_augment(torch.from_numpy(x),
                                          torch.from_numpy(x[..., 0]), draws)
    np.testing.assert_array_equal(got_i[0].numpy(), want)
    np.testing.assert_array_equal(got_l[0].numpy(), want[..., 0])
    np.testing.assert_array_equal(got_i[1].numpy(), x[1])  # untouched


def test_draw_frequencies_match_the_config():
    """Over 40k draws: each flag at its p (within 0.01), RandomRotate90's
    k = 0 at 1 − p + p/4 and k = 1, 2, 3 at p/4 each, the factors uniform
    over their limits."""
    cfg = device2d.Augment2DConfig(p_hflip=0.3, p_vflip=0.5, p_rot90=0.6,
                                   p_transpose=0.7,
                                   p_brightness_contrast=0.2,
                                   brightness_limit=0.1, contrast_limit=0.3)
    n = 40000
    d = device2d.draw_augment(n, cfg, torch.Generator().manual_seed(0))
    for flag, p in (("hflip", 0.3), ("vflip", 0.5), ("transpose", 0.7),
                    ("brightness_contrast", 0.2)):
        assert abs(getattr(d, flag).float().mean().item() - p) < 0.01, flag
    counts = torch.bincount(d.k90, minlength=4).float() / n
    np.testing.assert_allclose(counts.numpy(), [0.4 + 0.15, 0.15, 0.15, 0.15],
                               atol=0.01)
    assert d.alpha.min() >= 0.7 and d.alpha.max() <= 1.3
    assert d.beta.min() >= -0.1 and d.beta.max() <= 0.1
    assert abs(d.alpha.mean().item() - 1.0) < 0.01
    assert abs(d.beta.std().item() - 0.2 / math.sqrt(12)) < 0.005


def test_augment_keeps_image_and_mask_locked():
    """A mask equal to the image's first channel stays equal to it after
    any geometry (brightness/contrast off); the same generator seed gives
    the same batch."""
    cfg = device2d.Augment2DConfig(p_brightness_contrast=0.0)
    x = torch.rand(64, 6, 6, 2, generator=torch.Generator().manual_seed(1))
    img, mask = device2d.augment_batch(x, x[..., :1].clone(), cfg,
                                       torch.Generator().manual_seed(7))
    assert torch.equal(img[..., :1], mask)
    assert not torch.equal(img, x)
    img2, _ = device2d.augment_batch(x, x[..., :1].clone(), cfg,
                                     torch.Generator().manual_seed(7))
    assert torch.equal(img, img2)
    bright, _ = device2d.augment_batch(
        x, x[..., :1], device2d.Augment2DConfig(p_brightness_contrast=1.0),
        torch.Generator().manual_seed(2))
    assert bright.min() >= 0.0 and bright.max() <= 1.0


def test_augment_refuses_a_generator_elsewhere_or_non_square():
    x = torch.zeros(2, 4, 4, 1)
    with pytest.raises(ValueError, match="Generator"):
        device2d.augment_batch(x, x, device2d.Augment2DConfig(), None)
    with pytest.raises(ValueError, match="square"):
        device2d.augment_batch(torch.zeros(2, 4, 5, 1), torch.zeros(2, 4, 5),
                               device2d.Augment2DConfig(),
                               torch.Generator())


# -- data ----------------------------------------------------------------------

@pytest.mark.parametrize("n", range(3, 61))
def test_split_equals_sklearn(n):
    """Both stages of the 70/20/10 split, as SliceDataset makes them."""
    items = [f"f{i:02d}" for i in range(n)]
    masks = [f"m{i:02d}" for i in range(n)]

    def stages(split):
        try:
            tr, tmp, trm, tmpm = split(items, masks, test_size=1 - 0.7,
                                       random_state=42)
            ev, te, evm, tem = split(tmp, tmpm, test_size=1 - 0.2 / 0.3,
                                     random_state=42)
        except ValueError:
            return "ValueError"
        return [list(a) for a in (tr, trm, ev, evm, te, tem)]

    assert stages(png2d.train_test_split) == stages(sk_split)


def _write_fixtures(root, layout, n, rng):
    """PNGs written by PIL: RGB (DRIVE) or grey (BUSI) images of mixed
    sizes, grey masks."""
    img_dir = os.path.join(root, "images")
    mask_dir = os.path.join(root, *(("labels",) if layout == "DRIVE"
                                    else ("mask", "0")))
    os.makedirs(img_dir)
    os.makedirs(mask_dir)
    for i in range(n):
        h, w = (20, 30) if i % 2 else (17, 17)
        shape = (h, w, 3) if layout == "DRIVE" else (h, w)
        Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8)).save(
            os.path.join(img_dir, f"{i:02d}.png"))
        Image.fromarray(((rng.random((h, w)) > 0.5) * 255).astype(np.uint8)
                        ).save(os.path.join(mask_dir, f"{i:02d}.png"))


@pytest.mark.parametrize("layout", ["DRIVE", "BUSI"])
@pytest.mark.parametrize("mode", ["train", "eval", "test"])
def test_slice_dataset_items_equal_jax(tmp_path, layout, mode):
    _write_fixtures(str(tmp_path), layout, 13, np.random.default_rng(0))
    name = f"{layout}Dataset"
    want = getattr(jax_png2d, name)(str(tmp_path), mode=mode, resolution=24)
    got = getattr(png2d, name)(str(tmp_path), mode=mode, resolution=24)
    assert len(got) == len(want) > 0 and got.num_channels == want.num_channels
    assert got.images_path == list(want.images_path)
    for i in range(len(want)):
        for key in ("image", "mask"):
            assert got[i][key].dtype == np.float32
            np.testing.assert_array_equal(got[i][key], want[i][key])
    assert got[0] is got[0]  # memoized


@pytest.mark.parametrize("n_classes", [1, 3])
def test_synthetic_dataset_equals_jax(n_classes):
    want = jax_png2d.SyntheticSliceDataset(5, 32, channels=2, seed=3,
                                           n_classes=n_classes)
    got = png2d.SyntheticSliceDataset(5, 32, channels=2, seed=3,
                                      n_classes=n_classes)
    for i in range(5):
        for key in ("image", "mask"):
            np.testing.assert_array_equal(got[i][key], want[i][key])


@pytest.mark.parametrize("shuffle,n,batch", [(True, 10, 3), (True, 2, 5),
                                             (False, 7, 3), (False, 2, 5)])
def test_batch_loader_order_equals_jax_across_epochs(shuffle, n, batch):
    """RandomState(seed + epoch) permutations, drop-last when shuffling,
    wrap padding (a dataset smaller than the batch still yields one)."""
    ds = png2d.SyntheticSliceDataset(n, 8, seed=1)
    jds = jax_png2d.SyntheticSliceDataset(n, 8, seed=1)
    for workers, prefetch in ((0, 0), (2, 2)):
        got = collate.BatchLoader(ds, batch, shuffle=shuffle, seed=5,
                                  num_workers=workers, prefetch=prefetch)
        want = jax_collate.BatchLoader(jds, batch, shuffle=shuffle, seed=5)
        assert len(got) == len(want)
        for _ in range(3):
            g, w = list(got), list(want)
            assert len(g) == len(w)
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a["images"], b["images"])
                np.testing.assert_array_equal(a["labels"], b["labels"])
        got.close()


def test_collator_aliases_and_unported_sharding():
    assert collate.DRIVEDataCollator is collate.SliceCollator
    assert collate.BUSIDataCollator is collate.SliceCollator
    batch = collate.SliceCollator()([{"image": np.zeros((4, 4, 3)),
                                      "mask": np.ones((4, 4, 1))}] * 2)
    assert batch["images"].shape == (2, 4, 4, 3)
    assert batch["labels"].shape == (2, 4, 4, 1)
    # process sharding (item 25a): each process's rows of the JAX
    # package's global batches, shuffled and in eval order
    ds = [{"image": np.full((2, 2, 1), i, np.float32),
           "mask": np.zeros((2, 2, 1), np.float32)} for i in range(7)]
    for shuffle in (True, False):
        for index in range(2):
            kw = dict(shuffle=shuffle, seed=3, prefetch=0,
                      process_shard=(index, 2))
            got = [b["images"][:, 0, 0, 0] for b in
                   collate.BatchLoader(ds, 4, **kw)]
            want = [b["images"][:, 0, 0, 0] for b in
                    jax_collate.BatchLoader(ds, 4, **kw)]
            assert len(got) == len(want) == (1 if shuffle else 2)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
                assert len(g) == 2
    with pytest.raises(ValueError, match="not divisible"):
        collate.BatchLoader(ds, 3, process_shard=(0, 2))

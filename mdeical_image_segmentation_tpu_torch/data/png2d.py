"""2D PNG slice datasets, host side (the JAX package's ``data/png2d.py``).

- directory layouts: DRIVE = ``images/*`` + ``labels/*``; BUSI = grey
  ``images/*`` + masks under ``mask/0/*``;
- the deterministic 70/20/10 train/eval/test split of two
  ``train_test_split(test_size=t, random_state=42)`` calls, rebuilt without
  sklearn (``train_test_split``: sklearn's ShuffleSplit, bit for bit);
- nearest-neighbour resize to a square resolution, source index
  ``floor(dst * in / out)``;
- samples scaled to [0, 1], masks with a trailing channel dim.

``__getitem__`` decodes (the port's PNG codec, ``utils/png.py``, in place of
PIL: the files must be PNGs), resizes and normalizes, and memoizes the
sample; the random augmentations run on the device, batched
(``transforms.device2d``).
"""

from __future__ import annotations

import math
import os
from glob import glob
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils import png


def nearest_resize(img: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """cv2.INTER_NEAREST-style resize of (H, W[, C]) numpy arrays:
    source index = floor(dst * in/out)."""
    h, w = img.shape[:2]
    oh, ow = out_hw
    if (h, w) == (oh, ow):
        return img
    ri = np.minimum((np.arange(oh) * h // oh), h - 1)
    ci = np.minimum((np.arange(ow) * w // ow), w - 1)
    return img[ri][:, ci]


def train_test_split(*arrays: Sequence, test_size: float,
                     random_state: int) -> List[list]:
    """sklearn's ``train_test_split(*arrays, test_size=test_size,
    random_state=random_state)`` for a float ``test_size`` and list inputs:
    ``n_test = ceil(test_size · n)``, ``n_train = n − n_test``, one
    ``RandomState(random_state).permutation(n)``; test takes its first
    ``n_test`` entries and train the next ``n_train``.  Returns
    ``[a_train, a_test, b_train, b_test, ...]``."""
    n = len(arrays[0])
    if any(len(a) != n for a in arrays):
        raise ValueError("Found input variables with inconsistent numbers "
                         f"of samples: {[len(a) for a in arrays]}")
    if not 0.0 < test_size < 1.0:
        raise ValueError(f"test_size={test_size} should be a float in (0, 1)")
    n_test = math.ceil(test_size * n)
    n_train = n - n_test
    if n_train <= 0:
        raise ValueError(
            f"With n_samples={n}, test_size={test_size} and train_size=None, "
            "the resulting train set will be empty")
    order = np.random.RandomState(random_state).permutation(n)
    test, train = order[:n_test], order[n_test:n_test + n_train]
    out: List[list] = []
    for a in arrays:
        out += [[a[i] for i in train], [a[i] for i in test]]
    return out


class SliceDataset:
    """Base PNG-pair dataset with the reference's split and normalization.

    ``__getitem__`` → {"image": float32 (H, W, C) in [0,1],
                       "mask":  float32 (H, W, 1) in [0,1]}.
    """

    image_mode = "RGB"

    def __init__(self, data_path: str, mode: str = "train", *,
                 train_ratio: float = 0.7, eval_ratio: float = 0.2,
                 random_seed: int = 42, resolution: int = 512,
                 cache: bool = True):
        self.resolution = resolution
        self.mode = mode
        images, masks = self._discover(data_path)
        if len(images) != len(masks):
            raise ValueError("The number of images and masks do not match.")

        # two-stage split, seed-42 parity with the reference
        train_images, temp_images, train_masks, temp_masks = train_test_split(
            images, masks, test_size=(1 - train_ratio),
            random_state=random_seed)
        eval_size = eval_ratio / (1 - train_ratio)
        eval_images, test_images, eval_masks, test_masks = train_test_split(
            temp_images, temp_masks, test_size=(1 - eval_size),
            random_state=random_seed)
        split = {
            "train": (train_images, train_masks),
            "eval": (eval_images, eval_masks),
            "test": (test_images, test_masks),
        }
        if mode not in split:
            raise ValueError("Mode should be 'train', 'eval', or 'test'.")
        self.images_path, self.masks_path = split[mode]
        self.n_samples = len(self.images_path)
        self._cache: Optional[List] = [None] * self.n_samples if cache else None

        for p in self.masks_path:
            if not os.path.exists(p):
                print(f"file {p} does not exist.")

    def _discover(self, data_path: str) -> Tuple[List[str], List[str]]:
        return (sorted(glob(os.path.join(data_path, "images", "*"))),
                sorted(glob(os.path.join(data_path, "labels", "*"))))

    def _load(self, index: int) -> Dict[str, np.ndarray]:
        image = png.read(self.images_path[index], self.image_mode)
        mask = png.read(self.masks_path[index], "L")
        if image.ndim == 2:
            image = image[..., None]
        res = (self.resolution, self.resolution)
        image = nearest_resize(image, res)
        mask = nearest_resize(mask, res)
        return {"image": image.astype(np.float32) / 255.0,
                "mask": (mask.astype(np.float32) / 255.0)[..., None]}

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        if self._cache is not None:
            if self._cache[index] is None:
                self._cache[index] = self._load(index)
            return self._cache[index]
        return self._load(index)

    def __len__(self) -> int:
        return self.n_samples

    @property
    def num_channels(self) -> int:
        return 3 if self.image_mode == "RGB" else 1


class DRIVEDataset(SliceDataset):
    """Retinal-vessel DRIVE layout (RGB images + ``labels/``)."""


class BUSIDataset(SliceDataset):
    """Breast-ultrasound BUSI layout: grey images, masks in ``mask/0/``.
    The reference's BUSI class uses every sample in every mode; here the
    split applies, as in the JAX package."""

    image_mode = "L"

    def _discover(self, data_path: str):
        return (sorted(glob(os.path.join(data_path, "images", "*"))),
                sorted(glob(os.path.join(data_path, "mask", "0", "*"))))


class SyntheticSliceDataset:
    """Synthetic binary-segmentation slices (BASELINE.json config #1: 256²
    grey): random blobs and their masks, deterministic per index, made
    lazily and cached.

    ``n_classes > 1`` switches to the multi-class contract: masks are
    integer class-id maps (H, W), each blob a class in 1..n_classes-1 with a
    class-dependent intensity."""

    def __init__(self, n_samples: int = 64, resolution: int = 256,
                 channels: int = 1, seed: int = 0, n_classes: int = 1):
        if n_classes < 1:
            raise ValueError(f"n_classes must be >= 1, got {n_classes}")
        self.n_samples = n_samples
        self.resolution = resolution
        self.channels = channels
        self.seed = seed
        self.n_classes = n_classes
        self._cache: List = [None] * n_samples

    def _make(self, index: int) -> Dict[str, np.ndarray]:
        rng = np.random.RandomState(self.seed * 100003 + index)
        r = self.resolution
        yy, xx = np.mgrid[0:r, 0:r].astype(np.float32) / r
        mask = np.zeros((r, r), np.float32)
        for _ in range(rng.randint(1, 4)):
            cy, cx = rng.rand(2)
            rad = 0.08 + 0.17 * rng.rand()
            blob = ((yy - cy) ** 2 + (xx - cx) ** 2 < rad**2).astype(np.float32)
            if self.n_classes > 1:
                cls = float(rng.randint(1, self.n_classes))
                # later blobs overwrite earlier ones where they overlap
                mask = np.where(blob > 0, cls * blob, mask)
            else:
                mask = np.maximum(mask, blob)
        noise = rng.rand(r, r).astype(np.float32)
        if self.n_classes > 1:
            fg = (mask > 0).astype(np.float32)
            shade = mask / max(self.n_classes - 1, 1)
            image = np.clip(
                0.4 * fg + 0.3 * shade + 0.25 * noise + 0.05 * rng.rand(), 0, 1)
            image = np.repeat(image[..., None], self.channels, axis=-1)
            return {"image": image, "mask": mask.astype(np.int32)}
        image = np.clip(0.6 * mask + 0.3 * noise + 0.1 * rng.rand(), 0, 1)
        image = np.repeat(image[..., None], self.channels, axis=-1)
        return {"image": image, "mask": mask[..., None]}

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        if self._cache[index] is None:
            self._cache[index] = self._make(index)
        return self._cache[index]

    def __len__(self) -> int:
        return self.n_samples

    @property
    def num_channels(self) -> int:
        return self.channels

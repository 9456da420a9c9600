"""DSB2018-style 2D dataset (the JAX package's ``data/dsb.py``).

Loads every image of ``<root>/images/`` (and ``<root>/masks/`` for train
and val) into memory, expanded to the C(Z)HW layout the transform
pipelines take: an (H, W) image becomes (1, H, W), an (H, W, C) one
(C, 1, H, W).  The test phase returns (image, path) pairs, batched by
``dsb_prediction_collate``.

Images are read by ``utils/image.py``'s ``imread`` into what
``imageio.imread`` gives the JAX package for a file under its own
extension: PNG, GIF, BMP and JPEG as imageio's pillow plugin reads them
(palette images as RGB, 1-bit as bool, 16-bit PNG grey kept, a JPEG as
libjpeg-turbo decodes it: (H, W) grey or (H, W, 3)), TIFF as its vendored
tifffile does (samples as stored, 16 bits kept, planar images as (S, H, W),
same-shaped pages stacked).  Any other file, and the variants the decoders
do not read yet, raise ``ImageError`` naming ROADMAP item 20c.
"""

from __future__ import annotations

import collections.abc
import os
from typing import List, Tuple

import numpy as np

from ..logging_utils import get_logger
from ..transforms.volume import Transformer
from ..utils.image import imread
from .hdf5 import ConfigDataset
from .volume_utils import calculate_stats

logger = get_logger("DSB2018Dataset")


def dsb_prediction_collate(batch):
    """A test batch of (images, paths): images stacked, paths listed."""
    if isinstance(batch[0], np.ndarray):
        return np.stack(batch, 0)
    if isinstance(batch[0], str):
        return list(batch)
    if isinstance(batch[0], collections.abc.Sequence):
        return [dsb_prediction_collate(samples) for samples in zip(*batch)]
    raise TypeError(f"batch must contain arrays or str; found "
                    f"{type(batch[0])}")


class DSB2018Dataset(ConfigDataset):
    def __init__(self, root_dir, phase, transformer_config,
                 expand_dims=True):
        if not os.path.isdir(root_dir):
            raise ValueError(f"{root_dir} is not a directory")
        if phase not in ("train", "val", "test"):
            raise ValueError(f"phase {phase!r}: train, val or test")
        self.phase = phase
        images_dir = os.path.join(root_dir, "images")
        if not os.path.isdir(images_dir):
            raise ValueError(f"{root_dir} has no images/ directory")
        self.images, self.paths = self._load_files(images_dir, expand_dims)
        self.file_path = images_dir

        transformer = Transformer(transformer_config,
                                  calculate_stats(None, True))
        self.raw_transform = transformer.raw_transform()
        if phase != "test":
            masks_dir = os.path.join(root_dir, "masks")
            if not os.path.isdir(masks_dir):
                raise ValueError(f"{root_dir} has no masks/ directory")
            self.masks, _ = self._load_files(masks_dir, expand_dims)
            if len(self.images) != len(self.masks):
                raise ValueError(f"{len(self.images)} images and "
                                 f"{len(self.masks)} masks")
            self.masks_transform = transformer.label_transform()
        else:
            self.masks = None
            self.masks_transform = None

    def __getitem__(self, idx):
        if idx >= len(self):
            raise StopIteration
        img = self.images[idx]
        if self.phase != "test":
            return (self.raw_transform(img),
                    self.masks_transform(self.masks[idx]))
        return self.raw_transform(img), self.paths[idx]

    def __len__(self):
        return len(self.images)

    @classmethod
    def prediction_collate(cls, batch):
        return dsb_prediction_collate(batch)

    @classmethod
    def create_datasets(cls, dataset_config, phase):
        phase_config = dataset_config[phase]
        return [cls(phase_config["file_paths"][0], phase,
                    phase_config["transformer"],
                    dataset_config.get("expand_dims", True))]

    @staticmethod
    def _load_files(dir: str, expand_dims: bool
                    ) -> Tuple[List[np.ndarray], List[str]]:
        files_data, paths = [], []
        for file in sorted(os.listdir(dir)):
            path = os.path.join(dir, file)
            img = imread(path)
            if expand_dims:
                dims = img.ndim
                img = np.expand_dims(img, axis=0)
                if dims == 3:
                    img = np.transpose(img, (3, 0, 1, 2))
            files_data.append(img)
            paths.append(path)
        return files_data, paths

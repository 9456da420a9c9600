"""HDF5 volume datasets (the JAX package's ``data/hdf5.py``), read with the
port's own codec (``utils/hdf5.py``: the machine with the card has no
h5py).

A dataset iterates one HDF5 file patch by patch through its slice builder.
Train and val phases return transformed ``(raw, label[, weight])``
patches; the test phase returns ``(halo-padded raw patch, spatial slice
index)`` pairs for the sliding-window predictor.  Normalization stats over
the whole raw volume are computed when ``global_normalization`` is set.
``create_datasets`` expands directories and skips an unreadable file with
its traceback logged.  Samples come out channels-last ((Z, Y, X, C) numpy)
through the pipelines' terminal ``ToTensor``.

``StandardHDF5Dataset`` reads each whole array into memory on first
access; ``LazyHDF5Dataset`` reads per patch, for volumes larger than RAM,
and memoizes the halo-padded raw volume in the input file itself as
``raw_padded_<h>x<h>x<h>`` (gzip, appended in place through the codec's
``"r+"`` mode), which a later run with the same halo reads per patch.
``DSB2018Dataset`` (PNG images) lives in ``data/dsb.py``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from ..logging_utils import get_logger
from ..transforms.volume import Transformer
from ..utils import hdf5
from .slice_builder import get_slice_builder
from .volume_utils import (
    calculate_stats,
    create_padded_indexes,
    mirror_pad,
    traverse_h5_paths,
)

logger = get_logger("HDF5Dataset")


class ConfigDataset:
    """Dataset interface of the config-driven loaders."""

    def __getitem__(self, index):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    @classmethod
    def create_datasets(cls, dataset_config, phase):
        raise NotImplementedError

    @classmethod
    def prediction_collate(cls, batch):
        from .loaders import default_prediction_collate

        return default_prediction_collate(batch)


class AbstractHDF5Dataset(ConfigDataset):
    def __init__(self, file_path: str, phase: str,
                 slice_builder_config: Dict[str, Any],
                 transformer_config: Dict[str, Any],
                 raw_internal_path: str = "raw",
                 label_internal_path: str = "label",
                 weight_internal_path: Optional[str] = None,
                 global_normalization: bool = True):
        if phase not in ("train", "val", "test"):
            raise ValueError(f"phase {phase!r}: train, val or test")
        self.phase = phase
        self.file_path = file_path
        self.raw_internal_path = raw_internal_path
        self.label_internal_path = label_internal_path
        self.weight_internal_path = weight_internal_path
        self.halo_shape = slice_builder_config.get("halo_shape", [0, 0, 0])

        if global_normalization:
            logger.info("computing global normalization stats over the raw "
                        "volume")
            with hdf5.File(file_path, "r") as f:
                stats = calculate_stats(f[raw_internal_path][:])
        else:
            stats = calculate_stats(None, True)

        self.transformer = Transformer(transformer_config, stats)
        self.raw_transform = self.transformer.raw_transform()

        if phase != "test":
            self.label_transform = self.transformer.label_transform()
            self.weight_transform = (self.transformer.weight_transform()
                                     if weight_internal_path is not None
                                     else None)
            self._check_volume_sizes()
        else:
            patch_shape = slice_builder_config.get("patch_shape")
            stride_shape = slice_builder_config.get("stride_shape")
            if sum(self.halo_shape) != 0 and patch_shape != stride_shape:
                logger.warning(
                    f"halo {self.halo_shape} with patch_shape {patch_shape} "
                    f"!= stride_shape {stride_shape}: overlapping windows "
                    f"are predicted twice — equal shapes tile fastest")

        with hdf5.File(file_path, "r") as f:
            raw = f[raw_internal_path]
            label = f[label_internal_path] if phase != "test" else None
            weight_map = (f[weight_internal_path]
                          if weight_internal_path is not None else None)
            slice_builder = get_slice_builder(raw, label, weight_map,
                                              slice_builder_config)
            self.raw_slices = slice_builder.raw_slices
            self.label_slices = slice_builder.label_slices
            self.weight_slices = slice_builder.weight_slices

        self.patch_count = len(self.raw_slices)
        logger.info(f"{self.patch_count} patches from {file_path}")

    def get_raw_patch(self, idx):
        raise NotImplementedError

    def get_label_patch(self, idx):
        raise NotImplementedError

    def get_weight_patch(self, idx):
        raise NotImplementedError

    def get_raw_padded_patch(self, idx):
        raise NotImplementedError

    def volume_shape(self):
        with hdf5.File(self.file_path, "r") as f:
            raw = f[self.raw_internal_path]
            return raw.shape if raw.ndim == 3 else raw.shape[1:]

    def __getitem__(self, idx):
        if idx >= len(self):
            raise StopIteration
        raw_idx = self.raw_slices[idx]
        if self.phase == "test":
            if len(raw_idx) == 4:
                raw_idx = raw_idx[1:]
                raw_idx_padded = (slice(None),) + create_padded_indexes(
                    raw_idx, self.halo_shape)
            else:
                raw_idx_padded = create_padded_indexes(raw_idx,
                                                       self.halo_shape)
            return (self.raw_transform(
                self.get_raw_padded_patch(raw_idx_padded)), raw_idx)

        raw_patch = self.raw_transform(self.get_raw_patch(raw_idx))
        label_patch = self.label_transform(
            self.get_label_patch(self.label_slices[idx]))
        if self.weight_internal_path is not None:
            weight_patch = self.weight_transform(
                self.get_weight_patch(self.weight_slices[idx]))
            return raw_patch, label_patch, weight_patch
        return raw_patch, label_patch

    def __len__(self):
        return self.patch_count

    def _check_volume_sizes(self):
        def _volume_shape(volume):
            return volume.shape if volume.ndim == 3 else volume.shape[1:]

        with hdf5.File(self.file_path, "r") as f:
            volumes = [("raw", f[self.raw_internal_path]),
                       ("label", f[self.label_internal_path])]
            if self.weight_internal_path is not None:
                volumes.append(("weight map", f[self.weight_internal_path]))
            for what, volume in volumes:
                if volume.ndim not in (3, 4):
                    raise ValueError(f"{what} must be DxHxW or CxDxHxW, got "
                                     f"ndim={volume.ndim}")
            raw_shape = _volume_shape(volumes[0][1])
            for what, volume in volumes[1:]:
                if _volume_shape(volume) != raw_shape:
                    raise ValueError(
                        f"raw {raw_shape} and {what} "
                        f"{_volume_shape(volume)} spatial shapes differ")

    @classmethod
    def create_datasets(cls, dataset_config, phase
                        ) -> List["AbstractHDF5Dataset"]:
        phase_config = dataset_config[phase]
        datasets = []
        for file_path in traverse_h5_paths(phase_config["file_paths"]):
            try:
                logger.info(f"building {phase} dataset from {file_path}")
                datasets.append(cls(
                    file_path=file_path, phase=phase,
                    slice_builder_config=phase_config["slice_builder"],
                    transformer_config=phase_config["transformer"],
                    raw_internal_path=dataset_config.get(
                        "raw_internal_path", "raw"),
                    label_internal_path=dataset_config.get(
                        "label_internal_path", "label"),
                    weight_internal_path=dataset_config.get(
                        "weight_internal_path", None),
                    global_normalization=dataset_config.get(
                        "global_normalization", None)))
            except Exception:  # noqa: BLE001 - one bad file skips, logged
                logger.error(f"unreadable {phase} file {file_path} — "
                             "skipped", exc_info=True)
        return datasets


class StandardHDF5Dataset(AbstractHDF5Dataset):
    """Reads each whole array into memory on first access."""

    def __init__(self, file_path, phase, slice_builder_config,
                 transformer_config, raw_internal_path="raw",
                 label_internal_path="label", weight_internal_path=None,
                 global_normalization=True):
        super().__init__(
            file_path=file_path, phase=phase,
            slice_builder_config=slice_builder_config,
            transformer_config=transformer_config,
            raw_internal_path=raw_internal_path,
            label_internal_path=label_internal_path,
            weight_internal_path=weight_internal_path,
            global_normalization=global_normalization)
        self._raw = None
        self._raw_padded = None
        self._label = None
        self._weight_map = None

    def _read(self, internal_path):
        with hdf5.File(self.file_path, "r") as f:
            if internal_path not in f:
                raise KeyError(f"{self.file_path} has no dataset "
                               f"'{internal_path}'")
            return f[internal_path][:]

    def _cached(self, attr, internal_path):
        if getattr(self, attr) is None:
            setattr(self, attr, self._read(internal_path))
        return getattr(self, attr)

    def get_raw_patch(self, idx):
        return self._cached("_raw", self.raw_internal_path)[idx]

    def get_label_patch(self, idx):
        return self._cached("_label", self.label_internal_path)[idx]

    def get_weight_patch(self, idx):
        return self._cached("_weight_map", self.weight_internal_path)[idx]

    def get_raw_padded_patch(self, idx):
        if self._raw_padded is None:
            self._raw_padded = mirror_pad(self._read(self.raw_internal_path),
                                          self.halo_shape)
        return self._raw_padded[idx]


class LazyHDF5Dataset(AbstractHDF5Dataset):
    """Reopens the file per access and reads only the patch; the padded raw
    volume is memoized in the input file (mode ``"r+"``)."""

    def __init__(self, file_path, phase, slice_builder_config,
                 transformer_config, raw_internal_path="raw",
                 label_internal_path="label", weight_internal_path=None,
                 global_normalization=False):
        super().__init__(
            file_path=file_path, phase=phase,
            slice_builder_config=slice_builder_config,
            transformer_config=transformer_config,
            raw_internal_path=raw_internal_path,
            label_internal_path=label_internal_path,
            weight_internal_path=weight_internal_path,
            global_normalization=global_normalization)
        logger.info("lazy H5 access: per-patch reads, padded raw memoized "
                    "in-file")

    def _read(self, internal_path, idx):
        with hdf5.File(self.file_path, "r") as f:
            return f[internal_path][idx]

    def get_raw_patch(self, idx):
        return self._read(self.raw_internal_path, idx)

    def get_label_patch(self, idx):
        return self._read(self.label_internal_path, idx)

    def get_weight_patch(self, idx):
        return self._read(self.weight_internal_path, idx)

    def get_raw_padded_patch(self, idx):
        # the key names the halo: a memo of another halo is another dataset
        key = "raw_padded_" + "x".join(str(h) for h in self.halo_shape)
        with hdf5.File(self.file_path, "r+") as f:
            if key in f:
                return f[key][idx]
            raw_padded = mirror_pad(f[self.raw_internal_path][:],
                                    self.halo_shape)
            f.create_dataset(key, data=raw_padded, compression="gzip")
            return raw_padded[idx]

"""Device-resident 3D training data (``loaders: {device_cache: true}``; the
JAX package's ``data/device_cache.py``).

The host loader assembles every patch on the CPU and copies it to the
device each step.  This loader copies the train *volumes* to the device
once and moves nothing per step but the patch coordinates, which stay on
the host:

  host    the SliceBuilder grid (the exact patch coverage of the host path),
          the per-epoch order from ``np.random.RandomState(seed + epoch)``
          and the batching (a dataset smaller than one batch is
          wrap-padded), so the coordinate stream is the JAX package's
          exactly;
  device  the batch's patches sliced out of the stacked volumes, then the
          random augmentations, batched, with every draw from one
          ``torch.Generator`` on the device seeded with ``seed + 7``.

Supported transforms (anything else raises :class:`DeviceCacheUnsupported`,
and ``get_train_loaders`` falls back to the host loader with a warning):

  raw    Standardize (the global-stats form baked into the cached volume
         once; the per-patch form, with the population std, on the device),
         RandomFlip, RandomRotate90, RandomContrast, AdditiveGaussianNoise,
         AdditivePoissonNoise, ToTensor
  label  RandomFlip, RandomRotate90, ToTensor — the geometric subsequence
         must equal the raw pipeline's (same order, same parameters); raw
         and label then take the SAME draws (the host pipelines' shared-seed
         RandomState lock)

The quirks of the host transforms are kept: RandomFlip flips an axis when
its draw u > axis_prob; RandomRotate90 turns the (H, W) plane by k
quarter-turns and needs square H x W patches (the four turns are computed
and one is selected per patch, so no draw is read on the host).  The
interpolating transforms (RandomRotate, ElasticDeformation) and per-voxel
weight maps have no device form, as in the JAX package.

A sampling step reads no value back to the host.  The sample stream differs
from the host path's, and from the JAX package's (Philox here, threefry
there), by construction; the patch coverage and order are the same.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..logging_utils import get_logger
from ..utils import hdf5
from .hdf5 import AbstractHDF5Dataset

logger = get_logger("DeviceCache")

_RAW_SUPPORTED = {
    "Standardize",
    "RandomFlip",
    "RandomRotate90",
    "RandomContrast",
    "AdditiveGaussianNoise",
    "AdditivePoissonNoise",
    "ToTensor",
}
_LABEL_SUPPORTED = {"RandomFlip", "RandomRotate90", "ToTensor"}
_GEOMETRIC = {"RandomFlip", "RandomRotate90"}
_CACHE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class DeviceCacheUnsupported(ValueError):
    """The datasets or pipelines cannot run device-resident; the caller
    falls back to the host loader."""


def _as_dhwc(vol: np.ndarray) -> np.ndarray:
    """A DxHxW or CxDxHxW volume → (D, H, W, C), as ToTensor lays it out."""
    if vol.ndim == 3:
        return vol[..., None]
    if vol.ndim == 4:
        return np.moveaxis(vol, 0, -1)
    raise DeviceCacheUnsupported(f"volume ndim {vol.ndim} not in (3, 4)")


def _label_dtype(entry: Dict[str, Any]) -> torch.dtype:
    dtype = entry.get("dtype", np.float32)
    if isinstance(dtype, str) and dtype == "long":  # the torch spelling
        dtype = np.int64
    return torch.from_numpy(np.zeros((), np.dtype(dtype))).dtype


def _geometry_params(entry: Dict[str, Any]) -> Tuple[str, Tuple]:
    """(name, parameters) of a geometric transform: the raw and label
    sequences must agree on them for the shared draws."""
    name = entry["name"]
    if name == "RandomFlip":
        return (name, (float(entry.get("axis_prob", 0.5)),))
    return (name, ())


def _pick(do: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per patch: a where ``do`` (B,) holds, else b."""
    return torch.where(do.reshape((-1,) + (1,) * (a.ndim - 1)), a, b)


class DeviceCachedVolumeLoader:
    """Train-phase loader over HDF5 datasets whose volumes live on
    ``device``.  Yields ``(raw, label, None)`` batches on the device (raw
    float32 (B, D, H, W, C), label in its ToTensor dtype): the trainer takes
    them as they are (``is_device_cached``)."""

    is_device_cached = True

    def __init__(self, datasets: Sequence[AbstractHDF5Dataset],
                 batch_size: int, device, seed: int = 0,
                 cache_dtype: str = "float32", budget_gb: float = 4.0):
        if not datasets:
            raise DeviceCacheUnsupported("no train datasets")
        if dist.is_initialized() and dist.get_world_size() > 1:
            raise DeviceCacheUnsupported(
                "device_cache is single-process (a data-parallel run needs "
                "per-process loader shards: the host loader has them)")
        for ds in datasets:
            if not isinstance(ds, AbstractHDF5Dataset):
                raise DeviceCacheUnsupported(
                    f"{type(ds).__name__} is not an HDF5 dataset")
            if ds.phase != "train":
                raise DeviceCacheUnsupported("device_cache is train-only")
            if ds.weight_internal_path is not None:
                raise DeviceCacheUnsupported("per-voxel weight maps")
        if cache_dtype not in _CACHE_DTYPES:
            raise DeviceCacheUnsupported(
                f"device_cache_dtype {cache_dtype!r}: 'float32' or "
                "'bfloat16'")

        self.device = torch.device(device)
        self.batch_size = int(batch_size)
        self.seed = int(seed)
        self._epoch = 0

        raw_cfg = datasets[0].transformer.phase_config["raw"]
        label_cfg = datasets[0].transformer.phase_config["label"]
        self._validate_pipelines(raw_cfg, label_cfg)
        self._raw_cfg = raw_cfg
        # Standardize entries with (entry or global) statistics are baked
        # into the cached volume; the others standardize each patch
        stats0 = datasets[0].transformer.config_base
        self._baked = {
            j for j, e in enumerate(raw_cfg)
            if e["name"] == "Standardize"
            and e.get("mean", stats0.get("mean")) is not None}

        raws: List[np.ndarray] = []
        labels: List[np.ndarray] = []
        coords: List[np.ndarray] = []
        patch: Optional[Tuple[int, int, int]] = None
        for v, ds in enumerate(datasets):
            raw, label = self._load_volume(ds, raw_cfg)
            raws.append(raw)
            labels.append(label)
            c, p = self._patch_coords(ds)
            patch = patch or p
            if p != patch:
                raise DeviceCacheUnsupported(
                    f"patch shapes differ across datasets: {p} vs {patch}")
            coords.append(np.concatenate(
                [np.full((len(c), 1), v, np.int64), c], axis=1))
        self._patch = patch
        self._coords = np.concatenate(coords, axis=0)
        self._n = len(self._coords)
        if any(e["name"] == "RandomRotate90" for e in raw_cfg) and (
                patch[1] != patch[2]):
            raise DeviceCacheUnsupported(
                f"RandomRotate90 needs square (H, W) patches; got "
                f"{patch[1]}x{patch[2]}")

        # stacked, padded to the largest volume (the SliceBuilder's
        # coordinates lie inside each true volume: padding is never read)
        self._label_dtype = _label_dtype(
            next(e for e in label_cfg if e["name"] == "ToTensor"))
        raw_stack = torch.from_numpy(self._pad_stack(raws)).to(
            _CACHE_DTYPES[cache_dtype])
        label_stack = torch.from_numpy(self._pad_stack(labels)).to(
            self._label_dtype)
        self.nbytes = (raw_stack.numel() * raw_stack.element_size()
                       + label_stack.numel() * label_stack.element_size())
        if self.nbytes > budget_gb * 2**30:
            raise DeviceCacheUnsupported(
                f"volumes need {self.nbytes / 2**30:.2f} GiB > budget "
                f"{budget_gb} GiB (loaders: {{device_cache_budget_gb: N}})")
        self._raws = raw_stack.to(self.device)
        self._labels = label_stack.to(self.device)
        logger.info(
            f"device cache: {len(datasets)} volume(s), "
            f"{self.nbytes / 2**20:.1f} MiB on {self.device}, {self._n} "
            f"patches, patch {patch}, batch {self.batch_size}")
        self._generator = torch.Generator(device=self.device).manual_seed(
            self.seed + 7)

    # -- validation and host-side preparation --------------------------------

    @staticmethod
    def _validate_pipelines(raw_cfg, label_cfg) -> None:
        for entry in raw_cfg:
            if entry["name"] not in _RAW_SUPPORTED:
                raise DeviceCacheUnsupported(
                    f"raw transform '{entry['name']}' has no device form")
        for entry in label_cfg:
            if entry["name"] not in _LABEL_SUPPORTED:
                raise DeviceCacheUnsupported(
                    f"label transform '{entry['name']}' has no device form")
        raw_geom = [_geometry_params(e) for e in raw_cfg
                    if e["name"] in _GEOMETRIC]
        label_geom = [_geometry_params(e) for e in label_cfg
                      if e["name"] in _GEOMETRIC]
        if raw_geom != label_geom:
            raise DeviceCacheUnsupported(
                "raw/label geometric transforms differ — the shared draws "
                f"need identical sequences ({raw_geom} vs {label_geom})")

    @staticmethod
    def _load_volume(ds, raw_cfg) -> Tuple[np.ndarray, np.ndarray]:
        with hdf5.File(ds.file_path, "r") as f:
            raw = _as_dhwc(f[ds.raw_internal_path][:]).astype(np.float32)
            label = _as_dhwc(f[ds.label_internal_path][:])
        # the global-stats Standardize is pointwise and commutes with the
        # flips and turns: applied once here
        stats = ds.transformer.config_base
        for entry in raw_cfg:
            if entry["name"] != "Standardize":
                continue
            mean = entry.get("mean", stats.get("mean"))
            std = entry.get("std", stats.get("std"))
            if mean is not None:
                eps = float(entry.get("eps", 1e-10))
                raw = (raw - mean) / np.clip(std, a_min=eps, a_max=None)
        return raw.astype(np.float32), label

    @staticmethod
    def _patch_coords(ds) -> Tuple[np.ndarray, Tuple[int, int, int]]:
        coords = []
        patch: Optional[Tuple[int, int, int]] = None
        for raw_idx, label_idx in zip(ds.raw_slices, ds.label_slices):
            r, lab = raw_idx[-3:], label_idx[-3:]
            if tuple((s.start, s.stop) for s in r) != tuple(
                    (s.start, s.stop) for s in lab):
                raise DeviceCacheUnsupported(
                    "raw/label patch grids differ (halo?) — host path only")
            size = tuple(s.stop - s.start for s in r)
            patch = patch or size
            if size != patch:
                raise DeviceCacheUnsupported(
                    f"non-uniform patch sizes {size} vs {patch}")
            coords.append([s.start for s in r])
        if patch is None:
            raise DeviceCacheUnsupported("dataset produced zero patches")
        return np.asarray(coords, np.int64), patch

    @staticmethod
    def _pad_stack(vols: List[np.ndarray]) -> np.ndarray:
        shape = tuple(max(v.shape[i] for v in vols) for i in range(4))
        out = np.zeros((len(vols),) + shape, vols[0].dtype)
        for i, v in enumerate(vols):
            out[i, :v.shape[0], :v.shape[1], :v.shape[2], :v.shape[3]] = v
        return out

    # -- the device sampler ----------------------------------------------------

    def _uniform(self, n: int, lo: float = 0.0, hi: float = 1.0
                 ) -> torch.Tensor:
        u = torch.rand((n,), generator=self._generator, device=self.device)
        return lo + (hi - lo) * u

    def _sample(self, coords: np.ndarray
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The augmented (raw, label) batch at ``coords`` (B, 4) host ints
        (volume, z, y, x)."""
        pd, ph, pw = self._patch
        raw = torch.stack([self._raws[v, z:z + pd, y:y + ph, x:x + pw]
                           for v, z, y, x in coords.tolist()]).float()
        label = torch.stack([self._labels[v, z:z + pd, y:y + ph, x:x + pw]
                             for v, z, y, x in coords.tolist()])
        b = raw.shape[0]
        for j, entry in enumerate(self._raw_cfg):
            name = entry["name"]
            if name == "RandomFlip":
                u = torch.rand((b, 3), generator=self._generator,
                               device=self.device)
                for axis in range(3):
                    do = u[:, axis] > float(entry.get("axis_prob", 0.5))
                    raw = _pick(do, raw.flip(axis + 1), raw)
                    label = _pick(do, label.flip(axis + 1), label)
            elif name == "RandomRotate90":
                k = torch.randint(0, 4, (b,), generator=self._generator,
                                  device=self.device)
                raw_k, label_k = raw, label
                for turns in range(1, 4):
                    raw_k = _pick(k == turns, torch.rot90(raw, turns, (2, 3)),
                                  raw_k)
                    label_k = _pick(k == turns,
                                    torch.rot90(label, turns, (2, 3)), label_k)
                raw, label = raw_k, label_k
            elif name == "Standardize" and j not in self._baked:
                eps = float(entry.get("eps", 1e-10))
                dims = (1, 2, 3) if entry.get("channelwise", False) else (
                    1, 2, 3, 4)
                sd, mu = torch.std_mean(raw, dim=dims, correction=0,
                                        keepdim=True)
                raw = (raw - mu) / sd.clamp_min(eps)
            elif name == "RandomContrast":
                lo, hi = entry.get("alpha", (0.5, 1.5))
                mean = float(entry.get("mean", 0.0))
                p = float(entry.get("execution_probability", 0.1))
                fire = self._uniform(b) < p
                alpha = self._uniform(b, lo, hi).reshape(b, 1, 1, 1, 1)
                adj = torch.clamp(mean + alpha * (raw - mean), -1, 1)
                raw = _pick(fire, adj, raw)
            elif name == "AdditiveGaussianNoise":
                lo, hi = entry.get("scale", (0.0, 1.0))
                p = float(entry.get("execution_probability", 0.1))
                fire = self._uniform(b) < p
                std = self._uniform(b, lo, hi).reshape(b, 1, 1, 1, 1)
                noise = torch.randn(raw.shape, generator=self._generator,
                                    device=self.device)
                raw = _pick(fire, raw + std * noise, raw)
            elif name == "AdditivePoissonNoise":
                lo, hi = entry.get("lam", (0.0, 1.0))
                p = float(entry.get("execution_probability", 0.1))
                fire = self._uniform(b) < p
                lam = self._uniform(b, lo, hi).reshape(b, 1, 1, 1, 1)
                noise = torch.poisson(lam.expand(raw.shape).contiguous(),
                                      generator=self._generator)
                raw = _pick(fire, raw + noise, raw)
        return raw.contiguous(), label.to(self._label_dtype).contiguous()

    # -- the loader surface ----------------------------------------------------

    def __len__(self) -> int:
        return max(self._n // self.batch_size, 1) if self._n else 0

    def close(self) -> None:  # the host loader's interface
        pass

    def epoch_batches(self, epoch: int) -> List[np.ndarray]:
        """The coordinate batches (B, 4) of ``epoch``: the host loader's
        shuffle rule, and a dataset smaller than one batch wrap-padded."""
        order = np.random.RandomState(self.seed + epoch).permutation(self._n)
        if self._n < self.batch_size:
            reps = -(-self.batch_size // self._n)
            return [self._coords[np.tile(order, reps)[:self.batch_size]]]
        return [self._coords[order[i * self.batch_size:
                                   (i + 1) * self.batch_size]]
                for i in range(self._n // self.batch_size)]

    def __iter__(self):
        batches = self.epoch_batches(self._epoch)
        self._epoch += 1
        for coords in batches:
            raw, label = self._sample(coords)
            yield raw, label, None

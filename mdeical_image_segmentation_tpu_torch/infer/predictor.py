"""Sliding-window prediction with overlap-averaged recomposition (the JAX
package's ``infer/predictor.py``).

Each batch of halo-padded patches goes through the model on the device,
padded at the tail to one fixed batch size; the halo is stripped, the
channel selected, and the patches are added into (D, H, W, C) float32 sum
and count maps with the overlap-add kernel (``ops/overlap.py``), the maps
staying on the device until the volume is done.  As in the JAX package, the
raw network output (logits) is averaged unless ``apply_activation``.

``_device_accumulate`` takes any iterable of ``(patches (B, D, H, W, C),
[index tuples])`` — ``data/volume_utils.padded_patch_batches`` makes one
from an in-memory volume.  ``__call__`` takes a test loader over an HDF5
dataset (``data/loaders.get_test_loaders``) and writes the averaged map
(or, with ``save_segmentation``, its argmax as uint16) gzip-compressed to
``<output_dir>/<name>_predictions.h5`` through the port's HDF5 codec
(``utils/hdf5.py``); with ``accumulate_on_device=False`` the patches are
summed on the host with uint8 counts, as the JAX package does.

``LazyPredictor`` is for volumes larger than RAM: as in the JAX package
its patches come back to the host (no overlap-add kernel) and are summed
into maps that live on disk (``np.memmap`` scratch files beside the output,
removed when the call ends), then normalized in the 27 slices of
``SliceBuilder._build_slices`` with patch = stride = shape // 3 (more where
an axis is not a multiple of 3: the tail slices overlap) and streamed into
a chunked gzip dataset of the output in slabs one chunk deep; with
``save_segmentation`` the file holds only ``segmentation`` (uint16 argmax).

``DSB2018Predictor`` predicts 2D images (``data/dsb.py``): one forward per
batch with the final activation, then each image's
``<name>_predictions.h5`` (``predictions``, and ``segmentation``: the
connected components of ``p > pmaps_thershold`` as uint16) written by a
pool of 8 threads (``dsb_save_batch``).

``quantize="int8"`` runs the W8A8 path (``ops/quant.py``), as the JAX
package does: the first ``calib_batches`` batches run the float forward
while they record each conv's activation absmax (their float output goes to
the overlap-add), the rest run the int8 convs with those scales.  The tail
batch is padded before either.  The scales live on the predictor
(``quant_scales``), outside the model's parameters.
"""

from __future__ import annotations

import contextlib
import os
import queue
import tempfile
import threading
import time
from concurrent import futures
from pathlib import Path
from typing import Any, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.slice_builder import SliceBuilder
from ..logging_utils import get_logger
from ..ops import quant
from ..ops.overlap import overlap_add_into
from ..ops.tta import flip_ensemble, mirror_combos
from ..transforms.skimage_compat import label as cc_label
from ..utils import hdf5

logger = get_logger("UNetPredictor")


def _get_output_file(dataset, suffix: str = "_predictions",
                     output_dir: Optional[str] = None) -> Path:
    """``<output_dir or the input's directory>/<name><suffix>.h5``."""
    input_dir, file_name = os.path.split(dataset.file_path)
    if output_dir is None:
        output_dir = input_dir
    return Path(output_dir) / (os.path.splitext(file_name)[0] + suffix
                               + ".h5")


def _unpad_channels_last(batch: torch.Tensor, halo) -> torch.Tensor:
    """Strip the spatial halo from (N, D, H, W, C) patches (a view)."""
    if halo is None or all(p == 0 for p in halo):
        return batch
    sl = (slice(None),) + tuple(slice(p, -p or None) for p in halo) + (
        slice(None),)
    return batch[sl]


class _AbstractPredictor:
    """The model's patch forward on ``device`` (default: the model's)."""

    def __init__(self, model: torch.nn.Module, output_dir: Optional[str],
                 out_channels: int, output_dataset: str = "predictions",
                 save_segmentation: bool = False,
                 prediction_channel: Optional[int] = None,
                 apply_activation: bool = False,
                 quantize: Optional[str] = None,
                 calib_batches: int = 1,
                 tta: Optional[str] = None, device=None, **kwargs):
        if kwargs:
            raise ValueError(
                f"unknown predictor config keys: {sorted(kwargs)}")
        if quantize not in (None, "int8"):
            raise ValueError(f"predictor quantize={quantize!r}: expected "
                             "'int8'")
        if tta not in (None, "mirror", "mirror-hw"):
            raise ValueError(f"predictor tta={tta!r}: expected 'mirror' or "
                             "'mirror-hw'")
        self.model = model
        self.output_dir = output_dir
        self.out_channels = out_channels
        self.output_dataset = output_dataset
        self.save_segmentation = save_segmentation
        self.prediction_channel = prediction_channel
        self.apply_activation = apply_activation
        self.quantize = quantize
        self.calib_batches = max(1, int(calib_batches))
        self.quant_scales: Dict[str, torch.Tensor] = {}
        self._calib_seen = 0
        self.tta = tta
        self.device = torch.device(
            device if device is not None
            else next(model.parameters()).device)
        self._forward = None
        self._batch_size: Optional[int] = None

    def _compile_forward(self, batch_size: int) -> None:
        """Fix the batch size and build the patch forward (TTA ensemble and
        activation included).  PyTorch runs eagerly: nothing is traced."""
        model = self.model
        # a 2D model sees (N, H, W, C), the depth axis of its patches
        # squeezed; (N, D, H, W, C) otherwise, where 'mirror-hw' skips depth
        is2d = not getattr(model, "is3d", True)
        if self.tta is None:
            combos = None
        elif is2d:
            combos = mirror_combos((1, 2))
        else:
            combos = mirror_combos((2, 3) if self.tta == "mirror-hw"
                                   else (1, 2, 3))
        act = model.final_activation() if self.apply_activation else None

        def forward(x: torch.Tensor) -> torch.Tensor:
            with torch.inference_mode():
                if is2d:
                    x = x.squeeze(1)
                out = (model(x) if combos is None
                       else flip_ensemble(model, combos, x))
                if is2d:
                    out = out.unsqueeze(1)
                return act(out) if act is not None else out

        self._forward = forward
        self._batch_size = batch_size

    def _predict_batch_device(self, input) -> Tuple[torch.Tensor, int]:
        """Forward with tail padding to the one fixed batch size; returns
        ``(device output, n_valid)`` without fetching it."""
        n = input.shape[0]
        if self._forward is None:
            self._compile_forward(n)
        x = torch.as_tensor(input).to(self.device)
        if n < self._batch_size:
            pad = x[-1:].expand(self._batch_size - n, *x.shape[1:])
            x = torch.cat([x, pad], dim=0)
        if self.quantize is None:
            return self._forward(x), n
        calib = self._calib_seen < self.calib_batches
        with quant.quant_mode("calib" if calib else "int8",
                              self.quant_scales, self.model):
            out = self._forward(x)
        self._calib_seen += calib
        return out, n

    def _predict_batch(self, input) -> np.ndarray:
        """The host variant: the batch's output fetched, padded rows
        dropped."""
        out, n = self._predict_batch_device(input)
        return out.cpu().numpy()[:n]


class StandardPredictor(_AbstractPredictor):
    """In-memory overlap-averaging predictor."""

    def __init__(self, *args, accumulate_on_device: bool = True, **kwargs):
        super().__init__(*args, **kwargs)
        self.accumulate_on_device = accumulate_on_device

    def _prefetch_batches(self, test_loader: Iterable, depth: int = 2):
        """Iterate ``(input, indices)`` with the host assembly of the next
        batch running one ahead in a worker thread."""
        q: "queue.Queue" = queue.Queue(maxsize=depth)
        stop = object()

        def producer():
            try:
                for input, indices in test_loader:
                    q.put((torch.as_tensor(np.asarray(input)), indices))
                q.put(stop)
            except BaseException as exc:  # noqa: BLE001 - re-raised below
                q.put(exc)

        threading.Thread(target=producer, daemon=True).start()
        while True:
            item = q.get()
            if item is stop:
                return
            if isinstance(item, BaseException):
                raise item
            yield item

    def _device_accumulate(self, test_loader: Iterable,
                           volume_shape: Sequence[int],
                           patch_halo: Optional[Sequence[int]],
                           ) -> Tuple[np.ndarray, np.ndarray]:
        """Stream batches through forward + overlap-add on the device;
        returns the (C, D, H, W) numpy sum and count maps."""
        pc = self.prediction_channel
        n_ch = 1 if pc is not None else self.out_channels
        shape = (*tuple(volume_shape), n_ch)
        acc = torch.zeros(shape, dtype=torch.float32, device=self.device)
        cnt = torch.zeros(shape, dtype=torch.float32, device=self.device)
        batch_size = None
        for input, indices in self._prefetch_batches(test_loader):
            if batch_size is None:
                batch_size = input.shape[0]
            out, n = self._predict_batch_device(input)
            pred = _unpad_channels_last(out, patch_halo)
            if pc is not None:
                pred = pred[..., pc:pc + 1]
            starts = np.array([[i[0].start, i[1].start, i[2].start]
                               for i in indices], np.int32)
            valid = np.ones((n,), np.float32)
            if n < batch_size:  # pad the metadata to the fixed batch
                pad = batch_size - n
                starts = np.concatenate(
                    [starts, np.repeat(starts[-1:], pad, axis=0)])
                valid = np.concatenate([valid, np.zeros((pad,), np.float32)])
            # the halo-stripped view is read in place, no copy
            overlap_add_into(acc, cnt, pred, starts, valid)
        return (np.moveaxis(acc.cpu().numpy(), -1, 0),
                np.moveaxis(cnt.cpu().numpy(), -1, 0))

    def __call__(self, test_loader) -> Path:
        """Predict the loader's volume and write it; returns the file."""
        dataset = test_loader.dataset
        logger.info(f"Processing '{dataset.file_path}'...")
        start = time.perf_counter()
        logger.info(f"Running inference on {len(test_loader)} batches")
        volume_shape = tuple(dataset.volume_shape())
        n_ch = 1 if self.prediction_channel is not None else self.out_channels
        output_file = _get_output_file(dataset, output_dir=self.output_dir)
        os.makedirs(os.path.dirname(str(output_file)) or ".", exist_ok=True)
        patch_halo = dataset.halo_shape
        if self.accumulate_on_device and type(self) is StandardPredictor:
            maps = self._device_accumulate(test_loader, volume_shape,
                                           patch_halo)
            self._finish(start, output_file, *maps)
            return output_file
        with self._prediction_maps((n_ch,) + volume_shape,
                                   output_file) as maps:
            prediction_map, normalization_mask = maps
            for input, indices in test_loader:
                prediction = _unpad_channels_last(
                    self._predict_batch(np.asarray(input)), patch_halo)
                prediction = np.moveaxis(prediction, -1, 1)  # (N, C, D, H, W)
                for pred, index in zip(prediction, indices):
                    if self.prediction_channel is not None:
                        pred = pred[self.prediction_channel:
                                    self.prediction_channel + 1]
                    index = (slice(0, n_ch),) + tuple(index)
                    prediction_map[index] += pred
                    normalization_mask[index] += 1
            self._finish(start, output_file, *maps)
        return output_file

    def _finish(self, start: float, output_file: Path, prediction_map,
                normalization_mask) -> None:
        logger.info(f"Finished inference in "
                    f"{time.perf_counter() - start:.2f} seconds")
        what = ("segmentation" if self.save_segmentation
                else "probability maps")
        logger.info(f"Saving {what} to: {output_file}")
        with hdf5.File(output_file, "w") as h5_output_file:
            self._save_results(prediction_map, normalization_mask,
                               h5_output_file)

    @contextlib.contextmanager
    def _prediction_maps(self, output_shape, output_file: Path):
        """The float32 sum and uint8 count maps the host loop adds into."""
        yield (np.zeros(output_shape, dtype="float32"),
               np.zeros(output_shape, dtype="uint8"))

    def _save_results(self, prediction_map, normalization_mask,
                      output_file) -> None:
        result = prediction_map / normalization_mask
        if self.save_segmentation:
            result = np.argmax(result, axis=0).astype("uint16")
        output_file.create_dataset(self.output_dataset, data=result,
                                   compression="gzip")


class LazyPredictor(StandardPredictor):
    """Maps on disk, normalized in 27 slices and streamed into the output,
    for volumes larger than RAM."""

    @contextlib.contextmanager
    def _prediction_maps(self, output_shape, output_file: Path):
        """Zero-filled ``np.memmap`` files in a scratch directory beside
        the output, removed when the call ends."""
        with tempfile.TemporaryDirectory(
                dir=os.path.dirname(str(output_file)) or ".",
                prefix=f".{output_file.stem}.maps.") as scratch:
            yield (np.memmap(os.path.join(scratch, "sum"), dtype="float32",
                             mode="w+", shape=output_shape),
                   np.memmap(os.path.join(scratch, "count"), dtype="uint8",
                             mode="w+", shape=output_shape))

    def _save_results(self, prediction_map, normalization_mask,
                      output_file) -> None:
        z, y, x = prediction_map.shape[1:]
        patch_shape = (z // 3, y // 3, x // 3)
        # the slices of the last row overlap the ones before when an axis
        # is not a multiple of 3; a count set to 1 makes the second pass
        # over a voxel divide by 1
        for index in SliceBuilder._build_slices(
                prediction_map, patch_shape=patch_shape,
                stride_shape=patch_shape):
            logger.info(f"Normalizing slice: {index}")
            prediction_map[index] /= normalization_mask[index]
            normalization_mask[index] = 1
        if self.save_segmentation:
            out = output_file.create_dataset(
                "segmentation", shape=(z, y, x), dtype="uint16", chunks=True,
                compression="gzip")
        else:
            out = output_file.create_dataset(
                self.output_dataset, shape=prediction_map.shape,
                dtype="float32", chunks=True, compression="gzip")
        # streamed in slabs one chunk deep, so that each chunk is encoded
        # once and one slab is in memory at a time
        depth = out.chunks[-3]
        for z0 in range(0, z, depth):
            slab = prediction_map[:, z0:z0 + depth]
            out[..., z0:z0 + depth, :, :] = (
                np.argmax(slab, axis=0).astype("uint16")
                if self.save_segmentation else slab)


def dsb_save_batch(output_dir: Optional[str], path, pred,
                   save_segmentation: bool = True,
                   pmaps_thershold: float = 0.5) -> list:
    """Write each image's prediction (and the connected components of its
    ``p > pmaps_thershold`` as uint16) to ``<name>_predictions.h5``;
    returns the files written."""
    written = []
    for single_pred, single_path in zip(pred, path):
        logger.info(f"Processing {single_path}")
        single_pred = np.squeeze(np.asarray(single_pred))
        out_file = os.path.splitext(single_path)[0] + "_predictions.h5"
        if output_dir is not None:
            out_file = os.path.join(output_dir, os.path.split(out_file)[1])
        with hdf5.File(out_file, "w") as f:
            f.create_dataset("predictions", data=single_pred,
                             compression="gzip")
            if save_segmentation:
                f.create_dataset(
                    "segmentation", compression="gzip",
                    data=cc_label(single_pred > pmaps_thershold).astype(
                        "uint16"))
        written.append(out_file)
    return written


class DSB2018Predictor(_AbstractPredictor):
    """Per-image 2D predictions, written by a pool of 8 threads."""

    def __init__(self, model, output_dir, out_channels=1,
                 save_segmentation=True, pmaps_thershold=0.5, **kwargs):
        super().__init__(model, output_dir, out_channels, **kwargs)
        # this predictor runs its own forward: these options would be
        # ignored silently
        if self.tta is not None:
            raise ValueError("tta is not supported by DSB2018Predictor")
        if self.quantize is not None:
            raise ValueError("quantize is not supported by "
                             "DSB2018Predictor")
        self.pmaps_threshold = pmaps_thershold
        self.save_segmentation = save_segmentation

    def __call__(self, test_loader) -> list:
        """Predict every batch of (images, paths); returns the files
        written."""
        act = self.model.final_activation()
        pending = []
        with futures.ThreadPoolExecutor(max_workers=8) as executor:
            for img, path in test_loader:
                x = torch.as_tensor(np.asarray(img)).to(self.device)
                if x.ndim == 5 and x.shape[1] == 1:
                    # DSB pipelines give (N, Z=1, H, W, C); 2D models take
                    # NHWC
                    x = x.squeeze(1)
                with torch.inference_mode():
                    out = self.model(x)
                    if act is not None:
                        out = act(out)
                pending.append(executor.submit(
                    dsb_save_batch, self.output_dir, path, out.cpu().numpy(),
                    self.save_segmentation, self.pmaps_threshold))
            logger.info("Waiting for all predictions to be saved to disk...")
        # a worker's exception surfaces here
        return [f for p in pending for f in p.result()]


PREDICTORS: Dict[str, Any] = {
    "StandardPredictor": StandardPredictor,
    "LazyPredictor": LazyPredictor,
    "DSB2018Predictor": DSB2018Predictor,
}


def get_predictor(model: torch.nn.Module, output_dir: Optional[str],
                  config: Dict[str, Any], *, device=None):
    """Build a predictor from ``config['predictor']`` (name + kwargs)."""
    predictor_config = dict(config.get("predictor", {}))
    cls_name = predictor_config.pop("name", "StandardPredictor")
    if cls_name not in PREDICTORS:
        raise KeyError(f"unknown predictor {cls_name!r}: one of "
                       f"{sorted(PREDICTORS)}")
    out_channels = config["model"].get("out_channels")
    return PREDICTORS[cls_name](model, output_dir, out_channels,
                                device=device, **predictor_config)

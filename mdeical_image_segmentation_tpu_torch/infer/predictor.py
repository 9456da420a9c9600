"""Sliding-window prediction with overlap-averaged recomposition (the JAX
package's ``infer/predictor.py``; the StandardPredictor's on-device chain).

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
summed on the host with uint8 counts, as the JAX package does.  Not ported
yet: the Lazy and DSB predictors (ROADMAP.md queue 1, item 20).

``quantize="int8"`` runs the W8A8 path (``ops/quant.py``), as the JAX
package does: the first ``calib_batches`` batches run the float forward
while they record each conv's activation absmax (their float output goes to
the overlap-add), the rest run the int8 convs with those scales.  The tail
batch is padded before either.  The scales live on the predictor
(``quant_scales``), outside the model's parameters.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from pathlib import Path
from typing import Any, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..logging_utils import get_logger
from ..ops import quant
from ..ops.overlap import overlap_add_into
from ..ops.tta import flip_ensemble, mirror_combos
from ..utils import hdf5

logger = get_logger("UNetPredictor")

PREDICT_ITEM = ("ROADMAP.md queue 1, item 20 (LazyPredictor and "
                "DSB2018Predictor)")


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


class StandardPredictor:
    """In-memory overlap-averaging predictor on ``device`` (default: the
    model's)."""

    def __init__(self, model: torch.nn.Module, output_dir: Optional[str],
                 out_channels: int, output_dataset: str = "predictions",
                 save_segmentation: bool = False,
                 prediction_channel: Optional[int] = None,
                 apply_activation: bool = False,
                 quantize: Optional[str] = None,
                 calib_batches: int = 1,
                 tta: Optional[str] = None,
                 accumulate_on_device: bool = True, device=None, **kwargs):
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
        self.accumulate_on_device = accumulate_on_device
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
        if self.accumulate_on_device:
            prediction_map, normalization_mask = self._device_accumulate(
                test_loader, volume_shape, patch_halo)
        else:
            prediction_map, normalization_mask = (
                self._allocate_prediction_maps((n_ch,) + volume_shape))
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
        logger.info(f"Finished inference in "
                    f"{time.perf_counter() - start:.2f} seconds")
        what = ("segmentation" if self.save_segmentation
                else "probability maps")
        logger.info(f"Saving {what} to: {output_file}")
        with hdf5.File(output_file, "w") as h5_output_file:
            self._save_results(prediction_map, normalization_mask,
                               h5_output_file)
        return output_file

    def _allocate_prediction_maps(self, output_shape):
        return (np.zeros(output_shape, dtype="float32"),
                np.zeros(output_shape, dtype="uint8"))

    def _save_results(self, prediction_map, normalization_mask,
                      output_file) -> None:
        result = prediction_map / normalization_mask
        if self.save_segmentation:
            result = np.argmax(result, axis=0).astype("uint16")
        output_file.create_dataset(self.output_dataset, data=result,
                                   compression="gzip")


PREDICTORS: Dict[str, Any] = {"StandardPredictor": StandardPredictor}


def get_predictor(model: torch.nn.Module, output_dir: Optional[str],
                  config: Dict[str, Any], *, device=None):
    """Build a predictor from ``config['predictor']`` (name + kwargs)."""
    predictor_config = dict(config.get("predictor", {}))
    cls_name = predictor_config.pop("name", "StandardPredictor")
    if cls_name not in PREDICTORS:
        raise NotImplementedError(f"predictor {cls_name!r}: {PREDICT_ITEM}")
    out_channels = config["model"].get("out_channels")
    return PREDICTORS[cls_name](model, output_dir, out_channels,
                                device=device, **predictor_config)

"""Segmentation serving: HTTP endpoint → batched GPU inference (the JAX
package's ``serve/app.py``).

- ``ModelRegistry``: named models, each with a forward specialized to its
  input resolution and device: 2D bundles, 3D checkpoints, exported
  artifacts (``export.py``) and promptable SAM-Med2D bundles;
- ``BatchingInferenceEngine``: a background worker per model that coalesces
  concurrent requests into one device batch (up to ``max_batch``, waiting at
  most ``max_wait_ms``), pads it to a power of two, and keeps one batch in
  flight while it collects the next;
- ``SegmentationServer``: a stdlib ThreadingHTTPServer exposing
    POST /            {"image_path", "model"?,
                       "return"?: "path"|"mask"|"png",
                       promptable models: "points"?: [[x, y], ...],
                       "point_labels"?: [1|0, ...], "box"?: [[x1, y1],
                       [x2, y2]], in the original image's pixels}
                      → {"response": <mask path, nested list, or base64 PNG
                         of the raw label mask>, "status", "time"}
    GET  /models      registered model names
    GET  /stats       request count + latency percentiles (p50/p90/p99)
    GET  /health      liveness

Images are decoded by the port's own readers (``utils/image.py``: PNG,
TIFF, GIF, BMP and JPEG, as PIL's ``Image.open(p).convert(mode)`` gives
them); a file they refuse (arithmetic-coded or CMYK JPEG among them) is
answered with a 400.
"""

from __future__ import annotations

import base64
import json
import os
import queue
import tempfile
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..data.png2d import nearest_resize
from ..logging_utils import get_logger
from ..models.wrappers import _checked_device
from ..ops import quant
from ..utils import image as image_io
from ..utils import png
from ..utils.image import ImageError

logger = get_logger("serve")


@dataclass
class ModelEntry:
    name: str
    # forward(uint8 images (N,H,W,C) in [0,255]) -> uint8 label masks
    # (N,H,W): the /255 and the threshold/argmax run on the device.
    # Promptable models (kind="promptable") take (images, points, labels
    # [, boxes]).
    forward: Callable[..., np.ndarray]
    in_channels: int
    resolution: int
    kind: str = "dense"
    max_points: int = 8
    # Optional split of forward for the pipelined engine: ``dispatch``
    # enqueues the device work and returns a handle WITHOUT waiting for it,
    # ``fetch(handle)`` waits and returns the host result.  When both are
    # set, the engine overlaps batch k's device execution with batch k+1's
    # host decode/stack/H2D.  Plain-numpy test doubles leave them None and
    # get the serial path.
    dispatch: Optional[Callable[..., Any]] = None
    fetch: Optional[Callable[[Any], np.ndarray]] = None
    # Non-blocking readiness probe on a dispatch handle (a CUDA event's
    # query() for registry entries).  Lets the "fill" drain policy keep
    # coalescing batch k+1 while batch k still executes.
    ready: Optional[Callable[[Any], bool]] = None
    n_classes: int = 2  # fixed class count: maps labels to grey levels
    # Float-contract probe: float images in [0,1] → float probabilities.
    # Not used by the HTTP engine; exists for tests and fidelity checks.
    probs_forward: Optional[Callable[..., np.ndarray]] = None
    # int8 PTQ serving: the activation scales the first request batches
    # calibrate ({conv path: absmax}, filled in place); None when float
    quant_scales: Optional[Dict[str, torch.Tensor]] = None


def _to_device(x: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def _handle(out: torch.Tensor, device: torch.device):
    """A dispatch handle: the result and, on CUDA, an event recorded after
    the work that produces it."""
    event = None
    if device.type == "cuda":
        event = torch.cuda.Event()
        event.record()
    return out, event


def _fetch(handle) -> np.ndarray:
    out, event = handle
    if event is not None:
        event.synchronize()
    return out.cpu().numpy()


def _ready(handle) -> bool:
    event = handle[1]
    return event is None or bool(event.query())


class ModelRegistry:
    def __init__(self):
        self._models: Dict[str, ModelEntry] = {}
        self.default: Optional[str] = None

    def register(self, entry: ModelEntry, default: bool = False):
        self._models[entry.name] = entry
        if default or self.default is None:
            self.default = entry.name
        logger.info(f"registered model {entry.name!r} (default={self.default})")

    def register_unet2d(self, name: str, path: str, *, threshold: float = 0.5,
                        resolution: int = 512, default: bool = False,
                        quantize: Optional[str] = None, calib_batches: int = 1,
                        tta: bool = False,
                        device: Union[str, torch.device] = "cuda",
                        max_batch: int = 8):
        """Load a 2D bundle saved by either package's ``save_pretrained`` and
        serve it on ``device``.

        ``tta=True`` serves a mirror flip ensemble (4 passes over H/W,
        averaged before the final activation).  Every ``unet_type`` serves
        its head 1; a ``*_CGM`` model's output is a probability already and
        is served as it is, the others' logits through a sigmoid (softmax
        for more than one class).

        ``quantize='int8'`` serves through the W8A8 conv path
        (``ops/quant.py``): the first ``calib_batches`` dispatched request
        batches run the float forward while they record the activation
        scales, later ones the int8 convs (safe: each model has one engine
        worker thread).  The conv weights stay float32 and are quantized from
        them, as the JAX package quantizes its float32 parameters; the TTA
        ensemble composes (calibration sees every flip).

        On CUDA this builds the kernels and runs one warm-up forward for each
        power-of-two batch up to ``max_batch``, on the calling thread, before
        the model is registered — so no request pays for a build or a first
        launch.  Under int8 the warm-up runs the float forward and the int8
        forward on scales of its own, thrown away: the served scales come
        from the first real batches only."""
        from ..models import UNetModel
        from ..ops.tta import flip_ensemble, mirror_combos

        if quantize not in (None, "int8"):
            raise ValueError(f"quantize={quantize!r}: expected 'int8'")
        device = _checked_device(device)
        model = UNetModel.from_pretrained(path, device=device)
        if quantize is None:
            # the serving copy: weights cast once to the compute dtype
            model.for_inference()
        else:
            model.requires_grad_(False)
        combos = mirror_combos((1, 2)) if tta else [[]]
        out_channels = model.config.out_channels
        is_prob = model.config.unet_type.endswith("CGM")

        def float_probs(x):
            logits = flip_ensemble(lambda xx: model(xx).logits, combos, x)
            if is_prob:
                return logits
            if out_channels > 1:
                return torch.softmax(logits, dim=-1)
            return torch.sigmoid(logits)

        probs, warm = float_probs, None
        if quantize == "int8":
            state = {"seen": 0, "scales": {}}
            n_calib = max(1, int(calib_batches))

            def probs(x):
                calib = state["seen"] < n_calib
                with quant.quant_mode("calib" if calib else "int8",
                                      state["scales"], model):
                    p = float_probs(x)
                state["seen"] += calib
                return p

            def warm(x):
                float_probs(x)
                scratch: dict = {}
                for m in ("calib", "int8"):
                    with quant.quant_mode(m, scratch, model):
                        float_probs(x)

        self._register_probs(name, probs, model.config.in_channels,
                             out_channels, resolution=resolution,
                             threshold=threshold, device=device,
                             max_batch=max_batch, default=default,
                             float_probs=float_probs, warm=warm,
                             quant_scales=state["scales"] if quantize
                             else None)

    def _register_probs(self, name: str, probs: Callable, in_channels: int,
                        out_channels: int, *, resolution: int,
                        threshold: float, device: torch.device,
                        max_batch: int, default: bool,
                        float_probs: Optional[Callable] = None,
                        warm: Optional[Callable] = None,
                        quant_scales: Optional[dict] = None) -> None:
        """Register ``probs`` (float images (N, H, W, C) in [0, 1] on the
        device → probabilities (N, H, W, out)) behind the uint8-in,
        mask-out engine contract.  On CUDA this builds the kernels and runs
        one warm-up forward for each power-of-two batch up to
        ``max_batch`` first: through ``warm`` when given (called on the
        float images; what it returns is dropped), else the served forward.
        ``float_probs`` (``probs`` by default) backs the entry's float
        probe."""
        float_probs = float_probs or probs
        from ..ops import _build

        if out_channels > 1:
            def mask_head(p):
                return torch.argmax(p, dim=-1).to(torch.uint8)
        else:
            thr = float(threshold)

            def mask_head(p):
                return (p[..., 0] > thr).to(torch.uint8)

        def dispatch(x: np.ndarray):
            # enqueue only: uint8 in, /255 and threshold/argmax on device,
            # an event recorded after the forward marks completion
            with torch.inference_mode():
                x = _to_device(x, device).float() / 255.0
                return _handle(mask_head(probs(x)), device)

        def np_forward(x):
            return _fetch(dispatch(x))

        def np_probs(x):
            with torch.inference_mode():
                x = _to_device(x, device).float()
                return float_probs(x).cpu().numpy()

        if device.type == "cuda":
            _build.load()
        b = 1
        while b <= max_batch:
            zeros = np.zeros((b, resolution, resolution, in_channels),
                             np.uint8)
            if warm is None:
                np_forward(zeros)
            else:
                with torch.inference_mode():
                    warm(_to_device(zeros, device).float() / 255.0)
            b *= 2
        if device.type == "cuda":
            torch.cuda.synchronize(device)

        self.register(
            ModelEntry(
                name=name,
                forward=np_forward,
                in_channels=in_channels,
                resolution=resolution,
                dispatch=dispatch,
                fetch=_fetch,
                n_classes=max(int(out_channels), 2),
                probs_forward=np_probs,
                ready=_ready,
                quant_scales=quant_scales,
            ),
            default=default,
        )

    def register_exported(self, name: str, path: str, *,
                          threshold: float = 0.5, default: bool = False,
                          device: Union[str, torch.device] = "cuda",
                          max_batch: int = 8):
        """Serve an artifact of ``export.export_bundle`` on ``device`` (the
        one it was traced on): no model code or checkpoint plumbing, the
        program holds its parameters.  2D artifacts only (3D volumes go
        through the predictor), emitting probabilities (``output:
        probs``: the engine thresholds them), with the symbolic batch (the
        engine's batches vary) and a square input (the HTTP resize
        contract).  Warms every power-of-two batch up to ``max_batch``
        before it registers, as ``register_unet2d`` does."""
        from ..export import load_exported

        device = _checked_device(device)
        model = load_exported(path, device=device)
        meta = model.meta
        if meta.get("kind") != "2d":
            raise ValueError(
                f"{path}: kind={meta.get('kind')!r} — only 2D artifacts "
                "serve over HTTP (use the sliding-window predictor for 3D)"
            )
        if meta.get("output") != "probs":
            raise ValueError(
                f"{path}: output={meta.get('output')!r} — serving needs a "
                "probability-emitting artifact (export without --logits)"
            )
        if meta["input_shape"][0] != "b":
            raise ValueError(
                f"{path}: batch pinned to {meta['input_shape'][0]} — the "
                "engine coalesces variable batches; export with the "
                "default symbolic batch"
            )
        h, w = meta["input_shape"][1], meta["input_shape"][2]
        if h != w:
            raise ValueError(
                f"{path}: non-square input {h}x{w} — the HTTP resize "
                "contract is square resolutions"
            )
        self._register_probs(name, model.module, model.in_channels,
                             model.out_channels, resolution=int(h),
                             threshold=threshold, device=device,
                             max_batch=max_batch, default=default)

    def register_unet3d(self, name: str, path: str,
                        model_config: Dict[str, Any], *,
                        threshold: float = 0.5, resolution: int = 256,
                        default: bool = False,
                        device: Union[str, torch.device] = "cuda",
                        max_batch: int = 8):
        """Load a 3D-family model (``model_config`` is a config's ``model``
        section, any member and dtype; BatchNorm statistics come from the
        checkpoint's ``batch_stats``) from a training checkpoint of either
        package and serve single 2D slices on ``device``: a 3D model sees
        each slice replicated to the least depth that survives its
        (num_levels - 1) poolings, ``2**(num_levels - 1)``, and the middle
        output slice is returned (pseudo-3D slice serving); a 2D member
        takes the slice as it is.  Builds the kernels and warms every
        power-of-two batch up to ``max_batch`` before it registers."""
        from ..models import get_model
        from ..train import load_checkpoint
        from ..utils.param_bridge import flax_to_state_dict

        device = _checked_device(device)
        model = get_model(model_config, device=device)
        model.load_state_dict(flax_to_state_dict(
            load_checkpoint(path)["model_state_dict"]))
        model.eval()
        act = model.final_activation()
        depth = 2 ** (max(int(model.num_levels), 1) - 1)

        def probs(x):
            if not model.is3d:  # UNet2D / ResidualUNet2D take the slice
                out = model(x.contiguous())
            else:
                x3 = x[:, None].expand(-1, depth, -1, -1, -1)
                out = model(x3.contiguous())[:, depth // 2]
            return act(out) if act is not None else out

        self._register_probs(name, probs, model.in_channels,
                             model.out_channels, resolution=resolution,
                             threshold=threshold, device=device,
                             max_batch=max_batch, default=default)

    def register_sam(self, name: str, path: str, *, threshold: float = 0.5,
                     max_points: int = 8, default: bool = False,
                     device: Union[str, torch.device] = "cuda",
                     max_batch: int = 8):
        """Serve a promptable bundle of ``models.sam.save_sam`` (either
        package's) on ``device``.  A request batch is (uint8 images, points
        (N, max_points, 2), labels (N, max_points) [, boxes (N, 2, 2)]);
        on the device: /255, the forward's primary low-res mask, a
        bilinear upsample to ``img_size`` (``ops/image.py``), sigmoid and
        threshold.  Batches with and without a box are separate programs
        and queue apart.  Warms both for every power-of-two batch up to
        ``max_batch`` before it registers."""
        from ..models.sam import load_sam
        from ..ops.image import resize_bilinear

        device = _checked_device(device)
        model = load_sam(path, device=device).requires_grad_(False)
        res = model.img_size
        thr = float(threshold)

        def probs(img, pts, lbl, box=None):
            masks, _ = model(img, pts, lbl, box)
            up = resize_bilinear(masks.permute(0, 2, 3, 1), (res, res))
            return torch.sigmoid(up[..., 0])

        def dispatch(*xs: np.ndarray):
            with torch.inference_mode():
                img, *prompts = (_to_device(a, device) for a in xs)
                p = probs(img.float() / 255.0, *prompts)
                return _handle((p > thr).to(torch.uint8), device)

        def np_forward(*xs):
            return _fetch(dispatch(*xs))

        def np_probs(img, *prompts):
            """float images in [0, 1] and prompts → (N, res, res)
            probabilities."""
            with torch.inference_mode():
                return probs(*(_to_device(a, device) for a in
                               (np.asarray(img, np.float32), *prompts))
                             ).cpu().numpy()

        if device.type == "cuda":
            from ..ops import _build

            _build.load()
        b = 1
        while b <= max_batch:
            img = np.zeros((b, res, res, model.in_channels), np.uint8)
            pts = np.zeros((b, max_points, 2), np.float32)
            lbl = np.ones((b, max_points), np.int32)
            np_forward(img, pts, lbl)
            np_forward(img, pts, lbl, np.zeros((b, 2, 2), np.float32))
            b *= 2

        self.register(
            ModelEntry(
                name=name, forward=np_forward, in_channels=model.in_channels,
                resolution=res, kind="promptable", max_points=max_points,
                dispatch=dispatch, fetch=_fetch, ready=_ready, n_classes=2,
                probs_forward=np_probs,
            ),
            default=default,
        )

    def get(self, name: Optional[str]) -> ModelEntry:
        if name is None:
            name = self.default
        if name not in self._models:
            raise KeyError(
                f"unknown model {name!r}; registered: {sorted(self._models)}"
            )
        return self._models[name]

    def names(self) -> List[str]:
        return sorted(self._models)


@dataclass
class _Request:
    payload: tuple  # per-sample arrays, stacked per position across the batch
    event: threading.Event = field(default_factory=threading.Event)
    result: Optional[np.ndarray] = None
    error: Optional[str] = None


class BatchingInferenceEngine:
    """Coalesce concurrent requests per model into device batches."""

    def __init__(self, registry: ModelRegistry, max_batch: int = 8,
                 max_wait_ms: float = 5.0, pad_to_pow2: bool = True,
                 drain_policy: str = "eager",
                 pipeline_fill_cap_ms: float = 60.0):
        self.registry = registry
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1e3
        # Drain policy while a pipelined batch is in flight (entries with a
        # ``ready`` probe):
        #   "eager": collect for max_wait_ms and dispatch;
        #   "fill":  keep coalescing until the in-flight batch's result is
        #            ready (or max_batch / pipeline_fill_cap_ms) — the
        #            device execution hides the wait.
        if drain_policy not in ("eager", "fill"):
            raise ValueError(f"drain_policy={drain_policy!r}: "
                             "expected 'eager' or 'fill'")
        self.drain_policy = drain_policy
        self.pipeline_fill_cap = pipeline_fill_cap_ms / 1e3
        # Pad coalesced batches up to the next power of two (repeating the
        # last sample) so the forward sees only ⌈log2(max_batch)⌉+1 batch
        # shapes — the shapes register_unet2d warmed up.
        self.pad_to_pow2 = pad_to_pow2
        self._queues: Dict[Any, "queue.Queue[_Request]"] = {}
        self._lock = threading.Lock()
        self._running = True
        # batch-occupancy accounting: model → [device batches, requests]
        self._occupancy: Dict[str, List[int]] = {}

    def _queue_for(self, key, model_name: str) -> "queue.Queue[_Request]":
        # one worker per (model, payload arity)
        with self._lock:
            if key not in self._queues:
                q: "queue.Queue[_Request]" = queue.Queue()
                self._queues[key] = q
                threading.Thread(
                    target=self._worker, args=(model_name, q), daemon=True
                ).start()
            return self._queues[key]

    def _worker(self, model_name: str, q: "queue.Queue[_Request]"):
        entry = self.registry.get(model_name)
        # Two-stage pipeline: with a non-blocking ``dispatch`` + blocking
        # ``fetch``, the worker keeps ONE batch in flight on the device and
        # only syncs its results after the NEXT batch has been collected and
        # dispatched.  A lone request is finalized immediately (queue empty
        # → zero added latency).
        pipelined = entry.dispatch is not None and entry.fetch is not None
        pending: Optional[Tuple[List[_Request], int, Any]] = None

        def finalize(p):
            reqs, n, handle = p
            try:
                probs = entry.fetch(handle)
                for r, pr in zip(reqs, probs[:n]):
                    r.result = pr
            except Exception as e:  # surfaced per request
                logger.error(f"fetch failed: {e}", exc_info=True)
                for r in reqs:
                    r.error = f"{type(e).__name__}: {e}"
            for r in reqs:
                r.event.set()

        while self._running:
            try:
                # with a batch in flight, don't sleep: either more work is
                # already queued (collect + dispatch it first) or we sync
                # the in-flight batch right away
                first = q.get(timeout=0.0 if pending is not None else 0.5)
            except queue.Empty:
                if pending is not None:
                    finalize(pending)
                    pending = None
                continue
            batch = [first]
            # "fill" drain: with a batch in flight and a readiness probe,
            # coalescing is free until the device finishes — poll the probe
            # between short queue waits and dispatch when the batch is full
            # or the cap expires.  When the probe flips, degrade to one
            # eager-style max_wait window rather than dispatching at once
            # (an instant dispatch fragments into size-1 batches).
            fill = (self.drain_policy == "fill" and pending is not None
                    and entry.ready is not None)
            deadline = time.monotonic() + (
                self.pipeline_fill_cap if fill else self.max_wait)
            while len(batch) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                if fill:
                    probe_ready = True  # un-probeable handle → eager
                    try:
                        probe_ready = bool(entry.ready(pending[2]))
                    except RuntimeError:
                        pass
                    if probe_ready:
                        fill = False
                        deadline = min(
                            deadline, time.monotonic() + self.max_wait)
                        continue
                    try:
                        batch.append(q.get(timeout=min(remaining, 0.002)))
                    except queue.Empty:
                        continue  # device still busy: keep coalescing
                else:
                    try:
                        batch.append(q.get(timeout=remaining))
                    except queue.Empty:
                        break
            with self._lock:
                occ = self._occupancy.setdefault(model_name, [0, 0])
                occ[0] += 1
                occ[1] += len(batch)
            try:
                arity = len(batch[0].payload)
                stacked = [
                    np.stack([r.payload[i] for r in batch], axis=0)
                    for i in range(arity)
                ]
                n = len(batch)
                if self.pad_to_pow2 and n & (n - 1):
                    pad = (1 << (n - 1).bit_length()) - n
                    stacked = [
                        np.concatenate(
                            [s, np.repeat(s[-1:], pad, axis=0)], axis=0
                        )
                        for s in stacked
                    ]
                if pipelined:
                    handle = entry.dispatch(*stacked)
                    if pending is not None:
                        finalize(pending)
                    pending = (batch, n, handle)
                    continue
                probs = entry.forward(*stacked)
                for r, p in zip(batch, probs[:n]):
                    r.result = p
            except Exception as e:  # surfaced per request
                logger.error(f"batch failed: {e}", exc_info=True)
                for r in batch:
                    r.error = f"{type(e).__name__}: {e}"
            for r in batch:
                r.event.set()
        if pending is not None:  # shutdown: don't strand in-flight waiters
            finalize(pending)

    def infer(self, model_name: Optional[str], *payload: np.ndarray,
              timeout: float = 60.0) -> np.ndarray:
        entry = self.registry.get(model_name)
        req = _Request(payload=tuple(payload))
        self._queue_for((entry.name, len(payload)), entry.name).put(req)
        if not req.event.wait(timeout):
            raise TimeoutError("inference timed out")
        if req.error:
            raise RuntimeError(req.error)
        return req.result

    def occupancy(self) -> Dict[str, Any]:
        """Average requests coalesced per device batch, per model."""
        with self._lock:
            return {
                name: {
                    "batches": b,
                    "requests": r,
                    "avg_batch": round(r / b, 2) if b else 0.0,
                }
                for name, (b, r) in self._occupancy.items()
            }

    def stop(self):
        self._running = False


class _Stats:
    def __init__(self):
        self.latencies: List[float] = []
        self.count = 0
        self.errors = 0
        self._lock = threading.Lock()

    def record(self, latency: float, error: bool = False):
        with self._lock:
            self.count += 1
            if error:
                self.errors += 1
            else:
                self.latencies.append(latency)
                if len(self.latencies) > 10000:
                    self.latencies = self.latencies[-5000:]

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            lats = sorted(self.latencies)
        if not lats:
            return {"count": self.count, "errors": self.errors}
        pct = lambda p: lats[min(int(p / 100 * len(lats)), len(lats) - 1)]
        return {
            "count": self.count,
            "errors": self.errors,
            "p50_ms": round(pct(50) * 1e3, 2),
            "p90_ms": round(pct(90) * 1e3, 2),
            "p99_ms": round(pct(99) * 1e3, 2),
        }


class SegmentationServer:
    def __init__(self, registry: ModelRegistry, *,
                 output_dir: Optional[str] = None,
                 max_batch: int = 8, max_wait_ms: float = 5.0):
        self.registry = registry
        self.engine = BatchingInferenceEngine(registry, max_batch, max_wait_ms)
        self.output_dir = output_dir or os.path.join(tempfile.gettempdir(),
                                                     "tpuseg_masks")
        self.stats = _Stats()
        os.makedirs(self.output_dir, exist_ok=True)
        self._httpd: Optional[ThreadingHTTPServer] = None

    # -- request handling ----------------------------------------------------

    def _build_input(self, image_path: str, entry: ModelEntry):
        """Decode + nearest-resize to the model's resolution, as uint8 (the
        /255 runs on the device).  Returns the image and the original
        (height, width), which prompt coordinates are rescaled from."""
        mode = "L" if entry.in_channels == 1 else "RGB"
        img = image_io.read(image_path, mode)
        if img.ndim == 2:
            img = img[..., None]
        orig_hw = img.shape[:2]
        return (nearest_resize(img, (entry.resolution, entry.resolution)),
                orig_hw)

    def _build_prompts(self, payload: Dict[str, Any], entry: ModelEntry,
                       orig_hw=None):
        """Fixed-width prompt arrays from the request JSON: ``points``
        [[x, y], ...] (+ optional ``point_labels``, default all-foreground),
        padded to entry.max_points with the -1 pad label; optional ``box``
        [[x1, y1], [x2, y2]].

        Coordinates are in the ORIGINAL image's pixel space and are
        rescaled here into the model-resolution frame the image was resized
        to."""
        points = payload.get("points") or []
        labels = payload.get("point_labels") or [1] * len(points)
        if len(points) != len(labels):
            raise KeyError("'points and point_labels length mismatch'")
        if len(points) > entry.max_points:
            raise KeyError(f"'too many points (max {entry.max_points})'")
        if not points and "box" not in payload:
            raise KeyError("'promptable model needs points and/or box'")
        pts = np.zeros((entry.max_points, 2), np.float32)
        lbl = -np.ones((entry.max_points,), np.int32)
        for i, (p, l) in enumerate(zip(points, labels)):
            pts[i] = p
            lbl[i] = l
        box = payload.get("box")
        if box is not None:
            box = np.asarray(box, np.float32).reshape(2, 2)
        if orig_hw is not None and orig_hw != (entry.resolution,) * 2:
            sx = entry.resolution / orig_hw[1]  # x scales with width
            sy = entry.resolution / orig_hw[0]
            scale = np.asarray([sx, sy], np.float32)
            pts = pts * scale
            if box is not None:
                box = box * scale
        return pts, lbl, box

    def handle_predict(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        start = time.time()
        try:
            image_path = payload["image_path"]
            entry = self.registry.get(payload.get("model"))
            image, orig_hw = self._build_input(image_path, entry)
            inputs = (image,)
            if entry.kind == "promptable":
                pts, lbl, box = self._build_prompts(payload, entry, orig_hw)
                inputs = (image, pts, lbl) + (() if box is None else (box,))
            # the device already thresholded / argmax'd
            mask = np.asarray(self.engine.infer(entry.name, *inputs),
                              np.uint8)

            ret_mode = payload.get("return")
            if ret_mode == "mask":
                response: Any = mask.tolist()
            elif ret_mode == "png":
                # lossless label mask as base64 PNG — far smaller than the
                # JSON nested-list encoding
                response = base64.b64encode(png.encode(mask)).decode("ascii")
            else:
                base = os.path.splitext(os.path.basename(image_path))[0]
                mask_path = os.path.join(
                    self.output_dir, f"{base}_{entry.name}_mask.png"
                )
                # spread label values over the uint8 range (binary → 0/255;
                # C-class maps → 0, 255//(C-1), …) by the model's fixed class
                # count, so a label always maps to the same grey value
                vis = mask * (255 // max(entry.n_classes - 1,
                                         int(mask.max()), 1))
                png.write(mask_path, vis.astype(np.uint8))
                response = mask_path
            elapsed = time.time() - start
            self.stats.record(elapsed)
            return {"response": response, "status": 200,
                    "time": time.strftime("%Y-%m-%d %H:%M:%S"),
                    "latency_ms": round(elapsed * 1e3, 2),
                    "model": entry.name}
        except FileNotFoundError as e:
            self.stats.record(time.time() - start, error=True)
            return {"response": f"image not found: {e}", "status": 404,
                    "time": time.strftime("%Y-%m-%d %H:%M:%S")}
        except (KeyError, ImageError) as e:
            self.stats.record(time.time() - start, error=True)
            return {"response": str(e), "status": 400,
                    "time": time.strftime("%Y-%m-%d %H:%M:%S")}
        except Exception as e:
            self.stats.record(time.time() - start, error=True)
            logger.error(f"prediction failed: {e}", exc_info=True)
            return {"response": f"{type(e).__name__}: {e}", "status": 500,
                    "time": time.strftime("%Y-%m-%d %H:%M:%S")}

    # -- http ----------------------------------------------------------------

    def _make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                logger.info("%s - %s" % (self.address_string(), fmt % args))

            def _send(self, obj: Dict[str, Any], status: int = 200):
                body = json.dumps(obj).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/health":
                    self._send({"status": "ok"})
                elif self.path == "/models":
                    self._send({"models": server.registry.names(),
                                "default": server.registry.default})
                elif self.path == "/stats":
                    summary = server.stats.summary()
                    summary["batch_occupancy"] = server.engine.occupancy()
                    self._send(summary)
                else:
                    self._send({"response": "not found", "status": 404}, 404)

            def do_POST(self):
                if self.path not in ("/", "/predict"):
                    self._send({"response": "not found", "status": 404}, 404)
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(length) or b"{}")
                except (ValueError, json.JSONDecodeError):
                    self._send({"response": "invalid JSON", "status": 400}, 400)
                    return
                result = server.handle_predict(payload)
                self._send(result, result.get("status", 200))

        return Handler

    def start(self, host: str = "0.0.0.0", port: int = 6076) -> ThreadingHTTPServer:
        """Start serving in a background thread; returns the server object."""
        self._httpd = ThreadingHTTPServer((host, port), self._make_handler())
        thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        thread.start()
        logger.info(f"serving on {host}:{port} (models: {self.registry.names()})")
        return self._httpd

    def serve_forever(self, host: str = "0.0.0.0", port: int = 6076):
        self._httpd = ThreadingHTTPServer((host, port), self._make_handler())
        logger.info(f"serving on {host}:{port} (models: {self.registry.names()})")
        self._httpd.serve_forever()

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        self.engine.stop()


def serve(registry: ModelRegistry, host: str = "0.0.0.0", port: int = 6076,
          **kwargs):
    """Blocking convenience entry."""
    SegmentationServer(registry, **kwargs).serve_forever(host, port)

"""Segmentation serving: HTTP endpoint → batched GPU inference (the JAX
package's ``serve/app.py``).

- ``ModelRegistry``: named models, each with a forward specialized to its
  input resolution and device;
- ``BatchingInferenceEngine``: a background worker per model that coalesces
  concurrent requests into one device batch (up to ``max_batch``, waiting at
  most ``max_wait_ms``), pads it to a power of two, and keeps one batch in
  flight while it collects the next;
- ``SegmentationServer``: a stdlib ThreadingHTTPServer exposing
    POST /            {"image_path", "model"?,
                       "return"?: "path"|"mask"|"png"}
                      → {"response": <mask path, nested list, or base64 PNG
                         of the raw label mask>, "status", "time"}
    GET  /models      registered model names
    GET  /stats       request count + latency percentiles (p50/p90/p99)
    GET  /health      liveness

Images are decoded by the port's own PNG codec (``utils/png.py``).
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
from ..utils import png

logger = get_logger("serve")


@dataclass
class ModelEntry:
    name: str
    # forward(uint8 images (N,H,W,C) in [0,255]) -> uint8 label masks
    # (N,H,W): the /255 and the threshold/argmax run on the device.
    forward: Callable[..., np.ndarray]
    in_channels: int
    resolution: int
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


def _not_ported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported to the PyTorch package yet "
        f"(ROADMAP.md queue 1, {item})")


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
                        quantize: Optional[str] = None, tta: bool = False,
                        device: Union[str, torch.device] = "cuda",
                        max_batch: int = 8):
        """Load a 2D bundle saved by either package's ``save_pretrained`` and
        serve it on ``device``.

        ``tta=True`` serves a mirror flip ensemble (4 passes over H/W,
        averaged in logit space before the final activation).

        On CUDA this builds the kernels and runs one warm-up forward for each
        power-of-two batch up to ``max_batch``, on the calling thread, before
        the model is registered — so no request pays for a build or a first
        launch."""
        from ..models import UNetModel
        from ..ops.tta import flip_ensemble, mirror_combos

        if quantize is not None:
            _not_ported(f"quantize={quantize!r} serving", "item 21 (int8 PTQ)")
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but CUDA is not "
                               "available")
        # the serving copy: weights cast once to the compute dtype
        model = UNetModel.from_pretrained(path, device=device).for_inference()
        combos = mirror_combos((1, 2)) if tta else [[]]
        out_channels = model.config.out_channels

        def probs(x):
            logits = flip_ensemble(lambda xx: model(xx).logits, combos, x)
            if out_channels > 1:
                return torch.softmax(logits, dim=-1)
            return torch.sigmoid(logits)

        self._register_probs(name, probs, model.config.in_channels,
                             out_channels, resolution=resolution,
                             threshold=threshold, device=device,
                             max_batch=max_batch, default=default)

    def _register_probs(self, name: str, probs: Callable, in_channels: int,
                        out_channels: int, *, resolution: int,
                        threshold: float, device: torch.device,
                        max_batch: int, default: bool) -> None:
        """Register ``probs`` (float images (N, H, W, C) in [0, 1] on the
        device → probabilities (N, H, W, out)) behind the uint8-in,
        mask-out engine contract.  On CUDA this builds the kernels and runs
        one warm-up forward for each power-of-two batch up to
        ``max_batch`` first."""
        from ..ops import _build

        if out_channels > 1:
            def mask_head(p):
                return torch.argmax(p, dim=-1).to(torch.uint8)
        else:
            thr = float(threshold)

            def mask_head(p):
                return (p[..., 0] > thr).to(torch.uint8)

        def to_device(x: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(x)).to(device)

        def dispatch(x: np.ndarray):
            # enqueue only: uint8 in, /255 and threshold/argmax on device,
            # an event recorded after the forward marks completion
            with torch.inference_mode():
                mask = mask_head(probs(to_device(x).float() / 255.0))
            event = None
            if device.type == "cuda":
                event = torch.cuda.Event()
                event.record()
            return mask, event

        def fetch(handle) -> np.ndarray:
            mask, event = handle
            if event is not None:
                event.synchronize()
            return mask.cpu().numpy()

        def ready(handle) -> bool:
            event = handle[1]
            return event is None or bool(event.query())

        def np_forward(x):
            return fetch(dispatch(x))

        def np_probs(x):
            with torch.inference_mode():
                return probs(to_device(x).float()).cpu().numpy()

        if device.type == "cuda":
            _build.load()
        b = 1
        while b <= max_batch:
            np_forward(np.zeros((b, resolution, resolution, in_channels),
                                np.uint8))
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
                fetch=fetch,
                n_classes=max(int(out_channels), 2),
                probs_forward=np_probs,
                ready=ready,
            ),
            default=default,
        )

    def register_exported(self, name: str, path: str, **kwargs):
        _not_ported("serving an exported artifact", "item 23 (export)")

    def register_unet3d(self, name: str, path: str,
                        model_config: Dict[str, Any], *,
                        threshold: float = 0.5, resolution: int = 256,
                        default: bool = False,
                        device: Union[str, torch.device] = "cuda",
                        max_batch: int = 8):
        """Load a 3D-family model (``model_config`` is a config's ``model``
        section) from a training checkpoint of either package and serve
        single 2D slices on ``device``: each slice is replicated to the
        least depth that survives the model's (num_levels - 1) poolings,
        ``2**(num_levels - 1)``, and the middle output slice is returned
        (pseudo-3D slice serving).  Builds the kernels and warms every
        power-of-two batch up to ``max_batch`` before it registers."""
        from ..models import get_model
        from ..train import load_checkpoint
        from ..utils.param_bridge import flax_to_state_dict

        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but CUDA is not "
                               "available")
        model = get_model(model_config, device=device)
        ms = load_checkpoint(path)["model_state_dict"]
        if ms.get("batch_stats"):
            _not_ported("a model with BatchNorm statistics",
                        "item 16 (BatchNorm layer orders)")
        model.load_state_dict(flax_to_state_dict(ms["params"]))
        model.eval()
        act = model.final_activation()
        depth = 2 ** (max(int(model.num_levels), 1) - 1)

        def probs(x):
            x3 = x[:, None].expand(-1, depth, -1, -1, -1)
            out = model(x3.contiguous())[:, depth // 2]
            return act(out) if act is not None else out

        self._register_probs(name, probs, model.in_channels,
                             model.out_channels, resolution=resolution,
                             threshold=threshold, device=device,
                             max_batch=max_batch, default=default)

    def register_sam(self, name: str, path: str, **kwargs):
        _not_ported("SAM-Med2D serving", "item 24 (SAM-Med2D)")

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

    def _build_input(self, image_path: str, entry: ModelEntry) -> np.ndarray:
        """Decode + nearest-resize to the model's resolution, as uint8 (the
        /255 runs on the device)."""
        mode = "L" if entry.in_channels == 1 else "RGB"
        img = png.read(image_path, mode)
        if img.ndim == 2:
            img = img[..., None]
        return nearest_resize(img, (entry.resolution, entry.resolution))

    def handle_predict(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        start = time.time()
        try:
            image_path = payload["image_path"]
            entry = self.registry.get(payload.get("model"))
            image = self._build_input(image_path, entry)
            # the device already thresholded / argmax'd
            mask = np.asarray(self.engine.infer(entry.name, image), np.uint8)

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
        except (KeyError, png.PngError) as e:
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

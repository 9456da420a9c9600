"""Exported deployment artifacts (the JAX package's ``export.py``), on
``torch.export``.

``export_bundle`` traces a saved bundle's *inference forward* with
``torch.export`` (eval mode, no autograd), with the parameters inside, and
writes ``model.pt2`` (``torch.export.save``) beside ``export_meta.json``.
The artifact:

- runs in any process with torch and this package's op registrations: no
  model code, no checkpoint plumbing (``load_exported(path)(images)``);
- reaches the hand-written kernels by name: kernels 1, 2, 3a and 3b are
  ``torch.library`` custom ops (``tpuseg::fused_double2d_y``,
  ``tpuseg::fused_conv3d``, ``tpuseg::gn_channel_sums``,
  ``tpuseg::gn_affine``; ``ops/fused_conv.py``, ``ops/norm.py``), so the
  exported program launches them on the card and runs their plain versions
  on the CPU;
- has a symbolic batch dimension ``b`` by default (export once, serve any
  batch: the serving engine's batches vary), while the spatial dims are
  static;
- keeps the device it was traced on: ``device`` (default ``"cuda"``)
  replaces the JAX package's ``platforms``, and ``load_exported`` refuses an
  artifact traced for another device.

2D artifacts emit what the serving path needs: probabilities (sigmoid,
multi-class softmax, or the CGM forward as it is — the dispatch of
``serve.app.ModelRegistry.register_unet2d``), from the serving copy of the
model (``UNetModel.for_inference``: conv weights cast once to the compute
dtype).  3D artifacts emit the wrapper's activated output (the reference's
quirk, ``models/wrappers3d.py``).  ``output="logits"`` skips the
activation.  The meta keeps the JAX meta's keys, with ``device`` and
``torch_version`` in place of ``platforms``, ``jax_version`` and
``calling_convention_version``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from .logging_utils import get_logger

logger = get_logger("export")

ARTIFACT_FILE = "model.pt2"
META_FILE = "export_meta.json"


def detect_bundle_kind(bundle_dir: str) -> str:
    """'2d' | '3d' from a saved bundle's config.json ``unet_type``."""
    from .models import MODELS_3D, UNET_TYPES

    with open(os.path.join(bundle_dir, "config.json")) as f:
        cfg = json.load(f)
    unet_type = cfg.get("unet_type", "")
    if unet_type in UNET_TYPES:
        return "2d"
    if unet_type in MODELS_3D:
        return "3d"
    raise ValueError(
        f"unrecognized unet_type {unet_type!r} in {bundle_dir}/config.json"
    )


def _probs_2d(model) -> Callable[[torch.Tensor], torch.Tensor]:
    """Probability head matching serve.app.register_unet2d's dispatch."""

    def probs(logits):
        if model.config.unet_type.endswith("CGM"):
            return logits  # the CGM forward is already sigmoided
        if model.config.out_channels > 1:
            return torch.softmax(logits, dim=-1)
        return torch.sigmoid(logits)

    return probs


class _Forward(torch.nn.Module):
    """The traced function: ``head(forward(model, x))``."""

    def __init__(self, model: torch.nn.Module, forward: Callable):
        super().__init__()
        self.model = model
        self._forward = forward

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._forward(self.model, x)


def export_bundle(
    bundle_dir: str,
    out_dir: str,
    *,
    batch: Optional[int] = None,
    resolution: Tuple[int, int] = (512, 512),
    patch_shape: Tuple[int, int, int] = (32, 64, 64),
    device: Union[str, torch.device] = "cuda",
    output: str = "probs",
    compute_dtype: Optional[str] = None,
) -> str:
    """Trace a saved bundle's inference forward on ``device`` and save it.

    ``batch=None`` exports a symbolic batch dimension ``b``; an int pins
    it.  ``resolution`` (2D, H×W) / ``patch_shape`` (3D, D×H×W) set the
    static spatial dims.  ``compute_dtype`` overrides the bundle's conv
    compute dtype (e.g. ``"bfloat16"``) without touching the fp32
    parameters of the bundle.  Returns ``out_dir``."""
    from .models import UNetModel, UNet3DForMedicalSegmentation
    from .models.wrappers import _DTYPES, _checked_device

    if output not in ("probs", "logits"):
        raise ValueError(f"output={output!r}: expected 'probs' or 'logits'")
    device = _checked_device(device)
    kind = detect_bundle_kind(bundle_dir)

    if kind == "2d":
        model = UNetModel.from_pretrained(bundle_dir, device=device)
        if compute_dtype:
            model.config = dataclasses.replace(model.config,
                                               compute_dtype=compute_dtype)
            model.compute_dtype = _DTYPES[compute_dtype]
        model.for_inference()  # the serving copy register_unet2d holds
        head = _probs_2d(model)

        def fn(m, x):
            logits = m(x).logits
            return head(logits) if output == "probs" else logits

        spatial = tuple(resolution)
    else:
        model = UNet3DForMedicalSegmentation.from_pretrained(bundle_dir,
                                                             device=device)
        if compute_dtype:
            live = model
            model = UNet3DForMedicalSegmentation(
                dataclasses.replace(live.config, compute_dtype=compute_dtype),
                device="meta")
            model.module.load_state_dict(live.module.state_dict(),
                                         assign=True)
        model.requires_grad_(False)
        if output == "probs":
            def fn(m, x):  # the activated tensor in the logits slot
                return m(x).logits
        else:
            def fn(m, x):
                return m.module(x)

        spatial = (tuple(patch_shape) if model.config.is3d
                   else tuple(patch_shape[-2:]))

    in_channels = int(model.config.in_channels)
    traced = _Forward(model, fn).eval()
    # a batch of 2 to trace: a batch of 1 would specialize the symbol
    example = torch.zeros((2 if batch is None else int(batch),) + spatial
                          + (in_channels,), device=device)
    dynamic = None if batch is not None else {
        "x": {0: torch.export.Dim("b", min=1)}}
    logger.info(
        f"exporting {bundle_dir} ({kind}, {model.config.unet_type}) input "
        f"{['b' if batch is None else int(batch), *spatial, in_channels]} "
        f"on {device}")
    with torch.no_grad():
        program = torch.export.export(traced, (example,),
                                      dynamic_shapes=dynamic)

    os.makedirs(out_dir, exist_ok=True)
    artifact = os.path.join(out_dir, ARTIFACT_FILE)
    torch.export.save(program, artifact)
    nbytes = os.path.getsize(artifact)
    meta = {
        "kind": kind,
        "unet_type": model.config.unet_type,
        "in_channels": in_channels,
        "out_channels": int(model.config.out_channels),
        "input_shape": ["b" if batch is None else int(batch)]
        + [int(s) for s in spatial]
        + [in_channels],
        "input_dtype": "float32",
        "output": output,
        "device": device.type,
        "torch_version": torch.__version__,
        "artifact_bytes": nbytes,
    }
    with open(os.path.join(out_dir, META_FILE), "w") as f:
        json.dump(meta, f, indent=2)
    logger.info(f"wrote {artifact} ({nbytes / 2**20:.2f} MiB)")
    return out_dir


class ExportedModel:
    """A loaded artifact: ``model(images) -> np.ndarray``.

    ``module`` is the exported program as a callable module (float32
    tensors on the artifact's device in, its output out); ``dispatch`` /
    ``fetch`` are the non-blocking halves, as in the JAX package."""

    def __init__(self, program, meta: Dict[str, Any]):
        self.meta = meta
        self.program = program
        self.module = program.module()
        self.device = torch.device(meta["device"])

    @property
    def in_channels(self) -> int:
        return int(self.meta["in_channels"])

    @property
    def out_channels(self) -> int:
        return int(self.meta["out_channels"])

    @property
    def input_shape(self) -> Tuple[Any, ...]:
        return tuple(self.meta["input_shape"])

    def dispatch(self, x) -> torch.Tensor:
        x = torch.as_tensor(np.asarray(x, np.float32)).to(self.device)
        with torch.inference_mode():
            return self.module(x)

    @staticmethod
    def fetch(handle: torch.Tensor) -> np.ndarray:
        return handle.cpu().numpy()

    def __call__(self, x) -> np.ndarray:
        return self.fetch(self.dispatch(x))


def load_exported(path: str, *,
                  device: Union[str, torch.device] = "cuda") -> ExportedModel:
    """Load an artifact directory written by :func:`export_bundle`.  The
    program keeps the device it was traced on: an artifact of another
    device than ``device`` is refused."""
    # the artifact names the tpuseg:: ops: register them first
    from .ops import fused_conv, norm  # noqa: F401
    from .models.wrappers import _checked_device

    device = _checked_device(device)
    with open(os.path.join(path, META_FILE)) as f:
        meta = json.load(f)
    if meta.get("device") != device.type:
        raise ValueError(
            f"{path}: traced for device {meta.get('device')!r}, asked for "
            f"{device.type!r}; export again with device={device.type!r}")
    program = torch.export.load(os.path.join(path, ARTIFACT_FILE))
    return ExportedModel(program, meta)

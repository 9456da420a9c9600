"""Config-driven 2D model bundles (the JAX package's ``models/wrappers.py``).

``UNetModel`` pairs a ``UNetConfig`` with the module its ``unet_type`` names
and with its criterion: for the classic UNet ``bce_with_logits`` (one output
channel) or ``cross_entropy`` (more), for the UNet-3+ family the hybrid
``segmentation_loss``.  A deep-supervision model's loss is summed over its 5
heads and its ``logits`` are head 1 (for ``UNet_3Plus_DeepSup_CGM``
probabilities already, which the criterion's sigmoid squashes a second
time, as the JAX package does).  It reads and writes the JAX package's
bundle format unchanged: ``config.json`` plus a flax ``params.msgpack``
holding ``params`` and, with BatchNorm, ``batch_stats`` (through
``utils/flax_msgpack.py`` and ``utils/param_bridge.py``).

Precision policy, as in the JAX wrapper: parameters are float32
(``param_dtype``), the master weights that training updates; with
``compute_dtype="bfloat16"`` every conv casts them to bf16 at use (flax's
``promote_dtype``), autograd carries the gradients back to float32, and the
logits and the loss are float32.  BatchNorm keeps its scale, bias and
running statistics float32 and normalizes in float32, casting its output
to the compute dtype, as flax does.  A model built or loaded this way holds
the float32 weights only.  Serving calls ``for_inference()``, which casts
the conv weights once to ``compute_dtype`` (the casts at use then cost
nothing), leaves BatchNorm float32 and stops every gradient:
``register_unet2d`` holds that copy.  ``remat`` / ``remat_policy`` reach
every block (``ops/remat.py``).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional, Union

import torch
import torch.nn as nn

from ..losses.losses2d import bce_with_logits, cross_entropy, segmentation_loss
from ..utils import flax_msgpack
from ..utils.param_bridge import flax_to_state_dict, state_dict_to_flax
from .layers2d import TorchBatchNorm
from .unet2d import UNet, UNet3Plus, UNet3PlusDeepSup, UNet3PlusDeepSupCGM

UNET_TYPES = {
    "UNet": UNet,
    "UNet_3Plus": UNet3Plus,
    "UNet_3Plus_DeepSup": UNet3PlusDeepSup,
    "UNet_3Plus_DeepSup_CGM": UNet3PlusDeepSupCGM,
}

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class UNetConfig:
    """Same fields (and ``config.json`` keys) as the JAX package's.  The port
    reads the channel counts, ``unet_type``, ``base_features`` and the two
    dtypes; the rest are carried so that a bundle loaded and saved again
    keeps its training settings."""

    in_channels: int = 1
    out_channels: int = 1
    unet_type: str = "UNet"
    base_features: int = 64
    bn_axis_name: Optional[str] = None
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    remat: bool = False
    remat_policy: Optional[str] = None
    label_names: str = "labels"
    main_input_name: str = "images"

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "UNetConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


@dataclasses.dataclass
class SegOutput:
    loss: Optional[torch.Tensor] = None
    logits: Optional[torch.Tensor] = None
    labels: Optional[torch.Tensor] = None

    def __getitem__(self, key):  # dict-style access, as in the JAX package
        return getattr(self, key)


def _checked_device(device: Union[str, torch.device]) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available; pass device='cpu' to run on the CPU")
    return device


class UNetModel(nn.Module):
    """The 2D model bundle.

    ``UNetModel(config, device=..., generator=...)`` builds it with its
    initializers drawn on the CPU from ``generator`` (a fresh
    ``torch.Generator`` seeded 0 when none is given), then moves the float32
    parameters to ``device``: the card by default (an error without one),
    the CPU only when asked (``device="cpu"``).  ``device="meta"`` builds
    the structure alone.  ``model(images, labels=None, generator=None)``
    takes NHWC images (and labels: NHWC masks, or class maps for
    ``out_channels > 1``) and returns ``SegOutput`` with float32 NHWC logits
    and, given labels, the float32 loss; ``generator`` drives CGM's dropout
    in training mode.
    """

    def __init__(self, config: UNetConfig, *,
                 device: Union[str, torch.device] = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cls = UNET_TYPES.get(config.unet_type)
        if cls is None:
            raise KeyError(f"unknown unet_type {config.unet_type!r}; one of "
                           f"{sorted(UNET_TYPES)}")
        if config.compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype={config.compute_dtype!r}: "
                             f"expected one of {sorted(_DTYPES)}")
        if config.param_dtype != "float32":
            raise ValueError("the port keeps float32 parameters "
                             f"(param_dtype={config.param_dtype!r})")
        self.config = config
        self.compute_dtype = _DTYPES[config.compute_dtype]
        device = _checked_device(device)
        build_on = device if device.type == "meta" else torch.device("cpu")
        rm = dict(remat=config.remat, remat_policy=config.remat_policy,
                  device=build_on)
        if config.unet_type == "UNet":
            self.criterion = (cross_entropy if config.out_channels > 1
                              else bce_with_logits)
            self.module = cls(config.in_channels, config.out_channels,
                              config.base_features, **rm)
        else:
            self.criterion = segmentation_loss
            self.module = cls(config.in_channels, config.out_channels,
                              bn_axis_name=config.bn_axis_name, **rm)
        if device.type != "meta":
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            self.module.reset_parameters(generator)
            self.module.to(device=device)
        self.eval()

    def forward(self, images: torch.Tensor,
                labels: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> SegOutput:
        raw = self.module(images.to(self.compute_dtype), generator)
        if isinstance(raw, tuple):  # deep supervision: 5 heads
            heads = tuple(d.float() for d in raw)
            loss = None if labels is None else sum(
                self.criterion(d, labels) for d in heads)
            return SegOutput(loss=loss, logits=heads[0], labels=labels)
        logits = raw.float()
        loss = None if labels is None else self.criterion(logits, labels)
        return SegOutput(loss=loss, logits=logits, labels=labels)

    def for_inference(self) -> "UNetModel":
        """The serving copy, in place: conv parameters cast once to
        ``compute_dtype`` (BatchNorm's stay float32, as flax keeps them), no
        gradients, eval mode.  Returns ``self``."""
        for m in self.module.modules():
            if isinstance(m, TorchBatchNorm):
                continue
            for p in m.parameters(recurse=False):
                p.data = p.data.to(self.compute_dtype)
        self.requires_grad_(False)
        return self.eval()

    # -- persistence ---------------------------------------------------------

    def save_pretrained(self, path: str) -> None:
        """``config.json`` + flax ``params.msgpack`` (``params``, and
        ``batch_stats`` with BatchNorm), loadable by the JAX package's
        ``UNetModel.from_pretrained``."""
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(self.config.to_dict(), f, indent=2)
        flax_msgpack.save(os.path.join(path, "params.msgpack"),
                          state_dict_to_flax(self.module.state_dict()))

    @classmethod
    def from_pretrained(cls, path: str, *,
                        device: Union[str, torch.device] = "cuda",
                        ) -> "UNetModel":
        """Load a bundle saved by either package's ``save_pretrained`` onto
        ``device`` (the card by default; ``"cpu"`` when asked), with float32
        parameters and BatchNorm statistics."""
        device = _checked_device(device)
        with open(os.path.join(path, "config.json")) as f:
            config = UNetConfig.from_dict(json.load(f))
        model = cls(config, device="meta")
        sd = flax_to_state_dict(
            flax_msgpack.load(os.path.join(path, "params.msgpack")))
        model.module.load_state_dict(sd, strict=True, assign=True)
        model.module.to(device=device, dtype=torch.float32)
        return model

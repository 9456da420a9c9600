"""Config-driven 2D model bundles (the JAX package's ``models/wrappers.py``).

``UNetModel`` pairs a ``UNetConfig`` with its module and its criterion
(``bce_with_logits`` for one output channel, ``cross_entropy`` for more), and
reads and writes the JAX package's bundle format unchanged: ``config.json``
plus a flax ``params.msgpack`` (through ``utils/flax_msgpack.py`` and
``utils/param_bridge.py``).

Precision policy, as in the JAX wrapper: parameters are float32
(``param_dtype``), the master weights that training updates; with
``compute_dtype="bfloat16"`` every conv casts them to bf16 at use (flax's
``promote_dtype``), autograd carries the gradients back to float32, and the
logits and the loss are float32.  A model built or loaded this way holds
the float32 weights only.  Serving calls ``for_inference()``, which casts
them once to ``compute_dtype`` (the casts at use then cost nothing) and
stops their gradients: ``register_unet2d`` holds that copy.

So far the port covers ``unet_type="UNet"``; the UNet-3+ family, remat and
the other initializers raise.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional, Union

import torch
import torch.nn as nn

from ..losses.losses2d import bce_with_logits, cross_entropy
from ..utils import flax_msgpack
from ..utils.param_bridge import flax_to_state_dict, state_dict_to_flax
from .unet2d import UNet

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
    """The classic UNet bundle.

    ``UNetModel(config, device=..., generator=...)`` builds it with PyTorch's
    default conv init drawn on the CPU from ``generator`` (a fresh
    ``torch.Generator`` seeded 0 when none is given), then moves the float32
    parameters to ``device``: the card by default (an error without one),
    the CPU only when asked (``device="cpu"``).  ``device="meta"`` builds
    the structure alone.  ``model(images, labels=None)`` takes NHWC images
    (and labels: NHWC masks, or class maps for ``out_channels > 1``) and
    returns ``SegOutput`` with float32 NHWC logits and, given labels, the
    float32 loss.
    """

    def __init__(self, config: UNetConfig, *,
                 device: Union[str, torch.device] = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if config.unet_type != "UNet":
            raise NotImplementedError(
                f"unet_type={config.unet_type!r} is not ported yet: the "
                "UNet-3+ family is ROADMAP.md queue 1, item 13")
        if config.compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype={config.compute_dtype!r}: "
                             f"expected one of {sorted(_DTYPES)}")
        if config.param_dtype != "float32":
            raise ValueError("the port keeps float32 parameters "
                             f"(param_dtype={config.param_dtype!r})")
        if config.remat:
            # remat_policy acts only under remat (the JAX CLI writes
            # "save_convs" into every bundle's config.json), so it alone
            # loads as it is
            raise NotImplementedError(
                f"remat (policy {config.remat_policy!r}) is not ported yet: "
                "ROADMAP.md queue 1, item 15 (selective remat)")
        self.config = config
        self.compute_dtype = _DTYPES[config.compute_dtype]
        self.criterion = (cross_entropy if config.out_channels > 1
                          else bce_with_logits)
        device = _checked_device(device)
        build_on = device if device.type == "meta" else torch.device("cpu")
        self.module = UNet(config.in_channels, config.out_channels,
                           config.base_features, device=build_on)
        if device.type != "meta":
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            self.module.reset_parameters(generator)
            self.module.to(device=device)
        self.eval()

    def forward(self, images: torch.Tensor,
                labels: Optional[torch.Tensor] = None) -> SegOutput:
        logits = self.module(images.to(self.compute_dtype)).float()
        loss = None if labels is None else self.criterion(logits, labels)
        return SegOutput(loss=loss, logits=logits, labels=labels)

    def for_inference(self) -> "UNetModel":
        """The serving copy, in place: parameters cast once to
        ``compute_dtype``, no gradients, eval mode.  Returns ``self``."""
        self.module.to(dtype=self.compute_dtype)
        self.requires_grad_(False)
        return self.eval()

    # -- persistence ---------------------------------------------------------

    def save_pretrained(self, path: str) -> None:
        """``config.json`` + flax ``params.msgpack``, loadable by the JAX
        package's ``UNetModel.from_pretrained``."""
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
        parameters."""
        device = _checked_device(device)
        with open(os.path.join(path, "config.json")) as f:
            config = UNetConfig.from_dict(json.load(f))
        model = cls(config, device="meta")
        sd = flax_to_state_dict(
            flax_msgpack.load(os.path.join(path, "params.msgpack")))
        model.module.load_state_dict(sd, strict=True, assign=True)
        model.module.to(device=device, dtype=torch.float32)
        return model

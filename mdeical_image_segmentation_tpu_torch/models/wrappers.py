"""Config-driven 2D model bundles (the JAX package's ``models/wrappers.py``).

``UNetModel`` pairs a ``UNetConfig`` with its module and reads and writes
the JAX package's bundle format unchanged: ``config.json`` plus a flax
``params.msgpack`` (through ``utils/flax_msgpack.py`` and
``utils/param_bridge.py``).

Precision policy, as in the JAX wrapper: parameters are float32
(``param_dtype``); with ``compute_dtype="bfloat16"`` they are cast once, when
the model is built or loaded, and the convs run in bf16; the logits are
returned in float32.  Saving a bf16 model therefore writes the bf16-rounded
values as float32 — the values the JAX package computes with under the same
policy.

So far the port covers ``unet_type="UNet"`` and inference only.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional, Union

import torch
import torch.nn as nn

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
    ``torch.Generator`` seeded 0 when none is given), then moves it to
    ``device`` in ``compute_dtype``: the card by default (an error without
    one), the CPU only when asked (``device="cpu"``).  ``device="meta"``
    builds the structure alone.  ``model(images)`` takes NHWC images and
    returns ``SegOutput`` with float32 NHWC logits.
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
        self.config = config
        self.compute_dtype = _DTYPES[config.compute_dtype]
        device = _checked_device(device)
        build_on = device if device.type == "meta" else torch.device("cpu")
        self.module = UNet(config.in_channels, config.out_channels,
                           config.base_features, device=build_on)
        if device.type != "meta":
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            self.module.reset_parameters(generator)
            self.module.to(device=device, dtype=self.compute_dtype)
        self.eval()

    def forward(self, images: torch.Tensor,
                labels: Optional[torch.Tensor] = None) -> SegOutput:
        if labels is not None:
            raise NotImplementedError(
                "losses are not ported yet: they come with the 2D training "
                "slice (ROADMAP.md queue 1, item 6)")
        logits = self.module(images.to(self.compute_dtype))
        return SegOutput(logits=logits.float())

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
        ``device`` (the card by default; ``"cpu"`` when asked)."""
        device = _checked_device(device)
        with open(os.path.join(path, "config.json")) as f:
            config = UNetConfig.from_dict(json.load(f))
        model = cls(config, device="meta")
        sd = flax_to_state_dict(
            flax_msgpack.load(os.path.join(path, "params.msgpack")))
        model.module.load_state_dict(sd, strict=True, assign=True)
        model.module.to(device=device, dtype=model.compute_dtype)
        return model

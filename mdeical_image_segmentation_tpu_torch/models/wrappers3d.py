"""Config-driven 3D model bundle (the JAX package's ``models/wrappers3d.py``).

``UNet3DForMedicalSegmentation`` pairs a ``UNet3DConfig`` with the 3D-family
module its ``unet_type`` names (UNet3D, ResidualUNet3D, ResidualUNetSE3D,
or the 2D members with ``is3d=False``) and with the loss that
``loss_config`` builds through the registry.  As in the JAX package (and its
reference), the sigmoid / softmax is applied **before** the loss and the
*activated* tensor is returned in the ``logits`` slot; set
``activate_before_loss=False`` for the conventional logits-into-loss
contract.  ``export.py`` relies on the activated output.

Batch contract: ``model(volume, target=None, weight=None)`` with
channels-last tensors; CE-family losses take integer targets of shape
(N, *spatial).  Bundles are ``config.json`` plus a flax ``params.msgpack``
(``params`` and, with BatchNorm, ``batch_stats``), read and written by
either package (``utils/flax_msgpack.py``, ``utils/param_bridge.py``).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn as nn

from ..losses.losses3d import get_loss_criterion
from ..utils import flax_msgpack
from ..utils.param_bridge import flax_to_state_dict, state_dict_to_flax
from .unet3d import MODELS_3D, AbstractUNet
from .wrappers import SegOutput, _checked_device


@dataclasses.dataclass
class UNet3DConfig:
    """The JAX package's ``UNet3DConfig`` fields and ``config.json`` keys."""

    in_channels: int = 1
    out_channels: int = 1
    final_sigmoid: bool = True
    basic_module: str = "DoubleConv"  # kept for config parity; unet_type decides
    f_maps: Union[int, Tuple[int, ...]] = 64
    layer_order: str = "gcr"
    num_groups: int = 8
    num_levels: int = 4
    is_segmentation: bool = True
    conv_kernel_size: int = 3
    pool_kernel_size: int = 2
    conv_padding: int = 1
    conv_upscale: int = 2
    upsample: str = "default"
    dropout_prob: float = 0.1
    is3d: bool = True
    loss_config: Optional[Dict[str, Any]] = None
    unet_type: str = "UNet3D"  # UNet3D | ResidualUNet3D | ResidualUNetSE3D
    activate_before_loss: bool = True
    compute_dtype: str = "float32"

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "UNet3DConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        d = {k: v for k, v in d.items() if k in known}
        if isinstance(d.get("f_maps"), list):
            d["f_maps"] = tuple(d["f_maps"])
        return cls(**d)


def _tuple_or_int(v):
    return tuple(v) if isinstance(v, (list, tuple)) else v


class UNet3DForMedicalSegmentation(nn.Module):
    """The 3D model bundle: ``module`` (the 3D-family network), its
    activation and its loss.  Built on the CPU from ``generator`` (a fresh
    one seeded 0 when none is given), then moved to ``device``: the card by
    default (an error without one), the CPU when asked; ``device="meta"``
    builds the structure alone.  Starts in eval mode."""

    def __init__(self, config: UNet3DConfig, *,
                 device: Union[str, torch.device] = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cls = MODELS_3D.get(config.unet_type)
        device = _checked_device(device)
        build_on = device if device.type == "meta" else torch.device("cpu")
        self.config = config
        self.module: AbstractUNet = cls(
            in_channels=config.in_channels,
            out_channels=config.out_channels,
            final_sigmoid=config.final_sigmoid,
            f_maps=_tuple_or_int(config.f_maps),
            layer_order=config.layer_order,
            num_groups=config.num_groups,
            num_levels=config.num_levels,
            is_segmentation=config.is_segmentation,
            conv_kernel_size=_tuple_or_int(config.conv_kernel_size),
            pool_kernel_size=_tuple_or_int(config.pool_kernel_size),
            conv_padding=config.conv_padding,
            conv_upscale=config.conv_upscale,
            upsample=config.upsample,
            dropout_prob=config.dropout_prob,
            dtype=config.compute_dtype,
            device=build_on,
        )
        self.activation = self.module.final_activation()
        self.loss_criterion = get_loss_criterion(
            config.loss_config or {"loss": {"name": "BCEDiceLoss"}})
        if device.type != "meta":
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            self.module.reset_parameters(generator)
            self.module.to(device=device)
        self.eval()

    def forward(self, volume: torch.Tensor,
                target: Optional[torch.Tensor] = None,
                weight: Optional[torch.Tensor] = None) -> SegOutput:
        raw = self.module(volume)
        activated = self.activation(raw) if self.activation else raw
        loss = None
        if target is not None:
            loss_input = (activated if self.config.activate_before_loss
                          else raw)
            loss = (self.loss_criterion(loss_input, target) if weight is None
                    else self.loss_criterion(loss_input, target, weight))
        # the activated output in the logits slot (the reference's quirk)
        return SegOutput(loss=loss, logits=activated, labels=target)

    # -- persistence ---------------------------------------------------------

    def save_pretrained(self, path: str) -> None:
        """``config.json`` + flax ``params.msgpack``, loadable by the JAX
        package's ``UNet3DForMedicalSegmentation.from_pretrained``."""
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(self.config.to_dict(), f, indent=2)
        flax_msgpack.save(os.path.join(path, "params.msgpack"),
                          state_dict_to_flax(self.module.state_dict()))

    @classmethod
    def from_pretrained(cls, path: str, *,
                        device: Union[str, torch.device] = "cuda",
                        ) -> "UNet3DForMedicalSegmentation":
        """Load a bundle saved by either package's ``save_pretrained`` onto
        ``device`` (the card by default; ``"cpu"`` when asked)."""
        device = _checked_device(device)
        with open(os.path.join(path, "config.json")) as f:
            config = UNet3DConfig.from_dict(json.load(f))
        model = cls(config, device="meta")
        sd = flax_to_state_dict(
            flax_msgpack.load(os.path.join(path, "params.msgpack")))
        model.module.load_state_dict(sd, strict=True, assign=True)
        model.module.to(device=device, dtype=torch.float32)
        return model

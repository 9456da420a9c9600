"""Weight initializers with PyTorch's statistics (the JAX package's
``ops/initializers.py``).

The reference picks an initializer by module class name: conv weights get
normal(0, 0.02), xavier-normal, kaiming-normal (fan_in, a=0) or orthogonal,
and norm scales N(1, 0.02²) with zero bias.  Modules that never call that
hook keep PyTorch's conv default: kaiming-uniform(a=sqrt(5)), i.e.
U(±1/sqrt(fan_in)) for the weight and the bias alike.  The squeeze-excitation
gates' dense layers keep flax's ``Dense`` default (``lecun_normal``, zero
bias).

The port stores weights the PyTorch way (conv ``(O, I, *k)``, ConvTranspose
``(I, O, *k)``), so PyTorch's own fan rule applies to both as it stands:
fan_in counts weight dim 1 times the receptive field, which for a
ConvTranspose is ``O * prod(k)`` (the JAX package's ``transpose=True``).
Every initializer fills a tensor in place from an explicit generator.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn as nn

Init = Callable[[torch.Tensor, torch.Generator], None]


def normal_002() -> Init:
    """``init.normal_(w, 0.0, 0.02)`` (init_weights 'normal')."""
    def init(w: torch.Tensor, generator: torch.Generator) -> None:
        nn.init.normal_(w, 0.0, 0.02, generator=generator)
    return init


def xavier_normal(gain: float = 1.0) -> Init:
    """``init.xavier_normal_(w, gain)``: std = gain·sqrt(2/(fan_in+fan_out))."""
    def init(w: torch.Tensor, generator: torch.Generator) -> None:
        nn.init.xavier_normal_(w, gain, generator=generator)
    return init


def kaiming_normal(a: float = 0.0) -> Init:
    """``init.kaiming_normal_(w, a=a, mode='fan_in')`` with the leaky-ReLU
    gain sqrt(2/(1+a²))."""
    def init(w: torch.Tensor, generator: torch.Generator) -> None:
        nn.init.kaiming_normal_(w, a=a, mode="fan_in",
                                nonlinearity="leaky_relu", generator=generator)
    return init


def orthogonal(gain: float = 1.0) -> Init:
    """``init.orthogonal_(w, gain)``: ``w.view(dim0, -1)`` orthogonal, i.e.
    (O, fan_in) for a conv and (I, O·prod(k)) for a ConvTranspose."""
    def init(w: torch.Tensor, generator: torch.Generator) -> None:
        nn.init.orthogonal_(w, gain, generator=generator)
    return init


def torch_conv_default() -> Init:
    """PyTorch's conv default: kaiming-uniform(a=sqrt(5)) = U(±1/sqrt(fan_in))."""
    def init(w: torch.Tensor, generator: torch.Generator) -> None:
        nn.init.kaiming_uniform_(w, a=math.sqrt(5), generator=generator)
    return init


def torch_conv_default_bias(b: torch.Tensor, fan_in: int,
                            generator: torch.Generator) -> None:
    """PyTorch's conv bias default: U(±1/sqrt(fan_in)) with the weight's
    fan_in."""
    bound = 1.0 / math.sqrt(fan_in)
    nn.init.uniform_(b, -bound, bound, generator=generator)


def lecun_normal(w: torch.Tensor, generator: torch.Generator) -> None:
    """flax's ``Dense`` default kernel init on a torch ``(out, in)`` weight:
    a normal truncated at ±2 std whose variance after truncation is
    1 / fan_in (std = sqrt(1 / fan_in) / 0.8796...)."""
    std = math.sqrt(1.0 / w.shape[1]) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)


def norm_scale_002(w: torch.Tensor, generator: torch.Generator) -> None:
    """Norm scale ~ N(1.0, 0.02²) (init_weights' BatchNorm branch)."""
    nn.init.normal_(w, 1.0, 0.02, generator=generator)


INIT_TYPES = {
    "normal": normal_002,
    "xavier": xavier_normal,
    "kaiming": kaiming_normal,
    "orthogonal": orthogonal,
}


def conv_kernel_init(init_type: str) -> Init:
    """The reference's ``init_type`` names, and ``"torch_default"``, to a
    weight initializer."""
    if init_type == "torch_default":
        return torch_conv_default()
    try:
        return INIT_TYPES[init_type]()
    except KeyError:
        raise NotImplementedError(
            f"initialization method [{init_type}] is not implemented"
        ) from None


def init_conv_(weight: nn.Parameter, bias: Optional[nn.Parameter],
               init_type: str, generator: torch.Generator) -> None:
    """A conv's weight by ``init_type``, then its bias by PyTorch's default
    (init_weights never touches conv biases), drawn in that order."""
    with torch.no_grad():
        conv_kernel_init(init_type)(weight, generator)
        if bias is not None:
            torch_conv_default_bias(bias, weight[0].numel(), generator)

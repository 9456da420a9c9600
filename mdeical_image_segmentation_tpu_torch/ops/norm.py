"""Channels-last GroupNorm forward: two CUDA kernels and their plain
versions (the JAX package's ``ops/norm.py``).

The math is the JAX package's: one pass over x gives per-(sample, channel)
fp32 sums Σx and Σx² (``gn_channel_sums``, kernel ``_stats_kernel`` there);
the group combine runs on the tiny (N, C) arrays, with the biased variance
``max(0, E[x²] − mean²)`` and ``rsqrt(var + eps)`` (``group_stats``); the
affine coefficients are ``a = inv·γ``, ``b = β − mean·a``
(``gn_affine_coeffs``); one more pass writes ``y = x·a + b`` in x's dtype
(``gn_affine``, kernel ``_affine_kernel`` there).  Full-size tensors are
read and written in their own dtype; fp32 lives only on the statistics.

``gn_channel_sums`` and ``gn_affine`` dispatch by the device of x alone: a
CUDA tensor launches the kernel in ``csrc/group_norm.cu`` (or raises), a CPU
tensor runs the plain PyTorch version.  Each keeps a ``.launches`` count.
Only the forward is ported: the kernels' backward comes with 3D training,
so a CUDA call that autograd would need to differentiate raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from . import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_NT = 256              # threads per block of the kernels
_STATS_ROWS = 64       # rows per thread the stats kernel aims for
_AFFINE_ROWS = 16      # rows per thread of the affine kernel
_MAX_PARTIALS = 2**21  # cap on the stats scratch per sample and statistic


def _spatial_dims(x: torch.Tensor) -> Tuple[int, ...]:
    return tuple(range(1, x.ndim - 1))


def _grid(rows: int, c: int, rows_per_thread: int, cap: Optional[int]) -> int:
    """Blocks per sample: each block takes a contiguous run of rows, its
    threads laid out as (256 // min(C, 256)) row lanes x min(C, 256)
    channel lanes (the kernels' own map)."""
    lanes = _NT // min(c, _NT)
    g = -(-rows // (lanes * rows_per_thread))
    if cap is not None:
        g = min(g, max(1, cap // c))
    return max(1, g)


def _check_cuda(name: str, x: torch.Tensor, *coeffs: torch.Tensor) -> None:
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name} takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous")
    if x.ndim < 3 or x.numel() == 0:
        raise ValueError(f"{name}: x must be a non-empty (N, ..., C) "
                         f"tensor, got {tuple(x.shape)}")
    n, c = x.shape[0], x.shape[-1]
    for t in coeffs:
        if (t.device != x.device or t.dtype != torch.float32
                or tuple(t.shape) != (n, c) or not t.is_contiguous()):
            raise ValueError(f"{name}: coefficients must be contiguous "
                             f"float32 ({n}, {c}) on {x.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, *coeffs)):
        raise RuntimeError(f"{name}: the CUDA kernel has no backward yet; "
                           "run it under torch.no_grad/inference_mode")


def gn_channel_sums_reference(x: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Σx, Σx²) over the spatial dims, per (sample, channel), fp32 (N, C).
    One sample at a time, so the fp32 temporaries stay a sample's size."""
    dims = tuple(d - 1 for d in _spatial_dims(x))
    s1, s2 = [], []
    for xn in x:
        xf = xn.float()
        s1.append(xf.sum(dims))
        s2.append(xf.square().sum(dims))
    return torch.stack(s1), torch.stack(s2)


def gn_channel_sums(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(sample, channel) fp32 Σx and Σx² of a channels-last x
    (N, *spatial, C), float32 or bfloat16."""
    if x.device.type == "cpu":
        return gn_channel_sums_reference(x)
    if not x.is_cuda:
        raise ValueError(f"gn_channel_sums runs on cuda or cpu, not {x.device}")
    _check_cuda("gn_channel_sums", x)
    n, c = x.shape[0], x.shape[-1]
    rows = x.numel() // (n * c)
    g = _grid(rows, c, _STATS_ROWS, _MAX_PARTIALS)
    partial = torch.empty((2, n, c, g), dtype=torch.float32, device=x.device)
    s1 = torch.empty((n, c), dtype=torch.float32, device=x.device)
    s2 = torch.empty_like(s1)
    lib = _build.load()
    rc = lib.tpuseg_gn_stats(
        x.data_ptr(), partial.data_ptr(), s1.data_ptr(), s2.data_ptr(), n,
        rows, c, g, _DTYPE_CODES[x.dtype], x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, "gn_stats launch")
    gn_channel_sums.launches += 1
    return s1, s2


gn_channel_sums.launches = 0


def gn_affine_reference(x: torch.Tensor, a: torch.Tensor,
                        b: torch.Tensor) -> torch.Tensor:
    """``x·a + b`` per (sample, channel) in fp32, rounded to x's dtype."""
    shape = (x.shape[0],) + (1,) * (x.ndim - 2) + (x.shape[-1],)
    y = x.to(torch.float32, copy=True)  # one fp32 temporary, then in place
    return y.mul_(a.reshape(shape)).add_(b.reshape(shape)).to(x.dtype)


def gn_affine(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor
              ) -> torch.Tensor:
    """y = x·a + b with (N, C) fp32 coefficients, y in x's dtype."""
    if x.device.type == "cpu":
        return gn_affine_reference(x, a, b)
    if not x.is_cuda:
        raise ValueError(f"gn_affine runs on cuda or cpu, not {x.device}")
    _check_cuda("gn_affine", x, a, b)
    n, c = x.shape[0], x.shape[-1]
    rows = x.numel() // (n * c)
    y = torch.empty_like(x)
    lib = _build.load()
    rc = lib.tpuseg_gn_affine(
        x.data_ptr(), a.data_ptr(), b.data_ptr(), y.data_ptr(), n, rows, c,
        _grid(rows, c, _AFFINE_ROWS, None), _DTYPE_CODES[x.dtype],
        x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, "gn_affine launch")
    gn_affine.launches += 1
    return y


gn_affine.launches = 0


def group_stats(s1: torch.Tensor, s2: torch.Tensor, num_groups: int,
                count: int, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Channel sums → per-channel fp32 (mean, rsqrt(var + eps)), (N, C);
    ``count`` is the number of spatial positions."""
    n, c = s1.shape
    cg = c // num_groups
    m = float(count * cg)
    mean = s1.reshape(n, num_groups, cg).sum(-1) / m
    var = torch.clamp(s2.reshape(n, num_groups, cg).sum(-1) / m
                      - mean * mean, min=0.0)
    inv = torch.rsqrt(var + eps)
    return (mean.repeat_interleave(cg, dim=-1),
            inv.repeat_interleave(cg, dim=-1))


def gn_affine_coeffs(mean_c: torch.Tensor, inv_c: torch.Tensor,
                     scale: torch.Tensor, bias: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """y = a·x + b coefficients, fp32 (N, C)."""
    a = inv_c * scale.float()[None]
    b = bias.float()[None] - mean_c * a
    return a, b


def group_norm_coeffs(x: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor, num_groups: int, eps: float
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (a, b) of GroupNorm on x: the stats kernel, then the (N, C)
    algebra."""
    c = x.shape[-1]
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by num_groups "
                         f"{num_groups}")
    s1, s2 = gn_channel_sums(x)
    mean_c, inv_c = group_stats(s1, s2, num_groups,
                                x.numel() // (x.shape[0] * c), eps)
    return gn_affine_coeffs(mean_c, inv_c, scale, bias)


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               num_groups: int, eps: float) -> torch.Tensor:
    """GroupNorm over contiguous channel groups of the trailing axis; the
    output has x's dtype, statistics and elementwise math are fp32."""
    a, b = group_norm_coeffs(x, scale, bias, num_groups, eps)
    return gn_affine(x, a, b)


class GroupNorm(nn.Module):
    """``nn.GroupNorm`` on channels-last tensors, with the JAX package's
    defaults: ``epsilon`` 1e-5 (torch's), parameters fp32 ones and zeros
    under the flax names' counterparts (``weight`` ↔ ``scale``, ``bias``),
    and ``dtype`` the output dtype (None: x's dtype promoted with fp32)."""

    def __init__(self, num_channels: int, num_groups: int = 32,
                 epsilon: float = 1e-5, dtype: Optional[torch.dtype] = None,
                 *, device=None):
        super().__init__()
        if num_channels % num_groups:
            raise ValueError(f"channels {num_channels} not divisible by "
                             f"num_groups {num_groups}")
        self.num_groups = num_groups
        self.epsilon = epsilon
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(num_channels, device=device))
        self.bias = nn.Parameter(torch.zeros(num_channels, device=device))

    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = group_norm(x.contiguous(), self.weight, self.bias,
                       self.num_groups, self.epsilon)
        out = self.dtype or torch.promote_types(x.dtype, torch.float32)
        return y.to(out)

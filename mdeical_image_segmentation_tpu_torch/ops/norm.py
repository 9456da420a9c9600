"""Channels-last GroupNorm: four CUDA kernels, their plain versions and
the autograd ``Function`` around them (the JAX package's ``ops/norm.py``).

The math is the JAX package's: one pass over x gives per-(sample, channel)
fp32 sums Σx and Σx² (``gn_channel_sums``, kernel ``_stats_kernel`` there);
the group combine runs on the tiny (N, C) arrays, with the biased variance
``max(0, E[x²] − mean²)`` and ``rsqrt(var + eps)`` (``group_stats``); the
affine coefficients are ``a = inv·γ``, ``b = β − mean·a``
(``gn_affine_coeffs``); one more pass writes ``y = x·a + b`` in x's dtype
(``gn_affine``, kernel ``_affine_kernel`` there).  Full-size tensors are
read and written in their own dtype; fp32 lives only on the statistics.

The backward is the JAX package's Pallas one (``_gn_bwd_pallas``): the
residual is ``(x, mean_c, inv_c, scale)``, so nothing full-size is saved
beyond x; one pass over (x, g) gives per-(sample, channel) fp32 Σg and Σg·x̂,
x̂ = (x − mean)·inv formed in registers (``gn_bwd_reduce``, kernel
``_bwd_reduce_kernel`` there); dbias and dscale are their sums over the
samples; the (N, C) algebra ``gn_bwd_coeffs`` gives A, C, D; one more pass
writes ``dx = g·A + x·C + D`` in x's dtype (``gn_bwd_dx``, kernel
``_bwd_dx_kernel`` there).  ``group_norm`` is a ``torch.autograd.Function``
that runs those kernels forward and backward.

The four wrappers dispatch by the device of x alone: a CUDA tensor launches
the kernel in ``csrc/group_norm.cu`` (or raises), a CPU tensor runs the plain
PyTorch version.  Each keeps a ``.launches`` count.  Called directly on a
tensor that autograd would have to differentiate, a CUDA wrapper raises: the
gradient runs through ``group_norm`` (``GroupNorm``) or
``fused_conv.gcr_fused_conv``.
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


def _check_cuda(name: str, x: torch.Tensor, *coeffs: torch.Tensor,
                g: Optional[torch.Tensor] = None) -> None:
    """The CUDA wrappers' argument checks: x (and g, x's twin in the
    backward) full-size, contiguous, float32 or bfloat16; the (N, C)
    coefficients contiguous fp32; no tensor that autograd tracks."""
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name} takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous")
    if x.ndim < 3 or x.numel() == 0:
        raise ValueError(f"{name}: x must be a non-empty (N, ..., C) "
                         f"tensor, got {tuple(x.shape)}")
    if g is not None and (g.shape != x.shape or g.dtype != x.dtype
                          or g.device != x.device or not g.is_contiguous()):
        raise ValueError(f"{name}: g must be a contiguous {x.dtype} "
                         f"{tuple(x.shape)} tensor on {x.device}")
    n, c = x.shape[0], x.shape[-1]
    for t in coeffs:
        if (t.device != x.device or t.dtype != torch.float32
                or tuple(t.shape) != (n, c) or not t.is_contiguous()):
            raise ValueError(f"{name}: coefficients must be contiguous "
                             f"float32 ({n}, {c}) on {x.device}")
    tracked = (x, *coeffs) if g is None else (x, g, *coeffs)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tracked):
        raise RuntimeError(
            f"{name}: the raw kernel wrapper has no backward; train through "
            "group_norm / GroupNorm or fused_conv.gcr_fused_conv (autograd "
            "Functions), or call it under torch.no_grad/inference_mode")


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


def gn_bwd_reduce_reference(x: torch.Tensor, g: torch.Tensor,
                            mean_c: torch.Tensor, inv_c: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Σg, Σg·x̂) over the spatial dims, x̂ = (x − mean)·inv, fp32 (N, C).
    One sample at a time, so the fp32 temporaries stay a sample's size."""
    dims = tuple(d - 1 for d in _spatial_dims(x))
    c1, c2 = [], []
    for xn, gn, m, v in zip(x, g, mean_c, inv_c):
        gf = gn.float()
        xhat = xn.to(torch.float32, copy=True).sub_(m).mul_(v)
        c1.append(gf.sum(dims))
        c2.append(xhat.mul_(gf).sum(dims))
    return torch.stack(c1), torch.stack(c2)


def gn_bwd_reduce(x: torch.Tensor, g: torch.Tensor, mean_c: torch.Tensor,
                  inv_c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(sample, channel) fp32 Σg and Σg·x̂ of channels-last x and g
    (N, *spatial, C), one dtype (float32 or bfloat16); x̂ = (x − mean)·inv
    with (N, C) fp32 ``mean_c`` and ``inv_c``."""
    if x.device.type == "cpu":
        return gn_bwd_reduce_reference(x, g, mean_c, inv_c)
    if not x.is_cuda:
        raise ValueError(f"gn_bwd_reduce runs on cuda or cpu, not {x.device}")
    _check_cuda("gn_bwd_reduce", x, mean_c, inv_c, g=g)
    n, c = x.shape[0], x.shape[-1]
    rows = x.numel() // (n * c)
    grid = _grid(rows, c, _STATS_ROWS, _MAX_PARTIALS)
    partial = torch.empty((2, n, c, grid), dtype=torch.float32,
                          device=x.device)
    c1 = torch.empty((n, c), dtype=torch.float32, device=x.device)
    c2 = torch.empty_like(c1)
    lib = _build.load()
    rc = lib.tpuseg_gn_bwd_reduce(
        x.data_ptr(), g.data_ptr(), mean_c.data_ptr(), inv_c.data_ptr(),
        partial.data_ptr(), c1.data_ptr(), c2.data_ptr(), n, rows, c, grid,
        _DTYPE_CODES[x.dtype], x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, "gn_bwd_reduce launch")
    gn_bwd_reduce.launches += 1
    return c1, c2


gn_bwd_reduce.launches = 0


def gn_bwd_dx_reference(x: torch.Tensor, g: torch.Tensor, a: torch.Tensor,
                        c: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """``g·A + x·C + D`` per (sample, channel) in fp32 (each product and
    sum rounded on its own, in that order), rounded to x's dtype."""
    shape = (x.shape[0],) + (1,) * (x.ndim - 2) + (x.shape[-1],)
    dx = g.to(torch.float32, copy=True).mul_(a.reshape(shape))
    dx.add_(x.float() * c.reshape(shape))
    return dx.add_(d.reshape(shape)).to(x.dtype)


def gn_bwd_dx(x: torch.Tensor, g: torch.Tensor, a: torch.Tensor,
              c: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """dx = g·A + x·C + D with (N, C) fp32 coefficients, dx in x's dtype."""
    if x.device.type == "cpu":
        return gn_bwd_dx_reference(x, g, a, c, d)
    if not x.is_cuda:
        raise ValueError(f"gn_bwd_dx runs on cuda or cpu, not {x.device}")
    _check_cuda("gn_bwd_dx", x, a, c, d, g=g)
    n, ch = x.shape[0], x.shape[-1]
    rows = x.numel() // (n * ch)
    dx = torch.empty_like(x)
    lib = _build.load()
    rc = lib.tpuseg_gn_bwd_dx(
        x.data_ptr(), g.data_ptr(), a.data_ptr(), c.data_ptr(), d.data_ptr(),
        dx.data_ptr(), n, rows, ch, _grid(rows, ch, _AFFINE_ROWS, None),
        _DTYPE_CODES[x.dtype], x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, "gn_bwd_dx launch")
    gn_bwd_dx.launches += 1
    return dx


gn_bwd_dx.launches = 0


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


def gn_bwd_coeffs(c1: torch.Tensor, c2: torch.Tensor, mean_c: torch.Tensor,
                  inv_c: torch.Tensor, scale: torch.Tensor, num_groups: int,
                  m: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dx = A·g + C·x + D coefficients, fp32 (N, C), from the channel sums
    c1 = Σg and c2 = Σg·x̂; ``m`` is the number of elements of a group."""
    n, c = c1.shape
    cg = c // num_groups
    sf = scale.float()[None]
    g1 = ((c1 * sf).reshape(n, num_groups, cg).sum(-1) / m
          ).repeat_interleave(cg, dim=-1)
    g2 = ((c2 * sf).reshape(n, num_groups, cg).sum(-1) / m
          ).repeat_interleave(cg, dim=-1)
    a = inv_c * sf
    cc = -(inv_c * inv_c) * g2
    dd = -inv_c * g1 - mean_c * cc
    return a, cc, dd


def group_norm_stats(x: torch.Tensor, num_groups: int, eps: float
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel fp32 (mean, rsqrt(var + eps)) of GroupNorm on x, (N, C):
    the statistics kernel, then the (N, C) group combine."""
    c = x.shape[-1]
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by num_groups "
                         f"{num_groups}")
    s1, s2 = gn_channel_sums(x)
    return group_stats(s1, s2, num_groups, x.numel() // (x.shape[0] * c), eps)


def group_norm_backward(x: torch.Tensor, g: torch.Tensor,
                        mean_c: torch.Tensor, inv_c: torch.Tensor,
                        scale: torch.Tensor, num_groups: int, need_dx: bool
                        ) -> Tuple[Optional[torch.Tensor], torch.Tensor,
                                   torch.Tensor]:
    """(dx or None, dscale, dbias) of GroupNorm from its residual
    ``(x, mean_c, inv_c, scale)`` and the output gradient g: the reduction
    kernel, the (N, C) algebra, then the dx kernel (skipped when x needs no
    gradient)."""
    g = g.to(x.dtype).contiguous()
    c1, c2 = gn_bwd_reduce(x, g, mean_c, inv_c)
    dbias = c1.sum(0).to(scale.dtype)
    dscale = c2.sum(0).to(scale.dtype)
    if not need_dx:
        return None, dscale, dbias
    m = float(x.numel() // (x.shape[0] * num_groups))
    a, cc, dd = gn_bwd_coeffs(c1, c2, mean_c, inv_c, scale, num_groups, m)
    return gn_bwd_dx(x, g, a, cc, dd), dscale, dbias


class _GroupNormFn(torch.autograd.Function):
    """GroupNorm with the JAX package's custom VJP (Pallas residual)."""

    @staticmethod
    def forward(ctx, x, scale, bias, num_groups, eps):
        mean_c, inv_c = group_norm_stats(x, num_groups, eps)
        a, b = gn_affine_coeffs(mean_c, inv_c, scale, bias)
        ctx.save_for_backward(x, mean_c, inv_c, scale)
        ctx.num_groups = num_groups
        return gn_affine(x, a, b)

    @staticmethod
    def backward(ctx, g):
        x, mean_c, inv_c, scale = ctx.saved_tensors
        dx, dscale, dbias = group_norm_backward(
            x, g, mean_c, inv_c, scale, ctx.num_groups,
            ctx.needs_input_grad[0])
        return dx, dscale, dbias, None, None


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               num_groups: int, eps: float) -> torch.Tensor:
    """GroupNorm over contiguous channel groups of the trailing axis of a
    contiguous x; the output has x's dtype, statistics and elementwise math
    are fp32.  Differentiable in x, scale and bias."""
    return _GroupNormFn.apply(x, scale, bias, num_groups, eps)


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

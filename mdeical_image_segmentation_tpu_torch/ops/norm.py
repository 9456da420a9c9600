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
PyTorch version.  The two forward ones run as ``torch.library`` custom ops
(``tpuseg::gn_channel_sums``, ``tpuseg::gn_affine``: the plain version on
the CPU, the launch on CUDA, shapes alone under a fake tensor), so
``torch.export`` records them and an exported program launches the kernels
(``export.py``); a CPU call that autograd records takes the plain version
directly.  Each keeps a ``.launches`` count, split by x's dtype in
``.launches_by_dtype``.  Called directly on a
tensor that autograd would have to differentiate, a CUDA wrapper raises: the
gradient runs through ``group_norm`` (``GroupNorm``) or
``fused_conv.gcr_fused_conv``.

Cross-shard statistics (the JAX package's ``cross_shard_group_stats``, for
spatial sharding, ``parallel/spatial.py``): inside
``cross_shard_group_stats(group, shard_axis, halo, padded_extent)`` every
GroupNorm sums its statistics over the ranks of ``group``, each slab
contributing only the interior rows of its shard axis, so each row of the
volume counts once and the result does not depend on how many ranks share
it.  The JAX package writes this mode in plain jnp; the port keeps its
kernels on it.  Forward: kernel 3a sums the interior rows alone (its
``window``), one all-reduce adds the (N, C) sums over the ranks, and 3b
(or kernel 2's prologue) applies the global coefficients to every row.
Backward: 3c sums over every row (halo outputs reach the loss through the
next convs), one all-reduce adds Σg and Σg·x̂ over the ranks, and 3d writes
``g·A + x·C + D`` on the interior and ``g·A`` on the halo rows, which take
no part in the statistics.  dscale and dbias stay this rank's: the step
averages the gradients over the ranks.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import math
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

from . import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_NT = 256              # threads per block of the dx kernel
_DX_ROWS = 16          # rows per thread of the dx kernel


# rows [lo, hi) along one spatial axis of x: (axis, lo, hi)
Window = Tuple[int, int, int]


def _spatial_dims(x: torch.Tensor) -> Tuple[int, ...]:
    return tuple(range(1, x.ndim - 1))


def _window_dims(x: torch.Tensor, window: Optional[Window]
                 ) -> Tuple[int, int, int, int, int]:
    """(outer, extent, inner, lo, hi) of x (N, ..., C) seen as
    (N, outer, extent, inner, C) around the window's axis; without a window
    the whole of x, (1, S, 1, 0, S)."""
    rows = math.prod(x.shape[1:-1])
    if window is None:
        return 1, rows, 1, 0, rows
    axis, lo, hi = window
    if not 1 <= axis <= x.ndim - 2:
        raise ValueError(f"window axis {axis} is not a spatial axis of a "
                         f"{x.ndim}-d x")
    extent = x.shape[axis]
    if not 0 <= lo < hi <= extent:
        raise ValueError(f"window [{lo}, {hi}) is not within the "
                         f"{extent} rows of axis {axis}")
    return (math.prod(x.shape[1:axis]), extent,
            math.prod(x.shape[axis + 1:-1]), lo, hi)


def _narrow(t: torch.Tensor, window: Optional[Window]) -> torch.Tensor:
    """The window's rows of t, a view (t itself without a window)."""
    if window is None:
        return t
    axis, lo, hi = window
    return t.narrow(axis, lo, hi - lo)


def _grid(rows: int, c: int, rows_per_thread: int) -> int:
    """Blocks per sample of the dx kernel: each block takes a contiguous run
    of rows, its threads laid out as (256 // min(C, 256)) row lanes x
    min(C, 256) channel lanes (the kernel's own map)."""
    lanes = _NT // min(c, _NT)
    return max(1, -(-rows // (lanes * rows_per_thread)))


@functools.lru_cache(maxsize=None)
def _reduce_blocks(dev: int, dtype: int, bwd: bool, n: int, rows: int,
                   c: int, aligned: bool) -> int:
    """Blocks per sample G of the reduction kernel (statistics or, with
    ``bwd``, the backward sums), which the library sizes from the card:
    the same arguments give the same grid, so it is asked once."""
    g = _build.kernel("tpuseg_gn_reduce_blocks")(int(aligned), int(bwd), n,
                                                 rows, c, dtype, dev)
    if g < 0:
        _build.check(-g, "gn_reduce_blocks")
    return g


def _reduce_scratch(x: torch.Tensor, g: Optional[torch.Tensor] = None,
                    window: Optional[Window] = None
                    ) -> Tuple[torch.Tensor, int]:
    """The fp32 scratch (2, N, C, G) of one reduction launch over x (and g),
    or over the window's rows of x, and its G.  A window's walk takes
    16-byte vectors only where a row of the axis (inner · C values) fills
    whole ones, as the launcher decides."""
    n, c = x.shape[0], x.shape[-1]
    outer, _, inner, lo, hi = _window_dims(x, window)
    ptrs = x.data_ptr() | (0 if g is None else g.data_ptr())
    aligned = ptrs % 16 == 0 and (
        window is None or inner * c * x.element_size() % 16 == 0)
    blocks = _reduce_blocks(x.get_device(), _DTYPE_CODES[x.dtype],
                            g is not None, n, outer * (hi - lo) * inner, c,
                            aligned)
    return (torch.empty((2, n, c, blocks), dtype=torch.float32,
                        device=x.device), blocks)


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
    dev = x.device
    for t in coeffs:
        if (t.dtype != torch.float32 or t.shape != (n, c) or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(f"{name}: coefficients must be contiguous "
                             f"float32 ({n}, {c}) on {x.device}")
    tracked = (x, *coeffs) if g is None else (x, g, *coeffs)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tracked):
        raise RuntimeError(
            f"{name}: the raw kernel wrapper has no backward; train through "
            "group_norm / GroupNorm or fused_conv.gcr_fused_conv (autograd "
            "Functions), or call it under torch.no_grad/inference_mode")


def gn_channel_sums_reference(x: torch.Tensor,
                              window: Optional[Window] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Σx, Σx²) over the spatial dims, per (sample, channel), fp32 (N, C);
    with a window, over its rows alone.  One sample at a time, so the fp32
    temporaries stay a sample's size."""
    _window_dims(x, window)  # checks the window
    dims = tuple(d - 1 for d in _spatial_dims(x))
    s1, s2 = [], []
    for xn in _narrow(x, window):
        xf = xn.float()
        s1.append(xf.sum(dims))
        s2.append(xf.square().sum(dims))
    return torch.stack(s1), torch.stack(s2)


def _tracked(*ts: torch.Tensor) -> bool:
    """Whether autograd would have to differentiate a call on ``ts``."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _device_type(x: torch.Tensor, name: str) -> str:
    """x's device type, which a wrapper dispatches on: cuda or cpu."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, not {x.device}")
    return x.device.type


def gn_channel_sums(x: torch.Tensor, window: Optional[Window] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(sample, channel) fp32 Σx and Σx² of a channels-last x
    (N, *spatial, C), float32 or bfloat16; with ``window`` (axis, lo, hi)
    over rows [lo, hi) of that spatial axis alone, read in place.  Runs the
    custom op ``tpuseg::gn_channel_sums`` (a window launches directly)."""
    device = _device_type(x, "gn_channel_sums")
    if device == "cpu" and (_tracked(x) or window is not None):
        return gn_channel_sums_reference(x, window)
    if _tracked(x):
        _check_cuda("gn_channel_sums", x)  # raises: no backward
    if window is not None:
        return _launch_stats(x, window)
    s1, s2 = _channel_sums_op(x)
    return s1, s2


gn_channel_sums.launches = 0
gn_channel_sums.launches_by_dtype = collections.Counter()


@torch.library.custom_op("tpuseg::gn_channel_sums", mutates_args=(),
                         device_types="cpu")
def _channel_sums_op(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return gn_channel_sums_reference(x)


def _launch_stats(x: torch.Tensor, window: Optional[Window] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 3a on a CUDA x, over the window's rows (all of x without
    one)."""
    _check_cuda("gn_channel_sums", x)
    n, c = x.shape[0], x.shape[-1]
    dims = _window_dims(x, window)
    partial, g = _reduce_scratch(x, window=window)
    s1 = torch.empty((n, c), dtype=torch.float32, device=x.device)
    s2 = torch.empty_like(s1)
    dev = x.get_device()
    rc = _build.kernel("tpuseg_gn_stats")(
        x.data_ptr(), partial.data_ptr(), s1.data_ptr(), s2.data_ptr(), n,
        *dims, c, g, _DTYPE_CODES[x.dtype], dev, _build.current_stream(dev))
    _build.check(rc, "gn_stats launch")
    gn_channel_sums.launches += 1
    gn_channel_sums.launches_by_dtype[x.dtype] += 1
    return s1, s2


@_channel_sums_op.register_kernel("cuda")
def _(x):
    return _launch_stats(x)


@_channel_sums_op.register_fake
def _(x):
    shape = (x.shape[0], x.shape[-1])
    return (x.new_empty(shape, dtype=torch.float32),
            x.new_empty(shape, dtype=torch.float32))


def gn_affine_reference(x: torch.Tensor, a: torch.Tensor,
                        b: torch.Tensor) -> torch.Tensor:
    """``x·a + b`` per (sample, channel) in fp32, rounded to x's dtype."""
    shape = (x.shape[0],) + (1,) * (x.ndim - 2) + (x.shape[-1],)
    y = x.to(torch.float32, copy=True)  # one fp32 temporary, then in place
    return y.mul_(a.reshape(shape)).add_(b.reshape(shape)).to(x.dtype)


def gn_affine(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor
              ) -> torch.Tensor:
    """y = x·a + b with (N, C) fp32 coefficients, y in x's dtype.  Runs the
    custom op ``tpuseg::gn_affine``."""
    if _device_type(x, "gn_affine") == "cpu" and _tracked(x, a, b):
        return gn_affine_reference(x, a, b)
    if _tracked(x, a, b):
        _check_cuda("gn_affine", x, a, b)  # raises: no backward
    return _affine_op(x, a, b)


gn_affine.launches = 0
gn_affine.launches_by_dtype = collections.Counter()


@torch.library.custom_op("tpuseg::gn_affine", mutates_args=(),
                         device_types="cpu")
def _affine_op(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor
               ) -> torch.Tensor:
    return gn_affine_reference(x, a, b)


@_affine_op.register_kernel("cuda")
def _(x, a, b):
    _check_cuda("gn_affine", x, a, b)
    n, c = x.shape[0], x.shape[-1]
    y = torch.empty_like(x)
    dev = x.get_device()
    # the kernel sizes its grid from the card
    rc = _build.kernel("tpuseg_gn_affine")(
        x.data_ptr(), a.data_ptr(), b.data_ptr(), y.data_ptr(), n,
        x.numel() // (n * c), c, _DTYPE_CODES[x.dtype], dev,
        _build.current_stream(dev))
    _build.check(rc, "gn_affine launch")
    gn_affine.launches += 1
    gn_affine.launches_by_dtype[x.dtype] += 1
    return y


@_affine_op.register_fake
def _(x, a, b):
    return torch.empty_like(x)


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
    partial, grid = _reduce_scratch(x, g)
    c1 = torch.empty((n, c), dtype=torch.float32, device=x.device)
    c2 = torch.empty_like(c1)
    dev = x.get_device()
    rc = _build.kernel("tpuseg_gn_bwd_reduce")(
        x.data_ptr(), g.data_ptr(), mean_c.data_ptr(), inv_c.data_ptr(),
        partial.data_ptr(), c1.data_ptr(), c2.data_ptr(), n, rows, c, grid,
        _DTYPE_CODES[x.dtype], dev, _build.current_stream(dev))
    _build.check(rc, "gn_bwd_reduce launch")
    gn_bwd_reduce.launches += 1
    gn_bwd_reduce.launches_by_dtype[x.dtype] += 1
    return c1, c2


gn_bwd_reduce.launches = 0
gn_bwd_reduce.launches_by_dtype = collections.Counter()


def gn_bwd_dx_reference(x: torch.Tensor, g: torch.Tensor, a: torch.Tensor,
                        c: torch.Tensor, d: torch.Tensor,
                        window: Optional[Window] = None) -> torch.Tensor:
    """``g·A + x·C + D`` per (sample, channel) in fp32 (each product and
    sum rounded on its own, in that order), rounded to x's dtype; with a
    window, ``x·C + D`` is added on its rows alone and the rest is
    ``g·A``."""
    _window_dims(x, window)  # checks the window
    shape = (x.shape[0],) + (1,) * (x.ndim - 2) + (x.shape[-1],)
    dx = g.to(torch.float32, copy=True).mul_(a.reshape(shape))
    inner = _narrow(dx, window)
    inner.add_(_narrow(x, window).float() * c.reshape(shape))
    inner.add_(d.reshape(shape))
    return dx.to(x.dtype)


def gn_bwd_dx(x: torch.Tensor, g: torch.Tensor, a: torch.Tensor,
              c: torch.Tensor, d: torch.Tensor,
              window: Optional[Window] = None) -> torch.Tensor:
    """dx = g·A + x·C + D with (N, C) fp32 coefficients, dx in x's dtype;
    with ``window`` (axis, lo, hi), C and D apply on rows [lo, hi) of that
    spatial axis alone."""
    if x.device.type == "cpu":
        return gn_bwd_dx_reference(x, g, a, c, d, window)
    if not x.is_cuda:
        raise ValueError(f"gn_bwd_dx runs on cuda or cpu, not {x.device}")
    _check_cuda("gn_bwd_dx", x, a, c, d, g=g)
    n, ch = x.shape[0], x.shape[-1]
    rows = x.numel() // (n * ch)
    dx = torch.empty_like(x)
    dev = x.get_device()
    rc = _build.kernel("tpuseg_gn_bwd_dx")(
        x.data_ptr(), g.data_ptr(), a.data_ptr(), c.data_ptr(), d.data_ptr(),
        dx.data_ptr(), n, *_window_dims(x, window), ch,
        _grid(rows, ch, _DX_ROWS), _DTYPE_CODES[x.dtype], dev,
        _build.current_stream(dev))
    _build.check(rc, "gn_bwd_dx launch")
    gn_bwd_dx.launches += 1
    gn_bwd_dx.launches_by_dtype[x.dtype] += 1
    return dx


gn_bwd_dx.launches = 0
gn_bwd_dx.launches_by_dtype = collections.Counter()


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


# -- cross-shard statistics (spatial sharding) ------------------------------


@dataclasses.dataclass(frozen=True)
class CrossShard:
    """The active cross-shard mode: GroupNorms sum their statistics over the
    ``world`` ranks of ``group`` (None: the default group, or a world of 1
    without one), each slab contributing the interior rows of
    ``shard_axis``, whose halo-padded extent at the model's input is
    ``padded_extent``."""

    group: Any
    world: int
    shard_axis: int
    halo: int
    padded_extent: int


@dataclasses.dataclass(frozen=True)
class Site:
    """One GroupNorm input under the mode: the window of its interior rows
    and the spatial positions of a sample over every rank's interior."""

    mode: CrossShard
    window: Window
    count: int


# Process-wide, not a context variable: a block rematerialized in the
# backward runs on the autograd engine's thread (as parallel.rows_split).
_CROSS_SHARD: Optional[CrossShard] = None


@contextlib.contextmanager
def cross_shard_group_stats(group: Any, shard_axis: int, halo: int,
                            padded_extent: int):
    """Within: every GroupNorm (the module and the fused 'gcr' block) sums
    its statistics over ``group``'s ranks, interior rows of ``shard_axis``
    only (the model's input is ``padded_extent`` rows along it, ``halo`` of
    them on each side).  Every rank enters it for the same forward and
    backward."""
    global _CROSS_SHARD
    prev = _CROSS_SHARD
    world = dist.get_world_size(group) if dist.is_initialized() else 1
    _CROSS_SHARD = CrossShard(group, world, shard_axis, halo, padded_extent)
    try:
        yield
    finally:
        _CROSS_SHARD = prev


def cross_shard_site(x: torch.Tensor) -> Optional[Site]:
    """x's ``Site`` under the active mode (None outside it), with the JAX
    package's checks: the extent along the shard axis divides the padded
    input's, the halo divides by the pooling factor, interior rows
    remain."""
    mode = _CROSS_SHARD
    if mode is None:
        return None
    axis = mode.shard_axis
    e = x.shape[axis]
    if mode.padded_extent % e:
        raise ValueError(
            f"GroupNorm site extent {e} does not divide the halo-padded "
            f"input extent {mode.padded_extent} along shard axis {axis}")
    f = mode.padded_extent // e
    if mode.halo % f:
        raise ValueError(
            f"halo {mode.halo} not divisible by the pooling factor {f} at a "
            f"GroupNorm site — choose a halo divisible by "
            f"2**(num_levels - 1) for cross-shard statistics")
    lh = mode.halo // f
    if e - 2 * lh <= 0:
        raise ValueError(
            f"halo {lh} leaves no interior rows at GroupNorm extent {e}")
    other = math.prod(x.shape[a] for a in _spatial_dims(x) if a != axis)
    return Site(mode, (axis, lh, e - lh), other * (e - 2 * lh) * mode.world)


def _rank_sum(c1: torch.Tensor, c2: torch.Tensor, site: Site
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two (N, C) sums added over the site's ranks, in one all-reduce."""
    if site.mode.world == 1:
        return c1, c2
    both = torch.stack((c1, c2))
    dist.all_reduce(both, group=site.mode.group)
    return both[0], both[1]


def group_norm_stats(x: torch.Tensor, num_groups: int, eps: float,
                     site: Optional[Site] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel fp32 (mean, rsqrt(var + eps)) of GroupNorm on x, (N, C):
    the statistics kernel, then the (N, C) group combine.  At a cross-shard
    ``site``: the kernel on the interior rows, the sums added over the
    ranks, the combine over every rank's interior."""
    c = x.shape[-1]
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by num_groups "
                         f"{num_groups}")
    if site is not None:
        s1, s2 = _rank_sum(*gn_channel_sums(x, site.window), site)
        return group_stats(s1, s2, num_groups, site.count, eps)
    s1, s2 = gn_channel_sums(x)
    # the spatial size from the static dims (a traced batch stays symbolic)
    return group_stats(s1, s2, num_groups, math.prod(x.shape[1:-1]), eps)


def group_norm_backward(x: torch.Tensor, g: torch.Tensor,
                        mean_c: torch.Tensor, inv_c: torch.Tensor,
                        scale: torch.Tensor, num_groups: int, need_dx: bool,
                        site: Optional[Site] = None
                        ) -> Tuple[Optional[torch.Tensor], torch.Tensor,
                                   torch.Tensor]:
    """(dx or None, dscale, dbias) of GroupNorm from its residual
    ``(x, mean_c, inv_c, scale)`` and the output gradient g: the reduction
    kernel, the (N, C) algebra, then the dx kernel (skipped when x needs no
    gradient).  At a cross-shard ``site``: Σg and Σg·x̂ over every row,
    added over the ranks for dx (the statistics' cotangents come from every
    rank's loss), whose C and D terms apply on the interior rows alone;
    dscale and dbias from this rank's sums."""
    g = g.to(x.dtype).contiguous()
    c1, c2 = gn_bwd_reduce(x, g, mean_c, inv_c)
    dbias = c1.sum(0).to(scale.dtype)
    dscale = c2.sum(0).to(scale.dtype)
    if not need_dx:
        return None, dscale, dbias
    if site is None:
        m = float(x.numel() // (x.shape[0] * num_groups))
        window = None
    else:
        c1, c2 = _rank_sum(c1, c2, site)
        m = float(site.count * (x.shape[-1] // num_groups))
        window = site.window
    a, cc, dd = gn_bwd_coeffs(c1, c2, mean_c, inv_c, scale, num_groups, m)
    return gn_bwd_dx(x, g, a, cc, dd, window), dscale, dbias


def _group_norm_forward(x, scale, bias, num_groups, eps, site):
    """(y, mean_c, inv_c): the statistics kernel, the (N, C) coefficients,
    the affine kernel (on every row, at a cross-shard site too)."""
    mean_c, inv_c = group_norm_stats(x, num_groups, eps, site)
    a, b = gn_affine_coeffs(mean_c, inv_c, scale, bias)
    return gn_affine(x, a, b), mean_c, inv_c


class _GroupNormFn(torch.autograd.Function):
    """GroupNorm with the JAX package's custom VJP (Pallas residual); with a
    cross-shard ``site``, the statistics over every rank's interior rows
    (the JAX package's ``_cross_shard_group_norm``, differentiated there
    through ``psum``): the same kernels, the site's window and all-reduces.
    The site is kept for the backward, which may run on another thread."""

    @staticmethod
    def forward(ctx, x, scale, bias, num_groups, eps, site):
        y, mean_c, inv_c = _group_norm_forward(x, scale, bias, num_groups,
                                               eps, site)
        ctx.save_for_backward(x, mean_c, inv_c, scale)
        ctx.num_groups, ctx.site = num_groups, site
        return y

    @staticmethod
    def backward(ctx, g):
        x, mean_c, inv_c, scale = ctx.saved_tensors
        dx, dscale, dbias = group_norm_backward(
            x, g, mean_c, inv_c, scale, ctx.num_groups,
            ctx.needs_input_grad[0], ctx.site)
        return dx, dscale, dbias, None, None, None


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               num_groups: int, eps: float) -> torch.Tensor:
    """GroupNorm over contiguous channel groups of the trailing axis of a
    contiguous x; the output has x's dtype, statistics and elementwise math
    are fp32.  Differentiable in x, scale and bias; a call that autograd
    need not record runs the forward alone, the same calls in the same
    order.  Inside ``cross_shard_group_stats`` the statistics span the
    ranks."""
    site = cross_shard_site(x)
    if _tracked(x, scale, bias):
        return _GroupNormFn.apply(x, scale, bias, num_groups, eps, site)
    return _group_norm_forward(x, scale, bias, num_groups, eps, site)[0]


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
        # parallel imports this module: import late
        from ..parallel.tensor import full_param

        # sharded over a model axis (parallel/tensor.py): the whole scale
        # and bias, the full tensor normalized on every model rank
        y = group_norm(x.contiguous(), full_param(self, "weight"),
                       full_param(self, "bias"), self.num_groups,
                       self.epsilon)
        out = self.dtype or torch.promote_types(x.dtype, torch.float32)
        return y.to(out)

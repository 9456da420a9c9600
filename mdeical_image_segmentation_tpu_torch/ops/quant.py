"""Post-training int8 quantization (W8A8) of the conv inference path (the
JAX package's ``ops/quant.py``).

Scheme, as in the JAX package:

* weights: symmetric per-output-channel int8, the scales taken from the
  float kernel (``_weight_quant``), quantized once per conv and weight
  version and cached on the conv;
* activations: symmetric per-tensor int8 with STATIC scales, the running
  absmax of each conv's input over calibration batches (``calibrate``),
  kept outside the parameters in a dict keyed by the conv's module path
  (the path ``utils/param_bridge.py`` gives its weight, without flax's
  inner ``Conv_0``; relative to a ``UNetModel``'s ``module``), so
  checkpoints and ``state_dict`` keys stay as they are;
* an exact s8 x s8 -> s32 convolution, then ``float(acc) * (x_scale *
  w_scale[co]) + bias[co]`` in float32, rounded to the conv's compute dtype.
  Norms, activations, pools and transposed convs stay float; convs with
  fewer than ``MIN_QUANT_CIN`` input channels (the stems) stay float too.

The mode (``off`` | ``calib`` | ``int8``) and the scales ride a
``contextvars.ContextVar`` that ``TorchConv.forward`` reads at call time
(``models/layers2d.py``)::

    scales = calibrate(lambda x: model(x), model, [x1, x2])
    with quant_mode("int8", scales, model):
        y = model(x)

``int8_conv`` is the quantized conv: on a CUDA tensor two hand-written
kernels in ``csrc/int8_conv.cu``, ``int8_quantize`` (x to int8, once per
call) and the tensor-core conv of the int8 values (the float32 rescale and
bias in its epilogue); on a CPU tensor its plain version
``int8_conv_reference`` (``_act_quant``, an exact integer conv as a float64
conv of the int8 values, then the same epilogue in separate float32 ops).
The two agree to the bit.  The JAX package leaves this conv to XLA; there is
no TPU kernel behind it.  On a CUDA tensor a shape the kernel does not take
(a stride, an asymmetric padding) raises ``NotImplementedError``.
``int8_conv.launches`` and ``int8_quantize.launches`` count kernel launches,
one each per conv call.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import (Callable, Dict, Iterable, NamedTuple, Optional, Sequence,
                    Tuple)

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import _build

MODES = ("off", "calib", "int8")

#: convs with Ci below this stay float (stem convs: negligible FLOPs,
#: widest dynamic range).
MIN_QUANT_CIN = 8

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}


class _State(NamedTuple):
    scales: Optional[Dict[str, torch.Tensor]]  # module path -> x absmax
    paths: Dict[int, str]                       # id(module) -> module path


_mode_var: contextvars.ContextVar = contextvars.ContextVar(
    "tpuseg_torch_quant_mode", default="off")
_state_var: contextvars.ContextVar = contextvars.ContextVar(
    "tpuseg_torch_quant_state", default=None)


def mode() -> str:
    """Current quantization mode ('off' | 'calib' | 'int8')."""
    return _mode_var.get()


def _module_paths(model: nn.Module) -> Dict[int, str]:
    """``id(module) -> path`` over ``model``, the paths ``param_bridge``
    gives the weights (a ``UNetModel``'s are relative to its ``module``)."""
    root = getattr(model, "module", None)
    if not isinstance(root, nn.Module):
        root = model
    return {id(m): name for name, m in root.named_modules()}


@contextlib.contextmanager
def quant_mode(m: str, scales: Optional[Dict[str, torch.Tensor]] = None,
               model: Optional[nn.Module] = None):
    """Run the body in mode ``m``.  Under 'calib' the convs of ``model``
    record their input absmax into ``scales`` (updated in place); under
    'int8' they read it from there."""
    if m not in MODES:
        raise ValueError(f"quant mode {m!r} not in {MODES}")
    state = None if model is None else _State(scales, _module_paths(model))
    token = _mode_var.set(m)
    state_token = _state_var.set(state)
    try:
        yield
    finally:
        _state_var.reset(state_token)
        _mode_var.reset(token)


def wrap_apply(fn: Callable, m: str,
               scales: Optional[Dict[str, torch.Tensor]] = None,
               model: Optional[nn.Module] = None) -> Callable:
    """``fn`` running under ``quant_mode(m, scales, model)``."""

    def wrapped(*args, **kwargs):
        with quant_mode(m, scales, model):
            return fn(*args, **kwargs)

    return wrapped


def quantizable(kernel_size: Sequence[int], in_channels: int) -> bool:
    """Whether ``TorchConv`` routes this conv through the int8 path."""
    return len(kernel_size) in (2, 3) and in_channels >= MIN_QUANT_CIN


def _conv_path(module: nn.Module) -> str:
    state = _state_var.get()
    path = None if state is None else state.paths.get(id(module))
    if path is None or state.scales is None:
        raise ValueError(
            f"quant mode {mode()!r} needs the model and its scales dict: "
            "run under quant_mode(mode, scales, model) with the model that "
            "holds this conv")
    return path


def observe(module: nn.Module, x: torch.Tensor) -> None:
    """Calib mode: fold ``max |x|`` into the running absmax of ``module``
    (on x's device; nothing waits for it)."""
    path = _conv_path(module)
    scales = _state_var.get().scales
    absmax = x.detach().abs().amax().to(torch.float32)
    prev = scales.get(path)
    scales[path] = absmax if prev is None else torch.maximum(prev, absmax)


def x_scale(module: nn.Module) -> torch.Tensor:
    """Int8 mode: ``max(absmax, 1e-12) / 127`` of ``module``'s input, a
    0-d float32 tensor; raises when the module was never calibrated."""
    path = _conv_path(module)
    absmax = _state_var.get().scales.get(path)
    if absmax is None:
        raise ValueError(
            "int8 inference requires calibrated activation scales: run "
            "ops.quant.calibrate(...) and pass its scales to quant_mode "
            f"(missing at {path})")
    return torch.clamp_min(absmax.to(torch.float32), 1e-12) / 127.0


def _act_quant(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    x32 = x.to(torch.float32) / scale
    return torch.clamp(torch.round(x32), -127.0, 127.0).to(torch.int8)


def _weight_quant(weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 of a (O, I, *k) weight: returns
    (w_q (O, I, *k) int8, w_scale (O,) float32)."""
    k32 = weight.detach().to(torch.float32)
    absmax = k32.abs().amax(dim=tuple(range(1, k32.ndim)))
    w_scale = torch.clamp_min(absmax, 1e-12) / 127.0
    shape = (-1,) + (1,) * (k32.ndim - 1)
    w_q = torch.clamp(torch.round(k32 / w_scale.reshape(shape)), -127.0,
                      127.0).to(torch.int8)
    return w_q, w_scale


class QuantizedWeight(NamedTuple):
    w_q: torch.Tensor      # (O, I, *k) int8
    w_scale: torch.Tensor  # (O,) float32
    # the gather loop's layout: (O, Kp) int8, row k = tap * I + i with the
    # taps in (kd, kh, kw) order, zero-padded to Kp = K rounded up to 16
    packed: Optional[torch.Tensor]
    # the halo loop's layout: (taps, O, I rounded up to 32) int8, the taps
    # in (kd, kh, kw) order, zero pad channels
    taps: Optional[torch.Tensor] = None


def quantize_weight(weight: torch.Tensor) -> QuantizedWeight:
    """``_weight_quant`` of ``weight``, plus the kernels' packed layouts
    when the weight lies on a CUDA device."""
    w_q, w_scale = _weight_quant(weight)
    if not w_q.is_cuda:
        return QuantizedWeight(w_q, w_scale, None)
    return QuantizedWeight(w_q, w_scale, pack(w_q), pack_taps(w_q))


def pack(w_q: torch.Tensor) -> torch.Tensor:
    """(O, I, *k) int8 → the gather loop's (O, Kp) layout
    (``QuantizedWeight``)."""
    k = w_q.movedim(1, -1).reshape(w_q.shape[0], -1)
    return F.pad(k, (0, -k.shape[1] % 16)).contiguous()


def pack_taps(w_q: torch.Tensor) -> torch.Tensor:
    """(O, I, *k) int8 → the halo loop's (taps, O, I rounded up to 32)
    layout: one TMA box per tap and 32-channel chunk, no guard."""
    o, i = w_q.shape[:2]
    t = w_q.reshape(o, i, -1).permute(2, 0, 1)
    return F.pad(t, (0, -i % 32)).contiguous()


def _pad_list(pads: Sequence[Tuple[int, int]]):
    """F.pad's list for channels-last x: channels unpadded, last dim first."""
    return [0, 0] + [p for lo_hi in reversed(pads) for p in lo_hi]


def int8_conv_accumulators(x_q: torch.Tensor, w_q: torch.Tensor,
                           pads: Sequence[Tuple[int, int]],
                           strides: Optional[Sequence[int]] = None,
                           ) -> torch.Tensor:
    """The exact s8 x s8 -> s32 conv (plain): channels-last int8 ``x_q``,
    (O, I, *k) int8 ``w_q``, per-dim (before, after) ``pads``; returns the
    channels-last int32 sums.  A float64 conv of the int values is exact
    while |acc| < 2^53 (here |acc| <= 127^2 * taps * Ci)."""
    nsp = w_q.ndim - 2
    xd = F.pad(x_q.to(torch.float64), _pad_list(pads))
    conv = F.conv2d if nsp == 2 else F.conv3d
    y = conv(xd.movedim(-1, 1), w_q.to(torch.float64),
             stride=tuple(strides) if strides else 1)
    return y.movedim(1, -1).to(torch.int32)


def int8_rescale(acc: torch.Tensor, col_scale: torch.Tensor,
                 bias: Optional[torch.Tensor], out_dtype: torch.dtype,
                 ) -> torch.Tensor:
    """The plain epilogue: ``float(acc) * col_scale``, then ``+ bias``,
    each a float32 op of its own, rounded to ``out_dtype``."""
    y = acc.to(torch.float32) * col_scale
    if bias is not None:
        y = y + bias.to(torch.float32)
    return y.to(out_dtype)


def int8_conv_reference(x: torch.Tensor, qw: QuantizedWeight,
                        x_scale: torch.Tensor, *,
                        pads: Sequence[Tuple[int, int]],
                        strides: Optional[Sequence[int]] = None,
                        bias: Optional[torch.Tensor] = None,
                        out_dtype: Optional[torch.dtype] = None,
                        accumulators: bool = False) -> torch.Tensor:
    """The plain version of :func:`int8_conv`, on any device: x quantized
    by ``_act_quant``, the exact integer conv, then the float32 epilogue
    (its product and its sum as separate ops)."""
    acc = int8_conv_accumulators(_act_quant(x, x_scale), qw.w_q, pads,
                                 strides)
    if accumulators:
        return acc
    return int8_rescale(acc, x_scale * qw.w_scale, bias,
                        out_dtype or x.dtype)


def _check_kernel_shape(x, qw, pads, strides, out_dtype) -> None:
    nsp = qw.w_q.ndim - 2
    ks = tuple(qw.w_q.shape[2:])
    what = (f"int8 conv of x {tuple(x.shape)} {x.dtype} with a {ks} kernel, "
            f"pads {tuple(map(tuple, pads))}, strides {strides}")
    if strides is not None and tuple(strides) != (1,) * nsp:
        raise NotImplementedError(f"{what}: the kernel takes stride 1 only")
    if any(lo != hi for lo, hi in pads):
        raise NotImplementedError(f"{what}: the kernel takes symmetric "
                                  "padding only")
    if x.ndim != nsp + 2 or x.shape[-1] != qw.w_q.shape[1]:
        raise ValueError(f"{what}: x must be (N, *spatial, {qw.w_q.shape[1]})")
    if x.dtype not in _DTYPE_CODES or out_dtype not in _OUT_CODES:
        raise NotImplementedError(f"{what}: the kernel reads float32 or "
                                  f"bfloat16 and writes those or int32, not "
                                  f"{out_dtype}")
    out = [n + 2 * lo - k + 1 for n, (lo, _), k in zip(x.shape[1:-1], pads, ks)]
    if min(out) <= 0 or x.numel() == 0:
        raise ValueError(f"{what}: empty output")
    if x.shape[0] * torch.Size(out).numel() >= 2 ** 31:
        raise NotImplementedError(f"{what}: over 2^31 output positions")
    if 127 * 127 * torch.Size(ks).numel() * x.shape[-1] >= 2 ** 31:
        raise NotImplementedError(f"{what}: its int32 sums could overflow")


def int8_quantize(x: torch.Tensor, x_scale: torch.Tensor) -> torch.Tensor:
    """x (float32 or bfloat16) → ``clamp(rint(x / x_scale), ±127)`` as
    int8, x's shape: on a CUDA tensor the quantize pass of
    ``csrc/int8_conv.cu`` (``x_scale``, a 0-d float32 tensor, read on the
    card), on a CPU tensor its plain version ``_act_quant``.  The two agree
    to the bit."""
    if x.device.type == "cpu":
        return _act_quant(x, x_scale)
    if not x.is_cuda:
        raise ValueError(f"int8_quantize runs on cuda or cpu, not {x.device}")
    if x.dtype not in _DTYPE_CODES or not x.is_contiguous():
        raise ValueError(f"int8_quantize: x must be contiguous float32 or "
                         f"bfloat16, not {x.dtype}")
    if (x_scale.device != x.device or x_scale.dtype != torch.float32
            or x_scale.numel() != 1):
        raise ValueError(f"int8_quantize: x_scale must be one float32 on "
                         f"{x.device}, not {x_scale.dtype} on "
                         f"{x_scale.device}")
    x_q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    dev = x.get_device()
    rc = _build.kernel("tpuseg_int8_quantize")(
        x.data_ptr(), x_q.data_ptr(), x_scale.data_ptr(), x.numel(),
        _DTYPE_CODES[x.dtype], dev, _build.current_stream(dev))
    _build.check(rc, "int8_quantize launch")
    int8_quantize.launches += 1
    return x_q


int8_quantize.launches = 0


def int8_conv(x: torch.Tensor, qw: QuantizedWeight, x_scale: torch.Tensor,
              *, pads: Sequence[Tuple[int, int]],
              strides: Optional[Sequence[int]] = None,
              bias: Optional[torch.Tensor] = None,
              out_dtype: Optional[torch.dtype] = None,
              accumulators: bool = False) -> torch.Tensor:
    """The quantized conv of channels-last ``x`` (float32 or bfloat16):
    x_q = clamp(rint(x / x_scale), ±127), the exact int32 conv with
    ``qw.w_q``, then ``float(acc) * (x_scale * w_scale) + bias`` rounded to
    ``out_dtype`` (x's dtype by default).  ``accumulators=True`` returns the
    int32 sums instead.  ``x_scale`` is a 0-d float32 tensor on x's device
    (read by the kernels there: no host wait).  On the card: one
    ``int8_quantize`` launch, then one conv launch."""
    out_dtype = torch.int32 if accumulators else (out_dtype or x.dtype)
    if x.device.type == "cpu":
        return int8_conv_reference(x, qw, x_scale, pads=pads,
                                   strides=strides, bias=bias,
                                   out_dtype=out_dtype,
                                   accumulators=accumulators)
    if not x.is_cuda:
        raise ValueError(f"int8_conv runs on cuda or cpu, not {x.device}")
    _check_kernel_shape(x, qw, pads, strides, out_dtype)
    if not x.is_contiguous() or qw.packed is None:
        raise ValueError("int8_conv: x must be contiguous and qw made by "
                         "quantize_weight on the card")
    co, ci = qw.w_q.shape[:2]
    ks = tuple(qw.w_q.shape[2:])
    out = [n + 2 * lo - k + 1
           for n, (lo, _), k in zip(x.shape[1:-1], pads, ks)]
    # the kernel's 3D view: 2D is D = 1, KD = 1
    one = (1,) * (3 - len(ks))
    dims = one + tuple(x.shape[1:-1])
    ks = one + ks
    pad3 = (0,) * len(one) + tuple(lo for lo, _ in pads)
    b = None if bias is None else bias.detach().to(torch.float32).contiguous()
    for name, t in (("x_scale", x_scale), ("w_scale", qw.w_scale),
                    ("bias", b), ("packed", qw.packed), ("taps", qw.taps)):
        if t is not None and t.device != x.device:
            raise ValueError(f"int8_conv: {name} is on {t.device}, x on "
                             f"{x.device}")
    if qw.w_scale.dtype != torch.float32 or not qw.w_scale.is_contiguous():
        raise ValueError("int8_conv: w_scale must be contiguous float32")
    x_q = int8_quantize(x, x_scale)
    y = torch.empty((x.shape[0], *out, co), dtype=out_dtype, device=x.device)
    taps = qw.taps
    dev = x.get_device()
    rc = _build.kernel("tpuseg_int8_conv_forward")(
        x_q.data_ptr(), qw.packed.data_ptr(),
        None if taps is None else taps.data_ptr(), x_scale.data_ptr(),
        qw.w_scale.data_ptr(), None if b is None else b.data_ptr(),
        y.data_ptr(), x.shape[0], *dims,
        ci, co, *ks, *pad3, qw.packed.shape[1],
        0 if taps is None else taps.shape[2], _OUT_CODES[out_dtype], dev,
        _build.current_stream(dev))
    _build.check(rc, "int8_conv launch")
    int8_conv.launches += 1
    return y


int8_conv.launches = 0


def calibrate(forward: Callable, model: nn.Module,
              batches: Iterable) -> Dict[str, torch.Tensor]:
    """Run ``forward`` over ``batches`` in calib mode; returns the scales
    (``{module path: x absmax}``, 0-d float32 tensors on the model's
    device), the running absmax over every batch and every call of each
    conv.  A batch that is a tuple is passed as positional arguments."""
    scales: Dict[str, torch.Tensor] = {}
    with quant_mode("calib", scales, model), torch.inference_mode():
        for args in batches:
            forward(*(args if isinstance(args, tuple) else (args,)))
    if not scales:
        raise ValueError("calibration saw no quantizable convs or no batches")
    return scales

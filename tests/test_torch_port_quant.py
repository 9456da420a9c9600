"""The port's int8 post-training quantization ops
(``mdeical_image_segmentation_tpu_torch/ops/quant.py``) against the JAX
package's ``ops/quant.py`` on the same seeded inputs (numpy in, numpy out).

Tolerance: none.  The weight and activation quantization, the int32
accumulators of the s8 conv and the quantized conv's output (fp32, and bf16
with ``dtype=bfloat16``) must equal JAX's to the bit: both divide, round
half to even and clip in float32, the integer sum is exact, and the epilogue
is one float32 product and one float32 sum in both.  Calibration's absmax is
held within 1e-5 relative (the float convs before each conv sum in other
orders)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mdeical_image_segmentation_tpu.ops import quant as jq
from mdeical_image_segmentation_tpu_torch.models.layers2d import TorchConv
from mdeical_image_segmentation_tpu_torch.ops import _build
from mdeical_image_segmentation_tpu_torch.ops import quant
from mdeical_image_segmentation_tpu_torch.utils.param_bridge import (
    quant_to_flax,
    quant_to_torch,
)

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _to_torch(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _to_jax(a: np.ndarray, dtype) -> jax.Array:
    return jnp.asarray(a, jnp.float32).astype(dtype)


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy() if t.is_floating_point() else t.numpy()
    return np.asarray(t.astype(jnp.float32) if jnp.issubdtype(
        t.dtype, jnp.floating) else t)


def test_mode_context_nests_and_restores():
    assert quant.mode() == "off"
    with quant.quant_mode("calib"):
        assert quant.mode() == "calib"
        with quant.quant_mode("int8"):
            assert quant.mode() == "int8"
        assert quant.mode() == "calib"
    assert quant.mode() == "off"
    with pytest.raises(ValueError, match="int7"):
        with quant.quant_mode("int7"):
            pass
    assert quant.mode() == "off"
    assert quant.wrap_apply(quant.mode, "int8")() == "int8"
    assert quant.quantizable((3, 3), 8) and quant.quantizable((1, 1, 1), 64)
    assert not quant.quantizable((3, 3), 7) and not quant.quantizable((3,), 16)
    assert quant.MIN_QUANT_CIN == jq.MIN_QUANT_CIN and quant.MODES == jq.MODES


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_weight_quant_equals_jax_bits(dtype):
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((3, 3, 3, 12, 5)) * 0.2).astype(np.float32)
    # channel 0: exact ties k + 0.5 at scale 1/128 (absmax 127/128); channel
    # 1: all zeros (the 1e-12 floor)
    w[..., 0] = (rng.integers(-126, 126, w.shape[:-1]) + 0.5) / 128
    w[0, 0, 0, 0, 0] = 127 / 128
    w[..., 1] = 0.0
    jw_q, jw_s = jq._weight_quant(_to_jax(w, jdt))
    # the port's layout: (O, I, *k)
    tw_q, tw_s = quant._weight_quant(
        _to_torch(w, tdt).permute(4, 3, 0, 1, 2))
    np.testing.assert_array_equal(_np(tw_q).transpose(2, 3, 4, 1, 0),
                                  _np(jw_q))
    np.testing.assert_array_equal(_np(tw_s), _np(jw_s))
    assert tw_q.dtype == torch.int8 and tw_s.dtype == torch.float32


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_act_quant_equals_jax_bits(dtype):
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(1)
    scale = np.float32(2.0 ** -5)
    ties = (np.arange(-130, 130) + 0.5) * scale       # exact halves
    beyond = np.array([200, -200, 127.6, -127.6]) * scale  # clipped
    x = np.concatenate([rng.standard_normal(500) * 2.5, ties, beyond]
                       ).astype(np.float32)
    for s in (scale, np.float32(np.abs(x).max() / 127 * 0.9)):
        got = quant._act_quant(_to_torch(x, tdt), torch.tensor(s))
        want = jq._act_quant(_to_jax(x, jdt), jnp.float32(s))
        np.testing.assert_array_equal(_np(got), _np(want))
        assert got.dtype == torch.int8


ACC_CASES = {  # name: (kernel, Ci, Co, spatial)
    "2d_3x3_ci8": ((3, 3), 8, 6, (9, 11)),
    "2d_3x3_ci16": ((3, 3), 16, 8, (8, 7)),
    "2d_3x3_ci40": ((3, 3), 40, 3, (6, 6)),
    "3d_3x3x3_ci16": ((3, 3, 3), 16, 8, (5, 6, 7)),
    "3d_1x3x3_ci40": ((1, 3, 3), 40, 5, (3, 6, 5)),
    "3d_1x1x1_co1": ((1, 1, 1), 8, 1, (4, 5, 6)),
}


@pytest.mark.parametrize("case", sorted(ACC_CASES))
def test_int8_accumulators_equal_jax_bits(case):
    ks, ci, co, sp = ACC_CASES[case]
    rng = np.random.default_rng(len(case))
    x_q = rng.integers(-127, 128, (2, *sp, ci)).astype(np.int8)
    w_q = rng.integers(-127, 128, (*ks, ci, co)).astype(np.int8)
    pads = [(k // 2, k // 2) for k in ks]
    want = np.asarray(jq._int8_conv_nd(
        jnp.asarray(x_q), jnp.asarray(w_q), (1,) * len(ks), pads, len(ks)))
    if len(ks) == 3:
        slab = np.asarray(jq._int8_slab_conv3d(
            jnp.asarray(x_q), jnp.asarray(w_q), tuple(pads)))
        np.testing.assert_array_equal(slab, want)
    tw = torch.from_numpy(w_q).permute(len(ks) + 1, len(ks),
                                       *range(len(ks)))
    got = quant.int8_conv_accumulators(torch.from_numpy(x_q), tw, pads)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the wrapper's CPU path, which quantizes first: at scale 1 the int8
    # values are their own quantization
    qw = quant.QuantizedWeight(tw, torch.ones(co), None)
    acc = quant.int8_conv(torch.from_numpy(x_q).float(), qw,
                          torch.tensor(1.0), pads=pads, accumulators=True)
    np.testing.assert_array_equal(acc.numpy(), want)


CONV_CASES = {  # name: (kernel, Ci, Co, spatial, strides, bias)
    "2d_3x3": ((3, 3), 16, 8, (9, 10), (1, 1), True),
    "2d_1x1_co1": ((1, 1), 16, 1, (8, 8), (1, 1), True),
    "2d_3x3_stride2": ((3, 3), 8, 4, (9, 10), (2, 2), True),
    "3d_3x3x3_nobias": ((3, 3, 3), 40, 1, (5, 6, 6), (1, 1, 1), False),
    "3d_1x3x3": ((1, 3, 3), 8, 24, (3, 6, 5), (1, 1, 1), False),
    "3d_1x1x1": ((1, 1, 1), 16, 1, (4, 5, 6), (1, 1, 1), True),
}


class _Holder(torch.nn.Module):
    def __init__(self, conv):
        super().__init__()
        self.TorchConv_0 = conv


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_quantized_torchconv_equals_jax_int8conv_bits(case, dtype):
    """Given the same x, kernel, bias and absmax, TorchConv in int8 mode
    equals JAX's Int8Conv to the bit (bf16: ``dtype=bfloat16``, x handed
    over in float32 and quantized before any cast, as JAX does)."""
    ks, ci, co, sp, strides, use_bias = CONV_CASES[case]
    tdt, jdt = DTYPES[dtype]
    cdt = None if dtype == "float32" else tdt
    rng = np.random.default_rng(len(case) + 7)
    x = (rng.standard_normal((2, *sp, ci)) * 1.7).astype(np.float32)
    k = (rng.standard_normal((*ks, ci, co)) * 0.3).astype(np.float32)
    b = rng.standard_normal(co).astype(np.float32)
    absmax = np.float32(np.abs(x).max() * 0.8)  # some inputs clip
    same = all(s == 1 for s in strides)
    jm = jq.Int8Conv(features=co, kernel_size=ks, strides=strides,
                     padding=[(kk // 2, kk // 2) for kk in ks] if same
                     else "SAME", use_bias=use_bias,
                     dtype=None if cdt is None else jdt)
    params = {"kernel": k, **({"bias": b} if use_bias else {})}
    with jq.quant_mode("int8"):
        want = jm.apply({"params": params, "quant": {"x_absmax": absmax}},
                        jnp.asarray(x))
    conv = TorchConv(ci, co, ks, strides=strides,
                     padding=[kk // 2 for kk in ks] if same else None,
                     use_bias=use_bias, dtype=cdt)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(k).permute(
            len(ks) + 1, len(ks), *range(len(ks))))
        if use_bias:
            conv.bias.copy_(torch.from_numpy(b))
    holder = _Holder(conv)
    scales = {"TorchConv_0": torch.tensor(absmax)}
    with quant.quant_mode("int8", scales, holder), torch.inference_mode():
        got = conv(torch.from_numpy(x))
    assert got.dtype == (cdt or torch.float32)
    assert str(want.dtype) == dtype
    np.testing.assert_array_equal(_np(got), _np(want))
    # the quantized weight is computed once per weight version
    first = conv._quantized[1]
    with quant.quant_mode("int8", scales, holder), torch.inference_mode():
        conv(torch.from_numpy(x))
    assert conv._quantized[1] is first
    with torch.no_grad():
        conv.weight.mul_(2.0)
    with quant.quant_mode("int8", scales, holder), torch.inference_mode():
        conv(torch.from_numpy(x))
    assert conv._quantized[1] is not first


def test_pack_is_the_kernels_k_contiguous_layout():
    rng = np.random.default_rng(3)
    w_q = torch.from_numpy(rng.integers(-127, 128, (5, 24, 3, 1, 3))
                           .astype(np.int8))
    packed = quant.pack(w_q)
    k = 24 * 9
    assert packed.shape == (5, k + (-k) % 16) and packed.dtype == torch.int8
    assert packed.is_contiguous()
    for co, ci, kd, kh, kw in ((0, 0, 0, 0, 0), (4, 23, 2, 0, 2),
                               (2, 7, 1, 0, 1)):
        tap = (kd * 1 + kh) * 3 + kw
        assert packed[co, tap * 24 + ci] == w_q[co, ci, kd, kh, kw]
    assert not packed[:, k:].any()


def test_kernel_shape_checks_raise_not_implemented():
    """On a CUDA tensor the wrapper refuses what the kernel does not take
    (the checks are plain Python and run before any launch)."""
    x = torch.zeros(1, 6, 6, 8)
    qw = quant.QuantizedWeight(torch.zeros(4, 8, 3, 3, dtype=torch.int8),
                               torch.ones(4), None)
    quant._check_kernel_shape(x, qw, [(1, 1), (1, 1)], (1, 1), torch.float32)
    quant._check_kernel_shape(x, qw, [(0, 0), (0, 0)], None, torch.int32)
    with pytest.raises(NotImplementedError, match="stride 1"):
        quant._check_kernel_shape(x, qw, [(1, 1)] * 2, (2, 2), torch.float32)
    with pytest.raises(NotImplementedError, match="symmetric"):
        quant._check_kernel_shape(x, qw, [(0, 1)] * 2, (1, 1), torch.float32)
    with pytest.raises(NotImplementedError, match="float32 or"):
        quant._check_kernel_shape(x.half(), qw, [(1, 1)] * 2, None,
                                  torch.float16)
    wide = quant.QuantizedWeight(torch.zeros(4, 8, 9, 9, 9,
                                             dtype=torch.int8),
                                 torch.ones(4), None)
    with pytest.raises(NotImplementedError, match="overflow"):
        quant._check_kernel_shape(torch.zeros(1, 9, 9, 9, 8 * 30),
                                  wide._replace(w_q=torch.zeros(
                                      4, 240, 9, 9, 9, dtype=torch.int8)),
                                  [(4, 4)] * 3, None, torch.float32)


def test_int8_kernel_source_and_wrapper():
    src = (_build.CSRC / "int8_conv.cu").read_text()
    assert 'extern "C" int tpuseg_int8_conv_forward(' in src
    assert 'extern "C" int tpuseg_int8_quantize(' in src
    build_src = open(_build.__file__).read()
    assert '"tpuseg_int8_conv_forward"' in build_src
    assert '"tpuseg_int8_quantize"' in build_src
    assert "int8_conv.cu" in _build.SOURCES
    # the gather loop on mma.sync, the halo loop on wgmma s8 fed by TMA
    assert "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32" in src
    for n in (32, 64, 128):
        assert f"wgmma.mma_async.sync.aligned.m64n{n}k32.s32.s8.s8" in src
    for op in ("cp.async.bulk.tensor.5d", "cp.async.bulk.tensor.3d",
               "mbarrier::complete_tx", "CU_TENSOR_MAP_SWIZZLE_32B",
               "wgmma.fence.sync.aligned", "wgmma.commit_group.sync.aligned",
               "wgmma.wait_group.sync.aligned",
               "__grid_constant__ CUtensorMap"):
        assert op in src, op
    for op in ("__fdiv_rn", "rintf", "__int2float_rn", "__fmul_rn",
               "__fadd_rn", "cudaGetLastError()", "int64_t"):
        assert op in src, op
    # quantization runs once per call, in its own pass: the only division
    # and the only use of quant1 are the quantize kernel's
    assert src.count("__fdiv_rn(") == 1
    quantize = src[src.index("// ---- the quantize pass"):
                   src.index("// ---- shared by both conv loops")]
    assert "quant1(" not in src.replace(quantize, "")
    assert isinstance(quant.int8_conv.launches, int)
    assert isinstance(quant.int8_quantize.launches, int)
    assert callable(quant.int8_conv_reference)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_int8_quantize_cpu_equals_jax_act_quant_bits(dtype):
    """``int8_quantize`` on a CPU tensor (the quantize pass's plain
    version) equals JAX's ``_act_quant`` to the bit: ties at .5 round to
    even, values past ±127 clip, in an NDHWC volume and a flat vector."""
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(5)
    scale = np.float32(2.0 ** -4)
    ties = (np.arange(-131, 131) + 0.5) * scale        # exact halves
    beyond = np.array([300, -300, 127.5, -127.5, 126.5, -126.5]) * scale
    flat = np.concatenate([rng.standard_normal(430) * 4.0, ties, beyond]
                          ).astype(np.float32)
    vol = np.resize(flat, (2, 3, 4, 5, 16)).astype(np.float32)
    for x in (flat, vol):
        got = quant.int8_quantize(_to_torch(x, tdt), torch.tensor(scale))
        want = jq._act_quant(_to_jax(x, jdt), jnp.float32(scale))
        assert got.dtype == torch.int8 and got.shape == x.shape
        np.testing.assert_array_equal(_np(got), _np(want))
    assert {-127, 127} <= set(_np(got).ravel().tolist())
    assert quant.int8_quantize.launches == 0  # the CPU path launches none


@pytest.mark.parametrize("ci", [48, 16])
def test_pack_taps_is_the_halo_kernels_layout(ci):
    """``pack_taps`` puts ``w_q[co, ci, kd, kh, kw]`` at byte ((tap * Co +
    co) * Cip + ci), tap = (kd * 3 + kh) * 3 + kw, where the halo loop's
    TMA box (32 channels, BN rows, 9 taps from kd * 9) reads it; the pad
    channels up to Cip = Ci rounded up to 32 are zero."""
    rng = np.random.default_rng(ci)
    co = 5
    for ks in ((3, 3, 3), (3, 3)):
        w_q = torch.from_numpy(rng.integers(-127, 128, (co, ci, *ks))
                               .astype(np.int8))
        taps = quant.pack_taps(w_q)
        cip = ci + (-ci) % 32
        ntap = int(np.prod(ks))
        assert taps.shape == (ntap, co, cip) and taps.dtype == torch.int8
        assert taps.is_contiguous() and cip % 32 == 0
        flat = taps.reshape(-1)
        k3 = (1,) * (3 - len(ks)) + ks
        for o in range(co):
            for i in range(ci):
                for kd in range(k3[0]):
                    for kh in range(3):
                        for kw in range(3):
                            tap = (kd * 3 + kh) * 3 + kw
                            want = w_q[(o, i, kd, kh, kw)[:2 + len(ks)]
                                       if len(ks) == 3 else (o, i, kh, kw)]
                            assert flat[(tap * co + o) * cip + i] == want
        assert not taps[:, :, ci:].any()


def test_int8_quantize_refuses_other_devices():
    x = torch.zeros(4, 16, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        quant.int8_quantize(x, torch.tensor(1.0, device="meta"))


def test_scales_bridge_round_trip():
    tree = {"quant": {"encoders_0": {"basic_module": {"SingleConv2": {
        "TorchConv_0": {"Conv_0": {"x_absmax": np.float32(2.5)}}}}},
        "final_conv": {"Conv_0": {"x_absmax": np.float32(0.25)}}}}
    scales = quant_to_torch(tree)
    assert sorted(scales) == ["encoders_0.basic_module.SingleConv2.TorchConv_0",
                              "final_conv"]
    assert scales["final_conv"].dtype == torch.float32
    assert float(scales["final_conv"]) == 0.25
    back = quant_to_flax(scales)
    assert quant_to_torch(back).keys() == scales.keys()
    assert float(back["quant"]["final_conv"]["Conv_0"]["x_absmax"]) == 0.25
    assert quant_to_torch(tree["quant"]).keys() == scales.keys()
    with pytest.raises(ValueError, match="unexpected quant leaf"):
        quant_to_torch({"a": {"kernel": np.float32(1)}})


def test_calibrate_needs_batches_and_a_model():
    conv = TorchConv(8, 4, (3, 3))
    conv.reset_parameters(torch.Generator().manual_seed(0))
    holder = _Holder(conv)
    with pytest.raises(ValueError, match="no batches"):
        quant.calibrate(holder.TorchConv_0, holder, [])
    # a conv outside the model the context names
    with pytest.raises(ValueError, match="needs the model"):
        with quant.quant_mode("calib", {}, _Holder(TorchConv(8, 4))):
            conv(torch.zeros(1, 4, 4, 8))
    x1 = torch.rand(1, 5, 5, 8)
    s1 = quant.calibrate(holder.TorchConv_0, holder, [x1])
    s2 = quant.calibrate(holder.TorchConv_0, holder, [x1, x1 * 3 - 4])
    assert list(s1) == ["TorchConv_0"]
    assert float(s1["TorchConv_0"]) == float(x1.abs().max())
    assert float(s2["TorchConv_0"]) == float((x1 * 3 - 4).abs().max()) > \
        float(s1["TorchConv_0"])
    with pytest.raises(ValueError, match="missing at TorchConv_0"):
        with quant.quant_mode("int8", {}, holder):
            conv(x1)

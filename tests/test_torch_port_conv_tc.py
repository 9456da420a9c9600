"""The arithmetic of the tensor-core conv core (``csrc/conv_tc.cuh``),
emulated in numpy on the CPU: no kernel runs here.

In fp32 the kernel runs 3xTF32: each operand v is split into big = v cut
to TF32 (10 mantissa bits, by masking) and small = v - big, which the tensor
core reads cut to TF32 as well; each 8-deep K step issues three mmas,
small_a*big_b, then big_a*small_b, then big_a*big_b.  An mma adds its
products into its fp32 fragment with truncation, which the emulation models
by cutting every mma's sum to fp32 toward zero.  Summed straight into the
running sum over a long K, that truncation biases the result; so the kernel
sums the mmas of one to three steps into a fresh fragment and folds it into
the running sum with one rounded fp32 add.  The emulation walks K in each
main loop's own order: the gather path's (k = tap * Ci + ci, 8 at a time,
K zero-padded to a multiple of 16, one step per fresh fragment) and the
halo path's (depth tap, 8-channel chunk, the 9 (kh, kw) taps, folded every
1 or 3 taps).  On the GroupNorm-affine prologue of ``fused_conv3d``
(rounded after the product and after the sum; the padding zero after the
affine) it is held against ``F.conv3d`` in float64 within the kernel's
stated fp32 limit (rtol = atol = 1e-4, ``chip_smoke.FP32_TOL``).  Two
counter-cases document the design: single-pass TF32 on the same inputs
(operands rounded to nearest, as ``cvt.rna.tf32.f32`` does) misses that
limit, which is why the kernel pays for three products; and at K = 27 * 768
the same 3xTF32 products summed into one fragment miss it too, while the
fresh-fragment fold meets it.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mdeical_image_segmentation_tpu_torch.ops import fused_conv

TOL = 1e-4      # the kernel's fp32 limit against its plain version
K_STEP = 8      # depth of one m16n8k8 TF32 mma; channels per halo stage
K_STAGE = 16    # fp32 K elements per gather stage: K is zero-padded to it


def _tf32(v: np.ndarray) -> np.ndarray:
    """Round float32 to TF32 (10 mantissa bits), to nearest, ties away."""
    bits = np.ascontiguousarray(v, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _cut(v: np.ndarray) -> np.ndarray:
    """Cut float32 to TF32 by masking the low 13 bits: the kernel's big
    part, and what the tensor core reads of a TF32 operand."""
    bits = np.ascontiguousarray(v, np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def _split(v):
    big = _cut(v)
    return big, _cut((v - big).astype(np.float32))


def _inputs(n, d, h, w, ci, co, kd, seed):
    rng = np.random.default_rng(seed)
    return (
        (3 * rng.standard_normal((n, d, h, w, ci)) + 0.3).astype(np.float32),
        (rng.standard_normal((kd, 3, 3, ci, co))
         / np.sqrt(9 * kd * ci)).astype(np.float32),
        (0.5 + rng.random((n, ci))).astype(np.float32),
        (0.5 * rng.standard_normal((n, ci))).astype(np.float32),
    )


def _prologue(x, a, b, pre_relu):
    """fp32 affine rounded after the product and after the sum."""
    n, ci = x.shape[0], x.shape[-1]
    xa = (x * a.reshape(n, 1, 1, 1, ci)).astype(np.float32)
    xa = (xa + b.reshape(n, 1, 1, 1, ci)).astype(np.float32)
    return np.maximum(xa, 0) if pre_relu else xa


def _im2col(xa, kd):
    """(M, K) with k = tap * Ci + ci, tap = (kd, kh, kw) row-major; zeros
    outside the volume (the padding of the normalized tensor)."""
    n, d, h, w, ci = xa.shape
    pd = (kd - 1) // 2
    xp = np.pad(xa, ((0, 0), (pd, pd), (1, 1), (1, 1), (0, 0)))
    cols = [xp[:, i:i + d, j:j + h, k:k + w, :]
            for i in range(kd) for j in range(3) for k in range(3)]
    return np.concatenate(cols, axis=-1).reshape(n * d * h * w, -1)


def _trunc32(v: np.ndarray) -> np.ndarray:
    """float64 to float32 toward zero: an mma's truncating accumulate."""
    f = v.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(v)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def _gather_order(ci, kd):
    """The gather path's K steps: 8 consecutive k = tap * Ci + ci each (-1
    past K: the zero padding), one step per fresh fragment."""
    k = kd * 9 * ci
    idx = np.arange(-(-k // K_STAGE) * K_STAGE)
    idx[idx >= k] = -1
    return [[idx[s:s + K_STEP]] for s in range(0, idx.size, K_STEP)]


def _halo_order(ci, kd, taps_per_fold):
    """The halo path's K steps: per depth tap, per 8-channel chunk
    (zero-filled past Ci), the 9 (kh, kw) taps; a fresh fragment every
    ``taps_per_fold`` taps (3 on the small warp tiles, 1 on the 4 x 4)."""
    groups = []
    for d in range(kd):
        for c0 in range(0, ci, K_STEP):
            ch = np.arange(c0, c0 + K_STEP)
            for t0 in range(0, 9, taps_per_fold):
                groups.append([np.where(ch < ci, (d * 9 + t) * ci + ch, -1)
                               for t in range(t0, min(t0 + taps_per_fold, 9))])
    return groups


def _mma_sum(a, b, split, groups, fresh=True):
    """(M, K) @ (K, Co) as the kernel sums it: ``split`` gives each operand's
    passes; every mma adds its 8 products (exact) to its fragment and cuts
    the sum to fp32 toward zero.  With ``fresh`` each group of steps sums
    into a zero fragment that one rounded fp32 add folds into the running
    sum; without it every mma adds straight into the running sum."""
    a = np.pad(a, ((0, 0), (0, 1)))  # index -1: the zero padding
    b = np.pad(b, ((0, 1), (0, 0)))
    passes = split(a, b)
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for group in groups:
        frag = np.zeros_like(acc) if fresh else acc
        for idx in group:
            for pa, pb in passes:
                part = pa[:, idx].astype(np.float64) @ pb[idx].astype(
                    np.float64)
                frag = _trunc32(frag.astype(np.float64) + part)
        acc = (acc + frag).astype(np.float32) if fresh else frag
    return acc


def _passes_3xtf32(a, b):
    a_big, a_small = _split(a)
    b_big, b_small = _split(b)
    return [(a_small, b_big), (a_big, b_small), (a_big, b_big)]


def _passes_1xtf32(a, b):
    return [(_tf32(a), _tf32(b))]


def _kernel_3xtf32(a, b, groups):
    return _mma_sum(a, b, _passes_3xtf32, groups)


def _kernel_1xtf32(a, b, groups):
    return _mma_sum(a, b, _passes_1xtf32, groups)


def _case(ci, co, kd, pre_relu=False, seed=0):
    x, k, a, b = _inputs(1, 3, 5, 7, ci, co, kd, seed)
    xa = _prologue(x, a, b, pre_relu)
    want = F.conv3d(torch.from_numpy(xa).double().permute(0, 4, 1, 2, 3),
                    torch.from_numpy(k).double().permute(4, 3, 0, 1, 2),
                    padding=((kd - 1) // 2, 1, 1)).permute(0, 2, 3, 4, 1)
    return (_im2col(xa, kd), k.reshape(-1, co),
            want.reshape(-1, co).numpy(), (x, k, a, b))


def test_tf32_rounding_and_cutting_keep_ten_mantissa_bits():
    v = np.array([1 + 2 ** -10, 1 + 2 ** -11, 1 + 3 * 2 ** -11, -(1 + 2 ** -11),
                  1 + 2 ** -12], np.float32)
    np.testing.assert_array_equal(
        _tf32(v), np.array([1 + 2 ** -10, 1 + 2 ** -10, 1 + 2 ** -9,
                            -(1 + 2 ** -10), 1], np.float32))
    np.testing.assert_array_equal(
        _cut(v), np.array([1 + 2 ** -10, 1, 1 + 2 ** -10, -1, 1], np.float32))
    big, small = _split(np.float32([np.pi]))
    assert big[0] != np.float32(np.pi) and _cut(small)[0] == small[0]
    assert abs(float(big[0]) + float(small[0]) - np.pi) < 2 ** -21


@pytest.mark.parametrize("kd", [1, 3])
@pytest.mark.parametrize("co", [7, 65])
@pytest.mark.parametrize("ci", [1, 3, 19])
def test_3xtf32_meets_the_fp32_limit(ci, co, kd):
    """Ci 1, 3, 19 and Co 7, 65 take the gather path."""
    cols, w, want, _ = _case(ci, co, kd, pre_relu=ci == 3, seed=ci + co + kd)
    got = _kernel_3xtf32(cols, w, _gather_order(ci, kd))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("taps_per_fold", [1, 3])
@pytest.mark.parametrize("kd", [1, 3])
@pytest.mark.parametrize("ci,co", [(4, 8), (20, 16), (64, 8)])
def test_3xtf32_halo_order_meets_the_fp32_limit(ci, co, kd, taps_per_fold):
    """Ci and Co multiples of 4 take the halo path (Ci 4 and 20 leave part
    of the last 8-channel chunk zero)."""
    cols, w, want, _ = _case(ci, co, kd, pre_relu=ci == 20, seed=ci + kd)
    got = _kernel_3xtf32(cols, w, _halo_order(ci, kd, taps_per_fold))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_3xtf32_matches_the_ports_plain_version():
    """The same emulation against ``fused_conv3d`` on the CPU (its plain
    version: the fp32 affine, then ``F.conv3d`` in fp32)."""
    cols, w, _, (x, k, a, b) = _case(19, 65, 3, seed=5)
    plain = fused_conv.fused_conv3d(
        *(torch.from_numpy(v) for v in (x, k, a, b)), post_relu=False)
    np.testing.assert_allclose(_kernel_3xtf32(cols, w, _gather_order(19, 3)),
                               plain.reshape(-1, 65).numpy(), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("ci,co,kd", [(19, 65, 3), (19, 7, 3)])
def test_single_pass_tf32_misses_the_fp32_limit(ci, co, kd):
    cols, w, want, _ = _case(ci, co, kd, seed=ci + co + kd)
    order = _gather_order(ci, kd)
    err = np.abs(_kernel_1xtf32(cols, w, order) - want) - TOL * np.abs(want)
    assert err.max() > TOL
    err3 = np.abs(_kernel_3xtf32(cols, w, order) - want) - TOL * np.abs(want)
    assert err3.max() < TOL / 10


@pytest.mark.parametrize("taps_per_fold", [1, 3])
def test_fresh_fragment_fold_is_what_meets_the_limit_at_large_k(
        taps_per_fold):
    """K = 27 * 768 (the decoder's 768-channel input), two interior
    positions, nonnegative operands so the running sum grows: every mma
    summed straight into one fragment truncates ~7800 times and misses the
    limit; the kernel's fresh fragments, folded with a rounded add, meet
    it with room to spare."""
    ci, kd, co = 768, 3, 8
    rng = np.random.default_rng(0)
    cols = rng.random((2, kd * 9 * ci)).astype(np.float32)
    w = (8 * rng.random((kd * 9 * ci, co)) / (kd * 9 * ci)).astype(np.float32)
    want = cols.astype(np.float64) @ w.astype(np.float64)
    order = _halo_order(ci, kd, taps_per_fold)

    def excess(fresh):
        got = _mma_sum(cols, w, _passes_3xtf32, order, fresh=fresh)
        return (np.abs(got - want) - TOL * np.abs(want)).max()

    assert excess(fresh=False) > TOL
    assert excess(fresh=True) < 0

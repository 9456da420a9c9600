"""The port's GroupNorm forward (``mdeical_image_segmentation_tpu_torch.ops.
norm``) against the JAX package's: the Pallas forward ``_gn_fwd_pallas`` in
interpret mode (the kernels ``_stats_kernel`` and ``_affine_kernel``) and
the jnp ``group_norm``, on the same numpy inputs from a fixed seed.

Tolerances: float32 within rtol = atol = 1e-5 (the two sides sum the same
terms in different orders); bfloat16 within 2e-2 against the Pallas
forward (same math, one bf16 ulp at |y| < 4 from a different sum order)
and 3e-2 against ``group_norm`` (which also rounds x̂ to bf16 before the
affine: two roundings more)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mdeical_image_segmentation_tpu.ops import norm as jax_norm
from mdeical_image_segmentation_tpu_torch.ops import norm

FP32_TOL = 1e-5
BF16_PALLAS_TOL = 2e-2
BF16_JNP_TOL = 3e-2

SHAPES = [
    ((2, 4, 8, 6, 16), 8),    # 2 channels per group
    ((1, 3, 8, 5, 8), 8),     # one channel per group (the 'gcr' default)
    ((2, 2, 8, 7, 12), 1),    # one group (channels < num_groups clamp)
    ((1, 2, 8, 4, 1), 1),     # one channel: the UNet's grey input
]


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = (1.5 * rng.standard_normal(shape) + 0.7).astype(np.float32)
    scale = (1.0 + 0.3 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.2 * rng.standard_normal(c)).astype(np.float32)
    return x, scale, bias


def _bf16_numpy(t):
    return t.float().numpy()


@pytest.mark.parametrize("shape,groups", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax_pallas_kernels(shape, groups, dtype):
    x, scale, bias = _inputs(shape, seed=sum(shape) + groups)
    jx = jnp.asarray(x).astype(dtype)
    y_jax, _ = jax_norm._gn_fwd_pallas(jx, jnp.asarray(scale),
                                       jnp.asarray(bias), groups, 1e-5,
                                       interpret=True)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    y = norm.group_norm(tx, torch.from_numpy(scale), torch.from_numpy(bias),
                        groups, 1e-5)
    assert y.dtype == tx.dtype and y.shape == tx.shape
    tol = FP32_TOL if dtype == "float32" else BF16_PALLAS_TOL
    np.testing.assert_allclose(_bf16_numpy(y),
                               np.asarray(y_jax.astype(jnp.float32)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("shape,groups", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax_group_norm(shape, groups, dtype):
    x, scale, bias = _inputs(shape, seed=7 * sum(shape) + groups)
    y_jax = jax_norm.group_norm(jnp.asarray(x).astype(dtype),
                                jnp.asarray(scale), jnp.asarray(bias),
                                groups, 1e-5)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    y = norm.group_norm(tx, torch.from_numpy(scale), torch.from_numpy(bias),
                        groups, 1e-5)
    tol = FP32_TOL if dtype == "float32" else BF16_JNP_TOL
    np.testing.assert_allclose(_bf16_numpy(y),
                               np.asarray(y_jax.astype(jnp.float32)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("shape,groups", SHAPES[:3])
def test_statistics_match_jax_group_stats(shape, groups):
    x, _, _ = _inputs(shape, seed=3)
    mean, inv, _ = jax_norm._group_stats(jnp.asarray(x), groups, 1e-5)
    s1, s2 = norm.gn_channel_sums(torch.from_numpy(x))
    count = int(np.prod(shape[1:-1]))
    mean_c, inv_c = norm.group_stats(s1, s2, groups, count, 1e-5)
    cg = shape[-1] // groups
    np.testing.assert_allclose(mean_c.numpy(),
                               np.repeat(np.asarray(mean), cg, -1),
                               rtol=FP32_TOL, atol=FP32_TOL)
    np.testing.assert_allclose(inv_c.numpy(),
                               np.repeat(np.asarray(inv), cg, -1),
                               rtol=FP32_TOL, atol=FP32_TOL)


def test_affine_coefficients_match_jax():
    rng = np.random.default_rng(11)
    mean_c, inv_c = (rng.standard_normal((2, 6)).astype(np.float32)
                     for _ in range(2))
    scale, bias = (rng.standard_normal(6).astype(np.float32)
                   for _ in range(2))
    a_j, b_j = jax_norm._gn_affine_coeffs(*(jnp.asarray(v) for v in (
        mean_c, inv_c, scale, bias)))
    a, b = norm.gn_affine_coeffs(*(torch.from_numpy(v) for v in (
        mean_c, inv_c, scale, bias)))
    np.testing.assert_array_equal(a.numpy(), np.asarray(a_j))
    np.testing.assert_array_equal(b.numpy(), np.asarray(b_j))


@pytest.mark.parametrize("dtype,out", [(None, torch.float32),
                                       (torch.bfloat16, torch.bfloat16)])
def test_module_defaults_and_output_dtype(dtype, out):
    """Parameters are fp32 ones and zeros; the output dtype follows flax's
    rule (x's dtype promoted with fp32 unless ``dtype`` is given)."""
    m = norm.GroupNorm(16, 4, dtype=dtype)
    assert m.epsilon == 1e-5
    assert torch.equal(m.weight, torch.ones(16))
    assert torch.equal(m.bias, torch.zeros(16))
    x = torch.randn(1, 2, 3, 4, 16, dtype=torch.bfloat16)
    assert m(x).dtype == out
    with pytest.raises(ValueError, match="not divisible"):
        norm.GroupNorm(12, 8)


def test_cpu_tensors_take_the_plain_versions():
    x = torch.randn(1, 2, 3, 4, 8)
    a, b = torch.ones(1, 8), torch.zeros(1, 8)
    before = (norm.gn_channel_sums.launches, norm.gn_affine.launches)
    norm.gn_channel_sums(x)
    torch.testing.assert_close(norm.gn_affine(x, a, b), x, rtol=0, atol=0)
    assert (norm.gn_channel_sums.launches, norm.gn_affine.launches) == before


def test_kernel_checks_refuse_autograd_and_bad_coefficients():
    """The CUDA path has no backward yet: it raises under autograd instead
    of returning wrong gradients.  The checks are plain Python."""
    x = torch.randn(1, 2, 3, 4, 8, requires_grad=True)
    a = torch.ones(1, 8)
    with pytest.raises(RuntimeError, match="no backward"):
        norm._check_cuda("gn_affine", x, a, a)
    with torch.no_grad():
        norm._check_cuda("gn_affine", x, a, a)
        with pytest.raises(ValueError, match="coefficients"):
            norm._check_cuda("gn_affine", x, a.double(), a)
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            norm._check_cuda("gn_affine", x.half(), a, a)


# -- kernels 3a and 3c (csrc/group_norm.cu, gn_partial_kernel): the walk ----
#
# Replayed in numpy with the source's constants: the unit of the walk (a
# 16-byte vector of V channels of a row when C % V == 0, of V / C whole rows
# when V % C == 0 and S·C % V == 0, else a scalar; vectors only with x and g
# aligned), the grid the launcher asks the card for (reduce_blocks), each
# thread summing units t, t + stride, ... into V pairs of fp32 accumulators
# whose channels never change, the fixed tree over the threads of a block
# that share a channel group, one partial per (n, c, block), and the final
# kernel's fixed tree over the G partials.  The products are rounded before
# the add where the kernel fuses them (fmaf), so the sums agree with the
# plain versions within SUM_TOL, not bit for bit.

def _reduce_constants():
    import re

    from mdeical_image_segmentation_tpu_torch.ops import _build

    src = (_build.CSRC / "group_norm.cu").read_text()
    return {name: int(re.search(rf"constexpr int {name} = (\d+);", src)[1])
            for name in ("NT", "UNROLL", "REDUCE_WAVES", "REDUCE_STEPS",
                         "MAX_TERMS")}


def _reduce_walk(rows, c, v, aligned):
    """(mode, values per unit, lanes, units of a sample): reduce_mode and
    reduce_lanes of the source."""
    if aligned and c % v == 0:
        mode, width, lanes = 1, v, c // v
    elif aligned and v % c == 0 and rows * c % v == 0:
        mode, width, lanes = 2, v, 1
    else:
        mode, width, lanes = 0, 1, c
    return mode, width, lanes, rows * c // width


def _reduce_blocks(n, units, lanes, sms, per_sm):
    """Blocks per sample: reduce_blocks of the source."""
    k = _reduce_constants()
    nt, max_terms = k["NT"], k["MAX_TERMS"]
    g = -(-units // (nt * k["UNROLL"] * k["REDUCE_STEPS"]))
    g = min(max(g, -(-sms // n)), sms * per_sm * k["REDUCE_WAVES"] // n)
    rows = -(-(-(-units // max_terms)) // lanes)
    return max(g, -(-(rows * lanes) // nt), 1)


def _final_tree(partial, nt):
    """gn_stats_final_kernel over (..., G) partials: thread t sums partials
    t, t + NT, ... in order, then a halving tree over the NT threads."""
    g = partial.shape[-1]
    pad = np.zeros(partial.shape[:-1] + (-(-g // nt) * nt,), np.float32)
    pad[..., :g] = partial
    acc = np.zeros(partial.shape[:-1] + (nt,), np.float32)
    for chunk in np.split(pad, pad.shape[-1] // nt, axis=-1):
        acc += chunk
    half = nt // 2
    while half:
        acc[..., :half] += acc[..., half:2 * half]
        half //= 2
    return acc[..., 0]


def _emulate_reduce(x, g, mean, inv, aligned, sms, per_sm):
    """(s1, s2, G) of tpuseg_gn_stats (g None) or tpuseg_gn_bwd_reduce."""
    k = _reduce_constants()
    nt = k["NT"]
    n, c = x.shape[0], x.shape[-1]
    rows = x.numel() // (n * c)
    v = 16 // x.element_size()
    mode, width, lanes, units = _reduce_walk(rows, c, v, aligned)
    blocks = _reduce_blocks(n, units, lanes, sms, per_sm)
    stride = blocks * nt // lanes * lanes
    assert stride > 0
    xf = x.float().numpy().reshape(n, rows * c)
    ch_of = np.arange(rows * c) % c
    if g is None:
        a, b = xf, xf * xf
    else:
        xhat = (xf - mean.numpy()[:, ch_of]) * inv.numpy()[:, ch_of]
        a = g.float().numpy().reshape(n, rows * c)
        b = a * xhat
    partial = np.zeros((2, n, c, blocks), np.float32)
    writes = np.zeros((n, c, blocks), np.int32)
    hits = np.zeros((n, rows * c), np.int32)
    t = np.arange(blocks * nt)
    c0 = (t % lanes) * width
    for smp in range(n):
        s1 = np.zeros((blocks * nt, width), np.float32)
        s2 = np.zeros_like(s1)
        terms = np.zeros(blocks * nt, np.int32)
        for step in range(-(-units // stride)):  # each thread's order
            i = t + step * stride
            ok = (t < stride) & (i < units)
            e = i[ok, None] * width + np.arange(width)
            assert (e % c == (c0[ok, None] + np.arange(width)) % c).all()
            s1[ok] += a[smp, e]
            s2[ok] += b[smp, e]
            terms[ok] += 1
            np.add.at(hits[smp], e.ravel(), 1)
        assert terms.max() <= k["MAX_TERMS"]
        tid = np.arange(nt)
        for blk in range(blocks):
            sh1, sh2 = (s[blk * nt:(blk + 1) * nt].copy() for s in (s1, s2))
            r, step = tid // lanes, 1
            while step < -(-nt // lanes):  # the tree over rows of lanes
                sel = (r % (2 * step) == 0) & (tid + step * lanes < nt)
                sh1[sel] += sh1[tid[sel] + step * lanes]
                sh2[sel] += sh2[tid[sel] + step * lanes]
                step *= 2
            ch = np.arange(c)
            if mode == 1:
                j, ks = ch // v, [ch % v]
            elif mode == 2:
                j, ks = 0 * ch, [ch + m * c for m in range(width // c)]
            else:
                j, ks = ch, [0 * ch]
            o = (j - blk * nt % lanes) % lanes
            cov = o < nt
            for kk in ks:
                partial[0, smp, cov, blk] += sh1[o[cov], kk[cov]]
                partial[1, smp, cov, blk] += sh2[o[cov], kk[cov]]
            writes[smp, :, blk] += 1
    assert (hits == 1).all() and (writes == 1).all()
    s1, s2 = _final_tree(partial, nt)
    return torch.from_numpy(s1), torch.from_numpy(s2), blocks


# blocks of 256 threads per SM of gn_partial_kernel on the H100, by (bytes
# per element, backward): the occupancy of each instantiation at its ptxas
# register count on sm_90a (48 registers for the statistics, 75 for the fp32
# and 99 for the bf16 backward sums: 5, 3 and 2 blocks of 64K registers)
H100_BLOCKS_PER_SM = {(4, False): 5, (2, False): 5, (4, True): 3,
                      (2, True): 2}


def _reduce_grids(itemsize, bwd):
    """(SMs, blocks per SM): the H100 and a 2-SM card."""
    return ((132, H100_BLOCKS_PER_SM[itemsize, bwd]), (2, 1))


@pytest.mark.parametrize("c", [1, 3, 19, 32, 192, 300, 768])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("aligned", [True, False])
def test_reduce_walk_sums_each_element_once(c, dtype, aligned):
    """Both reductions on the H100's grid and on a 2-SM card, where each
    thread walks many steps: every element lands in exactly one
    accumulator, whose channels never change and which adds at most
    MAX_TERMS terms; every partial of the (2, N, C, G) scratch is written
    once; the sums agree with the plain versions."""
    rng = np.random.default_rng(c)
    shape = (2, 4, 5, 8, c)
    x = torch.from_numpy((1.5 * rng.standard_normal(shape) + 0.7).astype(
        np.float32)).to(dtype)
    g = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        dtype)
    mean = torch.from_numpy((0.7 + 0.1 * rng.standard_normal((2, c))).astype(
        np.float32))
    inv = torch.from_numpy((0.5 + rng.random((2, c))).astype(np.float32))
    for args, want in (((None, None, None),
                        norm.gn_channel_sums_reference(x)),
                       ((g, mean, inv),
                        norm.gn_bwd_reduce_reference(x, g, mean, inv))):
        for sms, per_sm in _reduce_grids(x.element_size(),
                                         args[0] is not None):
            got = _emulate_reduce(x, *args, aligned, sms, per_sm)
            for a, b in zip(got[:2], want):
                np.testing.assert_allclose(a.numpy(), b.numpy(),
                                           rtol=SUM_TOL, atol=SUM_TOL)


@pytest.mark.parametrize("rows,c", [(6_131_712, 1), (6_131_712, 192),
                                    (767_637, 64), (35, 19), (10, 300)])
def test_stats_grid_bounds_work_and_scratch(rows, c):
    """The reductions' grid at the 3D UNet's largest activations (N = 4)
    and at ragged C, on the H100 and on a 2-SM card, fp32 and bf16: no
    accumulator adds more than MAX_TERMS terms, every lane has a thread,
    and at the model shapes the (2, N, C, G) fp32 scratch stays under 1%
    of x's bytes."""
    k = _reduce_constants()
    assert norm._NT == k["NT"]
    for itemsize in (4, 2):
        _, _, lanes, units = _reduce_walk(rows, c, 16 // itemsize, True)
        for sms, per_sm in (*_reduce_grids(itemsize, False),
                            *_reduce_grids(itemsize, True)):
            blocks = _reduce_blocks(4, units, lanes, sms, per_sm)
            stride = blocks * k["NT"] // lanes * lanes
            assert stride >= lanes and -(-units // stride) <= k["MAX_TERMS"]
            if rows > 1000:
                assert 2 * c * blocks * 4 <= rows * c * itemsize / 100


# -- the backward: kernels 3c (_bwd_reduce_kernel) and 3d (_bwd_dx_kernel) --
#
# Tolerances: the channel sums Σg and Σg·x̂ within rtol = atol = 1e-4 (fp32
# sums of a few hundred terms of size ~1-4 in different orders, both from
# the same bf16 or fp32 inputs); dx within rtol = atol = 1e-5 in fp32 and
# 2e-2 in bf16 (one bf16 ulp at |dx| < 4; the coefficients' fp32 algebra
# is the same on both sides).

SUM_TOL = 1e-4


def _bwd_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    n, c = shape[0], shape[-1]
    x = (1.5 * rng.standard_normal(shape) + 0.7).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    mean = (0.7 + 0.1 * rng.standard_normal((n, c))).astype(np.float32)
    inv = (0.5 + rng.random((n, c))).astype(np.float32)
    return x, g, mean, inv


def _as(v, dtype):
    return torch.from_numpy(v).to(getattr(torch, dtype))


@pytest.mark.parametrize("shape", [s for s, _ in SHAPES])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_reduce_matches_jax_pallas_kernel(shape, dtype):
    x, g, mean, inv = _bwd_inputs(shape, seed=sum(shape))
    n, d, h, w, c = shape
    jx, jg = (jnp.asarray(v).astype(dtype).reshape(n, d, h, w * c)
              for v in (x, g))
    c1_j, c2_j = jax_norm._gn_bwd_reduce(jx, jg, jnp.asarray(mean),
                                         jnp.asarray(inv), w, c,
                                         interpret=True)
    c1, c2 = norm.gn_bwd_reduce(_as(x, dtype), _as(g, dtype),
                                torch.from_numpy(mean), torch.from_numpy(inv))
    assert c1.dtype == c2.dtype == torch.float32 and c1.shape == (n, c)
    np.testing.assert_allclose(c1.numpy(), np.asarray(c1_j), rtol=SUM_TOL,
                               atol=SUM_TOL)
    np.testing.assert_allclose(c2.numpy(), np.asarray(c2_j), rtol=SUM_TOL,
                               atol=SUM_TOL)


@pytest.mark.parametrize("shape", [s for s, _ in SHAPES])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_dx_matches_jax_pallas_kernel(shape, dtype):
    x, g, _, _ = _bwd_inputs(shape, seed=3 * sum(shape))
    rng = np.random.default_rng(1)
    n, d, h, w, c = shape
    a, cc, dd = (rng.standard_normal((n, c)).astype(np.float32)
                 for _ in range(3))
    jx, jg = (jnp.asarray(v).astype(dtype).reshape(n, d, h, w * c)
              for v in (x, g))
    dx_j = jax_norm._gn_grid(jx, 3, jax_norm._bwd_dx_kernel, 0,
                             out_full=jx.dtype, interpret=True)(
        jx, jg, *(jax_norm._tile_row(jnp.asarray(v), w) for v in (a, cc, dd)))
    dx = norm.gn_bwd_dx(_as(x, dtype), _as(g, dtype), *(
        torch.from_numpy(v) for v in (a, cc, dd)))
    assert dx.dtype == getattr(torch, dtype) and dx.shape == shape
    tol = FP32_TOL if dtype == "float32" else BF16_PALLAS_TOL
    np.testing.assert_allclose(
        _bf16_numpy(dx), np.asarray(dx_j.astype(jnp.float32)).reshape(shape),
        rtol=tol, atol=tol)


@pytest.mark.parametrize("shape,groups", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_matches_jax_gn_bwd_pallas(shape, groups, dtype):
    """The whole backward from the Pallas residual (x, mean_c, inv_c,
    scale): kernel 3c, the (N, C) algebra of ``_gn_bwd_coeffs``, kernel
    3d."""
    x, scale, _ = _inputs(shape, seed=5 * sum(shape) + groups)
    g = np.random.default_rng(groups).standard_normal(shape).astype(
        np.float32)
    jx = jnp.asarray(x).astype(dtype)
    _, res = jax_norm._gn_fwd_pallas(jx, jnp.asarray(scale),
                                     jnp.zeros_like(jnp.asarray(scale)),
                                     groups, 1e-5, interpret=True)
    dx_j, ds_j, db_j = jax_norm._gn_bwd_pallas(
        groups, 1e-5, res, jnp.asarray(g).astype(dtype), interpret=True)
    tx = _as(x, dtype)
    mean_c, inv_c = norm.group_norm_stats(tx, groups, 1e-5)
    dx, ds, db = norm.group_norm_backward(tx, _as(g, dtype), mean_c, inv_c,
                                          torch.from_numpy(scale), groups,
                                          True)
    tol = FP32_TOL if dtype == "float32" else BF16_PALLAS_TOL
    np.testing.assert_allclose(_bf16_numpy(dx),
                               np.asarray(dx_j.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    for got, want in ((ds, ds_j), (db, db_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=SUM_TOL, atol=SUM_TOL)


def test_backward_coefficients_match_jax():
    rng = np.random.default_rng(12)
    c1, c2, mean_c = (rng.standard_normal((2, 8)).astype(np.float32)
                      for _ in range(3))
    inv_c = (0.5 + rng.random((2, 8))).astype(np.float32)
    scale = rng.standard_normal(8).astype(np.float32)
    want = jax_norm._gn_bwd_coeffs(*(jnp.asarray(v) for v in (
        c1, c2, mean_c, inv_c, scale)), 4, 96.0)
    got = norm.gn_bwd_coeffs(*(torch.from_numpy(v) for v in (
        c1, c2, mean_c, inv_c, scale)), 4, 96.0)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("shape,groups", SHAPES)
def test_group_norm_grads_match_jax_vjp(shape, groups):
    """``group_norm`` as an autograd Function: (dx, dscale, dbias) against
    ``jax.vjp`` of the JAX package's ``group_norm``, fp32 within 1e-4 of
    each gradient's max |value| (dscale and dbias sum the whole volume)."""
    import jax

    x, scale, bias = _inputs(shape, seed=9 * sum(shape) + groups)
    g = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a, s, b: jax_norm.group_norm(a, s, b, groups,
                                                         1e-5),
                     *(jnp.asarray(v) for v in (x, scale, bias)))
    want = vjp(jnp.asarray(g))
    tx, ts, tb = (torch.from_numpy(v).requires_grad_() for v in (x, scale,
                                                                 bias))
    got = torch.autograd.grad(norm.group_norm(tx, ts, tb, groups, 1e-5),
                              (tx, ts, tb), torch.from_numpy(g))
    for a, b in zip(got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-4 * np.abs(b).max())


def test_group_norm_skips_dx_when_x_needs_no_grad():
    """The first 'gcr' layer's input (the image) needs no gradient: the
    Function returns dscale and dbias and runs no dx pass."""
    x = torch.randn(1, 2, 3, 4, 8)
    s = torch.ones(8, requires_grad=True)
    b = torch.zeros(8, requires_grad=True)
    calls = []
    orig = norm.gn_bwd_dx
    norm.gn_bwd_dx = lambda *a: calls.append(1) or orig(*a)
    try:
        norm.group_norm(x, s, b, 4, 1e-5).sum().backward()
    finally:
        norm.gn_bwd_dx = orig
    assert calls == [] and s.grad is not None and b.grad is not None
    torch.testing.assert_close(b.grad, torch.full((8,), 24.0))


def test_bwd_kernel_checks_refuse_autograd_and_bad_shapes():
    x = torch.randn(1, 2, 3, 4, 8)
    m = torch.ones(1, 8)
    norm._check_cuda("gn_bwd_reduce", x, m, m, g=x)
    with pytest.raises(ValueError, match="g must be"):
        norm._check_cuda("gn_bwd_reduce", x, m, m, g=x[..., :4])
    with pytest.raises(ValueError, match="g must be"):
        norm._check_cuda("gn_bwd_dx", x, m, m, m, g=x.bfloat16())
    with pytest.raises(RuntimeError, match="no backward"):
        norm._check_cuda("gn_bwd_dx", x, m, m, m,
                         g=x.clone().requires_grad_())


# -- kernel 3b (csrc/group_norm.cu, gn_affine_kernel): its work partition ----
#
# Replayed in numpy with the source's constants: a grid sized from the card
# (at most AFFINE_WAVES waves of resident blocks, at least one thread per
# unit of a row), each thread walking units t, t + stride, ... in groups of
# UNROLL, a unit being a 16-byte vector (4 fp32 or 8 bf16 channels)
# when C % V == 0 and x and y are aligned, else one scalar.  Every element
# must be written exactly once, by a thread whose channels never change,
# with the value the plain version gives, bit for bit.

def _affine_constants():
    import re

    from mdeical_image_segmentation_tpu_torch.ops import _build

    src = (_build.CSRC / "group_norm.cu").read_text()
    return {name: int(re.search(rf"constexpr int {name} = (\d+);", src)[1])
            for name in ("NT", "UNROLL", "AFFINE_WAVES")}


def _emulate_affine(x, a, b, aligned, sms, per_sm):
    k = _affine_constants()
    nt, unroll = k["NT"], k["UNROLL"]
    n, c = x.shape[0], x.shape[-1]
    s = x.numel() // (n * c)
    v = 16 // x.element_size()
    vec = c % v == 0 and aligned
    width = v if vec else 1
    lanes = c // width
    units = s * c // width
    per_block = nt * unroll
    g = min(-(-units // per_block), sms * per_sm * k["AFFINE_WAVES"] // n)
    g = max(g, -(-lanes // nt), 1)
    stride = g * nt // lanes * lanes
    xf = x.float().numpy().reshape(n, s * c)
    out = np.zeros((n, s * c), np.float32)
    writes = np.zeros((n, s * c), np.int32)
    an, bn = a.numpy(), b.numpy()
    for smp in range(n):
        for t in range(stride):  # threads t >= stride return at once
            c0 = (t % lanes) * width
            av, bv = an[smp, c0:c0 + width], bn[smp, c0:c0 + width]
            for i0 in range(t, units, unroll * stride):
                for i in range(i0, min(i0 + unroll * stride, units), stride):
                    e = np.arange(i * width, (i + 1) * width)
                    assert (e % c == np.arange(c0, c0 + width)).all()
                    out[smp, e] = np.float32(xf[smp, e] * av) + bv
                    writes[smp, e] += 1
    assert (writes == 1).all()
    y = torch.from_numpy(out.reshape(x.shape)).to(x.dtype)
    return y, vec, g


@pytest.mark.parametrize("c", [1, 3, 8, 19, 32, 192, 300])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("aligned", [True, False])
def test_affine_partition_writes_each_element_once_bit_exactly(c, dtype,
                                                               aligned):
    """On the H100's grid (132 SMs, 8 resident blocks) and on a 2-SM card,
    where each thread walks many groups of units."""
    rng = np.random.default_rng(c)
    shape = (2, 3, 5, 7, c)
    x = torch.from_numpy((1.5 * rng.standard_normal(shape)).astype(
        np.float32)).to(dtype)
    a = torch.from_numpy(rng.random((2, c)).astype(np.float32) + 0.5)
    b = torch.from_numpy(rng.standard_normal((2, c)).astype(np.float32))
    want = norm.gn_affine_reference(x, a, b)
    for sms, per_sm in ((132, 8), (2, 1)):
        y, vec, g = _emulate_affine(x, a, b, aligned, sms, per_sm)
        assert torch.equal(y, want)
        v = 16 // x.element_size()
        assert vec == (aligned and c % v == 0)
        assert g * 256 >= (c // v if vec else c)


@pytest.mark.parametrize("c", [1, 3, 19, 300])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_affine_matches_jax_affine_kernel_at_ragged_c(c, dtype):
    """3b's plain version against the JAX ``_affine_kernel`` run through
    ``_gn_grid`` in interpret mode, as ``_gn_fwd_pallas`` runs it, at the
    ragged C of the card checks (the kernel's scalar path)."""
    rng = np.random.default_rng(100 + c)
    n, d, h, w = 2, 3, 4, 5
    x = (1.5 * rng.standard_normal((n, d, h, w, c)) + 0.7).astype(np.float32)
    a = (rng.random((n, c)) + 0.5).astype(np.float32)
    b = rng.standard_normal((n, c)).astype(np.float32)
    jx4 = jnp.asarray(x).astype(dtype).reshape(n, d, h, w * c)
    y_j = jax_norm._gn_grid(jx4, 2, jax_norm._affine_kernel, 0,
                            out_full=jx4.dtype, interpret=True)(
        jx4, jax_norm._tile_row(jnp.asarray(a), w),
        jax_norm._tile_row(jnp.asarray(b), w))
    y = norm.gn_affine(_as(x, dtype), torch.from_numpy(a),
                       torch.from_numpy(b))
    assert y.dtype == getattr(torch, dtype)
    tol = FP32_TOL if dtype == "float32" else BF16_PALLAS_TOL
    np.testing.assert_allclose(
        _bf16_numpy(y), np.asarray(y_j.astype(jnp.float32)).reshape(x.shape),
        rtol=tol, atol=tol)

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


@pytest.mark.parametrize("rows,c", [(6_131_712, 1), (6_131_712, 192),
                                    (767_637, 64), (35, 19), (10, 300)])
def test_stats_grid_bounds_work_and_scratch(rows, c):
    """The stats kernel's blocks: a thread sums at most a few hundred rows
    at the 3D UNet's largest activations, and the scratch of partial sums
    stays under 2^21 floats per sample and statistic."""
    g = norm._grid(rows, c, norm._STATS_ROWS, norm._MAX_PARTIALS)
    lanes = 256 // min(c, 256)
    assert g >= 1 and g * c <= max(norm._MAX_PARTIALS, c)
    assert -(-rows // (g * lanes)) <= 1024

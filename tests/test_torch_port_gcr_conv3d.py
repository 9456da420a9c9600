"""The port's fused GroupNorm-apply + conv3d + ReLU (``mdeical_image_
segmentation_tpu_torch.ops.fused_conv.fused_conv3d`` and
``gcr_fused_conv``) against the JAX package's Pallas ``fused_conv3d`` and
``gcr_fused_conv`` run in interpret mode on the CPU, on the same numpy
inputs from a fixed seed.

Tolerances: float32 within rtol = atol = 1e-5 (the same products summed in
different orders); bfloat16 within rtol = atol = 2e-2 (both round the
affine output and y to bf16; a different fp32 sum order can move y by one
bf16 ulp at |y| < 4)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mdeical_image_segmentation_tpu.ops import fused_conv as jax_fc
from mdeical_image_segmentation_tpu_torch.ops import fused_conv

FP32_TOL = 1e-5
BF16_TOL = 2e-2


def _inputs(n, d, h, w, ci, co, kd, seed):
    rng = np.random.default_rng(seed)
    return (
        (rng.standard_normal((n, d, h, w, ci)) + 0.3).astype(np.float32),
        (rng.standard_normal((kd, 3, 3, ci, co))
         / np.sqrt(9 * kd * ci)).astype(np.float32),
        (0.5 + rng.random((n, ci))).astype(np.float32),
        (0.5 * rng.standard_normal((n, ci))).astype(np.float32),
    )


def _jax(x, k, a, b, dtype, **kw):
    y = jax_fc.fused_conv3d(jnp.asarray(x).astype(dtype),
                            jnp.asarray(k).astype(dtype), jnp.asarray(a),
                            jnp.asarray(b), interpret=True, **kw)
    return np.asarray(y.astype(jnp.float32))


def _port(x, k, a, b, dtype, **kw):
    t = getattr(torch, dtype)
    y = fused_conv.fused_conv3d(torch.from_numpy(x).to(t),
                                torch.from_numpy(k).to(t),
                                torch.from_numpy(a), torch.from_numpy(b), **kw)
    assert y.dtype == t and y.is_contiguous()
    return y.float().numpy()


@pytest.mark.parametrize("kd", [1, 3])
@pytest.mark.parametrize("pre_relu,post_relu", [(False, True), (True, False),
                                                (True, True)])
@pytest.mark.parametrize("ci", [1, 3, 12])
def test_matches_jax_pallas_kernel(kd, pre_relu, post_relu, ci):
    arrays = _inputs(2, 4, 8, 6, ci, 8, kd, seed=kd * 100 + ci)
    kw = dict(pre_relu=pre_relu, post_relu=post_relu)
    before = fused_conv.fused_conv3d.launches
    np.testing.assert_allclose(_port(*arrays, "float32", **kw),
                               _jax(*arrays, "float32", **kw),
                               rtol=FP32_TOL, atol=FP32_TOL)
    # a CPU tensor takes the plain version: no kernel launch is counted
    assert fused_conv.fused_conv3d.launches == before


@pytest.mark.parametrize("kd", [1, 3])
def test_bf16_matches_jax_pallas_kernel(kd):
    arrays = _inputs(1, 3, 8, 5, 8, 16, kd, seed=kd)
    np.testing.assert_allclose(_port(*arrays, "bfloat16"),
                               _jax(*arrays, "bfloat16"),
                               rtol=BF16_TOL, atol=BF16_TOL)


def test_padding_is_zero_after_the_affine():
    """The frame around the volume is zero in the NORMALIZED tensor: with
    a = 0 and b = 1 every in-volume tap sees 1 and every padded tap 0, so a
    1-weight 3x3x3 kernel counts the in-volume neighbours."""
    x = torch.zeros(1, 3, 4, 5, 1)
    k = torch.ones(3, 3, 3, 1, 1)
    y = fused_conv.fused_conv3d(x, k, torch.zeros(1, 1), torch.ones(1, 1))
    assert y[0, 1, 1, 1, 0] == 27       # interior
    assert y[0, 0, 0, 0, 0] == 8        # corner: 2 x 2 x 2 in the volume
    assert y[0, 1, 0, 2, 0] == 18       # face: 3 x 2 x 3


@pytest.mark.parametrize("ci,groups", [(1, 1), (3, 1), (8, 8), (16, 8),
                                       (12, 4)])
def test_gcr_fused_conv_matches_jax(ci, groups):
    arrays = _inputs(2, 4, 8, 6, ci, 8, 3, seed=ci + groups)
    x, k = arrays[0], arrays[1]
    rng = np.random.default_rng(groups)
    scale = (1 + 0.2 * rng.standard_normal(ci)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(ci)).astype(np.float32)
    y_jax = jax_fc.gcr_fused_conv(jnp.asarray(x), jnp.asarray(scale),
                                  jnp.asarray(bias), jnp.asarray(k), groups,
                                  1e-5, True)
    y = fused_conv.gcr_fused_conv(torch.from_numpy(x), torch.from_numpy(scale),
                                  torch.from_numpy(bias), torch.from_numpy(k),
                                  groups, 1e-5)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_jax), rtol=FP32_TOL,
                               atol=FP32_TOL)


def test_kernel_checks_run_before_any_launch():
    """Shape, dtype and autograd checks are plain Python and raise before
    the kernel library is touched."""
    x = torch.zeros(1, 2, 4, 4, 3)
    k, a = torch.zeros(3, 3, 3, 3, 5), torch.zeros(1, 3)
    fused_conv._check3d(x, k, a, a)
    with pytest.raises(ValueError, match="kernel must be"):
        fused_conv._check3d(x, torch.zeros(2, 3, 3, 3, 5), a, a)
    with pytest.raises(ValueError, match="pre_shift must be"):
        fused_conv._check3d(x, k, a, torch.zeros(1, 4))
    with pytest.raises(TypeError, match="kernel is torch.float64"):
        fused_conv._check3d(x, k.double(), a, a)
    with pytest.raises(ValueError, match="contiguous"):
        fused_conv._check3d(x.transpose(2, 3), k, a, a)
    with pytest.raises(RuntimeError, match="no backward"):
        fused_conv._check3d(x, k.requires_grad_(), a, a)


@pytest.mark.parametrize("kd", [1, 3])
@pytest.mark.parametrize("ci,groups", [(1, 1), (3, 1), (8, 8), (12, 4),
                                       (16, 8)])
def test_gcr_fused_conv_grads_match_jax_vjp(kd, ci, groups):
    """``gcr_fused_conv`` as an autograd Function: (dx, dscale, dbias, dw)
    against ``jax.vjp`` of the JAX package's custom-VJP ``gcr_fused_conv``
    in interpret mode (the oracle of its own
    test_gcr_block_gradients_match_unfused), fp32 within 1e-4 of each
    gradient's max |value| (dscale, dbias and dw sum the whole volume)."""
    import jax

    arrays = _inputs(2, 4, 8, 6, ci, 8, kd, seed=10 * kd + ci + groups)
    x, k = arrays[0], arrays[1]
    rng = np.random.default_rng(ci * groups)
    scale = (1 + 0.2 * rng.standard_normal(ci)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(ci)).astype(np.float32)
    g = rng.standard_normal((2, 4, 8, 6, 8)).astype(np.float32)
    y_jax, vjp = jax.vjp(
        lambda a, s, b, w: jax_fc.gcr_fused_conv(a, s, b, w, groups, 1e-5,
                                                 True),
        *(jnp.asarray(v) for v in (x, scale, bias, k)))
    want = vjp(jnp.asarray(g))
    tx, ts, tb, tk = (torch.from_numpy(v).requires_grad_()
                      for v in (x, scale, bias, k))
    y = fused_conv.gcr_fused_conv(tx, ts, tb, tk, groups, 1e-5)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_jax),
                               rtol=FP32_TOL, atol=FP32_TOL)
    got = torch.autograd.grad(y, (tx, ts, tb, tk), torch.from_numpy(g))
    for name, a, b in zip(("dx", "dscale", "dbias", "dw"), got, want):
        b = np.asarray(b)
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-4 * np.abs(b).max(), err_msg=name)


def test_gcr_fused_conv_input_grad_only_where_needed():
    """The image needs no gradient: the GroupNorm parameters and the kernel
    get theirs, and the dx pass (kernel 3d) does not run."""
    from mdeical_image_segmentation_tpu_torch.ops import norm

    x, k, _, _ = _inputs(1, 3, 8, 6, 1, 4, 3, seed=4)
    s = torch.ones(1, requires_grad=True)
    b = torch.zeros(1, requires_grad=True)
    tk = torch.from_numpy(k).requires_grad_()
    calls = []
    orig = norm.gn_bwd_dx
    norm.gn_bwd_dx = lambda *a: calls.append(1) or orig(*a)
    try:
        fused_conv.gcr_fused_conv(torch.from_numpy(x), s, b, tk, 1,
                                  1e-5).sum().backward()
    finally:
        norm.gn_bwd_dx = orig
    assert calls == []
    assert all(t.grad is not None and torch.isfinite(t.grad).all()
               for t in (s, b, tk))

"""The port's DoubleConv (``mdeical_image_segmentation_tpu_torch.ops.
fused_conv``) against the JAX package's Pallas ``fused_double2d``, run in
interpret mode on the CPU.  Inputs come from numpy with a fixed seed; y and
z agree in float32 within rtol = atol = 1e-5 (the two sides sum the same
products in different orders)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mdeical_image_segmentation_tpu.ops import fused_conv as jax_fc
from mdeical_image_segmentation_tpu_torch.models import DoubleConvolution
from mdeical_image_segmentation_tpu_torch.ops import fused_conv

TOL = 1e-5


def _inputs(n, h, w, ci, c1, co, seed):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((n, h, w, ci)).astype(np.float32),
        (0.2 * rng.standard_normal((3, 3, ci, c1))).astype(np.float32),
        (0.2 * rng.standard_normal((c1,))).astype(np.float32),
        (0.2 * rng.standard_normal((3, 3, c1, co))).astype(np.float32),
        (0.2 * rng.standard_normal((co,))).astype(np.float32),
    )


@pytest.mark.parametrize("shape", [
    (2, 8, 12, 8, 16, 16),   # the JAX package's own oracle case
    (1, 8, 8, 1, 8, 8),      # Ci = 1 (the UNet's first block, grey input)
    (1, 8, 8, 3, 8, 8),      # Ci = 3 (RGB input)
    (1, 7, 9, 4, 8, 6),      # odd H and W, Co != C1
    (1, 9, 7, 1, 5, 13),     # Ci = 1 (flattened K on the card), Co = 13
    (1, 6, 5, 19, 12, 65),   # ragged Ci and Co, Co not a multiple of 8
])
def test_matches_jax_pallas_kernel(shape):
    arrays = _inputs(*shape, seed=sum(shape))
    y_jax, z_jax = jax_fc.fused_double2d(
        *(jnp.asarray(a) for a in arrays), interpret=True)
    before = fused_conv.fused_double2d.launches
    y, z = fused_conv.fused_double2d(*(torch.from_numpy(a) for a in arrays))
    np.testing.assert_allclose(z.numpy(), np.asarray(z_jax), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_jax), rtol=TOL, atol=TOL)
    # a CPU tensor takes the plain version: no kernel launch is counted
    assert fused_conv.fused_double2d.launches == before


def test_without_z_returns_none_and_same_y():
    arrays = [torch.from_numpy(a) for a in _inputs(1, 6, 5, 3, 4, 5, seed=1)]
    y, z = fused_conv.fused_double2d(*arrays)
    y2, z2 = fused_conv.fused_double2d(*arrays, with_z=False)
    assert z is not None and z2 is None
    assert torch.equal(y, y2)
    assert y.is_contiguous() and y.shape == (1, 6, 5, 5)


def test_z_rounds_to_input_dtype():
    """bf16 in: z (the residual conv2 consumes) is bf16, as in the JAX
    kernel, and y equals conv2 applied to that rounded z."""
    arrays = [torch.from_numpy(a).to(torch.bfloat16)
              for a in _inputs(1, 6, 6, 4, 8, 4, seed=2)]
    y, z = fused_conv.fused_double2d(*arrays)
    assert z.dtype == torch.bfloat16 and y.dtype == torch.bfloat16
    w2, b2 = arrays[3], arrays[4]
    ref =torch.relu(torch.nn.functional.conv2d(
        z.permute(0, 3, 1, 2), w2.permute(3, 2, 0, 1), b2, padding=1))
    assert torch.equal(y, ref.permute(0, 2, 3, 1))


def test_non_cpu_non_cuda_tensor_raises():
    arrays = [torch.from_numpy(a).to("meta") for a in _inputs(1, 4, 4, 2, 2, 2,
                                                              seed=3)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_conv.fused_double2d(*arrays)


def test_double_convolution_module_matches_two_convs():
    """The module passes its OIHW weights to the kernel's HWIO interface;
    on the CPU it equals two plain NHWC conv+relu layers."""
    g = torch.Generator().manual_seed(0)
    dc = DoubleConvolution(3, 8)
    dc.reset_parameters(g)
    x = torch.from_numpy(_inputs(2, 9, 7, 3, 1, 1, seed=4)[0])
    with torch.no_grad():
        want = torch.relu(dc.TorchConv_1(torch.relu(dc.TorchConv_0(x))))
        got = dc(x)
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)


# -- gradients: double_conv2d, the autograd Function ---------------------------

GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # relative to max |grad|


def _rel_err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 8, 12, 8, 16, 16), (1, 7, 9, 1, 8, 6),
                                   (2, 6, 5, 19, 12, 13)])
def test_gradients_match_jax_vjp_and_plain_autograd(shape, dtype):
    """dx, dw1, db1, dw2, db2 of ``double_conv2d`` against the JAX custom
    VJP (its Pallas forward in interpret mode) and against torch autograd
    through the plain composition (two conv2d + relu).  Float32 within 1e-4
    of each gradient's max |value| (sums in different orders), bfloat16
    within 2e-2 (both round every conv output to bf16)."""
    import jax

    arrays = _inputs(*shape, seed=sum(shape) + 11)
    g = np.random.default_rng(5).standard_normal(
        (*shape[:3], shape[5])).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jargs = [jnp.asarray(a, jdt) for a in arrays]
    y_jax, vjp = jax.vjp(
        lambda *a: jax_fc.double_conv2d(*a, True), *jargs)
    want_jax = vjp(jnp.asarray(g, jdt))

    tdt = getattr(torch, dtype)
    targs = [torch.from_numpy(a).to(tdt).requires_grad_() for a in arrays]
    y = fused_conv.double_conv2d(*targs)
    assert y.dtype == tdt and y.grad_fn is not None
    np.testing.assert_allclose(y.detach().float().numpy(),
                               np.asarray(y_jax, np.float32),
                               rtol=GRAD_TOL[dtype], atol=GRAD_TOL[dtype])
    got = torch.autograd.grad(y, targs, torch.from_numpy(g).to(tdt))
    assert [t.dtype for t in got] == [tdt] * 5

    def plain(x, w1, b1, w2, b2):
        conv = lambda t, w, b: torch.nn.functional.conv2d(
            t.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), b, padding=1
        ).permute(0, 2, 3, 1)
        return torch.relu(conv(torch.relu(conv(x, w1, b1)), w2, b2))

    pargs = [torch.from_numpy(a).to(tdt).requires_grad_() for a in arrays]
    want_plain = torch.autograd.grad(plain(*pargs), pargs,
                                     torch.from_numpy(g).to(tdt))
    for name, a, b, c in zip(("dx", "dw1", "db1", "dw2", "db2"), got,
                             want_jax, want_plain):
        a = a.float().numpy()
        assert _rel_err(a, b) <= GRAD_TOL[dtype], (name, "jax")
        assert _rel_err(a, c.float().numpy()) <= GRAD_TOL[dtype], (name,
                                                                   "plain")


def test_gradients_reach_fp32_master_weights_under_bf16_compute():
    """The module casts fp32 weights to bf16 at use: the kernel call sees
    bf16, autograd returns fp32 gradients equal to the bf16 ones upcast."""
    g = torch.Generator().manual_seed(3)
    dc = DoubleConvolution(3, 8)
    dc.reset_parameters(g)
    x = torch.rand(2, 9, 7, 3, generator=g).to(torch.bfloat16)
    y = dc(x)
    assert y.dtype == torch.bfloat16 and y.grad_fn is not None
    y.float().square().sum().backward()
    w1, b1 = dc.TorchConv_0.hwio(torch.bfloat16)
    w2, b2 = dc.TorchConv_1.hwio(torch.bfloat16)
    args = [t.detach().requires_grad_() for t in (w1, b1, w2, b2)]
    fused_conv.double_conv2d(x, *args).float().square().sum().backward()
    w = dc.TorchConv_0.weight
    assert w.grad.dtype == torch.float32
    torch.testing.assert_close(w.grad, args[0].grad.float().permute(3, 2, 0, 1),
                               rtol=0, atol=0)
    torch.testing.assert_close(dc.TorchConv_1.bias.grad, args[3].grad.float(),
                               rtol=0, atol=0)


def test_module_without_autograd_takes_the_forward_only_call(monkeypatch):
    """Under no_grad (serving) the module calls ``fused_double2d`` without
    z; while autograd records it calls ``double_conv2d``."""
    calls = []
    real = fused_conv.fused_double2d

    def spy(*a, with_z=True):
        calls.append(with_z)
        return real(*a, with_z=with_z)

    monkeypatch.setattr(fused_conv, "fused_double2d", spy)
    import mdeical_image_segmentation_tpu_torch.models.layers2d as layers2d
    monkeypatch.setattr(layers2d, "fused_double2d", spy)
    dc = DoubleConvolution(2, 4)
    dc.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.rand(1, 5, 5, 2)
    with torch.no_grad():
        dc(x)
    dc(x)
    assert calls == [False, True]


def test_raw_cuda_wrapper_refuses_tensors_that_need_grad():
    """The guard sits in the CUDA path's checks (here called directly, as a
    CUDA call would): a tensor that autograd tracks raises, under no_grad
    it passes."""
    x = torch.zeros(1, 4, 4, 2)
    w1, b1 = torch.zeros(3, 3, 2, 3, requires_grad=True), torch.zeros(3)
    w2, b2 = torch.zeros(3, 3, 3, 5), torch.zeros(5)
    with pytest.raises(RuntimeError, match="double_conv2d"):
        fused_conv._check(x, w1, b1, w2, b2)
    with torch.no_grad():
        fused_conv._check(x, w1, b1, w2, b2)

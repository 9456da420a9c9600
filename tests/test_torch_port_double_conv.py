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

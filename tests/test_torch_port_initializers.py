"""The port's initializers (``ops/initializers.py``) against the JAX
package's and PyTorch's own, by distribution, as ``test_initializers.py``
checks the JAX ones: the same standard deviation (within 5% at 16-32k
draws, about 10 standard errors) and the same uniform bound, the fan
counted the PyTorch way for convs (I·k²) and ConvTranspose (O·k²),
orthogonal rows, norm scales N(1, 0.02²), and the same draws from the same
generator."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdeical_image_segmentation_tpu.ops import initializers as jinit
from mdeical_image_segmentation_tpu_torch.models import (
    TorchBatchNorm,
    TorchConv,
    TorchConvTranspose,
)
from mdeical_image_segmentation_tpu_torch.ops import initializers as tinit

STD_RTOL = 0.05
KEY = jax.random.PRNGKey(0)
# torch layout (O, I, kH, kW) of a conv and (I, O, kH, kW) of a deconv, and
# the flax kernel (kH, kW, I, O) both describe
CONV = ((64, 32, 3, 3), (3, 3, 32, 64), False)
DECONV = ((32, 64, 4, 4), (4, 4, 32, 64), True)


def _port(init_type, shape, seed=0):
    w = torch.empty(shape)
    tinit.conv_kernel_init(init_type)(w, torch.Generator().manual_seed(seed))
    return w.numpy()


@pytest.mark.parametrize("torch_shape,flax_shape,transpose", [CONV, DECONV])
@pytest.mark.parametrize("init_type", ["normal", "xavier", "kaiming"])
def test_normal_family_std_matches_jax_and_torch(init_type, torch_shape,
                                                 flax_shape, transpose):
    got = _port(init_type, torch_shape)
    want = np.asarray(jinit.conv_kernel_init(init_type, transpose=transpose)(
        KEY, flax_shape))
    t = torch.empty(torch_shape)
    torch.manual_seed(0)
    {"normal": lambda w: torch.nn.init.normal_(w, 0.0, 0.02),
     "xavier": torch.nn.init.xavier_normal_,
     "kaiming": torch.nn.init.kaiming_normal_}[init_type](t)
    np.testing.assert_allclose(got.std(), want.std(), rtol=STD_RTOL)
    np.testing.assert_allclose(got.std(), float(t.std()), rtol=STD_RTOL)
    assert abs(got.mean()) < 0.05 * got.std()


@pytest.mark.parametrize("torch_shape,flax_shape,transpose", [CONV, DECONV])
def test_kaiming_counts_the_torch_fan(torch_shape, flax_shape, transpose):
    """fan_in = I·k² for a conv, O·k² for a ConvTranspose (weight dim 1)."""
    fan_in = torch_shape[1] * torch_shape[2] * torch_shape[3]
    np.testing.assert_allclose(_port("kaiming", torch_shape).std(),
                               math.sqrt(2.0 / fan_in), rtol=STD_RTOL)


@pytest.mark.parametrize("torch_shape,flax_shape,transpose", [CONV, DECONV])
def test_torch_default_bound_matches_jax(torch_shape, flax_shape, transpose):
    got = _port("torch_default", torch_shape)
    want = np.asarray(jinit.torch_conv_default_kernel(transpose=transpose)(
        KEY, flax_shape))
    bound = 1.0 / math.sqrt(torch_shape[1] * torch_shape[2] * torch_shape[3])
    for a in (got, want):
        assert np.abs(a).max() <= bound + 1e-7
        assert np.abs(a).max() > 0.98 * bound
    np.testing.assert_allclose(got.std(), want.std(), rtol=STD_RTOL)


@pytest.mark.parametrize("torch_shape,flax_shape,transpose", [CONV, DECONV])
def test_orthogonal_rows_like_torch(torch_shape, flax_shape, transpose):
    """``w.view(dim0, -1)``: 64 rows of 288 for the conv, 32 rows of 1024
    for the deconv, orthonormal in both packages."""
    got = _port("orthogonal", torch_shape).reshape(torch_shape[0], -1)
    np.testing.assert_allclose(got @ got.T, np.eye(torch_shape[0]),
                               atol=1e-4)
    want = np.asarray(jinit.orthogonal(transpose=transpose)(KEY, flax_shape))
    if transpose:  # (k, k, I, O) -> rows I of (O·k²), as torch views (I, O, k, k)
        mat = np.transpose(want, (2, 3, 0, 1)).reshape(torch_shape[0], -1)
    else:  # (k, k, I, O) -> rows O of (I·k²)
        mat = np.transpose(want, (3, 2, 0, 1)).reshape(torch_shape[0], -1)
    np.testing.assert_allclose(mat @ mat.T, np.eye(torch_shape[0]),
                               atol=1e-4)


def test_norm_scale_and_bias():
    bn = TorchBatchNorm(4096, init_type="kaiming")
    bn.reset_parameters(torch.Generator().manual_seed(0))
    w = bn.weight.detach().numpy()
    want = np.asarray(jinit.norm_scale_002()(KEY, (4096,)))
    np.testing.assert_allclose(w.mean(), 1.0, atol=2e-3)
    np.testing.assert_allclose(w.std(), want.std(), rtol=STD_RTOL)
    np.testing.assert_allclose(w.std(), 0.02, rtol=STD_RTOL)
    assert not bn.bias.detach().any()
    assert not bn.running_mean.any() and (bn.running_var == 1).all()
    plain = TorchBatchNorm(8)
    plain.reset_parameters(torch.Generator().manual_seed(0))
    assert (plain.weight == 1).all()


@pytest.mark.parametrize("module", [
    lambda k: TorchConv(32, 64, (3, 3), kernel_init=k),
    lambda k: TorchConvTranspose(32, 64, (4, 4), (2, 2), padding=1,
                                 kernel_init=k),
])
@pytest.mark.parametrize("init_type", ["kaiming", "orthogonal"])
def test_modules_draw_the_named_init_and_the_torch_bias(module, init_type):
    """The weight by ``kernel_init``, the bias by PyTorch's default with the
    weight's fan_in, from the generator, the same draws every time."""
    a, b = module(init_type), module(init_type)
    a.reset_parameters(torch.Generator().manual_seed(3))
    b.reset_parameters(torch.Generator().manual_seed(3))
    assert torch.equal(a.weight, b.weight) and torch.equal(a.bias, b.bias)
    fan_in = a.weight[0].numel()
    assert a.bias.abs().max() <= 1.0 / math.sqrt(fan_in)
    if init_type == "kaiming":
        np.testing.assert_allclose(float(a.weight.detach().std()),
                                   math.sqrt(2.0 / fan_in), rtol=0.1)


def test_unknown_init_raises():
    with pytest.raises(NotImplementedError, match="bogus"):
        tinit.conv_kernel_init("bogus")
    with pytest.raises(NotImplementedError, match="bogus"):
        TorchConv(2, 2, kernel_init="bogus")

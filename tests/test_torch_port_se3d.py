"""Squeeze-excitation in the port (``models/se3d.py``, ``ResNetBlockSE``,
``ResidualUNetSE3D``) against the JAX package's ``models/se3d.py`` and
``ResidualUNetSE3D``, with the flax weights carried across by the parameter
bridge (flax ``Dense`` kernels (in, out) ↔ torch (out, in)).

Tolerances (float32 on the CPU): outputs within rtol = atol = 1e-5 for the
gates and within 1e-5 of max |y| for the model; gradients within 1e-5 of
each leaf's max |gradient| for the gates, and, for the model, within 1e-5
relative in L2 over all leaves (both packages sum in other orders, which
GroupNorm's E[x²] − mean² amplifies in single leaves)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mdeical_image_segmentation_tpu.losses import losses3d as jax_losses
from mdeical_image_segmentation_tpu.models import get_model as jax_get_model
from mdeical_image_segmentation_tpu.models import se3d as jax_se3d
from mdeical_image_segmentation_tpu_torch.losses import get_loss_criterion
from mdeical_image_segmentation_tpu_torch.models import get_model, se3d
from mdeical_image_segmentation_tpu_torch.utils.param_bridge import (
    flax_to_state_dict,
    state_dict_to_flax,
)

TOL = 1e-5


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


@pytest.mark.parametrize("name", ["cse", "sse", "scse"])
@pytest.mark.parametrize("shape", [(2, 4, 6, 5, 8), (2, 9, 7, 6)],
                         ids=["3d", "2d"])
def test_gates_match_jax(name, shape):
    rng = np.random.default_rng(len(name) + len(shape))
    x = rng.standard_normal(shape).astype(np.float32)
    jm = jax_se3d.SE_MODULES[name](None)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    want_y, vjp = jax.vjp(lambda p, xx: jm.apply({"params": p}, xx), params,
                          jnp.asarray(x))
    cot = rng.standard_normal(shape).astype(np.float32)
    want_gp, want_gx = vjp(jnp.asarray(cot))

    m = se3d.se_module(name, shape[-1], len(shape) - 2)
    m.load_state_dict({k.split(".", 1)[1]: v for k, v in flax_to_state_dict(
        {"m": params}).items()})
    xt = torch.from_numpy(x).requires_grad_(True)
    y = m(xt)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y),
                               rtol=TOL, atol=TOL)
    y.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_gx),
                               rtol=0, atol=TOL * np.abs(want_gx).max())
    want = {k.split(".", 1)[1]: v for k, v in flax_to_state_dict(
        {"m": jax.tree_util.tree_map(np.asarray, want_gp)}).items()}
    grads = dict(m.named_parameters())
    assert sorted(grads) == sorted(want)
    for n, w in want.items():
        np.testing.assert_allclose(grads[n].grad.numpy(), w.numpy(), rtol=0,
                                   atol=TOL * float(w.abs().max()),
                                   err_msg=n)


CFG = {"name": "ResidualUNetSE3D", "in_channels": 2, "out_channels": 2,
       "f_maps": 8, "num_levels": 3}


@pytest.fixture(scope="module")
def model_case():
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((2, 8, 16, 12, 2)) + 0.5).astype(np.float32)
    t = (rng.random((2, 8, 16, 12, 2)) > 0.5).astype(np.float32)
    jm = jax_get_model(CFG)
    params = jm.init(jax.random.PRNGKey(3), jnp.asarray(x), False)["params"]
    loss = jax_losses.BCEDiceLoss()
    y = np.asarray(jm.apply({"params": params}, jnp.asarray(x), False))
    grads = jax.grad(lambda p: loss(jm.apply({"params": p}, jnp.asarray(x),
                                             True), jnp.asarray(t)))(params)
    return x, t, jax.tree_util.tree_map(np.asarray, params), y, grads


def test_residual_unet_se3d_forward_and_grads_match_jax(model_case):
    x, t, params, y_jax, g_jax = model_case
    model = get_model(CFG)
    model.load_state_dict(flax_to_state_dict({"params": params}))
    with torch.no_grad():
        y = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, y_jax, rtol=0,
                               atol=TOL * np.abs(y_jax).max())
    model.train()
    get_loss_criterion({"loss": {"name": "BCEDiceLoss"}})(
        model(torch.from_numpy(x)), torch.from_numpy(t)).backward()
    want = flax_to_state_dict({"params": g_jax})
    grads = dict(model.named_parameters())
    assert sorted(grads) == sorted(want)
    num = sum(float(((grads[n].grad - w) ** 2).sum()) for n, w in want.items())
    den = sum(float((w ** 2).sum()) for w in want.values())
    assert (num / den) ** 0.5 < TOL


def test_bridge_both_ways_keeps_the_se_leaves(model_case):
    """flax → torch → flax gives the flax tree leaf for leaf, the Dense
    kernels included; the torch side stores (out, in)."""
    _, _, params, _, _ = model_case
    model = get_model(CFG)
    model.load_state_dict(flax_to_state_dict({"params": params}), strict=True)
    dense = model.encoder1.basic_module.ChannelSpatialSELayer_0\
        .ChannelSELayer_0.Dense_0
    flax_kernel = params["encoder1"]["basic_module"][
        "ChannelSpatialSELayer_0"]["ChannelSELayer_0"]["Dense_0"]["kernel"]
    assert np.array_equal(dense.weight.detach().numpy(), flax_kernel.T)
    back = dict(_leaves(state_dict_to_flax(model.state_dict())["params"]))
    theirs = dict(_leaves(params))
    assert sorted(back) == sorted(theirs)
    for k, v in theirs.items():
        assert back[k].shape == v.shape and np.array_equal(back[k], v), k


def test_seeded_init_draws_dense_as_flax_does():
    """Dense kernels: lecun-normal (truncated at 2 std, variance 1/fan_in);
    biases zero; the same seed gives the same weights."""
    a = get_model({**CFG, "f_maps": 32, "num_levels": 2},
                  generator=torch.Generator().manual_seed(0))
    b = get_model({**CFG, "f_maps": 32, "num_levels": 2},
                  generator=torch.Generator().manual_seed(0))
    for (k, p), (_, q) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(p, q), k
    dense = [m for m in a.modules() if isinstance(m, se3d.Dense)]
    assert dense
    for m in dense:
        w, fan_in = m.weight.detach(), m.weight.shape[1]
        assert float(m.bias.detach().abs().max()) == 0
        # 1024+ draws: the sample variance lies within ~5% of its mean
        assert abs(float(w.var()) * fan_in - 1.0) < 0.2
        assert float(w.abs().max()) <= 2 * (1 / fan_in) ** 0.5 / 0.8796 + 1e-6


def test_unknown_se_module_raises():
    with pytest.raises(ValueError, match="se_module"):
        se3d.se_module("ese", 8, 3)

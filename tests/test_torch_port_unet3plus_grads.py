"""Gradients of the port's UNet-3+ family against ``jax.vjp`` of the JAX
modules, through the parameter bridge, in float64 on both sides.

In float32 neither package resolves these gradients at 32²-48², batch 2:
BatchNorm over 8-18 values a channel at the bottleneck and the ReLU masks
behind it turn rounding into gradient differences, and the JAX package's
own float32 gradients lie up to 1e-2-1e-1 of a leaf's max |value| from its
float64 ones (the port's alike).  In float64 (both packages still
interpolate in float32, as the JAX package does) every leaf agrees within
1e-5 of its max |value| (GRAD_TOL; measured ~2e-7), the outputs and
batch statistics within 1e-6 (OUT_TOL; measured ~1e-7).  The conv biases in
front of a BatchNorm have an exact gradient of 0 (BatchNorm removes the
mean), so those are held against the model's largest gradient instead.
The forward outputs and the training-mode batch statistics come along.
CGM is compared in eval mode, where its dropout is off, with its gate
open (a closed gate multiplies every head by 0); its gate conv gets no
gradient (an argmax) on either side.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mdeical_image_segmentation_tpu.models import UNetConfig as JaxUNetConfig
from mdeical_image_segmentation_tpu.models import UNetModel as JaxUNetModel
from mdeical_image_segmentation_tpu_torch.models import UNetConfig, UNetModel
from mdeical_image_segmentation_tpu_torch.utils.param_bridge import (
    state_dict_to_flax,
)

GRAD_TOL = 1e-5
OUT_TOL = 1e-6  # outputs and batch statistics (float32 interpolation)


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v, np.float64)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def _pre_bn_bias(key: str) -> bool:
    return "_UNet3PlusBackbone_0" in key and key.endswith(
        "['Conv_0']['bias']")


@pytest.mark.parametrize("unet_type,hw,train", [
    ("UNet_3Plus", 32, True),
    ("UNet_3Plus_DeepSup_CGM", 32, False),
])
def test_gradients_match_jax_vjp_in_float64(unet_type, hw, train):
    check_gradients(unet_type, hw, train)


def check_gradients(unet_type, hw, train):
    """One type at hw², batch 2: outputs, gradients and (training mode)
    batch statistics against ``jax.vjp`` in float64.  48² runs in
    ``test_torch_port_unet3plus_grads48.py`` (its own file, so the two
    spread over the test workers)."""
    model = UNetModel(UNetConfig(in_channels=3, out_channels=1,
                                 unet_type=unet_type), device="cpu",
                      generator=torch.Generator().manual_seed(hw))
    model.module.double().train(train)
    if unet_type.endswith("CGM"):  # open the gate (class 1), or no
        with torch.no_grad():      # gradient reaches any weight
            model.module.TorchConv_0.bias.copy_(torch.tensor([0.0, 5.0]))
    rng = np.random.default_rng(hw)
    x = rng.random((2, hw, hw, 3))
    jm = JaxUNetModel(JaxUNetConfig(in_channels=3, out_channels=1,
                                    unet_type=unet_type)).module
    with jax.enable_x64(True):
        variables = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64),
            state_dict_to_flax(model.module.state_dict()))

        def fwd(params, xx):
            v = dict(variables, params=params)
            if train:
                out, mut = jm.apply(v, xx, True, mutable=["batch_stats"])
                return out, mut["batch_stats"]
            return jm.apply(v, xx, False), variables["batch_stats"]

        @jax.jit
        def fwd_vjp(params, xx, cot):
            out, vjp, stats = jax.vjp(lambda p: fwd(p, xx), params,
                                      has_aux=True)
            return out, stats, vjp(cot)[0]

        shapes = jax.eval_shape(lambda p: fwd(p, jnp.asarray(x))[0],
                                variables["params"])
        cot = jax.tree_util.tree_map(
            lambda s: rng.standard_normal(s.shape), shapes)
        want_out, want_stats, want_grads = fwd_vjp(
            variables["params"], jnp.asarray(x),
            jax.tree_util.tree_map(jnp.asarray, cot))
        want_out = jax.tree_util.tree_leaves(want_out)
        want_stats, want_grads = _leaves(want_stats), _leaves(want_grads)

    out = model.module(torch.from_numpy(x), torch.Generator())
    outs = out if isinstance(out, tuple) else (out,)
    assert outs[0].dtype == torch.float64
    for o, w in zip(outs, want_out):
        w = np.asarray(w)
        assert np.abs(o.detach().numpy() - w).max() <= OUT_TOL * np.abs(
            w).max()
    sum((o * torch.from_numpy(c)).sum()
        for o, c in zip(outs, jax.tree_util.tree_leaves(cot))).backward()

    got = _leaves(state_dict_to_flax(
        {n: torch.zeros_like(p) if p.grad is None else p.grad  # CGM's gate
         for n, p in model.module.named_parameters()})["params"])
    assert got.keys() == want_grads.keys()
    top = max(np.abs(v).max() for v in want_grads.values())
    errs = {}
    for k, w in want_grads.items():
        # CGM's gate conv sits behind an argmax: 0 on both sides
        scale = top if _pre_bn_bias(k) or not w.any() else np.abs(w).max()
        errs[k] = np.abs(got[k] - w).max() / scale
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_TOL, f"{worst}: {errs[worst]:.2e}"

    stats = _leaves(state_dict_to_flax(model.module.state_dict())[
        "batch_stats"])
    assert stats.keys() == want_stats.keys()
    for k, w in want_stats.items():
        assert np.abs(stats[k] - w).max() <= OUT_TOL * np.abs(w).max(), k

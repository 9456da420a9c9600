"""bf16 compute in the port's 3D family (``models/unet3d.py``,
``models/blocks3d.py``) against the JAX package's ``dtype: bfloat16``
models on the CPU, with the flax weights carried across by the parameter
bridge.

Both keep float32 parameters and compute in bf16; the port runs the fused
'gcr' Function (its plain version on the CPU) where the JAX package's CPU
path runs GroupNorm then conv, and each rounds to bf16 in other places.

Tolerances, set from bf16's 8 bits:

- logits within 3e-2 x max |y_jax| (a few bf16 ulps of the output);
- the BCEDice loss of one training step within 1e-2 relative;
- gradients: in bf16 neither package resolves most leaves: the JAX
  package's own bf16 gradient lies tens of percent of a leaf's max |grad|
  from its float32 gradient (most of all the final conv's bias, a sum over
  every voxel accumulated in bf16), and the port's lies as far on other
  leaves.  So the port's bf16 gradient is held to the float32 gradient of
  the same weights: its relative L2 error over all leaves must not exceed
  the JAX package's bf16 one, every leaf must be finite, and every
  gradient and parameter must stay float32."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mdeical_image_segmentation_tpu.losses import losses3d as jax_losses
from mdeical_image_segmentation_tpu.models import get_model as jax_get_model
from mdeical_image_segmentation_tpu_torch.losses import get_loss_criterion
from mdeical_image_segmentation_tpu_torch.models import get_model
from mdeical_image_segmentation_tpu_torch.models.unet3d import compute_dtype
from mdeical_image_segmentation_tpu_torch.train import optimizers
from mdeical_image_segmentation_tpu_torch.utils.param_bridge import (
    flax_to_state_dict,
)

FWD_TOL = 3e-2
LOSS_TOL = 1e-2

CONFIGS = {
    "unet3d_l3": {"name": "UNet3D", "in_channels": 1, "out_channels": 1,
                  "f_maps": 8, "num_levels": 3},
    "residual_l3": {"name": "ResidualUNet3D", "in_channels": 2,
                    "out_channels": 1, "f_maps": 8, "num_levels": 3},
}
SMALL = {"name": "UNet3D", "in_channels": 1, "out_channels": 2, "f_maps": 8,
         "num_levels": 2}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def case(request):
    """The config, seeded inputs, the JAX float32 weights, and the JAX
    package's bf16 logits, loss and gradients plus its float32 gradients."""
    cfg = CONFIGS[request.param]
    rng = np.random.default_rng(len(request.param))
    x = (rng.standard_normal((2, 8, 16, 16, cfg["in_channels"])) + 0.5
         ).astype(np.float32)
    t = (rng.random((2, 8, 16, 16, cfg["out_channels"])) > 0.5).astype(
        np.float32)
    j32 = jax_get_model(cfg)
    j16 = jax_get_model({**cfg, "dtype": "bfloat16"})
    params = j32.init(jax.random.PRNGKey(2), jnp.asarray(x), False)["params"]
    loss = jax_losses.BCEDiceLoss()

    def loss_of(model):
        return lambda p: loss(model.apply({"params": p}, jnp.asarray(x),
                                          True), jnp.asarray(t))

    y16 = np.asarray(j16.apply({"params": params}, jnp.asarray(x), False))
    l16, g16 = jax.value_and_grad(loss_of(j16))(params)
    g32 = jax.grad(loss_of(j32))(params)
    return {"cfg": cfg, "x": x, "t": t, "params": params, "y16": y16,
            "loss16": float(l16),
            "g16": flax_to_state_dict({"params": g16}),
            "g32": flax_to_state_dict({"params": g32})}


def _port(case):
    model = get_model({**case["cfg"], "dtype": "bfloat16"})
    model.load_state_dict(flax_to_state_dict({"params": case["params"]}))
    return model


def test_forward_matches_jax_bf16(case):
    model = _port(case)
    assert model.dtype == torch.bfloat16
    with torch.no_grad():
        y = model(torch.from_numpy(case["x"]))
    assert y.dtype == torch.float32 and y.shape == case["y16"].shape
    np.testing.assert_allclose(y.numpy(), case["y16"], rtol=0,
                               atol=FWD_TOL * np.abs(case["y16"]).max())


def test_training_step_loss_and_gradients(case):
    model = _port(case).train()
    loss = get_loss_criterion({"loss": {"name": "BCEDiceLoss"}})(
        model(torch.from_numpy(case["x"])), torch.from_numpy(case["t"]))
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(loss.item(), case["loss16"], rtol=LOSS_TOL)
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    g32, g16 = case["g32"], case["g16"]
    assert sorted(grads) == sorted(g32)
    for n, g in grads.items():
        assert g is not None and g.dtype == torch.float32, n
        assert torch.isfinite(g).all(), n

    def rel_l2(got):
        num = sum(float(((got[n] - w) ** 2).sum()) for n, w in g32.items())
        den = sum(float((w ** 2).sum()) for w in g32.values())
        return (num / den) ** 0.5

    port_err, jax_err = rel_l2(grads), rel_l2(g16)
    assert port_err <= jax_err, (port_err, jax_err)


def test_master_weights_stay_float32_through_adam():
    """An Adam step on the bf16 model updates float32 parameters with
    float32 moments, and the checkpoint tree holds float32 leaves."""
    from mdeical_image_segmentation_tpu_torch.train import checkpoint as ckpt

    cfg = {**SMALL, "dtype": "bfloat16"}
    model = get_model(cfg, generator=torch.Generator().manual_seed(0))
    model.train()
    opt = optimizers.create_optimizer({"name": "Adam",
                                       "learning_rate": 1e-3},
                                      model.parameters())
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    x = torch.rand(1, 8, 16, 16, 1)
    model(x).square().mean().backward()
    opt.step()
    for n, p in model.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, n
        st = opt.state[p]
        assert st["exp_avg"].dtype == torch.float32, n
    assert any(not torch.equal(before[n], p)
               for n, p in model.named_parameters())
    tree = ckpt.optimizer_state_tree(opt, model)
    for leaf in jax.tree_util.tree_leaves(tree["inner_state"]):
        assert np.asarray(leaf).dtype in (np.float32, np.int32)


@pytest.mark.parametrize("given,want", [
    (None, None), ("float32", None), ("jnp.float32", None),
    (torch.float32, None), ("bfloat16", torch.bfloat16),
    ("jnp.bfloat16", torch.bfloat16), (torch.bfloat16, torch.bfloat16)])
def test_compute_dtype_names(given, want):
    assert compute_dtype(given) == want


def test_other_dtypes_raise():
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        get_model({**CONFIGS["unet3d_l3"], "dtype": "float16"})

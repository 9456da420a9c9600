"""The port's 3D UNet family (``mdeical_image_segmentation_tpu_torch.models.
unet3d``) against the JAX package's ``model.apply``, with the flax weights
carried across by the parameter bridge; the bridge's round trip; and
checkpoints written by one package's ``save_checkpoint`` and read by the
other's ``load_checkpoint``.

Tolerance: logits within rtol = atol = 1e-4 in float32.  Observed errors
are ~1e-5: both sides sum the same terms in other orders, and GroupNorm's
E[x²] − mean² (kept from the JAX package) amplifies that difference where
a channel's spread is small against its mean.  The one-channel input of
the ResidualUNet3D, whose 1x1 shortcut makes such channels, is
therefore given two channels here."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from mdeical_image_segmentation_tpu.models import get_model as jax_get_model
from mdeical_image_segmentation_tpu.train import checkpoint as jax_ckpt
from mdeical_image_segmentation_tpu_torch.models import get_model
from mdeical_image_segmentation_tpu_torch.models import blocks3d, unet3d
from mdeical_image_segmentation_tpu_torch.train import (
    load_checkpoint,
    save_checkpoint,
)
from mdeical_image_segmentation_tpu_torch.utils.param_bridge import (
    flax_to_state_dict,
    state_dict_to_flax,
)

TOL = 1e-4

CONFIGS = {
    "unet3d_f8_l3": {"name": "UNet3D", "in_channels": 1, "out_channels": 2,
                     "f_maps": 8, "num_levels": 3, "layer_order": "gcr"},
    "unet3d_f4_l2_sigmoid": {"name": "UNet3D", "in_channels": 1,
                             "out_channels": 1, "f_maps": 8,
                             "num_levels": 2},
    "residual_f8_l3": {"name": "ResidualUNet3D", "in_channels": 2,
                       "out_channels": 2, "f_maps": 8, "num_levels": 3,
                       "layer_order": "gcr"},
    "residual_f16_l3_odd": {"name": "ResidualUNet3D", "in_channels": 3,
                            "out_channels": 1, "f_maps": 16,
                            "num_levels": 3},
}


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    cfg = CONFIGS[request.param]
    jm = jax_get_model(cfg)
    rng = np.random.default_rng(len(request.param))
    # odd H and W: floor-mode pooling and the nearest / deconv resizes
    x = (3 * rng.standard_normal((2, 8, 18, 14, cfg["in_channels"]))
         ).astype(np.float32)
    variables = jm.init(jax.random.PRNGKey(1), jnp.asarray(x), False)
    params = {"params": jax.tree_util.tree_map(np.asarray,
                                               variables["params"])}
    return cfg, jm, variables, params, x


def test_logits_match_jax_apply(pair):
    cfg, jm, variables, params, x = pair
    y_jax = np.asarray(jm.apply(variables, jnp.asarray(x), False))
    model = get_model(cfg)
    model.load_state_dict(flax_to_state_dict(params))
    with torch.no_grad():
        y = model(torch.from_numpy(x))
    assert y.dtype == torch.float32 and y.shape == y_jax.shape
    np.testing.assert_allclose(y.numpy(), y_jax, rtol=TOL, atol=TOL)


def test_bridge_round_trip_is_exact(pair):
    """flax → state_dict → flax gives the same tree, leaf for leaf (every
    flax leaf has a port parameter: the load is strict)."""
    cfg, _, _, params, _ = pair
    model = get_model(cfg)
    model.load_state_dict(flax_to_state_dict(params), strict=True)
    ours = dict(_leaves(state_dict_to_flax(model.state_dict())["params"]))
    theirs = dict(_leaves(params["params"]))
    assert sorted(ours) == sorted(theirs)
    for k, b in theirs.items():
        assert ours[k].shape == b.shape and np.array_equal(ours[k], b), k


def test_seeded_init_is_reproducible_and_torch_default():
    cfg = CONFIGS["unet3d_f4_l2_sigmoid"]
    a = get_model(cfg, generator=torch.Generator().manual_seed(3))
    b = get_model(cfg, generator=torch.Generator().manual_seed(3))
    for (k, p), (_, q) in zip(a.state_dict().items(),
                              b.state_dict().items()):
        assert torch.equal(p, q), k
    gn = a.encoder0.basic_module.SingleConv1.GroupNorm_0
    assert torch.equal(gn.weight, torch.ones(1))
    w = a.encoder0.basic_module.SingleConv2.TorchConv_0.weight
    bound = 1 / np.sqrt(w[0].numel())  # kaiming-uniform(a=sqrt(5))
    assert float(w.detach().abs().max()) <= bound


def test_checkpoint_from_jax_loads_in_the_port_and_back(tmp_path, pair):
    """A JAX ``save_checkpoint`` (params, an optax state with scalars, ints
    and empty dicts, counters) loads in the port, whose model then gives
    the JAX logits; the port's checkpoint loads in the JAX package."""
    cfg, jm, variables, params, x = pair
    opt_state = optax.adam(1e-3).init(variables["params"])
    state = {"model_state_dict": {"params": variables["params"],
                                  "batch_stats": {}},
             "optimizer_state_dict": opt_state, "best_eval_score": 0.25,
             "num_iterations": 17, "num_epoch": 2}
    path = jax_ckpt.save_checkpoint(state, True, str(tmp_path / "jax"))
    assert os.path.exists(tmp_path / "jax" / jax_ckpt.BEST_NAME)

    loaded = load_checkpoint(path)
    assert loaded["num_iterations"] == 17
    assert loaded["best_eval_score"] == 0.25
    assert loaded["model_state_dict"]["batch_stats"] == {}
    model = get_model(cfg)
    model.load_state_dict(
        flax_to_state_dict(loaded["model_state_dict"]["params"]))
    with torch.no_grad():
        y = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(
        y, np.asarray(jm.apply(variables, jnp.asarray(x), False)),
        rtol=TOL, atol=TOL)

    port_state = {"model_state_dict": state_dict_to_flax(model.state_dict()),
                  "optimizer_state_dict": loaded["optimizer_state_dict"],
                  "best_eval_score": 0.5, "num_iterations": 18,
                  "history": [1, 2.5]}
    port_path = save_checkpoint(port_state, False, str(tmp_path / "port"))
    back = jax_ckpt.load_checkpoint(port_path)
    assert back["num_iterations"] == 18
    assert back["history"] == {"0": 1, "1": 2.5}  # flax's list layout
    ours = dict(_leaves(back["model_state_dict"]["params"]))
    for k, b in _leaves(params["params"]):
        assert np.array_equal(ours[k], b), k
    opt_ours = dict(_leaves(back["optimizer_state_dict"]))
    opt_jax = dict(_leaves(jax_ckpt.load_checkpoint(path)[
        "optimizer_state_dict"]))
    assert sorted(opt_ours) == sorted(opt_jax)
    for k, b in opt_jax.items():
        assert np.array_equal(opt_ours[k], b), k


def test_final_activation_and_registry():
    sig = get_model(CONFIGS["unet3d_f4_l2_sigmoid"])
    soft = get_model({**CONFIGS["unet3d_f4_l2_sigmoid"],
                      "final_sigmoid": False})
    t = torch.randn(1, 2, 2, 2, 3)
    assert torch.equal(sig.final_activation()(t), torch.sigmoid(t))
    assert torch.allclose(soft.final_activation()(t).sum(-1),
                          torch.ones(1, 2, 2, 2))
    assert get_model({**CONFIGS["unet3d_f4_l2_sigmoid"],
                      "is_segmentation": False}).final_activation() is None
    assert unet3d.ResidualUNet3D().num_levels == 5
    # every name of the JAX package's MODELS_3D builds, with its defaults
    for name, levels, is3d in (("ResidualUNetSE3D", 5, True),
                               ("UNet2D", 4, False),
                               ("ResidualUNet2D", 5, False)):
        assert name in unet3d.MODELS_3D
        m = get_model({"name": name, "f_maps": 8})
        assert (m.num_levels, m.is3d) == (levels, is3d), name
    with pytest.raises(KeyError, match="unknown model"):
        get_model({"name": "VNet"})
    # float32 (also spelled out) and bfloat16 compute; others raise
    for dtype in (None, "float32"):
        assert get_model({**CONFIGS["unet3d_f4_l2_sigmoid"],
                          "dtype": dtype}).dtype is None
    assert get_model({**CONFIGS["unet3d_f4_l2_sigmoid"],
                      "dtype": "bfloat16"}).dtype == torch.bfloat16
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        get_model({**CONFIGS["unet3d_f4_l2_sigmoid"], "dtype": "float16"})


def test_blocks_refuse_what_is_not_ported():
    """Every order, block and upsampler of the JAX package builds now (the
    BatchNorm orders, ResNetBlockSE, any padding, the interpolating
    upsamplers); what the JAX package refuses, the port refuses too."""
    assert isinstance(blocks3d.SingleConv(4, 8, order="cbr").BatchNorm_0,
                      torch.nn.Module)
    assert isinstance(blocks3d.Encoder(1, 4, basic_module="ResNetBlockSE")
                      .basic_module, blocks3d.ResNetBlockSE)
    assert blocks3d.SingleConv(4, 8, kernel_size=3, padding=0
                               ).TorchConv_0.padding == (0, 0, 0)
    assert blocks3d.Decoder(16, 8, 8, upsample="trilinear").mode == "linear"
    with pytest.raises(ValueError, match="Non-linearity"):
        blocks3d.SingleConv(4, 8, order="rcg")
    with pytest.raises(ValueError, match="Unsupported basic_module"):
        blocks3d.Encoder(1, 4, basic_module="DenseBlock")
    with pytest.raises(ValueError, match="Unsupported layer type"):
        blocks3d.SingleConv(4, 8, order="cxr")


@pytest.mark.parametrize("order", ["gcr", "cgr", "gce", "cr", "gcl", "gcrd"])
def test_single_conv_orders_match_jax(order):
    """Every order: 'gcr' rides the fused path, the others the GroupNorm
    module and TorchConv; dropout ('d') is the identity at inference."""
    from mdeical_image_segmentation_tpu.models.blocks3d import (
        SingleConv as JaxSingleConv,
    )

    rng = np.random.default_rng(len(order))
    x = (rng.standard_normal((2, 4, 6, 5, 8)) + 1).astype(np.float32)
    jm = JaxSingleConv(16, order=order)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    m = blocks3d.SingleConv(8, 16, order=order)
    assert m.fused == (order == "gcr")
    sd = flax_to_state_dict({"m": jax.tree_util.tree_map(
        np.asarray, variables["params"])})
    m.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()})
    with torch.no_grad():
        y = m(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(
        y, np.asarray(jm.apply(variables, jnp.asarray(x))), rtol=TOL,
        atol=TOL)

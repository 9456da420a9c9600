"""The port's UNet-3+ family, its layers and its image ops against the JAX
package's, with the parameters carried over by ``utils/param_bridge``.

- Ops: ``max_pool_nd(ceil_mode=True)`` and the nearest resize equal the JAX
  ops; the bilinear resize agrees within 1e-6 of max |x| (RESIZE_TOL, a
  few float32 ulps: XLA's dot sums the taps in another order, and torch
  takes the source coordinate from a float32 ratio where the JAX package
  takes a float64 one).
- Layers: ``TorchConv`` under a stride (flax 'SAME' padding), ``UNetConv2``,
  ``ConvBNReLU`` and ``UNetUp`` in training mode, and ``TorchBatchNorm``
  against flax's ``nn.BatchNorm``: outputs, batch and running statistics
  within 1e-5 of max |value| (LAYER_TOL).
- Models, float32, 32² and 48² (48 pools to 3 at the bottleneck), batch 2:
  the eval-mode forward, the training-mode forward and the running
  statistics after it within 1e-4 of max |value| (TOL).  CGM: eval mode as
  the others; in training mode its batch statistics (before the dropout)
  as the others and its dropout by distribution.  bf16 (UNet_3Plus at
  32²): BF16_TOL below.  Gradients: ``test_torch_port_unet3plus_grads.py``.
"""

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from mdeical_image_segmentation_tpu.models import UNetConfig as JaxUNetConfig
from mdeical_image_segmentation_tpu.models import UNetModel as JaxUNetModel
from mdeical_image_segmentation_tpu.models import layers2d as jax_layers
from mdeical_image_segmentation_tpu.ops import image as jax_image
from mdeical_image_segmentation_tpu_torch.models import (
    ConvBNReLU,
    TorchBatchNorm,
    TorchConv,
    UNetConfig,
    UNetConv2,
    UNetModel,
    UNetUp,
)
from mdeical_image_segmentation_tpu_torch.models import unet2d
from mdeical_image_segmentation_tpu_torch.ops import image
from mdeical_image_segmentation_tpu_torch.utils.param_bridge import (
    flax_to_state_dict,
    state_dict_to_flax,
)

TOL = 1e-4
LAYER_TOL = 1e-5
RESIZE_TOL = 1e-6
# bf16 keeps 8 bits (one ulp is 2^-8 = 3.9e-3 relative).  Eval mode
# normalizes with fixed statistics: a few ulps through 29 conv layers.
# Training mode divides by a standard deviation estimated from 8 (hd5 at
# 2x2, batch 2) to 32 values per channel, which magnifies a one-ulp
# difference in a conv output; measured 6-8e-2 of max |value| at 32² and
# 48², 1.4-2.0e-2 for the statistics.
BF16_TOL = {"eval": 5e-2, "train": 0.15, "stats": 5e-2}
TYPES = ("UNet_3Plus", "UNet_3Plus_DeepSup", "UNet_3Plus_DeepSup_CGM")


def _scaled_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v, np.float32)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def _assert_trees_close(got, want, tol, what):
    got, want = _leaves(got), _leaves(want)
    assert got.keys() == want.keys(), what
    errs = {k: _scaled_err(got[k], want[k]) for k in want}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= tol, f"{what}: {worst} off by {errs[worst]:.2e}"


# -- ops ----------------------------------------------------------------------

@pytest.mark.parametrize("hw,window", [((8, 8), 2), ((9, 7), 2), ((5, 6), 4),
                                       ((17, 3), 8), ((3, 3), 4)])
def test_max_pool_ceil_mode_matches_jax(hw, window):
    x = np.random.default_rng(1).standard_normal((2, *hw, 3)).astype(
        np.float32)
    want = np.asarray(jax_image.max_pool_nd(jnp.asarray(x), window,
                                            ceil_mode=True))
    got = image.max_pool_nd(torch.from_numpy(x), window, ceil_mode=True)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape,scale,align", [
    ((2, 3, 5, 4), 2, False), ((2, 2, 2, 3), 16, False),
    ((2, 6, 7, 3), 4, False), ((1, 1, 3, 2), 8, False),
    ((1, 3, 3, 2), 2, True), ((2, 4, 5, 2), 4, True),
])
def test_upsample_bilinear_matches_jax(shape, scale, align):
    x = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    want = np.asarray(jax_image.upsample_bilinear2d(
        jnp.asarray(x), scale, align_corners=align))
    got = image.upsample_bilinear2d(torch.from_numpy(x), scale,
                                    align_corners=align)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=RESIZE_TOL * np.abs(x).max())


@pytest.mark.parametrize("out_hw", [(9, 4), (3, 3), (12, 13)])
def test_resize_bilinear_any_size_matches_jax(out_hw):
    x = np.random.default_rng(3).standard_normal((2, 5, 7, 3)).astype(
        np.float32)
    want = np.asarray(jax_image.resize_bilinear(jnp.asarray(x), out_hw))
    got = image.resize_bilinear(torch.from_numpy(x), out_hw).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=RESIZE_TOL * np.abs(x).max())


def test_upsample_bilinear_bf16_computes_in_fp32_and_casts_once():
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (1, 3, 4, 2)).astype(np.float32)).bfloat16()
    got = image.upsample_bilinear2d(x, 4)
    assert got.dtype == torch.bfloat16
    want = np.asarray(jax_image.upsample_bilinear2d(
        jnp.asarray(x.float().numpy()).astype(jnp.bfloat16), 4)).astype(
            np.float32)
    # the same float32 values to within an ulp, rounded once to bf16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -8)


def test_upsample_splits_outputs_over_the_kernel_limit(monkeypatch):
    """An output over ``INTERPOLATE_MAX_OUTPUT`` elements goes through the
    interpolation in batch chunks, with the same values and gradient."""
    x = torch.randn(5, 3, 4, 6, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    want = image.upsample_bilinear2d(x, 4)
    (gw,) = torch.autograd.grad(want.square().sum(), x)
    monkeypatch.setattr(image, "INTERPOLATE_MAX_OUTPUT", 2 * 12 * 16 * 6)
    got = image.upsample_bilinear2d(x, 4)
    (gg,) = torch.autograd.grad(got.square().sum(), x)
    assert torch.equal(got, want) and torch.equal(gg, gw)


@pytest.mark.parametrize("scale", [2, 3])
def test_upsample_nearest_matches_jax(scale):
    x = np.random.default_rng(5).standard_normal((2, 3, 4, 2)).astype(
        np.float32)
    want = np.asarray(jax_image.upsample_nearest(jnp.asarray(x), scale))
    np.testing.assert_array_equal(
        image.upsample_nearest(torch.from_numpy(x), scale).numpy(), want)


# -- layers -------------------------------------------------------------------

@pytest.mark.parametrize("hw", [(8, 8), (7, 9)])
@pytest.mark.parametrize("stride", [1, 2])
def test_torch_conv_strides_match_jax(hw, stride):
    """'SAME' under stride 2 pads (0, 1) for an even size, (1, 1) for an
    odd one: the extra row goes after, as XLA pads."""
    x = np.random.default_rng(6).standard_normal((2, *hw, 3)).astype(
        np.float32)
    jm = jax_layers.TorchConv(5, (3, 3), strides=(stride, stride),
                              kernel_init="kaiming")
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    m = TorchConv(3, 5, (3, 3), strides=(stride, stride))
    sd = flax_to_state_dict({"params": {"m": v["params"]}})
    m.load_state_dict({k[len("m."):]: t for k, t in sd.items()}, strict=True)
    got = m(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape
    assert _scaled_err(got, want) <= LAYER_TOL


def _flax_bn(bn: TorchBatchNorm):
    """The variables of a bare flax ``nn.BatchNorm`` holding bn's values."""
    def t(v):
        return jnp.array(v.detach().numpy(), copy=True)
    return {"params": {"scale": t(bn.weight), "bias": t(bn.bias)},
            "batch_stats": {"mean": t(bn.running_mean),
                            "var": t(bn.running_var)}}


def _flax_bn_apply(x, train, variables):
    bn = fnn.BatchNorm(use_running_average=not train, momentum=0.9,
                       epsilon=1e-5)
    return bn.apply(variables, x,
                    mutable=["batch_stats"] if train else False)


def _seeded_bn(channels, seed):
    bn = TorchBatchNorm(channels, init_type="kaiming")
    bn.reset_parameters(torch.Generator().manual_seed(seed))
    with torch.no_grad():
        bn.bias.uniform_(-0.5, 0.5)
        bn.running_mean.uniform_(-1, 1)
        bn.running_var.uniform_(0.5, 2)
    return bn


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batch_norm_matches_flax(dtype):
    """Training mode: the output, flax's fast-variance batch statistics and
    the running update with the *biased* variance (torch's BatchNorm2d
    would take the unbiased one); eval mode with the running statistics.
    bf16 input: a bf16 output (within one bf16 ulp) from float32
    statistics and parameters."""
    rng = np.random.default_rng(7)
    x = (3.0 + 2.0 * rng.standard_normal((2, 5, 6, 4))).astype(np.float32)
    bn = _seeded_bn(4, 0)
    variables = _flax_bn(bn)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    xj = jnp.asarray(x).astype(dtype)
    want, mutated = _flax_bn_apply(xj, True, variables)
    bn.train()
    got = bn(xt)
    assert got.dtype == xt.dtype
    tol = LAYER_TOL if dtype == "float32" else 2 ** -8
    assert _scaled_err(got.detach().float(), np.asarray(want, np.float32)
                       ) <= tol
    stats = mutated["batch_stats"]
    assert bn.running_mean.dtype == torch.float32
    assert _scaled_err(bn.running_mean, stats["mean"]) <= LAYER_TOL
    assert _scaled_err(bn.running_var, stats["var"]) <= LAYER_TOL
    xf = xt.float().numpy()
    np.testing.assert_allclose(  # the biased batch variance went in
        bn.running_var.numpy(),
        0.9 * np.asarray(variables["batch_stats"]["var"])
        + 0.1 * xf.var(axis=(0, 1, 2)), rtol=1e-5)
    bn.eval()
    want_eval = _flax_bn_apply(xj, False, dict(variables, batch_stats=stats))
    got_eval = bn(xt)
    assert _scaled_err(got_eval.detach().float(),
                       np.asarray(want_eval, np.float32)) <= tol


def test_batch_norm_gradients_match_flax():
    rng = np.random.default_rng(8)
    x = (1.0 + rng.standard_normal((3, 4, 5, 6))).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    bn = _seeded_bn(6, 1)
    variables = _flax_bn(bn)

    def f(p, xx):
        return _flax_bn_apply(xx, True, dict(variables, params=p))[0]

    _, vjp = jax.vjp(f, variables["params"], jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    bn.train()
    (bn(xt) * torch.from_numpy(g)).sum().backward()
    assert _scaled_err(xt.grad, gx) <= LAYER_TOL
    assert _scaled_err(bn.weight.grad, gp["scale"]) <= LAYER_TOL
    assert _scaled_err(bn.bias.grad, gp["bias"]) <= LAYER_TOL


def _train_layer(jmod, pmod, x, *args):
    variables = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x), *args)
    want, mutated = jmod.apply(variables, jnp.asarray(x), *args,
                               mutable=["batch_stats"])
    pmod.load_state_dict(flax_to_state_dict(variables), strict=True)
    pmod.train()
    got = pmod(torch.from_numpy(x)).detach()
    assert _scaled_err(got, want) <= LAYER_TOL
    _assert_trees_close(state_dict_to_flax(pmod.state_dict())["batch_stats"],
                        mutated["batch_stats"], LAYER_TOL, "running stats")


def test_conv_bn_relu_matches_jax():
    x = np.random.default_rng(9).standard_normal((2, 6, 6, 5)).astype(
        np.float32)
    _train_layer(jax_layers.ConvBNReLU(7), ConvBNReLU(5, 7), x, True)


def test_unet_conv2_matches_jax():
    x = np.random.default_rng(10).standard_normal((2, 6, 6, 3)).astype(
        np.float32)
    _train_layer(jax_layers.UNetConv2(4), UNetConv2(3, 4), x, True)


@pytest.mark.parametrize("is_deconv", [True, False])
def test_unet_up_matches_jax(is_deconv):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 4, 4, 6)).astype(np.float32)
    skip = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    jm = jax_layers.UNetUp(5, is_deconv=is_deconv)
    v = jm.init(jax.random.PRNGKey(2), jnp.asarray(x), jnp.asarray(skip))
    want = np.asarray(jm.apply(v, jnp.asarray(x), jnp.asarray(skip)))
    pm = UNetUp(6, 5, 3, is_deconv=is_deconv)
    pm.load_state_dict(flax_to_state_dict(v), strict=True)
    got = pm(torch.from_numpy(x), torch.from_numpy(skip)).detach()
    assert _scaled_err(got, want) <= LAYER_TOL


def test_bn_axis_name_points_at_its_item():
    """``bn_axis_name`` (item 25a) builds the same model: on one process
    its training-mode forward and running statistics equal those of the
    model without it, as the JAX package's GSPMD statistics are global
    either way (the data-parallel case: test_torch_port_dp_train.py)."""
    x = torch.from_numpy(np.random.default_rng(0).random(
        (2, 32, 32, 3), np.float32))
    outs = []
    for axis in (None, "data"):
        m = UNetModel(UNetConfig(unet_type="UNet_3Plus", in_channels=3,
                                 bn_axis_name=axis), device="cpu",
                      generator=torch.Generator().manual_seed(0))
        m.train()
        outs.append((m(x).logits.detach(), m.module.state_dict()))
    assert torch.equal(outs[0][0], outs[1][0])
    for k, v in outs[0][1].items():
        assert torch.equal(v, outs[1][1][k]), k


# -- models -------------------------------------------------------------------

_JAX_FNS = {}


def _jax_forward(unet_type, compute_dtype):
    """(eval outputs, training outputs, the batch statistics after the
    training forward) of the JAX model, one jitted function per type."""
    key = (unet_type, compute_dtype)
    if key not in _JAX_FNS:
        jm = JaxUNetModel(JaxUNetConfig(in_channels=3, out_channels=1,
                                        unet_type=unet_type,
                                        compute_dtype=compute_dtype)).module

        def fwd(variables, x):
            ev = jm.apply(variables, x, False)
            tr, mut = jm.apply(variables, x, True, mutable=["batch_stats"],
                               rngs={"dropout": jax.random.PRNGKey(0)})
            return ev, tr, mut["batch_stats"]

        _JAX_FNS[key] = jax.jit(fwd)
    return _JAX_FNS[key]


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def _check_model(unet_type, hw, compute_dtype, tols):
    kw = dict(in_channels=3, out_channels=1, unet_type=unet_type,
              compute_dtype=compute_dtype)
    model = UNetModel(UNetConfig(**kw), device="cpu",
                      generator=torch.Generator().manual_seed(hw))
    # running statistics other than flax's init, so the update shows
    with torch.no_grad():
        for name, b in model.module.named_buffers():
            b.uniform_(0.5, 1.5) if name.endswith("var") else b.uniform_(
                -0.2, 0.2)
    variables = jax.tree_util.tree_map(
        jnp.asarray, state_dict_to_flax(model.module.state_dict()))
    x = np.random.default_rng(hw).random((2, hw, hw, 3), dtype=np.float32)
    ev, tr, stats = _jax_forward(unet_type, compute_dtype)(
        variables, jnp.asarray(x))
    xt = torch.from_numpy(x).to(model.compute_dtype)
    model.eval()
    with torch.no_grad():
        got = _as_tuple(model.module(xt))
    for g, w in zip(got, _as_tuple(ev)):
        assert g.dtype == model.compute_dtype and g.shape == w.shape
        assert _scaled_err(g.float(), np.asarray(w, np.float32)) <= tols[
            "eval"], "eval"
    model.train()
    with torch.no_grad():
        got = _as_tuple(model.module(xt, torch.Generator().manual_seed(0)))
    if not unet_type.endswith("CGM"):  # CGM's dropout draws differ
        for g, w in zip(got, _as_tuple(tr)):
            assert _scaled_err(g.float(), np.asarray(w, np.float32)) <= tols[
                "train"], "train"
    _assert_trees_close(state_dict_to_flax(model.module.state_dict())[
        "batch_stats"], stats, tols["stats"], "running statistics")


@pytest.mark.parametrize("hw", [32, 48])
@pytest.mark.parametrize("unet_type", TYPES)
def test_model_matches_jax_fp32(unet_type, hw):
    _check_model(unet_type, hw, "float32",
                 {"eval": TOL, "train": TOL, "stats": TOL})


def test_model_matches_jax_bf16():
    _check_model("UNet_3Plus", 32, "bfloat16", BF16_TOL)


def test_cgm_dropout_by_distribution():
    """Training mode: hd5 (under batch statistics) with half of it zeroed
    and the rest doubled, drawn from the generator (the same seed, the same
    draw; another seed, another); no generator raises; eval mode drops
    nothing.  The outputs are probabilities."""
    model = unet2d.UNet3PlusDeepSupCGM(3, 1)
    model.reset_parameters(torch.Generator().manual_seed(0))
    seen = {}
    model._UNet3PlusBackbone_0.register_forward_hook(
        lambda mod, args, out: seen.__setitem__("hd5", out[5].clone()))
    model.TorchConv_0.register_forward_pre_hook(
        lambda mod, args: seen.__setitem__("cls_in", args[0].clone()))
    x = torch.rand(4, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        model.eval()
        model(x)
        assert torch.equal(seen["cls_in"], seen["hd5"])
        model.train()
        with pytest.raises(ValueError, match="generator"):
            model(x)
        drops, outs = [], []
        for seed in (5, 5, 6):
            outs.append(model(x, torch.Generator().manual_seed(seed)))
            drops.append(seen["cls_in"])
    hd5 = seen["hd5"]
    live = hd5 != 0
    kept = drops[0] != 0
    assert torch.equal(drops[0][kept], 2 * hd5[kept])
    share = (live & ~kept).sum().item() / live.sum().item()
    assert live.sum() > 4000
    assert abs(share - 0.5) < 0.03  # > 4k live values: > 3.8 standard errors
    assert torch.equal(drops[0], drops[1])
    assert not torch.equal(drops[0], drops[2])
    for a, b in zip(outs[0], outs[1]):
        assert torch.equal(a, b)
    for o in outs[0]:
        assert torch.all((o >= 0) & (o <= 1))


def test_reference_width_param_count():
    """UNet_3Plus: 26,971,777 parameters, 160 leaves and 116 batch_stats
    leaves, the flax tree of the JAX model (jax.eval_shape)."""
    jm = JaxUNetModel(JaxUNetConfig(in_channels=3, out_channels=1,
                                    unet_type="UNet_3Plus"))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 3)))
    model = UNetModel(UNetConfig(in_channels=3, unet_type="UNet_3Plus"),
                      device="meta")
    flax_tree = state_dict_to_flax(
        {k: np.zeros(v.shape, np.float32)
         for k, v in model.module.state_dict().items()})
    for col in ("params", "batch_stats"):
        want = {jax.tree_util.keystr(k): v.shape for k, v in
                jax.tree_util.tree_leaves_with_path(shapes[col])}
        got = {jax.tree_util.keystr(k): v.shape for k, v in
               jax.tree_util.tree_leaves_with_path(flax_tree[col])}
        assert got == want, col
    assert sum(p.numel() for p in model.parameters()) == 26_971_777

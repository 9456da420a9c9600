"""The port's classic UNet against the JAX package's, with the parameters
carried over by ``utils/param_bridge``.  Images come from numpy with a fixed
seed; float32 logits agree within rtol = atol = 1e-4 (nine conv pairs, four
transposed convs and the head, summed in different orders on each side)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mdeical_image_segmentation_tpu.models import UNetConfig as JaxUNetConfig
from mdeical_image_segmentation_tpu.models import UNetModel as JaxUNetModel
from mdeical_image_segmentation_tpu.ops import image as jax_image
from mdeical_image_segmentation_tpu_torch.models import UNetConfig, UNetModel
from mdeical_image_segmentation_tpu_torch.ops import fused_conv, image
from mdeical_image_segmentation_tpu_torch.utils.param_bridge import (
    flax_to_state_dict,
)

TOL = 1e-4


def _port_from_jax(cfg_kwargs, variables):
    model = UNetModel(UNetConfig(**cfg_kwargs), device="meta")
    model.module.load_state_dict(flax_to_state_dict(variables), strict=True,
                                 assign=True)
    model.module.to(model.compute_dtype)
    return model


@pytest.mark.parametrize("size", [32, 40])
@pytest.mark.parametrize("out_channels", [1, 2])
@pytest.mark.parametrize("in_channels", [1, 3])
def test_logits_match_jax(in_channels, out_channels, size):
    """40² makes the deepest skip 5 pixels wide, which center_crop crops to
    the 4-pixel upsampled map."""
    kw = dict(in_channels=in_channels, out_channels=out_channels,
              unet_type="UNet", base_features=4)
    jm = JaxUNetModel(JaxUNetConfig(**kw))
    variables = jm.init(jax.random.PRNGKey(size + in_channels),
                        jnp.zeros((1, size, size, in_channels)))
    x = np.random.default_rng(size).random(
        (2, size, size, in_channels), dtype=np.float32)
    want = np.asarray(jm.apply(variables, jnp.asarray(x)).logits)

    model = _port_from_jax(kw, variables)
    before = fused_conv.fused_double2d.launches
    with torch.inference_mode():
        out = model(torch.from_numpy(x))
    assert out.logits.dtype == torch.float32
    assert out.logits.shape == want.shape
    np.testing.assert_allclose(out.logits.numpy(), want, rtol=TOL, atol=TOL)
    assert fused_conv.fused_double2d.launches == before  # CPU: plain version


def test_reference_width_param_tree():
    """base_features 64: 46 leaves, 31,030,593 parameters (the JAX tree's
    count under jax.eval_shape)."""
    model = UNetModel(UNetConfig(base_features=64), device="meta")
    sd = model.module.state_dict()
    assert len(sd) == 46
    assert sum(t.numel() for t in sd.values()) == 31_030_593
    assert list(sd)[:2] == ["DoubleConvolution_0.TorchConv_0.weight",
                            "DoubleConvolution_0.TorchConv_0.bias"]
    assert list(sd)[-1] == "TorchConv_0.bias"


def test_seeded_init_is_reproducible_and_torch_default():
    cfg = UNetConfig(in_channels=1, base_features=4)
    a = UNetModel(cfg, device="cpu",
                  generator=torch.Generator().manual_seed(7))
    b = UNetModel(cfg, device="cpu",
                  generator=torch.Generator().manual_seed(7))
    for (ka, ta), (kb, tb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(ta, tb)
    w = a.module.DoubleConvolution_1.TorchConv_0.weight.detach()  # fan_in 36
    assert float(w.abs().max()) <= 1 / 36 ** 0.5
    assert float(w.std()) > 0.5 / (3 * 36) ** 0.5


def test_bf16_policy_casts_weights_once_and_returns_fp32():
    """Training keeps float32 master weights (each conv casts them to bf16
    at use, and their gradients come back float32); the serving copy of
    ``for_inference`` casts them once and gives the same logits."""
    model = UNetModel(UNetConfig(base_features=4, compute_dtype="bfloat16"),
                      device="cpu")
    assert all(p.dtype == torch.float32 for p in model.parameters())
    x = torch.rand(1, 32, 32, 1, generator=torch.Generator().manual_seed(0))
    out = model(x, (x > 0.5).float())
    assert out.logits.dtype == torch.float32 and out.loss.dtype == torch.float32
    out.loss.backward()
    assert all(p.grad is not None and p.grad.dtype == torch.float32
               and torch.isfinite(p.grad).all() for p in model.parameters())
    with torch.inference_mode():
        train_logits = model(x).logits
    served = model.for_inference()
    assert served is model and not model.training
    assert all(p.dtype == torch.bfloat16 and not p.requires_grad
               for p in model.parameters())
    with torch.inference_mode():
        logits = model(x).logits
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()
    assert torch.equal(logits, train_logits)


def test_unported_options_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        UNetModel(UNetConfig(unet_type="UNet_3Plus"), device="cpu")
    for policy in (None, "save_convs"):
        with pytest.raises(NotImplementedError, match="item 15"):
            UNetModel(UNetConfig(base_features=2, remat=True,
                                 remat_policy=policy), device="cpu")
    # a policy without remat is inert, as in the JAX package (whose CLI
    # writes one into every bundle)
    UNetModel(UNetConfig(base_features=2, remat_policy="save_convs"),
              device="cpu")
    model = UNetModel(UNetConfig(base_features=2), device="cpu")
    out = model(torch.zeros(1, 16, 16, 1), torch.zeros(1, 16, 16, 1))
    assert out.loss is not None and out["loss"] is out.loss


@pytest.mark.parametrize("in_hw,out_hw", [
    ((5, 5), (4, 4)), ((7, 6), (4, 4)), ((9, 8), (6, 3)),
    ((3, 4), (6, 7)), ((4, 4), (4, 4)),
])
def test_center_crop_matches_jax(in_hw, out_hw):
    x = np.random.default_rng(0).random((2, *in_hw, 3), dtype=np.float32)
    want = np.asarray(jax_image.center_crop(jnp.asarray(x), out_hw))
    got = image.center_crop(torch.from_numpy(x), out_hw).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hw", [(8, 8), (5, 7)])
def test_max_pool2d_matches_jax(hw):
    x = np.random.default_rng(1).random((2, *hw, 3), dtype=np.float32)
    want = np.asarray(jax_image.max_pool2d(jnp.asarray(x), 2))
    got = image.max_pool2d(torch.from_numpy(x), 2)
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)


def test_entry_points_default_to_the_card(tmp_path, monkeypatch):
    """``UNetModel`` and ``from_pretrained`` run on the card unless the
    caller asks for the CPU; without a card the default raises."""
    import inspect

    for fn in (UNetModel.__init__, UNetModel.from_pretrained):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = UNetConfig(base_features=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        UNetModel(cfg)
    UNetModel(cfg, device="cpu").save_pretrained(str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        UNetModel.from_pretrained(str(tmp_path))
    model = UNetModel.from_pretrained(str(tmp_path), device="cpu")
    assert next(model.parameters()).device.type == "cpu"
    assert UNetModel(cfg, device="meta").module is not None

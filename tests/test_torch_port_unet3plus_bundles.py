"""The UNet-3+ bundle: the wrapper's loss and logits, bundles with
``batch_stats`` both ways, the serving copy and ``register_unet2d``.

- Wrapper, 176² (the smallest size the hybrid loss takes), batch 1, eval
  mode, float32: a deep-supervision model's loss is the hybrid loss summed
  over its 5 heads and its logits are head 1 (CGM: probabilities, squashed
  a second time by the criterion), within 1e-4 relative of the JAX
  wrapper's (LOSS_TOL; the loss sums 5 MS-SSIM pyramids).
- A port bundle loads in the JAX package's ``UNetModel.from_pretrained``
  and a JAX bundle in the port's; both give the same eval-mode outputs
  within 1e-4 of max |value| (TOL), so the running statistics made it.
- ``for_inference()`` casts the conv weights to bf16 and keeps BatchNorm's
  scale, bias and running statistics float32.
- ``register_unet2d`` on the CPU serves a UNet_3Plus and a CGM bundle: the
  CGM output is served as it is (a probability), the others through a
  sigmoid; every mask is the thresholded forward, and the probabilities
  match the JAX server's within 1e-4.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mdeical_image_segmentation_tpu.models import UNetConfig as JaxUNetConfig
from mdeical_image_segmentation_tpu.models import UNetModel as JaxUNetModel
from mdeical_image_segmentation_tpu.serve.app import (
    ModelRegistry as JaxRegistry,
)
from mdeical_image_segmentation_tpu_torch.models import (
    TorchBatchNorm,
    UNetConfig,
    UNetModel,
)
from mdeical_image_segmentation_tpu_torch.serve import ModelRegistry
from mdeical_image_segmentation_tpu_torch.utils.param_bridge import (
    state_dict_to_flax,
)

TOL = 1e-4
LOSS_TOL = 1e-4
RES = 32


def _port(unet_type, seed=0, **kw):
    model = UNetModel(UNetConfig(in_channels=3, out_channels=1,
                                 unet_type=unet_type, **kw), device="cpu",
                      generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():  # running statistics other than the init's
        for name, b in model.module.named_buffers():
            b.uniform_(0.5, 1.5) if name.endswith("var") else b.uniform_(
                -0.2, 0.2)
    return model.eval()


def _err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("unet_type", ["UNet_3Plus_DeepSup",
                                       "UNet_3Plus_DeepSup_CGM"])
def test_wrapper_loss_sums_the_heads_like_jax(unet_type):
    model = _port(unet_type, seed=1)
    rng = np.random.default_rng(1)
    x = rng.random((1, 176, 176, 3), dtype=np.float32)
    y = (rng.random((1, 176, 176, 1)) < 0.4).astype(np.float32)
    jm = JaxUNetModel(JaxUNetConfig(in_channels=3, out_channels=1,
                                    unet_type=unet_type))
    variables = jax.tree_util.tree_map(
        jnp.asarray, state_dict_to_flax(model.module.state_dict()))
    want = jax.jit(lambda v, a, b: jm.apply(v, a, b))(
        variables, jnp.asarray(x), jnp.asarray(y))
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(y))
        heads = model.module(torch.from_numpy(x))
    assert len(heads) == 5
    assert out.logits.dtype == torch.float32
    assert torch.equal(out.logits, heads[0])
    summed = sum(model.criterion(h, torch.from_numpy(y)) for h in heads)
    assert float(out.loss) == pytest.approx(float(summed), rel=1e-6)
    np.testing.assert_allclose(float(out.loss), float(want.loss),
                               rtol=LOSS_TOL)
    assert _err(out.logits, want.logits) <= TOL


@pytest.mark.parametrize("unet_type", ["UNet_3Plus",
                                       "UNet_3Plus_DeepSup_CGM"])
def test_bundles_load_both_ways(unet_type, tmp_path):
    x = np.random.default_rng(2).random((2, RES, RES, 3), dtype=np.float32)
    model = _port(unet_type, seed=2)
    model.save_pretrained(str(tmp_path / "port"))
    with open(tmp_path / "port" / "config.json") as f:
        assert json.load(f)["unet_type"] == unet_type
    jm, variables = JaxUNetModel.from_pretrained(str(tmp_path / "port"))
    assert set(variables) == {"params", "batch_stats"}
    apply = jax.jit(lambda v, a: jm.apply(v, a).logits)
    want = apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).logits
    assert _err(got, want) <= TOL

    # the other way: a JAX-initialized bundle (its own weights, running
    # statistics moved by one training-mode forward) into the port
    jax_init = jax.jit(jm.init)(jax.random.PRNGKey(3), jnp.asarray(x))
    _, mutated = jax.jit(lambda v, a: jm.module.apply(
        v, a, True, mutable=["batch_stats"],
        rngs={"dropout": jax.random.PRNGKey(0)}))(jax_init, jnp.asarray(x))
    jax_vars = dict(jax_init, batch_stats=mutated["batch_stats"])
    jm.save_pretrained(str(tmp_path / "jax"), jax_vars)
    loaded = UNetModel.from_pretrained(str(tmp_path / "jax"), device="cpu")
    assert loaded.config.unet_type == unet_type
    assert not loaded.training
    with torch.no_grad():
        got = loaded(torch.from_numpy(x)).logits
    assert _err(got, apply(jax_vars, jnp.asarray(x))) <= TOL
    sd = loaded.module.state_dict()
    assert not any(k.endswith("num_batches_tracked") for k in sd)
    assert any(k.endswith("running_var") for k in sd)


def test_for_inference_keeps_batch_norm_in_fp32():
    model = _port("UNet_3Plus", compute_dtype="bfloat16")
    x = torch.rand(1, RES, RES, 3)
    with torch.no_grad():
        want = model(x).logits
    served = model.for_inference()
    for m in served.module.modules():
        own = list(m.parameters(recurse=False)) + list(m.buffers(
            recurse=False))
        want_dtype = (torch.float32 if isinstance(m, TorchBatchNorm)
                      else torch.bfloat16)
        assert all(t.dtype == want_dtype for t in own), type(m).__name__
    assert not any(p.requires_grad for p in served.parameters())
    with torch.no_grad():
        got = served(x).logits
    assert got.dtype == torch.float32
    assert torch.equal(got, want)  # the casts at use gave the same bits


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    root = tmp_path_factory.mktemp("u3p_serve")
    paths = {}
    for name, unet_type in (("u3p", "UNet_3Plus"),
                            ("cgm", "UNet_3Plus_DeepSup_CGM")):
        model = _port(unet_type, seed=4)
        if unet_type.endswith("CGM"):  # open the gate for one class
            with torch.no_grad():
                model.module.TorchConv_0.bias.copy_(torch.tensor([0.0, 5.0]))
        paths[name] = str(root / name)
        model.save_pretrained(paths[name])
    reg = ModelRegistry()
    for name, path in paths.items():
        reg.register_unet2d(name, path, resolution=RES, device="cpu",
                            max_batch=2)
    return reg, paths


@pytest.mark.parametrize("name", ["u3p", "cgm"])
def test_register_unet2d_serves_unet3plus(served, name):
    reg, paths = served
    entry = reg.get(name)
    x = np.random.default_rng(5).integers(0, 256, (2, RES, RES, 3),
                                          dtype=np.uint8)
    xf = x.astype(np.float32) / 255.0
    model = UNetModel.from_pretrained(paths[name], device="cpu")
    with torch.no_grad():
        out = model(torch.from_numpy(xf)).logits.numpy()
    want_probs = out if name == "cgm" else 1.0 / (1.0 + np.exp(-out))
    probs = entry.probs_forward(xf)
    np.testing.assert_allclose(probs, want_probs, rtol=0, atol=1e-6)
    masks = entry.forward(x)
    assert masks.dtype == np.uint8 and masks.shape == (2, RES, RES)
    np.testing.assert_array_equal(masks, (probs[..., 0] > 0.5))
    assert 0 < masks.mean() < 1  # a real decision, not a constant
    jreg = JaxRegistry()
    jreg.register_unet2d(name, paths[name], resolution=RES)
    np.testing.assert_allclose(probs, jreg.get(name).probs_forward(xf),
                               rtol=0, atol=TOL)
    assert os.path.isfile(os.path.join(paths[name], "params.msgpack"))

"""Remat of the port's 3D family (``remat`` / ``remat_policy`` of the model
section; ``ops/remat.checkpoint_block`` around each Encoder and Decoder).

Rematerialization recomputes the same operations on the same inputs, so on
the CPU every policy must give the loss and every gradient of remat off to
the bit, also with dropout (the recompute reuses the first run's masks) and
BatchNorm (the running statistics are updated once).  Against the JAX
package's ``remat=True`` model (``nn.remat`` of each Encoder and Decoder)
with the same flax weights: the loss within 1e-5 relative and the
gradients within 1e-5 relative in L2 over all leaves (float32; the two
packages sum in other orders)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mdeical_image_segmentation_tpu.losses import losses3d as jax_losses
from mdeical_image_segmentation_tpu.models import get_model as jax_get_model
from mdeical_image_segmentation_tpu_torch.losses import get_loss_criterion
from mdeical_image_segmentation_tpu_torch.models import blocks3d, get_model
from mdeical_image_segmentation_tpu_torch.ops import remat
from mdeical_image_segmentation_tpu_torch.utils.param_bridge import (
    flax_to_state_dict,
    state_dict_to_flax,
)

JAX_TOL = 1e-5
POLICIES = [None, "save_convs", "save_convs_norms", "everything"]
MODELS = {
    "unet3d": {"name": "UNet3D", "in_channels": 1, "out_channels": 1,
               "f_maps": 8, "num_levels": 3},
    "residual": {"name": "ResidualUNet3D", "in_channels": 2,
                 "out_channels": 1, "f_maps": 8, "num_levels": 3},
    # BatchNorm and both dropouts: the recompute must not update the
    # running statistics again and must reuse the masks
    "unet3d_bcrdD": {"name": "UNet3D", "in_channels": 1, "out_channels": 1,
                     "f_maps": 8, "num_levels": 2, "layer_order": "bcrdD",
                     "dropout_prob": 0.3},
    "unet2d": {"name": "UNet2D", "in_channels": 1, "out_channels": 1,
               "f_maps": 8, "num_levels": 3},
}


def _inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    spatial = (8, 16, 16) if cfg["name"] != "UNet2D" else (16, 16)
    x = (rng.standard_normal((2, *spatial, cfg["in_channels"])) + 0.5
         ).astype(np.float32)
    t = (rng.random((2, *spatial, cfg["out_channels"])) > 0.5).astype(
        np.float32)
    return x, t


def _step(cfg, state, x, t):
    """Loss, gradients and buffers after one forward and backward in
    training mode from the weights ``state``, dropout seeded."""
    model = get_model(cfg)
    model.load_state_dict(state)
    model.train()
    blocks3d.set_dropout_generator(model, torch.Generator().manual_seed(5))
    loss = get_loss_criterion({"loss": {"name": "BCEDiceLoss"}})(
        model(torch.from_numpy(x)), torch.from_numpy(t))
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    buffers = {n: b.clone() for n, b in model.named_buffers()}
    return loss.detach(), grads, buffers, model


@pytest.fixture(scope="module", params=sorted(MODELS))
def remat_off(request):
    cfg = MODELS[request.param]
    x, t = _inputs(cfg)
    model = get_model(cfg, generator=torch.Generator().manual_seed(1))
    state = {k: v.clone() for k, v in model.state_dict().items()}
    return cfg, state, x, t, _step(cfg, state, x, t)


@pytest.mark.parametrize("policy", POLICIES,
                         ids=[str(p) for p in POLICIES])
def test_remat_equals_remat_off_to_the_bit(remat_off, policy):
    cfg, state, x, t, (loss0, grads0, buffers0, _) = remat_off
    loss, grads, buffers, model = _step(
        {**cfg, "remat": True, "remat_policy": policy}, state, x, t)
    assert model.remat and model.remat_policy == policy
    assert torch.equal(loss, loss0)
    for n, g in grads0.items():
        assert torch.equal(grads[n], g), n
    for n, b in buffers0.items():  # running statistics updated once
        assert torch.equal(buffers[n], b), n


def test_none_policy_recomputes_each_block(monkeypatch):
    """Under the None policy every Encoder and Decoder runs twice a step:
    once forward, once in the backward; the other policies run them once."""
    cfg = MODELS["unet3d"]
    x, t = _inputs(cfg)
    calls = {}
    for policy in POLICIES:
        model = get_model({**cfg, "remat": True, "remat_policy": policy},
                          generator=torch.Generator().manual_seed(1))
        model.train()
        n = [0]
        for name in ("encoder0", "decoder1"):
            getattr(model, name).register_forward_pre_hook(
                lambda *_: n.__setitem__(0, n[0] + 1))
        get_loss_criterion({"loss": {"name": "BCEDiceLoss"}})(
            model(torch.from_numpy(x)), torch.from_numpy(t)).backward()
        calls[policy] = n[0]
    assert calls == {None: 4, "save_convs": 2, "save_convs_norms": 2,
                     "everything": 2}


@pytest.mark.parametrize("name", ["unet3d", "residual"])
def test_remat_matches_jax_remat(name):
    cfg = MODELS[name]
    x, t = _inputs(cfg, seed=3)
    jm = jax_get_model({**cfg, "remat": True})
    params = jm.init(jax.random.PRNGKey(4), jnp.asarray(x), False)["params"]
    loss = jax_losses.BCEDiceLoss()
    want_loss, want = jax.value_and_grad(
        lambda p: loss(jm.apply({"params": p}, jnp.asarray(x), True),
                       jnp.asarray(t)))(params)
    got_loss, grads, _, _ = _step({**cfg, "remat": True},
                                  flax_to_state_dict({"params": params}), x, t)
    np.testing.assert_allclose(float(got_loss), float(want_loss),
                               rtol=JAX_TOL)
    want = flax_to_state_dict({"params": want})
    num = sum(float(((grads[n] - w) ** 2).sum()) for n, w in want.items())
    den = sum(float((w ** 2).sum()) for w in want.values())
    assert (num / den) ** 0.5 < JAX_TOL


def test_get_model_keeps_remat_and_refuses_unknown_policies():
    m = get_model({**MODELS["unet3d"], "remat": True,
                   "remat_policy": "save_convs_norms"})
    assert (m.remat, m.remat_policy) == (True, "save_convs_norms")
    assert get_model({**MODELS["unet3d"], "remat": True,
                      "remat_policy": "none"}).remat_policy is None
    off = get_model(MODELS["unet3d"])
    assert (off.remat, off.remat_policy) == (False, None)
    with pytest.raises(ValueError, match="remat_policy"):
        get_model({**MODELS["unet3d"], "remat": True,
                   "remat_policy": "save_everything"})


def test_replay_keeps_masks_in_call_order():
    r = remat.Replay()
    draws = iter([torch.tensor([True]), torch.tensor([False])])
    first = [r.keep_mask(lambda: next(draws)) for _ in range(2)]
    r.recompute, r.pos = True, 0
    again = [r.keep_mask(lambda: torch.tensor([True])) for _ in range(2)]
    assert [bool(m) for m in first] == [bool(m) for m in again] == [True,
                                                                   False]


def test_remat_checkpoint_round_trips_through_the_bridge():
    """The remat flag adds no parameter: the flax tree is the same."""
    a = get_model(MODELS["unet3d_bcrdD"])
    b = get_model({**MODELS["unet3d_bcrdD"], "remat": True})
    fa, fb = state_dict_to_flax(a.state_dict()), state_dict_to_flax(
        b.state_dict())
    assert jax.tree_util.tree_structure(fa) == jax.tree_util.tree_structure(
        fb)

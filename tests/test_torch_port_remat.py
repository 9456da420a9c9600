"""Rematerialization (``ops/remat.py``): remat on equals remat off.

Each policy recomputes the same operations on the same inputs, so after a
training-mode forward and backward from the same weights the outputs, the
gradients and the running statistics equal those without remat: to the bit
on the CPU for every policy (``everything`` recomputes nothing at all).
The running statistics are updated once per forward, never again by a
recompute: after one step they equal ``0.9·init + 0.1·batch`` exactly as
without remat.  The classic UNet's DoubleConvolution is covered too.
Unknown policy names raise, as ``resolve_policy`` does in JAX.
"""

import numpy as np
import pytest
import torch

from mdeical_image_segmentation_tpu.ops import remat as jax_remat
from mdeical_image_segmentation_tpu_torch.models import UNetConfig, UNetModel
from mdeical_image_segmentation_tpu_torch.ops import remat

POLICIES = [None, "save_convs", "save_convs_norms", "everything"]


def _step(unet_type, remat_on, policy, hw=32, base_features=4):
    """(outputs, {name: grad}, {name: buffer}) of one training-mode forward
    and backward of a seeded model."""
    model = UNetModel(UNetConfig(in_channels=3, out_channels=1,
                                 unet_type=unet_type,
                                 base_features=base_features,
                                 remat=remat_on, remat_policy=policy),
                      device="cpu", generator=torch.Generator().manual_seed(7))
    model.train()
    rng = np.random.default_rng(hw)
    x = torch.from_numpy(rng.random((2, hw, hw, 3), dtype=np.float32))
    out = model.module(x, torch.Generator().manual_seed(3))
    outs = out if isinstance(out, tuple) else (out,)
    cot = [torch.from_numpy(rng.standard_normal(o.shape).astype(np.float32))
           for o in outs]
    sum((o * c).sum() for o, c in zip(outs, cot)).backward()
    grads = {n: p.grad.clone() for n, p in model.module.named_parameters()
             if p.grad is not None}
    bufs = {n: b.clone() for n, b in model.module.named_buffers()}
    return [o.detach() for o in outs], grads, bufs


def _assert_same(a, b):
    (oa, ga, ba), (ob, gb, bb) = a, b
    for x, y in zip(oa, ob):
        assert torch.equal(x, y)
    assert ga.keys() == gb.keys() and ba.keys() == bb.keys()
    for k in ga:
        assert torch.equal(ga[k], gb[k]), k
    for k in ba:
        assert torch.equal(ba[k], bb[k]), k


_OFF = {}


def _off(unet_type):
    if unet_type not in _OFF:
        _OFF[unet_type] = _step(unet_type, False, None)
    return _OFF[unet_type]


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("unet_type", ["UNet_3Plus", "UNet"])
def test_remat_equals_no_remat(unet_type, policy):
    _assert_same(_step(unet_type, True, policy), _off(unet_type))


def test_remat_equals_no_remat_deep_supervision():
    """The 5 heads, and CGM's dropout outside the remat blocks: the same
    draws."""
    unet_type = "UNet_3Plus_DeepSup_CGM"
    _assert_same(_step(unet_type, True, "save_convs"),
                 _step(unet_type, False, None))


@pytest.mark.parametrize("policy", [None, "save_convs_norms"])
def test_recompute_runs_and_stats_update_once(policy, monkeypatch):
    """The backward re-runs the checkpointed functions (the recompute
    happens), yet each BatchNorm's running statistics moved once:
    ``0.9·init + 0.1·batch``, the same bits as without remat."""
    from torch.utils import checkpoint as ckpt

    calls = []
    real = ckpt.checkpoint

    def counting(fn, *args, **kw):
        calls.append(fn)
        return real(fn, *args, **kw)

    monkeypatch.setattr(remat, "checkpoint", counting)
    got = _step("UNet_3Plus", True, policy)
    assert calls  # remat engaged
    _, _, off_bufs = _off("UNet_3Plus")
    for k, v in got[2].items():
        assert torch.equal(v, off_bufs[k]), k
    init = UNetModel(UNetConfig(in_channels=3, unet_type="UNet_3Plus"),
                     device="cpu", generator=torch.Generator().manual_seed(7))
    moved = [k for k, v in init.module.named_buffers()
             if not torch.equal(v, got[2][k])]
    assert len(moved) == len(got[2])  # every statistic moved, once


def test_eval_and_no_grad_skip_the_checkpoint(monkeypatch):
    monkeypatch.setattr(remat, "checkpoint", lambda *a, **k: pytest.fail(
        "checkpoint without autograd"))
    model = UNetModel(UNetConfig(in_channels=3, unet_type="UNet_3Plus",
                                 remat=True), device="cpu")
    with torch.no_grad():
        model.module(torch.zeros(1, 32, 32, 3))


def test_policies_resolve_like_jax():
    for name in ("none", None, "save_convs", "save_convs_norms",
                 "everything"):
        assert (remat.resolve_policy(name) is None) == (
            jax_remat.resolve_policy(name) is None)
    for bad in ("save_everything", "convs"):
        with pytest.raises(ValueError, match="remat_policy"):
            remat.resolve_policy(bad)
        with pytest.raises(ValueError, match="remat_policy"):
            jax_remat.resolve_policy(bad)
    with pytest.raises(ValueError, match="remat_policy"):
        UNetModel(UNetConfig(unet_type="UNet_3Plus", remat=True,
                             remat_policy="bogus"), device="cpu")

"""Kernels 1, 2, 3a and 3b as ``torch.library`` custom ops
(``tpuseg::fused_double2d``, ``tpuseg::fused_double2d_y``,
``tpuseg::fused_conv3d``, ``tpuseg::gn_channel_sums``,
``tpuseg::gn_affine``): ``torch.library.opcheck`` of each (schema, fake
tensor, autograd registration, AOT dispatch) at small shapes; the wrappers
route a CPU call through the op, whose CPU implementation is the plain
version; and the eager CPU forwards of the 2D UNet and the 3D UNets give the
bits of the plain composition, with the op and without it, against the JAX
package's forward within the tolerance its own port tests use."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mdeical_image_segmentation_tpu.models import UNetConfig as JaxUNetConfig
from mdeical_image_segmentation_tpu.models import UNetModel as JaxUNetModel
from mdeical_image_segmentation_tpu.models import get_model as jax_get_model
from mdeical_image_segmentation_tpu_torch.models import (
    UNetConfig,
    UNetModel,
    get_model,
    layers2d,
)
from mdeical_image_segmentation_tpu_torch.ops import fused_conv, norm
from mdeical_image_segmentation_tpu_torch.utils.param_bridge import (
    flax_to_state_dict,
)

JAX_TOL = 1e-5  # float32 forwards, port vs JAX, x max(1, max |y|)


def _rand(gen, *shape):
    return torch.randn(*shape, generator=gen)


def _cases():
    g = torch.Generator().manual_seed(0)
    x2 = _rand(g, 2, 6, 5, 3)
    w1, b1 = _rand(g, 3, 3, 3, 4) * 0.3, _rand(g, 4)
    w2, b2 = _rand(g, 3, 3, 4, 2) * 0.3, _rand(g, 2)
    x3 = _rand(g, 2, 3, 4, 5, 6)
    a, b = _rand(g, 2, 6), _rand(g, 2, 6)
    cases = [
        ("fused_double2d", fused_conv._double2d_op, (x2, w1, b1, w2, b2)),
        ("fused_double2d_y", fused_conv._double2d_y_op,
         (x2, w1, b1, w2, b2)),
        ("gn_channel_sums", norm._channel_sums_op, (x3,)),
        ("gn_affine", norm._affine_op, (x3, a, b)),
        ("gn_affine_bf16", norm._affine_op, (x3.bfloat16(), a, b)),
    ]
    for kd in (1, 3):
        k = _rand(g, kd, 3, 3, 6, 5) * 0.2
        for pre, post in ((False, True), (True, False)):
            cases.append((f"fused_conv3d_kd{kd}_{pre}_{post}",
                          fused_conv._conv3d_op, (x3, k, a, b, pre, post)))
    return cases


CASES = _cases()


@pytest.mark.parametrize("name,op,args", CASES, ids=[c[0] for c in CASES])
def test_opcheck(name, op, args):
    torch.library.opcheck(op, args)


def test_ops_are_registered_under_tpuseg():
    for name in ("fused_double2d", "fused_double2d_y", "fused_conv3d",
                 "gn_channel_sums", "gn_affine"):
        assert hasattr(torch.ops.tpuseg, name), name


@pytest.mark.parametrize("name,op,args", CASES[:4],
                         ids=[c[0] for c in CASES[:4]])
def test_fake_implementations_give_the_shapes_and_dtypes(name, op, args):
    from torch._subclasses.fake_tensor import FakeTensorMode

    real = op(*args)
    with FakeTensorMode() as mode:
        fake = op(*(mode.from_tensor(a) if isinstance(a, torch.Tensor)
                    else a for a in args))
    real = real if isinstance(real, tuple) else (real,)
    fake = fake if isinstance(fake, tuple) else (fake,)
    for r, f in zip(real, fake):
        assert (r.shape, r.dtype, r.stride()) == (f.shape, f.dtype,
                                                  f.stride())


class _Recorder(torch.utils._python_dispatch.TorchDispatchMode):
    """The ops the dispatcher sees, by name."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


def _tpuseg_calls(fn):
    with _Recorder() as rec:
        out = fn()
    return out, sorted(n for n in rec.names if n.startswith("tpuseg."))


def test_wrappers_go_through_the_ops_and_keep_their_bits():
    g = torch.Generator().manual_seed(1)
    x = _rand(g, 2, 6, 5, 3)
    w1, b1 = _rand(g, 3, 3, 3, 4), _rand(g, 4)
    w2, b2 = _rand(g, 3, 3, 4, 2), _rand(g, 2)
    (y, z), calls = _tpuseg_calls(
        lambda: fused_conv.fused_double2d(x, w1, b1, w2, b2))
    assert calls == ["tpuseg.fused_double2d.default"]
    ry, rz = fused_conv.fused_double2d_reference(x, w1, b1, w2, b2)
    assert torch.equal(y, ry) and torch.equal(z, rz)
    (y, z), calls = _tpuseg_calls(
        lambda: fused_conv.fused_double2d(x, w1, b1, w2, b2, with_z=False))
    assert calls == ["tpuseg.fused_double2d_y.default"] and z is None
    assert torch.equal(y, ry)
    x3 = _rand(g, 1, 2, 3, 4, 8)
    (s1, s2), calls = _tpuseg_calls(lambda: norm.gn_channel_sums(x3))
    assert calls == ["tpuseg.gn_channel_sums.default"]
    r1, r2 = norm.gn_channel_sums_reference(x3)
    assert torch.equal(s1, r1) and torch.equal(s2, r2)


def test_autograd_on_the_cpu_differentiates_the_plain_composition():
    """A CPU call that autograd records skips the op (which has no
    backward) and differentiates the plain version."""
    g = torch.Generator().manual_seed(2)
    x = _rand(g, 1, 2, 3, 4, 8).requires_grad_()
    a, b = torch.ones(1, 8), torch.zeros(1, 8)
    y, calls = _tpuseg_calls(lambda: norm.gn_affine(x, a, b))
    assert calls == []
    y.sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x))


def test_no_grad_blocks_run_the_forward_alone_with_the_same_bits():
    """``gcr_fused_conv`` and ``group_norm`` outside autograd (an inference
    forward, an export) make the calls the autograd Functions make."""
    g = torch.Generator().manual_seed(3)
    x = _rand(g, 2, 3, 4, 5, 8)
    s, b = 1 + 0.1 * _rand(g, 8), 0.1 * _rand(g, 8)
    k = 0.2 * _rand(g, 3, 3, 3, 8, 4)
    with torch.no_grad():
        (y0, calls) = _tpuseg_calls(
            lambda: fused_conv.gcr_fused_conv(x, s, b, k, 4, 1e-5))
    assert calls == ["tpuseg.fused_conv3d.default",
                     "tpuseg.gn_channel_sums.default"]
    y1 = fused_conv.gcr_fused_conv(x, s.requires_grad_(), b, k, 4, 1e-5)
    assert y1.grad_fn is not None and torch.equal(y0, y1.detach())
    with torch.no_grad():
        n0, calls = _tpuseg_calls(lambda: norm.group_norm(x, s, b, 4, 1e-5))
    assert calls == ["tpuseg.gn_affine.default",
                     "tpuseg.gn_channel_sums.default"]
    assert torch.equal(n0, norm.group_norm(x, s, b, 4, 1e-5).detach())


class _plain_versions:
    """The wrappers swapped for their plain versions (no op at all)."""

    SWAPS = ((layers2d, "fused_double2d",
              fused_conv.fused_double2d_reference),
             (fused_conv, "fused_conv3d", fused_conv.fused_conv3d_reference),
             (norm, "gn_channel_sums", norm.gn_channel_sums_reference),
             (norm, "gn_affine", norm.gn_affine_reference))

    def __enter__(self):
        self.saved = [(m, n, getattr(m, n)) for m, n, _ in self.SWAPS]
        for m, n, f in self.SWAPS:
            setattr(m, n, f)

    def __exit__(self, *exc):
        for m, n, f in self.saved:
            setattr(m, n, f)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_unet2d_forward_keeps_its_bits():
    jm = JaxUNetModel(JaxUNetConfig(in_channels=1, out_channels=1,
                                    unet_type="UNet", base_features=4))
    x = np.random.default_rng(0).random((2, 32, 32, 1), np.float32)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x[:1]))
    want = np.asarray(jax.jit(jm.apply, static_argnames="train")(
        variables, jnp.asarray(x), None, train=False).logits)
    model = UNetModel(UNetConfig(base_features=4), device="cpu")
    model.module.load_state_dict(flax_to_state_dict(_np(variables)))
    with torch.no_grad():
        out, calls = _tpuseg_calls(lambda: model(torch.from_numpy(x)).logits)
        with _plain_versions():
            plain = model(torch.from_numpy(x)).logits
    assert calls == ["tpuseg.fused_double2d_y.default"] * 9
    assert torch.equal(out, plain)
    err = np.abs(out.numpy() - want).max()
    assert err <= JAX_TOL * max(1.0, np.abs(want).max()), err


@pytest.mark.parametrize("name,affine", [("UNet3D", 0),
                                         ("ResidualUNet3D", 3)])
def test_unet3d_forward_keeps_its_bits(name, affine):
    cfg = {"name": name, "in_channels": 1, "out_channels": 1, "f_maps": 8,
           "num_levels": 2, "num_groups": 4, "layer_order": "gcr"}
    x = np.random.default_rng(1).standard_normal((2, 8, 16, 16, 1),
                                                 np.float32)
    jm = jax_get_model(cfg)
    variables = jax.jit(jm.init, static_argnums=2)(
        jax.random.PRNGKey(0), jnp.asarray(x[:1]), False)
    want = np.asarray(jax.jit(jm.apply, static_argnums=2)(
        variables, jnp.asarray(x), False))
    model = get_model(cfg, device="cpu")
    model.load_state_dict(flax_to_state_dict(_np(variables)))
    model.eval()
    with torch.no_grad():
        out, calls = _tpuseg_calls(lambda: model(torch.from_numpy(x)))
        with _plain_versions():
            plain = model(torch.from_numpy(x))
    convs = 6 if name == "UNet3D" else 3  # fused 'gcr' SingleConvs
    assert calls.count("tpuseg.fused_conv3d.default") == convs
    assert calls.count("tpuseg.gn_affine.default") == affine
    assert torch.equal(out, plain)
    err = np.abs(out.numpy() - want).max()
    assert err <= JAX_TOL * max(1.0, np.abs(want).max()), err

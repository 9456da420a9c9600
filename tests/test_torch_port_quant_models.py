"""The port's int8 PTQ path on whole models, the sliding-window predictor
and 2D serving, held against the JAX package on the same seeded weights
(the parameter bridge) and, where the JAX package calibrated, its own scales
(``quant_to_torch``).

Tolerances:

* calibration: the same scale keys as JAX's ``quant`` collection; each
  absmax within 1e-5 relative (the float convs before each conv sum in
  other orders);
* a calib-mode forward against the off-mode forward: 1e-5 (the same float
  ops; the fused kernels' plain versions stand aside);
* the int8 forward against JAX's int8 forward on JAX's scales: max |Δ| <=
  2e-2 of max |y_jax| and sign agreement >= 0.99 (the 2D UNet).  The
  integers are the same except where the two frameworks' float activations
  straddle a half-step of the activation scale and round to neighbouring
  int8 values.  The random-init UNet3D amplifies such flips past that bar
  in JAX alone: its int8 output moves by ~6% of max |y| with 0.984 sign
  agreement when x is scaled by 1 + 1e-6·noise.  There the port is held to
  that noise floor of the reference instead: max |Δ| <= 1.5 x JAX's own
  move and sign agreement >= JAX's own - 0.01 under that perturbation;
* the int8 forward against the port's own float forward: relative 0.15,
  the JAX package's own bar (tests/test_quant.py);
* the port's predictor and server against the port's own calibrate-then-
  int8 forward: equal (the same ops in the same order)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mdeical_image_segmentation_tpu.infer import StandardPredictor as JaxPredictor
from mdeical_image_segmentation_tpu.models import UNetConfig as JaxUNetConfig
from mdeical_image_segmentation_tpu.models import UNetModel as JaxUNetModel
from mdeical_image_segmentation_tpu.models import get_model as jax_get_model
from mdeical_image_segmentation_tpu.ops import quant as jq
from mdeical_image_segmentation_tpu_torch.cli import serve as serve_cli
from mdeical_image_segmentation_tpu_torch.data import volume_utils
from mdeical_image_segmentation_tpu_torch.infer import StandardPredictor
from mdeical_image_segmentation_tpu_torch.models import (
    UNetConfig,
    UNetModel,
    get_model,
)
from mdeical_image_segmentation_tpu_torch.ops import quant
from mdeical_image_segmentation_tpu_torch.ops.tta import mirror_combos
from mdeical_image_segmentation_tpu_torch.serve import ModelRegistry
from mdeical_image_segmentation_tpu_torch.utils.param_bridge import (
    flax_to_state_dict,
    quant_to_torch,
)

ABSMAX_RTOL = 1e-5
CALIB_TOL = 1e-5
INT8_REL = 2e-2
SIGN_AGREE = 0.99
FLOAT_REL = 0.15
NOISE_FLOOR_X = 1.5  # of JAX's int8 move under a 1e-6 relative input noise


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _check_against_jax(q, q_jax, ref, floor=None):
    """``floor``: (max |Δ|, sign agreement) of JAX's int8 output against
    itself on a perturbed input, for a model that amplifies rounding
    flips past the fixed bar."""
    gap, agree = np.abs(q - q_jax).max(), ((q > 0) == (q_jax > 0)).mean()
    max_gap, min_agree = INT8_REL * np.abs(q_jax).max(), SIGN_AGREE
    if floor is not None:
        max_gap = max(max_gap, NOISE_FLOOR_X * floor[0])
        min_agree = min(min_agree, floor[1] - 0.01)
    assert gap <= max_gap, (gap, max_gap)
    assert agree >= min_agree, (agree, min_agree)
    assert np.abs(q - ref).max() / (np.abs(ref).max() + 1e-9) < FLOAT_REL


def _check_scales(scales, jax_scales):
    want = quant_to_torch(jax_scales)
    assert sorted(scales) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(float(scales[k]), float(v),
                                   rtol=ABSMAX_RTOL)


# -- classic 2D UNet, base 16, 64² (tests/test_quant.py's model) -------------

@pytest.fixture(scope="module")
def unet2d():
    jm = JaxUNetModel(JaxUNetConfig(in_channels=1, out_channels=1,
                                    unet_type="UNet", base_features=16))
    x = np.random.default_rng(4).random((2, 64, 64, 1)).astype(np.float32)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))

    def fwd(v, xx, **kw):
        return jm.apply(v, xx, None, train=False, **kw)

    ref = np.asarray(fwd(variables, jnp.asarray(x)).logits)
    jscales = jq.calibrate(fwd, variables, [(jnp.asarray(x),)])
    q = np.asarray(jq.wrap_apply(lambda v, xx: fwd(v, xx).logits, "int8")(
        {**variables, **jscales}, jnp.asarray(x)))
    model = UNetModel(UNetConfig(in_channels=1, out_channels=1,
                                 unet_type="UNet", base_features=16),
                      device="meta")
    model.module.load_state_dict(flax_to_state_dict(_np_tree(variables)),
                                 strict=True, assign=True)
    model.module.to(torch.float32)
    return dict(x=x, ref=ref, q=q, jscales=_np_tree(jscales), model=model)


def test_unet2d_calibration_matches_jax(unet2d):
    model, x = unet2d["model"], torch.from_numpy(unet2d["x"])
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.inference_mode():
        off = model(x).logits
    scales = quant.calibrate(lambda xx: model(xx), model, [x])
    _check_scales(scales, unet2d["jscales"])
    # the Ci = 1 stem conv stays float: no scale; every other conv has one
    assert "DoubleConvolution_0.TorchConv_0" not in scales
    assert "DoubleConvolution_0.TorchConv_1" in scales
    convs = [n for n, _ in model.module.named_modules()
             if n.split(".")[-1].startswith("TorchConv_")]
    assert len(scales) == len(convs) - 1
    with quant.quant_mode("calib", {}, model), torch.inference_mode():
        calib = model(x).logits
    np.testing.assert_allclose(calib.numpy(), off.numpy(), rtol=CALIB_TOL,
                               atol=CALIB_TOL)
    for k, v in model.state_dict().items():  # scales live outside it
        assert torch.equal(v, sd[k]), k
    assert model.state_dict().keys() == sd.keys()


def test_unet2d_int8_matches_jax_on_its_scales(unet2d):
    model, x = unet2d["model"], torch.from_numpy(unet2d["x"])
    scales = quant_to_torch(unet2d["jscales"])
    with quant.quant_mode("int8", scales, model), torch.inference_mode():
        q = model(x).logits.numpy()
    _check_against_jax(q, unet2d["q"], unet2d["ref"])
    assert ((unet2d["ref"] > 0) == (q > 0)).mean() > 0.98


# -- UNet3D f_maps 16, 3 levels, 'gcr', 16x32x32, fp32 and bf16 --------------

UNET3D = {"name": "UNet3D", "in_channels": 1, "out_channels": 1,
          "f_maps": 16, "num_levels": 3, "layer_order": "gcr"}


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def unet3d(request):
    cfg = dict(UNET3D, **({} if request.param == "float32"
                          else {"dtype": "bfloat16"}))
    jm = jax_get_model(cfg)
    x = np.random.default_rng(5).random((1, 16, 32, 32, 1)).astype(
        np.float32)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))

    def fwd(v, xx, **kw):
        return jm.apply(v, xx, False, **kw)

    ref = np.asarray(fwd(variables, jnp.asarray(x)).astype(jnp.float32))
    jscales = jq.calibrate(fwd, variables, [(jnp.asarray(x),)])
    int8_fwd = jq.wrap_apply(fwd, "int8")
    q = np.asarray(int8_fwd({**variables, **jscales}, jnp.asarray(x))
                   .astype(jnp.float32))
    noise = np.random.default_rng(9).standard_normal(x.shape)
    xp = (x * (1 + 1e-6 * noise)).astype(np.float32)
    qp = np.asarray(int8_fwd({**variables, **jscales}, jnp.asarray(xp))
                    .astype(jnp.float32))
    floor = (np.abs(qp - q).max(), ((qp > 0) == (q > 0)).mean())
    model = get_model(cfg)
    model.load_state_dict(flax_to_state_dict(_np_tree(variables)))
    return dict(x=x, ref=ref, q=q, jscales=_np_tree(jscales), model=model,
                dtype=request.param, floor=floor)


def test_unet3d_calibration_and_int8_match_jax(unet3d):
    model, x = unet3d["model"], torch.from_numpy(unet3d["x"])
    with torch.inference_mode():
        off = model(x).float()
    scales = quant.calibrate(model, model, [x])
    if unet3d["dtype"] == "float32":
        _check_scales(scales, unet3d["jscales"])
    else:  # bf16 activations: the same keys; values within a bf16 ulp
        want = quant_to_torch(unet3d["jscales"])
        assert sorted(scales) == sorted(want)
        for k, v in want.items():
            np.testing.assert_allclose(float(scales[k]), float(v),
                                       rtol=2 ** -7)
        calib_tol = 2e-2
    with quant.quant_mode("calib", {}, model), torch.inference_mode():
        calib = model(x).float()
    tol = CALIB_TOL if unet3d["dtype"] == "float32" else calib_tol
    np.testing.assert_allclose(calib.numpy(), off.numpy(), rtol=tol,
                               atol=tol)
    with quant.quant_mode("int8", quant_to_torch(unet3d["jscales"]), model
                          ), torch.inference_mode():
        q = model(x).float().numpy()
    _check_against_jax(q, unet3d["q"], unet3d["ref"], unet3d["floor"])


# -- the sliding-window predictor --------------------------------------------

P_MODEL = {"name": "UNet3D", "in_channels": 1, "out_channels": 1,
           "f_maps": 16, "num_levels": 2, "layer_order": "gcr"}
PATCH, HALO = (4, 64, 64), (2, 4, 4)
VOLUME = (8, 128, 128)  # 2 x 2 x 2 windows: 8 patches, batches of 3, 3, 2
BATCH = 3
SLICES = {"name": "SliceBuilder", "patch_shape": list(PATCH),
          "stride_shape": list(PATCH), "halo_shape": list(HALO)}


@pytest.fixture(scope="module")
def predictor_setup():
    jm = jax_get_model(P_MODEL)
    variables = jm.init(jax.random.PRNGKey(2),
                        jnp.zeros((1, 8, 40, 40, 1)), False)
    model = get_model(P_MODEL)
    model.load_state_dict(flax_to_state_dict(_np_tree(variables)))
    raw = np.random.default_rng(6).standard_normal(VOLUME).astype(np.float32)
    batches = list(volume_utils.padded_patch_batches(raw, SLICES, BATCH))
    return jm, variables, model, batches


def _modes_of_calls(model):
    modes = []
    handle = model.register_forward_pre_hook(
        lambda *_: modes.append(quant.mode()))
    return modes, handle


def test_predictor_calibrates_then_runs_int8(predictor_setup):
    jm, variables, model, batches = predictor_setup
    assert len(batches) == 3 and batches[-1][0].shape[0] == 2  # padded tail
    pred = StandardPredictor(model, None, out_channels=1, quantize="int8",
                             calib_batches=2)
    modes, handle = _modes_of_calls(model)
    try:
        acc, cnt = pred._device_accumulate(iter(batches), VOLUME, HALO)
    finally:
        handle.remove()
    assert modes == ["calib", "calib", "int8"]
    assert pred._calib_seen == 2 and pred.quant_scales

    # by hand: the tail padded to the batch by its last row, the two calib
    # batches' float outputs, then the int8 forward on their scales
    def padded(b):
        x = torch.from_numpy(b)
        if x.shape[0] < BATCH:
            x = torch.cat([x, x[-1:].expand(BATCH - x.shape[0],
                                            *x.shape[1:])])
        return x

    xs = [padded(b) for b, _ in batches]
    scales = quant.calibrate(model, model, xs[:2])
    for k, v in scales.items():
        assert torch.equal(v, pred.quant_scales[k]), k
    with torch.inference_mode():
        outs = [model(x) for x in xs[:2]]
        with quant.quant_mode("int8", scales, model):
            outs.append(model(xs[2]))
    want_acc = np.zeros((1, *VOLUME), np.float32)
    want_cnt = np.zeros((1, *VOLUME), np.float32)
    for out, (b, idx) in zip(outs, batches):
        out = out.numpy()[:len(idx), HALO[0]:-HALO[0], HALO[1]:-HALO[1],
                          HALO[2]:-HALO[2], :]
        for o, sl in zip(out, idx):
            want_acc[(slice(None), *sl)] += np.moveaxis(o, -1, 0)
            want_cnt[(slice(None), *sl)] += 1
    np.testing.assert_array_equal(cnt, want_cnt)
    np.testing.assert_allclose(acc, want_acc, rtol=1e-6, atol=1e-6)

    # the JAX predictor on the same bridged weights, its own calibration
    def jax_map(bs):
        jp = JaxPredictor(jm, variables, None, out_channels=1,
                          quantize="int8", calib_batches=2)
        return jp, jp._device_accumulate(iter(bs), VOLUME, HALO)

    jax_pred, (ja, jc) = jax_map(batches)
    np.testing.assert_array_equal(cnt, jc)
    _check_scales(pred.quant_scales,
                  _np_tree({"quant": jax_pred._quant_scales}))
    # the reference's own move under a 1e-6 relative input noise
    rng = np.random.default_rng(10)
    _, (jp_acc, _) = jax_map([
        ((b * (1 + 1e-6 * rng.standard_normal(b.shape))).astype(np.float32),
         idx) for b, idx in batches])
    floor = (np.abs(jp_acc - ja).max(), ((jp_acc > 0) == (ja > 0)).mean())
    with torch.inference_mode():
        ref = np.zeros_like(want_acc)
        for b, idx in batches:
            out = model(torch.from_numpy(b)).numpy()[
                :, HALO[0]:-HALO[0], HALO[1]:-HALO[1], HALO[2]:-HALO[2], :]
            for o, sl in zip(out, idx):
                ref[(slice(None), *sl)] += np.moveaxis(o, -1, 0)
    _check_against_jax(acc / cnt, ja / jc, ref / want_cnt,
                       (floor[0] / jc.min(), floor[1]))


def test_predictor_calibration_sees_every_flip(predictor_setup):
    _, _, model, batches = predictor_setup
    pred = StandardPredictor(model, None, out_channels=1, quantize="int8",
                             calib_batches=1, tta="mirror")
    x = torch.from_numpy(batches[0][0])
    pred._predict_batch_device(batches[0][0])
    combos = mirror_combos((1, 2, 3))
    assert len(combos) == 8
    per_flip = [quant.calibrate(model, model,
                                [torch.flip(x, c) if c else x])
                for c in combos]
    for k, v in pred.quant_scales.items():
        assert float(v) == max(float(s[k]) for s in per_flip), k
    assert any(float(pred.quant_scales[k]) > float(per_flip[0][k])
               for k in pred.quant_scales)


# -- 2D serving --------------------------------------------------------------

RES = 32


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    jm = JaxUNetModel(JaxUNetConfig(in_channels=1, out_channels=1,
                                    unet_type="UNet", base_features=8))
    variables = jm.init(jax.random.PRNGKey(3), jnp.zeros((1, RES, RES, 1)))
    path = str(tmp_path_factory.mktemp("quant_serve") / "bundle")
    jm.save_pretrained(path, variables)
    return path


def test_register_unet2d_int8_calibrates_on_the_first_batch(bundle,
                                                            monkeypatch):
    seen = []
    real = quant.quant_mode

    def spy(m, scales=None, model=None):
        seen.append((m, id(scales), len(scales) if scales is not None
                     else None))
        return real(m, scales, model)

    monkeypatch.setattr(quant, "quant_mode", spy)
    reg = ModelRegistry()
    reg.register_unet2d("q", bundle, resolution=RES, device="cpu",
                        quantize="int8", calib_batches=1, max_batch=2)
    warm = list(seen)
    # the warm-up ran calib then int8 at batches 1 and 2, on scales of its
    # own
    assert [m for m, _, _ in warm] == ["calib", "int8"] * 2
    entry = reg.get("q")
    rng = np.random.default_rng(8)
    b1 = rng.integers(0, 256, (2, RES, RES, 1)).astype(np.uint8)
    b2 = rng.integers(0, 256, (2, RES, RES, 1)).astype(np.uint8)
    m1 = entry.forward(b1)
    m2 = entry.forward(b2)
    served = seen[len(warm):]
    assert [m for m, _, _ in served] == ["calib", "int8"]
    assert served[0][2] == 0  # the served scales start empty
    assert served[0][1] == served[1][1]
    assert served[0][1] not in {i for _, i, _ in warm}

    # the port's own calibrate-then-int8 forward on the float32 weights
    model = UNetModel.from_pretrained(bundle, device="cpu")
    x1 = torch.from_numpy(b1).float() / 255.0
    x2 = torch.from_numpy(b2).float() / 255.0
    scales = quant.calibrate(lambda xx: model(xx), model, [x1])
    with torch.inference_mode():
        f1 = (torch.sigmoid(model(x1).logits)[..., 0] > 0.5).numpy()
        with real("int8", scales, model):
            p2 = torch.sigmoid(model(x2).logits)[..., 0]
    np.testing.assert_array_equal(m1, f1.astype(np.uint8))
    np.testing.assert_array_equal(m2, (p2 > 0.5).numpy().astype(np.uint8))
    # the float probe stays float
    np.testing.assert_allclose(entry.probs_forward(x2.numpy())[..., 0],
                               torch.sigmoid(model(x2).logits)[..., 0]
                               .detach().numpy(), rtol=1e-6, atol=1e-6)


def test_cli_serve_parses_quantize_and_calib_batches(monkeypatch):
    calls = []
    monkeypatch.setattr(ModelRegistry, "register_unet2d",
                        lambda self, *a, **kw: calls.append((a, kw)))
    monkeypatch.setattr(ModelRegistry, "names", lambda self: ["a"])
    import mdeical_image_segmentation_tpu_torch.serve as serve_pkg
    monkeypatch.setattr(serve_pkg, "serve", lambda *a, **kw: None)
    serve_cli.main(["--unet2d", "name=a,path=p,quantize=int8,calib_batches=2",
                    "--device", "cpu"])
    (args, kw), = calls
    assert args == ("a", "p")
    assert kw["quantize"] == "int8" and kw["calib_batches"] == 2
    calls.clear()
    serve_cli.main(["--unet2d", "name=a,path=p", "--device", "cpu"])
    assert calls[0][1]["quantize"] is None and calls[0][1]["calib_batches"] == 1

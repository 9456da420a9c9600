"""SAM-Med2D in the port (``models/sam.py``, the SAM bridge of
``utils/param_bridge.py``, ``ModelRegistry.register_sam``) against the JAX
package's ``models/sam.py`` on the CPU, at the JAX tests' small size (img
64, embed 64, depth 2, heads 4, prompt 64) with the JAX package's
initialized parameters: the bridge both ways to the bit; masks and IoU
predictions for points, a box, a mask prompt, multimask and padded points
within 1e-4; ``sam_loss`` and its gradients against ``jax.value_and_grad``
within 1e-5 relative; bundles across packages both ways; promptable HTTP
serving against the JAX package's served masks and its error replies."""

import http.client
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from mdeical_image_segmentation_tpu.models.sam import SAMMed2D as JaxSAM
from mdeical_image_segmentation_tpu.models.sam import load_sam as jax_load_sam
from mdeical_image_segmentation_tpu.models.sam import sam_loss as jax_sam_loss
from mdeical_image_segmentation_tpu.models.sam import save_sam as jax_save_sam
from mdeical_image_segmentation_tpu.serve import ModelRegistry as JaxRegistry
from mdeical_image_segmentation_tpu_torch.models import SAMMed2D, sam_loss
from mdeical_image_segmentation_tpu_torch.models.sam import load_sam, save_sam
from mdeical_image_segmentation_tpu_torch.serve import (
    ModelRegistry,
    SegmentationServer,
)
from mdeical_image_segmentation_tpu_torch.utils.param_bridge import (
    sam_flax_to_state_dict,
    sam_state_dict_to_flax,
)

SMALL = dict(img_size=64, in_channels=1, embed_dim=64, encoder_depth=2,
             encoder_heads=4, prompt_embed_dim=64)
OUT_TOL = 1e-4    # masks and IoU predictions, port vs JAX, absolute
LOSS_TOL = 1e-5   # sam_loss and its gradients, relative to max |value|
TIE_BAND = 1e-4   # served masks may differ only where p is this close to 0.5


def _flat(tree):
    return {"/".join(k.key for k in path): np.asarray(leaf) for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def sams(tmp_path_factory):
    jm = JaxSAM(**SMALL)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 64, 64, 1)),
                                 jnp.zeros((1, 1, 2)),
                                 jnp.ones((1, 1), jnp.int32))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    model = SAMMed2D(**SMALL, device="meta")
    model.load_state_dict(sam_flax_to_state_dict(variables), assign=True)
    bundle = str(tmp_path_factory.mktemp("sam") / "jax_bundle")
    jax_save_sam(bundle, jm, variables)
    return jm, variables, model.eval(), bundle


def _prompts(seed=0):
    rs = np.random.RandomState(seed)
    return {
        "img": rs.rand(2, 64, 64, 1).astype(np.float32),
        "pts": (rs.rand(2, 3, 2) * 64).astype(np.float32),
        "lbl": np.array([[1, 0, -1], [1, 1, 0]], np.int32),
        "box": np.array([[[8, 8], [50, 40]], [[2, 3], [60, 61]]], np.float32),
        "mask": rs.randn(2, 16, 16, 1).astype(np.float32),
    }


def test_bridge_round_trip_is_exact(sams):
    _, variables, model, _ = sams
    sd = model.state_dict()
    assert set(sd) == set(sam_flax_to_state_dict(variables))
    back, want = _flat(sam_state_dict_to_flax(sd)), _flat(variables)
    assert set(back) == set(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
    # the taps of a transposed conv are flipped, a Dense kernel transposed
    ct = variables["params"]["mask_decoder"]["ConvTranspose_0"]["kernel"]
    np.testing.assert_array_equal(
        sd["mask_decoder.ConvTranspose_0.weight"].numpy(),
        np.transpose(ct[::-1, ::-1], (2, 3, 0, 1)))


def test_defaults_match_the_jax_model():
    jm, model = JaxSAM(), SAMMed2D(device="meta")
    assert model.config() == {k: getattr(jm, k) for k in model.config()}
    assert model.mask_decoder.block0.self_attn.num_heads == 8
    assert model.image_encoder.block0.LayerNorm_0.eps == 1e-6


CASES = {
    "points": (("img", "pts", "lbl"), {}),
    "box": (("img", "pts", "lbl", "box"), {}),
    "box_only": (("img", None, None, "box"), {}),
    "mask_prompt": (("img", "pts", "lbl", "box", "mask"), {}),
    "multimask": (("img", "pts", "lbl"), {"multimask_output": True}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_outputs_match_jax(sams, case):
    jm, variables, model, _ = sams
    names, kw = CASES[case]
    p = _prompts()
    args = [None if n is None else p[n] for n in names]
    jmask, jiou = jax.jit(jm.apply, static_argnames="multimask_output")(
        variables, *[None if a is None else jnp.asarray(a) for a in args],
        **kw)
    with torch.no_grad():
        mask, iou = model(*[None if a is None else torch.from_numpy(a)
                            for a in args], **kw)
    m = 3 if kw else 1
    assert mask.shape == (2, m, 16, 16) and iou.shape == (2, m)
    np.testing.assert_allclose(mask.numpy(), np.asarray(jmask), rtol=0,
                               atol=OUT_TOL)
    np.testing.assert_allclose(iou.numpy(), np.asarray(jiou), rtol=0,
                               atol=OUT_TOL)


def test_padded_points_are_inert_and_match_jax(sams):
    """A pad-labelled point changes nothing, wherever it lies."""
    jm, variables, model, _ = sams
    img = np.random.RandomState(1).rand(1, 64, 64, 1).astype(np.float32)
    lbl = np.asarray([[1, -1]], np.int32)
    outs = []
    for pad in ([0.0, 0.0], [55.0, 13.0]):
        pts = np.asarray([[[20.0, 20.0], pad]], np.float32)
        with torch.no_grad():
            outs.append(model(torch.from_numpy(img), torch.from_numpy(pts),
                              torch.from_numpy(lbl))[0].numpy())
    np.testing.assert_array_equal(outs[0], outs[1])
    want, _ = jax.jit(jm.apply)(variables, jnp.asarray(img),
                                jnp.asarray(pts), jnp.asarray(lbl))
    np.testing.assert_allclose(outs[0], np.asarray(want), rtol=0,
                               atol=OUT_TOL)


@pytest.mark.parametrize("target_hw", [(16, 16), (64, 64)])
def test_sam_loss_and_grads_match_jax(target_hw):
    rs = np.random.RandomState(2)
    logits = (3 * rs.randn(3, 1, 16, 16)).astype(np.float32)
    iou = rs.rand(3, 1).astype(np.float32)
    target = (rs.rand(3, *target_hw) > 0.6).astype(np.float32)
    jl, (jg_l, jg_i) = jax.value_and_grad(
        lambda a, b: jax_sam_loss(a, b, jnp.asarray(target)),
        argnums=(0, 1))(jnp.asarray(logits), jnp.asarray(iou))
    tl, ti = (torch.from_numpy(a).requires_grad_() for a in (logits, iou))
    loss = sam_loss(tl, ti, torch.from_numpy(target))
    loss.backward()
    for got, want in ((loss.detach(), jl), (tl.grad, jg_l), (ti.grad, jg_i)):
        want = np.asarray(want)
        err = np.abs(got.numpy() - want).max()
        assert err <= LOSS_TOL * max(np.abs(want).max(), 1e-12), err


def test_bundles_cross_packages(sams, tmp_path):
    jm, variables, model, jax_bundle = sams
    # JAX writes, the port reads
    loaded = load_sam(jax_bundle, device="cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    # the port writes, JAX reads
    port_bundle = str(tmp_path / "port_bundle")
    save_sam(port_bundle, loaded)
    assert json.load(open(os.path.join(port_bundle, "config.json"))) == (
        json.load(open(os.path.join(jax_bundle, "config.json"))))
    jm2, v2 = jax_load_sam(port_bundle)
    assert {k: getattr(jm2, k) for k in SMALL} == SMALL
    back, want = _flat(v2), _flat(variables)
    assert set(back) == set(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)


def test_seeded_init_is_flax_like():
    m = SAMMed2D(**SMALL, device="cpu",
                 generator=torch.Generator().manual_seed(0))
    m2 = SAMMed2D(**SMALL, device="cpu",
                  generator=torch.Generator().manual_seed(0))
    for (k, a), b in zip(m.state_dict().items(), m2.state_dict().values()):
        assert torch.equal(a, b), k
    pe = m.image_encoder.pos_embed
    assert 0.015 < float(pe.detach().std()) < 0.025
    q = m.image_encoder.block0.Attention_0.q_proj
    assert float(q.bias.detach().abs().max()) == 0.0
    assert abs(float(q.weight.detach().std()) * 64 ** 0.5 - 1.0) < 0.1
    ln = m.mask_decoder.LayerNorm_1
    assert torch.equal(ln.weight, torch.ones(16))


def _post(port, payload):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("POST", "/", json.dumps(payload),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    body = json.loads(resp.read())
    conn.close()
    return resp.status, body


def test_promptable_serving_matches_jax(sams, tmp_path):
    """register_sam over HTTP: point, box and point + box prompts (in the
    original image's pixels, rescaled) give the JAX package's served masks;
    the PNG grey scaling and the error replies of the JAX package's
    test_promptable_sam_serving."""
    _, _, _, bundle = sams
    registry = ModelRegistry()
    registry.register_sam("sam", bundle, device="cpu", max_batch=4)
    # threshold 0.0: every sigmoid probability exceeds it
    registry.register_sam("samall", bundle, threshold=0.0, device="cpu",
                          max_batch=1)
    jreg = JaxRegistry()
    jreg.register_sam("sam", bundle)
    jentry = jreg.get("sam")
    srv = SegmentationServer(registry, output_dir=str(tmp_path / "masks"))
    port = srv.start(host="127.0.0.1", port=0).server_address[1]
    try:
        img = (np.random.RandomState(0).rand(48, 80) * 255).astype(np.uint8)
        path = str(tmp_path / "img.png")
        Image.fromarray(img).save(path)
        requests = [
            {"points": [[40, 24]]},
            {"points": [[20, 20], [60, 40]], "point_labels": [1, 0],
             "box": [[8, 8], [70, 44]]},
            {"box": [[4, 2], [50, 30]]},
        ]
        for req in requests:
            status, body = _post(port, {"image_path": path, "model": "sam",
                                        "return": "mask", **req})
            assert status == 200, body
            mask = np.asarray(body["response"], np.uint8)
            assert mask.shape == (64, 64)
            entry = registry.get("sam")
            image, orig_hw = srv._build_input(path, entry)
            pts, lbl, box = srv._build_prompts(req, entry, orig_hw)
            args = [image[None].astype(np.float32) / 255.0, pts[None],
                    lbl[None]] + ([] if box is None else [box[None]])
            p = np.asarray(jentry.forward(*args))[0]
            decided = np.abs(p - 0.5) > TIE_BAND
            np.testing.assert_array_equal(mask[decided], (p > 0.5)[decided])
            np.testing.assert_allclose(entry.probs_forward(*args)[0], p,
                                       rtol=0, atol=OUT_TOL)

        # a positive binary mask renders as 255, not 255 // (width - 1)
        status, body = _post(port, {"image_path": path, "model": "samall",
                                    "points": [[32, 32]]})
        assert status == 200, body
        vis = np.asarray(Image.open(body["response"]))
        assert vis.max() == 255 and set(np.unique(vis)) <= {0, 255}

        for bad, words in (
                ({}, "needs points and/or box"),
                ({"points": [[1, 1]] * 20}, "too many points"),
                ({"points": [[1, 1]], "point_labels": [1, 0]},
                 "length mismatch")):
            status, body = _post(port, {"image_path": path, "model": "sam",
                                        **bad})
            assert status == 400 and words in body["response"], body
    finally:
        srv.stop()

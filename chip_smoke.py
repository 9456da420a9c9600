"""GPU smoke run of the PyTorch port: 2D serving, 3D sliding-window
inference and 3D 'gcr' training.

    python3 chip_smoke.py

Needs one CUDA card, nvcc and the checkout this file sits in; imports nothing
of JAX (nor PyYAML or h5py).  It exits non-zero, without printing a result,
when any of those is missing or any phase fails.  Every phase prints its
wall time.

1. DoubleConv kernel against its plain version: builds all of ``csrc/`` for
   sm_90a from this checkout (one nvcc per source, in parallel), runs
   ``fused_double2d`` on the 9 DoubleConv shapes of the base-64 UNet at 256²
   (N=2) plus ragged shapes, in float32 (plain version with TF32 off,
   rtol = atol = 1e-4) and bfloat16 (rtol = atol = 2e-2, about two bf16
   ulps), comparing y and z, and times kernel and cuDNN pair with CUDA
   events (median of 20 after warm-up).
2. 2D serving: a base-64 bf16 UNet from a seeded generator is saved with
   ``save_pretrained``, loaded by ``ModelRegistry.register_unet2d(
   resolution=256, device="cuda")`` and served by ``SegmentationServer`` on
   127.0.0.1; 8 concurrent clients POST 16 synthetic PNGs in the png, mask
   and path return modes.  Every reply must be 200 with a 256x256 mask, the
   kernel must have launched 9 times per device batch, and 4 served masks
   must agree on >= 99.9% of pixels with the same model run with the plain
   DoubleConv (probabilities within 2e-2).  Last, one batch of 8 is timed
   through the served forward and through the plain path (median of 5).
3. The 3D predictor at full width: UNet3D from the model section of
   ``configs/unet3d_predict.yml`` (f_maps 64, 4 levels, 'gcr', fp32) with
   weights from a seeded generator, saved with the port's
   ``save_checkpoint``, loaded with ``load_checkpoint`` and the parameter
   bridge, and run through ``get_predictor`` and
   ``StandardPredictor._device_accumulate`` with the yml's settings (batch
   4, patch = stride 80x170x170, halo 16/32/32: 112x234x234 inputs) on a
   seeded standardized 80x340x510 volume (6 patches: a full batch and a
   padded tail).  Per batch: 14 fused GN-conv and 14 GN-statistics
   launches, and one overlap-add; the averaged map must match the same
   pipeline on the plain versions (cuDNN conv3d with TF32 off, plain GN,
   plain overlap-add) within 1e-3 x max(1, |map|), counts equal.
4. ResidualUNet3D, f_maps 32, 5 levels, 'gcr' through the same predictor
   (patch 48x96x96, halo 8/16/16: 64x128x128 inputs) on a 48x192x288
   volume: per batch 9 fused GN-conv, 18 GN-statistics and 9 GN-affine
   launches (conv3, order 'gc'); map within 2e-3 x max(1, |map|).
5. 3D serving: ``register_unet3d`` on phase 3's checkpoint at 256²
   (slices replicated to depth 8) behind ``SegmentationServer``; 4 clients
   POST 8 PNGs; all replies 200 with 256x256 masks, probabilities within
   1e-3 of the plain path.
6. The 3D kernels against their plain versions at every shape phases 3-4
   gave them, plus ragged cases (kd 3 and 1, pre-ReLU, Ci 1/3/19/40; C 3,
   19, 300; overlapping windows with a valid = 0 tail), in fp32 and bf16:
   GN-conv within 1e-4 (fp32) / 2e-2 (bf16), GN statistics (mean and
   rsqrt(var + eps)) within 1e-4, GN affine within 1e-6 / 2e-2, overlap-add
   bit-exact; kernel and plain ms by CUDA events, in turns, median.
7. The GroupNorm backward kernels (Σg and Σg·x̂; dx = g·A + x·C + D)
   against their plain versions at every GroupNorm input shape of the two
   training models (UNet3D at 80x170x170, ResidualUNet3D at 64x128x128,
   N = 1, found by one forward with hooks) plus ragged C and C = 1, in fp32
   and bf16: the sums within 1e-5 x the number of positions, dx within
   1e-6 / 2e-2; kernel and plain ms by CUDA events, in turns, median.
8. Gradients (dx, dscale, dbias, dw) through the autograd Functions
   ``gcr_fused_conv`` (the UNet3D's 14 shapes, kd 3 and kd 1) and
   ``GroupNorm`` (the ResidualUNet3D's shapes and ragged ones) against
   autograd through the plain composition (affine, ``F.conv3d``, ReLU;
   ``F.group_norm``), fp32 with TF32 off: within 1e-3 of each gradient's
   max |value|.  The cotangent is zeroed where either output lies within
   1e-4 x max|y| of the ReLU's kink, which neither path decides exactly.
9. Training at full width: the UNet3D and the loss, metric, optimizer,
   scheduler and settings of ``configs/unet3d_train.yml`` (f_maps 64, 4
   levels, 'gcr', BCEDice, MeanIoU, Adam 2e-4 / 1e-5, ReduceLROnPlateau;
   batch 1, patch 80x170x170, train stride 40x90x90, fp32, TF32 off) with
   weights from a seeded generator, loaded through ``pre_trained``, driven
   by ``UNetTrainer.fit()`` over a ``VolumeLoader`` of 4 patches of a
   seeded 80x260x260 volume (label: its smoothed sign) and 2 validation
   patches: 7 steps, validation and checkpoints at iterations 3 and 6.
   Per step 14 GN-conv, 14 GN-statistics, 14 GN-affine (the backward's
   recompute), 14 bwd-reduce and 13 bwd-dx launches (the image needs no
   dx); finite losses; last and best checkpoints.  The first 3 steps
   again on the plain path from the same weights: losses within 1e-5,
   1e-4, 1e-3 relative (Adam turns rounding noise into ±lr steps; see
   LOSS_TOLS) and the grad norm after step 1 within 1e-4.  A ``resume``
   from the last checkpoint takes one step at iteration 6 (Adam step 7).
   Step ms (synchronised) and peak memory of both paths.
10. ResidualUNet3D f_maps 32, 5 levels at 64x128x128 for two steps: per
   step 9 GN-conv, 18 of each GroupNorm kernel (its 'gc' conv3 runs the
   ``GroupNorm`` Function); losses and grad norm against the plain path.
11. Prints the card's name and power limit, the kernels' JSON line (launches
   from the main-path runs, each run's counts zeroed just before it), and
   last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import base64
import http.client
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
FP32_TOL = 1e-4
BF16_TOL = 2e-2
PROB_TOL = 2e-2
MASK_AGREEMENT = 0.999
REPEATS = 20
SEED = 0  # inputs and weights are random, made from this seed

# (N, H, W, Ci, C1, Co): the base-64 UNet's DoubleConvs at 256², then ragged
DC_SHAPES = [
    ("DC0", (2, 256, 256, 1, 64, 64)),
    ("DC1", (2, 128, 128, 64, 128, 128)),
    ("DC2", (2, 64, 64, 128, 256, 256)),
    ("DC3", (2, 32, 32, 256, 512, 512)),
    ("DC4", (2, 16, 16, 512, 1024, 1024)),
    ("DC5", (2, 32, 32, 1024, 512, 512)),
    ("DC6", (2, 64, 64, 512, 256, 256)),
    ("DC7", (2, 128, 128, 256, 128, 128)),
    ("DC8", (2, 256, 256, 128, 64, 64)),
]
RAGGED_SHAPES = [
    ("ragged_a", (2, 17, 33, 3, 20, 70)),
    ("ragged_b", (2, 33, 17, 1, 40, 100)),
    ("ragged_c", (1, 17, 17, 5, 33, 129)),
    ("ragged_d", (3, 9, 31, 19, 7, 65)),
]


def log(msg: str) -> None:
    print(msg, flush=True)


def _import_port():
    """Import the port from this checkout, and nowhere else."""
    sys.path.insert(0, ROOT)
    import mdeical_image_segmentation_tpu_torch as port

    where = os.path.dirname(os.path.abspath(port.__file__))
    if os.path.dirname(where) != ROOT:
        raise RuntimeError(f"the port was imported from {where}, not from "
                           f"the checkout at {ROOT}")
    return port


def _inputs(shape, dtype, gen):
    import torch

    n, h, w, ci, c1, co = shape
    x = torch.rand((n, h, w, ci), device="cuda", generator=gen)
    w1 = torch.randn((3, 3, ci, c1), device="cuda", generator=gen) / (9 * ci) ** 0.5
    b1 = 0.1 * torch.randn((c1,), device="cuda", generator=gen)
    w2 = torch.randn((3, 3, c1, co), device="cuda", generator=gen) / (9 * c1) ** 0.5
    b2 = 0.1 * torch.randn((co,), device="cuda", generator=gen)
    return [t.to(dtype) for t in (x, w1, b1, w2, b2)]


def _median_ms(fn, repeats: int = REPEATS) -> float:
    import torch

    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(repeats)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(repeats)]
    for s, e in zip(starts, ends):
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def phase_kernels(seed: int):
    """Kernel vs plain version on every shape; returns (max_abs_err,
    kernel ms, plain ms summed over the 9 UNet shapes in bf16)."""
    import torch

    from mdeical_image_segmentation_tpu_torch.ops import _build
    from mdeical_image_segmentation_tpu_torch.ops.fused_conv import (
        fused_double2d,
        fused_double2d_reference,
    )

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.time()
    _build.load()
    log(f"[phase 1] kernel library {_build.library_path().name} ready in "
        f"{time.time() - t0:.2f} s")
    for line in _build.build_log_path().read_text().splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    gen = torch.Generator(device="cuda").manual_seed(seed)
    max_err = 0.0
    ms = plain_ms = 0.0
    log(f"{'case':9s} {'dtype':8s} {'N,H,W,Ci,C1,Co':28s} {'err y':>10s} "
        f"{'err z':>10s} {'kernel ms':>10s} {'cuDNN ms':>10s}")
    for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
        for name, shape in DC_SHAPES + RAGGED_SHAPES:
            args = _inputs(shape, dtype, gen)
            y, z = fused_double2d(*args)
            y_only, no_z = fused_double2d(*args, with_z=False)
            y_ref, z_ref = fused_double2d_reference(*args)
            torch.cuda.synchronize()
            if no_z is not None or not torch.equal(y, y_only):
                raise AssertionError(f"{name}: with_z=False changed y")
            errs = []
            for what, got, want in (("y", y, y_ref), ("z", z, z_ref)):
                got, want = got.float(), want.float()
                if not torch.isfinite(got).all():
                    raise AssertionError(f"{name} {dtype}: non-finite {what}")
                errs.append((got - want).abs().max().item())
                if not torch.allclose(got, want, rtol=tol, atol=tol):
                    raise AssertionError(
                        f"{name} {dtype}: {what} differs from the plain "
                        f"version by {errs[-1]:.3e} (rtol = atol = {tol})")
            max_err = max(max_err, *errs)
            k_ms = _median_ms(lambda: fused_double2d(*args, with_z=False))
            p_ms = _median_ms(
                lambda: fused_double2d_reference(*args, with_z=False))
            if dtype == torch.bfloat16 and name.startswith("DC"):
                ms += k_ms
                plain_ms += p_ms
            log(f"{name:9s} {str(dtype)[6:]:8s} {str(shape):28s} "
                f"{errs[0]:10.3e} {errs[1]:10.3e} {k_ms:10.4f} {p_ms:10.4f}")
            del args, y, z, y_only, y_ref, z_ref
    log(f"[phase 1] ok: max |kernel - plain| = {max_err:.3e}; 9 UNet shapes "
        f"in bf16: kernel {ms:.4f} ms, cuDNN pair {plain_ms:.4f} ms")
    return max_err, ms, plain_ms


def _plain_probs(model, x_u8):
    """The model's forward with every DoubleConv on its plain version."""
    import torch

    from mdeical_image_segmentation_tpu_torch.models import crop_and_concat
    from mdeical_image_segmentation_tpu_torch.ops.fused_conv import (
        fused_double2d_reference,
    )
    from mdeical_image_segmentation_tpu_torch.ops.image import max_pool2d

    unet = model.module

    def dc(i, t):
        m = getattr(unet, f"DoubleConvolution_{i}")
        w1, b1 = m.TorchConv_0.hwio()
        w2, b2 = m.TorchConv_1.hwio()
        return fused_double2d_reference(t, w1, b1, w2, b2, with_z=False)[0]

    with torch.inference_mode():
        x = (x_u8.float() / 255.0).to(model.compute_dtype)
        skips = []
        for i in range(unet.levels):
            x = dc(i, x)
            skips.append(x)
            x = max_pool2d(x, 2)
        x = dc(unet.levels, x)
        for i in range(unet.levels):
            x = getattr(unet, f"UpSample_{i}")(x)
            x = crop_and_concat(x, skips.pop())
            x = dc(unet.levels + 1 + i, x)
        return torch.sigmoid(unet.TorchConv_0(x).float())


def _post(port: int, payload: dict):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request("POST", "/", json.dumps(payload),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _get(port: int, path: str):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path)
        return json.loads(conn.getresponse().read())
    finally:
        conn.close()


def phase_serve(seed: int, workdir: str):
    """Serve the base-64 bf16 UNet at 256²; returns the kernel launch count
    of the served traffic."""
    import numpy as np
    import torch

    from mdeical_image_segmentation_tpu_torch.data.png2d import nearest_resize
    from mdeical_image_segmentation_tpu_torch.models import (
        UNetConfig,
        UNetModel,
    )
    from mdeical_image_segmentation_tpu_torch.ops.fused_conv import (
        fused_double2d,
    )
    from mdeical_image_segmentation_tpu_torch.serve import (
        ModelRegistry,
        SegmentationServer,
    )
    from mdeical_image_segmentation_tpu_torch.utils import png

    res, max_batch, clients = 256, 8, 8
    config = UNetConfig(in_channels=1, out_channels=1, unet_type="UNet",
                        base_features=64, compute_dtype="bfloat16")
    bundle = os.path.join(workdir, "unet2d_base64_bf16")
    UNetModel(config, generator=torch.Generator().manual_seed(seed)
              ).save_pretrained(bundle)

    t0 = time.time()
    registry = ModelRegistry()
    registry.register_unet2d("unet", bundle, resolution=res, device="cuda",
                             max_batch=max_batch)
    log(f"[phase 2] registered (load + warm-up of batches 1..{max_batch}) "
        f"in {time.time() - t0:.2f} s")

    rng = np.random.default_rng(seed)
    sizes = [(256, 256), (200, 310), (384, 384), (97, 130)]
    images = []
    for i in range(16):
        h, w = sizes[i % len(sizes)]
        yy, xx = np.mgrid[:h, :w]
        blob = (((yy - h / 2) ** 2 + (xx - w / 3) ** 2) < (min(h, w) / 3) ** 2)
        noise = rng.integers(0, 60, (h, w))
        grey = (blob * 150 + noise).astype(np.uint8)
        arr = grey if i % 3 else np.stack([grey, grey // 2, 255 - grey], -1)
        path = os.path.join(workdir, f"scan_{i:02d}.png")
        png.write(path, arr)
        images.append(path)

    srv = SegmentationServer(registry, output_dir=os.path.join(workdir, "masks"),
                             max_batch=max_batch, max_wait_ms=5.0)
    port = srv.start(host="127.0.0.1", port=0).server_address[1]
    modes = ("png", "mask", "path")
    replies = [None] * len(images)
    try:
        occ0 = srv.engine.occupancy().get("unet", {"batches": 0})["batches"]
        fused_double2d.launches = 0

        def client(k):
            for i in range(k, len(images), clients):
                replies[i] = _post(port, {"image_path": images[i],
                                          "return": modes[i % 3]})

        t0 = time.time()
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.time() - t0
        launches = fused_double2d.launches
        if any(t.is_alive() for t in threads):
            raise AssertionError("a client did not finish within 600 s")
        stats = _get(port, "/stats")
    finally:
        srv.stop()
    batches = stats["batch_occupancy"]["unet"]["batches"] - occ0
    log(f"[phase 2] 16 requests from {clients} clients in {wall:.3f} s; "
        f"/stats: {json.dumps(stats)}")

    masks = []
    for i, (status, body) in enumerate(replies):
        if status != 200 or body.get("status") != 200:
            raise AssertionError(f"request {i}: {status} {body}")
        mode = modes[i % 3]
        if mode == "png":
            mask = png.convert(png.decode(base64.b64decode(body["response"])),
                               "L")
        elif mode == "mask":
            mask = np.asarray(body["response"], np.uint8)
        else:
            mask = png.read(body["response"], "L") // 255
        if mask.shape != (res, res) or mask.max() > 1:
            raise AssertionError(f"request {i}: bad mask {mask.shape}")
        masks.append(mask)

    if batches <= 0 or launches != 9 * batches:
        raise AssertionError(f"{launches} kernel launches for {batches} "
                             "device batches (want 9 per batch)")
    log(f"[phase 2] {launches} kernel launches for {batches} device batches "
        f"(9 DoubleConvs each); all 16 replies 200 with {res}x{res} masks")

    model = UNetModel.from_pretrained(bundle, device="cuda")
    entry = registry.get("unet")
    for i in range(4):
        x = nearest_resize(png.read(images[i], "L")[..., None], (res, res))
        plain = _plain_probs(model, torch.from_numpy(x[None]).cuda())
        plain = plain.cpu().numpy()[0, ..., 0]
        served_probs = entry.probs_forward(
            x[None].astype(np.float32) / 255.0)[0, ..., 0]
        err = float(np.abs(served_probs - plain).max())
        agree = float(np.mean(masks[i] == (plain > 0.5)))
        log(f"  image {i} {sizes[i % 4]}: mask agreement {agree:.6f}, "
            f"max |p_kernel - p_plain| {err:.3e}, p in [{plain.min():.4f}, "
            f"{plain.max():.4f}], mask fg share {masks[i].mean():.4f}")
        if err > PROB_TOL or agree < MASK_AGREEMENT:
            raise AssertionError(f"image {i}: served output disagrees with "
                                 "the plain DoubleConv")

    # where the time goes at the model layer: one full device batch through
    # the served forward (kernel DoubleConvs) and through the plain path
    x8 = np.stack([nearest_resize(png.read(p, "L")[..., None], (res, res))
                   for p in images[:max_batch]])
    x8_dev = torch.from_numpy(x8).cuda()
    served_ms = _median_ms(lambda: entry.dispatch(x8), repeats=5)
    plain_ms = _median_ms(lambda: _plain_probs(model, x8_dev), repeats=5)
    log(f"[phase 2] forward of a batch of {max_batch} at {res}²: served "
        f"(kernel DoubleConvs, uint8 in, mask out) {served_ms:.3f} ms, plain "
        f"(cuDNN DoubleConvs, probabilities out) {plain_ms:.3f} ms")
    return launches


# ---------------------------------------------------------------------------
# 3D sliding-window inference (UNet3D / ResidualUNet3D 'gcr')
# ---------------------------------------------------------------------------

DEVICE = "cuda"
PREDICT_YML = os.path.join(ROOT, "configs", "unet3d_predict.yml")
VOLUME_3D = (80, 340, 510)      # 1 x 2 x 3 patches of 80x170x170: 6 patches
RESIDUAL_MODEL = {"name": "ResidualUNet3D", "in_channels": 1,
                  "out_channels": 1, "f_maps": 32, "num_levels": 5,
                  "layer_order": "gcr", "final_sigmoid": True}
RESIDUAL_SLICES = {"name": "SliceBuilder", "patch_shape": [48, 96, 96],
                   "stride_shape": [48, 96, 96], "halo_shape": [8, 16, 16]}
VOLUME_RESIDUAL = (48, 192, 288)  # 1 x 2 x 3 patches: 6 patches
UNET3D_MAP_TOL = 1e-3     # fp32 averaged map, kernel vs plain (TF32 off)
RESIDUAL_MAP_TOL = 2e-3   # its 1x1 shortcut of one input channel feeds
                          # GroupNorm channels whose E[x²] − mean² cancels
SERVE3D_PROB_TOL = 1e-3
GN_TOL = 1e-4             # per-channel mean and rsqrt(var + eps), fp32 sums
AFFINE_FP32_TOL = 1e-6    # both round x·a and x·a + b the same way
KERNELS_3D = ("gcr_conv3d", "gn_stats", "gn_affine", "gn_bwd_reduce",
              "gn_bwd_dx", "overlap_add")


def _read_yaml_subset(path: str) -> dict:
    """Read the block mappings, scalars (int, float, bool, string) and
    inline lists of a config file such as configs/unet3d_predict.yml or
    configs/unet3d_train.yml (the card's machine has no PyYAML); block list
    items ('- ...') are skipped, and the keys nested under them land in the
    enclosing mapping."""
    root: dict = {}
    stack = [(-1, root)]
    for raw in open(path):
        line = raw.split("#", 1)[0].rstrip()
        if not line.strip() or line.strip().startswith("- "):
            continue
        indent = len(line) - len(line.lstrip())
        key, _, value = line.strip().partition(":")
        while stack[-1][0] >= indent:
            stack.pop()
        parent = stack[-1][1]
        value = value.strip()
        if not value:
            parent[key] = {}
            stack.append((indent, parent[key]))
        elif value.startswith("["):
            parent[key] = json.loads(value)
        elif value in ("true", "false"):
            parent[key] = value == "true"
        else:
            for kind in (int, float, str):
                try:
                    parent[key] = kind(value)
                    break
                except ValueError:
                    continue
    return root


def _counts():
    from mdeical_image_segmentation_tpu_torch.ops import fused_conv, norm, overlap

    # inside _plain_path the plain versions stand in: they launch nothing
    fns = {"gcr_conv3d": fused_conv.fused_conv3d,
           "gn_stats": norm.gn_channel_sums, "gn_affine": norm.gn_affine,
           "gn_bwd_reduce": norm.gn_bwd_reduce, "gn_bwd_dx": norm.gn_bwd_dx,
           "overlap_add": overlap.overlap_add_into}
    return {k: getattr(fn, "launches", 0) for k, fn in fns.items()}


def _zero_counts():
    from mdeical_image_segmentation_tpu_torch.ops import fused_conv, norm, overlap

    for fn in (fused_conv.fused_conv3d, norm.gn_channel_sums, norm.gn_affine,
               norm.gn_bwd_reduce, norm.gn_bwd_dx, overlap.overlap_add_into):
        fn.launches = 0


class _plain_path:
    """Within this block the model, the predictor, the trainer and the
    server run every kernel's plain PyTorch version on the card (cuDNN
    conv3d, plain GN forward and backward, plain overlap-add): the
    comparison pipeline.  Nothing of the port switches by itself; only this
    script swaps the functions."""

    def __enter__(self):
        from mdeical_image_segmentation_tpu_torch.infer import predictor
        from mdeical_image_segmentation_tpu_torch.ops import fused_conv, norm, overlap

        self.saved = [
            (norm, "gn_channel_sums", norm.gn_channel_sums_reference),
            (norm, "gn_affine", norm.gn_affine_reference),
            (norm, "gn_bwd_reduce", norm.gn_bwd_reduce_reference),
            (norm, "gn_bwd_dx", norm.gn_bwd_dx_reference),
            (fused_conv, "fused_conv3d", fused_conv.fused_conv3d_reference),
            (predictor, "overlap_add_into",
             overlap.overlap_add_into_reference),
        ]
        self.saved = [(m, n, getattr(m, n), f) for m, n, f in self.saved]
        for m, n, _, f in self.saved:
            setattr(m, n, f)
        return self

    def __exit__(self, *exc):
        for m, n, orig, _ in self.saved:
            setattr(m, n, orig)


def _record_shapes(model, shapes: set):
    """Forward pre-hooks that note the input shape of every fused 'gcr'
    SingleConv and GroupNorm module: the shapes kernel checks run at."""
    from mdeical_image_segmentation_tpu_torch.models import SingleConv
    from mdeical_image_segmentation_tpu_torch.ops.norm import GroupNorm

    def conv_hook(mod, args):
        if mod.fused:
            x = args[0]
            shapes.add(("gcr", tuple(x.shape), mod.TorchConv_0.weight.shape[0]))
            shapes.add(("stats", tuple(x.shape)))

    def gn_hook(mod, args):
        shapes.add(("stats", tuple(args[0].shape)))
        shapes.add(("affine", tuple(args[0].shape)))

    handles = []
    for m in model.modules():
        if isinstance(m, SingleConv):
            handles.append(m.register_forward_pre_hook(conv_hook))
        elif isinstance(m, GroupNorm):
            handles.append(m.register_forward_pre_hook(gn_hook))
    return handles


def _timed_batches(pred, rec):
    """Wrap the predictor's batch forward to time each batch (synchronised
    host clock) and note the kernel launches it made."""
    import torch

    orig = pred._predict_batch_device

    def timed(input):
        torch.cuda.synchronize()
        before, t0 = _counts(), time.perf_counter()
        out = orig(input)
        torch.cuda.synchronize()
        after = _counts()
        rec.append(((time.perf_counter() - t0) * 1e3,
                    {k: after[k] - before[k] for k in after}))
        return out

    pred._predict_batch_device = timed


def _record_overlap_batches(channels, raw, slices, batch_size, shapes):
    """The overlap-add calls the predictor makes: patch batch shape, volume,
    starts and valid mask (the tail padded with the last start, weight 0)."""
    from mdeical_image_segmentation_tpu_torch.data.slice_builder import (
        SliceBuilder,
    )

    windows = SliceBuilder(raw, None, None, slices["patch_shape"],
                           slices["stride_shape"]).raw_slices
    for b0 in range(0, len(windows), batch_size):
        starts = [tuple(s.start for s in w) for w in
                  windows[b0:b0 + batch_size]]
        valid = [1] * len(starts) + [0] * (batch_size - len(starts))
        starts += [starts[-1]] * (batch_size - len(starts))
        shapes.add(("overlap", (batch_size, *slices["patch_shape"], channels),
                    tuple(raw.shape), tuple(starts), tuple(valid)))


def _volume(shape, seed):
    import numpy as np

    v = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return ((v - v.mean()) / v.std()).astype(np.float32)


def _run_predictor(model, config, raw, slices, batch_size, shapes=None):
    """One pass of the sliding-window predictor, kernel path then plain
    path; returns (maps, plain maps, per-batch records, launches)."""
    import torch

    from mdeical_image_segmentation_tpu_torch.data.volume_utils import (
        padded_patch_batches,
    )
    from mdeical_image_segmentation_tpu_torch.infer import get_predictor

    def batches():
        return padded_patch_batches(raw, slices, batch_size)

    handles = _record_shapes(model, shapes)
    _record_overlap_batches(model.out_channels, raw, slices, batch_size,
                            shapes)
    pred = get_predictor(model, None, config)
    rec = []
    _timed_batches(pred, rec)
    _zero_counts()
    t0 = time.perf_counter()
    acc, cnt = pred._device_accumulate(batches(), raw.shape,
                                       slices["halo_shape"])
    wall = time.perf_counter() - t0
    launches = _counts()
    for h in handles:
        h.remove()
    torch.cuda.empty_cache()
    with _plain_path():
        plain = get_predictor(model, None, config)
        plain_rec = []
        _timed_batches(plain, plain_rec)
        t0 = time.perf_counter()
        p_acc, p_cnt = plain._device_accumulate(batches(), raw.shape,
                                                slices["halo_shape"])
        plain_wall = time.perf_counter() - t0
    torch.cuda.empty_cache()
    return (acc, cnt), (p_acc, p_cnt), rec, plain_rec, launches, wall, plain_wall


def _check_maps(name, maps, plain, tol):
    import numpy as np

    (acc, cnt), (p_acc, p_cnt) = maps, plain
    if not np.array_equal(cnt, p_cnt) or cnt.min() < 1:
        raise AssertionError(f"{name}: count maps differ or leave voxels "
                             "uncovered")
    avg, p_avg = acc / cnt, p_acc / p_cnt
    if not np.isfinite(avg).all():
        raise AssertionError(f"{name}: non-finite averaged map")
    err = float(np.abs(avg - p_avg).max())
    scale = max(1.0, float(np.abs(p_avg).max()))
    log(f"  averaged map {avg.shape}: max |kernel - plain| {err:.3e} (limit "
        f"{tol} x {scale:.3f}), values in [{avg.min():.4f}, {avg.max():.4f}],"
        f" counts in [{cnt.min():.0f}, {cnt.max():.0f}]")
    if err > tol * scale:
        raise AssertionError(f"{name}: averaged map differs from the plain "
                             f"pipeline by {err:.3e}")
    return err


def phase_unet3d_predictor(seed: int, workdir: str, shapes: set):
    """UNet3D of configs/unet3d_predict.yml at full width through the port's
    checkpoint I/O and sliding-window predictor."""
    import torch

    from mdeical_image_segmentation_tpu_torch.models import get_model
    from mdeical_image_segmentation_tpu_torch.train import (
        load_checkpoint,
        save_checkpoint,
    )
    from mdeical_image_segmentation_tpu_torch.utils.param_bridge import (
        flax_to_state_dict,
        state_dict_to_flax,
    )

    torch.backends.cudnn.allow_tf32 = False
    cfg = _read_yaml_subset(PREDICT_YML)
    model_cfg, slices = cfg["model"], cfg["loaders"]["test"]["slice_builder"]
    batch_size = cfg["loaders"]["batch_size"]
    log(f"[phase 3] model {model_cfg}; predictor {cfg['predictor']}; "
        f"batch {batch_size}; slices {slices}")
    cpu_model = get_model(model_cfg,
                          generator=torch.Generator().manual_seed(seed))
    ckpt = save_checkpoint(
        {"model_state_dict": state_dict_to_flax(cpu_model.state_dict()),
         "best_eval_score": 0.0, "num_iterations": 0}, True, workdir)
    model = get_model(model_cfg, device=DEVICE)
    model.load_state_dict(flax_to_state_dict(
        load_checkpoint(ckpt)["model_state_dict"]["params"]))
    model.eval()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  {n_params} parameters, checkpoint {os.path.getsize(ckpt)} bytes")

    raw = _volume(VOLUME_3D, seed)
    config = {"model": model_cfg, "predictor": cfg["predictor"]}
    maps, plain, rec, plain_rec, launches, wall, plain_wall = _run_predictor(
        model, config, raw, slices, batch_size, shapes)
    for i, ((ms, n), (p_ms, _)) in enumerate(zip(rec, plain_rec)):
        log(f"  batch {i}: kernel path {ms:.1f} ms ({n}), plain path "
            f"{p_ms:.1f} ms")
        if n["gcr_conv3d"] != 14 or n["gn_stats"] != 14:
            raise AssertionError(f"batch {i}: {n}, want 14 gcr_conv3d and "
                                 "14 gn_stats launches")
    if launches["overlap_add"] != len(rec) or len(rec) != 2:
        raise AssertionError(f"{launches} for {len(rec)} batches: want one "
                             "overlap_add per batch, 2 batches")
    log(f"  whole volume: kernel path {wall:.2f} s, plain path "
        f"{plain_wall:.2f} s; launches {launches}")
    err = _check_maps("UNet3D", maps, plain, UNET3D_MAP_TOL)
    return model_cfg, ckpt, launches, err


def phase_residual_predictor(seed: int, shapes: set):
    """ResidualUNet3D f_maps 32, 5 levels (bench.py's residual row) through
    the same predictor: runs the GroupNorm affine kernel (conv3, 'gc')."""
    import torch

    from mdeical_image_segmentation_tpu_torch.models import get_model

    cfg = _read_yaml_subset(PREDICT_YML)
    model = get_model(RESIDUAL_MODEL,
                      generator=torch.Generator().manual_seed(seed + 1))
    model = model.to(DEVICE).eval()
    raw = _volume(VOLUME_RESIDUAL, seed + 1)
    config = {"model": RESIDUAL_MODEL, "predictor": cfg["predictor"]}
    maps, plain, rec, plain_rec, launches, wall, plain_wall = _run_predictor(
        model, config, raw, RESIDUAL_SLICES, cfg["loaders"]["batch_size"],
        shapes)
    for i, ((ms, n), (p_ms, _)) in enumerate(zip(rec, plain_rec)):
        log(f"  batch {i}: kernel path {ms:.1f} ms ({n}), plain path "
            f"{p_ms:.1f} ms")
        blocks = 2 * RESIDUAL_MODEL["num_levels"] - 1  # one ResNetBlock each
        if (n["gcr_conv3d"], n["gn_stats"], n["gn_affine"]) != (
                blocks, 2 * blocks, blocks):
            raise AssertionError(f"batch {i}: {n}, want {blocks} gcr_conv3d, "
                                 f"{2 * blocks} gn_stats and {blocks} "
                                 "gn_affine launches")
    log(f"  whole volume: kernel path {wall:.2f} s, plain path "
        f"{plain_wall:.2f} s; launches {launches}")
    err = _check_maps("ResidualUNet3D", maps, plain, RESIDUAL_MAP_TOL)
    return launches, err


def phase_serve3d(seed: int, workdir: str, model_cfg, ckpt: str):
    """register_unet3d on the UNet3D checkpoint at 256², served over HTTP."""
    import numpy as np
    import torch

    from mdeical_image_segmentation_tpu_torch.data.png2d import nearest_resize
    from mdeical_image_segmentation_tpu_torch.serve import (
        ModelRegistry,
        SegmentationServer,
    )
    from mdeical_image_segmentation_tpu_torch.utils import png

    res, max_batch, clients = 256, 8, 4
    t0 = time.time()
    registry = ModelRegistry()
    registry.register_unet3d("unet3d", ckpt, model_cfg, resolution=res,
                             device=DEVICE, max_batch=max_batch)
    log(f"[phase 5] registered (load + warm-up of batches 1..{max_batch}, "
        f"depth 8) in {time.time() - t0:.2f} s")
    rng = np.random.default_rng(seed)
    images = []
    for i in range(8):
        h, w = (256, 256) if i % 2 else (300, 220)
        path = os.path.join(workdir, f"slice_{i}.png")
        png.write(path, rng.integers(0, 256, (h, w)).astype(np.uint8))
        images.append(path)
    srv = SegmentationServer(registry, output_dir=os.path.join(workdir, "m3"),
                             max_batch=max_batch, max_wait_ms=5.0)
    port = srv.start(host="127.0.0.1", port=0).server_address[1]
    replies = [None] * len(images)
    try:
        _zero_counts()

        def client(k):
            for i in range(k, len(images), clients):
                replies[i] = _post(port, {"image_path": images[i],
                                          "return": "png"})

        t0 = time.time()
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.time() - t0
        launches = _counts()
        if any(t.is_alive() for t in threads):
            raise AssertionError("a client did not finish within 600 s")
        stats = _get(port, "/stats")
    finally:
        srv.stop()
    for i, (status, body) in enumerate(replies):
        if status != 200 or body.get("status") != 200:
            raise AssertionError(f"3D request {i}: {status} {body}")
        mask = png.convert(png.decode(base64.b64decode(body["response"])), "L")
        if mask.shape != (res, res) or mask.max() > 1:
            raise AssertionError(f"3D request {i}: bad mask {mask.shape}")
    if launches["gcr_conv3d"] == 0 or launches["gn_stats"] == 0:
        raise AssertionError(f"3D serving launched {launches}")
    log(f"[phase 5] {len(images)} requests from {clients} clients in "
        f"{wall:.3f} s, all 200 with {res}x{res} masks; launches {launches}; "
        f"/stats {json.dumps(stats)}")
    entry = registry.get("unet3d")
    x = np.stack([nearest_resize(png.read(p, "L")[..., None], (res, res))
                  for p in images[:2]]).astype(np.float32) / 255.0
    probs = entry.probs_forward(x)
    with _plain_path():
        plain = entry.probs_forward(x)
    err = float(np.abs(probs - plain).max())
    log(f"  served probabilities vs plain path: max |diff| {err:.3e} (limit "
        f"{SERVE3D_PROB_TOL}), p in [{plain.min():.4f}, {plain.max():.4f}]")
    if not np.isfinite(probs).all() or err > SERVE3D_PROB_TOL:
        raise AssertionError("3D serving disagrees with the plain path")
    torch.cuda.empty_cache()
    return launches


def _compare(name, got, want, tol, exact=False):
    import torch

    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (got - want).abs().max().item()
    ok = torch.equal(got, want) if exact else torch.allclose(
        got, want, rtol=tol, atol=tol)
    if not ok:
        raise AssertionError(f"{name}: kernel differs from the plain version "
                             f"by {err:.3e} (tolerance {tol}, exact={exact})")
    return err


def _time_pair(kernel_fn, plain_fn, budget_s: float = 0.6):
    """Median ms of kernel and plain version, timed in turns with CUDA
    events after one warm-up each; fewer repeats for the long calls."""
    import torch

    def once(fn):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e)

    first = once(kernel_fn) + once(plain_fn)
    repeats = max(1, min(10, int(budget_s * 1e3 / max(first, 1e-3))))
    ks, ps = [], []
    for _ in range(repeats):
        ks.append(once(kernel_fn))
        ps.append(once(plain_fn))
    return statistics.median(ks), statistics.median(ps)


def _rand(gen, shape, dtype, scale=1.0, shift=0.0):
    import torch

    t = torch.randn(shape, device=DEVICE, generator=gen)
    return t.mul_(scale).add_(shift).to(dtype)


def _record_header():
    log(f"{'kernel':13s} {'dtype':8s} {'case':44s} {'max err':>10s} "
        f"{'kernel ms':>11s} {'plain ms':>11s}")


def _record(out, kernel, case, dtype, err, k_ms, p_ms, model_shape):
    """Log one kernel-vs-plain case; keep the kernel's worst error and the
    fp32 model shapes' summed times."""
    import torch

    rec = out[kernel]
    rec["err"] = max(rec["err"], err)
    if model_shape and dtype == torch.float32:
        rec["ms"] += k_ms
        rec["plain_ms"] += p_ms
    log(f"{kernel:13s} {str(dtype)[6:]:8s} {case:44s} {err:10.3e} "
        f"{k_ms:11.3f} {p_ms:11.3f}")


def phase_kernels_3d(seed: int, shapes: set):
    """Each 3D kernel against its plain version at every shape the two
    models produced in phases 3-4, plus ragged cases, in fp32 and bf16."""
    import torch

    from mdeical_image_segmentation_tpu_torch.ops import fused_conv, norm, overlap

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    out = {k: {"err": 0.0, "ms": 0.0, "plain_ms": 0.0}
           for k in ("gcr_conv3d", "gn_stats", "gn_affine", "overlap_add")}

    def rand(shape, dtype=torch.float32, scale=1.0, shift=0.0):
        return _rand(gen, shape, dtype, scale, shift)

    def coeffs(n, c):
        a = torch.rand((n, c), device=DEVICE, generator=gen) + 0.5
        return a, 0.5 * torch.randn((n, c), device=DEVICE, generator=gen)

    def record(*args):
        _record(out, *args)

    gcr = sorted(s for s in shapes if s[0] == "gcr")
    stats = sorted(s for s in shapes if s[0] == "stats")
    affine = sorted(s for s in shapes if s[0] == "affine")
    overlaps = sorted(s for s in shapes if s[0] == "overlap")
    ragged_gcr = [((2, 5, 9, 11, 1), 32, 3, False), ((2, 4, 17, 13, 19), 70,
                  3, True), ((1, 3, 16, 16, 3), 64, 1, False),
                  ((1, 6, 12, 10, 40), 130, 1, True)]
    ragged_gn = [(2, 5, 9, 11, 3), (2, 6, 20, 17, 19), (1, 3, 7, 9, 300)]
    _record_header()
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        cases = [(s[1], s[2], 3, False, True) for s in gcr] + [
            (*r, False) for r in ragged_gcr]
        for shape, co, kd, pre, model_shape in cases:
            ci = shape[-1]
            x = rand(shape, dtype)
            k = rand((kd, 3, 3, ci, co), dtype, (9 * kd * ci) ** -0.5)
            a, b = coeffs(shape[0], ci)
            y = fused_conv.fused_conv3d(x, k, a, b, pre_relu=pre)
            ref = fused_conv.fused_conv3d_reference(x, k, a, b, pre_relu=pre)
            err = _compare(f"gcr_conv3d {shape}->{co}", y, ref,
                           BF16_TOL if bf16 else FP32_TOL)
            del y, ref
            k_ms, p_ms = _time_pair(
                lambda: fused_conv.fused_conv3d(x, k, a, b, pre_relu=pre),
                lambda: fused_conv.fused_conv3d_reference(x, k, a, b,
                                                          pre_relu=pre))
            record("gcr_conv3d", f"{shape}->{co} kd{kd} pre{int(pre)}", dtype,
                   err, k_ms, p_ms, model_shape)
            del x, k
            torch.cuda.empty_cache()
        cases = [(s[1], True) for s in stats] + [(r, False) for r in ragged_gn]
        for shape, model_shape in cases:
            x = rand(shape, dtype, 2.0, 1.0)
            count = x.numel() // (shape[0] * shape[-1])
            got = norm.group_stats(*norm.gn_channel_sums(x), shape[-1],
                                   count, 1e-5)
            want = norm.group_stats(*norm.gn_channel_sums_reference(x),
                                    shape[-1], count, 1e-5)
            err = max(_compare(f"gn_stats {shape} {what}", g, w, GN_TOL)
                      for what, g, w in zip(("mean", "inv"), got, want))
            k_ms, p_ms = _time_pair(
                lambda: norm.gn_channel_sums(x),
                lambda: norm.gn_channel_sums_reference(x))
            record("gn_stats", str(shape), dtype, err, k_ms, p_ms,
                   model_shape)
            del x
            torch.cuda.empty_cache()
        cases = [(s[1], True) for s in affine] + [(r, False) for r in ragged_gn]
        for shape, model_shape in cases:
            x = rand(shape, dtype)
            a, b = coeffs(shape[0], shape[-1])
            err = _compare(f"gn_affine {shape}", norm.gn_affine(x, a, b),
                           norm.gn_affine_reference(x, a, b),
                           BF16_TOL if bf16 else AFFINE_FP32_TOL)
            k_ms, p_ms = _time_pair(lambda: norm.gn_affine(x, a, b),
                                    lambda: norm.gn_affine_reference(x, a, b))
            record("gn_affine", str(shape), dtype, err, k_ms, p_ms,
                   model_shape)
            del x
            torch.cuda.empty_cache()
        # the predictors' batches (patch = stride: no overlap; the second
        # batch a padded tail) and ragged overlapping windows
        cases = [s[1:] + (True,) for s in overlaps] + [
            ((5, 4, 8, 9, 2), (8, 14, 16),
             [[0, 0, 0], [2, 3, 1], [1, 5, 6], [4, 6, 7], [4, 6, 7]],
             [1, 1, 1, 1, 0], False),
            ((6, 7, 9, 5, 3), (9, 11, 13),
             [[0, 0, 0], [1, 1, 1], [2, 2, 8], [2, 0, 4], [0, 2, 3], [0, 2, 3]],
             [1, 1, 1, 1, 1, 0], False),
        ]
        for pshape, vol, starts, valid, model_shape in cases:
            p = rand(pshape, dtype)
            acc0 = rand((*vol, pshape[-1]))
            cnt0 = torch.randint(0, 3, (*vol, pshape[-1]), device=DEVICE,
                                 generator=gen).float()
            acc, cnt = acc0.clone(), cnt0.clone()
            p_acc, p_cnt = acc0.clone(), cnt0.clone()
            overlap.overlap_add_into(acc, cnt, p, starts, valid)
            overlap.overlap_add_into_reference(p_acc, p_cnt, p, starts, valid)
            err = max(_compare(f"overlap_add {pshape} acc", acc, p_acc, 0.0,
                               exact=True),
                      _compare(f"overlap_add {pshape} cnt", cnt, p_cnt, 0.0,
                               exact=True))
            k_ms, p_ms = _time_pair(
                lambda: overlap.overlap_add_into(acc, cnt, p, starts, valid),
                lambda: overlap.overlap_add_into_reference(p_acc, p_cnt, p,
                                                           starts, valid))
            record("overlap_add", f"{pshape} into {vol}", dtype, err, k_ms,
                   p_ms, model_shape)
            del p, acc0, cnt0, acc, cnt, p_acc, p_cnt
            torch.cuda.empty_cache()
    log(f"[phase 6] ok: {len(gcr)} gcr_conv3d, {len(stats)} gn_stats, "
        f"{len(affine)} gn_affine and {len(overlaps)} overlap_add model cases "
        "plus ragged cases match in fp32 and bf16 (overlap_add bit-exact)")
    return out


# ---------------------------------------------------------------------------
# 3D 'gcr' training (UNetTrainer; GroupNorm backward kernels, autograd)
# ---------------------------------------------------------------------------

TRAIN_YML = os.path.join(ROOT, "configs", "unet3d_train.yml")
TRAIN_VOLUME = (80, 260, 260)   # 1 x 2 x 2 train patches at stride 40x90x90
VAL_VOLUME = (80, 170, 340)     # 2 val patches at stride = patch
RESIDUAL_TRAIN = dict(RESIDUAL_MODEL)
RESIDUAL_PATCH = (64, 128, 128)  # bench.py's residual_unet3d row
GN_BWD_SUM_TOL = 1e-5   # Σg and Σg·x̂ over S positions: |err| <= tol · S
GRAD_TOL = 1e-3         # autograd grads vs the plain composition, relative
                        # to each gradient's max |value|
# trainer losses of steps 1, 2, 3, kernel path vs plain path, relative.
# Step 1 runs the same weights.  Adam's first updates are ±lr for every
# weight whose gradient exceeds eps, so the weights whose gradient is
# rounding noise on both paths (a GroupNorm scale whose output the next
# GroupNorm renormalizes, a conv weight of a deep level where a ReLU at its
# kink decides) move by ±lr at random; that difference grows about tenfold
# per step (measured on the H100: 0, 1.7e-5, 2.3e-4; the kernel path alone
# differs by 2.3e-5 at step 3 between two runs, as cuDNN's weight gradient
# is not deterministic).
LOSS_TOLS = (1e-5, 1e-4, 1e-3)
GRAD_NORM_TOL = 1e-4    # global grad norm after step 1 (same weights)
KINK = 1e-4             # cotangent zeroed where y is within KINK·max|y| of 0


def _training_shapes(seed: int):
    """The input shapes of every fused 'gcr' SingleConv and GroupNorm module
    of the two training models (one no-grad forward each at the training
    patch): {"gcr": [(shape, Co, model)], "gn": [(shape, model)]}."""
    import torch

    from mdeical_image_segmentation_tpu_torch.models import get_model

    cfg = _read_yaml_subset(TRAIN_YML)
    patch = tuple(cfg["loaders"]["train"]["slice_builder"]["patch_shape"])
    found = {"gcr": set(), "gn": set()}
    for name, model_cfg, shape in (("UNet3D", cfg["model"], patch),
                                   ("ResidualUNet3D", RESIDUAL_TRAIN,
                                    RESIDUAL_PATCH)):
        model = get_model(model_cfg, device=DEVICE,
                          generator=None).eval()
        for p in model.parameters():
            torch.nn.init.normal_(p, std=0.02)
        shapes: set = set()
        handles = _record_shapes(model, shapes)
        with torch.no_grad():
            model(torch.zeros((1, *shape, model_cfg["in_channels"]),
                              device=DEVICE))
        for h in handles:
            h.remove()
        for s in shapes:
            if s[0] == "gcr":
                found["gcr"].add((s[1], s[2], name))
            elif s[0] == "stats":
                found["gn"].add((s[1], name))
        del model
        torch.cuda.empty_cache()
    return {k: sorted(v) for k, v in found.items()}


def phase_gn_backward_kernels(seed: int, shapes):
    """Kernels 3c and 3d against their plain versions at every GroupNorm
    input shape of the two training models, plus ragged C and C = 1, in
    fp32 and bf16; returns {kernel: {err, ms, plain_ms}}."""
    import torch

    from mdeical_image_segmentation_tpu_torch.ops import norm

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    out = {k: {"err": 0.0, "ms": 0.0, "plain_ms": 0.0}
           for k in ("gn_bwd_reduce", "gn_bwd_dx")}

    ragged = [(2, 5, 9, 11, 3), (2, 6, 20, 17, 19), (1, 3, 7, 9, 300),
              (1, 7, 13, 11, 1)]
    cases = [(s, True, m) for s, m in shapes["gn"]] + [
        (r, False, "ragged") for r in ragged]
    _record_header()
    for dtype in (torch.float32, torch.bfloat16):
        for shape, model_shape, model in cases:
            n, c = shape[0], shape[-1]
            count = 1
            for d in shape[1:-1]:
                count *= d
            x = _rand(gen, shape, dtype, 2.0, 1.0)
            g = _rand(gen, shape, dtype)
            mean = 0.3 * torch.randn((n, c), device=DEVICE, generator=gen) + 1
            inv = torch.rand((n, c), device=DEVICE, generator=gen) + 0.5
            got = norm.gn_bwd_reduce(x, g, mean, inv)
            want = norm.gn_bwd_reduce_reference(x, g, mean, inv)
            err = 0.0
            for what, a, b in zip(("sum g", "sum g*xhat"), got, want):
                e = (a - b).abs().max().item()
                if not torch.isfinite(a).all() or e > GN_BWD_SUM_TOL * count:
                    raise AssertionError(
                        f"gn_bwd_reduce {shape} {dtype} {what}: differs from "
                        f"the plain version by {e:.3e} (limit "
                        f"{GN_BWD_SUM_TOL} x {count} positions)")
                err = max(err, e)
            k_ms, p_ms = _time_pair(
                lambda: norm.gn_bwd_reduce(x, g, mean, inv),
                lambda: norm.gn_bwd_reduce_reference(x, g, mean, inv))
            _record(out, "gn_bwd_reduce", f"{shape} {model}", dtype, err,
                    k_ms, p_ms, model_shape)
            a, cc, dd = (torch.randn((n, c), device=DEVICE, generator=gen)
                         for _ in range(3))
            err = _compare(f"gn_bwd_dx {shape}", norm.gn_bwd_dx(x, g, a, cc, dd),
                           norm.gn_bwd_dx_reference(x, g, a, cc, dd),
                           BF16_TOL if dtype == torch.bfloat16
                           else AFFINE_FP32_TOL)
            k_ms, p_ms = _time_pair(
                lambda: norm.gn_bwd_dx(x, g, a, cc, dd),
                lambda: norm.gn_bwd_dx_reference(x, g, a, cc, dd))
            _record(out, "gn_bwd_dx", f"{shape} {model}", dtype, err, k_ms,
                    p_ms, model_shape)
            del x, g
            torch.cuda.empty_cache()
    log(f"[phase 7] ok: {len(shapes['gn'])} model shapes plus "
        f"{len(ragged)} ragged cases match in fp32 and bf16")
    return out


def _rel_errs(names, got, want):
    """max |got - want| / max |want| per gradient."""
    import torch

    errs = {}
    for name, a, b in zip(names, got, want):
        if not torch.isfinite(a).all():
            raise AssertionError(f"non-finite {name}")
        errs[name] = ((a.float() - b.float()).abs().max()
                      / b.float().abs().max().clamp_min(1e-30)).item()
    return errs


def phase_autograd(seed: int, shapes):
    """Gradients through the autograd Functions against autograd through
    the plain composition (affine, F.conv3d, ReLU; F.group_norm), fp32 with
    TF32 off, at the training models' shapes."""
    import torch
    import torch.nn.functional as F

    from mdeical_image_segmentation_tpu_torch.ops import fused_conv, norm

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    worst = 0.0

    def randn(shape, scale=1.0, shift=0.0):
        return torch.randn(shape, device=DEVICE, generator=gen) * scale + shift

    def plain_gn(x, s, b, groups):
        xc = x.permute(0, 4, 1, 2, 3)
        return F.group_norm(xc, groups, s, b, 1e-5).permute(0, 2, 3, 4, 1)

    log(f"{'block':8s} {'x shape':26s} {'Co':>4s} {'kd':>2s} "
        f"{'dx':>9s} {'dscale':>9s} {'dbias':>9s} {'dw':>9s} "
        f"{'kernel ms':>10s} {'plain ms':>9s}")
    cases = [(s, co, kd) for s, co, m in shapes["gcr"] if m == "UNet3D"
             for kd in (3, 1)]
    for shape, co, kd in cases:
        ci = shape[-1]
        groups = 1 if ci < 8 else 8
        x = randn(shape, 1.0, 0.3).requires_grad_()
        s = randn((ci,), 0.2, 1.0).requires_grad_()
        b = randn((ci,), 0.1).requires_grad_()
        k = randn((kd, 3, 3, ci, co), (9 * kd * ci) ** -0.5).requires_grad_()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = fused_conv.gcr_fused_conv(x, s, b, k, groups, 1e-5)
        torch.cuda.synchronize()
        k_ms = (time.perf_counter() - t0) * 1e3
        with torch.no_grad():
            y_plain = F.relu(F.conv3d(
                plain_gn(x, s, b, groups).permute(0, 4, 1, 2, 3),
                k.permute(4, 3, 0, 1, 2), padding=((kd - 1) // 2, 1, 1))
            ).permute(0, 2, 3, 4, 1)
            # the ReLU's choice at its kink is not a gradient: zero the
            # cotangent where either output lies within KINK·max|y| of 0
            lim = KINK * y_plain.abs().max()
            near = ((y > 0) & (y < lim)) | ((y_plain > 0) & (y_plain < lim))
            w = randn(y.shape).masked_fill_(near, 0.0)
            del y_plain
        t0 = time.perf_counter()
        got = torch.autograd.grad(y, (x, s, b, k), w)
        torch.cuda.synchronize()
        k_ms += (time.perf_counter() - t0) * 1e3
        del y
        t0 = time.perf_counter()
        y = F.relu(F.conv3d(plain_gn(x, s, b, groups).permute(0, 4, 1, 2, 3),
                            k.permute(4, 3, 0, 1, 2),
                            padding=((kd - 1) // 2, 1, 1))
                   ).permute(0, 2, 3, 4, 1)
        want = torch.autograd.grad(y, (x, s, b, k), w)
        torch.cuda.synchronize()
        p_ms = (time.perf_counter() - t0) * 1e3
        errs = _rel_errs(("dx", "dscale", "dbias", "dw"), got, want)
        log(f"{'gcr':8s} {str(shape):26s} {co:4d} {kd:2d} {errs['dx']:9.2e} "
            f"{errs['dscale']:9.2e} {errs['dbias']:9.2e} {errs['dw']:9.2e} "
            f"{k_ms:10.1f} {p_ms:9.1f}  near-kink share "
            f"{near.float().mean().item():.2e}")
        worst = max(worst, *errs.values())
        if max(errs.values()) > GRAD_TOL:
            raise AssertionError(f"gcr_fused_conv {shape}->{co} kd{kd}: "
                                 f"grads differ from the plain composition "
                                 f"{errs} (limit {GRAD_TOL} x max |grad|)")
        del x, s, b, k, y, w, got, want, near
        torch.cuda.empty_cache()
    gn_cases = [(sh, m) for sh, m in shapes["gn"]
                if m == "ResidualUNet3D"] + [((1, 7, 13, 11, 1), "ragged"),
                                             ((2, 6, 20, 17, 24), "ragged")]
    for shape, model in gn_cases:
        c = shape[-1]
        groups = 1 if c < 8 else 8
        mod = norm.GroupNorm(c, groups, device=DEVICE)
        with torch.no_grad():
            mod.weight.copy_(randn((c,), 0.2, 1.0))
            mod.bias.copy_(randn((c,), 0.1))
        x = randn(shape, 2.0, 1.0).requires_grad_()
        w = randn(shape)
        got = torch.autograd.grad(mod(x), (x, mod.weight, mod.bias), w)
        want = torch.autograd.grad(plain_gn(x, mod.weight, mod.bias, groups),
                                   (x, mod.weight, mod.bias), w)
        errs = _rel_errs(("dx", "dscale", "dbias"), got, want)
        log(f"{'GN':8s} {str(shape):26s} {'':4s} {'':2s} {errs['dx']:9.2e} "
            f"{errs['dscale']:9.2e} {errs['dbias']:9.2e}  ({model})")
        worst = max(worst, *errs.values())
        if max(errs.values()) > GRAD_TOL:
            raise AssertionError(f"GroupNorm {shape}: grads differ from "
                                 f"F.group_norm's {errs} (limit {GRAD_TOL})")
        del x, w, got, want
        torch.cuda.empty_cache()
    log(f"[phase 8] ok: {len(cases)} gcr_fused_conv and {len(gn_cases)} "
        f"GroupNorm cases; worst gradient error {worst:.3e} of max |grad| "
        f"(limit {GRAD_TOL}; TF32 off on both paths)")
    return worst


def _smooth_label(raw):
    """A binary label with blobs: a 9-wide moving average of the volume
    along each axis, thresholded at 0."""
    import numpy as np

    v = raw.astype(np.float64)
    for axis in range(3):
        c = np.cumsum(np.pad(v, [(5, 4) if a == axis else (0, 0)
                                 for a in range(3)], mode="edge"), axis=axis)
        n = v.shape[axis]
        v = (np.take(c, range(9, 9 + n), axis=axis)
             - np.take(c, range(0, n), axis=axis)) / 9.0
    return (v > 0).astype(np.float32)


class _PatchDataset:
    """(raw, label) patches of in-memory volumes, channels-last (D, H, W, 1)
    float32, as the JAX package's ToTensor(expand_dims) gives them."""

    def __init__(self, raw, label, patch, stride):
        from mdeical_image_segmentation_tpu_torch.data.slice_builder import (
            SliceBuilder,
        )

        sb = SliceBuilder(raw, label, None, patch, stride)
        self.raw, self.label = raw, label
        self.slices = list(zip(sb.raw_slices, sb.label_slices))

    def __len__(self):
        return len(self.slices)

    def __getitem__(self, i):
        rs, ls = self.slices[i]
        return self.raw[rs][..., None], self.label[ls][..., None]


def _instrument(trainer, rec):
    """Wrap the trainer's step: synchronised ms, launch counts, the loss
    and (on the first step) the global grad norm."""
    import torch

    orig = trainer._train_step

    def step(input, target, weight):
        torch.cuda.synchronize()
        before, t0 = _counts(), time.perf_counter()
        loss, output = orig(input, target, weight)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        after = _counts()
        norm2 = grads = None
        if not rec:
            named = [(n, p) for n, p in trainer.model.named_parameters()
                     if p.grad is not None]
            norm2 = torch.sqrt(sum(p.grad.double().square().sum()
                                   for _, p in named)).item()
            grads = {n: p.grad.detach().cpu() for n, p in named}
        rec.append({"ms": ms, "loss": loss.item(), "grad_norm": norm2,
                    "grads": grads,
                    "launches": {k: after[k] - before[k] for k in after}})
        return loss, output

    trainer._train_step = step


def _make_trainer(model_cfg, cfg, loaders, checkpoint_dir, pre_trained,
                  **trainer_kw):
    from mdeical_image_segmentation_tpu_torch.logging_utils import (
        get_tensorboard_formatter,
    )
    from mdeical_image_segmentation_tpu_torch.losses import (
        get_loss_criterion,
    )
    from mdeical_image_segmentation_tpu_torch.metrics import (
        get_evaluation_metric,
    )
    from mdeical_image_segmentation_tpu_torch.models import get_model
    from mdeical_image_segmentation_tpu_torch.train.optimizers import (
        create_lr_scheduler,
        create_optimizer,
    )
    from mdeical_image_segmentation_tpu_torch.train.trainer3d import (
        UNetTrainer,
    )

    model = get_model(model_cfg, device=DEVICE)
    optimizer = create_optimizer(cfg["optimizer"], model.parameters())
    lr = cfg["optimizer"]["learning_rate"]
    return UNetTrainer(
        model=model, optimizer=optimizer,
        lr_scheduler=create_lr_scheduler(cfg["lr_scheduler"], lr),
        loss_criterion=get_loss_criterion(cfg),
        eval_criterion=get_evaluation_metric(cfg), loaders=loaders,
        checkpoint_dir=checkpoint_dir, base_lr=lr, seed=SEED,
        tensorboard_formatter=get_tensorboard_formatter(None),
        pre_trained=pre_trained, max_num_epochs=100,
        **{**{k: v for k, v in cfg["trainer"].items()
              if k == "eval_score_higher_is_better"}, **trainer_kw})


def _initial_checkpoint(model_cfg, seed, workdir, name):
    """Random weights from a seeded generator, written with the port's
    save_checkpoint: the trainers' ``pre_trained``."""
    import torch

    from mdeical_image_segmentation_tpu_torch.models import get_model
    from mdeical_image_segmentation_tpu_torch.train import save_checkpoint
    from mdeical_image_segmentation_tpu_torch.utils.param_bridge import (
        state_dict_to_flax,
    )

    model = get_model(model_cfg, generator=torch.Generator().manual_seed(seed))
    return save_checkpoint(
        {"model_state_dict": state_dict_to_flax(model.state_dict()),
         "best_eval_score": 0.0, "num_iterations": 0},
        False, os.path.join(workdir, name))


def _compare_runs(name, rec, plain_rec, steps):
    """Losses of the first ``steps`` steps, the global grad norm after step
    1 and each parameter's step-1 gradient, kernel path vs plain path."""
    bad = []
    for i in range(steps):
        k, p = rec[i]["loss"], plain_rec[i]["loss"]
        rel = abs(k - p) / abs(p)
        log(f"  step {i + 1}: loss kernel {k:.7f} plain {p:.7f} (rel "
            f"{rel:.2e}, limit {LOSS_TOLS[i]}); ms kernel "
            f"{rec[i]['ms']:.1f} plain {plain_rec[i]['ms']:.1f}")
        if rel > LOSS_TOLS[i]:
            bad.append(f"step {i + 1} loss {rel:.2e}")
    gk, gp = rec[0]["grad_norm"], plain_rec[0]["grad_norm"]
    norm_err = abs(gk - gp) / gp
    log(f"  global grad norm after step 1: kernel {gk:.7e} plain {gp:.7e} "
        f"(rel {norm_err:.2e}, limit {GRAD_NORM_TOL})")
    per_param = sorted(
        ((float((g - plain_rec[0]["grads"][n]).abs().max()
                / plain_rec[0]["grads"][n].abs().max().clamp_min(1e-30)), n)
         for n, g in rec[0]["grads"].items()), reverse=True)
    log(f"  step-1 gradients, max |kernel - plain| / max |plain| per "
        f"parameter, worst 4 of {len(per_param)}: "
        + ", ".join(f"{n} {e:.2e}" for e, n in per_param[:4]))
    if norm_err > GRAD_NORM_TOL:
        bad.append(f"grad norm {norm_err:.2e}")
    if bad:
        raise AssertionError(f"{name}, kernel path vs plain path: "
                             f"{'; '.join(bad)} beyond the limits")


def phase_train_unet3d(seed: int, workdir: str):
    """UNet3D of configs/unet3d_train.yml at full width through
    UNetTrainer.fit(); returns the main-path launches."""
    import numpy as np
    import torch

    from mdeical_image_segmentation_tpu_torch.data.loaders import VolumeLoader

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _read_yaml_subset(TRAIN_YML)
    model_cfg = cfg["model"]
    train_sb = cfg["loaders"]["train"]["slice_builder"]
    val_sb = cfg["loaders"]["val"]["slice_builder"]
    log(f"[phase 9] model {model_cfg}; loss {cfg['loss']}; eval_metric "
        f"{cfg['eval_metric']}; optimizer {cfg['optimizer']}; lr_scheduler "
        f"{cfg['lr_scheduler']}; batch {cfg['loaders']['batch_size']}; "
        f"patch {train_sb['patch_shape']}, train stride "
        f"{train_sb['stride_shape']}; fp32, TF32 off")
    raw = _volume(TRAIN_VOLUME, seed + 2)
    val_raw = _volume(VAL_VOLUME, seed + 3)
    train_ds = _PatchDataset(raw, _smooth_label(raw),
                             train_sb["patch_shape"], train_sb["stride_shape"])
    val_ds = _PatchDataset(val_raw, _smooth_label(val_raw),
                           val_sb["patch_shape"], val_sb["stride_shape"])
    log(f"  {len(train_ds)} train patches of a {TRAIN_VOLUME} volume, "
        f"{len(val_ds)} val patches of {VAL_VOLUME}; label share "
        f"{train_ds.label.mean():.3f}")
    bs = cfg["loaders"]["batch_size"]

    def loaders():
        return {"train": VolumeLoader(train_ds, bs, shuffle=True, seed=seed,
                                      drop_last=True),
                "val": VolumeLoader(val_ds, bs)}

    ckpt0 = _initial_checkpoint(model_cfg, seed, workdir, "unet3d_init")
    run_dir = os.path.join(workdir, "unet3d_train")
    trainer = _make_trainer(model_cfg, cfg, loaders(), run_dir, ckpt0,
                            max_num_iterations=6, validate_after_iters=3,
                            log_after_iters=2)
    rec = []
    _instrument(trainer, rec)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    trainer.fit()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    # two SingleConvs per encoder and decoder, 14 at 4 levels; the first
    # one's input (the image) needs no gradient, so 3d runs one time less
    convs = 2 * (2 * model_cfg["num_levels"] - 1)
    want = {"gcr_conv3d": convs, "gn_stats": convs, "gn_affine": convs,
            "gn_bwd_reduce": convs, "gn_bwd_dx": convs - 1, "overlap_add": 0}
    for i, r in enumerate(rec):
        log(f"  step {i + 1}: {r['ms']:.1f} ms, loss {r['loss']:.6f}, "
            f"launches {r['launches']}")
        if r["launches"] != want or not np.isfinite(r["loss"]):
            raise AssertionError(f"step {i + 1}: {r}, want launches {want} "
                                 "and a finite loss")
    last = os.path.join(run_dir, "last_checkpoint.msgpack")
    best = os.path.join(run_dir, "best_checkpoint.msgpack")
    if not (os.path.exists(last) and os.path.exists(best)):
        raise AssertionError("the last and best checkpoints were not written")
    if trainer.num_iterations != 7 or len(rec) != 7:
        raise AssertionError(f"{len(rec)} steps, iteration "
                             f"{trainer.num_iterations}: want 7 and 7")
    steady = statistics.median(r["ms"] for r in rec[1:])
    log(f"  fit: {len(rec)} steps + 2 validations in {wall:.2f} s; step "
        f"median {steady:.1f} ms (first {rec[0]['ms']:.1f}); peak memory "
        f"{peak:.2f} GiB; best score {trainer.best_eval_score:.4f}; "
        f"launches {launches}")

    # the same first three steps from the same weights on the plain path
    with _plain_path():
        plain = _make_trainer(model_cfg, cfg, loaders(),
                              os.path.join(workdir, "unet3d_plain"), ckpt0,
                              max_num_iterations=2, validate_after_iters=1000,
                              log_after_iters=1000)
        plain_rec = []
        _instrument(plain, plain_rec)
        torch.cuda.reset_peak_memory_stats()
        plain.fit()
        plain_peak = torch.cuda.max_memory_allocated() / 2**30
    del plain
    torch.cuda.empty_cache()
    _compare_runs("UNet3D", rec, plain_rec, 3)
    plain_steady = statistics.median(r["ms"] for r in plain_rec[1:])
    log(f"  plain path: step median {plain_steady:.1f} ms, peak memory "
        f"{plain_peak:.2f} GiB")

    # resume from the last checkpoint (saved at iteration 6) for one step
    resumed = _make_trainer(model_cfg, cfg, loaders(), run_dir, None,
                            resume=last, max_num_iterations=5,
                            validate_after_iters=1000, log_after_iters=1000)
    if resumed.num_iterations != 6:
        raise AssertionError(f"resumed at iteration {resumed.num_iterations}"
                             ", want 6")
    res_rec = []
    _instrument(resumed, res_rec)
    resumed.fit()
    p0 = next(resumed.model.parameters())
    adam_step = int(resumed.optimizer.state[p0]["step"])
    log(f"  resume: iteration 6 -> {resumed.num_iterations}, one step, loss "
        f"{res_rec[0]['loss']:.6f}, Adam step {adam_step}")
    if (len(res_rec) != 1 or adam_step != 7
            or not np.isfinite(res_rec[0]["loss"])):
        raise AssertionError(f"resume took {len(res_rec)} steps, Adam step "
                             f"{adam_step}: want 1 step and Adam step 7")
    del trainer, resumed
    torch.cuda.empty_cache()
    return launches, steady, plain_steady, peak


def phase_train_residual(seed: int, workdir: str):
    """ResidualUNet3D f_maps 32, 5 levels at 64x128x128 for two steps, with
    its loss and grad norm against the plain path: the GroupNorm module's
    Function (3a/3b forward, 3c/3d backward) beside the fused one."""
    import numpy as np
    import torch

    from mdeical_image_segmentation_tpu_torch.data.loaders import VolumeLoader

    cfg = _read_yaml_subset(TRAIN_YML)
    raw = _volume((64, 128, 256), seed + 4)
    ds = _PatchDataset(raw, _smooth_label(raw), RESIDUAL_PATCH,
                       RESIDUAL_PATCH)

    def loaders():
        return {"train": VolumeLoader(ds, 1, shuffle=True, seed=seed,
                                      drop_last=True),
                "val": VolumeLoader(ds, 1)}

    ckpt0 = _initial_checkpoint(RESIDUAL_TRAIN, seed + 1, workdir,
                                "residual_init")
    kw = dict(max_num_iterations=1, validate_after_iters=1000,
              log_after_iters=1000)
    trainer = _make_trainer(RESIDUAL_TRAIN, cfg, loaders(),
                            os.path.join(workdir, "residual"), ckpt0, **kw)
    rec = []
    _instrument(trainer, rec)
    _zero_counts()
    trainer.fit()
    launches = _counts()
    blocks = 2 * RESIDUAL_TRAIN["num_levels"] - 1
    want = {"gcr_conv3d": blocks, "gn_stats": 2 * blocks,
            "gn_affine": 2 * blocks, "gn_bwd_reduce": 2 * blocks,
            "gn_bwd_dx": 2 * blocks, "overlap_add": 0}
    for i, r in enumerate(rec):
        log(f"  step {i + 1}: {r['ms']:.1f} ms, loss {r['loss']:.6f}, "
            f"launches {r['launches']}")
        if r["launches"] != want or not np.isfinite(r["loss"]):
            raise AssertionError(f"step {i + 1}: {r}, want {want}")
    with _plain_path():
        plain = _make_trainer(RESIDUAL_TRAIN, cfg, loaders(),
                              os.path.join(workdir, "residual_plain"), ckpt0,
                              **kw)
        plain_rec = []
        _instrument(plain, plain_rec)
        plain.fit()
    _compare_runs("ResidualUNet3D", rec, plain_rec, 2)
    del trainer, plain
    torch.cuda.empty_cache()
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    port = _import_port()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"port {port.__name__} from {ROOT}; torch {torch.__version__} "
        f"(CUDA {torch.version.cuda}); {torch.cuda.get_device_name(0)}")

    t_phase = time.time()
    max_err, ms, plain_ms = phase_kernels(SEED)
    log(f"[phase 1] wall {time.time() - t_phase:.1f} s")
    build_dir = os.path.join(ROOT, "build")
    os.makedirs(build_dir, exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_", dir=build_dir)
    shapes: set = set()
    try:
        t_phase = time.time()
        launches = phase_serve(SEED, workdir)
        log(f"[phase 2] wall {time.time() - t_phase:.1f} s")
        t_phase = time.time()
        model_cfg, ckpt, unet3d_launches, unet3d_err = phase_unet3d_predictor(
            SEED, workdir, shapes)
        log(f"[phase 3] UNet3D predictor ok; wall {time.time() - t_phase:.1f} s")
        t_phase = time.time()
        log("[phase 4] ResidualUNet3D f_maps 32, 5 levels, patch 48x96x96 + "
            "halo 8/16/16 on a 48x192x288 volume")
        res_launches, res_err = phase_residual_predictor(SEED, shapes)
        log(f"[phase 4] ResidualUNet3D predictor ok; wall "
            f"{time.time() - t_phase:.1f} s")
        t_phase = time.time()
        serve3d_launches = phase_serve3d(SEED, workdir, model_cfg, ckpt)
        log(f"[phase 5] wall {time.time() - t_phase:.1f} s")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    t_phase = time.time()
    k3d = phase_kernels_3d(SEED, shapes)
    log(f"[phase 6] wall {time.time() - t_phase:.1f} s")

    t_phase = time.time()
    train_shapes = _training_shapes(SEED)
    log(f"[phase 7] GroupNorm backward kernels at the training shapes: "
        f"{len(train_shapes['gn'])} GroupNorm inputs of UNet3D (80x170x170) "
        f"and ResidualUNet3D (64x128x128)")
    k3d.update(phase_gn_backward_kernels(SEED, train_shapes))
    log(f"[phase 7] wall {time.time() - t_phase:.1f} s")
    t_phase = time.time()
    log("[phase 8] gradients through gcr_fused_conv and GroupNorm vs "
        "autograd through the plain composition (TF32 off)")
    grad_err = phase_autograd(SEED, train_shapes)
    log(f"[phase 8] wall {time.time() - t_phase:.1f} s")
    workdir = tempfile.mkdtemp(prefix="chip_smoke_train_", dir=build_dir)
    try:
        t_phase = time.time()
        train_launches, step_ms, plain_step_ms, peak = phase_train_unet3d(
            SEED, workdir)
        log(f"[phase 9] UNet3D training ok; wall {time.time() - t_phase:.1f}"
            " s")
        t_phase = time.time()
        log("[phase 10] ResidualUNet3D f_maps 32, 5 levels, 64x128x128, two "
            "steps")
        res_train_launches = phase_train_residual(SEED, workdir)
        log(f"[phase 10] ResidualUNet3D training ok; wall "
            f"{time.time() - t_phase:.1f} s")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    # launches of each kernel over the main-path runs it belongs to (each
    # run zeroes the counts just before and reads them just after)
    runs = (unet3d_launches, res_launches, serve3d_launches, train_launches,
            res_train_launches)
    launches_3d = {k: sum(r[k] for r in runs) for k in KERNELS_3D}
    for k, n in launches_3d.items():
        if n == 0:
            raise AssertionError(f"{k} was never launched on the main path")
    log(f"3D main-path launches: UNet3D predictor {unet3d_launches}, "
        f"ResidualUNet3D predictor {res_launches}, 3D serving "
        f"{serve3d_launches}, UNet3D training {train_launches}, "
        f"ResidualUNet3D training {res_train_launches}; averaged-map errors "
        f"{unet3d_err:.3e} (UNet3D), {res_err:.3e} (ResidualUNet3D); worst "
        f"autograd gradient error {grad_err:.3e}; UNet3D train step "
        f"{step_ms:.1f} ms kernel path, {plain_step_ms:.1f} ms plain path, "
        f"peak {peak:.2f} GiB")

    sources = {"gcr_conv3d": "gcr_conv3d.cu", "gn_stats": "group_norm.cu",
               "gn_affine": "group_norm.cu", "gn_bwd_reduce": "group_norm.cu",
               "gn_bwd_dx": "group_norm.cu", "overlap_add": "overlap_add.cu"}
    replaces = {"gcr_conv3d": "ops/fused_conv.py:244",
                "gn_stats": "ops/norm.py:360", "gn_affine": "ops/norm.py:375",
                "gn_bwd_reduce": "ops/norm.py:382",
                "gn_bwd_dx": "ops/norm.py:399",
                "overlap_add": "ops/overlap.py:100"}
    kernels = [{
        "name": "double_conv2d",
        "route": "cuda",
        "source": "mdeical_image_segmentation_tpu_torch/csrc/double_conv2d.cu",
        "replaces": "mdeical_image_segmentation_tpu/ops/fused_conv.py:420",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }] + [{
        "name": k,
        "route": "cuda",
        "source": f"mdeical_image_segmentation_tpu_torch/csrc/{sources[k]}",
        "replaces": f"mdeical_image_segmentation_tpu/{replaces[k]}",
        "launches": launches_3d[k],
        "max_abs_err": k3d[k]["err"],
        "ms": k3d[k]["ms"],
        "plain_ms": k3d[k]["plain_ms"],
    } for k in KERNELS_3D]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""GPU smoke run of the PyTorch port: 2D serving and 3D sliding-window
inference.

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
7. Prints the card's name and power limit, the kernels' JSON line (launches
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
KERNELS_3D = ("gcr_conv3d", "gn_stats", "gn_affine", "overlap_add")


def _read_yaml_subset(path: str) -> dict:
    """Read the block mappings, scalars and inline lists of a config file
    such as configs/unet3d_predict.yml (the card's machine has no PyYAML);
    list items ('- ...') are skipped."""
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
            parent[key] = [int(v) for v in value[1:-1].split(",") if v.strip()]
        elif value in ("true", "false"):
            parent[key] = value == "true"
        else:
            try:
                parent[key] = int(value)
            except ValueError:
                parent[key] = value
    return root


def _counts():
    from mdeical_image_segmentation_tpu_torch.ops import fused_conv, norm, overlap

    # inside _plain_path the plain versions stand in: they launch nothing
    fns = {"gcr_conv3d": fused_conv.fused_conv3d,
           "gn_stats": norm.gn_channel_sums, "gn_affine": norm.gn_affine,
           "overlap_add": overlap.overlap_add_into}
    return {k: getattr(fn, "launches", 0) for k, fn in fns.items()}


def _zero_counts():
    from mdeical_image_segmentation_tpu_torch.ops import fused_conv, norm, overlap

    for fn in (fused_conv.fused_conv3d, norm.gn_channel_sums, norm.gn_affine,
               overlap.overlap_add_into):
        fn.launches = 0


class _plain_path:
    """Within this block the model, the predictor and the server run every
    kernel's plain PyTorch version on the card (cuDNN conv3d, plain GN,
    plain overlap-add): the comparison pipeline.  Nothing of the port
    switches by itself; only this script swaps the functions."""

    def __enter__(self):
        from mdeical_image_segmentation_tpu_torch.infer import predictor
        from mdeical_image_segmentation_tpu_torch.ops import fused_conv, norm, overlap

        self.saved = [
            (norm, "gn_channel_sums", norm.gn_channel_sums_reference),
            (norm, "gn_affine", norm.gn_affine_reference),
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


def phase_kernels_3d(seed: int, shapes: set):
    """Each 3D kernel against its plain version at every shape the two
    models produced in phases 3-4, plus ragged cases, in fp32 and bf16."""
    import torch

    from mdeical_image_segmentation_tpu_torch.ops import fused_conv, norm, overlap

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    out = {k: {"err": 0.0, "ms": 0.0, "plain_ms": 0.0} for k in KERNELS_3D}

    def rand(shape, dtype=torch.float32, scale=1.0, shift=0.0):
        t = torch.randn(shape, device=DEVICE, generator=gen)
        return t.mul_(scale).add_(shift).to(dtype)

    def coeffs(n, c):
        a = torch.rand((n, c), device=DEVICE, generator=gen) + 0.5
        return a, 0.5 * torch.randn((n, c), device=DEVICE, generator=gen)

    def record(kernel, case, dtype, err, k_ms, p_ms, model_shape):
        rec = out[kernel]
        rec["err"] = max(rec["err"], err)
        if model_shape and dtype == torch.float32:
            rec["ms"] += k_ms
            rec["plain_ms"] += p_ms
        log(f"{kernel:11s} {str(dtype)[6:]:8s} {case:44s} {err:10.3e} "
            f"{k_ms:11.3f} {p_ms:11.3f}")

    gcr = sorted(s for s in shapes if s[0] == "gcr")
    stats = sorted(s for s in shapes if s[0] == "stats")
    affine = sorted(s for s in shapes if s[0] == "affine")
    overlaps = sorted(s for s in shapes if s[0] == "overlap")
    ragged_gcr = [((2, 5, 9, 11, 1), 32, 3, False), ((2, 4, 17, 13, 19), 70,
                  3, True), ((1, 3, 16, 16, 3), 64, 1, False),
                  ((1, 6, 12, 10, 40), 130, 1, True)]
    ragged_gn = [(2, 5, 9, 11, 3), (2, 6, 20, 17, 19), (1, 3, 7, 9, 300)]
    log(f"{'kernel':11s} {'dtype':8s} {'case':44s} {'max err':>10s} "
        f"{'kernel ms':>11s} {'plain ms':>11s}")
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
    # launches of each kernel over the main-path runs it belongs to (each
    # run zeroes the counts just before and reads them just after)
    launches_3d = {k: unet3d_launches[k] + res_launches[k]
                   + serve3d_launches[k] for k in KERNELS_3D}
    for k, n in launches_3d.items():
        if n == 0:
            raise AssertionError(f"{k} was never launched on the main path")
    log(f"3D main-path launches: UNet3D predictor {unet3d_launches}, "
        f"ResidualUNet3D predictor {res_launches}, 3D serving "
        f"{serve3d_launches}; averaged-map errors {unet3d_err:.3e} (UNet3D), "
        f"{res_err:.3e} (ResidualUNet3D)")

    sources = {"gcr_conv3d": "gcr_conv3d.cu", "gn_stats": "group_norm.cu",
               "gn_affine": "group_norm.cu", "overlap_add": "overlap_add.cu"}
    replaces = {"gcr_conv3d": "ops/fused_conv.py:244",
                "gn_stats": "ops/norm.py:360", "gn_affine": "ops/norm.py:375",
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

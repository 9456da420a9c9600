"""GPU smoke run of the PyTorch port's serving path.

    python3 chip_smoke.py

Needs one CUDA card, nvcc and the checkout this file sits in; imports nothing
of JAX.  It exits non-zero, without printing a result, when any of those is
missing or any phase fails.

1. Kernels against their plain versions: builds ``csrc/double_conv2d.cu``
   for sm_90a from this checkout, runs ``fused_double2d`` on the 9 DoubleConv
   shapes of the base-64 UNet at 256² (N=2) plus ragged shapes, in float32
   (plain version with TF32 off, rtol = atol = 1e-4) and bfloat16
   (rtol = atol = 2e-2, about two bf16 ulps), comparing y and z, and times
   kernel and cuDNN pair with CUDA events (median of 20 after warm-up).
2. The slice through its entry points: a base-64 bf16 UNet from a seeded
   generator is saved with ``save_pretrained``, loaded by
   ``ModelRegistry.register_unet2d(resolution=256, device="cuda")`` and
   served by ``SegmentationServer`` on 127.0.0.1; 8 concurrent clients POST
   16 synthetic PNGs in the png, mask and path return modes.  Every reply must
   be 200 with a 256x256 mask, the kernel must have launched 9 times per
   device batch, and 4 served masks must agree on >= 99.9% of pixels with the
   same model run with the plain DoubleConv (probabilities within 2e-2).
   Last, one batch of 8 is timed through the served forward and through the
   plain path (median of 5).
3. Prints the card's name and power limit, the kernels' JSON line, and last
   ``{"ok": true, "device": {...}}``.
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

    max_err, ms, plain_ms = phase_kernels(SEED)
    build_dir = os.path.join(ROOT, "build")
    os.makedirs(build_dir, exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_", dir=build_dir)
    try:
        launches = phase_serve(SEED, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    print(smi)
    print(json.dumps({"kernels": [{
        "name": "double_conv2d",
        "route": "cuda",
        "source": "mdeical_image_segmentation_tpu_torch/csrc/double_conv2d.cu",
        "replaces": "mdeical_image_segmentation_tpu/ops/fused_conv.py:420",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

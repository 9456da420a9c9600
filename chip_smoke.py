"""GPU smoke run of the PyTorch port: 2D serving, 3D sliding-window
inference, 3D 'gcr' training and 2D classic-UNet training.

    python3 chip_smoke.py

Needs one CUDA card, nvcc and the checkout this file sits in; imports nothing
of JAX (nor PyYAML or h5py).  It exits non-zero, without printing a result,
when any of those is missing or any phase fails.  Every phase prints its
wall time.

1. DoubleConv kernel against its plain version: builds all of ``csrc/`` for
   sm_90a from this checkout (one nvcc per source, in parallel; the ptxas
   register, shared-memory and spill lines of every kernel are printed),
   runs ``fused_double2d`` on the 9 DoubleConv shapes of the base-64 UNet
   at 256² (N=2) plus ragged shapes, in float32 (plain version with TF32
   off, rtol = atol = 1e-4) and bfloat16 (rtol = atol = 2e-2, about two
   bf16 ulps), comparing y and z, and times kernel and cuDNN pair with CUDA
   events (median of 20 after warm-up); then the 9 shapes in bf16 at the
   other device batches the server forms (N = 1, 4, 8; the launcher's tile
   depends on N), y and z against the plain version at each, and timed at
   N=8, the served batch.  Each line gives the kernel's TFLOP/s and its
   share of the tensor-core peak (bf16 989, fp32 against TF32 495 with the
   67 TFLOP/s fp32 rate beside).
2. 2D serving: a base-64 bf16 UNet from a seeded generator is saved with
   ``save_pretrained``, loaded by ``ModelRegistry.register_unet2d(
   resolution=256, device="cuda")`` and served by ``SegmentationServer`` on
   127.0.0.1; 8 concurrent clients POST 16 synthetic PNGs (filter 0) and 8
   copies of 4 of them with every row under the Average or the Paeth
   filter (written here with zlib; decoded by the port's C unfilter), in
   the png, mask and path return modes.  Every reply must be 200 with a
   256x256 mask, each filtered copy must decode to its original's pixels
   and get its mask, the kernel must have launched 18 times per device
   batch (twice per DoubleConv: conv1, conv2), and 4 served masks must
   agree on >= 99.9% of pixels with the same model run with the plain
   DoubleConv (probabilities within 2e-2, one image at a time).  Last, one batch
   of 8 goes through the served forward against the plain path
   (probabilities within 2e-2) and is timed through both (median of 5).
   With random weights the probabilities lie near 0.48 and the masks are
   empty: the probability bounds carry the check.
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
   1e-3 of the plain path at each device batch size (1, 2, 4, 8).
6. The 3D kernels against their plain versions at every shape phases 3-4
   gave them, plus ragged cases (kd 3 and 1, pre-ReLU, Ci 1/3/19/40; C 3,
   19, 300; overlapping windows with a valid = 0 tail), in fp32 and bf16:
   GN-conv within 1e-4 (fp32) / 2e-2 (bf16), GN statistics (mean and
   rsqrt(var + eps)) within 1e-4, GN affine and overlap-add bit-exact.  The
   GN affine also at the UNet3D training step's GroupNorm inputs (N=1,
   80x170x170: the x_aff recompute); the overlap-add on halo-stripped
   channel views of the network output as the predictor passes them, also
   at overlapping windows of predictor size (patch 80x170x170 at stride
   40x85x85 over 160x340x340: 27 windows), and every first call of it
   under ``torch.cuda.set_sync_debug_mode("error")`` (no copy to the card,
   no wait for it).  Kernel, plain and library ms (cuDNN conv3d,
   ``torch.var_mean``, ``torch.addcmul``) by CUDA events around each call
   (the event window: host work inside), in turns, median; the GN
   statistics', the affine's and the overlap-add's device time by
   ``torch.profiler``; each case's bound; sums over the model shapes (one
   ``[phase 6]`` line per kernel and dtype: window, device, library,
   bound, both shares), and the GN-conv's UNet3D predictor shapes against
   cuDNN fp32 (TF32 off).  Two calls of the GN statistics on the same
   inputs must give the same bits.
7. The GroupNorm backward kernels (Σg and Σg·x̂; dx = g·A + x·C + D)
   against their plain versions at every GroupNorm input shape of the two
   training models (UNet3D at 80x170x170, ResidualUNet3D at 64x128x128,
   N = 1, found by one forward with hooks) plus ragged C and C = 1, in fp32
   and bf16: the sums within 1e-5 x the number of positions and the same
   bits on two calls, dx within 1e-6 / 2e-2; kernel and plain ms by CUDA
   events, in turns, median; at the UNet3D shapes also the device time
   (``torch.profiler``), summed in one ``[phase 7]`` line per kernel and
   dtype (window, device, bound, both shares).
8. Kernel 2 at the 14 forward shapes of one UNet3D training step (N=1,
   80x170x170), held against its plain version within 1e-4 and timed
   against cuDNN conv3d (fp32, TF32 off).  Then gradients
   (dx, dscale, dbias, dw) through the autograd Functions
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
11. 2D training (``UNet2DTraining``): kernel 1 at the 9 DoubleConv shapes
   at the training batch (N = 32, bf16, z written, as ``double_conv2d``'s
   forward calls it), y and z against the plain version within 2e-2,
   timed against the cuDNN pair (event window and ``torch.profiler``
   device time); ``double_conv2d``'s gradients (dx, dw1, db1, dw2, db2)
   there against autograd through the plain composition (two ``F.conv2d``
   + bias + relu in fp32, z and y rounded to the input dtype, as the
   kernel computes them), fp32 with TF32 off within 1e-3 and bf16 within
   2e-2 of each gradient's max |value|, the cotangent zeroed where the two
   y differ in sign or lie near the ReLU kink and over the 3x3 window of
   every position whose z differs in sign (at most 10% zeroed); the raw
   ``fused_double2d`` must raise on tensors that require grad.  Then ``Trainer.train()`` of the base-64 bf16 UNet (fp32
   master weights) at 256², batch 32, AdamW at 1e-3, augmentation on, on
   ``SyntheticSliceDataset(64, 256, 1)``: 10 steps, evaluation (two
   passes, batches of 32 and 8) and checkpoints at steps 5 and 10; 18
   kernel-1 launches per step and per eval batch, finite losses,
   ``checkpoint-10`` reloading equal through ``UNetModel.from_pretrained``.
   Step ms (synchronised, median of steps 3-10), slices/s and peak memory
   of the kernel path and of the plain path (``plain_path()``), and a
   ``torch.profiler`` split of 3 steps of each (kernel 1, cuDNN, the
   rest).  Last, 3 steps of each path from the same weights and batches,
   augmentation off: fp32 (TF32 off) losses within LOSS_TOLS and the
   step-1 grad norm within 1e-4; bf16 within BF16_LOSS_TOLS and 1e-2.
12. Prints the card's name and power limit, the kernels' JSON line (launches
   from the main-path runs, each run's counts zeroed just before it; ms,
   plain, library and bound ms summed over the model shapes: the 9 UNet
   DoubleConvs at N=2 in bf16, the 3D kernels' fp32 model shapes; device
   ms where phases 6-7 measured it, else null; kernel 1 also its launches
   by path, serving and training, and under ``train`` its numbers at the
   training batch), and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import base64
import contextlib
import http.client
import json
import math
import os
import re
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
SERVED_BATCH = 8
SERVED_SIZES = (1, 2, 4, 8)  # device batches the engine forms (pow-2 pad)
# published H100 SXM peaks (dense): bf16 and TF32 tensor cores, fp32 on the
# CUDA cores, HBM3 bandwidth
PEAK_BF16 = 989e12
PEAK_TF32 = 495e12
PEAK_FP32 = 67e12
HBM_BYTES_PER_S = 3.35e12

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


def _peak(dtype):
    """Published dense tensor-core rate for a conv in ``dtype`` (fp32 runs
    on the TF32 units as 3xTF32; the fp32 CUDA-core rate is named beside)."""
    import torch

    return PEAK_BF16 if dtype == torch.bfloat16 else PEAK_TF32


def _bound_ms(flop: float, nbytes: float, peak: float):
    """(least ms the card could take, "operations" or "bytes")."""
    t_op, t_b = flop / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_op, "operations") if t_op >= t_b else (t_b, "bytes")


def _rate(flop: float, ms: float, dtype) -> str:
    import torch

    tf = flop / ms / 1e9
    if dtype == torch.bfloat16:
        return f"{tf:8.1f} TFLOP/s {100 * tf * 1e12 / PEAK_BF16:5.1f}% of 989"
    return (f"{tf:8.1f} TFLOP/s {100 * tf * 1e12 / PEAK_TF32:5.1f}% of 495 "
            f"(TF32; {100 * tf * 1e12 / PEAK_FP32:5.1f}% of 67 fp32)")


def _dc_flop_bytes(shape, itemsize: int, with_z: bool = False):
    """FLOP and bytes (x, weights, biases read once, y and, with_z, z
    written once) of one DoubleConvolution."""
    n, h, w, ci, c1, co = shape
    flop = 2.0 * 9 * n * h * w * (ci * c1 + c1 * co)
    nbytes = itemsize * (n * h * w * (ci + co + (c1 if with_z else 0))
                         + 9 * (ci * c1 + c1 * co) + c1 + co)
    return flop, nbytes


def _gcr_flop_bytes(shape, co: int, kd: int, itemsize: int):
    """FLOP and bytes (x and the kernel read once, y written once, a and b
    in fp32) of one fused GN-conv3d."""
    ci = shape[-1]
    positions = 1
    for d in shape[:-1]:
        positions *= d
    flop = 2.0 * kd * 9 * ci * co * positions
    nbytes = (itemsize * (positions * (ci + co) + kd * 9 * ci * co)
              + 8 * shape[0] * ci)
    return flop, nbytes


def _log_ptxas(build_log: str) -> None:
    """Registers, shared memory and spills of every kernel in the build log,
    under its name (the conv core's instantiations shortened to dtype, tile
    (rows or positions / channels / warp rows) and prologue)."""
    name = "?"
    for line in build_log.splitlines():
        if "entry function" in line:
            name = line.split("'")[1] if "'" in line else line
            m = re.search(r"(conv_\w+?_kernel)I(f|13__nv_bfloat16)\w*?Li(\d+)E"
                          r"Li(\d+)ELi(\d+)E\w*?Lb([01])", name)
            if m:
                name = (f"{m[1]}<{'fp32' if m[2] == 'f' else 'bf16'}, tile "
                        f"{m[3]}/{m[4]}/{m[5]}, affine {m[6]}>")
        elif "registers" in line or "spill" in line:
            log(f"  ptxas {name[:72]}: {line.split(':', 1)[-1].strip()}")


def phase_kernels(seed: int):
    """Kernel vs plain version on every shape, and the 9 UNet shapes timed
    at N=2 and at N=8 (the served batch) in bf16; returns (max_abs_err,
    kernel ms, cuDNN ms, bound ms summed over the 9 UNet shapes at N=2 in
    bf16)."""
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
    _log_ptxas(_build.build_log_path().read_text())

    gen = torch.Generator(device="cuda").manual_seed(seed)
    max_err = 0.0
    ms = plain_ms = bound = 0.0
    log(f"{'case':9s} {'dtype':8s} {'N,H,W,Ci,C1,Co':28s} {'err y':>10s} "
        f"{'err z':>10s} {'kernel ms':>10s} {'cuDNN ms':>10s}  kernel rate")
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
            flop, nbytes = _dc_flop_bytes(shape, args[0].element_size())
            if dtype == torch.bfloat16 and name.startswith("DC"):
                ms += k_ms
                plain_ms += p_ms
                bound += _bound_ms(flop, nbytes, PEAK_BF16)[0]
            log(f"{name:9s} {str(dtype)[6:]:8s} {str(shape):28s} "
                f"{errs[0]:10.3e} {errs[1]:10.3e} {k_ms:10.4f} {p_ms:10.4f}  "
                f"{_rate(flop, k_ms, dtype)}")
            del args, y, z, y_only, y_ref, z_ref
    log(f"[phase 1] ok: max |kernel - plain| = {max_err:.3e}; 9 UNet shapes "
        f"in bf16 at N=2: kernel {ms:.4f} ms, cuDNN pair {plain_ms:.4f} ms, "
        f"bound {bound:.4f} ms")

    # the served batches: the launcher picks the tile from the grid, so each
    # device batch size the engine forms (1, 2, 4, 8) runs its own code;
    # y and z against the plain version at each, then N=8 timed
    n8_ms = n8_plain = n8_bound = 0.0
    for name, shape in DC_SHAPES:
        for n in SERVED_SIZES:
            if n == shape[0]:
                continue  # compared above
            args = _inputs((n, *shape[1:]), torch.bfloat16, gen)
            y, z = fused_double2d(*args)
            y_ref, z_ref = fused_double2d_reference(*args)
            for what, got, want in (("y", y, y_ref), ("z", z, z_ref)):
                got, want = got.float(), want.float()
                err = (got - want).abs().max().item()
                if (not torch.isfinite(got).all()
                        or not torch.allclose(got, want, rtol=BF16_TOL,
                                              atol=BF16_TOL)):
                    raise AssertionError(
                        f"{name} bf16 N={n}: {what} differs from the plain "
                        f"version by {err:.3e} (rtol = atol = {BF16_TOL})")
                max_err = max(max_err, err)
            del y, z, y_ref, z_ref
        shape = (SERVED_BATCH, *shape[1:])
        args = _inputs(shape, torch.bfloat16, gen)
        k_ms = _median_ms(lambda: fused_double2d(*args, with_z=False))
        p_ms = _median_ms(
            lambda: fused_double2d_reference(*args, with_z=False))
        flop, nbytes = _dc_flop_bytes(shape, 2)
        n8_ms += k_ms
        n8_plain += p_ms
        n8_bound += _bound_ms(flop, nbytes, PEAK_BF16)[0]
        log(f"{name:9s} {'bfloat16':8s} {str(shape):28s} {'':10s} {'':10s} "
            f"{k_ms:10.4f} {p_ms:10.4f}  {_rate(flop, k_ms, torch.bfloat16)}")
        del args
    log(f"[phase 1] 9 UNet shapes in bf16 at N={SERVED_BATCH} (the served "
        f"batch): kernel {n8_ms:.4f} ms, cuDNN pair {n8_plain:.4f} ms, bound "
        f"{n8_bound:.4f} ms; y and z match at N = {SERVED_SIZES}; max |kernel"
        f" - plain| over all = {max_err:.3e}")
    return max_err, ms, plain_ms, bound


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


def filtered_png(arr, ftype: int) -> bytes:
    """8-bit grey (H, W) or RGB (H, W, 3) PNG bytes with every row under
    filter ``ftype`` (3 Average, 4 Paeth), written with zlib and raw
    filtered scanlines (the card's machine has no PIL)."""
    import struct
    import zlib

    import numpy as np

    h, w = arr.shape[:2]
    ch = 1 if arr.ndim == 2 else arr.shape[2]
    rows = arr.reshape(h, w * ch).astype(np.int32)
    b = np.vstack([np.zeros((1, w * ch), np.int32), rows[:-1]])  # above
    a = np.hstack([np.zeros((h, ch), np.int32), rows[:, :-ch]])  # left
    c = np.hstack([np.zeros((h, ch), np.int32), b[:, :-ch]])     # above-left
    if ftype == 3:
        pred = (a + b) >> 1
    elif ftype == 4:
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    else:
        raise ValueError(f"filter {ftype}: 3 or 4")
    body = ((rows - pred) & 0xFF).astype(np.uint8)
    raw = np.hstack([np.full((h, 1), ftype, np.uint8), body]).tobytes()

    def chunk(t, data):
        return (struct.pack(">I", len(data)) + t + data
                + struct.pack(">I", zlib.crc32(t + data)))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0 if ch == 1 else 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


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
    UNetModel(config, device="cpu",
              generator=torch.Generator().manual_seed(seed)
              ).save_pretrained(bundle)

    t0 = time.time()
    registry = ModelRegistry()
    registry.register_unet2d("unet", bundle, resolution=res, device="cuda",
                             max_batch=max_batch)
    log(f"[phase 2] registered (load + warm-up of batches 1..{max_batch}) "
        f"in {time.time() - t0:.2f} s")

    rng = np.random.default_rng(seed)
    sizes = [(256, 256), (200, 310), (384, 384), (97, 130)]
    images, arrays = [], []
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
        arrays.append(arr)
    # the first 4 again (RGB 256², grey 200x310, grey 384², RGB 97x130),
    # each with every row under Average (3) and under Paeth (4): real
    # clients' PNGs, decoded by the C unfilter
    filtered = []
    for k in range(4):
        for ftype in (3, 4):
            path = os.path.join(workdir, f"scan_{k:02d}_filter{ftype}.png")
            with open(path, "wb") as f:
                f.write(filtered_png(arrays[k], ftype))
            if not np.array_equal(png.read(path, "L"),
                                  png.read(images[k], "L")):
                raise AssertionError(f"{path}: decodes differently from the "
                                     "filter-0 copy")
            filtered.append((k, path))
    images += [path for _, path in filtered]

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
    log(f"[phase 2] {len(images)} requests from {clients} clients in "
        f"{wall:.3f} s; /stats: {json.dumps(stats)}")

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

    if batches <= 0 or launches != 18 * batches:
        raise AssertionError(f"{launches} kernel launches for {batches} "
                             "device batches (want 18 per batch: conv1 and "
                             "conv2 of 9 DoubleConvs)")
    for j, (k, path) in enumerate(filtered):
        if not np.array_equal(masks[16 + j], masks[k]):
            raise AssertionError(f"{path}: its mask differs from the filter-0 "
                                 "copy's")
    log(f"[phase 2] {launches} kernel launches for {batches} device batches "
        f"(9 DoubleConvs of 2 launches each); all {len(images)} replies 200 "
        f"with {res}x{res} masks; the {len(filtered)} Average- and "
        f"Paeth-filtered copies decode to the filter-0 pixels and get the "
        f"same masks")

    # the serving copy, as register_unet2d holds it
    model = UNetModel.from_pretrained(bundle, device="cuda").for_inference()
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
    # a full device batch through the served forward (the tiles of N=8)
    err8 = float(np.abs(entry.probs_forward(x8.astype(np.float32) / 255.0)
                        - _plain_probs(model, x8_dev).cpu().numpy()).max())
    log(f"  batch of {max_batch}: max |p_kernel - p_plain| {err8:.3e}")
    if err8 > PROB_TOL:
        raise AssertionError(f"a served batch of {max_batch} disagrees with "
                             "the plain DoubleConv")
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


def read_yaml_subset(path: str) -> dict:
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

    # inside plain_path the plain versions stand in: they launch nothing
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


class plain_path:
    """Within this block the models, the predictor, the trainers and the
    server run every kernel's plain PyTorch version on the card (cuDNN
    conv2d pair for kernel 1, cuDNN conv3d, plain GN forward and backward,
    plain overlap-add): the comparison pipeline.  Nothing of the port
    switches by itself; only this script swaps the functions."""

    def __enter__(self):
        from mdeical_image_segmentation_tpu_torch.infer import predictor
        from mdeical_image_segmentation_tpu_torch.models import layers2d
        from mdeical_image_segmentation_tpu_torch.ops import fused_conv, norm, overlap

        self.saved = [
            (fused_conv, "fused_double2d",
             fused_conv.fused_double2d_reference),
            (layers2d, "fused_double2d", fused_conv.fused_double2d_reference),
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


def _record_shapes(model, shapes: set, tag: str = ""):
    """Forward pre-hooks that note the input shape of every fused 'gcr'
    SingleConv (with Co and ``tag``, the model's name) and GroupNorm
    module: the shapes kernel checks run at."""
    from mdeical_image_segmentation_tpu_torch.models import SingleConv
    from mdeical_image_segmentation_tpu_torch.ops.norm import GroupNorm

    def conv_hook(mod, args):
        if mod.fused:
            x = args[0]
            shapes.add(("gcr", tuple(x.shape), mod.TorchConv_0.weight.shape[0],
                        tag))
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
    starts, valid mask (the tail padded with the last start, weight 0) and
    the halo the patches are a stripped view of."""
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
                    tuple(raw.shape), tuple(starts), tuple(valid),
                    tuple(slices["halo_shape"])))


def seeded_volume(shape, seed):
    import numpy as np

    v = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return ((v - v.mean()) / v.std()).astype(np.float32)


def _run_predictor(model, config, raw, slices, batch_size, shapes, tag):
    """One pass of the sliding-window predictor, kernel path then plain
    path; returns (maps, plain maps, per-batch records, launches)."""
    import torch

    from mdeical_image_segmentation_tpu_torch.data.volume_utils import (
        padded_patch_batches,
    )
    from mdeical_image_segmentation_tpu_torch.infer import get_predictor

    def batches():
        return padded_patch_batches(raw, slices, batch_size)

    handles = _record_shapes(model, shapes, tag)
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
    with plain_path():
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
    cfg = read_yaml_subset(PREDICT_YML)
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

    raw = seeded_volume(VOLUME_3D, seed)
    config = {"model": model_cfg, "predictor": cfg["predictor"]}
    maps, plain, rec, plain_rec, launches, wall, plain_wall = _run_predictor(
        model, config, raw, slices, batch_size, shapes, "UNet3D")
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

    cfg = read_yaml_subset(PREDICT_YML)
    model = get_model(RESIDUAL_MODEL,
                      generator=torch.Generator().manual_seed(seed + 1))
    model = model.to(DEVICE).eval()
    raw = seeded_volume(VOLUME_RESIDUAL, seed + 1)
    config = {"model": RESIDUAL_MODEL, "predictor": cfg["predictor"]}
    maps, plain, rec, plain_rec, launches, wall, plain_wall = _run_predictor(
        model, config, raw, RESIDUAL_SLICES, cfg["loaders"]["batch_size"],
        shapes, "ResidualUNet3D")
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
                  for p in images]).astype(np.float32) / 255.0
    # every device batch size the engine forms: each picks its own tiles
    for n in SERVED_SIZES:
        probs = entry.probs_forward(x[:n])
        with plain_path():
            plain = entry.probs_forward(x[:n])
        err = float(np.abs(probs - plain).max())
        log(f"  served probabilities vs plain path, batch of {n}: max |diff| "
            f"{err:.3e} (limit {SERVE3D_PROB_TOL}), p in [{plain.min():.4f}, "
            f"{plain.max():.4f}]")
        if not np.isfinite(probs).all() or err > SERVE3D_PROB_TOL:
            raise AssertionError(f"3D serving disagrees with the plain path "
                                 f"at a batch of {n}")
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


def _time_turns(*fns, budget_s: float = 0.6):
    """Median ms of each function (kernel, plain version, library call),
    timed in turns with CUDA events after one warm-up each; fewer repeats
    for the long calls."""
    import torch

    def once(fn):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e)

    first = sum(once(fn) for fn in fns)
    repeats = max(1, min(10, int(budget_s * 1e3 / max(first, 1e-3))))
    times = [[] for _ in fns]
    for _ in range(repeats):
        for t, fn in zip(times, fns):
            t.append(once(fn))
    return tuple(statistics.median(t) for t in times)


def _rand(gen, shape, dtype, scale=1.0, shift=0.0):
    import torch

    t = torch.randn(shape, device=DEVICE, generator=gen)
    return t.mul_(scale).add_(shift).to(dtype)


def _record_header():
    log(f"{'kernel':13s} {'dtype':8s} {'case':44s} {'max err':>10s} "
        f"{'kernel ms':>11s} {'plain ms':>11s} {'library ms':>11s} "
        f"{'bound ms':>10s}")


def _new_records(*kernels):
    return {k: {"err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": None,
                "device_ms": None, "bound_ms": 0.0, "op_ms": 0.0,
                "byte_ms": 0.0}
            for k in kernels}


def _record(out, kernel, case, dtype, err, k_ms, p_ms, model_shape, flop,
            nbytes, peak, lib_ms=None, dev_ms=None):
    """Log one kernel-vs-plain case; keep the kernel's worst error and the
    fp32 model shapes' summed kernel, plain, library, device and bound times
    (the bound per shape: FLOP at ``peak`` or bytes at the HBM rate, the
    larger)."""
    import torch

    rec = out[kernel]
    rec["err"] = max(rec["err"], err)
    bound = _bound_ms(flop, nbytes, peak)[0]
    if model_shape and dtype == torch.float32:
        rec["ms"] += k_ms
        rec["plain_ms"] += p_ms
        rec["bound_ms"] += bound
        rec["op_ms"] += flop / peak * 1e3
        rec["byte_ms"] += nbytes / HBM_BYTES_PER_S * 1e3
        for key, v in (("library_ms", lib_ms), ("device_ms", dev_ms)):
            if v is not None:
                rec[key] = (rec[key] or 0.0) + v
    lib = f"{lib_ms:11.3f}" if lib_ms is not None else f"{'none':>11s}"
    log(f"{kernel:13s} {str(dtype)[6:]:8s} {case:44s} {err:10.3e} "
        f"{k_ms:11.3f} {p_ms:11.3f} {lib} {bound:10.3f}")


def _add_sums(sums: dict, key, **vals) -> None:
    """Add one shape's times (window, device, library, ..., bound) into the
    totals of ``key`` (a shape set and dtype), counting the shapes."""
    tot = sums.setdefault(key, {"n": 0.0})
    tot["n"] += 1
    for name, v in vals.items():
        tot[name] = tot.get(name, 0.0) + v


def _log_sums(phase: int, kernel: str, sums: dict, library: str = "") -> None:
    """One line per (shape set, dtype) of ``_add_sums`` totals: the event
    window, the device time, the library call's where there is one, the
    bound and both shares."""
    for (label, dtype), t in sums.items():
        lib = ""
        if library:
            lib = f"; {library} window {t['library']:.4f} ms"
            if "library_device" in t:
                lib += f", device {_ms(t['library_device'])}"
        log(f"[phase {phase}] {kernel} over the {t['n']:.0f} {label}, "
            f"{str(dtype)[6:]}: event window {t['window']:.4f} ms, device "
            f"{_ms(t['device'])}{lib}; bound {t['bound']:.4f} ms (share: "
            f"window {_share(t['bound'], t['window'])}, device "
            f"{_share(t['bound'], t['device'])})")


def _same_bits(what: str, first, second) -> None:
    """Two calls' outputs must be identical, bit for bit."""
    import torch

    for a, b in zip(first, second):
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: two calls on the same inputs "
                                 "differ (the reduction must be "
                                 "deterministic)")


def _elementwise(numel: int, ops_per_element: int, nbytes: float):
    """(FLOP, bytes, peak) of a streaming pass: fp32 ops on the CUDA
    cores."""
    return float(numel) * ops_per_element, float(nbytes), PEAK_FP32


def device_times(prof):
    """{kernel name: ms} of a ``torch.profiler`` run: the self device time
    of every kernel, summed by name."""
    by_name: dict = {}
    for evt in prof.key_averages():
        dev = getattr(evt, "self_device_time_total", None)
        if dev is None:
            dev = getattr(evt, "self_cuda_time_total", 0.0)
        if dev and evt.device_type.name == "CUDA":
            by_name[evt.key] = by_name.get(evt.key, 0.0) + dev / 1e3
    return by_name


def _device_ms(fn, launches: int = 1, repeats: int = 5,
               tries: int = 3) -> float:
    """Device time of one call of ``fn``, which launches ``launches``
    kernels of one kind: the mean self device time of the kernel events
    ``torch.profiler`` recorded over ``repeats`` calls after a warm-up,
    times ``launches``.  Host work between launches is not in it; the event
    window of ``_time_turns`` holds both.  The tracer drops an event now
    and then, so the mean is over the events it kept; a profiled pass that
    kept none is run again, and after ``tries`` such passes the time is
    NaN: not measured."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(repeats):
                fn()
            torch.cuda.synchronize()
        total = count = 0.0
        for evt in prof.key_averages():
            dev = getattr(evt, "self_device_time_total", None)
            if dev is None:
                dev = getattr(evt, "self_cuda_time_total", 0.0)
            if dev and evt.device_type.name == "CUDA":
                total += dev / 1e3
                count += evt.count
        if count:
            return total / count * launches
    return math.nan


def _ms(v: float) -> str:
    return "not measured" if math.isnan(v) else f"{v:.4f} ms"


def _share(bound: float, ms: float) -> str:
    return "not measured" if math.isnan(ms) else f"{100 * bound / ms:.1f}%"


class _sync_debug_error:
    """``torch.cuda.set_sync_debug_mode("error")`` within the block: any
    synchronising CUDA call through PyTorch raises."""

    def __enter__(self):
        import torch

        self.prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")

    def __exit__(self, *exc):
        import torch

        torch.cuda.set_sync_debug_mode(self.prev)


def _overlap_work(pshape, vol, starts, valid, itemsize: int):
    """(FLOP, bytes) the overlap-add needs for these inputs: each valid
    patch read once (a mul and two adds per element), each element of the
    union of their windows read and written once in acc and cnt (fp32)."""
    import numpy as np

    p, pd, ph, pw, c = pshape
    cover = np.zeros(vol, bool)
    n_valid = 0
    for (z, y, x), w in zip(starts, valid):
        if w:
            cover[z:z + pd, y:y + ph, x:x + pw] = True
            n_valid += 1
    elems = n_valid * pd * ph * pw * c
    return 3.0 * elems, float(elems * itemsize + int(cover.sum()) * c * 16)


def _windows(vol, patch, stride):
    """Sliding-window starts over ``vol``, the last window flush with the
    end (the SliceBuilder's rule)."""
    import itertools

    axes = []
    for v, p, st in zip(vol, patch, stride):
        starts = list(range(0, v - p + 1, st))
        if starts[-1] != v - p:
            starts.append(v - p)
        axes.append(starts)
    return [list(s) for s in itertools.product(*axes)]


# the overlapping-window case at predictor size: patch 80x170x170 at stride
# 40x85x85 over 160x340x340 (27 windows; a voxel in up to 8), halo-stripped
# views of 112x234x234 outputs as the predictor passes them
OVERLAP_PATCH = (80, 170, 170)
OVERLAP_STRIDE = (40, 85, 85)
OVERLAP_VOLUME = (160, 340, 340)
OVERLAP_HALO = (16, 32, 32)


def phase_kernels_3d(seed: int, shapes: set, train_shapes):
    """Each 3D kernel against its plain version at every shape the two
    models produced in phases 3-4, plus ragged cases, in fp32 and bf16;
    kernel 2, 3a and 3b also against one library call (cuDNN conv3d,
    ``torch.var_mean``, ``torch.addcmul``); 3b also at the UNet3D training
    step's GroupNorm inputs; 3a, 3b and 4 also by device time; 3a's two
    calls on the same inputs give the same bits."""
    import torch
    import torch.nn.functional as F

    from mdeical_image_segmentation_tpu_torch.ops import fused_conv, norm, overlap

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    out = _new_records("gcr_conv3d", "gn_stats", "gn_affine", "overlap_add")
    unet = {"ms": 0.0, "library_ms": 0.0, "flop": 0.0}  # UNet3D shapes, fp32

    def rand(shape, dtype=torch.float32, scale=1.0, shift=0.0):
        return _rand(gen, shape, dtype, scale, shift)

    def coeffs(n, c):
        a = torch.rand((n, c), device=DEVICE, generator=gen) + 0.5
        return a, 0.5 * torch.randn((n, c), device=DEVICE, generator=gen)

    def record(*args, **kw):
        _record(out, *args, **kw)

    # (shape set, dtype) -> summed ms and bound
    stats_sums: dict = {}
    affine_sums: dict = {}
    overlap_sums: dict = {}
    sync_checked = 0
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
        cases = [(s[1], s[2], 3, False, s[3]) for s in gcr] + [
            (*r, "") for r in ragged_gcr]
        for shape, co, kd, pre, model in cases:
            ci = shape[-1]
            x = rand(shape, dtype)
            k = rand((kd, 3, 3, ci, co), dtype, (9 * kd * ci) ** -0.5)
            a, b = coeffs(shape[0], ci)
            y = fused_conv.fused_conv3d(x, k, a, b, pre_relu=pre)
            ref = fused_conv.fused_conv3d_reference(x, k, a, b, pre_relu=pre)
            err = _compare(f"gcr_conv3d {shape}->{co}", y, ref,
                           BF16_TOL if bf16 else FP32_TOL)
            del y, ref
            xc, kc = x.permute(0, 4, 1, 2, 3), k.permute(4, 3, 0, 1, 2)
            k_ms, p_ms, l_ms = _time_turns(
                lambda: fused_conv.fused_conv3d(x, k, a, b, pre_relu=pre),
                lambda: fused_conv.fused_conv3d_reference(x, k, a, b,
                                                          pre_relu=pre),
                lambda: F.conv3d(xc, kc, padding=((kd - 1) // 2, 1, 1)))
            flop, nbytes = _gcr_flop_bytes(shape, co, kd, x.element_size())
            record("gcr_conv3d", f"{shape}->{co} kd{kd} pre{int(pre)}", dtype,
                   err, k_ms, p_ms, bool(model), flop, nbytes, _peak(dtype),
                   l_ms)
            log(f"{'':13s} {model or 'ragged':14s} kernel "
                f"{_rate(flop, k_ms, dtype)}; cuDNN conv3d "
                f"{_rate(flop, l_ms, dtype)}")
            if model == "UNet3D" and not bf16:
                unet["ms"] += k_ms
                unet["library_ms"] += l_ms
                unet["flop"] += flop
            del x, k, xc, kc
            torch.cuda.empty_cache()
        cases = [(s[1], True) for s in stats] + [(r, False) for r in ragged_gn]
        for shape, model_shape in cases:
            x = rand(shape, dtype, 2.0, 1.0)
            count = x.numel() // (shape[0] * shape[-1])
            sums = norm.gn_channel_sums(x)
            _same_bits(f"gn_stats {shape} {dtype}", sums,
                       norm.gn_channel_sums(x))
            got = norm.group_stats(*sums, shape[-1], count, 1e-5)
            want = norm.group_stats(*norm.gn_channel_sums_reference(x),
                                    shape[-1], count, 1e-5)
            err = max(_compare(f"gn_stats {shape} {what}", g, w, GN_TOL)
                      for what, g, w in zip(("mean", "inv"), got, want))
            spatial = tuple(range(1, x.ndim - 1))
            # one library call that reads x once for the same per-(n, c)
            # statistics
            fn = lambda: norm.gn_channel_sums(x)
            k_ms, p_ms, l_ms = _time_turns(
                fn, lambda: norm.gn_channel_sums_reference(x),
                lambda: torch.var_mean(x, dim=spatial, correction=0))
            # two launches a call: the partial sums and the final tree
            k_dev = _device_ms(fn, 2) if model_shape else math.nan
            work = _elementwise(x.numel(), 3, x.numel() * x.element_size()
                                + 8 * shape[0] * shape[-1])
            record("gn_stats", str(shape), dtype, err, k_ms, p_ms,
                   model_shape, *work, l_ms, k_dev)
            if model_shape:
                log(f"{'':13s} device time: kernel {_ms(k_dev)}")
                _add_sums(stats_sums, ("predictor shapes", dtype),
                          window=k_ms, device=k_dev, library=l_ms,
                          bound=_bound_ms(*work)[0])
            del x
            torch.cuda.empty_cache()
        # 3b: the ResidualUNet3D predictor's GroupNorm inputs (N=4), the
        # UNet3D training step's x_aff recompute inputs (N=1), ragged C
        cases = ([(s[1], "ResidualUNet3D") for s in affine]
                 + [(s, "UNet3D train") for s, m in train_shapes["gn"]
                    if m == "UNet3D"]
                 + [(r, "ragged") for r in ragged_gn])
        for shape, model in cases:
            x = rand(shape, dtype)
            a, b = coeffs(shape[0], shape[-1])
            err = _compare(f"gn_affine {shape}", norm.gn_affine(x, a, b),
                           norm.gn_affine_reference(x, a, b), 0.0, exact=True)
            bshape = (shape[0],) + (1,) * (x.ndim - 2) + (shape[-1],)
            # the library call moves the same bytes: coefficients in x's
            # dtype, so a bf16 x gives a bf16 y (its rounding differs)
            a_b, b_b = a.view(bshape).to(dtype), b.view(bshape).to(dtype)
            fns = (lambda: norm.gn_affine(x, a, b),
                   lambda: norm.gn_affine_reference(x, a, b),
                   lambda: torch.addcmul(b_b, x, a_b))
            k_ms, p_ms, l_ms = _time_turns(*fns)
            k_dev, l_dev = _device_ms(fns[0]), _device_ms(fns[2])
            work = _elementwise(x.numel(), 2, 2 * x.numel() * x.element_size()
                                + 8 * shape[0] * shape[-1])
            record("gn_affine", f"{shape} {model}", dtype, err, k_ms, p_ms,
                   model == "ResidualUNet3D", *work, l_ms, k_dev)
            log(f"{'':13s} device time: kernel {_ms(k_dev)}, "
                f"torch.addcmul {_ms(l_dev)}")
            if model != "ragged":
                _add_sums(affine_sums, (f"{model} shapes", dtype),
                          window=k_ms, device=k_dev, library=l_ms,
                          library_device=l_dev, bound=_bound_ms(*work)[0])
            del x
            torch.cuda.empty_cache()
        # 4: the predictors' batches (patch = stride: no overlap; the second
        # batch a padded tail), overlapping windows at predictor size, and
        # ragged ones; (pshape, volume, starts, valid, halo, (channels of
        # the network output, offset of the selected ones), label): the
        # patches are a halo-stripped channel view of the network output,
        # as the predictor passes them
        wins = _windows(OVERLAP_VOLUME, OVERLAP_PATCH, OVERLAP_STRIDE)
        cases = [(s[1], s[2], s[3], s[4], s[5], (s[1][-1], 0), "predictor")
                 for s in overlaps] + [
            ((len(wins), *OVERLAP_PATCH, 1), OVERLAP_VOLUME, wins,
             [1] * len(wins), OVERLAP_HALO, (1, 0), "overlapping windows"),
            ((5, 4, 8, 9, 2), (8, 14, 16),
             [[0, 0, 0], [2, 3, 1], [1, 5, 6], [4, 6, 7], [4, 6, 7]],
             [1, 1, 1, 1, 0], (0, 0, 0), (2, 0), "ragged"),
            ((6, 7, 9, 5, 3), (9, 11, 13),
             [[0, 0, 0], [1, 1, 1], [2, 2, 8], [2, 0, 4], [0, 2, 3], [0, 2, 3]],
             [1, 1, 1, 1, 1, 0], (0, 0, 0), (3, 0), "ragged"),
            ((5, 4, 8, 9, 1), (8, 14, 16),
             [[0, 0, 0], [2, 3, 1], [1, 5, 6], [4, 6, 7], [4, 6, 7]],
             [1, 1, 1, 1, 0], (1, 2, 1), (3, 1), "ragged view"),
            ((6, 7, 9, 5, 2), (9, 11, 13),
             [[0, 0, 0], [1, 1, 1], [2, 2, 8], [2, 0, 4], [0, 2, 3], [0, 2, 3]],
             [1, 1, 1, 1, 1, 0], (3, 1, 2), (3, 0), "ragged view"),
        ]
        for pshape, vol, starts, valid, halo, (cb, c0), label in cases:
            p_, pd, ph, pw, c = pshape
            hz, hy, hx = halo
            base = rand((p_, pd + 2 * hz, ph + 2 * hy, pw + 2 * hx, cb), dtype)
            p = base[:, hz:hz + pd, hy:hy + ph, hx:hx + pw, c0:c0 + c]
            acc0 = rand((*vol, c))
            cnt0 = torch.randint(0, 3, (*vol, c), device=DEVICE,
                                 generator=gen).float()
            acc, cnt = acc0.clone(), cnt0.clone()
            p_acc, p_cnt = acc0.clone(), cnt0.clone()
            with _sync_debug_error():  # no copy to the card, no wait for it
                overlap.overlap_add_into(acc, cnt, p, starts, valid)
            sync_checked += 1
            overlap.overlap_add_into_reference(p_acc, p_cnt, p, starts, valid)
            err = max(_compare(f"overlap_add {pshape} acc", acc, p_acc, 0.0,
                               exact=True),
                      _compare(f"overlap_add {pshape} cnt", cnt, p_cnt, 0.0,
                               exact=True))
            fn = lambda: overlap.overlap_add_into(acc, cnt, p, starts, valid)
            k_ms, p_ms = _time_turns(
                fn, lambda: overlap.overlap_add_into_reference(
                    p_acc, p_cnt, p, starts, valid))
            k_dev = _device_ms(fn, -(-p_ // overlap.CHUNK))
            flop, nbytes = _overlap_work(pshape, vol, starts, valid,
                                         p.element_size())
            record("overlap_add", f"{pshape} into {vol} {label}", dtype, err,
                   k_ms, p_ms, label == "predictor", flop, nbytes, PEAK_FP32,
                   dev_ms=k_dev)
            log(f"{'':13s} device time: kernel {_ms(k_dev)}; patches "
                f"strides {p.stride()}")
            if label != "ragged" and label != "ragged view":
                _add_sums(overlap_sums, (f"{label} case(s)", dtype),
                          window=k_ms, device=k_dev,
                          bound=_bound_ms(flop, nbytes, PEAK_FP32)[0])
            del base, p, acc0, cnt0, acc, cnt, p_acc, p_cnt
            torch.cuda.empty_cache()
    log(f"[phase 6] ok: {len(gcr)} gcr_conv3d, {len(stats)} gn_stats, "
        f"{len(affine)} gn_affine and {len(overlaps)} overlap_add model cases "
        "plus training and ragged cases match in fp32 and bf16 (gn_affine "
        "and overlap_add bit-exact, gn_stats the same bits on two calls); "
        f"overlap_add_into ran {sync_checked} times under "
        "torch.cuda.set_sync_debug_mode('error')")
    _log_sums(6, "gn_stats", stats_sums, "torch.var_mean")
    _log_sums(6, "gn_affine", affine_sums, "torch.addcmul")
    _log_sums(6, "overlap_add", overlap_sums)
    log(f"[phase 6] kernel 2 over the UNet3D predictor's "
        f"{sum(s[3] == 'UNet3D' for s in gcr)} shapes, fp32: kernel "
        f"{unet['ms']:.3f} ms, cuDNN conv3d (TF32 off) "
        f"{unet['library_ms']:.3f} ms; kernel "
        f"{_rate(unet['flop'], unet['ms'], torch.float32)}")
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

    cfg = read_yaml_subset(TRAIN_YML)
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
    fp32 and bf16, 3c also for the same bits on two calls; at the UNet3D
    shapes also by device time.  Returns {kernel: {err, ms, plain_ms,
    ...}}."""
    import torch

    from mdeical_image_segmentation_tpu_torch.ops import norm

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    out = _new_records("gn_bwd_reduce", "gn_bwd_dx")
    reduce_sums: dict = {}  # (shape set, dtype) -> summed ms and bound
    dx_sums: dict = {}

    ragged = [(2, 5, 9, 11, 3), (2, 6, 20, 17, 19), (1, 3, 7, 9, 300),
              (1, 7, 13, 11, 1)]
    # the sums cover one UNet3D training step's GroupNorm inputs
    cases = [(s, m == "UNet3D", m) for s, m in shapes["gn"]] + [
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
            _same_bits(f"gn_bwd_reduce {shape} {dtype}", got,
                       norm.gn_bwd_reduce(x, g, mean, inv))
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
            fn = lambda: norm.gn_bwd_reduce(x, g, mean, inv)
            k_ms, p_ms = _time_turns(
                fn, lambda: norm.gn_bwd_reduce_reference(x, g, mean, inv))
            timed = model == "UNet3D"
            # two launches a call: the partial sums and the final tree
            k_dev = _device_ms(fn, 2) if timed else math.nan
            work = _elementwise(x.numel(), 5, 2 * x.numel() * x.element_size()
                                + 16 * n * c)
            _record(out, "gn_bwd_reduce", f"{shape} {model}", dtype, err,
                    k_ms, p_ms, model_shape, *work, dev_ms=k_dev)
            if timed:
                log(f"{'':13s} device time: kernel {_ms(k_dev)}")
                _add_sums(reduce_sums, ("UNet3D training shapes", dtype),
                          window=k_ms, device=k_dev,
                          bound=_bound_ms(*work)[0])
            a, cc, dd = (torch.randn((n, c), device=DEVICE, generator=gen)
                         for _ in range(3))
            err = _compare(f"gn_bwd_dx {shape}", norm.gn_bwd_dx(x, g, a, cc, dd),
                           norm.gn_bwd_dx_reference(x, g, a, cc, dd),
                           BF16_TOL if dtype == torch.bfloat16
                           else AFFINE_FP32_TOL)
            fn = lambda: norm.gn_bwd_dx(x, g, a, cc, dd)
            k_ms, p_ms = _time_turns(
                fn, lambda: norm.gn_bwd_dx_reference(x, g, a, cc, dd))
            k_dev = _device_ms(fn) if timed else math.nan
            work = _elementwise(x.numel(), 4, 3 * x.numel() * x.element_size()
                                + 12 * n * c)
            _record(out, "gn_bwd_dx", f"{shape} {model}", dtype, err, k_ms,
                    p_ms, model_shape, *work, dev_ms=k_dev)
            if timed:
                log(f"{'':13s} device time: kernel {_ms(k_dev)}")
                _add_sums(dx_sums, ("UNet3D training shapes", dtype),
                          window=k_ms, device=k_dev,
                          bound=_bound_ms(*work)[0])
            del x, g
            torch.cuda.empty_cache()
    log(f"[phase 7] ok: {len(shapes['gn'])} model shapes plus "
        f"{len(ragged)} ragged cases match in fp32 and bf16 (gn_bwd_reduce "
        "the same bits on two calls)")
    _log_sums(7, "gn_bwd_reduce", reduce_sums)
    _log_sums(7, "gn_bwd_dx", dx_sums)
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


def phase_train_forward_convs(seed: int, shapes):
    """Kernel 2 against cuDNN's conv3d (fp32, TF32 off) at the UNet3D
    training model's 14 SingleConv input shapes (N=1, 80x170x170): the
    forward convs of one training step.  Returns (kernel ms, cuDNN ms),
    summed."""
    import torch
    import torch.nn.functional as F

    from mdeical_image_segmentation_tpu_torch.ops import fused_conv

    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    ms = lib_ms = flop_sum = 0.0
    cases = [(s, co) for s, co, m in shapes["gcr"] if m == "UNet3D"]
    for shape, co in cases:
        ci = shape[-1]
        x = _rand(gen, shape, torch.float32)
        k = _rand(gen, (3, 3, 3, ci, co), torch.float32, (27 * ci) ** -0.5)
        a = torch.rand((shape[0], ci), device=DEVICE, generator=gen) + 0.5
        b = 0.5 * torch.randn((shape[0], ci), device=DEVICE, generator=gen)
        # N=1 picks its own tiles: held against the plain version here too
        err = _compare(f"gcr_conv3d train {shape}->{co}",
                       fused_conv.fused_conv3d(x, k, a, b),
                       fused_conv.fused_conv3d_reference(x, k, a, b), FP32_TOL)
        xc, kc = x.permute(0, 4, 1, 2, 3), k.permute(4, 3, 0, 1, 2)
        k_ms, l_ms = _time_turns(
            lambda: fused_conv.fused_conv3d(x, k, a, b),
            lambda: F.conv3d(xc, kc, padding=1))
        flop = _gcr_flop_bytes(shape, co, 3, 4)[0]
        ms += k_ms
        lib_ms += l_ms
        flop_sum += flop
        log(f"  train fwd {str(shape):26s} -> {co:4d}: err {err:.2e}; kernel "
            f"{k_ms:9.3f} ms {_rate(flop, k_ms, torch.float32)}; cuDNN "
            f"{l_ms:9.3f} ms")
        del x, k, xc, kc
        torch.cuda.empty_cache()
    log(f"[phase 8] kernel 2 at the {len(cases)} training-forward shapes, "
        f"fp32: kernel {ms:.3f} ms, cuDNN conv3d (TF32 off) {lib_ms:.3f} ms; "
        f"kernel {_rate(flop_sum, ms, torch.float32)}")
    return ms, lib_ms


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
                  seed=SEED, **trainer_kw):
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
        checkpoint_dir=checkpoint_dir, base_lr=lr, seed=seed,
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


class UNet3DTraining:
    """Phase 9's training setup, the one way to build it (phase 9 and
    ``chip_train_step.py`` use it): the UNet3D, loss, metric, optimizer and
    scheduler of configs/unet3d_train.yml; a seeded 80x260x260 training
    volume (4 patches at the yml's stride) and 80x170x340 validation volume
    (2 patches), each labelled with its smoothed sign; random initial
    weights from ``seed``, saved under ``workdir``.  ``trainer(name)``
    builds a UNetTrainer on them, writing to ``workdir/name``; inside
    ``plain_path()`` it runs the plain versions."""

    def __init__(self, seed: int, workdir: str):
        self.seed, self.workdir = seed, workdir
        os.makedirs(workdir, exist_ok=True)
        self.cfg = read_yaml_subset(TRAIN_YML)
        self.model_cfg = self.cfg["model"]
        loaders = self.cfg["loaders"]
        train_sb = loaders["train"]["slice_builder"]
        val_sb = loaders["val"]["slice_builder"]
        raw = seeded_volume(TRAIN_VOLUME, seed + 2)
        val_raw = seeded_volume(VAL_VOLUME, seed + 3)
        self.train_ds = _PatchDataset(raw, _smooth_label(raw),
                                      train_sb["patch_shape"],
                                      train_sb["stride_shape"])
        self.val_ds = _PatchDataset(val_raw, _smooth_label(val_raw),
                                    val_sb["patch_shape"],
                                    val_sb["stride_shape"])
        self.batch_size = loaders["batch_size"]
        self.checkpoint = _initial_checkpoint(self.model_cfg, seed, workdir,
                                              "unet3d_init")

    def trainer(self, name: str, resume: str | None = None, **trainer_kw):
        """A UNetTrainer from the initial weights, or from ``resume``."""
        from mdeical_image_segmentation_tpu_torch.data.loaders import (
            VolumeLoader,
        )

        loaders = {"train": VolumeLoader(self.train_ds, self.batch_size,
                                         shuffle=True, seed=self.seed,
                                         drop_last=True),
                   "val": VolumeLoader(self.val_ds, self.batch_size)}
        if resume is not None:
            trainer_kw["resume"] = resume
        return _make_trainer(self.model_cfg, self.cfg, loaders,
                             os.path.join(self.workdir, name),
                             None if resume else self.checkpoint,
                             seed=self.seed, **trainer_kw)


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

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    setup = UNet3DTraining(seed, workdir)
    cfg, model_cfg = setup.cfg, setup.model_cfg
    train_sb = cfg["loaders"]["train"]["slice_builder"]
    log(f"[phase 9] model {model_cfg}; loss {cfg['loss']}; eval_metric "
        f"{cfg['eval_metric']}; optimizer {cfg['optimizer']}; lr_scheduler "
        f"{cfg['lr_scheduler']}; batch {setup.batch_size}; "
        f"patch {train_sb['patch_shape']}, train stride "
        f"{train_sb['stride_shape']}; fp32, TF32 off")
    log(f"  {len(setup.train_ds)} train patches of a {TRAIN_VOLUME} volume, "
        f"{len(setup.val_ds)} val patches of {VAL_VOLUME}; label share "
        f"{setup.train_ds.label.mean():.3f}")
    run_dir = os.path.join(workdir, "unet3d_train")
    trainer = setup.trainer("unet3d_train", max_num_iterations=6,
                            validate_after_iters=3, log_after_iters=2)
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
    with plain_path():
        plain = setup.trainer("unet3d_plain", max_num_iterations=2,
                              validate_after_iters=1000, log_after_iters=1000)
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
    resumed = setup.trainer("unet3d_train", resume=last, max_num_iterations=5,
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

    cfg = read_yaml_subset(TRAIN_YML)
    raw = seeded_volume((64, 128, 256), seed + 4)
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
    with plain_path():
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


# ---------------------------------------------------------------------------
# 2D classic-UNet training (Trainer.train(); kernel 1 under double_conv2d)
# ---------------------------------------------------------------------------

TRAIN_BATCH_2D = 32          # bench.py's headline batch
TRAIN_STEPS_2D = 10
# 2D step losses of steps 1, 2, 3 and the step-1 grad norm, kernel path vs
# plain path, relative, in bf16.  Set before any run: bf16 keeps 8 bits, so
# a conv output that the two paths round differently differs by one ulp
# (2^-8 = 3.9e-3 relative); the loss, a mean over 2M pixels, averages such
# differences, so step 1 (same weights) should sit well inside half an ulp;
# AdamW's first updates are ±lr for every weight, and a weight whose bf16
# gradient is rounding noise moves either way, so the gap grows step by
# step (about tenfold a step in fp32, phase 9).  fp32 keeps LOSS_TOLS.
BF16_LOSS_TOLS = (2e-3, 1e-2, 5e-2)
BF16_GRAD_NORM_TOL = 1e-2
DC_GRAD_TOL = {"float32": 1e-3, "bfloat16": 2e-2}  # of each max |grad|
CONV_CORE = re.compile(r"conv_(halo|gather)_kernel")
CUDNN = re.compile(r"cudnn|xmma|dgrad|wgrad|fprop|implicit|gemm|cutlass|"
                   r"sm90_|sm80_|nchwToNhwc|nhwcToNchw", re.I)


def _plain_double_conv(x, w1, b1, w2, b2):
    """DoubleConvolution as two F.conv2d + bias + relu, differentiated by
    autograd: the plain composition, with kernel 1's arithmetic: each conv
    and its bias in fp32 from the inputs as they are, z and y rounded to
    x's dtype after the ReLU (cuDNN's bf16 conv would round the conv before
    adding the bias, moving the ReLU masks by an ulp).  Returns (y, z)."""
    import torch.nn.functional as F

    def conv(t, w, b):
        return F.conv2d(t.float().permute(0, 3, 1, 2),
                        w.float().permute(3, 2, 0, 1), b.float(),
                        padding=1).permute(0, 2, 3, 1)

    z = F.relu(conv(x, w1, b1)).to(x.dtype)
    return F.relu(conv(z, w2, b2)).to(x.dtype), z


def phase_dc_training_batch(seed: int):
    """Kernel 1 at the training batch (N = 32, bf16, z written, as the
    train step calls it): y and z against the plain version, timed against
    the cuDNN pair, device time; then ``double_conv2d``'s gradients at the
    9 DoubleConv shapes, fp32 (TF32 off) and bf16, against autograd through
    the plain composition, and the raw wrapper's refusal under grad.
    Returns the kernel-1 training-batch record."""
    import torch
    import torch.nn.functional as F

    from mdeical_image_segmentation_tpu_torch.ops.fused_conv import (
        double_conv2d,
        fused_double2d,
        fused_double2d_reference,
    )

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(seed + 11)
    rec = {"ms": 0.0, "plain_ms": 0.0, "device_ms": 0.0, "bound_ms": 0.0,
           "max_abs_err": 0.0}
    log(f"{'case':6s} {'N,H,W,Ci,C1,Co':30s} {'err y':>9s} {'err z':>9s} "
        f"{'kernel ms':>10s} {'cuDNN ms':>9s} {'device ms':>10s}  rate")
    for name, shape in DC_SHAPES:
        shape = (TRAIN_BATCH_2D, *shape[1:])
        args = _inputs(shape, torch.bfloat16, gen)
        y, z = fused_double2d(*args)
        y_ref, z_ref = fused_double2d_reference(*args)
        errs = []
        for what, got, want in (("y", y, y_ref), ("z", z, z_ref)):
            got, want = got.float(), want.float()
            errs.append((got - want).abs().max().item())
            if (not torch.isfinite(got).all()
                    or not torch.allclose(got, want, rtol=BF16_TOL,
                                          atol=BF16_TOL)):
                raise AssertionError(f"{name} bf16 N={shape[0]}: {what} "
                                     f"differs from the plain version by "
                                     f"{errs[-1]:.3e} (rtol = atol = "
                                     f"{BF16_TOL})")
        del y, z, y_ref, z_ref
        k_ms, p_ms = _time_turns(lambda: fused_double2d(*args),
                                 lambda: fused_double2d_reference(*args))
        d_ms = _device_ms(lambda: fused_double2d(*args), launches=2)
        flop, nbytes = _dc_flop_bytes(shape, 2, with_z=True)
        for key, v in (("ms", k_ms), ("plain_ms", p_ms), ("device_ms", d_ms),
                       ("bound_ms", _bound_ms(flop, nbytes, PEAK_BF16)[0])):
            rec[key] += v
        rec["max_abs_err"] = max(rec["max_abs_err"], *errs)
        log(f"{name:6s} {str(shape):30s} {errs[0]:9.2e} {errs[1]:9.2e} "
            f"{k_ms:10.4f} {p_ms:9.4f} {_ms(d_ms):>10s}  "
            f"{_rate(flop, k_ms, torch.bfloat16)}")
        del args
    log(f"[phase 11] kernel 1 at the training batch (N={TRAIN_BATCH_2D}, "
        f"bf16, z written) over the 9 UNet shapes: window {rec['ms']:.4f} ms,"
        f" device {_ms(rec['device_ms'])}, cuDNN pair {rec['plain_ms']:.4f} "
        f"ms, bound {rec['bound_ms']:.4f} ms (operations); share window "
        f"{_share(rec['bound_ms'], rec['ms'])}, device "
        f"{_share(rec['bound_ms'], rec['device_ms'])}")

    names = ("dx", "dw1", "db1", "dw2", "db2")
    worst = {}
    log(f"{'case':6s} {'dtype':9s} " + " ".join(f"{n:>9s}" for n in names)
        + "  zeroed share")
    for dtype in (torch.float32, torch.bfloat16):
        tol = DC_GRAD_TOL[str(dtype)[6:]]
        worst[dtype] = 0.0
        for name, shape in DC_SHAPES:
            shape = (TRAIN_BATCH_2D, *shape[1:])
            args = [t.requires_grad_() for t in _inputs(shape, dtype, gen)]
            try:
                fused_double2d(*args)
            except RuntimeError as e:
                if "double_conv2d" not in str(e):
                    raise
            else:
                raise AssertionError("the raw fused_double2d ran on tensors "
                                     "that require grad")
            y = double_conv2d(*args)
            with torch.no_grad():
                _, z = fused_double2d(*args)
                y_ref, z_ref = _plain_double_conv(*args)
                # the ReLU's choice at its kink is not a gradient: zero the
                # cotangent where the two y differ in sign or either lies
                # within KINK·max|y| of 0, and around every position where
                # the two z differ in sign (zero cotangent over its 3x3
                # window makes dz there 0, so conv1's mask decides nothing)
                lim = KINK * y_ref.abs().max()
                near = (((y > 0) != (y_ref > 0)) | ((y > 0) & (y < lim))
                        | ((y_ref > 0) & (y_ref < lim)))
                flip = ((z > 0) != (z_ref > 0)).any(-1, keepdim=True)
                flip = F.max_pool2d(flip.float().permute(0, 3, 1, 2), 3, 1,
                                    1).permute(0, 2, 3, 1) > 0
                zero = near | flip
                if zero.float().mean().item() > 0.1:
                    raise AssertionError(f"{name} {dtype}: the masks differ "
                                         "at over 10% of the outputs")
                g = torch.randn(y.shape, device="cuda", generator=gen).to(
                    dtype).masked_fill_(zero, 0.0)
                del y_ref, z_ref, z
            got = torch.autograd.grad(y, args, g)
            del y
            want = torch.autograd.grad(_plain_double_conv(*args)[0], args, g)
            errs = _rel_errs(names, got, want)
            log(f"{name:6s} {str(dtype)[6:]:9s} "
                + " ".join(f"{errs[n]:9.2e}" for n in names)
                + f"  {zero.float().mean().item():.2e}")
            worst[dtype] = max(worst[dtype], *errs.values())
            if max(errs.values()) > tol:
                raise AssertionError(
                    f"double_conv2d {name} {dtype}: gradients differ from the "
                    f"plain composition {errs} (limit {tol} x max |grad|)")
            del args, got, want, g, zero, near, flip
            torch.cuda.empty_cache()
    log(f"[phase 11] double_conv2d gradients at the 9 DoubleConv shapes, "
        f"N={TRAIN_BATCH_2D}: worst {worst[torch.float32]:.3e} (fp32, TF32 "
        f"off, limit {DC_GRAD_TOL['float32']}), {worst[torch.bfloat16]:.3e} "
        f"(bf16, limit {DC_GRAD_TOL['bfloat16']}) of max |grad|; the raw "
        f"wrapper raises under grad")
    rec["grad_err"] = max(worst.values())
    return rec


class UNet2DTraining:
    """The 2D training setup of phase 11, the one way to build it: the
    base-64 UNet (1 channel in and out) in ``compute_dtype`` with weights
    from ``seed``, ``SyntheticSliceDataset(64, 256, 1)`` to train on and
    40 more slices to evaluate, batch 32, AdamW at bench.py's rate (1e-3),
    the other ``TrainingArguments`` at their defaults unless given."""

    def __init__(self, seed: int, workdir: str):
        from mdeical_image_segmentation_tpu_torch.data import (
            SyntheticSliceDataset,
        )

        self.seed, self.workdir = seed, workdir
        self.train_ds = SyntheticSliceDataset(64, 256, 1, seed=seed)
        self.eval_ds = SyntheticSliceDataset(40, 256, 1, seed=seed + 7)

    def trainer(self, name: str, compute_dtype: str = "bfloat16", **kw):
        import torch

        from mdeical_image_segmentation_tpu_torch.models import (
            UNetConfig,
            UNetModel,
        )
        from mdeical_image_segmentation_tpu_torch.train import (
            Trainer,
            TrainingArguments,
        )

        model = UNetModel(
            UNetConfig(in_channels=1, out_channels=1, unet_type="UNet",
                       base_features=64, compute_dtype=compute_dtype),
            device="cuda", generator=torch.Generator().manual_seed(self.seed))
        args = TrainingArguments(**{
            "output_dir": os.path.join(self.workdir, name),
            "per_device_train_batch_size": TRAIN_BATCH_2D,
            "per_device_eval_batch_size": TRAIN_BATCH_2D,
            "learning_rate": 1e-3, "seed": self.seed, "logging_steps": 5,
            **kw})
        return Trainer(model, args, self.train_ds, self.eval_ds,
                       device="cuda")


def _instrument_2d(trainer, rec, evals):
    """Wrap the 2D trainer's step (synchronised ms, kernel-1 launches, the
    loss, the pre-clip grad norm of the update) and its eval forward
    (kernel-1 launches per eval batch)."""
    import torch

    from mdeical_image_segmentation_tpu_torch.ops import fused_conv

    step_fn, eval_fn = trainer._train_step, trainer._eval_forward

    def count():  # inside plain_path the plain version stands in: 0
        return getattr(fused_conv.fused_double2d, "launches", 0)

    def step(images, labels):
        torch.cuda.synchronize()
        before, t0 = count(), time.perf_counter()
        loss = step_fn(images, labels)
        torch.cuda.synchronize()
        rec.append({"ms": (time.perf_counter() - t0) * 1e3,
                    "loss": loss.item(),
                    "grad_norm": trainer.last_grad_norm.item(),
                    "launches": count() - before})
        return loss

    def eval_forward(batch):
        before = count()
        out = eval_fn(batch)
        evals.append(count() - before)
        return out

    trainer._train_step, trainer._eval_forward = step, eval_forward


def _profile_2d(trainer, steps: int = 3):
    """Device time of ``steps`` train steps on one device batch, grouped:
    the port's conv core (kernel 1), cuDNN (the conv backward; on the plain
    path the forward too), the rest; wall and busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mdeical_image_segmentation_tpu_torch.data import SliceCollator

    batch = SliceCollator()([trainer.train_dataset[i]
                             for i in range(TRAIN_BATCH_2D)])
    images = torch.from_numpy(batch["images"]).cuda()
    labels = torch.from_numpy(batch["labels"]).cuda()
    step = type(trainer)._train_step.__get__(trainer)  # not instrumented
    for _ in range(2):
        step(images, labels)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(images, labels)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    groups = {"kernel 1 (conv core)": 0.0, "cuDNN": 0.0, "the rest": 0.0}
    times = device_times(prof)
    for k, ms in times.items():
        g = ("kernel 1 (conv core)" if CONV_CORE.search(k) else
             "cuDNN" if CUDNN.search(k) else "the rest")
        groups[g] += ms / steps
    busy = sum(groups.values())
    top = sorted(times.items(), key=lambda kv: -kv[1])[:8]
    return groups, busy, wall, [(k[:60], v / steps) for k, v in top]


def phase_train_unet2d(seed: int, workdir: str):
    """The base-64 bf16 UNet at 256², batch 32, through Trainer.train():
    augmentation on, evaluation and checkpoints at steps 5 and 10; then the
    plain path; then 3 steps of each path from the same weights and
    batches, augmentation off, fp32 and bf16.  Returns the kernel-1
    launches of the main run and the numbers to print."""
    import numpy as np
    import torch

    from mdeical_image_segmentation_tpu_torch.models import UNetModel
    from mdeical_image_segmentation_tpu_torch.ops import fused_conv

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    setup = UNet2DTraining(seed, workdir)
    main_kw = dict(max_steps=TRAIN_STEPS_2D, eval_steps=5, save_steps=5,
                   save_total_limit=2, augment=True)
    trainer = setup.trainer("unet2d_train", **main_kw)
    log(f"[phase 11] UNet base 64, bf16 compute, fp32 master weights, 256², "
        f"batch {TRAIN_BATCH_2D}; {len(setup.train_ds)} train and "
        f"{len(setup.eval_ds)} eval slices; {trainer.args}")
    rec, evals = [], []
    _instrument_2d(trainer, rec, evals)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_conv.fused_double2d.launches = 0
    t0 = time.perf_counter()
    out = trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fused_conv.fused_double2d.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    for i, r in enumerate(rec):
        log(f"  step {i + 1}: {r['ms']:.2f} ms, loss {r['loss']:.6f}, grad "
            f"norm {r['grad_norm']:.4e}, kernel-1 launches {r['launches']}")
    bad = [i + 1 for i, r in enumerate(rec)
           if r["launches"] != 18 or not np.isfinite(r["loss"])]
    # 2 evaluations x 2 passes (the mean threshold, then the sums) x 2
    # batches (32 and a tail of 8)
    if (bad or len(rec) != TRAIN_STEPS_2D or len(evals) != 8
            or any(n != 18 for n in evals)
            or launches != 18 * (len(rec) + len(evals))):
        raise AssertionError(
            f"steps {bad} off; {len(rec)} steps, eval batches {evals}, "
            f"{launches} launches: want {TRAIN_STEPS_2D} steps and 8 eval "
            "batches of 18 launches each, finite losses")
    ckpts = sorted(d for d in os.listdir(trainer.args.output_dir)
                   if d.startswith("checkpoint-"))
    if ckpts != ["checkpoint-10", "checkpoint-5"]:
        raise AssertionError(f"checkpoints {ckpts}")
    reloaded = UNetModel.from_pretrained(
        os.path.join(trainer.args.output_dir, "checkpoint-10"), device="cuda")
    for (k, a), (_, b) in zip(reloaded.state_dict().items(),
                              trainer.model.state_dict().items()):
        if not torch.equal(a, b):
            raise AssertionError(f"checkpoint-10 reloads {k} differently")
    metrics = trainer.evaluate()
    if not all(np.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"eval metrics {metrics}")
    steady = statistics.median(r["ms"] for r in rec[2:])
    log(f"  train(): {len(rec)} steps + 2 evaluations in {wall:.2f} s; "
        f"training_loss {out.training_loss:.6f}; eval {metrics}; "
        f"checkpoints {ckpts} (checkpoint-10 reloads equal)")
    groups, busy, prof_wall, top = _profile_2d(trainer)
    del trainer, reloaded
    torch.cuda.empty_cache()

    # the plain path: the same run with kernel 1's plain version (cuDNN)
    with plain_path():
        plain = setup.trainer("unet2d_plain", max_steps=TRAIN_STEPS_2D,
                              eval_strategy="no", save_steps=0, augment=True)
        plain_rec = []
        _instrument_2d(plain, plain_rec, [])
        torch.cuda.reset_peak_memory_stats()
        plain.train()
        plain_peak = torch.cuda.max_memory_allocated() / 2**30
        p_groups, p_busy, p_wall, p_top = _profile_2d(plain)
    del plain
    torch.cuda.empty_cache()
    plain_steady = statistics.median(r["ms"] for r in plain_rec[2:])
    log(f"[phase 11] train step (median of steps 3-{TRAIN_STEPS_2D}, "
        f"synchronised): kernel path {steady:.2f} ms = "
        f"{TRAIN_BATCH_2D / steady * 1e3:.1f} slices/s, peak "
        f"{peak:.2f} GiB; plain path {plain_steady:.2f} ms = "
        f"{TRAIN_BATCH_2D / plain_steady * 1e3:.1f} slices/s, peak "
        f"{plain_peak:.2f} GiB")
    for label, g, b, w, t in (("kernel", groups, busy, prof_wall, top),
                              ("plain", p_groups, p_busy, p_wall, p_top)):
        log(f"[phase 11] profiled {label} step (3 steps, one batch): "
            + ", ".join(f"{k} {v:.2f} ms" for k, v in g.items())
            + f"; device busy {b:.2f} of {w:.2f} ms wall ({100 * b / w:.1f}%)")
        log("    largest: " + "; ".join(f"{k} {v:.2f}" for k, v in t))

    # kernel path vs plain path from the same weights and batches, 3 steps,
    # augmentation off, fp32 (TF32 off) and bf16
    cmp_kw = dict(max_steps=3, eval_strategy="no", save_steps=0,
                  augment=False)
    gaps = {}
    for dtype, tols, norm_tol in (("float32", LOSS_TOLS, GRAD_NORM_TOL),
                                  ("bfloat16", BF16_LOSS_TOLS,
                                   BF16_GRAD_NORM_TOL)):
        runs = []
        for plain_run in (False, True):
            ctx = plain_path() if plain_run else contextlib.nullcontext()
            with ctx:
                t = setup.trainer(f"cmp_{dtype}_{int(plain_run)}", dtype,
                                  **cmp_kw)
                r = []
                _instrument_2d(t, r, [])
                t.train()
            runs.append(r)
            del t
            torch.cuda.empty_cache()
        k_rec, p_rec = runs
        rels = [abs(k["loss"] - p["loss"]) / abs(p["loss"])
                for k, p in zip(k_rec, p_rec)]
        norm_rel = (abs(k_rec[0]["grad_norm"] - p_rec[0]["grad_norm"])
                    / p_rec[0]["grad_norm"])
        for i, (k, p) in enumerate(zip(k_rec, p_rec)):
            log(f"  {dtype} step {i + 1}: loss kernel {k['loss']:.7f} plain "
                f"{p['loss']:.7f} (rel {rels[i]:.2e}, limit {tols[i]}); ms "
                f"kernel {k['ms']:.1f} plain {p['ms']:.1f}")
        log(f"  {dtype} grad norm after step 1: kernel "
            f"{k_rec[0]['grad_norm']:.7e} plain {p_rec[0]['grad_norm']:.7e} "
            f"(rel {norm_rel:.2e}, limit {norm_tol})")
        if any(r > t for r, t in zip(rels, tols)) or norm_rel > norm_tol:
            raise AssertionError(f"2D training, {dtype}, kernel path vs plain "
                                 f"path: losses {rels}, grad norm {norm_rel}"
                                 " beyond the limits")
        gaps[dtype] = (rels, norm_rel)
    return {"launches": launches, "steady": steady,
            "plain_steady": plain_steady, "peak": peak,
            "plain_peak": plain_peak, "gaps": gaps}


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
    max_err, ms, plain_ms, dc_bound = phase_kernels(SEED)
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
    train_shapes = _training_shapes(SEED)
    k3d = phase_kernels_3d(SEED, shapes, train_shapes)
    log(f"[phase 6] wall {time.time() - t_phase:.1f} s")

    t_phase = time.time()
    log(f"[phase 7] GroupNorm backward kernels at the training shapes: "
        f"{len(train_shapes['gn'])} GroupNorm inputs of UNet3D (80x170x170) "
        f"and ResidualUNet3D (64x128x128)")
    k3d.update(phase_gn_backward_kernels(SEED, train_shapes))
    log(f"[phase 7] wall {time.time() - t_phase:.1f} s")
    t_phase = time.time()
    log("[phase 8] gradients through gcr_fused_conv and GroupNorm vs "
        "autograd through the plain composition (TF32 off)")
    phase_train_forward_convs(SEED, train_shapes)
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
        t_phase = time.time()
        log("[phase 11] 2D training: kernel 1 at the training batch, "
            "double_conv2d's gradients, Trainer.train() of the base-64 bf16 "
            "UNet at 256²")
        dc_train = phase_dc_training_batch(SEED)
        train2d = phase_train_unet2d(SEED, workdir)
        log(f"[phase 11] 2D training ok; wall {time.time() - t_phase:.1f} s")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    if train2d["launches"] == 0:
        raise AssertionError("double_conv2d was never launched in training")

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
    log(f"2D training: kernel-1 launches {train2d['launches']} (serving "
        f"{launches}); step {train2d['steady']:.2f} ms kernel path, "
        f"{train2d['plain_steady']:.2f} ms plain path; peak "
        f"{train2d['peak']:.2f} / {train2d['plain_peak']:.2f} GiB; "
        f"kernel-vs-plain loss gaps {train2d['gaps']}")
    kernels = [{
        "name": "double_conv2d",
        "route": "cuda",
        "source": "mdeical_image_segmentation_tpu_torch/csrc/double_conv2d.cu",
        "replaces": "mdeical_image_segmentation_tpu/ops/fused_conv.py:420",
        # served batches (phase 2) and Trainer.train() (phase 11)
        "launches": launches + train2d["launches"],
        "launches_by_path": {"serve_2d": launches,
                             "train_2d": train2d["launches"]},
        "max_abs_err": max(max_err, dc_train["max_abs_err"]),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": dc_bound,
        "bound_by": "operations",
        # the plain version is the library's: two cuDNN conv2d + relu
        "library_ms": plain_ms,
        "device_ms": None,
        # the 9 shapes at the training batch (N=32, bf16, z written)
        "train": {k: (None if isinstance(v, float) and math.isnan(v) else v)
                  for k, v in dc_train.items()},
    }] + [{
        "name": k,
        "route": "cuda",
        "source": f"mdeical_image_segmentation_tpu_torch/csrc/{sources[k]}",
        "replaces": f"mdeical_image_segmentation_tpu/{replaces[k]}",
        "launches": launches_3d[k],
        "max_abs_err": k3d[k]["err"],
        "ms": k3d[k]["ms"],
        "plain_ms": k3d[k]["plain_ms"],
        "bound_ms": k3d[k]["bound_ms"],
        "bound_by": ("operations" if k3d[k]["op_ms"] >= k3d[k]["byte_ms"]
                     else "bytes"),
        "library_ms": k3d[k]["library_ms"],
        # torch.profiler's device time over the same shapes, where measured
        "device_ms": (None if k3d[k]["device_ms"] is None
                      or math.isnan(k3d[k]["device_ms"])
                      else k3d[k]["device_ms"]),
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

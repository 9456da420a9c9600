"""Where the time of one 3D training step and of the 3D predictors' batches
goes on the card, and how far the kernel path's first losses drift from the
plain path's: the PyTorch port's UNetTrainer on the UNet3D of
configs/unet3d_train.yml (f_maps 64, batch 1, 80x170x170 patch, fp32, TF32
off), built by ``chip_smoke.UNet3DTraining`` exactly as ``chip_smoke.py``
phase 9 builds it, and the sliding-window predictor of phases 3 and 4.

    python3 chip_train_step.py [--steps 3] [--dtype bfloat16] [--predictors]
                               [--loss-seeds 0 1 2 3] [--tf32]

Needs one CUDA card and the checkout it sits in; imports nothing of JAX.

Profile (``--steps`` > 0): two warm-up steps, then ``--steps`` steps under
``torch.profiler`` on the kernel path and on the plain path, with the
model in ``--dtype`` (float32, or bfloat16: ``chip_smoke.py`` phase 15's
bf16 cell, fp32 master weights); per step, the
device time of each group of kernels (self CUDA time summed by kernel
name), the device busy time against the wall time, and the 12 largest
kernels.  Groups: the port's conv core (``conv_halo_kernel`` /
``conv_gather_kernel``: kernel 2's forward), the GroupNorm kernels
(``gn_*``), cuDNN / cuBLAS convolutions and GEMMs (the conv backward, and
on the plain path the forward too), everything else.

Predictors (``--predictors``): the UNet3D of configs/unet3d_predict.yml
(80x340x510 volume, 2 batches of 4) and the ResidualUNet3D of phase 4
(48x192x288, 2 batches of 4), each through
``StandardPredictor._device_accumulate`` once cold (its wall time
printed) and once under ``torch.profiler``, on the plain path and then
the kernel path: per batch,
the device time of each group (the overlap-add kernel too) against the
wall time of the whole pass (host batch assembly, copies and the final
fetch of the maps included), and the largest kernels.

Loss drift (``--loss-seeds``): for each seed, phase 9's setup from that seed
trained for 5 steps through ``UNetTrainer.fit()``: kernel path, plain
path, each again, and the plain path once more for each size p in
``PERTURB``, from initial weights scaled by 1 + p or 1 - p (a seeded
random sign; the kernel's relative forward error against cuDNN fp32 lies
between the two sizes).  Prints each step's losses, the relative gaps kernel
vs plain, kernel vs kernel and plain vs plain (cuDNN's weight gradient is
not deterministic) and each perturbed run vs plain, and whether every run
saw the same input patch: the kernel's gap read against the run-to-run
noise and against how far perturbations of its size carry the plain path.

TF32 (``--tf32``): what torch's default precision does to the fp32 legs
of ``chip_smoke.py`` phases 9 and 13.  torch lets cuDNN convolutions use
TF32 unless told otherwise (``torch.backends.cudnn.allow_tf32`` is True,
``torch.backends.cuda.matmul.allow_tf32`` False).  Each leg trains 3
steps with TF32 off, again with TF32 off (the run-to-run noise: cuDNN's
weight gradient is not deterministic), and with torch's defaults, from
the same weights on the same batches: phase 9's setup on the kernel path
and on the plain path, and phase 13's (``configs/unet3d_train.yml``
through ``create_trainer`` on its seeded gzip HDF5 volumes, no loader
threads and the transforms' seeds drawn afresh, so that each run sees the
same patches).  Prints each step's loss and the step-1 global grad norm,
the gaps of the default run and of the second TF32-off run against the
first, beside phase 9's limits (``chip_smoke.LOSS_TOLS``,
``GRAD_NORM_TOL``), and the median step ms of each mode.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import re
import subprocess
import sys
import tempfile
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (helpers only; it runs nothing on import)

GROUPS = (
    ("overlap-add kernel (4)", re.compile(r"overlap_add_kernel")),
    ("port conv core (kernel 2 forward)", re.compile(r"conv_(halo|gather)_kernel")),
    ("GroupNorm kernels (3a-3d)", re.compile(r"\bgn_\w*kernel")),
    ("cuDNN / cuBLAS conv and GEMM", re.compile(
        r"cudnn|xmma|dgrad|wgrad|fprop|implicit|conv|gemm|cutlass|sm90_|sm80_",
        re.I)),
)
# (title, plain path, relative weight perturbation)
RUNS = (("kernel", False, 0.0), ("plain", True, 0.0),
        ("kernel again", False, 0.0), ("plain again", True, 0.0))
PERTURB = (1e-6, 1e-5)
LOSS_STEPS = 5


def _group(name: str) -> str:
    for label, pat in GROUPS:
        if pat.search(name):
            return label
    return "everything else"


def _profile(trainer, steps: int):
    import torch
    from torch.profiler import ProfilerActivity, profile

    def device_batches():
        while True:  # epochs of the training loader, copied one ahead
            yield from trainer._device_batches(trainer.loaders["train"])

    batches = device_batches()

    def step():
        input, target, weight = next(batches)
        trainer._train_step(input, target, weight)

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return chip_smoke.device_times(prof), wall


def _predictor_setup(name: str):
    """(model, predictor config, volume, slices, batch size) of
    ``chip_smoke.py`` phase 3 (UNet3D) or 4 (ResidualUNet3D), the weights
    from the same seed."""
    import torch

    from mdeical_image_segmentation_tpu_torch.models import get_model

    cfg = chip_smoke.read_yaml_subset(chip_smoke.PREDICT_YML)
    if name == "UNet3D":
        model_cfg, slices = cfg["model"], cfg["loaders"]["test"]["slice_builder"]
        volume, seed = chip_smoke.VOLUME_3D, chip_smoke.SEED
    else:
        model_cfg, slices = chip_smoke.RESIDUAL_MODEL, chip_smoke.RESIDUAL_SLICES
        volume, seed = chip_smoke.VOLUME_RESIDUAL, chip_smoke.SEED + 1
    model = get_model(model_cfg, generator=torch.Generator().manual_seed(seed))
    model = model.to("cuda").eval()
    config = {"model": model_cfg, "predictor": cfg["predictor"]}
    return (model, config, chip_smoke.seeded_volume(volume, seed), slices,
            cfg["loaders"]["batch_size"])


def _profile_predictor(name: str):
    """Device time by kernel name and wall ms of one steady pass of the
    sliding-window predictor over the volume, the wall ms of the pass
    before it (the first of the process on this path), and the batch
    count."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mdeical_image_segmentation_tpu_torch.data.volume_utils import (
        padded_patch_batches,
    )
    from mdeical_image_segmentation_tpu_torch.infer import get_predictor

    model, config, raw, slices, batch = _predictor_setup(name)
    pred = get_predictor(model, None, config)
    batches = list(padded_patch_batches(raw, slices, batch))

    def run():
        pred._device_accumulate(iter(batches), raw.shape,
                                slices["halo_shape"])

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()  # cold: cuDNN's algorithms chosen, the allocator's blocks taken
    torch.cuda.synchronize()
    cold = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    del model, pred
    torch.cuda.empty_cache()
    return chip_smoke.device_times(prof), wall, cold, len(batches)


def _report(title: str, by_name, wall: float, steps: int,
            unit: str = "step") -> None:
    groups = defaultdict(float)
    for name, ms in by_name.items():
        groups[_group(name)] += ms
    busy = sum(by_name.values())
    print(f"== {title}: {steps} x {unit}, per {unit}: wall "
          f"{wall / steps:.1f} ms, device busy {busy / steps:.1f} ms "
          f"({100 * busy / wall:.1f}%)")
    for label, _ in GROUPS + (("everything else", None),):
        print(f"   {label:40s} {groups[label] / steps:9.1f} ms")
    print(f"   largest kernels (ms per {unit}):")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"     {ms / steps:9.2f}  {name[:110]}")


def _recorded_fit(trainer, steps: int):
    """``trainer.fit()`` recording each step's loss, a fingerprint (the
    sum) of its input patch and synchronised ms, and the global grad norm
    after step 1."""
    import torch

    losses, inputs, ms, norm = [], [], [], []
    step = trainer._train_step

    def recorded(input, target, weight):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, output = step(input, target, weight)
        losses.append(loss.item())
        ms.append((time.perf_counter() - t0) * 1e3)
        inputs.append(input.double().sum().item())
        if not norm:
            norm.append(torch.sqrt(sum(
                p.grad.double().square().sum()
                for p in trainer.model.parameters()
                if p.grad is not None)).item())
        return loss, output

    trainer._train_step = recorded
    trainer.fit()
    if len(losses) < steps:
        raise AssertionError(f"{len(losses)} steps, want {steps}")
    return losses[:steps], inputs[:steps], ms[:steps], norm[0]


def _losses(setup, name: str, steps: int, perturb: float = 0.0):
    """The losses of the first ``steps`` steps of ``fit()``, and a
    fingerprint (the sum) of each step's input patch.  ``perturb`` > 0
    scales every initial weight by 1 + perturb or 1 - perturb (a seeded
    random sign)."""
    import torch

    trainer = setup.trainer(name, max_num_iterations=steps - 1,
                            validate_after_iters=1000, log_after_iters=1000)
    if perturb:
        gen = torch.Generator(device="cuda").manual_seed(setup.seed)
        with torch.no_grad():
            for p in trainer.model.parameters():
                sign = torch.randint(0, 2, p.shape, device=p.device,
                                     generator=gen) * 2.0 - 1.0
                p.mul_(1.0 + perturb * sign)
    losses, inputs, _, _ = _recorded_fit(trainer, steps)
    return losses, inputs


def _loss_drift(seeds, steps: int, perturbs, work: str) -> None:
    import torch

    limits = chip_smoke.LOSS_TOLS
    for seed in seeds:
        setup = chip_smoke.UNet3DTraining(seed, os.path.join(work, f"s{seed}"))
        runs, inputs = {}, {}
        perturbed = [f"plain x(1+-{p:g})" for p in perturbs]
        cases = RUNS + tuple((t, True, p) for t, p in zip(perturbed, perturbs))
        for title, plain, perturb in cases:
            with chip_smoke.plain_path() if plain else contextlib.nullcontext():
                runs[title], inputs[title] = _losses(
                    setup, re.sub(r"\W+", "_", title), steps,
                    perturb)
            torch.cuda.empty_cache()

        def rel(a, b, i):
            return abs(runs[a][i] - runs[b][i]) / abs(runs[b][i])

        print(f"== loss drift, seed {seed}, {steps} steps (phase 9's limits "
              f"for steps 1-{len(limits)}: {limits}); relative loss gaps")
        print(f"   {'step':>4s} {'kernel':>11s} {'plain':>11s} "
              f"{'kernel-plain':>13s} {'kernel-kernel':>14s} "
              f"{'plain-plain':>12s}"
              + "".join(f" {t:>16s}" for t in perturbed) + "  same input")
        for i in range(steps):
            same = len({inputs[t][i] for t, _, _ in cases}) == 1
            print(f"   {i + 1:4d} {runs['kernel'][i]:11.7f} "
                  f"{runs['plain'][i]:11.7f} "
                  f"{rel('kernel', 'plain', i):13.2e} "
                  f"{rel('kernel again', 'kernel', i):14.2e} "
                  f"{rel('plain again', 'plain', i):12.2e}"
                  + "".join(f" {rel(t, 'plain', i):16.2e}" for t in perturbed)
                  + f"  {same}")
        del setup


TF32_STEPS = 3
# (title, TF32 allowed): torch's default lets cuDNN use TF32, not cuBLAS
TF32_MODES = (("TF32 off", False), ("TF32 off again", False),
              ("torch default (cuDNN TF32)", True))


def _set_tf32(on: bool) -> None:
    import torch

    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = False


def _config_trainer(work: str, name: str):
    """Phase 13's trainer: ``configs/unet3d_train.yml`` through
    ``create_trainer`` on seeded gzip HDF5 volumes, with no loader threads
    and the transforms' seeds drawn anew from the generator's first state,
    so that every run takes the same patches in the same order."""
    from mdeical_image_segmentation_tpu_torch.configs import load_config
    from mdeical_image_segmentation_tpu_torch.train import trainer3d
    from mdeical_image_segmentation_tpu_torch.transforms import volume

    paths = {}
    for phase, shape, seed in (("train", chip_smoke.H5_TRAIN_VOLUME, 4),
                               ("val", chip_smoke.H5_VAL_VOLUME, 5)):
        paths[phase] = os.path.join(work, f"{phase}_volume.h5")
        if not os.path.exists(paths[phase]):
            raw = chip_smoke.seeded_volume(shape, chip_smoke.SEED + seed)
            chip_smoke.write_h5_volume(paths[phase], raw,
                                       chip_smoke.foreground_label(raw))
    config = load_config([
        "--config", chip_smoke.TRAIN_YML,
        "--loaders.train.file_paths", repr([paths["train"]]),
        "--loaders.val.file_paths", repr([paths["val"]]),
        "--loaders.num_workers", "0",
        "--trainer.checkpoint_dir", os.path.join(work, name),
        "--trainer.max_num_iterations", str(TF32_STEPS - 1),
        "--trainer.validate_after_iters", "1000",
        "--trainer.log_after_iters", "1000"])
    volume.GLOBAL_RANDOM_STATE.seed(47)
    return trainer3d.create_trainer(config)


def _tf32(work: str) -> None:
    import statistics

    import torch

    setup = chip_smoke.UNet3DTraining(chip_smoke.SEED,
                                      os.path.join(work, "tf32"))
    legs = (("phase 9, kernel path", False),
            ("phase 9, plain path", True), ("phase 13", None))
    limits = chip_smoke.LOSS_TOLS
    for leg, plain in legs:
        runs = {}
        for title, on in TF32_MODES:
            _set_tf32(on)
            name = re.sub(r"\W+", "_", f"{leg} {title}")
            with (chip_smoke.plain_path() if plain
                  else contextlib.nullcontext()):
                trainer = (_config_trainer(work, name) if plain is None
                           else setup.trainer(
                               name, max_num_iterations=TF32_STEPS - 1,
                               validate_after_iters=1000,
                               log_after_iters=1000))
                runs[title] = _recorded_fit(trainer, TF32_STEPS)
            del trainer
            torch.cuda.empty_cache()
        _set_tf32(False)
        ref = runs[TF32_MODES[0][0]]
        print(f"== TF32, {leg}: {TF32_STEPS} steps from the same weights; "
              f"loss gaps against the first TF32-off run, limits {limits}; "
              f"grad norm after step 1, limit {chip_smoke.GRAD_NORM_TOL}")
        for title, _ in TF32_MODES:
            losses, inputs, ms, norm = runs[title]
            gaps = [abs(a - b) / abs(b) for a, b in zip(losses, ref[0])]
            out = [g > t for g, t in zip(gaps, limits)]
            norm_gap = abs(norm - ref[3]) / ref[3]
            print(f"   {title:28s} losses "
                  + " ".join(f"{v:.7f}" for v in losses)
                  + " gaps " + " ".join(f"{g:.2e}" for g in gaps)
                  + f" grad norm {norm:.7e} gap {norm_gap:.2e}"
                  + f" outside: losses {sum(out)}, norm "
                  f"{norm_gap > chip_smoke.GRAD_NORM_TOL}; step ms median "
                  f"{statistics.median(ms[1:]):.1f}; same inputs "
                  f"{inputs == ref[1]}")
    del setup


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=3,
                    help="profiled steps per path (0: no profile)")
    ap.add_argument("--dtype", choices=("float32", "bfloat16"),
                    default="float32",
                    help="compute dtype of the profiled training step")
    ap.add_argument("--predictors", action="store_true",
                    help="profile the UNet3D and ResidualUNet3D predictors")
    ap.add_argument("--loss-seeds", type=int, nargs="*", default=[],
                    help="seeds of phase 9's setup for the loss drift")
    ap.add_argument("--tf32", action="store_true",
                    help="phases 9 and 13's fp32 legs under torch's default "
                    "TF32 against TF32 off")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_train_step: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(torch.cuda.get_device_name(0), subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip())
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as work:
        if args.steps > 0:
            setup = chip_smoke.UNet3DTraining(chip_smoke.SEED, work)
            setup.model_cfg = {**setup.model_cfg, "dtype": args.dtype}
            for title, plain, _ in RUNS[:2]:
                with (chip_smoke.plain_path() if plain
                      else contextlib.nullcontext()):
                    trainer = setup.trainer(f"profile_{title}",
                                            max_num_iterations=100)
                    by_name, wall = _profile(trainer, args.steps)
                    _report(f"{title} path, {args.dtype}", by_name, wall,
                            args.steps)
                    del trainer
                    torch.cuda.empty_cache()
            del setup
        if args.predictors:
            # the plain path first (chip_smoke.py runs the kernel path
            # first): whichever runs first pays the process's cold start
            for name in ("UNet3D", "ResidualUNet3D"):
                for title, plain, _ in RUNS[1::-1]:
                    with (chip_smoke.plain_path() if plain
                          else contextlib.nullcontext()):
                        by_name, wall, cold, n = _profile_predictor(name)
                    _report(f"{name} predictor, {title} path", by_name, wall,
                            n, unit="batch")
                    print(f"   the pass before (cold): {cold:.1f} ms, "
                          f"{cold / n:.1f} ms per batch")
        if args.loss_seeds:
            _loss_drift(args.loss_seeds, LOSS_STEPS, PERTURB, work)
        if args.tf32:
            _tf32(work)
    return 0


if __name__ == "__main__":
    sys.exit(main())

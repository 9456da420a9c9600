"""The port's 2D ``Trainer`` (``train/trainer2d.py``) against the JAX
package's on a one-device CPU mesh: the same bridged initial weights, the
same synthetic batches in the same order, augmentation off, warmup and
clipping on, and once with two accumulation steps.  Per-step losses agree
within 1e-4 relative (LOSS_TOL, as the 3D trainer's test: AdamW turns
last-digit differences of the gradients into small weight differences
that grow step by step), ``evaluate()`` within 1e-5 (EVAL_TOL).  Then the
bundles each side saves load in the other, checkpoint rotation, the CLI,
and the port-only paths (device-resident data, augmentation, callbacks,
preemption)."""

import json
import os
import signal

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mdeical_image_segmentation_tpu.data import (
    SyntheticSliceDataset as JaxSynthetic,
)
from mdeical_image_segmentation_tpu.data.collate import (
    SliceCollator as JaxCollator,
)
from mdeical_image_segmentation_tpu.models import UNetConfig as JaxUNetConfig
from mdeical_image_segmentation_tpu.models import UNetModel as JaxUNetModel
from mdeical_image_segmentation_tpu.parallel import mesh as jax_mesh
from mdeical_image_segmentation_tpu.train import (
    TrainerCallback as JaxCallback,
)
from mdeical_image_segmentation_tpu.train import Trainer as JaxTrainer
from mdeical_image_segmentation_tpu.train import (
    TrainingArguments as JaxArgs,
)
from mdeical_image_segmentation_tpu_torch.cli import train2d as cli
from mdeical_image_segmentation_tpu_torch.data import SyntheticSliceDataset
from mdeical_image_segmentation_tpu_torch.models import UNetConfig, UNetModel
from mdeical_image_segmentation_tpu_torch.train import (
    BestIoUCallback,
    Trainer,
    TrainerCallback,
    TrainingArguments,
)
from mdeical_image_segmentation_tpu_torch.train.trainer2d import (
    linear_schedule,
)
from mdeical_image_segmentation_tpu_torch.utils.param_bridge import (
    state_dict_to_flax,
)

LOSS_TOL = 1e-4
EVAL_TOL = 1e-5
RES = 32
MODEL_KW = dict(in_channels=1, out_channels=1, unet_type="UNet",
                base_features=4)
# 10 train slices in batches of 3 (drop-last: 3 a epoch, so 6 steps cross
# an epoch boundary); 5 eval slices in batches of 2 (a wrap-padded tail)
ARGS = dict(max_steps=6, per_device_train_batch_size=3,
            per_device_eval_batch_size=2, learning_rate=1e-3,
            warmup_ratio=0.4, max_grad_norm=0.05, weight_decay=0.01,
            logging_steps=1, eval_strategy="no", save_steps=0, augment=False,
            seed=3)


class _Losses:
    def __init__(self):
        self.losses = []

    def on_log(self, args, state, control, logs, **kw):
        self.losses.append(logs["loss"])

    def on_evaluate(self, *a, **kw):
        pass

    def on_step_end(self, *a, **kw):
        pass


class _JaxLosses(_Losses, JaxCallback):
    pass


class _PortLosses(_Losses, TrainerCallback):
    pass


def _port_model(seed=0):
    return UNetModel(UNetConfig(**MODEL_KW), device="cpu",
                     generator=torch.Generator().manual_seed(seed))


def _run(root, accum):
    """One JAX and one port training run from the same weights; returns
    (jax trainer, port trainer, jax losses, port losses)."""
    kw = dict(ARGS, gradient_accumulation_steps=accum)
    model = _port_model()
    params = state_dict_to_flax(model.module.state_dict())["params"]

    jcb = _JaxLosses()
    jt = JaxTrainer(JaxUNetModel(JaxUNetConfig(**MODEL_KW)),
                    JaxArgs(output_dir=str(root / f"jax{accum}"), **kw),
                    JaxSynthetic(10, RES), JaxSynthetic(5, RES, seed=7),
                    callbacks=[jcb],
                    mesh=jax_mesh.make_mesh(devices=jax.devices()[:1]))
    sample = JaxCollator()([jt.train_dataset[0]])["images"]
    jt._init_state(sample, jt._num_train_steps())
    jt.state = jt.state.replace(params=jax_mesh.replicate(
        jt.mesh, jax.tree_util.tree_map(jnp.asarray, params)))
    jt._compile_steps()
    jt.train()

    pcb = _PortLosses()
    pt = Trainer(model, TrainingArguments(output_dir=str(root / f"port{accum}"),
                                          **kw),
                 SyntheticSliceDataset(10, RES),
                 SyntheticSliceDataset(5, RES, seed=7), callbacks=[pcb],
                 device="cpu")
    pt.train()
    return jt, pt, jcb.losses, pcb.losses


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("trainer2d")
    return {accum: _run(root, accum) for accum in (1, 2)}


@pytest.mark.parametrize("accum", [1, 2])
def test_losses_match_jax(runs, accum):
    _, pt, want, got = runs[accum]
    assert len(got) == len(want) == 6
    np.testing.assert_allclose(got, want, rtol=LOSS_TOL)
    assert pt.state.step == 6 and pt.state.opt_step == 6 // accum
    # the losses change from step to step: the updates are not zero
    assert len(set(np.round(got, 6))) > 1


@pytest.mark.parametrize("accum", [1, 2])
def test_evaluate_matches_jax(runs, accum):
    """Two-pass streaming eval (the mean threshold, then the thresholded
    sums) with a wrap-padded tail batch."""
    jt, pt, _, _ = runs[accum]
    want, got = jt.evaluate(), pt.evaluate()
    assert set(got) == set(want) == {"eval_iou", "eval_dice", "eval_loss"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=EVAL_TOL,
                                   atol=EVAL_TOL, err_msg=k)


def test_fixed_threshold_single_pass_matches_jax(runs):
    jt, pt, _, _ = runs[1]
    jt.args.eval_threshold = pt.args.eval_threshold = 0.5
    try:
        want, got = jt.evaluate(), pt.evaluate()
    finally:
        jt.args.eval_threshold = pt.args.eval_threshold = None
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=EVAL_TOL,
                                   atol=EVAL_TOL, err_msg=k)


def test_bundles_load_in_the_other_package(runs, tmp_path):
    jt, pt, _, _ = runs[1]
    x = np.random.default_rng(0).random((2, RES, RES, 1), dtype=np.float32)
    pt.save_model(str(tmp_path / "port"))
    jm, variables = JaxUNetModel.from_pretrained(str(tmp_path / "port"))
    with torch.inference_mode():
        port_logits = pt.model(torch.from_numpy(x)).logits.numpy()
    np.testing.assert_allclose(
        np.asarray(jm.apply(variables, jnp.asarray(x)).logits), port_logits,
        rtol=1e-4, atol=1e-4)
    jt.save_model(str(tmp_path / "jax"))
    model = UNetModel.from_pretrained(str(tmp_path / "jax"), device="cpu")
    jm2, v2 = JaxUNetModel.from_pretrained(str(tmp_path / "jax"))
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).logits.numpy()
    np.testing.assert_allclose(got, np.asarray(jm2.apply(v2, jnp.asarray(x))
                                               .logits), rtol=1e-4, atol=1e-4)


def test_schedule_is_optax_warmup_then_decay(tmp_path):
    """linear 0 → lr over the warmup, then lr → 0; the first step at 0;
    without warmup the full rate first; under accumulation the schedule
    counts optimizer steps."""
    import optax

    for total, accum, ratio in ((6, 1, 0.4), (6, 2, 0.4), (7, 2, 0.0),
                                (100, 1, 0.1)):
        args = TrainingArguments(output_dir=str(tmp_path), max_steps=total,
                                 learning_rate=0.01, warmup_ratio=ratio,
                                 gradient_accumulation_steps=accum)
        t = Trainer(_port_model(), args, device="cpu")
        sched = t._build_schedule(total)
        opt_steps = -(-total // accum)
        warmup = int(ratio * opt_steps)
        if warmup:
            want = optax.join_schedules(
                [optax.linear_schedule(0.0, 0.01, warmup),
                 optax.linear_schedule(0.01, 0.0, max(opt_steps - warmup, 1))],
                [warmup])
        else:
            want = optax.linear_schedule(0.01, 0.0, max(opt_steps, 1))
        for c in range(opt_steps + 2):
            np.testing.assert_allclose(sched(c), float(want(c)), rtol=1e-6,
                                       atol=1e-9)
        assert (sched(0) == 0.0) == (warmup > 0)
    assert linear_schedule(1.0, 0.0, 4)(2) == 0.5


def test_clip_matches_optax_clip_by_global_norm(tmp_path):
    """×max_norm/norm when the norm reaches max_norm, no epsilon."""
    import optax

    model = _port_model()
    t = Trainer(model, TrainingArguments(output_dir=str(tmp_path),
                                         max_steps=1, max_grad_norm=0.01,
                                         learning_rate=0.0, warmup_ratio=0.0,
                                         weight_decay=0.0), device="cpu")
    t._init_state(1)
    rng = np.random.default_rng(0)
    grads = {n: rng.standard_normal(p.shape).astype(np.float32)
             for n, p in model.named_parameters()}
    for n, p in model.named_parameters():
        p.grad = torch.from_numpy(grads[n].copy())
    clipped = {}
    orig_step = t.state.optimizer.step
    t.state.optimizer.step = lambda: clipped.update(
        {n: p.grad.clone() for n, p in model.named_parameters()})
    try:
        t._apply_update()
    finally:
        t.state.optimizer.step = orig_step
    want, _ = optax.clip_by_global_norm(0.01).update(grads, None)
    for n in grads:
        np.testing.assert_allclose(clipped[n].numpy(), np.asarray(want[n]),
                                   rtol=1e-5, atol=1e-9)
    norm = np.sqrt(sum(np.square(g).sum() for g in grads.values()))
    np.testing.assert_allclose(float(t.last_grad_norm), norm, rtol=1e-5)


def test_checkpoints_rotate_and_reload(tmp_path):
    args = TrainingArguments(output_dir=str(tmp_path), max_steps=5,
                             per_device_train_batch_size=2, save_steps=1,
                             save_total_limit=2, eval_strategy="no",
                             logging_steps=2, augment=False)
    t = Trainer(_port_model(), args, SyntheticSliceDataset(6, RES),
                device="cpu")
    out = t.train()
    assert out.global_step == 5 and np.isfinite(out.training_loss)
    kept = sorted(d for d in os.listdir(tmp_path) if d.startswith("checkpoint"))
    assert kept == ["checkpoint-4", "checkpoint-5"]
    model = UNetModel.from_pretrained(str(tmp_path / "checkpoint-5"),
                                      device="cpu")
    for (k, a), (_, b) in zip(model.state_dict().items(),
                              t.model.state_dict().items()):
        assert torch.equal(a, b), k
    rows = [json.loads(l) for l in open(tmp_path / "logs" / "metrics.jsonl")]
    assert [r["step"] for r in rows if r["tag"] == "train/loss"] == [2, 4]


def test_resident_augmented_training_and_callbacks(tmp_path):
    """dataset_on_device: uint8 on the device, i.i.d. indices from the
    device generator; augmentation on; BestIoUCallback saves the model at
    an improvement; evaluation every epoch-equivalent."""
    args = TrainingArguments(output_dir=str(tmp_path), max_steps=4,
                             per_device_train_batch_size=2,
                             per_device_eval_batch_size=3,
                             eval_strategy="epoch", save_steps=0,
                             logging_steps=0, dataset_on_device=True,
                             augment=True, plot_eval=True)
    seen = []

    class Seen(TrainerCallback):
        def on_evaluate(self, args, state, control, metrics, **kw):
            seen.append(state.step)

    t = Trainer(_port_model(), args, SyntheticSliceDataset(4, RES),
                SyntheticSliceDataset(4, RES, seed=7),
                callbacks=[BestIoUCallback(), Seen()], device="cpu")
    out = t.train()
    assert out.global_step == 4 and np.isfinite(out.training_loss)
    assert seen == [2, 4]  # 4 samples / batch 2: an epoch is 2 steps
    assert os.path.exists(tmp_path / "config.json")  # the callback's save
    assert os.path.exists(tmp_path / "output.png")


def test_multiclass_eval_matches_the_host_metric(tmp_path):
    """C > 1: argmax macro IoU/Dice summed on the device equals the host
    metric over gathered logits; cross-entropy loss on (N, H, W) maps."""
    from mdeical_image_segmentation_tpu_torch.metrics import (
        compute_metrics_multiclass,
    )

    model = UNetModel(UNetConfig(**{**MODEL_KW, "out_channels": 3}),
                      device="cpu")
    ds = SyntheticSliceDataset(5, RES, seed=2, n_classes=3)
    args = TrainingArguments(output_dir=str(tmp_path),
                             per_device_eval_batch_size=2, plot_eval=True)
    t = Trainer(model, args, eval_dataset=ds, device="cpu")
    got = t.evaluate()
    images = torch.from_numpy(np.stack([ds[i]["image"] for i in range(5)]))
    labels = np.stack([ds[i]["mask"] for i in range(5)])
    with torch.inference_mode():
        out = model(images, torch.from_numpy(labels))
    want = compute_metrics_multiclass(out.logits.numpy(), labels)
    np.testing.assert_allclose(got["eval_iou"], want["iou"], rtol=1e-6)
    np.testing.assert_allclose(got["eval_dice"], want["dice"], rtol=1e-6)
    np.testing.assert_allclose(got["eval_loss"], float(out.loss), rtol=1e-5)


def test_compute_metrics_hook_gathers_logits(tmp_path):
    seen = {}

    def hook(logits, labels):
        seen["shape"] = (logits.shape, labels.shape)
        return {"iou": 0.25}

    t = Trainer(_port_model(), TrainingArguments(
        output_dir=str(tmp_path), per_device_eval_batch_size=2),
        eval_dataset=SyntheticSliceDataset(3, RES), compute_metrics=hook,
        device="cpu")
    metrics = t.evaluate()
    assert seen["shape"] == ((3, RES, RES, 1), (3, RES, RES, 1))
    assert metrics["eval_iou"] == 0.25 and np.isfinite(metrics["eval_loss"])


def test_preemption_handler_saves_and_stops(tmp_path):
    t = Trainer(_port_model(), TrainingArguments(output_dir=str(tmp_path)),
                device="cpu")
    old = signal.getsignal(signal.SIGUSR1)
    try:
        t.install_preemption_handler([signal.SIGUSR1])
        os.kill(os.getpid(), signal.SIGUSR1)
    finally:
        signal.signal(signal.SIGUSR1, old)
    assert t.control.should_save and t.control.should_stop


def test_unported_options_and_card_default_raise(monkeypatch, tmp_path):
    import inspect

    model = _port_model()
    out = dict(output_dir=str(tmp_path))
    for kw in (dict(tensor_parallel=True), dict(zero1=True)):
        with pytest.raises(NotImplementedError, match="item 25"):
            Trainer(model, TrainingArguments(**out, **kw), device="cpu")
    with pytest.raises(NotImplementedError, match="item 25"):
        Trainer(model, TrainingArguments(**out), mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="item 26"):
        Trainer(model, TrainingArguments(**out, profile_dir=str(tmp_path)),
                device="cpu")
    with pytest.raises(ValueError, match="eval_strategy"):
        TrainingArguments(eval_strategy="step")
    with pytest.raises(ValueError, match="float32 master weights"):
        Trainer(_port_model().for_inference(), TrainingArguments(**out),
                device="cpu")
    assert inspect.signature(Trainer.__init__).parameters[
        "device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(model, TrainingArguments(**out))


def test_arguments_match_jax_fields_and_defaults():
    import dataclasses

    want = {f.name: f.default for f in dataclasses.fields(JaxArgs)}
    got = {f.name: f.default for f in dataclasses.fields(TrainingArguments)}
    assert got == want


def test_cli_trains_on_the_cpu(tmp_path):
    out = cli.main(["--synthetic", "8", "--unet_type", "UNet",
                    "--resolution", str(RES), "--base_features", "4",
                    "--in_channels", "1", "--max_steps", "2",
                    "--eval_steps", "2", "--logging_steps", "1",
                    "--per_device_train_batch_size", "2",
                    "--output_dir", str(tmp_path), "--device", "cpu"])
    assert os.path.exists(os.path.join(out, "final", "params.msgpack"))
    assert os.path.exists(os.path.join(out, "output.png"))
    assert os.path.exists(os.path.join(out, "logs", "metrics.jsonl"))
    UNetModel.from_pretrained(os.path.join(out, "final"), device="cpu")


def test_cli_flags_match_the_jax_cli():
    from mdeical_image_segmentation_tpu.cli import train2d as jax_cli

    import sys
    argv = sys.argv
    try:
        sys.argv = ["train2d"]
        want = vars(jax_cli.parse_args())
    finally:
        sys.argv = argv
    got = vars(cli.parse_args([]))
    assert len(want) == 30
    assert got.pop("device") == "cuda"
    assert got == want

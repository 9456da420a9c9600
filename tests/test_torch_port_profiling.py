"""The port's profiler tooling (``train/profiling.py``, the JAX package's
``train/profiling.py``, after ``tests/test_profiling.py``) and
``utils/viz.py``, on the CPU:

- ``trace`` writes a Chrome trace holding the traced ops and a
  ``ProfiledSection``'s name;
- ``StepTimer`` on the host clock: ``synced_lap``'s mean ms a step and
  ``summary``'s percentiles; on the card without one it raises;
- ``device_memory_summary`` lists no card on a machine without one;
- ``TrainingArguments.profile_dir`` traces steps ``profile_start_step``
  to ``+ profile_num_steps`` of ``Trainer.train()``;
- ``show`` and ``show_transform_grid`` write PNGs on matplotlib's Agg
  backend.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

from mdeical_image_segmentation_tpu_torch.data import SyntheticSliceDataset
from mdeical_image_segmentation_tpu_torch.models import UNetConfig, UNetModel
from mdeical_image_segmentation_tpu_torch.train import (
    Trainer,
    TrainingArguments,
)
from mdeical_image_segmentation_tpu_torch.train.profiling import (
    ProfiledSection,
    StepTimer,
    device_memory_summary,
    trace,
)
from mdeical_image_segmentation_tpu_torch.utils import viz


def _events(logdir):
    files = glob.glob(os.path.join(logdir, "trace_*.json"))
    assert len(files) == 1, files
    with open(files[0]) as f:
        return {e.get("name") for e in json.load(f)["traceEvents"]}


def test_trace_writes_a_chrome_trace_with_sections(tmp_path):
    logdir = str(tmp_path / "trace")
    x = torch.ones(64, 64)
    with trace(logdir) as where:
        assert where == logdir
        with ProfiledSection("forward"):
            (x @ x).sum().item()
    names = _events(logdir)
    assert "forward" in names
    assert any(n and n.startswith("aten::mm") for n in names)


def test_step_timer_on_the_host_clock():
    t = StepTimer(device="cpu")
    assert t.synced_lap() is None and t.summary() == {}
    for _ in range(5):
        t.tick()
    ms = t.synced_lap(torch.ones(3))
    assert ms is not None and ms >= 0
    for _ in range(3):
        t.tick()
    t.synced_lap()
    s = t.summary()
    assert set(s) == {"ms_per_step_mean", "ms_per_step_p50",
                      "ms_per_step_p90"}
    assert all(np.isfinite(v) and v >= 0 for v in s.values())
    assert len(t.synced_ms) == 2


def test_card_only_tools_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA card"):
        StepTimer()
    assert device_memory_summary() == []


def test_trainer_profile_dir(tmp_path):
    model = UNetModel(UNetConfig(in_channels=1, out_channels=1,
                                 unet_type="UNet", base_features=2),
                      device="cpu")
    args = TrainingArguments(
        output_dir=str(tmp_path / "out"), max_steps=5,
        per_device_train_batch_size=1, eval_strategy="no", logging_steps=0,
        save_steps=0, profile_dir=str(tmp_path / "prof"),
        profile_start_step=2, profile_num_steps=2)
    Trainer(model, args, SyntheticSliceDataset(n_samples=16, resolution=16),
            device="cpu").train()
    names = _events(str(tmp_path / "prof"))
    # the double conv's backward ran inside the traced steps
    assert any(n and "convolution" in n for n in names)


def test_viz_writes_pngs(tmp_path):
    ds = SyntheticSliceDataset(n_samples=2, resolution=16, channels=3)
    path = viz.show(ds, 1, str(tmp_path / "sample.png"))
    volume = np.random.default_rng(0).random((6, 8, 8)).astype(np.float32)
    grid = viz.show_transform_grid(
        volume, [lambda v: v[::-1], lambda v: np.stack([v > 0.5])],
        ["flip", "label"], str(tmp_path / "grid.png"))
    for p in (path, grid):
        with open(p, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"

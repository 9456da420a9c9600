"""The port's config-driven 3D entry points against the JAX package's, on
the CPU (``--device cpu``) and on files h5py writes:

- ``cli/train3d.py`` (``create_trainer``, the HDF5 loaders with
  ``configs/unet3d_train.yml``'s whole transformer pipeline, ``copy_config``)
  against the JAX ``cli/train3d.py`` from the same initial weights
  (``trainer.pre_trained``, a JAX-written checkpoint) and the same
  ``GLOBAL_RANDOM_STATE``: the logged losses of 3 steps within
  ``test_torch_port_trainer3d.py``'s ``LOSS_TOL`` (1e-4 relative);
- ``cli/predict3d.py`` on a JAX-written checkpoint against the JAX
  ``cli/predict3d.py``: ``<name>_predictions.h5`` within
  ``test_torch_port_predictor.py``'s ``TOL`` (1e-4), on the device and host
  accumulation paths; the argmax segmentation equal;
- the device rule: without ``device: cpu`` both entry points want the card
  and raise without one; a ``parallel:`` section raises naming its item."""

import json
import os

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdeical_image_segmentation_tpu.cli import predict3d as jax_predict3d
from mdeical_image_segmentation_tpu.cli import train3d as jax_train3d
from mdeical_image_segmentation_tpu.models import get_model as jax_get_model
from mdeical_image_segmentation_tpu.parallel import mesh as jax_mesh
from mdeical_image_segmentation_tpu.train import checkpoint as jax_ckpt
from mdeical_image_segmentation_tpu.train import optimizers as jax_opt
from mdeical_image_segmentation_tpu.train import trainer3d as jax_trainer3d
from mdeical_image_segmentation_tpu.transforms import volume as jax_volume
from mdeical_image_segmentation_tpu_torch.cli import predict3d, train3d
from mdeical_image_segmentation_tpu_torch.configs import load_config
from mdeical_image_segmentation_tpu_torch.train import checkpoint as ckpt
from mdeical_image_segmentation_tpu_torch.train import trainer3d
from mdeical_image_segmentation_tpu_torch.transforms import volume
from test_torch_port_predictor import TOL
from test_torch_port_trainer3d import LOSS_TOL

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_YML = os.path.join(REPO, "configs", "unet3d_train.yml")
PREDICT_YML = os.path.join(REPO, "configs", "unet3d_predict.yml")
SMALL_MODEL = ["--model.f_maps", "4", "--model.num_levels", "2",
               "--model.num_groups", "2"]


def _reset_global_states():
    volume.GLOBAL_RANDOM_STATE = np.random.RandomState(47)
    jax_volume.GLOBAL_RANDOM_STATE = np.random.RandomState(47)


def _write_volume(path, shape, seed, label=True):
    rng = np.random.default_rng(seed)
    raw = rng.standard_normal(shape).astype(np.float32)
    with h5py.File(path, "w") as f:
        f.create_dataset("raw", data=raw, compression="gzip", chunks=True)
        if label:
            f.create_dataset("label", data=(raw > -0.4).astype(np.uint8),
                             compression="gzip", chunks=True)
    return path


def _jax_checkpoint(model_cfg, root, patch, optimizer_cfg=None):
    """Weights from the JAX model's init, saved by the JAX package (with a
    fresh optimizer state when the trainer loads it)."""
    jm = jax_get_model(model_cfg)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, *patch, 1)),
                     False)["params"]
    state = {"num_epochs": 0, "num_iterations": 0,
             "model_state_dict": {"params": params, "batch_stats": {}},
             "best_eval_score": 0.0}
    if optimizer_cfg is not None:
        state["optimizer_state_dict"] = jax_opt.create_optimizer(
            optimizer_cfg).init(params)
    return jax_ckpt.save_checkpoint(state, False, str(root))


def _logged(run_dir, tag):
    rows = {}
    for base, _, files in os.walk(os.path.join(run_dir, "logs")):
        if "metrics.jsonl" in files:
            for line in open(os.path.join(base, "metrics.jsonl")):
                r = json.loads(line)
                if r["tag"] == tag:
                    rows[r["step"]] = r["value"]
    return rows


def _train_argv(root, init):
    return ["--config", TRAIN_YML, *SMALL_MODEL, "--device", "cpu",
            "--loaders.train.file_paths",
            repr([_write_volume(str(root / "train.h5"), (10, 48, 48), 1)]),
            "--loaders.val.file_paths",
            repr([_write_volume(str(root / "val.h5"), (8, 32, 64), 2)]),
            "--loaders.train.slice_builder.patch_shape", "[8, 32, 32]",
            "--loaders.train.slice_builder.stride_shape", "[2, 16, 16]",
            "--loaders.train.slice_builder.skip_shape_check", "true",
            "--loaders.val.slice_builder.patch_shape", "[8, 32, 32]",
            "--loaders.val.slice_builder.stride_shape", "[8, 32, 32]",
            "--loaders.val.slice_builder.skip_shape_check", "true",
            "trainer.max_num_iterations=2", "trainer.validate_after_iters=2",
            "trainer.log_after_iters=1", f"trainer.pre_trained={init}"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One JAX and one port train3d run: 3 steps, a validation and the
    checkpoints at iteration 2, on one device each."""
    root = tmp_path_factory.mktemp("train3d")
    cfg = load_config(["--config", TRAIN_YML, *SMALL_MODEL])
    init = _jax_checkpoint(cfg["model"], root / "init", (8, 32, 32),
                           cfg["optimizer"])
    argv = _train_argv(root, init)
    jax_dir, port_dir = str(root / "jax"), str(root / "port")
    one_device = jax_mesh.make_mesh(devices=jax.devices()[:1])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_trainer3d.mesh_lib, "make_mesh",
                   lambda *a, **k: one_device)
        _reset_global_states()
        jax_train3d.main(argv + ["--trainer.checkpoint_dir", jax_dir])
    _reset_global_states()
    trainer = train3d.main(argv + ["--trainer.checkpoint_dir", port_dir])
    return trainer, jax_dir, port_dir


def test_train3d_losses_match_jax(trained):
    trainer, jax_dir, port_dir = trained
    assert trainer.num_iterations == 3
    assert next(trainer.model.parameters()).device.type == "cpu"
    for tag in ("train_loss_avg", "val_loss_avg"):
        want, got = _logged(jax_dir, tag), _logged(port_dir, tag)
        assert sorted(got) == sorted(want) and want, tag
        for step in want:
            np.testing.assert_allclose(got[step], want[step], rtol=LOSS_TOL,
                                       err_msg=f"{tag} at {step}")
    assert len(_logged(port_dir, "train_loss_avg")) == 3


def test_train3d_writes_checkpoints_and_the_resolved_config(trained):
    trainer, jax_dir, port_dir = trained
    for name in (ckpt.LAST_NAME, ckpt.BEST_NAME):
        assert os.path.exists(os.path.join(port_dir, name))
    copied = load_config(config_path=os.path.join(port_dir, "logs",
                                                  "config.yml"))
    assert copied["model"]["f_maps"] == 4 and copied["device"] == "cpu"
    assert copied["trainer"]["max_num_iterations"] == 2
    jax_copied = load_config(config_path=os.path.join(jax_dir, "logs",
                                                      "config.yml"))
    assert copied["loaders"] == jax_copied["loaders"]
    saved = ckpt.load_checkpoint(os.path.join(port_dir, ckpt.LAST_NAME))
    assert saved["num_iterations"] == 2


def test_entry_points_want_the_card_unless_device_cpu(tmp_path,
                                                      monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in ("auto", "cuda"):
        cfg = load_config(["--config", TRAIN_YML, "--device", device])
        with pytest.raises(RuntimeError, match="CUDA card"):
            trainer3d.create_trainer(cfg)
        with pytest.raises(RuntimeError, match="CUDA card"):
            predict3d.main(["--config", PREDICT_YML, "--device", device])
    with pytest.raises(ValueError, match="'auto', 'cuda' or 'cpu'"):
        trainer3d.config_device({"device": "tpu"})
    assert trainer3d.config_device({"device": "cpu"}) == torch.device("cpu")
    cfg = load_config(["--config", TRAIN_YML, "--device", "cpu",
                       "--parallel.zero1", "true"])
    with pytest.raises(NotImplementedError, match="item 25"):
        trainer3d.create_trainer(cfg)
    with pytest.raises(KeyError, match="model_path"):
        predict3d.main(["--config", PREDICT_YML, "--device", "cpu",
                        "--model_path", "null"])


PREDICT_CASES = {
    "device-logits": dict(out=1, extra=[]),
    "host-2ch": dict(out=2, extra=["--predictor.accumulate_on_device",
                                   "false"]),
    "segmentation": dict(out=2, extra=["--predictor.save_segmentation",
                                       "true"]),
    # the JAX run appends the padded memo to the scan, the port's reads it;
    # 9x40x70 is not a multiple of 3: the 27 normalization slices overlap
    "lazy": dict(out=2, extra=["--loaders.dataset", "LazyHDF5Dataset",
                               "--predictor.name", "LazyPredictor"]),
}


@pytest.fixture(scope="module")
def prediction_inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("predict3d")
    path = _write_volume(str(root / "scan.h5"), (9, 40, 70), 3, label=False)
    ckpts = {}
    for out in (1, 2):
        cfg = load_config(["--config", PREDICT_YML, *SMALL_MODEL,
                           "--model.out_channels", str(out)])
        ckpts[out] = _jax_checkpoint(cfg["model"], root / f"ckpt{out}",
                                     (6, 24, 48))
    return root, path, ckpts


@pytest.mark.parametrize("case", PREDICT_CASES)
def test_predict3d_matches_jax(prediction_inputs, case):
    root, path, ckpts = prediction_inputs
    c = PREDICT_CASES[case]
    argv = ["--config", PREDICT_YML, *SMALL_MODEL, "--device", "cpu",
            "--model.out_channels", str(c["out"]),
            "--model_path", ckpts[c["out"]],
            "--loaders.test.file_paths", repr([path]),
            "--loaders.test.slice_builder.patch_shape", "[4, 16, 32]",
            "--loaders.test.slice_builder.stride_shape", "[4, 16, 32]",
            "--loaders.test.slice_builder.halo_shape", "[1, 4, 8]",
            "--loaders.test.slice_builder.skip_shape_check", "true",
            *c["extra"]]
    jax_out, port_out = str(root / case / "jax"), str(root / case / "port")
    jax_predict3d.main(argv + ["--output_dir", jax_out])
    written = predict3d.main(argv + ["--output_dir", port_out])
    assert [str(p) for p in written] == [
        os.path.join(port_out, "scan_predictions.h5")]
    with h5py.File(os.path.join(jax_out, "scan_predictions.h5"), "r") as f:
        want = f["predictions"][()]
    with h5py.File(written[0], "r") as f:
        ds = f["predictions"]
        assert ds.compression == "gzip" and list(f.keys()) == ["predictions"]
        got = ds[()]
    assert got.shape == want.shape and got.dtype == want.dtype
    if want.dtype == np.uint16:
        np.testing.assert_array_equal(got, want)
    else:
        assert want.shape == (c["out"], 9, 40, 70)
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)

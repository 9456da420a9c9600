"""UNet-3+ at 176², the smallest size the hybrid F1 + MS-SSIM + IoU loss
takes (MS-SSIM's 5 levels need more than 160 px):

- the port ``Trainer``'s first step (batch 1, the real criterion, training
  mode: BatchNorm on batch statistics) has the loss of the JAX model's
  training-mode forward on the same weights and batch, within 1e-5
  relative (FIRST_STEP_TOL; the same arithmetic in another order), and
  the running statistics it leaves are flax's, within 1e-5 of max |value|;
- the 2D training CLI on its default ``--unet_type UNet_3Plus`` with
  ``--remat on`` (what 'auto' picks at >= 384 px) takes a step on
  synthetic data, evaluates and saves a servable bundle; its defaults
  build the 512² model.
"""

import os

import numpy as np
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
from mdeical_image_segmentation_tpu_torch.cli import train2d as cli
from mdeical_image_segmentation_tpu_torch.data import SyntheticSliceDataset
from mdeical_image_segmentation_tpu_torch.models import UNetConfig, UNetModel
from mdeical_image_segmentation_tpu_torch.train import (
    Trainer,
    TrainerCallback,
    TrainingArguments,
)
from mdeical_image_segmentation_tpu_torch.utils.param_bridge import (
    state_dict_to_flax,
)

FIRST_STEP_TOL = 1e-5
KW = dict(in_channels=3, out_channels=1, unet_type="UNet_3Plus")


def test_first_trainer_step_with_the_hybrid_loss_matches_jax(tmp_path):
    model = UNetModel(UNetConfig(**KW), device="cpu",
                      generator=torch.Generator().manual_seed(0))
    variables = jax.tree_util.tree_map(
        jnp.asarray, state_dict_to_flax(model.module.state_dict()))
    batch = JaxCollator()([JaxSynthetic(1, 176, 3)[0]])
    jm = JaxUNetModel(JaxUNetConfig(**KW))
    want, mutated = jax.jit(lambda v, x, y: jm.apply(
        v, x, y, train=True, mutable=["batch_stats"]))(
            variables, jnp.asarray(batch["images"]),
            jnp.asarray(batch["labels"]))
    losses = []

    class _Losses(TrainerCallback):
        def on_log(self, args, state, control, logs, **kw):
            losses.append(logs["loss"])

    Trainer(model, TrainingArguments(
        output_dir=str(tmp_path), max_steps=1, per_device_train_batch_size=1,
        logging_steps=1, eval_strategy="no", save_steps=0, augment=False),
        SyntheticSliceDataset(1, 176, 3), callbacks=[_Losses()],
        device="cpu").train()
    np.testing.assert_allclose(losses, [float(want.loss)],
                               rtol=FIRST_STEP_TOL)
    got = state_dict_to_flax(model.module.state_dict())["batch_stats"]
    for (k, g), w in zip(jax.tree_util.tree_leaves_with_path(got),
                         jax.tree_util.tree_leaves(
                             mutated["batch_stats"])):
        w = np.asarray(w)
        assert np.abs(g - w).max() <= FIRST_STEP_TOL * np.abs(w).max(), k


def test_cli_default_unet_type_trains_with_remat(tmp_path):
    """``--unet_type`` left at its default (UNet_3Plus), ``--remat on`` (what
    'auto' picks at >= 384 px), 176², one step and the final evaluation."""
    out = cli.main(["--synthetic", "4", "--resolution", "176",
                    "--remat", "on", "--max_steps", "1",
                    "--eval_strategy", "no", "--logging_steps", "1",
                    "--per_device_train_batch_size", "1",
                    "--per_device_eval_batch_size", "4", "--device", "cpu",
                    "--output_dir", str(tmp_path)])
    assert out.endswith("UNet_3Plus")
    final = UNetModel.from_pretrained(os.path.join(out, "final"),
                                      device="cpu")
    assert final.config.remat and final.config.remat_policy == "save_convs"
    assert os.path.isfile(os.path.join(out, "output.png"))


def test_cli_defaults_build_at_512():
    args = cli.parse_args([])
    assert (args.unet_type, args.resolution, args.remat) == (
        "UNet_3Plus", 512, "auto")
    model = UNetModel(UNetConfig(in_channels=args.in_channels,
                                 unet_type=args.unet_type, remat=True,
                                 remat_policy=args.remat_policy),
                      device="meta")
    assert model.criterion.__name__ == "segmentation_loss"
    assert model.module._UNet3PlusBackbone_0.ConvBNReLU_0.remat

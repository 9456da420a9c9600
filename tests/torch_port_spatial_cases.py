"""The port's side of ``test_torch_port_spatial.py``: the seeded inputs and
the runs of the spatially sharded path (``parallel/spatial.py``), in a
world of 1 (the test process, no process group) or as one rank of the
gloo world of 2 that ``torch_port_dp_worker.py`` spawns (its
``scenario_spatial``).  Imports the port only, never JAX.

Shapes after ``tests/test_spatial_sharding.py``, cut to 2 ranks: a
UNet3D 'gcr' (f_maps 8, 2 levels, 4 groups) on one 1x8x64x16 volume split
on H, halo 8 (a rank's slab of 32 rows pads to 48: 24 at the second
level, whose interior is rows 4-20); a ResidualUNet3D 'cr' (f_maps 4, 2
levels) with halo 16.  Every run starts from the JAX-initialized weights
the test writes (``weights_path``).
"""

from __future__ import annotations

import os

import numpy as np

HALO = 8
RES_HALO = 16
SHAPE = (1, 8, 64, 16, 1)
LR = 0.05
GCR = {"name": "UNet3D", "in_channels": 1, "out_channels": 1, "f_maps": 8,
       "num_levels": 2, "num_groups": 4, "layer_order": "gcr"}
RES_CR = {"name": "ResidualUNet3D", "in_channels": 1, "out_channels": 1,
          "f_maps": 4, "num_levels": 2, "layer_order": "cr"}
MODES = (False, True)  # cross_shard_norm

# the trainer run: configs/unet3d_train.yml's loss and metric on the GCR
# model, SGD, two 1-patch epochs (two steps), validation at step 2
TRAIN_CFG = {
    "model": {**GCR, "final_sigmoid": True},
    "loss": {"name": "BCEDiceLoss"},
    "eval_metric": {"name": "MeanIoU"},
    "optimizer": {"name": "SGD", "learning_rate": LR},
    "parallel": {"spatial_halo": HALO, "spatial_shard_axis": 2,
                 "spatial_cross_shard_norm": True},
}
TRAINER = {"max_num_epochs": 2, "max_num_iterations": 1,
           "validate_after_iters": 2, "log_after_iters": 1}


def inputs():
    """(volume, labels, cotangent) of SHAPE, float32, from seeds."""
    rs = np.random.RandomState(11)
    vol = rs.rand(*SHAPE).astype(np.float32)
    labels = (rs.rand(*SHAPE) > 0.5).astype(np.float32)
    cot = rs.standard_normal(SHAPE).astype(np.float32)
    return vol, labels, cot


def train_volumes():
    """(train raw, val raw) volumes of 8x64x16 for the trainer run; labels
    are ``raw > 0.5``."""
    rs = np.random.RandomState(5)
    return (rs.rand(*SHAPE[1:4]).astype(np.float32),
            rs.rand(*SHAPE[1:4]).astype(np.float32))


def weights_path(out, name):
    return os.path.join(out, f"init_{name}.pt")


def trainer_config(out, checkpoint_dir):
    """The config ``create_trainer`` takes, on the test's HDF5 files."""
    def phase(name):
        return {"file_paths": [os.path.join(out, f"{name}.h5")],
                "slice_builder": {"name": "SliceBuilder",
                                  "patch_shape": list(SHAPE[1:4]),
                                  "stride_shape": list(SHAPE[1:4]),
                                  "skip_shape_check": True},
                "transformer": {"raw": [{"name": "Standardize"},
                                        {"name": "ToTensor",
                                         "expand_dims": True}],
                                "label": [{"name": "ToTensor",
                                           "expand_dims": True}]}}

    return {**TRAIN_CFG, "device": "cpu",
            "loaders": {"dataset": "StandardHDF5Dataset", "batch_size": 1,
                        "num_workers": 0, "train": phase("train"),
                        "val": phase("val")},
            "trainer": {**TRAINER, "checkpoint_dir": checkpoint_dir,
                        "pre_trained": os.path.join(
                            out, "init_ckpt", "last_checkpoint.msgpack")}}


def _model(cfg, out, name):
    import torch

    from mdeical_image_segmentation_tpu_torch.models import get_model

    model = get_model(cfg)
    model.load_state_dict(torch.load(weights_path(out, name)))
    return model


def _params(model):
    from mdeical_image_segmentation_tpu_torch.utils.param_bridge import (
        state_dict_to_flax,
    )

    sd = state_dict_to_flax({k: v.detach() for k, v in
                             model.state_dict().items()})
    return _flat(sd["params"])


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + str(k)] = np.array(v)
    return out


def forward_and_grad(model, cross_shard_norm):
    """This rank's output slab of the sharded forward and its slab of the
    input gradient of sum(output · cotangent)."""
    import torch

    from mdeical_image_segmentation_tpu_torch.parallel import (
        shard_slab,
        spatial_sharded_apply,
    )

    vol, _, cot = inputs()
    x = shard_slab(torch.from_numpy(vol)).clone().requires_grad_(True)
    out = spatial_sharded_apply(model, x, halo=HALO, shard_axis=2,
                                cross_shard_norm=cross_shard_norm)
    (out * shard_slab(torch.from_numpy(cot))).sum().backward()
    return out.detach().numpy(), x.grad.numpy()


def sgd_step(model, cross_shard_norm):
    """One SGD step of the mean of the per-slab MSEs: the ranks' mean loss
    and the parameters after it."""
    import torch

    from mdeical_image_segmentation_tpu_torch.parallel import (
        make_spatial_train_step,
        shard_slab,
    )

    vol, labels, _ = inputs()
    step = make_spatial_train_step(
        model, lambda o, y: torch.mean(torch.square(o - y)),
        torch.optim.SGD(model.parameters(), lr=LR), halo=HALO, shard_axis=2,
        cross_shard_norm=cross_shard_norm)
    loss = step(shard_slab(torch.from_numpy(vol)),
                shard_slab(torch.from_numpy(labels)))
    return float(loss), _params(model)


def residual_forward(model):
    """This rank's output slab of the ResidualUNet3D's sharded forward."""
    import torch

    from mdeical_image_segmentation_tpu_torch.parallel import (
        shard_slab,
        spatial_sharded_apply,
    )

    vol, _, _ = inputs()
    with torch.no_grad():
        return spatial_sharded_apply(model, shard_slab(torch.from_numpy(vol)),
                                     halo=RES_HALO).numpy()


def error_messages():
    """What the port raises where the JAX package's checks fire: an extent
    that does not divide over the ranks, a halo of a whole slab, a halo
    that does not divide by the pooling factor (cross-shard)."""
    import torch

    from mdeical_image_segmentation_tpu_torch.models import get_model
    from mdeical_image_segmentation_tpu_torch.parallel import (
        shard_slab,
        spatial_sharded_apply,
    )

    model = get_model(GCR)
    slab = torch.zeros((1, 8, 32, 16, 1))
    cases = {
        "indivisible": lambda: shard_slab(torch.zeros((1, 8, 63, 16, 1))),
        "oversized": lambda: spatial_sharded_apply(model, slab, halo=32),
        "pool_factor": lambda: spatial_sharded_apply(
            model, slab, halo=7, cross_shard_norm=True),
    }
    got = {}
    for name, fn in cases.items():
        try:
            fn()
            got[name] = None
        except ValueError as e:
            got[name] = str(e)
    return got


def run_trainer(out, rank):
    """``create_trainer(...).fit()`` with the ``parallel:`` keys: the
    train batch each step sees, whether the train loader is
    process-sharded, whether ``rows_split`` is active while the loss is
    computed, each step's loss, the logs and the parameters after."""
    from mdeical_image_segmentation_tpu_torch.parallel import mesh as mesh_lib
    from mdeical_image_segmentation_tpu_torch.train import trainer3d

    run_dir = os.path.join(out, f"trainer_rank{rank}")
    t = trainer3d.create_trainer(trainer_config(out, run_dir))
    rec = {"losses": [], "batch_rows": [], "split_in_loss": [],
           "process_shard": getattr(t.loaders["train"], "process_shard",
                                    None),
           "spatial": (t.spatial_halo, t.spatial_shard_axis,
                       t.spatial_cross_shard_norm),
           "ddp": t._ddp is not t.model}
    step, criterion = t._train_step, t.loss_criterion

    def probed(output, target, *w):
        rec["split_in_loss"].append(mesh_lib.split_mesh() is not None)
        return criterion(output, target, *w)

    def recorded(input, target, weight):
        rec["batch_rows"].append(tuple(input.shape))
        loss, output = step(input, target, weight)
        rec["losses"].append(float(loss))
        return loss, output

    t.loss_criterion = probed
    t._train_step = recorded
    t.fit()
    rec["params"] = _params(t.model)
    rec["files"] = sorted(os.listdir(run_dir)) if os.path.isdir(
        run_dir) else []
    rec["logged"] = {tag: _logged(run_dir, tag)
                     for tag in ("train_loss_avg", "val_loss_avg",
                                 "val_eval_score_avg")}
    return rec


def _logged(run_dir, tag):
    import json

    rows = {}
    for root, _, files in os.walk(os.path.join(run_dir, "logs")):
        for f in files:
            if f == "metrics.jsonl":
                for line in open(os.path.join(root, f)):
                    r = json.loads(line)
                    if r["tag"] == tag:
                        rows[r["step"]] = r["value"]
    return rows


def port_runs(out, rank):
    """Everything this rank computes, for the test to hold."""
    res = {"forward": {}, "grad": {}, "step": {}}
    for mode in MODES:
        res["forward"][mode], res["grad"][mode] = forward_and_grad(
            _model(GCR, out, "gcr"), mode)
        res["step"][mode] = sgd_step(_model(GCR, out, "gcr"), mode)
    res["residual"] = residual_forward(_model(RES_CR, out, "res"))
    res["errors"] = error_messages()
    res["trainer"] = run_trainer(out, rank)
    return res

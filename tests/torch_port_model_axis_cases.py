"""The port's side of ``test_torch_port_tensor_parallel.py`` and
``test_torch_port_zero1.py``: the runs of one rank of a gloo world on a
(data, model) mesh (``torch_port_dp_worker.py``'s ``scenario_tp``,
``scenario_zero1`` and ``scenario_tp_zero1``), from the weights and inputs
the tests write into ``out``.  Imports the port only, never JAX.

- the 2D UNet of ``tests/test_tensor_parallel.py`` (base 8, 32², batch 2):
  forward and the gradients of mean(logits²) in eval mode, on a model
  axis of 2;
- the 3D UNet3D 'gcr' (f_maps 8, 2 levels, 4 groups) through
  ``create_trainer`` on HDF5 volumes with ``parallel: {model_axis: 2,
  tensor_parallel: true}``; a ``DistCheckpointer`` round trip of the
  data-parallel tests' 'gcr' trainer (2 steps, the sharded save, a resumed
  step 3 against the uninterrupted one);
- the 2D Trainer of ``tests/test_zero1.py`` (base 8, 16 slices of 32²,
  per-device batch 2, 6 steps, lr 3e-3) with ``zero1`` and without, on a
  data axis of 2, and with both on a (2, 2) mesh;
- a JAX orbax checkpoint of ``tests/fixtures/orbax`` resumed by
  ``create_trainer`` with ``tensor_parallel`` on a model axis of 2 or
  ``zero1`` on a data axis of 2: this rank's blocks of the parameters and
  the Adam moments.
"""

from __future__ import annotations

import os

import numpy as np

SHAPE_3D = (1, 8, 64, 16, 1)
GCR = {"name": "UNet3D", "in_channels": 1, "out_channels": 1, "f_maps": 8,
       "num_levels": 2, "num_groups": 4, "layer_order": "gcr",
       "final_sigmoid": True}
TP_PARALLEL = {"model_axis": 2, "tensor_parallel": True}
TRAINER_3D = {"max_num_epochs": 2, "max_num_iterations": 1,
              "validate_after_iters": 2, "log_after_iters": 1}
LR_3D = 0.05
UNET_KW = dict(in_channels=1, out_channels=1, unet_type="UNet",
               base_features=8)
ZERO_ARGS = dict(max_steps=6, per_device_train_batch_size=2,
                 eval_strategy="no", logging_steps=1, save_steps=0,
                 learning_rate=3e-3, augment=False)
N_SLICES, RES = 16, 32


def init_2d_path(out):
    return os.path.join(out, "unet2d_init.pt")


def forward_input():
    return np.random.RandomState(0).rand(2, 32, 32, 1).astype(np.float32)


def train_config(out, checkpoint_dir, parallel=TP_PARALLEL):
    """The config ``create_trainer`` takes, on the test's HDF5 files: the
    yml's BCEDiceLoss and MeanIoU, SGD, two 1-patch epochs, validation at
    step 2."""
    def phase(name):
        return {"file_paths": [os.path.join(out, f"{name}.h5")],
                "slice_builder": {"name": "SliceBuilder",
                                  "patch_shape": list(SHAPE_3D[1:4]),
                                  "stride_shape": list(SHAPE_3D[1:4]),
                                  "skip_shape_check": True},
                "transformer": {"raw": [{"name": "Standardize"},
                                        {"name": "ToTensor",
                                         "expand_dims": True}],
                                "label": [{"name": "ToTensor",
                                           "expand_dims": True}]}}

    return {"model": GCR, "loss": {"name": "BCEDiceLoss"},
            "eval_metric": {"name": "MeanIoU"},
            "optimizer": {"name": "SGD", "learning_rate": LR_3D},
            "parallel": dict(parallel), "device": "cpu",
            "loaders": {"dataset": "StandardHDF5Dataset", "batch_size": 1,
                        "num_workers": 0, "train": phase("train"),
                        "val": phase("val")},
            "trainer": {**TRAINER_3D, "checkpoint_dir": checkpoint_dir,
                        "pre_trained": os.path.join(
                            out, "init_ckpt", "last_checkpoint.msgpack")}}


def train_volumes():
    """(train raw, val raw), 8x64x16; labels are ``raw > 0.5``."""
    rs = np.random.RandomState(5)
    return (rs.rand(*SHAPE_3D[1:4]).astype(np.float32),
            rs.rand(*SHAPE_3D[1:4]).astype(np.float32))


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + str(k)] = np.array(v)
    return out


def _flax(sd):
    from mdeical_image_segmentation_tpu_torch.utils.param_bridge import (
        state_dict_to_flax,
    )

    return flat(state_dict_to_flax(
        {k: v.detach() for k, v in sd.items()})["params"])


def whole_params(model):
    """The flax tree (flat) of ``model``'s whole weights: a sharded model
    gathers them (every rank calls it)."""
    from mdeical_image_segmentation_tpu_torch.parallel import tensor as tp

    with tp.full_parameters(model):
        return _flax(model.state_dict())


def unet2d_forward_and_grads(out, mesh):
    """The sharded 2D UNet's logits and its local gradients (flax layout)
    and shard shapes, eval mode, from the test's weights."""
    import torch

    from mdeical_image_segmentation_tpu_torch.models import (
        UNetConfig,
        UNetModel,
    )
    from mdeical_image_segmentation_tpu_torch.parallel import tensor as tp

    module = UNetModel(UNetConfig(**UNET_KW), device="cpu").module
    module.load_state_dict(torch.load(init_2d_path(out)))
    tp.shard_params_tp(module, mesh)
    module.eval()
    logits = module(torch.from_numpy(forward_input()))
    logits.square().mean().backward()
    return {"logits": logits.detach().numpy(),
            "grads": _flax({k: p.grad for k, p in
                            module.named_parameters()}),
            "shapes": {k: tuple(p.shape) for k, p in
                       module.named_parameters()},
            "dims": tp.sharded_dims(module)}


def run_trainer_3d(out, rank):
    """``create_trainer(...).fit()`` with ``parallel: {model_axis: 2,
    tensor_parallel: true}``: each step's loss, the logs, the whole
    parameters after, the shard shapes, the files written."""
    from mdeical_image_segmentation_tpu_torch.parallel import tensor as tp
    from mdeical_image_segmentation_tpu_torch.train import trainer3d

    run_dir = os.path.join(out, "trainer")  # the ranks' one directory
    t = trainer3d.create_trainer(train_config(out, run_dir))
    rec = {"losses": [], "mesh": t.mesh.shape, "tp": t.tensor_parallel,
           "ddp": t._ddp is not t.model, "dims": tp.sharded_dims(t.model),
           "shapes": {k: tuple(p.shape) for k, p in
                      t.model.named_parameters()}}
    step = t._train_step

    def recorded(input, target, weight):
        loss, output = step(input, target, weight)
        rec["losses"].append(float(loss))
        return loss, output

    t._train_step = recorded
    t.fit()
    rec["params"] = whole_params(t.model)
    rec["files"] = sorted(
        os.path.relpath(os.path.join(d, f), run_dir)
        for d, _, fs in os.walk(run_dir) for f in fs)
    rec["logged"] = {tag: logged(run_dir, tag)
                     for tag in ("train_loss_avg", "val_loss_avg",
                                 "val_eval_score_avg")}
    return rec


def logged(run_dir, tag):
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


def _state(trainer):
    """The whole parameters and the local optimizer state, flat."""
    import torch

    from mdeical_image_segmentation_tpu_torch.parallel.zero import (
        Zero1Optimizer,
    )

    opt = trainer.optimizer
    inner = opt.inner if isinstance(opt, Zero1Optimizer) else opt
    slices = [s for g in inner.param_groups for s in g["params"]]
    moments = {f"{i}/{k}": np.array(v) for i, s in enumerate(slices)
               for k, v in inner.state.get(s, {}).items()
               if isinstance(v, torch.Tensor)}
    return {"params": whole_params(trainer.model), "moments": moments}


def dcp_round_trip(out, rank, mesh, **mode):
    """The data-parallel tests' 'gcr' trainer (``torch_port_dp_worker``)
    in ``mode`` over ``mesh``: 3 steps uninterrupted; 2 steps, the sharded
    save (``_save_checkpoint``: every rank its blocks), a trainer resumed
    from ``<run>/dist_ckpt`` that takes step 3."""
    import torch_port_dp_worker as W

    kw = dict(validate_after_iters=100, max_num_epochs=5, **mode)
    init = W.init_path(out, "gcr")

    def trainer(name, iterations, **more):
        # one directory for the ranks: each writes its blocks into it
        return W.port_trainer_3d(
            "gcr", os.path.join(out, name), mesh,
            loaders={"train": W.train_batches_3d()[:2],
                     "val": W.val_batches_3d()},
            max_num_iterations=iterations, **kw, **more)

    res = {}
    full = trainer("full", 2, pre_trained=init)
    res["full"] = W.record_3d(full)
    full.fit()
    res["full_state"] = _state(full)
    first = trainer("first", 1, pre_trained=init)
    res["first"] = W.record_3d(first)
    first.fit()
    first._save_checkpoint(is_best=True)
    res["template"] = template_restore(first)
    resumed = trainer("resumed", 1, resume=os.path.join(
        first.checkpoint_dir, "dist_ckpt"))
    res["resumed_at"] = resumed.num_iterations
    res["resumed"] = W.record_3d(resumed)
    resumed.fit()
    res["resumed_state"] = _state(resumed)
    res["dcp_files"] = W.files_under(os.path.join(first.checkpoint_dir,
                                                  "dist_ckpt"))
    return res


def template_restore(trainer):
    """Restore ``trainer``'s sharded checkpoint into a template of its own
    sharded state with every block zeroed: whether each ``DTensor`` block
    came back equal to the live one, and how many blocks there were."""
    import torch
    from torch.distributed.tensor import DTensor

    from mdeical_image_segmentation_tpu_torch.train.dist_ckpt import (
        DistCheckpointer,
    )

    live = flat_tensors(trainer.sharded_checkpoint_state())
    template = trainer.sharded_checkpoint_state()
    blocks = [v for v in flat_tensors(template).values()
              if isinstance(v, DTensor)]
    for v in blocks:
        v.to_local().zero_()
    DistCheckpointer(os.path.join(trainer.checkpoint_dir,
                                  "dist_ckpt")).restore(template=template)
    got = flat_tensors(template)
    return {"blocks": len(blocks),
            "equal": all(torch.equal(got[k].to_local(), v.to_local())
                         for k, v in live.items() if isinstance(v, DTensor))}


def flat_tensors(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_tensors(v, f"{prefix}{k}/"))
        else:
            out[prefix + str(k)] = v
    return out


def trainer_2d(out, name, mesh, **kw):
    """The port's Trainer of ``tests/test_zero1.py`` over ``mesh``, from
    the test's weights, writing into ``out/name``."""
    import torch

    from mdeical_image_segmentation_tpu_torch.data import (
        SyntheticSliceDataset,
    )
    from mdeical_image_segmentation_tpu_torch.models import (
        UNetConfig,
        UNetModel,
    )
    from mdeical_image_segmentation_tpu_torch.train import (
        Trainer,
        TrainingArguments,
    )

    model = UNetModel(UNetConfig(**UNET_KW), device="cpu")
    model.module.load_state_dict(torch.load(init_2d_path(out)))
    return Trainer(model, TrainingArguments(
        output_dir=os.path.join(out, name), **ZERO_ARGS, **kw),
                   SyntheticSliceDataset(N_SLICES, RES), mesh=mesh,
                   device="cpu")


def run_2d(out, name, mesh, **kw):
    """6 steps: the logged losses, the whole parameters, the optimizer
    state this rank holds (its bytes, and every leaf's local shape with
    its data-axis dim) and the parameters' shapes."""
    from mdeical_image_segmentation_tpu_torch.parallel import tensor as tp
    from mdeical_image_segmentation_tpu_torch.parallel.zero import (
        Zero1Optimizer,
    )
    from mdeical_image_segmentation_tpu_torch.train import TrainerCallback

    losses = []

    class Log(TrainerCallback):
        def on_log(self, args, state, control, logs, **kw):
            if "loss" in logs:
                losses.append(logs["loss"])

    t = trainer_2d(out, name, mesh, **kw)
    t.callbacks.append(Log())
    t.train()
    opt = t.state.optimizer
    rec = {"losses": losses, "params": whole_params(t.model.module),
           "param_shapes": {k: tuple(p.shape) for k, p in
                            t.model.named_parameters()},
           "tp_dims": tp.sharded_dims(t.model), "zero": None}
    if isinstance(opt, Zero1Optimizer):
        rec["zero"] = {
            "bytes": opt.state_bytes(),
            "leaves": {name: (tuple(s.shape), dim) for name, s, dim in
                       opt.named_slices()}}
    return rec


ORBAX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                     "orbax")


def fixture_script():
    """``scripts/make_port_fixtures.py`` as a module (its ``orbax_config``
    and ``logged``; JAX only inside the functions that write fixtures)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_port_fixtures", os.path.join(os.path.dirname(ORBAX), "..", "..",
                                           "scripts", "make_port_fixtures.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def orbax_resume(out, rank, run, parallel):
    """``create_trainer`` with ``parallel`` resuming the JAX run ``run``'s
    orbax directory (a copy of this rank's): the counters, the sharded
    dims, and each parameter's local tensor with its slice and moments
    (``Zero1Optimizer``'s slices under ZeRO-1, the parameters under TP)."""
    import shutil

    from mdeical_image_segmentation_tpu_torch.parallel import tensor as tp
    from mdeical_image_segmentation_tpu_torch.parallel.zero import (
        Zero1Optimizer,
    )
    from mdeical_image_segmentation_tpu_torch.train import trainer3d

    copy = os.path.join(out, f"orbax_{run}_rank{rank}")
    shutil.copytree(os.path.join(ORBAX, run), copy)
    cfg = fixture_script().orbax_config(
        os.path.join(ORBAX, "volumes", "train.h5"),
        os.path.join(ORBAX, "volumes", "val.h5"), os.path.join(copy, "run"),
        parallel, resume=os.path.join(copy, "orbax"))
    cfg["device"] = "cpu"
    t = trainer3d.create_trainer(cfg)
    opt = t.optimizer
    if isinstance(opt, Zero1Optimizer):
        inner, entries = opt.inner, opt.named_slices()
    else:
        dims = tp.sharded_dims(t.model)
        inner = opt
        entries = [(k, p, dims.get(k)) for k, p in t.model.named_parameters()]
    blocks = {}
    for name, s, dim in entries:
        st = inner.state[s]
        blocks[name] = {"dim": dim, "slice": s.detach().numpy().copy(),
                        "exp_avg": st["exp_avg"].numpy().copy(),
                        "exp_avg_sq": st["exp_avg_sq"].numpy().copy(),
                        "step": float(st["step"])}
    return {"zero1": isinstance(opt, Zero1Optimizer),
            "tensor_parallel": t.tensor_parallel,
            "mesh": (t.mesh.rank, t.mesh.size, t.mesh.model_rank,
                     t.mesh.model_size),
            "counters": (t.num_iterations, t.num_epochs, t.best_eval_score),
            "params": {k: p.detach().numpy().copy()
                       for k, p in t.model.named_parameters()},
            "blocks": blocks}


def check_orbax_blocks(res, whole):
    """``orbax_resume``'s result against the whole checkpoint (``whole``:
    ``params``, ``mu`` and ``nu`` as numpy state dicts, Adam's ``count``,
    the ``counters``): every local tensor the slice of its whole on this
    rank's axis, to the bit; at least one tensor sliced."""
    rank, size, model_rank, model_size = res["mesh"]
    idx, n = ((model_rank, model_size) if res["tensor_parallel"]
              else (rank, size))
    assert res["counters"] == whole["counters"]
    sliced = 0
    for name, b in res["blocks"].items():
        dim = b["dim"]

        def cut(a, dim=dim):
            if dim is None:
                return a
            block = a.shape[dim] // n
            return np.take(a, np.arange(idx * block, (idx + 1) * block),
                           axis=dim)

        for key, tree in (("slice", "params"), ("exp_avg", "mu"),
                          ("exp_avg_sq", "nu")):
            want = cut(whole[tree][name])
            assert b[key].shape == want.shape, (name, key)
            assert np.array_equal(b[key], want), (name, key)
        assert b["step"] == whole["count"], name
        sliced += dim is not None
        if res["zero1"]:  # the parameters themselves stay whole
            assert np.array_equal(res["params"][name], whole["params"][name])
    assert sliced, "no tensor was sliced"
    return sliced

"""ZeRO-1 of the port (``parallel/zero.py``: ``zero1_specs``,
``Zero1Optimizer``; the 2D ``Trainer``'s ``zero1``) against the JAX
package's (``parallel/zero.py``), on the CPU: the port's gloo world of 2
on the data axis (``torch_port_dp_worker.py``'s ``scenario_zero1``) and of
4 on a (2, 2) mesh (``scenario_tp_zero1``), cases in
``torch_port_model_axis_cases.py``, against the JAX ``Trainer`` of
``tests/test_zero1.py`` on a 2-device mesh, from the same weights.

Held:

- ``zero1_specs`` equal JAX's on ``tests/test_zero1.py``'s trees (the
  largest divisible dim, scalars and indivisible leaves whole, composed
  with a tensor-parallel base);
- the world of 2 (the UNet of ``tests/test_zero1.py``, base 8, 16 slices
  of 32², per-device batch 2, 6 steps of AdamW at 3e-3): each rank holds
  half the moment bytes, on the dim JAX's rule picks for the flax leaf
  (``param_bridge.flax_dim``); the parameters stay whole; the parameters
  after 6 steps equal the port's replicated DDP run's to the bit; against
  JAX's ZeRO-1 run the losses lie within 1e-5 relative and the
  parameters within the data-parallel tests' bound for this trainer (1e-4
  of the tensor's max |value| plus 2·lr a step: Adam's per-element
  normalization moves an element whose gradient the two frameworks round
  differently by a share of lr).  The JAX test's rtol 2e-5 / atol 1e-6
  holds within one framework; across the two, 93% of the elements meet
  it after 6 steps, the rest stray by up to 2.5e-5.  The bit equality
  with the replicated run shows that none of the gap is ZeRO-1's;
- the world of 4 on a (2, 2) mesh with ``tensor_parallel`` and ``zero1``:
  some moment leaf is sharded over both axes, the losses are finite and
  within 1e-4 relative of the replicated run's (the tensor-parallel
  forward's tolerance) on the same global batches;
- the world of 2 resuming the JAX package's own orbax checkpoint of a
  ZeRO-1 run (``tests/fixtures/orbax/zero1``): each rank's slices and
  Adam moments the slice of what the JAX package restores, to the bit.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import torch_port_dp_worker as W
import torch_port_model_axis_cases as M
from mdeical_image_segmentation_tpu.data import (
    SyntheticSliceDataset as JaxSynthetic,
)
from mdeical_image_segmentation_tpu.data.collate import (
    SliceCollator as JaxCollator,
)
from mdeical_image_segmentation_tpu.models import UNetConfig as JaxConfig
from mdeical_image_segmentation_tpu.models import UNetModel as JaxUNet
from mdeical_image_segmentation_tpu.parallel import mesh as jax_mesh
from mdeical_image_segmentation_tpu.parallel.zero import (
    zero1_specs as jax_zero1_specs,
)
from mdeical_image_segmentation_tpu.train import Trainer as JaxTrainer
from mdeical_image_segmentation_tpu.train import (
    TrainerCallback as JaxCallback,
)
from mdeical_image_segmentation_tpu.train import (
    TrainingArguments as JaxArgs,
)
from mdeical_image_segmentation_tpu_torch.parallel import zero1_specs
from mdeical_image_segmentation_tpu_torch.parallel.zero import leaf_spec
from mdeical_image_segmentation_tpu_torch.utils.param_bridge import (
    flax_dim,
    flax_to_state_dict,
    state_dict_to_flax,
)

PARAM_TOL = 1e-4
LOSS_RTOL = 1e-5
TP_LOSS_RTOL = 1e-4

SPEC_CASES = {
    "largest_divisible": (
        8, {"kernel": (3, 3, 4, 16), "bias": (16,), "odd": (3, 3),
            "count": ()}, None),
    "compose_with_tp": (
        4, {"kernel": (3, 3, 8, 16)},
        {"kernel": (None, None, None, "model")}),
}


def _padded(spec, ndim):
    spec = tuple(spec)
    return spec + (None,) * (ndim - len(spec))


@pytest.mark.parametrize("case", sorted(SPEC_CASES))
def test_specs_match_jax(case):
    n, shapes, base = SPEC_CASES[case]
    tree = {k: np.zeros(s) for k, s in shapes.items()}
    mesh = jax_mesh.make_mesh(n, 8 // n)
    want = jax_zero1_specs(tree, mesh, None if base is None else {
        k: P(*v) for k, v in base.items()})
    got = zero1_specs(tree, n, base)
    for k, s in shapes.items():
        assert got[k] == _padded(want[k], len(s)), k


def test_a_leaf_with_no_divisible_dim_keeps_its_base():
    assert leaf_spec((3, 5), 2) == (None, None)
    assert leaf_spec((3, 6), 2, ("model", None)) == ("model", "data")
    assert leaf_spec((), 2) == ()


class _JaxLog(JaxCallback):
    def __init__(self):
        self.losses = []

    def on_log(self, args, state, control, logs, **kw):
        if "loss" in logs:
            self.losses.append(logs["loss"])


def _jax_zero1(out, variables):
    """The JAX Trainer of tests/test_zero1.py with zero1 on 2 devices, from
    ``variables``."""
    jm = JaxUNet(JaxConfig(**M.UNET_KW))
    log = _JaxLog()
    jt = JaxTrainer(jm, JaxArgs(output_dir=os.path.join(out, "jax"),
                                zero1=True, **M.ZERO_ARGS),
                    JaxSynthetic(M.N_SLICES, M.RES), callbacks=[log],
                    mesh=jax_mesh.make_mesh(n_data=2,
                                            devices=jax.devices()[:2]))
    sample = JaxCollator()([jt.train_dataset[0]])["images"]
    jt._init_state(sample, jt._num_train_steps())
    jt.state = jt.state.replace(params=jax_mesh.replicate(
        jt.mesh, jax.tree_util.tree_map(jnp.asarray, variables["params"])))
    jt._compile_steps()
    jt.train()
    return {"losses": log.losses,
            "params": W.flat(jax.device_get(jt.state.params))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX's ZeRO-1 run, the world of 2's ranks, the world of 4's)."""
    out = str(tmp_path_factory.mktemp("zero1"))
    jm = JaxUNet(JaxConfig(**M.UNET_KW))
    variables = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.asarray(
        M.forward_input())))
    torch.save(flax_to_state_dict(variables), M.init_2d_path(out))
    two = W.spawn("zero1", out)
    four = W.spawn("tp_zero1", out, world=4)
    try:
        jax_run = _jax_zero1(out, variables)
    except BaseException:
        for p in two + four:
            p.kill()
        raise
    return (jax_run, W.results(two, "zero1", out),
            W.results(four, "tp_zero1", out))


def test_moments_are_halved_on_the_dim_jax_picks(runs):
    _, ranks, _ = runs
    for r in ranks:
        z = r["zero1"]["zero"]
        shapes = r["zero1"]["param_shapes"]
        # AdamW: two float32 moments of the slice, a float32 step
        assert z["bytes"] == sum(4 * (2 * int(np.prod(local)) + 1)
                                 for local, _ in z["leaves"].values())
        whole = sum(4 * (2 * int(np.prod(s)) + 1) for s in shapes.values())
        assert z["bytes"] < 0.501 * whole
        for name, (local, dim) in z["leaves"].items():
            whole = shapes[name]
            ndim = len(whole)
            flax_shape = [None] * ndim
            for d in range(ndim):
                flax_shape[flax_dim(name, d, ndim)] = whole[d]
            want = leaf_spec(flax_shape, 2)
            if dim is None:  # the head's bias, of 1
                assert "data" not in want and local == whole, name
                continue
            assert want[flax_dim(name, dim, ndim)] == "data", name
            assert local[dim] * 2 == whole[dim], name


def test_parameters_stay_whole(runs):
    _, ranks, _ = runs
    for r in ranks:
        run = r["zero1"]
        assert run["param_shapes"] == r["replicated"]["param_shapes"]
        assert run["zero"] is not None and r["replicated"]["zero"] is None


def test_zero1_equals_the_replicated_run_to_the_bit(runs):
    _, ranks, _ = runs
    for r in ranks:
        assert r["zero1"]["losses"] == r["replicated"]["losses"]
        want = r["replicated"]["params"]
        assert r["zero1"]["params"].keys() == want.keys()
        for k, v in r["zero1"]["params"].items():
            np.testing.assert_array_equal(v, want[k], err_msg=k)
    for k, v in ranks[0]["zero1"]["params"].items():
        np.testing.assert_array_equal(ranks[1]["zero1"]["params"][k], v)


def test_zero1_matches_jax(runs):
    jax_run, ranks, _ = runs
    got = ranks[0]["zero1"]
    assert len(got["losses"]) == len(jax_run["losses"]) == 6
    np.testing.assert_allclose(got["losses"], jax_run["losses"],
                               rtol=LOSS_RTOL)
    assert got["params"].keys() == jax_run["params"].keys()
    for k, want in jax_run["params"].items():
        lr, steps = M.ZERO_ARGS["learning_rate"], M.ZERO_ARGS["max_steps"]
        np.testing.assert_allclose(
            got["params"][k], want, rtol=0,
            atol=PARAM_TOL * float(np.abs(want).max()) + 2 * steps * lr,
            err_msg=k)


def test_tp_and_zero1_shard_moments_over_both_axes(runs):
    _, two, four = runs
    for rank, r in enumerate(four):
        assert r["mesh"] == ({"data": 2, "model": 2}, rank // 2, rank % 2)
        run = r["run"]
        both = [name for name, (_, dim) in run["zero"]["leaves"].items()
                if dim is not None and name in run["tp_dims"]]
        assert both, "no moment leaf is sharded over both axes"
        assert np.all(np.isfinite(run["losses"]))
        np.testing.assert_allclose(run["losses"],
                                   two[0]["replicated"]["losses"],
                                   rtol=TP_LOSS_RTOL)


def test_jax_orbax_checkpoint_resumes_sliced_to_each_rank(runs):
    """The JAX package's own orbax checkpoint of a ZeRO-1 run
    (``tests/fixtures/orbax/zero1``) resumed by ``create_trainer`` with
    ``zero1`` on a data axis of 2: each rank's slices of the parameters
    and its Adam moments the slice of what the JAX package restores, to
    the bit; the parameters whole."""
    from test_torch_port_tensor_parallel import orbax_whole

    _, ranks, _ = runs
    whole = orbax_whole("zero1")
    for rank, r in enumerate(ranks):
        res = r["orbax"]
        assert res["zero1"] and not res["tensor_parallel"]
        assert res["mesh"] == (rank, 2, 0, 1)
        assert M.check_orbax_blocks(res, whole) >= 4

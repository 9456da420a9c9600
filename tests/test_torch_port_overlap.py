"""The port's overlap-add (``mdeical_image_segmentation_tpu_torch.ops.
overlap``) against the JAX package's Pallas ``overlap_add_into_pallas``
(interpret mode) and ``overlap_add_into_xla``, on the same numpy patches
from a fixed seed: overlapping windows, a padded tail with valid = 0 and
bf16 patches.  With weights in {0, 1} all sides add the same fp32 values
in the same patch order, so the maps must be EQUAL, not just close."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mdeical_image_segmentation_tpu.ops import overlap as jax_overlap
from mdeical_image_segmentation_tpu_torch.ops import overlap

VOLUME = (8, 14, 16)
STARTS = np.array([[0, 0, 0], [2, 3, 1], [1, 5, 6], [4, 6, 7], [4, 6, 7]],
                  np.int32)
VALID = np.array([1, 1, 1, 1, 0], np.float32)  # last entry: a padded tail


def _case(dtype, c, seed):
    rng = np.random.default_rng(seed)
    patches = rng.standard_normal((len(STARTS), 4, 8, 9, c)).astype(np.float32)
    acc = rng.standard_normal((*VOLUME, c)).astype(np.float32)
    cnt = rng.integers(0, 3, (*VOLUME, c)).astype(np.float32)
    jp = jnp.asarray(patches).astype(dtype)
    tp = torch.from_numpy(patches).to(getattr(torch, dtype))
    return acc, cnt, jp, tp


@pytest.mark.parametrize("c", [1, 2])
@pytest.mark.parametrize("oracle,dtype", [
    ("pallas", "float32"),
    ("xla", "float32"),
    # the Pallas kernel's scratch has the patches' dtype, so it cannot add
    # bf16 patches into fp32 maps: the XLA version is the bf16 oracle
    ("xla", "bfloat16"),
])
def test_matches_jax_exactly(dtype, c, oracle):
    acc, cnt, jp, tp = _case(dtype, c, seed=c)
    args = (jnp.asarray(acc), jnp.asarray(cnt), jp, jnp.asarray(STARTS),
            jnp.asarray(VALID))
    if oracle == "pallas":
        ja, jc = jax_overlap.overlap_add_into_pallas(*args, interpret=True)
    else:
        ja, jc = jax_overlap.overlap_add_into_xla(*args)
    ta, tc = torch.from_numpy(acc.copy()), torch.from_numpy(cnt.copy())
    before = overlap.overlap_add_into.launches
    out = overlap.overlap_add_into(ta, tc, tp, STARTS, VALID)
    assert out[0] is ta and out[1] is tc  # updated in place
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert overlap.overlap_add_into.launches == before  # CPU: plain version


def test_streaming_batches_equal_one_call():
    """Adding a patch set in two batches equals adding it at once."""
    _, _, _, tp = _case("float32", 2, seed=5)
    whole = overlap.overlap_add(tp, STARTS, VOLUME, VALID)
    acc = torch.zeros((*VOLUME, 2))
    cnt = torch.zeros((*VOLUME, 2))
    overlap.overlap_add_into(acc, cnt, tp[:2], STARTS[:2], VALID[:2])
    overlap.overlap_add_into(acc, cnt, tp[2:], STARTS[2:], VALID[2:])
    assert torch.equal(acc, whole[0]) and torch.equal(cnt, whole[1])


def test_bf16_patches_get_float32_maps_and_jax_counts():
    """The maps are float32 whatever the patches: a bf16 count stops
    resolving integers past 256 overlaps."""
    _, _, jp, tp = _case("bfloat16", 1, seed=9)
    acc, cnt = overlap.overlap_add(tp, STARTS, VOLUME)
    assert acc.dtype == torch.float32 and cnt.dtype == torch.float32
    ja, jc = jax_overlap.overlap_add(jp, jnp.asarray(STARTS), VOLUME)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jc))
    ones = torch.ones((300, 1, 1, 1, 1), dtype=torch.bfloat16)
    _, many = overlap.overlap_add(ones, np.zeros((300, 3), np.int32),
                                  (1, 1, 1))
    assert many.item() == 300.0


def test_patch_outside_the_volume_raises():
    _, _, _, tp = _case("float32", 1, seed=1)
    bad = STARTS.copy()
    bad[2] = (5, 0, 0)  # 5 + 4 > 8
    with pytest.raises(ValueError, match="leaves the volume"):
        overlap.overlap_add(tp, bad, VOLUME)
    with pytest.raises(ValueError, match="5 patches but starts"):
        overlap.overlap_add(tp, STARTS[:3], VOLUME)

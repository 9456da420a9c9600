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



# -- the CUDA kernel's work partition (csrc/overlap_add.cu), emulated --------
#
# The kernel cannot run here, so its partition is replayed in numpy with the
# source's own constants: one launch per chunk of K patches in patch order;
# per launch, the chunk's bounding box; a block per segment of a (z, y) row
# of it, whose warp 0 lists the covering patches in patch order; a thread per
# 4 elements aligned to 16 bytes of acc, with 16-byte acc/cnt access only
# where all 4 are covered, and a vector patch load only where the patch's
# (x, c) run is contiguous and aligned.  The replay must write every covered
# element exactly once per launch and never an uncovered one, and give maps
# bit-identical to the plain version (fp32 adds, product and sum rounded
# separately, in patch order).

def _cu_constants():
    import re

    from mdeical_image_segmentation_tpu_torch.ops import _build

    src = (_build.CSRC / "overlap_add.cu").read_text()
    return tuple(int(re.search(rf"constexpr int {name} = (\d+);", src)[1])
                 for name in ("V", "K", "MAX_NT"))


def _emulate(acc, cnt, patches, starts, valid):
    """Replay the kernel's launches on numpy copies of the (D, H, W, C)
    maps; returns (acc, cnt, {path: count})."""
    V, K, max_nt = _cu_constants()
    assert K == overlap.CHUNK
    d_, h_, w_, c = acc.shape
    a_map = acc.numpy().reshape(-1).copy()
    m_map = cnt.numpy().reshape(-1).copy()
    # the patches as the kernel sees them: flat storage, offset, strides
    store = patches.untyped_storage()
    base = torch.tensor([], dtype=patches.dtype).set_(
        store, 0, (store.nbytes() // patches.element_size(),))
    vals = base.float().numpy()
    off0 = patches.storage_offset()
    sb, sz, sy, sx, sc = patches.stride()
    p, pd, ph, pw, _ = patches.shape
    starts = np.asarray(starts, np.int32).reshape(-1, 3)
    valid = np.asarray(valid, np.float32)
    paths = {"launches": 0, "vec maps": 0, "scalar maps": 0,
             "vec patch": 0, "scalar patch": 0}
    for i0 in range(0, p, K):
        st, wt = starts[i0:i0 + K], valid[i0:i0 + K]
        lo = st.min(0)
        bz, by, bx = (st + (pd, ph, pw)).max(0) - lo
        row = bx * c + V - 1
        nt = min(-(-(-(-row // V)) // 32) * 32, max_nt)
        seg = nt * V
        written = np.zeros(a_map.shape, np.int32)
        paths["launches"] += 1
        for zz in range(lo[0], lo[0] + bz):
            for yy in range(lo[1], lo[1] + by):
                rowbase = (zz * h_ + yy) * w_ * c
                lo_e = rowbase + lo[2] * c
                hi_e = lo_e + bx * c
                for s in range(-(-row // seg)):
                    seg0 = lo_e - lo_e % V + s * seg
                    seg_lo, seg_hi = max(seg0, lo_e), min(seg0 + seg, hi_e)
                    if seg_lo >= seg_hi:
                        continue
                    vx_lo = (seg_lo - rowbase) // c
                    vx_hi = (seg_hi - 1 - rowbase) // c
                    listed = [i for i in range(len(st))
                              if 0 <= zz - st[i, 0] < pd
                              and 0 <= yy - st[i, 1] < ph
                              and st[i, 2] <= vx_hi and st[i, 2] + pw > vx_lo]
                    if not listed:
                        continue
                    for t in range(nt):
                        e0 = seg0 + t * V
                        if e0 >= seg_hi or e0 + V <= seg_lo:
                            continue
                        e = np.arange(e0, e0 + V)
                        in_box = (e >= seg_lo) & (e < seg_hi)
                        r = np.where(in_box, e - rowbase, 0)
                        ex, ec = r // c, r % c
                        cov = np.zeros(V, bool)
                        for i in listed:
                            cov |= in_box & (ex >= st[i, 2]) & (
                                ex < st[i, 2] + pw)
                        if not cov.any():
                            continue
                        assert e0 % V == 0  # 16 bytes of acc
                        paths["vec maps" if cov.all() else "scalar maps"] += 1
                        a = a_map[e0:e0 + V].copy()
                        m = m_map[e0:e0 + V].copy()
                        for i in listed:  # patch order
                            px = st[i, 2]
                            inside = in_box & (ex >= px) & (ex < px + pw)
                            idx = (off0 + (i0 + i) * sb
                                   + (zz - st[i, 0]) * sz
                                   + (yy - st[i, 1]) * sy
                                   + (ex - px) * sx + ec * sc)
                            run = sc == 1 and sx == c
                            vec = inside.all() and run and idx[0] % V == 0
                            if inside.any():
                                paths["vec patch" if vec
                                      else "scalar patch"] += 1
                            if vec:
                                assert (np.diff(idx) == 1).all()
                            w = wt[i]
                            for k in np.flatnonzero(inside):
                                a[k] = np.float32(a[k] + np.float32(
                                    w * vals[idx[k]]))
                                m[k] = np.float32(m[k] + w)
                        for k in np.flatnonzero(cov):
                            a_map[e0 + k], m_map[e0 + k] = a[k], m[k]
                            written[e0 + k] += 1
        # each element of the chunk's windows written exactly once, no other
        want = np.zeros((d_, h_, w_, c), np.int32)
        for z, y, x in st:
            want[z:z + pd, y:y + ph, x:x + pw] = 1
        np.testing.assert_array_equal(written.reshape(want.shape), want)
    return (a_map.reshape(acc.shape), m_map.reshape(acc.shape), paths)


def _view(base_shape, halo, c0, c, dtype, seed):
    """A halo-stripped channel view of a seeded (P, ...) network output, as
    the predictor passes it."""
    rng = np.random.default_rng(seed)
    base = torch.from_numpy(rng.standard_normal(base_shape).astype(
        np.float32)).to(dtype)
    sl = tuple(slice(h, n - h) for h, n in zip(halo, base_shape[1:4]))
    return base[(slice(None),) + sl + (slice(c0, c0 + c),)]


VIEW_CASES = [
    # (network output, halo, first channel, channels, volume, starts, valid)
    ((5, 4, 8, 9, 2), (0, 0, 0), 0, 2, VOLUME, STARTS, VALID),
    ((5, 6, 12, 11, 3), (1, 2, 1), 1, 1, VOLUME, STARTS, VALID),
    ((4, 8, 12, 20, 1), (2, 2, 4), 0, 1, (8, 16, 24),
     np.array([[0, 0, 0], [0, 0, 12], [0, 8, 0], [4, 8, 12]], np.int32),
     np.array([1, 1, 1, 0], np.float32)),
    ((6, 11, 11, 9, 3), (2, 1, 2), 0, 2, (9, 11, 13),
     np.array([[0, 0, 0], [1, 1, 1], [2, 2, 8], [2, 0, 4], [0, 2, 3],
               [0, 2, 3]], np.int32),
     np.array([1, 1, 1, 1, 1, 0], np.float32)),
]


@pytest.mark.parametrize("case", range(len(VIEW_CASES)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_partition_writes_each_element_once_bit_exactly(case, dtype):
    base_shape, halo, c0, c, vol, starts, valid = VIEW_CASES[case]
    p = _view(base_shape, halo, c0, c, dtype, seed=case)
    rng = np.random.default_rng(10 + case)
    acc = torch.from_numpy(rng.standard_normal((*vol, c)).astype(np.float32))
    cnt = torch.from_numpy(rng.integers(0, 3, (*vol, c)).astype(np.float32))
    ea, em, paths = _emulate(acc, cnt, p, starts, valid)
    overlap.overlap_add_into_reference(acc, cnt, p, starts, valid)
    np.testing.assert_array_equal(ea, acc.numpy())
    np.testing.assert_array_equal(em, cnt.numpy())
    assert paths["launches"] == 1 and paths["vec maps"] > 0


def test_kernel_partition_vector_and_scalar_paths():
    """The predictor's one-channel halo view (x stride = C) at aligned
    starts: every access a vector.  A channel slice of a wider output (x
    stride != C) loads patches element by element, and ragged rows take
    scalars at their heads and tails and beside patch edges."""
    for case, aligned in ((2, True), (1, False)):
        base_shape, halo, c0, c, vol, starts, valid = VIEW_CASES[case]
        p = _view(base_shape, halo, c0, c, torch.float32, seed=case)
        zeros = torch.zeros((*vol, c))
        _, _, paths = _emulate(zeros, zeros.clone(), p, starts, valid)
        assert paths["vec maps"] > 0
        assert (paths["scalar maps"] == 0) == aligned
        assert (paths["scalar patch"] == 0) == aligned
        assert (paths["vec patch"] > 0) == aligned


def test_kernel_partition_chunks_launch_in_patch_order():
    """More patches than one launch's table: K-patch chunks, in order, each
    reading what the one before wrote, bit-identical to one sequential
    pass."""
    rng = np.random.default_rng(3)
    p_count = overlap.CHUNK + 22
    starts = np.stack([np.arange(p_count) % 7, np.arange(p_count) % 8,
                       np.arange(p_count) % 9], 1).astype(np.int32)
    valid = (rng.random(p_count) > 0.1).astype(np.float32)
    p = _view((p_count, 5, 6, 7, 3), (1, 1, 1), 0, 3, torch.float32, seed=4)
    acc = torch.from_numpy(rng.standard_normal((9, 11, 13, 3)).astype(
        np.float32))
    cnt = torch.zeros_like(acc)
    ea, em, paths = _emulate(acc, cnt, p, starts, valid)
    overlap.overlap_add_into_reference(acc, cnt, p, starts, valid)
    assert paths["launches"] == 2
    np.testing.assert_array_equal(ea, acc.numpy())
    np.testing.assert_array_equal(em, cnt.numpy())


@pytest.mark.parametrize("case", range(1, len(VIEW_CASES)))
def test_plain_version_reads_a_haloed_view_like_its_copy_and_jax(case):
    """The plain version on the strided, halo-stripped view equals it on a
    contiguous copy and the JAX Pallas kernel (interpret mode) on the
    stripped patches, exactly."""
    base_shape, halo, c0, c, vol, starts, valid = VIEW_CASES[case]
    p = _view(base_shape, halo, c0, c, torch.float32, seed=case)
    assert not p.is_contiguous()
    rng = np.random.default_rng(20 + case)
    acc = rng.standard_normal((*vol, c)).astype(np.float32)
    cnt = rng.integers(0, 3, (*vol, c)).astype(np.float32)
    got = overlap.overlap_add_into(torch.from_numpy(acc.copy()),
                                   torch.from_numpy(cnt.copy()), p, starts,
                                   valid)
    copy = overlap.overlap_add_into(torch.from_numpy(acc.copy()),
                                    torch.from_numpy(cnt.copy()),
                                    p.contiguous(), starts, valid)
    ja, jc = jax_overlap.overlap_add_into_pallas(
        jnp.asarray(acc), jnp.asarray(cnt), jnp.asarray(p.contiguous().numpy()),
        jnp.asarray(starts), jnp.asarray(valid), interpret=True)
    for g, cp, j in zip(got, copy, (ja, jc)):
        np.testing.assert_array_equal(g.numpy(), cp.numpy())
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))

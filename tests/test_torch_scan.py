"""The port's scan-only entry `scan_level` and the plain versions of its
kernel, on the CPU.

On the CPU `scan_level` runs the plain scan (`tree_trainer.scan_of`);
these tests hold it against the JAX package's XLA scan `_make_scan_fn`
on derived-sibling planes (parent minus the built child, zeros under
non-split parents: what the tree scans with this entry), hold the
kernel's per-slot planes' plain version `scan_planes_reference` through
the shared epilogue against the plain 9-tuple (node totals past 2^24
included), and check the kernels' work division `plan_scan`. The CUDA
kernel itself runs in tests/test_torch_cuda.py, on the card.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from shifu_tpu.train.tree_trainer import (  # noqa: E402
    _device_layout,
    _make_scan_fn,
    make_layout,
)
from shifu_tpu_torch.ops import hist_kernel as hk  # noqa: E402
from shifu_tpu_torch.train import tree_trainer as tt  # noqa: E402

NAMES = ("feature", "cut_rank", "rank_flat", "leaf_value", "is_split",
         "best_gain", "left_mask", "node_cnt", "left_cnt")
# the ragged layout of test_hist_pallas.py: narrow numerics, 33/65-wide
# categoricals and one 1500-slot categorical (past the kernel's cap)
SLOTS = [9] * 6 + [33, 65] + [1500]
IS_CAT = [False] * 6 + [True] * 3


def _derived(K=0, Lh=4, n=3000, seed=0, w_scale=1):
    """Derived-sibling planes [P, Lh, T] of a level: the parents'
    histogram minus the built (smaller) children's, zero under the
    parents that did not split; integer weights (times w_scale) and
    0/1 or class labels, so every plane is integer-valued. Returns
    (lay, derived, feat_ok_t)."""
    rng = np.random.default_rng(seed)
    lay = tt.make_layout(SLOTS, IS_CAT)
    codes = np.stack([rng.integers(0, s - 1, size=n) for s in SLOTS],
                     1).astype(np.int32)
    y = (((codes[:, 0] + codes[:, 7]) % K) if K else
         (codes[:, 7] % 3 == 0)).astype(np.float32)
    w = (rng.poisson(1.0, size=n) * w_scale).astype(np.float32)
    node = rng.integers(0, Lh, size=n).astype(np.int32)
    act = rng.random(n) < 0.95
    built_row = act & ((codes[:, 1] + rng.integers(0, 3, size=n)) % 2 == 0)
    t = torch.as_tensor
    args = (t(codes), t(y), t(w), t(node))
    p_hist = hk.hist_level_reference(*args, t(act), L=Lh, lay=lay,
                                     n_classes=K)
    built = hk.hist_level_reference(*args, t(built_row), L=Lh, lay=lay,
                                    n_classes=K)
    p_split = t(np.arange(Lh) != 1)  # parent 1 did not split
    left_small = t(rng.random(Lh) < 0.5)
    derived, _full = tt._derive(p_hist, built, p_split, left_small)
    fok = torch.ones(lay.T, dtype=torch.bool)
    fok[lay.off[2]:lay.off[2] + lay.slots[2]] = False  # outside the subset
    return lay, derived.contiguous(), fok


def _jax_scan(derived, fok, impurity, K, min_inst=2):
    jlay = make_layout(SLOTS, IS_CAT)
    la = _device_layout(jlay, np.ones(len(SLOTS), bool))
    fn = jax.jit(_make_scan_fn(derived.shape[1], jlay.T, jlay.s_max,
                               impurity, min_inst, 0.0, K))
    out = fn(jnp.asarray(derived.numpy()), jnp.asarray(fok.numpy()),
             la.is_cat_t, la.seg_t, la.pos_t, la.start_t, la.size_t, la.off,
             la.clip, int(SLOTS[0]))
    return [np.asarray(a) for a in out]


@pytest.mark.parametrize("K", [0, 4])
def test_scan_level_on_the_cpu_is_the_plain_scan(K):
    """On a CPU tensor `scan_level` runs `scan_of(K)` on the same
    histogram, and counts a plain-version call under its mode's name."""
    lay, derived, fok = _derived(K=K)
    kw = dict(impurity="gini", min_inst=2, min_gain=0.0)
    hk.reset_counters()
    out = hk.scan_level(derived, fok, lay=lay, n_classes=K, **kw)
    ref = tt.scan_of(K)(derived, fok, tt.scan_layout(lay, derived.device),
                        **kw)
    for nm, a, b in zip(NAMES, ref, out):
        assert torch.equal(a, b), nm
    name = "scan_level_mc" if K else "scan_level"
    assert hk.reference_calls[name] == 1
    assert sum(hk.reference_calls.values()) == 1
    assert sum(hk.launches.values()) == 0


@pytest.mark.parametrize("K,impurity", [(0, "variance"), (0, "gini"),
                                        (3, "gini"), (3, "entropy"),
                                        (5, "gini"), (5, "entropy")])
def test_derived_sibling_scan_matches_jax(K, impurity):
    """The scan of a derived sibling: the port's plain scan (what
    `scan_level` runs on the CPU) against the JAX package's XLA scan
    `_make_scan_fn` on the same planes. Row totals stay below 2^24, where
    the JAX scan's f32 running sum is exact (ROADMAP C.2): every field
    is bit-equal, the gains of variance and of gini in both modes too
    (the class gain rounds as XLA's fused multiply-adds); entropy gains
    may differ by an ulp of log2 (rtol 1e-6)."""
    lay, derived, fok = _derived(K=K, seed=K + 1)
    assert float(derived.sum(0).sum(1).max()) < 2 ** 24
    out = hk.scan_level(derived, fok, lay=lay, impurity=impurity,
                        min_inst=2, min_gain=0.0, n_classes=K)
    ref = _jax_scan(derived, fok, impurity, K)
    for nm, a, b in zip(NAMES, ref, out):
        b = b.numpy()
        if nm == "best_gain" and impurity == "entropy":
            fin = np.isfinite(a)
            np.testing.assert_array_equal(np.isfinite(b), fin, err_msg=nm)
            np.testing.assert_allclose(b[fin], a[fin], rtol=1e-6, err_msg=nm)
        else:
            np.testing.assert_array_equal(b, a, err_msg=nm)
    assert out[4].any() and not out[4][1]  # parent 1's slot never splits


@pytest.mark.parametrize("K,impurity,w_scale", [
    (0, "variance", 1), (0, "friedmanmse", 1), (0, "entropy", 1),
    (0, "gini", 1), (0, "variance", 3_000_000), (3, "gini", 1),
    (5, "entropy", 1), (5, "gini", 3_000_000)])
def test_scan_planes_reference_through_epilogue(K, impurity, w_scale):
    """The scan kernels' per-slot planes, plainly (per node and segment,
    f64 segment sums rounded once), turned into the 9-tuple by the
    shared epilogue, equal the plain scan's 9-tuple bit for bit on
    derived-sibling planes, every impurity of both modes; also where a
    node's total passes 2^24 (w_scale), where an f32 prefix sum would no
    longer be exact."""
    lay, derived, fok = _derived(K=K, seed=10 + K, w_scale=w_scale)
    if w_scale > 1:  # a node's total: its count over segment 0's slots
        cnt = tt.class_sum(derived) if K else derived[0]
        assert float(cnt[:, :SLOTS[0]].sum(1).max()) > 2 ** 24
    kw = dict(impurity=impurity, min_inst=2, min_gain=0.0)
    ref = tt.scan_of(K)(derived, fok, tt.scan_layout(lay, derived.device),
                        **kw)
    planes = hk.scan_planes_reference(derived, fok, lay, n_classes=K,
                                      **kw)
    out = hk._epilogue(derived, planes, fok, lay, n_classes=K, **kw)
    for nm, a, b in zip(NAMES, ref, out):
        assert a.dtype == b.dtype, nm
        assert torch.equal(a, b), nm
    assert bool(ref[4].any())


@pytest.mark.parametrize("P", [3, 5, 32])
def test_scan_plan_covers_every_segment_once(P):
    """The scan kernels' work division: every (node, feature) is one
    job, a warp job holds a segment of at most WARP_SLOTS (and the cap)
    slots in its warp's share of the block's shared memory, a block job
    holds a wider one up to the cap (or none past it), and a block's
    dynamic shared memory fits what a Hopper block may opt in to; warps
    take segments only at levels with WARP_JOBS_MIN such jobs; many
    class planes fit fewer warps a block."""
    optin = hk.SMEM_BLOCK_MAX
    cap = hk.seg_cap_for(P, optin)
    words = (2 * P + 3) * 4
    for slots, L in (([33] * 30, 1), ([33] * 30, 32),
                     ([33] * 20 + [65] * 10, 128),
                     ([9] * 6 + [33, 65, 200, 900, 2001], 64),
                     ([3, 129, 1024, 1025], 5)):
        lay = tt.make_layout(slots, [False] * len(slots))
        plan = hk.plan_scan(lay, P, cap, L, optin)
        narrow = sum(s <= min(hk.WARP_SLOTS, cap) for s in slots)
        assert (len(plan.warp_feats) > 0) == (L * narrow
                                              >= hk.WARP_JOBS_MIN)
        assert plan.smem <= optin
        assert 1 <= plan.warps <= hk.SCAN_WARPS
        jobs = plan.jobs(L)
        seen = np.zeros((L, len(slots)), np.int32)
        blocks = {}
        for b, w, l, f in jobs:
            seen[l, f] += 1
            blocks.setdefault(b, set()).add(w)
            if w >= 0:
                assert slots[f] <= min(hk.WARP_SLOTS, cap, plan.wseg)
                assert 0 <= w < plan.warps
                assert (w + 1) * words * plan.wseg <= plan.smem
            else:
                assert (slots[f] > min(hk.WARP_SLOTS, cap)
                        or len(plan.warp_feats) == 0)
                assert slots[f] > cap or words * slots[f] <= plan.smem
        assert (seen == 1).all()
        # a block runs warp jobs or one block job, never both
        assert all(ws == {-1} or -1 not in ws for ws in blocks.values())
        assert sorted(blocks) == list(range(len(blocks)))
    lay = tt.make_layout([hk.WARP_SLOTS] * 4, [True] * 4)
    for P in (3, 32, 100):
        plan = hk.plan_scan(lay, P, hk.seg_cap_for(P, optin), 128, optin)
        assert plan.warps == min(hk.SCAN_WARPS, optin // (
            (2 * P + 3) * 4 * hk.WARP_SLOTS))
    assert plan.warps < hk.SCAN_WARPS

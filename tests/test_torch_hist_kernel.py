"""The port's histogram -> split-scan entries vs the JAX package.

On the CPU the port's wrappers run their plain PyTorch versions
(`hist_level_reference`, `fused_level_reference`); these tests hold those
against the JAX package's XLA histogram and its Pallas kernel in
interpret mode, on the same numpy inputs. The CUDA kernel itself runs
only on the card: tests/test_torch_cuda.py holds it against these plain
versions there (marked `cuda`, skipped without a card).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from shifu_tpu.ops.hist_pallas import (  # noqa: E402
    make_fused_level_fn,
    make_pallas_hist_fn,
)
from shifu_tpu.train.tree_trainer import (  # noqa: E402
    _device_layout,
    _make_hist_fn,
    make_layout,
)
from shifu_tpu_torch.ops import hist_kernel as hk  # noqa: E402
from shifu_tpu_torch.train import tree_trainer as tt  # noqa: E402

NAMES = ("feature", "cut_rank", "rank_flat", "leaf_value", "is_split",
         "best_gain", "left_mask", "node_cnt", "left_cnt")


def _mixed_case(n=1500, seed=0):
    """test_hist_pallas.py's ragged layout: narrow numerics, 33/65-wide
    categoricals and one 1500-slot categorical (wider than the kernel's
    segment cap, so it takes the torch scan route)."""
    rng = np.random.default_rng(seed)
    slots = [9] * 6 + [33, 65] + [1500]
    is_cat = [False] * 6 + [True] * 3
    codes = np.stack([rng.integers(0, s - 1, size=n) for s in slots],
                     1).astype(np.int32)
    y = rng.random(n).astype(np.float32)
    w = rng.integers(1, 4, size=n).astype(np.float32)
    return slots, is_cat, codes, y, w, rng


def _jax_scatter_hist(L, slots, is_cat, codes, y, w, node, active):
    lay = make_layout(slots, is_cat)
    la = _device_layout(lay, np.ones(len(slots), bool))
    fn = jax.jit(_make_hist_fn(L, lay, allow_matmul=False))
    return np.asarray(fn(jnp.asarray(codes), jnp.asarray(y), jnp.asarray(w),
                         jnp.asarray(node), jnp.asarray(active), la.off,
                         la.clip, la.seg_t, la.pos_t))


def _jax_pallas_hist(L, slots, is_cat, codes, y, w, node, active,
                     low_precision=False):
    lay = make_layout(slots, is_cat)
    fn = jax.jit(make_pallas_hist_fn(L, lay, interpret=True,
                                     low_precision=low_precision))
    return np.asarray(fn(jnp.asarray(codes), jnp.asarray(y), jnp.asarray(w),
                         jnp.asarray(node), jnp.asarray(active)))


def _port_hist(L, slots, is_cat, codes, y, w, node, active,
               low_precision=False):
    lay = tt.make_layout(slots, is_cat)
    t = torch.as_tensor
    return hk.hist_level_reference(
        t(codes), t(y), t(w), t(node), t(active), L=L, lay=lay,
        low_precision=low_precision).numpy()


def test_hist_matches_jax_scatter_and_pallas():
    slots, is_cat, codes, y, w, rng = _mixed_case()
    L = 8
    node = rng.integers(0, L, size=len(y)).astype(np.int32)
    active = rng.random(len(y)) < 0.9
    args = (L, slots, is_cat, codes, y, w, node, active)
    h_port = _port_hist(*args)
    for h_ref in (_jax_scatter_hist(*args), _jax_pallas_hist(*args)):
        # counts: integer weights sum exactly in f32 in any order
        np.testing.assert_array_equal(h_port[0], h_ref[0])
        # moments: equal up to float summation order
        np.testing.assert_allclose(h_port, h_ref, rtol=1e-5, atol=1e-3)


def test_hist_bf16_planes_bounds():
    """bf16 component planes (the GBT precision policy): counts stay
    exact, moments land within one bf16 rounding of the f32 sums; and
    they match the JAX kernel's bf16 planes up to summation order."""
    slots, is_cat, codes, y, w, rng = _mixed_case(n=900, seed=5)
    L = 4
    node = rng.integers(0, L, size=len(y)).astype(np.int32)
    active = np.ones(len(y), bool)
    w1 = np.ones(len(y), np.float32)
    args = (L, slots, is_cat, codes, y, w1, node, active)
    h_port = _port_hist(*args, low_precision=True)
    h_ref = _jax_scatter_hist(*args)
    np.testing.assert_array_equal(h_port[0], h_ref[0])
    np.testing.assert_allclose(h_port[1:], h_ref[1:], rtol=1e-2, atol=0.15)
    h_pl = _jax_pallas_hist(*args, low_precision=True)
    np.testing.assert_allclose(h_port, h_pl, rtol=1e-5, atol=1e-3)


def _fused_pair(impurity, L=4, n=1300, seed=11, min_inst=2):
    slots, is_cat, codes, _y, w, _rng = _mixed_case(n=n, seed=seed)
    y = (codes[:, 0] >= 4).astype(np.float32)  # 0/1 labels: exact planes
    rng = np.random.default_rng(7)
    node = rng.integers(0, L, size=n).astype(np.int32)
    active = rng.random(n) < 0.95
    feat_ok = np.ones(len(slots), bool)
    feat_ok[2] = False  # one feature outside the tree's subset
    jlay = make_layout(slots, is_cat)
    fot = feat_ok[jlay.seg_of_t]
    fused = jax.jit(make_fused_level_fn(L, jlay, impurity, min_inst, 0.0,
                                        interpret=True))
    j_hist, j_out = fused(jnp.asarray(codes), None, jnp.asarray(y),
                          jnp.asarray(w), jnp.asarray(node),
                          jnp.asarray(active), jnp.asarray(fot))
    t = torch.as_tensor
    p_hist, p_out = hk.fused_level_reference(
        t(codes), t(y), t(w), t(node), t(active), t(fot), L=L,
        lay=tt.make_layout(slots, is_cat), impurity=impurity,
        min_inst=min_inst, min_gain=0.0)
    return j_hist, j_out, p_hist, p_out


@pytest.mark.parametrize("impurity", ["variance", "friedmanmse", "entropy",
                                      "gini"])
def test_fused_matches_jax_kernel(impurity):
    """Integer-valued labels and weights: the histogram is bit-equal, the
    9-tuple's integer fields and masks are exact (the wide 1500-slot
    feature included), float stats within rtol 1e-5."""
    j_hist, j_out, p_hist, p_out = _fused_pair(impurity)
    np.testing.assert_array_equal(np.asarray(j_hist), p_hist.numpy())
    for nm, a, b in zip(NAMES, j_out, p_out):
        a, b = np.asarray(a), b.numpy()
        if nm in ("best_gain", "leaf_value", "node_cnt", "left_cnt"):
            np.testing.assert_allclose(b, a, rtol=1e-5, err_msg=nm)
        else:
            np.testing.assert_array_equal(b, a, err_msg=nm)
    assert bool(np.asarray(j_out[4]).any())  # some node really splits


def _class_labels(codes, k):
    """Class indices that follow a numeric and the 65-slot categorical."""
    return ((codes[:, 0] + codes[:, 7]) % k).astype(np.float32)


def test_multiclass_hist_matches_jax_scatter_and_pallas():
    """K = 4 per-class count planes at L = 4 on the ragged layout (the
    1500-slot categorical included): integer weights, so the plain
    histogram equals the JAX XLA histogram and the Pallas kernel in
    interpret mode bit for bit."""
    slots, is_cat, codes, _y, w, rng = _mixed_case()
    K, L = 4, 4
    y = _class_labels(codes, K)
    node = rng.integers(0, L, size=len(y)).astype(np.int32)
    active = rng.random(len(y)) < 0.9
    lay = make_layout(slots, is_cat)
    la = _device_layout(lay, np.ones(len(slots), bool))
    args = (jnp.asarray(codes), jnp.asarray(y), jnp.asarray(w),
            jnp.asarray(node), jnp.asarray(active))
    h_xla = jax.jit(_make_hist_fn(L, lay, allow_matmul=False, n_classes=K))(
        *args, la.off, la.clip, la.seg_t, la.pos_t)
    h_pl = jax.jit(make_pallas_hist_fn(L, lay, n_classes=K,
                                       interpret=True))(*args)
    t = torch.as_tensor
    h_port = hk.hist_level(t(codes), t(y), t(w), t(node), t(active), L=L,
                           lay=tt.make_layout(slots, is_cat), n_classes=K)
    assert h_port.shape == (K, L, lay.T)
    np.testing.assert_array_equal(h_port.numpy(), np.asarray(h_xla))
    np.testing.assert_array_equal(h_port.numpy(), np.asarray(h_pl))


def _fused_cls_pair(impurity, K=4, L=2, n=1300, seed=11):
    slots, is_cat, codes, _y, w, _rng = _mixed_case(n=n, seed=seed)
    y = _class_labels(codes, K)
    rng = np.random.default_rng(7)
    node = rng.integers(0, L, size=n).astype(np.int32)
    active = rng.random(n) < 0.95
    feat_ok = np.ones(len(slots), bool)
    feat_ok[2] = False
    jlay = make_layout(slots, is_cat)
    fot = feat_ok[jlay.seg_of_t]
    fused = jax.jit(make_fused_level_fn(L, jlay, impurity, 2, 0.0,
                                        n_classes=K, interpret=True))
    j_hist, j_out = fused(jnp.asarray(codes), None, jnp.asarray(y),
                          jnp.asarray(w), jnp.asarray(node),
                          jnp.asarray(active), jnp.asarray(fot))
    t = torch.as_tensor
    p_hist, p_out = hk.fused_level(
        t(codes), t(y), t(w), t(node), t(active), t(fot), L=L,
        lay=tt.make_layout(slots, is_cat), impurity=impurity, min_inst=2,
        min_gain=0.0, n_classes=K)
    return j_hist, j_out, p_hist, p_out


@pytest.mark.parametrize("impurity", ["gini", "entropy", "variance"])
def test_fused_multiclass_matches_jax_kernel(impurity):
    """The plain fused multi-class level against the Pallas kernel in
    interpret mode at L = 2, the 1500-slot categorical (the wide route)
    included. Integer weights: the K planes are bit-equal. gini (and
    variance, which falls back to gini): every field of the 9-tuple is
    exact. entropy: log2 may differ by an ulp between torch and XLA, so
    best_gain is held at rtol 1e-6 and the discrete fields exactly; a
    flipped near-tie names its node and both gains."""
    j_hist, j_out, p_hist, p_out = _fused_cls_pair(impurity)
    np.testing.assert_array_equal(np.asarray(j_hist), p_hist.numpy())
    j = {nm: np.asarray(a) for nm, a in zip(NAMES, j_out)}
    p = {nm: b.numpy() for nm, b in zip(NAMES, p_out)}
    for l in range(len(j["feature"])):
        assert (j["feature"][l], j["cut_rank"][l]) == (
            p["feature"][l], p["cut_rank"][l]), (
            f"node {l}: JAX splits feature {j['feature'][l]} at rank "
            f"{j['cut_rank'][l]} (gain {j['best_gain'][l]!r}), the port "
            f"feature {p['feature'][l]} at {p['cut_rank'][l]} "
            f"(gain {p['best_gain'][l]!r})")
    for nm in NAMES:
        if nm == "best_gain" and impurity == "entropy":
            np.testing.assert_allclose(p[nm], j[nm], rtol=1e-6, err_msg=nm)
        else:
            np.testing.assert_array_equal(p[nm], j[nm], err_msg=nm)
    assert j["is_split"].any()
    assert set(np.unique(p["leaf_value"])) <= set(range(4))


@pytest.mark.parametrize("wide_first,w_scale", [(False, 1), (True, 1),
                                                (False, 4097)])
def test_kernel_epilogue_reproduces_reference(wide_first, w_scale):
    """The wrapper's torch epilogue (argmax with the ordered-position
    tie-break, the wide-feature merge, rank_flat, left mask, node stats)
    turns the kernel's planes (their plain version,
    `scan_planes_reference`) into exactly the reference 9-tuple — also
    when the widest feature is segment 0 and owns the node totals, and
    when a node's row of slots sums past 2^24 while each segment stays
    below it (w_scale: the plain scan's running sums must stay exact
    across segments, as the kernel's per-segment sums are)."""
    rng = np.random.default_rng(3)
    slots = ([1500, 9, 33] if wide_first
             else [9] * 6 + [33, 65] + [1500])
    is_cat = ([True, False, True] if wide_first
              else [False] * 6 + [True] * 3)
    lay = tt.make_layout(slots, is_cat)
    n, L = 1500, 4
    codes = np.stack([rng.integers(0, s - 1, size=n) for s in slots],
                     1).astype(np.int32)
    t = torch.as_tensor
    # heavy case: the label follows the 65-slot categorical (segment 7),
    # so the best split's sums sit far past 2^24 in the running sum
    y = t((codes[:, 0] >= 4) if w_scale == 1 else (codes[:, 7] % 2 == 0)
          ).to(torch.float32)
    w = t((rng.integers(1, 4, size=n) * w_scale).astype(np.float32))
    node = t(rng.integers(0, L, size=n).astype(np.int32))
    act = t(rng.random(n) < 0.95)
    fok = torch.ones(lay.T, dtype=torch.bool)
    fok[lay.off[1]:lay.off[1] + lay.slots[1]] = False
    hist, ref = hk.fused_level_reference(t(codes), y, w, node, act, fok, L=L,
                                         lay=lay, impurity="variance",
                                         min_inst=2, min_gain=0.0)
    if w_scale > 1:
        assert float(hist[0].sum(1).max()) > 2 ** 24
    planes = hk.scan_planes_reference(hist, fok, lay, "variance", 2, 0.0)
    out = hk._epilogue(hist, planes, fok, lay, "variance", 2, 0.0)
    for nm, a, b in zip(NAMES, ref, out):
        assert a.dtype == b.dtype, nm
        assert torch.equal(a, b), nm


@pytest.mark.parametrize("K,cap", [(3, hk.SEG_CAP), (5, hk.SEG_CAP),
                                   (5, 40)])
def test_kernel_epilogue_reproduces_class_reference(K, cap):
    """Class mode: the epilogue turns the kernel's planes into exactly the
    plain multi-class 9-tuple (node count summed in class order, first
    majority class), also when a narrower segment cap (many class planes
    in shared memory) sends the 65-slot categorical to the wide route."""
    slots, is_cat, codes, _y, w, rng = _mixed_case(n=1400, seed=8)
    lay = tt.make_layout(slots, is_cat)
    L = 4
    t = torch.as_tensor
    y = t(_class_labels(codes, K))
    node = t(rng.integers(0, L, size=len(y)).astype(np.int32))
    act = t(rng.random(len(y)) < 0.95)
    fok = torch.ones(lay.T, dtype=torch.bool)
    fok[lay.off[1]:lay.off[1] + lay.slots[1]] = False
    hist, ref = hk.fused_level_reference(t(codes), y, t(w), node, act, fok,
                                         L=L, lay=lay, impurity="gini",
                                         min_inst=2, min_gain=0.0,
                                         n_classes=K)
    planes = hk.scan_planes_reference(hist, fok, lay, "gini", 2, 0.0, K, cap)
    out = hk._epilogue(hist, planes, fok, lay, "gini", 2, 0.0, K, cap)
    for nm, a, b in zip(NAMES, ref, out):
        assert a.dtype == b.dtype, nm
        assert torch.equal(a, b), nm
    assert bool(ref[4].any())


def _tiles_seen(plan, L, T):
    """How often each (node, slot) bin lies in a tile of the plan."""
    seen = np.zeros((L, T), np.int32)
    for g in range(plan.n_groups):
        l_lo = g * plan.l_n
        for f_lo, f_hi, t_lo, t_w, _nf in plan.ttiles:
            seen[l_lo:l_lo + plan.l_n, t_lo:t_lo + t_w] += 1
    return seen


def test_class_mode_segment_cap_and_tiles():
    """Shared memory a class-mode scan needs: (2K + 3) words a slot, so
    1,024 slots fit for K <= 28 in 227 KB (232,448 B) and K = 32 scans
    867; the accumulate tile holds its K planes' bins (32- or 64-bit) and
    the feature table in the shared memory of `tile_bytes_for` (at most a
    little more where the widest slot range and the longest feature table
    are two ranges)."""
    optin = 232_448
    assert hk.seg_cap_for(3, optin) == hk.SEG_CAP
    assert hk.seg_cap_for(8, optin) == hk.SEG_CAP
    assert (2 * 8 + 3) * 4 * hk.SEG_CAP > 48 * 1024  # past the static limit
    assert hk.seg_cap_for(32, optin) == 867
    assert hk.seg_cap_for(32, optin) * (2 * 32 + 3) * 4 <= optin
    lay = tt.make_layout([33] * 20 + [65] * 10, [False] * 20 + [True] * 10)
    for K in (3, 8, 32):
        for bins32 in (False, True):
            plan = hk.plan_accumulate(lay, 128, K, bins32)
            assert plan.planes == K
            bb = K * (4 if bins32 else 8)
            assert plan.smem == (plan.tab_bytes
                                 + bb * plan.l_n * int(plan.ttiles[:, 3].max()))
            assert plan.smem <= hk.SMEM_BLOCK_MAX
            assert plan.smem <= hk.tile_bytes_for(K, bins32) + 16 * 30
            assert (_tiles_seen(plan, 128, lay.T) == 1).all()


def test_cpu_wrappers_run_plain_versions_and_count():
    slots, is_cat, codes, y, w, rng = _mixed_case(n=400, seed=2)
    lay = tt.make_layout(slots, is_cat)
    t = torch.as_tensor
    node = t(rng.integers(0, 2, size=400).astype(np.int32))
    act = torch.ones(400, dtype=torch.bool)
    fok = torch.ones(lay.T, dtype=torch.bool)
    hk.reset_counters()
    h = hk.hist_level(t(codes), t(y), t(w), node, act, L=2, lay=lay)
    h2, _ = hk.fused_level(t(codes), t(y), t(w), node, act, fok, L=2,
                           lay=lay, impurity="gini", min_inst=1,
                           min_gain=0.0)
    assert torch.equal(h, h2)
    cls = t((codes[:, 0] % 4).astype(np.float32))
    h3 = hk.hist_level(t(codes), cls, t(w), node, act, L=2, lay=lay,
                       n_classes=4)
    hk.scan_level(h, fok, lay=lay, impurity="gini", min_inst=1, min_gain=0.0)
    hk.scan_level(h3, fok, lay=lay, impurity="gini", min_inst=1,
                  min_gain=0.0, n_classes=4)
    assert hk.reference_calls == {"hist_level": 1, "fused_level": 1,
                                  "scan_level": 1, "hist_level_mc": 1,
                                  "fused_level_mc": 0, "scan_level_mc": 1}
    assert hk.launches == {"hist_level": 0, "fused_level": 0,
                           "scan_level": 0, "hist_level_mc": 0,
                           "fused_level_mc": 0, "scan_level_mc": 0}
    c8 = hk.codes8_of(t(codes), lay)
    assert c8.dtype == torch.int8
    np.testing.assert_array_equal(c8[:, :8].numpy(), codes[:, :8])


def test_tiles_cover_every_bin_within_shared_memory():
    """The accumulate tiling covers each (node, slot) bin exactly once,
    its slot ranges end on feature boundaries (only a feature wider than
    a tile is split, so each (row, feature) pair falls in one tile), and
    every block fits the kernel's shared-memory budget."""
    for slots, L in (([33] * 30, 32), ([33] * 20 + [65] * 10, 128),
                     ([9] * 6 + [2001], 16), ([10_000], 1)):
        lay = tt.make_layout(slots, [False] * len(slots))
        for bins32 in (False, True):
            plan = hk.plan_accumulate(lay, L, 0, bins32)
            assert plan.smem <= hk.SMEM_BLOCK_MAX
            assert plan.n_groups * plan.l_n >= L > (plan.n_groups - 1) * plan.l_n
            nf_before = 0
            for f_lo, f_hi, t_lo, t_w, nf in plan.ttiles:
                assert nf == nf_before
                nf_before += f_hi - f_lo
                assert f_lo == lay.seg_of_t[t_lo]
                assert f_hi - 1 == lay.seg_of_t[t_lo + t_w - 1]
                if f_hi - f_lo > 1 or t_w == lay.slots[f_lo]:
                    assert t_lo == lay.off[f_lo]
                    assert t_lo + t_w == lay.off[f_hi - 1] + lay.slots[f_hi - 1]
            assert nf_before == plan.NF
            assert (_tiles_seen(plan, L, lay.T) == 1).all()


# ---------------------------------------------------------------------------
# the exact fixed-point yardstick and the kernels' plan, on the CPU
# ---------------------------------------------------------------------------

RF_SLOTS = [33] * 20 + [65] * 10
RF_CAT = [False] * 20 + [True] * 10


def _level(n, L, seed, *, slots=RF_SLOTS, K=0, weights="poisson",
           labels="binary", rows="random"):
    """Level inputs as numpy: codes, labels (0/1, float residuals or class
    ids), weights (Poisson bags, fractional or large integers), node ids
    in [0, L) with a few out of range (the kernels clamp them), and the
    active mask of `rows`: "random" (90%), "small1"/"small99" (the built
    smaller child holding ~1% / ~99% of the rows), "none" (all
    inactive)."""
    rng = np.random.default_rng(seed)
    codes = np.stack([rng.integers(0, s - 1, size=n) for s in slots],
                     1).astype(np.int32)
    if K >= 3:
        y = ((codes[:, 0] + codes[:, -1]) % K).astype(np.float32)
    elif labels == "float":
        y = (rng.random(n) - 0.35).astype(np.float32)
    else:
        y = (codes[:, 0] >= slots[0] // 2).astype(np.float32)
    w = {"poisson": lambda: rng.poisson(1.0, size=n),
         "frac": lambda: rng.random(n) * 3,
         "big": lambda: rng.integers(1, 4, size=n) * 3_000_000,
         "huge": lambda: np.where(rng.random(n) < 0.01, 2.0 ** 25 + 1,
                                  rng.integers(0, 3, size=n))}[weights]()
    w = w.astype(np.float32)
    node = rng.integers(-1, L + 1, size=n).astype(np.int32)
    frac = {"random": 0.9, "small1": 0.01, "small99": 0.99, "none": 0.0}
    act = rng.random(n) < frac[rows]
    return codes, y, w, node, act


def _t(*arrs):
    return [torch.as_tensor(a) for a in arrs]


@pytest.mark.parametrize("K", [0, 4])
def test_fixed_reference_matches_plain_and_jax(K):
    """The exact fixed-point plain version: bit-equal to the f32 plain
    version and to the JAX package's Pallas kernel (interpret mode) and
    XLA histogram on integer planes, both modes; on float moment planes
    (GBT's bf16 residuals) within the moment tolerance of the f32 sums."""
    slots, is_cat, codes, _y, w, rng = _mixed_case()
    L = 8
    y = (_class_labels(codes, K) if K else
         (codes[:, 0] >= 4).astype(np.float32))
    node = rng.integers(0, L, size=len(y)).astype(np.int32)
    active = rng.random(len(y)) < 0.9
    lay = tt.make_layout(slots, is_cat)
    args = _t(codes, y, w, node, active)
    fixed = hk.hist_level_fixed_reference(*args, L=L, lay=lay, n_classes=K)
    plain = hk.hist_level_reference(*args, L=L, lay=lay, n_classes=K)
    assert torch.equal(fixed, plain)
    jlay = make_layout(slots, is_cat)
    jargs = (jnp.asarray(codes), jnp.asarray(y), jnp.asarray(w),
             jnp.asarray(node), jnp.asarray(active))
    h_pl = jax.jit(make_pallas_hist_fn(L, jlay, n_classes=K,
                                       interpret=True))(*jargs)
    np.testing.assert_array_equal(fixed.numpy(), np.asarray(h_pl))
    if K == 0:
        np.testing.assert_array_equal(
            fixed.numpy(), _jax_scatter_hist(L, slots, is_cat, codes, y, w,
                                             node, active))
        # float moment planes, bf16 as GBT sends them
        yf = (rng.random(len(y)) - 0.4).astype(np.float32)
        args = _t(codes, yf, np.ones_like(w), node, active)
        fixed = hk.hist_level_fixed_reference(*args, L=L, lay=lay,
                                              low_precision=True)
        plain = hk.hist_level_reference(*args, L=L, lay=lay,
                                        low_precision=True)
        assert torch.equal(fixed[0], plain[0])
        lim = 1e-4 * plain.abs() + 1e-5 * plain.abs().amax((1, 2),
                                                           keepdim=True)
        assert bool(((fixed - plain).abs() <= lim).all())
        h_pl = jax.jit(make_pallas_hist_fn(L, jlay, interpret=True,
                                           low_precision=True))(
            jnp.asarray(codes), jnp.asarray(yf), jnp.ones(len(yf)),
            jnp.asarray(node), jnp.asarray(active))
        np.testing.assert_allclose(fixed.numpy(), np.asarray(h_pl),
                                   rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("K", [0, 3, 5, 32])
@pytest.mark.parametrize("L", [1, 8, 32, 64, 128])
def test_prepass_groups_every_live_row_once(L, K):
    """The pre-pass's plain emulation and the tile planner: every live row
    (active, weight != 0) lands in exactly one group, the group of its
    clamped node; every (plane, node, slot) bin lies in exactly one tile;
    a block's shared memory fits 232,448 B; the grouped accumulate keeps
    every 32-bit bin within 2^31 - 1 and equals the ungrouped fixed point
    bit for bit. Row masks: random, a smaller child of 1% and of 99%,
    all inactive; and n = 0 and 1."""
    lay = tt.make_layout(RF_SLOTS, RF_CAT)
    cases = [(3000, rows) for rows in ("random", "small1", "small99",
                                       "none")] + [(0, "random"),
                                                   (1, "random")]
    for bins32 in (True, False):
        plan = hk.plan_accumulate(lay, L, K, bins32)
        assert plan.smem <= 232_448
        assert (_tiles_seen(plan, L, lay.T) == 1).all()
        for n, rows in cases:
            codes, y, w, node, act = _level(n, L, 11 + L + K, K=K, rows=rows)
            args = _t(codes, y, w, node, act)
            gstart, grow, meta, vals, maxabs = hk.group_rows_reference(
                *args[1:], L=L, plan=plan, n_classes=K)
            live = np.flatnonzero(act & (w != 0))
            assert sorted(grow.tolist()) == live.tolist()
            nl = np.clip(node, 0, L - 1)
            g_of = np.repeat(np.arange(plan.n_groups), np.diff(gstart.numpy()))
            np.testing.assert_array_equal(g_of, nl[grow.numpy()] // plan.l_n)
            np.testing.assert_array_equal(
                (meta & 0xFFFF).numpy() + g_of * plan.l_n, nl[grow.numpy()])
            if K:
                np.testing.assert_array_equal(
                    (meta >> 16).numpy(), y[grow.numpy()].astype(np.int64))
            acc = hk.accumulate_reference(args[0], (gstart, grow, meta, vals,
                                                    maxabs), L=L, lay=lay,
                                          plan=plan, n=n)
            ref, ref_max = hk.fixed_acc_reference(*args, L=L, lay=lay,
                                                  n_classes=K)
            assert torch.equal(maxabs, ref_max)
            assert torch.equal(acc, ref), (n, rows, bins32)


@pytest.mark.parametrize("case", ["gbt_bf16", "frac_weights_32", "frac_64",
                                  "int32_codes", "big_weights_32",
                                  "huge_weights_32", "class_frac_32",
                                  "n_odd", "float_labels_32"])
def test_grouped_accumulate_equals_ungrouped(case):
    """The kernels' plan step for step (pre-pass groups, the pairs cut
    into equal spans over blocks, per-tile bins, 32-bit bins flushed as
    v * 2^S every row_cap rows, rows that are no small integers sent to
    the global accumulator) gives the ungrouped fixed point bit for bit,
    whatever the trainer's int_planes says: GBT bf16 planes, fractional
    weights on either route, a 200-slot feature (int32 codes), integer
    weights large enough to make several flushes a block, weights past
    2^24, fractional class weights, float labels, n not a multiple of 8,
    and blocks that cut through groups and tiles."""
    slots, K, lowp, bins32, n = RF_SLOTS, 0, False, True, 3000
    kw = {}
    if case == "gbt_bf16":
        kw, lowp, bins32 = dict(labels="float", weights="frac"), True, False
    elif case == "frac_weights_32":
        kw = dict(weights="frac")
    elif case == "frac_64":
        kw, bins32 = dict(weights="frac"), False
    elif case == "int32_codes":
        slots = [33] * 8 + [200, 65]
    elif case == "big_weights_32":
        kw = dict(weights="big")
    elif case == "huge_weights_32":
        kw = dict(weights="huge")
    elif case == "class_frac_32":
        K, kw = 5, dict(weights="frac")
    elif case == "n_odd":
        n = 2999
    elif case == "float_labels_32":
        kw = dict(labels="float")
    L = 16
    lay = tt.make_layout(slots, [False] * len(slots))
    codes, y, w, node, act = _level(n, L, 3, slots=slots, K=K, **kw)
    args = _t(codes, y, w, node, act)
    plan = hk.plan_accumulate(lay, L, K, bins32, tile_bytes=6 * 1024)
    assert plan.n_groups > 1 and len(plan.ttiles) > 1
    grouped = hk.group_rows_reference(*args[1:], L=L, plan=plan,
                                      low_precision=lowp, n_classes=K)
    ref, _m = hk.fixed_acc_reference(*args, L=L, lay=lay, low_precision=lowp,
                                     n_classes=K)
    for blocks in (1, 7, 64):
        acc = hk.accumulate_reference(args[0], grouped, L=L, lay=lay,
                                      plan=plan, n=n, blocks=blocks)
        assert torch.equal(acc, ref), blocks
    planes = hk.fixed_planes(ref, grouped[4], n)
    exact = hk.hist_level_fixed_reference(*args, L=L, lay=lay,
                                          low_precision=lowp, n_classes=K)
    assert torch.equal(planes, exact)


def test_int_planes_decision():
    """32-bit shared bins only where every plane value is an integer:
    Poisson-bagged integer weights with 0/1 labels, or any integer
    weights in class mode; fractional weights, float labels (regression
    RF: w*y is then no integer) and GBT's bf16 planes take 64 bits."""
    rng = np.random.default_rng(0)
    n = 1000
    bag = torch.as_tensor(rng.poisson(1.0, size=n).astype(np.float32))
    y01 = torch.as_tensor((rng.random(n) < 0.3).astype(np.float32))
    yf = torch.as_tensor(rng.random(n).astype(np.float32))
    ones = torch.ones(n)
    assert tt.int_planes_of(y01, ones * bag, 0, False)
    assert tt.int_planes_of(yf, ones * bag, 5, False)
    assert not tt.int_planes_of(yf, ones * bag, 0, False)
    assert not tt.int_planes_of(y01, (ones * 0.5) * bag, 0, False)
    assert not tt.int_planes_of(y01, (ones * 0.5) * bag, 5, False)
    assert not tt.int_planes_of(y01, ones * bag, 0, True)


def test_codes8_rows_padded_for_wide_loads():
    """codes8_of's rows sit 16 bytes apart in memory (the kernel reads
    them 16 bytes at a time) and hold the clamped int8 codes."""
    slots, is_cat, codes, *_ = _mixed_case(n=50, seed=1)
    lay = tt.make_layout(slots, is_cat)
    c8 = hk.codes8_of(torch.as_tensor(codes), lay)
    assert c8.shape == codes.shape and c8.stride() == (16, 1)
    np.testing.assert_array_equal(c8.numpy()[:, :8], codes[:, :8])
    wide = hk.codes8_of(torch.zeros((3, 17), dtype=torch.int32),
                        tt.make_layout([9] * 17, [False] * 17))
    assert wide.stride() == (32, 1)

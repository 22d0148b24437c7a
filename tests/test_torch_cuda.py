"""The CUDA histogram -> split-scan kernels against their plain PyTorch
versions, on the card. Every test here is marked `cuda` and skips without
a CUDA device (the kernels have no CPU mode); this file imports no JAX, so
it runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from shifu_tpu_torch.ops import hist_kernel as hk  # noqa: E402
from shifu_tpu_torch.train import tree_trainer as tt  # noqa: E402

NAMES = ("feature", "cut_rank", "rank_flat", "leaf_value", "is_split",
         "best_gain", "left_mask", "node_cnt", "left_cnt")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _case(dev, slots, is_cat, n, L, seed):
    rng = np.random.default_rng(seed)
    lay = tt.make_layout(slots, is_cat)
    codes = np.stack([rng.integers(0, s - 1, size=n) for s in slots],
                     1).astype(np.int32)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    y = t((codes[:, 0] >= slots[0] // 2).astype(np.float32))  # exact planes
    w = t(rng.poisson(1.0, size=n).astype(np.float32))
    node = t(rng.integers(0, L, size=n).astype(np.int32))
    act = t(rng.random(n) < 0.9)
    return lay, t(codes), y, w, node, act


@pytest.mark.cuda
@pytest.mark.parametrize("slots,is_cat,L", [
    ([9] * 6 + [33, 65] + [1500], [False] * 6 + [True] * 3, 8),
    ([1500, 9, 33], [True, False, True], 4),
    ([33] * 30, [False] * 30, 32),
])
@pytest.mark.parametrize("impurity", ["variance", "gini"])
def test_fused_kernel_matches_plain(dev, slots, is_cat, L, impurity):
    """Integer-valued planes: histogram and the whole 9-tuple exact."""
    lay, codes, y, w, node, act = _case(dev, slots, is_cat, 20_000, L, 9)
    fok = torch.ones(lay.T, dtype=torch.bool, device=dev)
    fok[int(lay.off[1]):int(lay.off[1] + lay.slots[1])] = False
    kw = dict(L=L, lay=lay, impurity=impurity, min_inst=2, min_gain=0.0)
    c8 = hk.codes8_of(codes, lay) if lay.s_max <= 128 else None
    h_k, out_k = hk.fused_level(codes, y, w, node, act, fok, codes8=c8, **kw)
    h_p, out_p = hk.fused_level_reference(codes, y, w, node, act, fok, **kw)
    torch.cuda.synchronize()
    assert torch.equal(h_k, h_p)
    for nm, a, b in zip(NAMES, out_p, out_k):
        assert torch.equal(a, b), nm


@pytest.mark.cuda
@pytest.mark.parametrize("L", [64, 128])
def test_hist_kernel_matches_plain(dev, L):
    slots = [33] * 20 + [65] * 10
    lay, codes, y, w, node, act = _case(dev, slots, [False] * 20 + [True] * 10,
                                        50_000, L, 4)
    h_k = hk.hist_level(codes, y, w, node, act, L=L, lay=lay,
                        codes8=hk.codes8_of(codes, lay))
    h_p = hk.hist_level_reference(codes, y, w, node, act, L=L, lay=lay)
    torch.cuda.synchronize()
    assert torch.equal(h_k, h_p)


@pytest.mark.cuda
def test_bf16_planes_close_and_deterministic(dev):
    """Float GBT planes: counts exact, moments within summation-order
    tolerance of the plain version and bit-equal to the fixed-point plain
    version, and two launches give the same bits."""
    lay, codes, _y, _w, node, act = _case(dev, [33] * 30, [False] * 30,
                                          100_000, 16, 2)
    g = torch.Generator(device="cpu").manual_seed(0)
    y = (torch.rand(codes.shape[0], generator=g) - 0.4).to(dev)
    w = torch.ones_like(y)
    kw = dict(L=16, lay=lay, low_precision=True)
    h1 = hk.hist_level(codes, y, w, node, act, **kw)
    h2 = hk.hist_level(codes, y, w, node, act, **kw)
    hp = hk.hist_level_reference(codes, y, w, node, act, **kw)
    hf = hk.hist_level_fixed_reference(codes, y, w, node, act, **kw)
    torch.cuda.synchronize()
    assert torch.equal(h1, h2)
    assert torch.equal(h1[0], hp[0])
    torch.testing.assert_close(h1, hp, rtol=1e-4, atol=1e-3)
    assert torch.equal(h1, hf)


@pytest.mark.cuda
def test_wrappers_raise_on_bad_inputs(dev):
    lay, codes, y, w, node, act = _case(dev, [9, 9], [False, False], 100, 2,
                                        0)
    with pytest.raises(TypeError):
        hk.hist_level(codes.long(), y, w, node, act, L=2, lay=lay)
    with pytest.raises(ValueError):
        hk.hist_level(codes, y.cpu(), w, node, act, L=2, lay=lay)
    with pytest.raises(ValueError):  # int8 rows not padded to 16 bytes
        hk.hist_level(codes, y, w, node, act, L=2, lay=lay,
                      codes8=codes.to(torch.int8))
    with pytest.raises(TypeError):
        hk.hist_level(codes, y, w, node, act.float(), L=2, lay=lay)


def _level(dev, slots, n, L, seed, *, K=0, weights="poisson",
           labels="binary", rows="random", node64=False):
    """Level inputs on the card: Poisson, fractional or unit weights;
    0/1, float or class labels; node ids (int32, or int64 with node64)
    with a few out of range; the active rows random (90%), none, or the
    built smaller child of a split holding ~1% / ~99% of them."""
    rng = np.random.default_rng(seed)
    codes = np.stack([rng.integers(0, s - 1, size=n) for s in slots],
                     1).astype(np.int32)
    if K >= 3:
        y = ((codes[:, 0] + codes[:, -1]) % K).astype(np.float32)
    elif labels == "float":
        y = (rng.random(n) - 0.35).astype(np.float32)
    else:
        y = (codes[:, 0] >= slots[0] // 2).astype(np.float32)
    w = {"poisson": rng.poisson(1.0, size=n), "frac": rng.random(n) * 3,
         "ones": np.ones(n)}[weights].astype(np.float32)
    node = rng.integers(-1, L + 1, size=n).astype(
        np.int64 if node64 else np.int32)
    if rows == "random":
        act = rng.random(n) < 0.9
    elif rows == "none":
        act = np.zeros(n, bool)
    else:  # a split's smaller child, built at L nodes (parent ids)
        left = rng.random(n) < {"small1": 0.01, "small99": 0.99}[rows]
        act = left & (rng.random(n) < 0.95)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    lay = tt.make_layout(slots, [False] * len(slots))
    return lay, t(codes), t(y), t(w), t(node), t(act)


BENCH_RF = [33] * 20 + [65] * 10


@pytest.mark.cuda
@pytest.mark.parametrize("case,slots,n,L,K,kw,int_planes", [
    ("class fractional weights (64-bit)", BENCH_RF, 30_000, 8, 5,
     dict(weights="frac"), False),
    ("class fractional weights, told integer", BENCH_RF, 30_000, 8, 5,
     dict(weights="frac"), True),
    ("smaller child 1%", BENCH_RF, 60_000, 16, 0, dict(rows="small1"), True),
    ("smaller child 99%", BENCH_RF, 60_000, 16, 0, dict(rows="small99"),
     True),
    ("class smaller child 1%", BENCH_RF, 60_000, 16, 5, dict(rows="small1"),
     True),
    ("class smaller child 99%", BENCH_RF, 60_000, 16, 5,
     dict(rows="small99"), True),
    ("K=32 L=64", BENCH_RF, 40_000, 64, 32, {}, True),
    ("K=32 L=64 (64-bit)", BENCH_RF, 40_000, 64, 32, {}, False),
    ("gbt bf16", [33] * 30, 50_000, 32, 0,
     dict(labels="float", weights="ones"), False),
    ("int32 codes (200 slots)", [33] * 8 + [200, 65], 30_000, 8, 0, {},
     True),
    ("class int32 codes (200 slots)", [33] * 8 + [200, 65], 30_000, 8, 3,
     {}, True),
    ("n not a multiple of 8", BENCH_RF, 30_001, 32, 0, {}, True),
    ("float labels, moment (64-bit)", BENCH_RF, 30_000, 64, 0,
     dict(labels="float"), False),
    ("L=1, one node group", BENCH_RF, 30_000, 1, 0, {}, True),
    ("class L=1, int64 node ids", BENCH_RF, 30_000, 1, 5,
     dict(node64=True), True),
    ("all rows inactive", BENCH_RF, 30_000, 8, 0, dict(rows="none"), True),
    ("class all rows inactive", BENCH_RF, 30_000, 64, 5, dict(rows="none"),
     True),
    ("n = 0", BENCH_RF, 0, 8, 0, {}, True),
    ("class n = 0", BENCH_RF, 0, 8, 3, {}, False),
    ("n = 1", BENCH_RF, 1, 8, 0, {}, True),
    ("gbt bf16 n = 1", [33] * 30, 1, 4, 0,
     dict(labels="float", weights="ones"), False),
])
def test_kernel_planes_equal_fixed_reference(dev, case, slots, n, L, K, kw,
                                             int_planes):
    """Every mode and route of the accumulate: the kernel's planes are the
    fixed-point plain version's bit for bit, two launches give the same
    bits, and the fused entry's planes equal the histogram entry's."""
    lay, codes, y, w, node, act = _level(dev, slots, n, L, 7, K=K, **kw)
    lowp = kw.get("labels") == "float" and kw.get("weights") == "ones"
    c8 = hk.codes8_of(codes, lay) if lay.s_max <= 128 else None
    args = (codes, y, w, node, act)
    hkw = dict(L=L, lay=lay, low_precision=lowp, n_classes=K)
    h1 = hk.hist_level(*args, codes8=c8, int_planes=int_planes, **hkw)
    h2 = hk.hist_level(*args, codes8=c8, int_planes=int_planes, **hkw)
    hf = hk.hist_level_fixed_reference(*args, **hkw)
    torch.cuda.synchronize()
    assert torch.equal(h1, h2), case
    assert torch.equal(h1, hf), case
    if L <= 32:
        fok = torch.ones(lay.T, dtype=torch.bool, device=dev)
        h3, _out = hk.fused_level(*args, fok, codes8=c8, impurity="gini",
                                  min_inst=2, min_gain=0.0,
                                  int_planes=int_planes, **hkw)
        torch.cuda.synchronize()
        assert torch.equal(h3, hf), case


def _class_case(dev, K, n, L, seed):
    slots = [33] * 20 + [65] * 10
    lay, codes, _y, w, node, act = _case(dev, slots, [False] * 20
                                         + [True] * 10, n, L, seed)
    c = codes.cpu().numpy()
    y = torch.as_tensor(((c[:, 0] + c[:, 25]) % K).astype(np.float32),
                        device=dev)
    return lay, codes, y, w, node, act


@pytest.mark.cuda
@pytest.mark.parametrize("K", [3, 8, 32])
@pytest.mark.parametrize("impurity", ["gini", "entropy"])
def test_multiclass_fused_kernel_matches_plain(dev, K, impurity):
    """Class mode, Poisson weights: the K planes are bit-equal; under gini
    every field of the 9-tuple is exact (K = 8 passes the 48 KB static
    shared-memory limit, K = 32 scans at most 867 slots a segment);
    under entropy log2f may differ from torch's log2 by an ulp, so the
    gains are held at rtol 1e-6 and the rest exactly."""
    lay, codes, y, w, node, act = _class_case(dev, K, 30_000, 8, 5)
    fok = torch.ones(lay.T, dtype=torch.bool, device=dev)
    kw = dict(L=8, lay=lay, impurity=impurity, min_inst=2, min_gain=0.0,
              n_classes=K)
    h_k, out_k = hk.fused_level(codes, y, w, node, act, fok,
                                codes8=hk.codes8_of(codes, lay), **kw)
    h_p, out_p = hk.fused_level_reference(codes, y, w, node, act, fok, **kw)
    torch.cuda.synchronize()
    assert torch.equal(h_k, h_p)
    for nm, a, b in zip(NAMES, out_p, out_k):
        if nm == "best_gain" and impurity == "entropy":
            torch.testing.assert_close(b, a, rtol=1e-6, atol=0)
        else:
            assert torch.equal(a, b), nm


@pytest.mark.cuda
@pytest.mark.parametrize("K", [3, 32])
def test_multiclass_wide_segment_route(dev, K):
    """A 900-slot categorical: the kernel scans it with 3 class planes
    (segment cap 1,024); with 32 it passes the 867-slot cap and takes the
    torch class scan, which the epilogue merges. Gini: exact either way."""
    slots, is_cat = [33] * 4 + [900], [False] * 4 + [True]
    lay, codes, _y, w, node, act = _case(dev, slots, is_cat, 40_000, 4, 8)
    assert (hk.seg_cap(K, dev) < 900) == (K == 32)
    c = codes.cpu().numpy()
    y = torch.as_tensor(((c[:, 4] // 7 + c[:, 0]) % K).astype(np.float32),
                        device=dev)
    fok = torch.ones(lay.T, dtype=torch.bool, device=dev)
    kw = dict(L=4, lay=lay, impurity="gini", min_inst=2, min_gain=0.0,
              n_classes=K)
    h_k, out_k = hk.fused_level(codes, y, w, node, act, fok, **kw)
    h_p, out_p = hk.fused_level_reference(codes, y, w, node, act, fok, **kw)
    torch.cuda.synchronize()
    assert torch.equal(h_k, h_p)
    for nm, a, b in zip(NAMES, out_p, out_k):
        assert torch.equal(a, b), nm


@pytest.mark.cuda
@pytest.mark.parametrize("K", [3, 8, 32])
def test_multiclass_hist_kernel_matches_plain(dev, K):
    lay, codes, y, w, node, act = _class_case(dev, K, 30_000, 64, 6)
    kw = dict(L=64, lay=lay, n_classes=K)
    h_k = hk.hist_level(codes, y, w, node, act,
                        codes8=hk.codes8_of(codes, lay), **kw)
    h_p = hk.hist_level_reference(codes, y, w, node, act, **kw)
    torch.cuda.synchronize()
    assert h_k.shape == (K, 64, lay.T)
    assert torch.equal(h_k, h_p)


@pytest.mark.cuda
def test_native_rf_forest_cuda_equals_cpu(dev):
    """A small NATIVE RF gini forest (depth 8: the fused class entry up to
    L = 32, the histogram-only one for the built half of L = 128) is
    bit-equal on the card and on the CPU."""
    rng = np.random.default_rng(3)
    slots = [17] * 5 + [33, 65]
    is_cat = [False] * 5 + [True] * 2
    n = 20_000
    codes = np.stack([rng.integers(0, s - 1, size=n) for s in slots],
                     1).astype(np.int32)
    y = ((codes[:, 0] // 6 + (codes[:, 6] >= 30)) % 4).astype(np.float32)
    w = np.ones(n, np.float32)
    cfg = tt.TreeTrainConfig(algorithm="RF", tree_num=3, max_depth=8,
                             impurity="gini", n_classes=4,
                             feature_subset_strategy="TWOTHIRDS", seed=2)
    cols = [f"f{i}" for i in range(len(slots))]
    hk.reset_counters()
    on_card = tt.train_trees(codes, y, w, slots, is_cat, cols, cfg,
                             device="cuda")
    assert hk.launches["fused_level_mc"] > 0
    assert hk.launches["hist_level_mc"] > 0
    assert hk.launches["scan_level_mc"] > 0
    assert sum(hk.reference_calls.values()) == 0
    on_cpu = tt.train_trees(codes, y, w, slots, is_cat, cols, cfg,
                            device="cpu")
    for a, b in zip(on_card.spec.trees, on_cpu.spec.trees):
        np.testing.assert_array_equal(a.feature, b.feature)
        np.testing.assert_array_equal(a.left_mask, b.left_mask)
        np.testing.assert_array_equal(a.leaf_value, b.leaf_value)
    assert on_card.valid_error == on_cpu.valid_error


# ---------------------------------------------------------------------------
# the scan-only entry
# ---------------------------------------------------------------------------

RAGGED = [9] * 6 + [33, 65] + [1500]
RAGGED_CAT = [False] * 6 + [True] * 3


def _derived_planes(dev, slots, is_cat, K, Lh, seed, *, w_scale=1,
                    lowp=False, n=60_000):
    """Derived-sibling planes [P, Lh, T] on the card (parents minus the
    built smaller children, zero under parent 1, which did not split):
    Poisson weights times w_scale with 0/1 or class labels (integer
    planes), or GBT's bf16 planes of float labels (lowp)."""
    rng = np.random.default_rng(seed)
    lay = tt.make_layout(slots, is_cat)
    codes = np.stack([rng.integers(0, s - 1, size=n) for s in slots],
                     1).astype(np.int32)
    if K:
        y = (codes[:, 0] // 3 + codes[:, -1]) % K
    elif lowp:
        y = rng.random(n) - 0.35
    else:
        y = codes[:, -1] % 3 == 0
    w = np.ones(n) if lowp else rng.poisson(1.0, size=n) * w_scale
    node = rng.integers(0, Lh, size=n)
    act = rng.random(n) < 0.95
    built = act & (rng.random(n) < 0.4)
    t = lambda a, dt: torch.as_tensor(np.asarray(a, dt), device=dev)  # noqa
    args = (t(codes, np.int32), t(y, np.float32), t(w, np.float32),
            t(node, np.int32))
    kw = dict(L=Lh, lay=lay, n_classes=K, low_precision=lowp)
    p_hist = hk.hist_level_reference(*args, t(act, bool), **kw)
    b_hist = hk.hist_level_reference(*args, t(built, bool), **kw)
    p_split = torch.arange(Lh, device=dev) != 1
    left_small = t(rng.random(Lh) < 0.5, bool)
    derived, _full = tt._derive(p_hist, b_hist, p_split, left_small)
    fok = torch.ones(lay.T, dtype=torch.bool, device=dev)
    fok[int(lay.off[2]):int(lay.off[2] + lay.slots[2])] = False
    return lay, derived.contiguous(), fok


def _check_scan(dev, lay, hist, fok, K, impurity, gain_rtol=0.0):
    """scan_level's planes against scan_planes_reference, its 9-tuple
    against the plain scan's: bit for bit, but gains at gain_rtol."""
    kw = dict(impurity=impurity, min_inst=2, min_gain=0.0, n_classes=K)
    (gain, rank, lcnt, tot0), cap = hk.scan_planes(hist, fok, lay=lay, **kw)
    ref = hk.scan_planes_reference(hist, fok, lay, cap=cap, **kw)
    out = hk.scan_level(hist, fok, lay=lay, **kw)
    plain = tt.scan_of(K)(hist, fok, tt.scan_layout(lay, dev),
                          **{k: kw[k] for k in kw if k != "n_classes"})
    torch.cuda.synchronize()
    for nm, a, b in (("rank", ref[1], rank), ("lcnt", ref[2], lcnt),
                     ("tot0", ref[3], tot0)):
        assert torch.equal(a, b), nm
    for nm, a, b in (("gain", ref[0], gain), ("best_gain", plain[5], out[5])):
        if gain_rtol:
            fin = torch.isfinite(a)
            assert torch.equal(fin, torch.isfinite(b)), nm
            torch.testing.assert_close(b[fin], a[fin], rtol=gain_rtol,
                                       atol=0, msg=nm)
        else:
            assert torch.equal(a, b), nm
    for nm, a, b in zip(NAMES, plain, out):
        if nm != "best_gain":
            assert torch.equal(a, b), nm
    assert bool(out[4].any())
    return cap


@pytest.mark.cuda
@pytest.mark.parametrize("K,impurity,layout,Lh", [
    (0, "variance", "rf", 64), (0, "gini", "ragged", 16),
    (0, "entropy", "rf", 16), (0, "friedmanmse", "ragged", 8),
    (3, "gini", "ragged", 16), (5, "gini", "rf", 64),
    (5, "entropy", "rf", 16), (32, "gini", "wide900", 8),
    (32, "gini", "rf", 32)])
def test_scan_level_matches_plain(dev, K, impurity, layout, Lh):
    """The scan-only entry on derived-sibling planes, both modes: the
    kernel's per-slot planes equal their plain version bit for bit and
    the 9-tuple the plain scan's (entropy gains at rtol 1e-6: log2f
    against torch's log2); the 1500-slot categorical, and at K = 32 a
    900-slot one, pass the cap and take the torch scan in the
    epilogue."""
    slots, is_cat = {"rf": (BENCH_RF, [False] * 20 + [True] * 10),
                     "ragged": (RAGGED, RAGGED_CAT),
                     "wide900": ([33] * 4 + [900],
                                 [False] * 4 + [True])}[layout]
    lay, hist, fok = _derived_planes(dev, slots, is_cat, K, Lh, 3 + K)
    cap = _check_scan(dev, lay, hist, fok, K, impurity,
                      1e-6 if impurity == "entropy" else 0.0)
    assert (max(slots) > cap) == (layout != "rf")


@pytest.mark.cuda
@pytest.mark.parametrize("K", [0, 5])
def test_scan_level_node_totals_past_2_24(dev, K):
    """Integer planes whose node totals pass 2^24: the kernel's f64
    segment sums keep planes and 9-tuple bit-equal to the plain scan's
    (an f32 prefix sum would not be exact)."""
    lay, hist, fok = _derived_planes(dev, RAGGED, RAGGED_CAT, K, 8, 5,
                                     w_scale=3_000_000)
    cnt = tt.class_sum(hist) if K else hist[0]
    assert float(cnt[:, :RAGGED[0]].sum(1).max()) > 2 ** 24
    _check_scan(dev, lay, hist, fok, K, "gini" if K else "variance")


@pytest.mark.cuda
@pytest.mark.parametrize("Lh", [1, 16])
def test_scan_level_bf16_moment_planes(dev, Lh):
    """GBT's float planes (bf16 comps): the kernel's f64 sums run in
    another order than the plain cumsum, so gains agree within 1e-5
    relative, and feature and cut are equal wherever a node's two best
    gains differ by more than that."""
    lay, hist, fok = _derived_planes(dev, [33] * 30, [False] * 30, 0, Lh, 9,
                                     lowp=True)
    kw = dict(impurity="variance", min_inst=5, min_gain=0.0)
    out = hk.scan_level(hist, fok, lay=lay, **kw)
    plain = tt.split_scan(hist, fok, tt.scan_layout(lay, dev), **kw)
    ref, _cap = hk.scan_planes(hist, fok, lay=lay, **kw)
    torch.cuda.synchronize()
    a, b = plain[5], out[5]
    fin = torch.isfinite(a)
    assert torch.equal(fin, torch.isfinite(b))
    torch.testing.assert_close(b[fin], a[fin], rtol=1e-5, atol=0)
    top2 = torch.topk(ref[0], 2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1]) > 1e-5 * top2[:, 0].abs()
    assert torch.equal(out[0][clear], plain[0][clear])
    assert torch.equal(out[1][clear], plain[1][clear])
    assert bool(clear.any())


@pytest.mark.cuda
def test_scan_level_raises_on_bad_inputs(dev):
    lay, hist, fok = _derived_planes(dev, [9, 9, 9], [False, True, False],
                                     0, 2, 1, n=500)
    kw = dict(lay=lay, impurity="gini", min_inst=1, min_gain=0.0)
    with pytest.raises(TypeError):
        hk.scan_level(hist.double(), fok, **kw)
    with pytest.raises(ValueError):  # 3 moment planes, not 4 classes
        hk.scan_level(hist, fok, n_classes=4, **kw)
    with pytest.raises(ValueError):
        hk.scan_level(hist, fok.cpu(), **kw)
    with pytest.raises(ValueError):
        hk.scan_level(hist.transpose(1, 2).contiguous().transpose(1, 2),
                      fok, **kw)
    with pytest.raises(ValueError):
        hk.scan_level(hist, fok, **{**kw, "impurity": "mse"})


@pytest.mark.cuda
def test_entries_follow_their_tensors_device(dev):
    """Each card entry makes its input's device current (the library's
    workspace plan and shared-memory opt-in read `cudaGetDevice`): on
    cuda:1 with cuda:0 current, `hist_level` and `scan_level` equal their
    plain versions, and the current device is cuda:0 again after."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    d1 = torch.device("cuda", 1)
    lay, codes, y, w, node, act = _case(d1, [33] * 20 + [65] * 10,
                                        [False] * 20 + [True] * 10,
                                        50_000, 64, 5)
    fok = torch.ones(lay.T, dtype=torch.bool, device=d1)
    with torch.cuda.device(0):
        h_k = hk.hist_level(codes, y, w, node, act, L=64, lay=lay,
                            codes8=hk.codes8_of(codes, lay))
        kw = dict(lay=lay, impurity="variance", min_inst=2, min_gain=0.0)
        out_k = hk.scan_level(h_k, fok, **kw)
        assert torch.cuda.current_device() == 0
    h_p = hk.hist_level_reference(codes, y, w, node, act, L=64, lay=lay)
    out_p = tt.split_scan(h_p, fok, tt.scan_layout(lay, d1), "variance",
                          2, 0.0)
    torch.cuda.synchronize(d1)
    assert torch.equal(h_k, h_p)
    for nm, a, b in zip(NAMES, out_p, out_k):
        assert torch.equal(a, b), nm


@pytest.mark.cuda
@pytest.mark.parametrize("n_classes", [0, 5])
def test_meshed_rf_on_the_card_equals_one_device(dev, n_classes):
    """RF (and NATIVE RF) on a 4-shard mesh of the card: each shard's
    fixed-point sums merge unconverted (`merge_acc`), so the forest is
    the one-device forest bit for bit; the mesh launches the
    histogram-only entry 4 times a level and never the fused entry."""
    from shifu_tpu_torch.parallel.mesh import data_mesh

    rng = np.random.default_rng(11)
    slots = [17] * 5 + [33, 65]
    is_cat = [False] * 5 + [True] * 2
    n = 30_001
    codes = np.stack([rng.integers(0, s - 1, size=n) for s in slots],
                     1).astype(np.int32)
    y = ((codes[:, 0] // 6 + (codes[:, 6] >= 30)) % max(n_classes, 2)
         ).astype(np.float32)
    w = np.ones(n, np.float32)
    cfg = tt.TreeTrainConfig(algorithm="RF", tree_num=3, max_depth=6,
                             n_classes=n_classes, seed=2,
                             impurity="gini" if n_classes else "variance")
    cols = [f"f{i}" for i in range(len(slots))]
    one = tt.train_trees(codes, y, w, slots, is_cat, cols, cfg,
                         device="cuda")
    hk.reset_counters()
    got = tt.train_trees(codes, y, w, slots, is_cat, cols, cfg,
                         mesh=data_mesh(virtual=4))
    sfx = "_mc" if n_classes else ""
    assert hk.launches["fused_level" + sfx] == 0
    assert hk.launches["hist_level" + sfx] == 4 * 6 * 3
    assert hk.launches["scan_level" + sfx] == 6 * 3
    for a, b in zip(one.spec.trees, got.spec.trees):
        np.testing.assert_array_equal(a.feature, b.feature)
        np.testing.assert_array_equal(a.left_mask, b.left_mask)
        np.testing.assert_array_equal(a.leaf_value, b.leaf_value)


@pytest.mark.cuda
def test_profiled_entry_seams_add_no_synchronisation(dev, monkeypatch):
    """Under the armed profiler (obs/profile.py) the tree grower's
    histogram and scan seams (`sync=False`) record a dispatch with the
    entries' analytic cost and never call `torch.cuda.synchronize`; the
    results equal the unprofiled calls."""
    from shifu_tpu_torch import obs
    from shifu_tpu_torch.ops import hist_bounds

    lay, codes, y, w, node, act = _case(dev, [9, 17, 33], [False] * 3,
                                        20_000, 4, 3)
    fok = torch.ones(lay.T, dtype=torch.bool, device=dev)
    kw = dict(L=4, lay=lay)
    skw = dict(impurity="variance", min_inst=1, min_gain=0.0)
    want_h = hk.hist_level(codes, y, w, node, act, **kw)
    want_s = hk.scan_level(want_h, fok, lay=lay, **skw)
    torch.cuda.synchronize()
    syncs = []
    real = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: syncs.append(a) or real(*a, **k))
    obs.begin_run()
    try:
        got_h = tt._hist(hk.hist_level, codes, y, w, node, act, **kw)
        got_s = tt._scan(got_h, fok, lay=lay, **skw)
        assert syncs == []
        progs = obs.profiler().snapshot()["programs"]
    finally:
        obs.end_run()
    monkeypatch.setattr(torch.cuda, "synchronize", real)
    torch.cuda.synchronize()
    assert torch.equal(got_h, want_h)
    for a, b in zip(got_s, want_s):
        assert torch.equal(a, b)
    row = progs["tree.hist"]
    assert row["dispatches"] == 1 and row["synced"] is False
    assert row["costSource"] == "analytic"
    assert row["bytesAccessed"] == hist_bounds.hist_cost(
        codes, y, w, node, act, **kw)[1]
    assert progs["tree.split_scan"]["dispatches"] == 1

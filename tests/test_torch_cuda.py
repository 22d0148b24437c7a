"""The CUDA histogram -> split-scan kernel against its plain PyTorch versions,
on the card. Every test here is marked `cuda` and skips without a CUDA
device (the kernel has no CPU mode); this file imports no JAX, so it runs
on a machine that has only PyTorch:

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
    tolerance of the plain version, and two launches give the same
    bits."""
    lay, codes, _y, _w, node, act = _case(dev, [33] * 30, [False] * 30,
                                          100_000, 16, 2)
    g = torch.Generator(device="cpu").manual_seed(0)
    y = (torch.rand(codes.shape[0], generator=g) - 0.4).to(dev)
    w = torch.ones_like(y)
    kw = dict(L=16, lay=lay, low_precision=True)
    h1 = hk.hist_level(codes, y, w, node, act, **kw)
    h2 = hk.hist_level(codes, y, w, node, act, **kw)
    hp = hk.hist_level_reference(codes, y, w, node, act, **kw)
    torch.cuda.synchronize()
    assert torch.equal(h1, h2)
    assert torch.equal(h1[0], hp[0])
    torch.testing.assert_close(h1, hp, rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
def test_wrappers_raise_on_bad_inputs(dev):
    lay, codes, y, w, node, act = _case(dev, [9, 9], [False, False], 100, 2,
                                        0)
    with pytest.raises(TypeError):
        hk.hist_level(codes.long(), y, w, node, act, L=2, lay=lay)
    with pytest.raises(ValueError):
        hk.hist_level(codes, y.cpu(), w, node, act, L=2, lay=lay)


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
    assert hk.reference_calls["fused_level_mc"] == 0
    on_cpu = tt.train_trees(codes, y, w, slots, is_cat, cols, cfg,
                            device="cpu")
    for a, b in zip(on_card.spec.trees, on_cpu.spec.trees):
        np.testing.assert_array_equal(a.feature, b.feature)
        np.testing.assert_array_equal(a.left_mask, b.left_mask)
        np.testing.assert_array_equal(a.leaf_value, b.leaf_value)
    assert on_card.valid_error == on_cpu.valid_error

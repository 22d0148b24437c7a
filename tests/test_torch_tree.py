"""The port's level-wise GBT/RF trainer and tree model vs the JAX package.

Port `train_trees(device="cpu")` (the fused level structure through the
histogram entries' plain versions) against JAX `train_trees` with
`-Dshifu.pallas.mode=off`, on test_hist_pallas.py's `_forest_data` case.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from shifu_tpu.models import tree as jtree  # noqa: E402
from shifu_tpu.train import tree_trainer as jtt  # noqa: E402
from shifu_tpu.utils import environment  # noqa: E402
from shifu_tpu_torch import convert  # noqa: E402
from shifu_tpu_torch.models import tree as ptree  # noqa: E402
from shifu_tpu_torch.ops import hist_kernel as hk  # noqa: E402
from shifu_tpu_torch.train import tree_trainer as ptt  # noqa: E402


def _forest_data(n=2500, seed=0):
    rng = np.random.default_rng(seed)
    slots = [17] * 5 + [33, 65]
    is_cat = [False] * 5 + [True] * 2
    codes = np.stack([rng.integers(0, s - 1, size=n) for s in slots],
                     1).astype(np.int32)
    y = ((codes[:, 0] >= 8).astype(np.int8)
         | (codes[:, 5] >= 20).astype(np.int8)).astype(np.float32)
    noise = rng.random(n) < 0.15
    y = np.where(noise, 1.0 - y, y).astype(np.float32)
    w = np.ones(n, np.float32)
    cols = [f"f{i}" for i in range(len(slots))]
    return codes, y, w, slots, is_cat, cols


def _jax_train(codes, y, w, slots, is_cat, cols, **kw):
    environment.set_property("shifu.pallas.mode", "off")
    try:
        return jtt.train_trees(codes, y, w, slots, is_cat, cols,
                               jtt.TreeTrainConfig(**kw))
    finally:
        environment.set_property("shifu.pallas.mode", "")


def _port_train(codes, y, w, slots, is_cat, cols, **kw):
    return ptt.train_trees(codes, y, w, slots, is_cat, cols,
                           ptt.TreeTrainConfig(**kw), device="cpu")


def _assert_forests_bit_equal(a, b):
    assert len(a.spec.trees) == len(b.spec.trees)
    for t0, t1 in zip(a.spec.trees, b.spec.trees):
        np.testing.assert_array_equal(t0.feature, t1.feature)
        np.testing.assert_array_equal(t0.left_mask, t1.left_mask)
        np.testing.assert_array_equal(t0.leaf_value, t1.leaf_value)
        assert t0.weight == t1.weight


def _scan_calls(depth, subtraction):
    """`scan_level` calls a tree: one a subtraction level (the derived
    sibling, or the whole level past 32 nodes), one a level past 32
    nodes built whole."""
    sub = ptt._sub_plan(ptt.TreeTrainConfig(max_depth=depth,
                                            hist_subtraction=subtraction),
                        1 << 30)
    built, derived, _fb = ptt._plan_counts(sub[:depth], subtraction)
    assert derived == sum(2 ** d // 2 for d in range(depth) if sub[d])
    return sum(1 for d in range(depth) if sub[d] or 2 ** d > 32)


@pytest.mark.parametrize("depth,subtraction", [(4, True), (7, False),
                                               (8, True)])
def test_rf_forest_bit_equal(depth, subtraction):
    """RF integer-weight planes are exact, so the forest is BIT-equal:
    depth 4 engages the subtraction chain through the fused entry; L=64
    takes the histogram-only entry, as a full level (depth 7, subtraction
    off) and as the built half of L=128 (depth 8)."""
    data = _forest_data()
    kw = dict(algorithm="RF", tree_num=3, max_depth=depth,
              feature_subset_strategy="TWOTHIRDS", seed=3,
              valid_set_rate=0.1, hist_subtraction=subtraction)
    ref = _jax_train(*data, **kw)
    hk.reset_counters()
    port = _port_train(*data, **kw)
    _assert_forests_bit_equal(ref, port)
    assert port.valid_error == pytest.approx(ref.valid_error, abs=1e-6)
    widths = [2 ** d // 2 if subtraction and d else 2 ** d
              for d in range(depth)]
    assert hk.reference_calls["fused_level"] == 3 * sum(
        w <= 32 for w in widths)
    assert hk.reference_calls["hist_level"] == 3 * sum(w > 32 for w in widths)
    assert hk.reference_calls["hist_level"] > 0 or depth == 4
    assert hk.reference_calls["scan_level"] == 3 * _scan_calls(depth,
                                                                subtraction)


def test_gbt_scores_within_tolerance():
    """GBT planes travel bf16 in the port (the kernel's precision policy)
    and f32 in the JAX XLA path: tolerance parity, as the JAX package's
    own kernel-on/off test."""
    codes, y, w, slots, is_cat, cols = _forest_data(seed=6)
    kw = dict(algorithm="GBT", tree_num=4, max_depth=4, learning_rate=0.3,
              seed=7, valid_set_rate=0.1)
    ref = _jax_train(codes, y, w, slots, is_cat, cols, **kw)
    port = _port_train(codes, y, w, slots, is_cat, cols, **kw)
    s_ref = ref.spec.independent().compute(codes)
    s_port = port.spec.independent(device="cpu").compute(codes)
    np.testing.assert_allclose(s_port, s_ref, atol=0.03)


def test_gbt_model_file_crosses_packages(tmp_path):
    """A .gbt saved by either package loads in the other and saves to the
    same bytes; one forest scores the same in both (via convert.py)."""
    codes, y, w, slots, is_cat, cols = _forest_data(n=1200, seed=2)
    kw = dict(algorithm="GBT", tree_num=3, max_depth=3, learning_rate=0.2,
              seed=1, valid_set_rate=0.1)
    port = _port_train(codes, y, w, slots, is_cat, cols, **kw)
    ref = _jax_train(codes, y, w, slots, is_cat, cols, **kw)
    for spec, name in ((port.spec, "port"), (ref.spec, "jax")):
        a = tmp_path / f"{name}-a.gbt"
        b = tmp_path / f"{name}-b.gbt"
        c = tmp_path / f"{name}-c.gbt"
        spec.save(str(a))
        jtree.TreeModelSpec.load(str(a)).save(str(b))
        ptree.TreeModelSpec.load(str(b)).save(str(c))
        assert a.read_bytes() == b.read_bytes() == c.read_bytes()

    # JAX forest -> port spec: scores agree
    moved = convert.spec_from(ref.spec)
    s_ref = ref.spec.independent().compute(codes)
    s_port = ptree.IndependentTreeModel(moved, device="cpu").compute(codes)
    np.testing.assert_allclose(s_port, s_ref, rtol=1e-6)
    # port forest -> JAX spec through plain fields, and per-tree arrays
    d = convert.spec_fields(port.spec)
    back = jtree.TreeModelSpec(**{**d, "trees": [jtree.DenseTree(**t)
                                                 for t in d["trees"]]})
    np.testing.assert_allclose(
        back.independent().compute(codes),
        port.spec.independent(device="cpu").compute(codes), rtol=1e-6)
    again = convert.forest_from(
        [t.feature for t in ref.spec.trees],
        [t.left_mask for t in ref.spec.trees],
        [t.leaf_value for t in ref.spec.trees],
        [t.weight for t in ref.spec.trees],
        algorithm="GBT", input_columns=cols, slots=slots,
        convert_to_prob=ref.spec.convert_to_prob)
    np.testing.assert_allclose(
        again.independent(device="cpu").compute(codes), s_ref, rtol=1e-6)


@pytest.mark.parametrize("alg", ["GBT", "RF"])
def test_resume_is_bit_equal(alg):
    """Per-tree draws keyed by (seed, tree index): 2 trees, then 2 more
    from init_trees, equal the uninterrupted 4-tree run bit for bit."""
    data = _forest_data(n=1500, seed=4)
    kw = dict(algorithm=alg, tree_num=4, max_depth=3, learning_rate=0.2,
              feature_subset_strategy="HALF", seed=5)
    full = _port_train(*data, **kw)
    head = _port_train(*data, **{**kw, "tree_num": 2})
    tail = ptt.train_trees(*data, ptt.TreeTrainConfig(**kw),
                           init_trees=head.spec.trees, device="cpu")
    _assert_forests_bit_equal(full, tail)


def test_hist_counters_follow_subtraction_plan():
    data = _forest_data(n=800, seed=1)
    for k in ptt.hist_counters:
        ptt.hist_counters[k] = 0
    _port_train(*data, algorithm="GBT", tree_num=2, max_depth=4, seed=1)
    leaves = 2 ** 4
    assert ptt.hist_counters["built"] == 2 * (leaves // 2)
    assert ptt.hist_counters["derived"] == 2 * (leaves // 2 - 1)
    assert ptt.hist_counters["fallback_rebuilds"] == 0


def test_early_stop_decider_matches_jax():
    rng = np.random.default_rng(0)
    errs = list(0.3 + 0.01 * rng.random(200))
    a, b = jtt.DTEarlyStopDecider(2), ptt.DTEarlyStopDecider(2)
    assert [a.add(e) for e in errs] == [b.add(e) for e in errs]


def _class_data(n=2500, seed=0, k=3):
    """_forest_data's codes with K class labels (class indices as float
    tags, as NATIVE CleanedData carries them): the class follows two
    numeric columns and one categorical, with 15% noise."""
    codes, _y, w, slots, is_cat, cols = _forest_data(n=n, seed=seed)
    rng = np.random.default_rng(seed + 100)
    cls = (codes[:, 0] * k // slots[0] + (codes[:, 5] >= 20)
           + (codes[:, 2] >= 12)) % k
    noise = rng.random(n) < 0.15
    cls = np.where(noise, rng.integers(0, k, size=n), cls)
    return codes, cls.astype(np.float32), w, slots, is_cat, cols


def _first_diff(a, b):
    """'tree t node i: feature x vs y' for the first differing node."""
    for t, (t0, t1) in enumerate(zip(a.spec.trees, b.spec.trees)):
        for i in range(t0.feature.shape[0]):
            if (t0.feature[i] != t1.feature[i]
                    or not np.array_equal(t0.left_mask[i], t1.left_mask[i])
                    or t0.leaf_value[i] != t1.leaf_value[i]):
                return (f"tree {t} node {i}: feature {t0.feature[i]} vs "
                        f"{t1.feature[i]}, leaf {t0.leaf_value[i]} vs "
                        f"{t1.leaf_value[i]}")
    return None


@pytest.mark.parametrize("k,depth,impurity", [(3, 3, "gini"),
                                              (4, 8, "gini"),
                                              (4, 4, "entropy")])
def test_native_multiclass_rf_bit_equal(k, depth, impurity):
    """NATIVE multi-class RF: per-class count planes under integer weights
    are exact, so the forest (majority-class leaves, masks, features) is
    BIT-equal to the JAX package's and the valid misclassification rate
    is equal. Depth 8 with subtraction reaches the histogram-only entry
    at L = 64 (the built half of level 7). Entropy gains may differ from
    XLA's by an ulp of log2; the forest is held equal on this data, and a
    flipped near-tie names its node."""
    data = _class_data(k=k)
    kw = dict(algorithm="RF", tree_num=3, max_depth=depth,
              feature_subset_strategy="TWOTHIRDS", seed=3,
              valid_set_rate=0.1, impurity=impurity, n_classes=k)
    ref = _jax_train(*data, **kw)
    hk.reset_counters()
    port = _port_train(*data, **kw)
    assert _first_diff(ref, port) is None, _first_diff(ref, port)
    _assert_forests_bit_equal(ref, port)
    assert port.valid_error == ref.valid_error
    assert port.train_error == ref.train_error
    assert port.spec.n_classes == k
    leaves = np.concatenate([t.leaf_value for t in port.spec.trees])
    assert set(np.unique(leaves)) <= set(range(k))
    assert hk.reference_calls["fused_level_mc"] > 0
    assert (hk.reference_calls["hist_level_mc"] > 0) == (depth == 8)
    assert hk.reference_calls["fused_level"] == 0
    assert hk.reference_calls["scan_level_mc"] == 3 * _scan_calls(depth, True)
    assert hk.reference_calls["scan_level"] == 0


def test_native_multiclass_resume_is_bit_equal():
    """2 trees, then 2 more from init_trees (votes re-derived from the
    loaded forest), equal the uninterrupted 4-tree multi-class run bit
    for bit, valid errors included."""
    data = _class_data(n=1500, seed=4, k=4)
    kw = dict(algorithm="RF", tree_num=4, max_depth=4, impurity="gini",
              feature_subset_strategy="HALF", seed=5, n_classes=4)
    errs = []
    full = ptt.train_trees(*data, ptt.TreeTrainConfig(**kw), device="cpu",
                           progress_cb=lambda k, t, v: errs.append(v))
    head = _port_train(*data, **{**kw, "tree_num": 2})
    tail = ptt.train_trees(*data, ptt.TreeTrainConfig(**kw),
                           init_trees=head.spec.trees,
                           init_valid_errors=errs[:2], device="cpu")
    _assert_forests_bit_equal(full, tail)
    assert tail.valid_error == full.valid_error


def test_native_multiclass_gbt_raises():
    data = _class_data(n=300, k=3)
    for train in (_jax_train, _port_train):
        with pytest.raises(ValueError, match="RF-only"):
            train(*data, algorithm="GBT", tree_num=1, n_classes=3)


def _jax_hist_counters():
    from shifu_tpu.obs import registry

    reg = registry()
    return {k: reg.counter(f"tree.hist.{k}").value
            for k in ("built", "derived", "fallback_rebuilds")}


def _assert_pointers_equal(a, b):
    for t0, t1 in zip(a.spec.trees, b.spec.trees):
        assert (t0.left is None) == (t1.left is None)
        if t0.left is not None:
            np.testing.assert_array_equal(t0.left, t1.left)
            np.testing.assert_array_equal(t0.right, t1.right)


# T = 183 slots: MaxStatsMemoryMB 1 gives a node batch of 477, so depth 9
# builds the 256-node level whole and the 512-node level in 2 batches
_BATCHED = dict(max_depth=9, max_stats_memory_mb=1)


def _wide_forest_data(n=2500, seed=6):
    """_forest_data plus one 5,500-slot numeric column of noise: T = 5,683
    gives a node batch of 15 at MaxStatsMemoryMB 1, so a depth-5 GBT
    builds its 16- and 32-node levels in 2 and 3 batches. (Deeper GBT
    trees on 2,500 noisy rows drift apart on near-tied gains between any
    two f32 scans, the level-wise path's too.)"""
    codes, y, w, slots, is_cat, cols = _forest_data(n=n, seed=seed)
    extra = np.random.default_rng(seed + 50).integers(0, 5499, size=n)
    return (np.concatenate([codes, extra[:, None].astype(np.int32)], 1), y,
            w, slots + [5500], is_cat + [False], cols + ["wide"])


@pytest.mark.parametrize("case,kw", [
    ("leafwise_gbt", dict(algorithm="GBT", max_leaves=12, max_depth=6,
                          learning_rate=0.3)),
    ("leafwise_rf", dict(algorithm="RF", max_leaves=12, max_depth=6,
                         feature_subset_strategy="TWOTHIRDS")),
    ("leafwise_rf_nosub", dict(algorithm="RF", max_leaves=12, max_depth=6,
                               hist_subtraction=False)),
    ("leafwise_rf_budget", dict(algorithm="RF", max_leaves=16, max_depth=8,
                                max_stats_memory_mb=0)),
    ("leafwise_native3", dict(algorithm="RF", max_leaves=10, max_depth=6,
                              n_classes=3, impurity="gini")),
    ("batched_gbt", dict(algorithm="GBT", learning_rate=0.3, max_depth=5,
                         max_stats_memory_mb=1)),
    ("batched_rf", dict(algorithm="RF", feature_subset_strategy="HALF",
                        **_BATCHED)),
    ("batched_rf_nosub", dict(algorithm="RF", hist_subtraction=False,
                              **_BATCHED)),
    ("batched_native3", dict(algorithm="RF", n_classes=3, impurity="gini",
                             **_BATCHED)),
])
def test_grower_parity(case, kw):
    """The leaf-wise and host-batched growers against the JAX package's:
    RF forests bit-equal (explicit child pointers included), GBT scores
    within 0.03, and the port's `hist_counters` equal to the JAX
    `tree.hist.*` deltas. The histogram-only and scan-only entries run,
    the fused one never."""
    if kw.get("n_classes"):
        data = _class_data(k=kw["n_classes"])
    elif case == "batched_gbt":
        data = _wide_forest_data()
    else:
        data = _forest_data(seed=6 if kw["algorithm"] == "GBT" else 0)
    kw = dict(tree_num=3, seed=3, valid_set_rate=0.1, **kw)
    before = _jax_hist_counters()
    ref = _jax_train(*data, **kw)
    after = _jax_hist_counters()
    for k in ptt.hist_counters:
        ptt.hist_counters[k] = 0
    hk.reset_counters()
    port = _port_train(*data, **kw)
    assert ptt.hist_counters == {k: int(after[k] - before[k])
                                 for k in after}
    leafwise = kw.get("max_leaves", 0) > 0
    assert all((t.left is not None) == leafwise for t in port.spec.trees)
    mc = "_mc" if kw.get("n_classes") else ""
    assert hk.reference_calls["fused_level" + mc] == 0
    assert hk.reference_calls["hist_level" + mc] > 0
    assert hk.reference_calls["scan_level" + mc] > 0
    if leafwise:  # one histogram a built node, one scan a leaf
        assert hk.reference_calls["hist_level" + mc] == \
            ptt.hist_counters["built"]
        assert hk.reference_calls["scan_level" + mc] == (
            ptt.hist_counters["built"] + ptt.hist_counters["derived"])
    if kw["algorithm"] == "GBT":
        codes = data[0]
        np.testing.assert_allclose(
            port.spec.independent(device="cpu").compute(codes),
            ref.spec.independent().compute(codes), atol=0.03)
        return
    assert _first_diff(ref, port) is None, _first_diff(ref, port)
    _assert_forests_bit_equal(ref, port)
    _assert_pointers_equal(ref, port)
    assert port.valid_error == pytest.approx(ref.valid_error, abs=1e-6)


@pytest.mark.parametrize("alg", ["GBT", "RF"])
def test_leafwise_resume_is_bit_equal(alg):
    """2 leaf-wise trees, then 2 more from init_trees, equal the
    uninterrupted 4-tree run bit for bit, pointers included."""
    data = _forest_data(n=1500, seed=4)
    kw = dict(algorithm=alg, tree_num=4, max_depth=5, max_leaves=9,
              learning_rate=0.2, feature_subset_strategy="HALF", seed=5)
    full = _port_train(*data, **kw)
    head = _port_train(*data, **{**kw, "tree_num": 2})
    tail = ptt.train_trees(*data, ptt.TreeTrainConfig(**kw),
                           init_trees=head.spec.trees, device="cpu")
    _assert_forests_bit_equal(full, tail)
    _assert_pointers_equal(full, tail)


def test_leafwise_gbt_model_file_crosses_packages(tmp_path):
    """A leaf-wise `.gbt` written by the port loads and scores in the JAX
    package, and the JAX package's in the port: the same bytes after a
    round trip, the same scores."""
    codes, y, w, slots, is_cat, cols = _forest_data(n=1200, seed=2)
    kw = dict(algorithm="GBT", tree_num=3, max_depth=5, max_leaves=8,
              learning_rate=0.2, seed=1, valid_set_rate=0.1)
    port = _port_train(codes, y, w, slots, is_cat, cols, **kw)
    ref = _jax_train(codes, y, w, slots, is_cat, cols, **kw)
    p_path, j_path = tmp_path / "port.gbt", tmp_path / "jax.gbt"
    port.spec.save(str(p_path))
    ref.spec.save(str(j_path))
    in_jax = jtree.TreeModelSpec.load(str(p_path))
    in_port = ptree.TreeModelSpec.load(str(j_path))
    assert all(t.left is not None for t in in_jax.trees + in_port.trees)
    np.testing.assert_allclose(
        in_jax.independent().compute(codes),
        port.spec.independent(device="cpu").compute(codes), rtol=1e-6)
    np.testing.assert_allclose(
        in_port.independent(device="cpu").compute(codes),
        ref.spec.independent().compute(codes), rtol=1e-6)
    again = tmp_path / "again.gbt"
    in_jax.save(str(again))
    assert again.read_bytes() == p_path.read_bytes()

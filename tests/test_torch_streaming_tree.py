"""The port's streamed GBT/RF trainer (`train/streaming_tree.py`) against
the JAX `train_trees_streamed` and against the port's own in-memory
`train_trees`, on CleanedData written in 4 shards (plain versions of the
histogram and scan entries on the CPU).

Contracts: RF and NATIVE RF forests bit-equal to both references (child
pointers included, leaf-wise), GBT scores within 0.03 (the JAX package's
kernel-on/off tolerance), `tree.hist.*` counters equal to the in-memory
trainer's and to the JAX `tree.hist.*` deltas but for the final level,
whose leaves the port takes from node totals where its in-memory route
does (the JAX streamed grower scans a histogram there), and the
histogram-only and scan-only entries the only ones called:
`hist_level` once a shard a built batch, never `fused_level`.
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from shifu_tpu_torch import obs as pobs  # noqa: E402
from shifu_tpu_torch.norm.dataset import write_codes  # noqa: E402
from shifu_tpu_torch.ops import hist_kernel as hk  # noqa: E402
from shifu_tpu_torch.train import streaming_tree as pst  # noqa: E402
from shifu_tpu_torch.train import tree_trainer as ptt  # noqa: E402
from tests.test_torch_tree import (_assert_forests_bit_equal,  # noqa: E402
                                   _assert_pointers_equal, _class_data,
                                   _first_diff, _forest_data,
                                   _jax_hist_counters)
from tests.test_torch_obs import port_hist_counters  # noqa: E402

SHARDS = 4


def _shards(tmp_path, data):
    codes, y, w, slots, _is_cat, cols = data
    out = str(tmp_path / "CleanedData")
    write_codes(out, codes, y, w, cols, slots, n_shards=SHARDS)
    return out


def _jax_streamed(out, data, **kw):
    from shifu_tpu.train.streaming_tree import train_trees_streamed
    from shifu_tpu.train.tree_trainer import TreeTrainConfig

    _codes, _y, _w, slots, is_cat, cols = data
    tags = kw.pop("tags_override", None)
    return train_trees_streamed(out, slots, is_cat, cols,
                                TreeTrainConfig(**kw), tags_override=tags)


def _port_streamed(out, data, **kw):
    _codes, _y, _w, slots, is_cat, cols = data
    tags = kw.pop("tags_override", None)
    return pst.train_trees_streamed(out, slots, is_cat, cols,
                                    ptt.TreeTrainConfig(**kw),
                                    tags_override=tags, device="cpu")


def _port_memory(data, **kw):
    codes, y, w, slots, is_cat, cols = data
    tags = kw.pop("tags_override", None)
    return ptt.train_trees(codes, y if tags is None else tags, w, slots,
                           is_cat, cols, ptt.TreeTrainConfig(**kw),
                           device="cpu")


CASES = [
    ("rf_depth4", dict(algorithm="RF", max_depth=4,
                       feature_subset_strategy="TWOTHIRDS")),
    ("rf_depth8", dict(algorithm="RF", max_depth=8)),
    ("rf_nosub", dict(algorithm="RF", max_depth=5, hist_subtraction=False)),
    ("rf_batched", dict(algorithm="RF", max_depth=9, max_stats_memory_mb=1,
                        feature_subset_strategy="HALF")),
    ("native3", dict(algorithm="RF", max_depth=5, n_classes=3,
                     impurity="gini")),
    ("native3_batched", dict(algorithm="RF", max_depth=9, n_classes=3,
                             impurity="gini", max_stats_memory_mb=1)),
    ("ova1", dict(algorithm="RF", max_depth=4)),
    ("leafwise_rf", dict(algorithm="RF", max_leaves=12, max_depth=6,
                         feature_subset_strategy="TWOTHIRDS")),
    ("leafwise_native3", dict(algorithm="RF", max_leaves=10, max_depth=6,
                              n_classes=3, impurity="gini")),
    ("gbt", dict(algorithm="GBT", max_depth=4, learning_rate=0.3)),
    ("leafwise_gbt", dict(algorithm="GBT", max_leaves=12, max_depth=6,
                          learning_rate=0.3)),
]


def _with_final_level(counters, data, kw):
    """The port's counters plus what the JAX streamed grower builds at the
    final level where the port, as its in-memory grower, takes node
    totals (2**max_depth nodes within a node batch, level-wise)."""
    cfg = ptt.TreeTrainConfig(**{k: v for k, v in kw.items()
                                 if k != "tags_override"})
    cap = ptt._node_batch_size(sum(data[3]), cfg.max_stats_memory_mb,
                               cfg.n_classes)
    D, out = cfg.max_depth, dict(counters)
    if cfg.max_leaves > 0 or 2 ** D > cap:
        return out
    L = 2 ** D
    sub = ptt._sub_plan(cfg, cap)[D]
    out["built"] += cfg.tree_num * (L // 2 if sub else L)
    out["derived"] += cfg.tree_num * (L // 2 if sub else 0)
    out["fallback_rebuilds"] += cfg.tree_num * int(
        not sub and cfg.hist_subtraction)
    return out


@pytest.mark.parametrize("case,kw", CASES, ids=[c for c, _ in CASES])
def test_streamed_forest_parity(tmp_path, case, kw):
    if kw.get("n_classes"):
        data = _class_data(k=kw["n_classes"])
    else:
        data = _forest_data(seed=6 if kw["algorithm"] == "GBT" else 0)
    kw = dict(tree_num=3, seed=3, valid_set_rate=0.1, **kw)
    if case.startswith("ova"):  # a ONEVSALL member's binary target
        cls = _class_data(k=3)[1]
        kw["tags_override"] = (cls == 1).astype(np.float32)
    out = _shards(tmp_path, data)
    before = _jax_hist_counters()
    ref = _jax_streamed(out, data, **dict(kw))
    after = _jax_hist_counters()
    pobs.reset()
    hk.reset_counters()
    port = _port_streamed(out, data, **dict(kw))
    counters = port_hist_counters()
    jax_deltas = {k: int(after[k] - before[k]) for k in after}
    assert _with_final_level(counters, data, kw) == jax_deltas
    mc = "_mc" if kw.get("n_classes") else ""
    assert hk.reference_calls["fused_level" + mc] == 0
    # one histogram a shard a built batch (the leaf-wise: a built leaf)
    assert hk.reference_calls["hist_level" + mc] % SHARDS == 0
    if kw.get("max_leaves"):
        assert hk.reference_calls["hist_level" + mc] == \
            SHARDS * port_hist_counters()["built"]
    assert hk.reference_calls["scan_level" + mc] > 0
    pobs.reset()
    mem = _port_memory(data, **dict(kw))
    assert port_hist_counters() == counters
    codes = data[0]
    if kw["algorithm"] == "GBT":
        got = port.spec.independent(device="cpu").compute(codes)
        np.testing.assert_allclose(
            got, ref.spec.independent().compute(codes), atol=0.03)
        np.testing.assert_allclose(
            got, mem.spec.independent(device="cpu").compute(codes),
            atol=0.03)
        return
    assert _first_diff(ref, port) is None, _first_diff(ref, port)
    _assert_forests_bit_equal(ref, port)
    _assert_pointers_equal(ref, port)
    _assert_forests_bit_equal(mem, port)
    _assert_pointers_equal(mem, port)
    assert port.valid_error == pytest.approx(ref.valid_error, abs=1e-6)
    assert port.valid_error == pytest.approx(mem.valid_error, abs=1e-6)


@pytest.mark.parametrize("alg,leaves", [("GBT", 0), ("RF", 9)])
def test_streamed_resume_is_bit_equal(tmp_path, alg, leaves):
    """2 streamed trees, then 2 more from init_trees (each shard's
    prediction state re-derived from the loaded forest), equal the
    unbroken 4-tree run bit for bit."""
    data = _forest_data(n=1500, seed=4)
    out = _shards(tmp_path, data)
    kw = dict(algorithm=alg, tree_num=4, max_depth=5, max_leaves=leaves,
              learning_rate=0.2, feature_subset_strategy="HALF", seed=5,
              dropout_rate=0.3 if alg == "GBT" else 0.0)
    full = _port_streamed(out, data, **kw)
    head = _port_streamed(out, data, **{**kw, "tree_num": 2})
    seen = []
    _c, _y, _w, slots, is_cat, cols = data
    tail = pst.train_trees_streamed(
        out, slots, is_cat, cols, ptt.TreeTrainConfig(**kw),
        init_trees=head.spec.trees,
        init_valid_errors=[head.valid_error] * 2,
        checkpoint_cb=lambda k, trees, errs: seen.append(k), device="cpu")
    assert seen == [3, 4]
    _assert_forests_bit_equal(full, tail)
    _assert_pointers_equal(full, tail)
    assert full.valid_error == tail.valid_error


def test_processor_streams_trees_when_forced(tmp_path):
    """`shifu train` RF with train.trainOnDisk (and NATIVE RF forced by
    shifu.train.forceStreaming) takes the streamed route: the in-memory
    route's model file byte for byte, its per-tree checkpoint cleared at
    the end."""
    from shifu_tpu.config.model_config import ModelConfig as JModelConfig
    from shifu_tpu_torch.models.tree import TreeModelSpec
    from shifu_tpu_torch.processor.train import TrainProcessor
    from shifu_tpu_torch.utils import environment as penv
    from tests.test_torch_config import prepare_model_set

    for kind in ("binary", "native"):
        root = str(tmp_path / kind)
        prepare_model_set(root, kind, rows=500, alg="RF", TreeNum=3,
                          MaxDepth=4)
        assert TrainProcessor(root, device="cpu").run() == 0
        model = os.path.join(root, "models", "model0.rf")
        with open(model, "rb") as fh:
            mem = fh.read()
        path = os.path.join(root, "ModelConfig.json")
        if kind == "binary":
            mc = JModelConfig.load(path)
            mc.train.train_on_disk = True
            mc.save(path)
        else:
            penv.set_property("shifu.train.forceStreaming", "true")
        hk.reset_counters()
        try:
            assert TrainProcessor(root, device="cpu").run() == 0
        finally:
            penv._props.pop("shifu.train.forceStreaming", None)
        assert hk.reference_calls["fused_level"] == 0
        assert hk.reference_calls["fused_level_mc"] == 0
        with open(model, "rb") as fh:  # the errors too: byte-identical
            assert fh.read() == mem
        assert len(TreeModelSpec.load(model).trees) == 3
        assert not os.path.exists(os.path.join(
            root, "tmp", "train", "checkpoint_0", "trees.ckpt"))


def test_codes_copied_once_a_shard_a_level(tmp_path):
    """Each level copies every shard's stored int16 codes once."""
    data = _forest_data(n=1200, seed=1)
    out = _shards(tmp_path, data)
    for k in pst.htod:
        pst.htod[k] = 0
    _port_streamed(out, data, algorithm="RF", tree_num=2, max_depth=3)
    assert pst.htod["copies"] == 2 * (3 + 1) * SHARDS
    assert pst.htod["bytes"] == 2 * (3 + 1) * data[0].size * 2



@pytest.mark.parametrize("K", [0, 5])
def test_merge_acc_is_one_call_over_every_row(K):
    """The card's merge of the shards' fixed-point sums (`merge_acc`, fed
    here by the exact plain accumulator `fixed_acc_reference`) gives the
    planes of one call over every row bit for bit: GBT's bf16 moment
    planes, and K class planes."""
    rng = np.random.default_rng(K)
    lay = ptt.make_layout([9, 17, 5], [False, True, False])
    n, L = 4000, 4
    codes = torch.as_tensor(np.stack([rng.integers(0, s, n) for s in
                                      (9, 17, 5)], 1).astype(np.int32))
    y = torch.as_tensor((rng.integers(0, K, n) if K else rng.normal(
        size=n)).astype(np.float32))
    w = torch.as_tensor(rng.uniform(0.5, 2.0, n).astype(np.float32))
    node = torch.as_tensor(rng.integers(0, L, n).astype(np.int32))
    act = torch.as_tensor(rng.random(n) < 0.8)
    kw = dict(L=L, lay=lay, low_precision=not K, n_classes=K)
    want = hk.hist_level_fixed_reference(codes, y, w, node, act, **kw)
    parts = []
    for a, b in ((0, 700), (700, 2600), (2600, 4000)):
        acc, maxabs = hk.fixed_acc_reference(codes[a:b], y[a:b], w[a:b],
                                             node[a:b], act[a:b], **kw)
        parts.append((acc, maxabs, b - a))
    got = hk.merge_acc(parts)
    assert got.dtype == torch.float32 and torch.equal(got, want)

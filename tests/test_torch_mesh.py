"""The port's device mesh (`parallel/mesh.py`) and the meshed tree growers
against the JAX package's, on the CPU.

The JAX side runs on its 8 virtual CPU devices (`data_mesh()`, the
conftest's forced platform), with `-Dshifu.pallas.mode=off`; the port on
`data_mesh(virtual=S, device="cpu")`, S shards on the CPU (1, 2, 3 and 8
where a test says so). Inputs are numpy draws from a seed.

Tolerances: the helpers equal; RF and NATIVE RF forests bit-equal to the
port's one-device forest and to the JAX 8-device forest, child pointers
included (integer count planes are exact under any summation order);
GBT features and masks equal and leaves within 1e-4 of the port's
one-device forest (the JAX package's own mesh bound, tests/test_tree.py:
253), features equal and scores within 0.03 of the JAX 8-device forest
(its planes are f32, the port's GBT planes bf16); meshed growers call the histogram-only and scan-only
entries' plain versions, never the fused entry.
"""

import logging

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from shifu_tpu.parallel import mesh as jmesh  # noqa: E402
from shifu_tpu.train import tree_trainer as jtt  # noqa: E402
from shifu_tpu.utils import environment  # noqa: E402
from shifu_tpu_torch.models import tree as ptree  # noqa: E402
from shifu_tpu_torch.norm.dataset import write_codes  # noqa: E402
from shifu_tpu_torch.ops import hist_kernel as hk  # noqa: E402
from shifu_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from shifu_tpu_torch.train import streaming_tree as pst  # noqa: E402
from shifu_tpu_torch.train import tree_trainer as ptt  # noqa: E402
from tests.test_torch_tree import (_assert_forests_bit_equal,  # noqa: E402
                                   _assert_pointers_equal, _class_data,
                                   _forest_data)


def _cpu(S, **kw):
    return pmesh.data_mesh(virtual=S, device="cpu", **kw)


# ---------------------------------------------------------------------------
# the helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dcn", [None, 2])
def test_helpers_match_jax(dcn):
    jm, pm = jmesh.data_mesh(8, dcn_slices=dcn), _cpu(8, dcn_slices=dcn)
    assert pm.axis_names == tuple(jm.axis_names)
    assert pm.shape == tuple(jm.devices.shape)
    assert pmesh.row_axes(pm) == jmesh.row_axes(jm)
    assert pmesh.row_shard_count(pm) == jmesh.row_shard_count(jm) == 8
    for n in (1, 7, 8, 1003):
        assert pmesh.round_up_rows(n, pm) == jmesh.round_up_rows(n, jm)
    rng = np.random.default_rng(0)
    a = rng.normal(size=(1003, 3)).astype(np.float32)
    b = rng.integers(0, 5, size=1003).astype(np.int32)
    (ja, jb), jn = jmesh.pad_rows([a, b], 8)
    (pa, pb), pn = pmesh.pad_rows([a, b], 8)
    assert jn == pn == 1003
    np.testing.assert_array_equal(pa, ja)
    np.testing.assert_array_equal(pb, jb)
    # shard s of the port holds the rows of the JAX array's shard s
    jarr = jmesh.shard_rows(ja, jm)
    by_start = {sh.index[0].start or 0: np.asarray(sh.data)
                for sh in jarr.addressable_shards}
    blocks = pmesh.shard_rows(pa, pm)
    assert len(blocks) == len(by_start) == 8
    for s, blk in enumerate(blocks):
        np.testing.assert_array_equal(blk.numpy(), by_start[s * 1008 // 8])
    # the axis-aware split pads with zeros to the same row count
    t = torch.as_tensor(a.T.copy())
    parts = pmesh.shard_padded(t, pm, axis=1)
    np.testing.assert_array_equal(torch.cat(parts, dim=1).numpy(), pa.T)


def test_psum_order_and_topology():
    pm = _cpu(8, dcn_slices=2)
    parts = [torch.tensor([2.0 ** 24 if s == 0 else 1.0]) for s in range(8)]
    # hierarchical: slice 0 = 2^24 + 1 + 1 + 1 (each 1 lost), slice 1 = 4
    assert pmesh.hierarchical_reduce(pm)
    assert float(pmesh.psum(parts, pm)[0]) == 2.0 ** 24 + 4
    environment.set_property("shifu.reduce.topology", "flat")
    try:
        from shifu_tpu_torch.utils import environment as penv

        penv.set_property("shifu.reduce.topology", "flat")
        assert not pmesh.hierarchical_reduce(pm)
        assert float(pmesh.psum(parts, pm)[0]) == 2.0 ** 24
        assert jmesh.hierarchical_reduce(jmesh.data_mesh(8, dcn_slices=2)) \
            == pmesh.hierarchical_reduce(pm)
    finally:
        environment.set_property("shifu.reduce.topology", "")
        penv.set_property("shifu.reduce.topology", "")
    assert not pmesh.hierarchical_reduce(_cpu(8))


def test_unported_axes_raise_naming_a13(monkeypatch):
    """Every axis is ported (the `model` axis with A.13.1): the model
    axis lays out as the JAX mesh does, rows shard over the data axes
    only, and a device count the model axis does not divide raises."""
    for kw in (dict(model_axis=2), dict(model_axis=2, dcn_slices=2),
               dict(model_axis=4), dict(model_axis=1, dcn_slices=2)):
        jm = jmesh.data_mesh(8, **kw)
        pm = pmesh.data_mesh(virtual=8, device="cpu", **kw)
        assert pm.axis_names == tuple(jm.axis_names), kw
        assert pm.shape == tuple(jm.devices.shape), kw
        assert pmesh.row_axes(pm) == tuple(jmesh.row_axes(jm)), kw
        assert pmesh.row_shard_count(pm) == jmesh.row_shard_count(jm)
        assert pm.size == pmesh.row_shard_count(pm)
        m = kw["model_axis"]
        assert pm.model_size == m
        assert len(pm.model_devices) == (pm.size if m > 1 else 0)
        assert pmesh.round_up_rows(13, pm) == jmesh.round_up_rows(13, jm)
    with pytest.raises(ValueError, match="model axis"):
        pmesh.data_mesh(virtual=6, device="cpu", model_axis=4)
    from shifu_tpu_torch.data import pipeline as pp
    from shifu_tpu_torch.utils import environment as penv

    # more than one host is no mesh axis: the knobs give a HostPlan the
    # lifecycle's ShardPlan composes on (host 1 of 2: the odd chunks)
    penv.set_property("shifu.lifecycle.hosts", "2")
    penv.set_property("shifu.lifecycle.hostIndex", "1")
    try:
        plan = pp.ShardPlan(2)
        assert (pmesh.lifecycle_hosts(), pmesh.lifecycle_host_index()) \
            == (2, 1)
    finally:
        penv.set_property("shifu.lifecycle.hosts", "")
        penv.set_property("shifu.lifecycle.hostIndex", "")
    assert [c for c in range(7) if plan.host.owns(c)] == [1, 3, 5]
    assert [plan.shard_of(c) for c in (1, 3, 5)] == [0, 1, 0]
    # the steps' mesh: one device on the CPU, and on one card
    assert pmesh.train_mesh(torch.device("cpu")) is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert pmesh.train_mesh(torch.device("cuda")) is None
    assert pmesh.lifecycle_shards(torch.device("cpu")) == 1
    assert pmesh.lifecycle_shards(torch.device("cuda")) == 1
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert pmesh.lifecycle_shards(torch.device("cuda")) == 4
    lm = pmesh.lifecycle_mesh(6, torch.device("cuda"))
    assert [d.index for d in lm.devices] == [0, 1, 2, 3, 0, 1]


def test_mesh_device_and_replicate():
    pm = _cpu(3)
    mesh, dev = pmesh.mesh_device(pm, None)
    assert mesh is pm and dev == torch.device("cpu")
    one, dev1 = pmesh.mesh_device(_cpu(1), "cuda")  # a one-shard mesh
    assert one is None and dev1 == torch.device("cpu")
    t = torch.arange(4.0)
    reps = pmesh.replicate(t, pm)
    assert len(reps) == 3 and all(r is t for r in reps)
    assert pm.distinct() == [torch.device("cpu")]


# ---------------------------------------------------------------------------
# in-memory trees (JAX tests/test_tree.py:234-255, test_dcn_mesh.py:52-70)
# ---------------------------------------------------------------------------


def _pad_data(seed=7):
    """JAX test_tree.py's mesh case: 1003 rows, not divisible by 8."""
    rng = np.random.default_rng(seed)
    n, F, S = 1003, 10, 12
    codes = rng.integers(0, S, size=(n, F)).astype(np.int32)
    y = (codes[:, 0] + codes[:, 1]
         + rng.normal(scale=2, size=n) > S).astype(np.float32)
    w = np.ones(n, np.float32)
    return (codes, y, w, [S] * F, [False] * (F - 2) + [True, True],
            [f"c{i}" for i in range(F)])


def _jax_meshed(data, mesh=None, **kw):
    codes, y, w, slots, is_cat, cols = data
    environment.set_property("shifu.pallas.mode", "off")
    try:
        return jtt.train_trees(codes, y, w, slots, is_cat, cols,
                               jtt.TreeTrainConfig(**kw),
                               mesh=mesh or jmesh.data_mesh())
    finally:
        environment.set_property("shifu.pallas.mode", "")


def _port(data, mesh=None, **kw):
    codes, y, w, slots, is_cat, cols = data
    return ptt.train_trees(codes, y, w, slots, is_cat, cols,
                           ptt.TreeTrainConfig(**kw), device="cpu",
                           mesh=mesh)


@pytest.fixture(scope="module")
def pad_case():
    data = _pad_data()
    kw = {alg: dict(algorithm=alg, tree_num=4, max_depth=4, seed=3)
          for alg in ("RF", "GBT")}
    return data, kw, {alg: _jax_meshed(data, **kw[alg]) for alg in kw}


@pytest.mark.parametrize("S", [1, 2, 3, 8])
def test_meshed_rf_bit_equal(pad_case, S):
    data, kw, jax8 = pad_case
    hk.reset_counters()
    got = _port(data, _cpu(S), **kw["RF"])
    if S > 1:  # never the fused entry on a mesh: S histograms a level
        assert hk.reference_calls["fused_level"] == 0
        assert hk.reference_calls["hist_level"] == 4 * 4 * S
        assert hk.reference_calls["scan_level"] == 4 * 4
    _assert_forests_bit_equal(got, _port(data, **kw["RF"]))
    _assert_forests_bit_equal(got, jax8["RF"])


@pytest.mark.parametrize("S", [3, 8])
def test_meshed_gbt_within_bounds(pad_case, S):
    data, kw, jax8 = pad_case
    got = _port(data, _cpu(S), **kw["GBT"])
    one = _port(data, **kw["GBT"])
    for t0, t1 in zip(one.spec.trees, got.spec.trees):
        np.testing.assert_array_equal(t0.feature, t1.feature)
        np.testing.assert_array_equal(t0.left_mask, t1.left_mask)
        np.testing.assert_allclose(t0.leaf_value, t1.leaf_value, atol=1e-4)
    # the JAX package's XLA planes are f32, the port's GBT planes bf16:
    # the same features, scores within its kernel-on/off bound
    for t0, t1 in zip(jax8["GBT"].spec.trees, got.spec.trees):
        np.testing.assert_array_equal(t0.feature, t1.feature)
    codes = torch.as_tensor(data[0])
    score = ptree.IndependentTreeModel(got.spec, device="cpu").compute(codes)
    want = np.asarray(jax8["GBT"].spec.independent().compute(data[0]))
    assert np.abs(np.asarray(score).reshape(-1)
                  - want.reshape(-1)).max() <= 0.03
    assert got.valid_error == pytest.approx(one.valid_error, abs=1e-4)


def test_meshed_native_rf_bit_equal():
    """NATIVE RF (K = 5) on 8 shards through the K-class entries' plain
    versions: the one-device forest, and the JAX 8-device forest."""
    data = _class_data(n=1003, k=5)
    kw = dict(algorithm="RF", tree_num=3, max_depth=5, n_classes=5,
              impurity="gini", seed=4)
    hk.reset_counters()
    got = _port(data, _cpu(8), **kw)
    assert hk.reference_calls["hist_level_mc"] > 0
    assert hk.reference_calls["scan_level_mc"] > 0
    assert hk.reference_calls["fused_level_mc"] == 0
    _assert_forests_bit_equal(got, _port(data, **kw))
    _assert_forests_bit_equal(got, _jax_meshed(data, **kw))
    assert got.valid_error == _port(data, **kw).valid_error


def test_leafwise_ignores_the_mesh(caplog):
    data = _forest_data(n=1003)
    kw = dict(algorithm="RF", tree_num=2, max_leaves=9, max_depth=5,
              seed=2)
    with caplog.at_level(logging.WARNING):
        got = _port(data, _cpu(8), **kw)
    assert "ignoring mesh" in caplog.text
    one = _port(data, **kw)
    _assert_forests_bit_equal(got, one)
    _assert_pointers_equal(got, one)


@pytest.mark.parametrize("alg", ["RF", "GBT"])
def test_host_batched_grower_on_the_mesh(alg):
    """Depth past the node budget: the host-batched `build_tree`, a
    batch's histogram a shard and merged; RF bit-equal across 1 and 8
    shards, GBT's features equal and leaves within 1e-4."""
    data = _forest_data(n=1003)
    kw = dict(algorithm=alg, tree_num=2, max_depth=9, max_stats_memory_mb=1,
              seed=5, learning_rate=0.3)
    one, got = _port(data, **kw), _port(data, _cpu(8), **kw)
    if alg == "RF":
        _assert_forests_bit_equal(got, one)
        return
    for t0, t1 in zip(one.spec.trees, got.spec.trees):
        np.testing.assert_array_equal(t0.feature, t1.feature)
        np.testing.assert_allclose(t0.leaf_value, t1.leaf_value, atol=1e-4)


def test_gbt_on_dcn_mesh_matches_single_device():
    """JAX tests/test_dcn_mesh.py:52-70: the (dcn, data) mesh's
    hierarchical merge leaves the GBT forest within 1e-4."""
    rng = np.random.default_rng(3)
    n, f, bins = 1600, 5, 8
    codes = rng.integers(0, bins, size=(n, f)).astype(np.int32)
    y = ((codes[:, 0] >= 4) | (codes[:, 1] <= 2)).astype(np.float32)
    data = (codes, y, np.ones(n, np.float32), [bins] * f, [False] * f,
            [f"c{i}" for i in range(f)])
    kw = dict(algorithm="GBT", tree_num=4, max_depth=4, learning_rate=0.3,
              valid_set_rate=0.15, seed=7, min_instances_per_node=2)
    one = _port(data, **kw)
    got = _port(data, _cpu(8, dcn_slices=2), **kw)
    jax8 = _jax_meshed(data, jmesh.data_mesh(8, dcn_slices=2), **kw)
    for ref in (one, jax8):
        for t0, t1 in zip(ref.spec.trees, got.spec.trees):
            np.testing.assert_array_equal(t0.feature, t1.feature)
            np.testing.assert_allclose(t0.leaf_value, t1.leaf_value,
                                       atol=1e-4)


# ---------------------------------------------------------------------------
# streamed trees (JAX tests/test_streaming_train.py:321)
# ---------------------------------------------------------------------------


def _streamed_case(tmp_path):
    rng = np.random.default_rng(21)
    n, f, bins = 2000, 5, 8
    codes = rng.integers(0, bins, size=(n, f)).astype(np.int16)
    y = ((codes[:, 0] >= 4) | (codes[:, 2] <= 1)).astype(np.int8)
    w = np.ones(n, np.float32)
    cols = [f"c{i}" for i in range(f)]
    out = str(tmp_path / "CleanedData")
    write_codes(out, codes, y, w, cols, [bins] * f, n_shards=3)
    return out, [bins] * f, [False] * f, cols


@pytest.mark.parametrize("alg", ["RF", "GBT"])
def test_streamed_trees_on_the_mesh(tmp_path, alg):
    """The streamed grower on 8 shards: RF bit-equal to its 1-shard run
    and to the JAX meshed streamed forest; GBT (JAX's case) features
    equal, leaves within 1e-4."""
    from shifu_tpu.train.streaming_tree import train_trees_streamed

    out, slots, is_cat, cols = _streamed_case(tmp_path)
    kw = dict(algorithm=alg, tree_num=4, max_depth=4, learning_rate=0.3,
              valid_set_rate=0.15, seed=5, min_instances_per_node=2)
    hk.reset_counters()
    got = pst.train_trees_streamed(out, slots, is_cat, cols,
                                   ptt.TreeTrainConfig(**kw), mesh=_cpu(8))
    assert hk.reference_calls["fused_level"] == 0
    one = pst.train_trees_streamed(out, slots, is_cat, cols,
                                   ptt.TreeTrainConfig(**kw), device="cpu")
    environment.set_property("shifu.pallas.mode", "off")
    try:
        want = train_trees_streamed(out, slots, is_cat, cols,
                                    jtt.TreeTrainConfig(**kw),
                                    mesh=jmesh.data_mesh())
    finally:
        environment.set_property("shifu.pallas.mode", "")
    if alg == "RF":
        _assert_forests_bit_equal(got, one)
        _assert_forests_bit_equal(got, want)
        assert got.valid_error == pytest.approx(one.valid_error, abs=1e-7)
        return
    for ref in (one, want):
        for t0, t1 in zip(ref.spec.trees, got.spec.trees):
            np.testing.assert_array_equal(t0.feature, t1.feature)
            np.testing.assert_allclose(t0.leaf_value, t1.leaf_value,
                                       atol=1e-4)


def test_streamed_native_rf_and_resume_on_the_mesh(tmp_path):
    """NATIVE RF streamed on 3 shards equals the one-device streamed
    forest, and a run resumed at tree 2 on the mesh equals the unbroken
    meshed run."""
    data = _class_data(n=900, k=3)
    codes, y, w, slots, is_cat, cols = data
    out = str(tmp_path / "CleanedData")
    write_codes(out, codes, y, w, cols, slots, n_shards=4)
    kw = dict(algorithm="RF", tree_num=4, max_depth=5, n_classes=3,
              impurity="gini", seed=9)
    run = lambda **a: pst.train_trees_streamed(  # noqa: E731
        out, slots, is_cat, cols, ptt.TreeTrainConfig(**kw), **a)
    got = run(mesh=_cpu(3))
    _assert_forests_bit_equal(got, run(device="cpu"))
    half = got.spec.trees[:2]
    resumed = run(mesh=_cpu(3), init_trees=half,
                  init_valid_errors=[0.0, 0.0])
    _assert_forests_bit_equal(resumed, got)

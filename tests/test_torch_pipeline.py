"""The port's streamed-route pipeline (`shifu_tpu_torch/data/pipeline.py`)
against the JAX package's: `prefetch_iter` (the cases of
`tests/test_pipeline.py::TestPrefetchIter` that the port keeps), the
ShardPlan, and the device fold of the streamed stats against a plain
host fold and against its own snapshot."""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from shifu_tpu_torch.data import pipeline as pp  # noqa: E402
from shifu_tpu_torch.ops.binagg import bin_aggregate  # noqa: E402
from shifu_tpu_torch.utils import environment as penv  # noqa: E402

CPU = torch.device("cpu")


class TestPrefetchIter:
    @pytest.mark.parametrize("depth", [0, 1, 3])
    def test_order_and_transform_match_jax(self, depth):
        from shifu_tpu.data.pipeline import prefetch_iter as jprefetch

        got = list(pp.prefetch_iter(range(50), depth=depth,
                                    transform=lambda x: x * 2))
        want = list(jprefetch(range(50), depth=depth,
                              transform=lambda x: x * 2))
        assert got == want == [2 * i for i in range(50)]

    def test_depth_zero_is_serial_inline(self):
        main = threading.get_ident()
        seen = []
        list(pp.prefetch_iter(range(5), depth=0,
                              transform=lambda x: seen.append(
                                  threading.get_ident()) or x))
        assert seen == [main] * 5

    @pytest.mark.parametrize("depth", [0, 2])
    def test_worker_exception_reraises_in_consumer(self, depth):
        def boom(x):
            if x == 3:
                raise ValueError("chunk 3 bad")
            return x

        got = []
        with pytest.raises(ValueError, match="chunk 3 bad"):
            for v in pp.prefetch_iter(range(10), depth=depth,
                                      transform=boom):
                got.append(v)
        assert got == [0, 1, 2]

    def test_failing_source_iter_raises_not_hangs(self):
        class BadSource:
            def __iter__(self):
                raise OSError("no such file")

        with pytest.raises(OSError, match="no such file"):
            list(pp.prefetch_iter(BadSource(), depth=2))

    def test_early_break_stops_worker(self):
        before = threading.active_count()
        it = pp.prefetch_iter(range(10_000), depth=2)
        for v in it:
            if v == 5:
                break
        it.close()
        deadline = time.time() + 5.0
        while threading.active_count() > before and time.time() < deadline:
            time.sleep(0.01)
        assert threading.active_count() <= before

    def test_depth_from_environment_knob(self):
        from shifu_tpu.data.pipeline import (prefetch_chunks_setting as
                                             jsetting)

        penv.set_property("shifu.ingest.prefetchChunks", "5")
        try:
            assert pp.prefetch_chunks_setting() == 5
        finally:
            penv._props.pop("shifu.ingest.prefetchChunks", None)
        assert pp.prefetch_chunks_setting() == jsetting() == 2


def test_shard_plan_matches_jax():
    from shifu_tpu.data.pipeline import HostPlan as JHostPlan
    from shifu_tpu.data.pipeline import ShardPlan as JShardPlan

    for s in (1, 3):
        plan = pp.ShardPlan(s)
        jplan = JShardPlan(s, host=JHostPlan(n_hosts=1, host_index=0))
        assert [plan.shard_of(c) for c in range(11)] == [
            jplan.shard_of(c) for c in range(11)]
        cursors = [4, -1, 7][:s]
        items = [(c, c * 10) for c in range(11)]
        assert list(plan.resume_slice(items, cursors)) == list(
            jplan.resume_slice(items, cursors))
    assert pp.ShardPlan().n_shards == 1
    # more than one host: the knobs give host 0 of a 2-host plan, which
    # folds the JAX 2-host plan's chunks on the same shards
    penv.set_property("shifu.lifecycle.hosts", "2")
    try:
        plan = pp.ShardPlan(3)
    finally:
        penv._props.pop("shifu.lifecycle.hosts", None)
    assert (plan.host.n_hosts, plan.host.host_index) == (2, 0)
    jplan = JShardPlan(3, host=JHostPlan(n_hosts=2, host_index=0))
    items = [(c, c * 10) for c in range(11)]
    assert [plan.shard_of(c) for c in range(11)] == [
        jplan.shard_of(c) for c in range(11)]
    assert list(plan.resume_slice(items, [2, -1, -1])) == list(
        jplan.resume_slice(items, [2, -1, -1]))


def _chunks(seed: int, n_chunks: int, C: int = 4, slots: int = 6):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_chunks):
        n = int(rng.integers(0, 300))
        codes = rng.integers(0, slots, (n, C)).astype(np.int32)
        tags = rng.integers(-1, 2, n).astype(np.int32)
        weights = rng.choice([0.5, 1.0, 1.25, 2.0], n).astype(np.float32)
        values = rng.integers(-50, 50, (n, 2)).astype(np.float32)
        values[rng.random((n, 2)) < 0.1] = np.nan
        out.append((codes, tags, weights, values))
    return out, np.arange(C, dtype=np.int32) * slots, C * slots


def test_device_accumulator_equals_host_fold():
    """The chunk-by-chunk device fold equals one aggregate of all rows
    (exact: integer counts, f64 sums of exact values)."""
    chunks, offs, total = _chunks(0, 7)
    acc = pp.DeviceAccumulator(CPU)
    assert acc.fetch() is None
    for c in chunks:
        acc.fold(c[0], offs, total, *c[1:])
    got = acc.fetch()
    whole = [np.concatenate([c[k] for c in chunks]) for k in range(4)]
    want = bin_aggregate(*[torch.from_numpy(a) for a in (
        whole[0], offs)], total, *[torch.from_numpy(a) for a in whole[1:]])
    assert acc.rows == int((whole[1] >= 0).sum())
    for g, w in zip(got, want):
        assert g.dtype == np.float64
        np.testing.assert_array_equal(g, w.numpy().astype(np.float64))
    # against a plain host fold of the counts
    flat = whole[0] + offs[None, :]
    pos = np.zeros(total)
    np.add.at(pos, flat[whole[1] == 1].reshape(-1), 1)
    np.testing.assert_array_equal(got[0], pos)


def test_device_accumulator_snapshot_restore_bits():
    chunks, offs, total = _chunks(1, 6)
    whole = pp.DeviceAccumulator(CPU)
    for c in chunks:
        whole.fold(c[0], offs, total, *c[1:])
    first = pp.DeviceAccumulator(CPU)
    for c in chunks[:3]:
        first.fold(c[0], offs, total, *c[1:])
    snap = first.snapshot()
    resumed = pp.DeviceAccumulator(CPU)
    resumed.restore(snap)
    for c in chunks[3:]:
        resumed.fold(c[0], offs, total, *c[1:])
    for a, b in zip(whole.fetch(), resumed.fetch()):
        assert a.tobytes() == b.tobytes()
    empty = pp.DeviceAccumulator(CPU)
    empty.restore(pp.DeviceAccumulator(CPU).snapshot())
    assert empty.fetch() is None

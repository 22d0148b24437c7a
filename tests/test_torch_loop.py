"""The port's serving loop (`shifu_tpu_torch/loop/`: the traffic log,
online PSI drift, hot-swap with shadow scoring, the promote gates) vs the
JAX package's `tests/test_loop.py` cases and the JAX modules, on the CPU.

Each JAX case of `TestTrafficLog`, `TestFleetTrafficLog`,
`TestDriftMonitor`, `TestHotSwap` and `TestPromoteGates` has its
counterpart here under the same name, on the port's modules (the
registries on device="cpu"). On top:
  * the window counts of the port's device fold equal the JAX
    `traced_fold`'s exactly, on the same featurized values (the JAX
    `fold_host` too where its featurize runs: under this sandbox's pandas
    its `flat_numeric_matrix` can write into a read-only buffer, ROADMAP
    C.1), and the PSI within 1e-12;
  * the fold's out-of-range slot ids drop as JAX's `mode="drop"`;
  * the server: the drift fold by default with a ColumnConfig, /healthz
    degrading on shifted traffic, the traffic log read back, `/admin/*`
    and `shifu promote --serve-url`, and the promote exit codes and
    manifest (live leases: the fleet round, test_torch_lease.py and
    test_torch_chaos_fleet.py hold it with live participants).
Every HTTP call and thread join takes a timeout.
"""

import glob
import json
import os
import shutil
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from shifu_tpu_torch.utils import environment  # noqa: E402
from tests.helpers import make_binary_dataset, make_model_set  # noqa: E402
from tests.test_torch_config import jax_inline_ingest  # noqa: E402


class _Props:
    """Env-property overrides for one test, restored on exit."""

    def __init__(self, **props):
        self.props = {k.replace("_", "."): v for k, v in props.items()}

    def __enter__(self):
        for k, v in self.props.items():
            environment.set_property(k, v)
        return self

    def __exit__(self, *exc):
        for k in self.props:
            environment.set_property(k, "")


def _counter_delta(before, after, prefix):
    """Per-key counter deltas for keys starting with `prefix`."""
    out = {}
    for k, v in after.items():
        if k.startswith(prefix):
            d = v - before.get(k, 0.0)
            if d:
                out[k] = d
    return out


def _snapshot_counters():
    from shifu_tpu_torch import obs

    return dict(obs.registry().snapshot().get("counters", {}))


@pytest.fixture(scope="module")
def model_set(tmp_path_factory):
    """One NN model set for the whole module, made by the JAX steps (stats
    bins + counts feed the drift baseline; models feed serve/hot-swap)."""
    from shifu_tpu.processor.init import InitProcessor
    from shifu_tpu.processor.norm import NormProcessor
    from shifu_tpu.processor.stats import StatsProcessor
    from shifu_tpu.processor.train import TrainProcessor

    root = str(tmp_path_factory.mktemp("loop_ms"))
    make_model_set(root, n_rows=400)
    mcp = os.path.join(root, "ModelConfig.json")
    mc = json.load(open(mcp))
    mc["train"]["numTrainEpochs"] = 12
    json.dump(mc, open(mcp, "w"), indent=2)
    with jax_inline_ingest():
        for proc in (InitProcessor, StatsProcessor, NormProcessor,
                     TrainProcessor):
            assert proc(root).run() == 0
    return root


@pytest.fixture()
def column_configs(model_set):
    from shifu_tpu_torch.config import load_column_config_list

    return load_column_config_list(
        os.path.join(model_set, "ColumnConfig.json"))


def _raw_batch(names, rows):
    from shifu_tpu_torch.serve.registry import records_to_columnar

    return records_to_columnar([dict(zip(names, r)) for r in rows], names)


def _training_raw(model_set):
    from shifu_tpu_torch.data.reader import read_columnar, read_header

    names = read_header(os.path.join(model_set, "data", "header.txt"))
    return read_columnar(os.path.join(model_set, "data", "data.txt"),
                         names)


def _shifted_rows(seed):
    """Covariate shift: num_0 (field 1) scaled + offset far out of its
    training bins."""
    names, rows, _ = make_binary_dataset(n_rows=400, seed=seed)
    shifted = []
    for r in rows:
        r = list(r)
        try:
            r[1] = f"{float(r[1]) * 4.0 + 25.0:.6g}"
        except ValueError:
            pass
        shifted.append(r)
    return names, shifted


# ---------------------------------------------------------------------------
# traffic log
# ---------------------------------------------------------------------------


class _FakeResult:
    def __init__(self, n):
        self.mean = np.linspace(100.0, 900.0, n)


def _fake_data(names, n, fill="1.5"):
    from shifu_tpu_torch.serve.registry import records_to_columnar

    return records_to_columnar([{c: fill for c in names}] * n, names)


class TestTrafficLog:
    NAMES = ["a", "b"]

    def test_rotation_flush_and_meta(self, tmp_path):
        from shifu_tpu_torch.loop.traffic import TrafficLog, traffic_columns

        log = TrafficLog(str(tmp_path), traffic_columns(self.NAMES),
                         sample=1.0, chunk_rows=10)
        for _ in range(3):
            log.record(_fake_data(self.NAMES, 7), _FakeResult(7), "sha0")
        # the buffer rotates into a whole chunk file when it reaches
        # chunk_rows (14 >= 10 after batch 2); batch 3 stays buffered
        chunks = sorted(glob.glob(
            str(tmp_path / ".shifu/runs/traffic/traffic-*.psv")))
        assert len(chunks) == 1
        log.flush()
        chunks = sorted(glob.glob(
            str(tmp_path / ".shifu/runs/traffic/traffic-*.psv")))
        assert len(chunks) == 2
        rows = sum(1 for p in chunks for _ in open(p))
        assert rows == 21
        meta = json.load(open(
            tmp_path / ".shifu/runs/traffic/_meta.json"))
        assert meta["schema"] == "shifu.traffic/1"
        assert meta["columns"][-4:] == ["shifu_score_mean",
                                        "shifu_model_sha", "shifu_trace",
                                        "shifu_ts"]

    def test_seq_grows_across_restart(self, tmp_path):
        from shifu_tpu_torch.loop.traffic import TrafficLog, traffic_columns

        a = TrafficLog(str(tmp_path), traffic_columns(self.NAMES),
                       sample=1.0, chunk_rows=4)
        a.record(_fake_data(self.NAMES, 4), _FakeResult(4), "s")
        a.close()
        b = TrafficLog(str(tmp_path), traffic_columns(self.NAMES),
                       sample=1.0, chunk_rows=4)
        b.record(_fake_data(self.NAMES, 4), _FakeResult(4), "s")
        b.close()
        names = sorted(os.path.basename(p) for p in glob.glob(
            str(tmp_path / ".shifu/runs/traffic/traffic-*.psv")))
        assert names == ["traffic-00001.psv", "traffic-00002.psv"]

    def test_sampling_is_deterministic(self, tmp_path):
        from shifu_tpu_torch.loop.traffic import TrafficLog, traffic_columns

        kept = []
        for sub in ("x", "y"):
            log = TrafficLog(str(tmp_path / sub),
                             traffic_columns(self.NAMES),
                             sample=0.5, chunk_rows=1000, seed=3)
            n = sum(log.record(_fake_data(self.NAMES, 50),
                               _FakeResult(50), "s") for _ in range(4))
            log.flush()
            kept.append(n)
        assert kept[0] == kept[1]
        files = [sorted(glob.glob(str(tmp_path / sub /
                                      ".shifu/runs/traffic/*.psv")))
                 for sub in ("x", "y")]

        def rows_sans_ts(paths):
            # the trailing field is wall-clock: strip it before comparing
            return [line.rsplit("|", 1)[0]
                    for p in paths for line in open(p)]

        assert rows_sans_ts(files[0]) == rows_sans_ts(files[1])

    def test_delimiter_and_newline_sanitized(self, tmp_path):
        from shifu_tpu_torch.loop.traffic import TrafficLog, traffic_columns

        log = TrafficLog(str(tmp_path), traffic_columns(self.NAMES),
                         sample=1.0, chunk_rows=1)
        log.record(_fake_data(self.NAMES, 1, fill="bad|val\nue"),
                   _FakeResult(1), "s")
        (path,) = glob.glob(str(tmp_path / ".shifu/runs/traffic/*.psv"))
        line = open(path).read().rstrip("\n")
        # 2 feature fields + score + sha + trace + ts = exactly 6 fields
        assert len(line.split("|")) == 6
        assert "bad;val ue" in line

    def test_readback_is_an_ordinary_chunk_stream(self, tmp_path):
        from shifu_tpu_torch.loop.traffic import (
            TrafficLog,
            traffic_columns,
            traffic_source,
        )

        log = TrafficLog(str(tmp_path), traffic_columns(self.NAMES),
                         sample=1.0, chunk_rows=8)
        for _ in range(3):
            log.record(_fake_data(self.NAMES, 5), _FakeResult(5), "sha9")
        log.close()
        factory, names = traffic_source(str(tmp_path))
        assert names[:2] == self.NAMES
        chunks = list(factory())
        total = sum(c.n_rows for c in chunks)
        assert total == 15
        first = chunks[0]
        assert list(first.column("shifu_model_sha"))[0] == "sha9"
        # scores parse back numerically
        assert np.isfinite(first.numeric("shifu_score_mean")).all()

    def test_snapshot_counts_only_this_runs_chunks(self, tmp_path):
        """The manifest's chunk count is per-replica accounting: a
        restarted server must not claim the chunks a previous run left
        on disk (the seq counter DOES continue across restarts)."""
        from shifu_tpu_torch.loop.traffic import TrafficLog, traffic_columns

        a = TrafficLog(str(tmp_path), traffic_columns(self.NAMES),
                       sample=1.0, chunk_rows=4)
        a.record(_fake_data(self.NAMES, 4), _FakeResult(4), "s")
        a.close()
        assert a.snapshot()["chunks"] == 1
        b = TrafficLog(str(tmp_path), traffic_columns(self.NAMES),
                       sample=1.0, chunk_rows=4)
        assert b.snapshot()["chunks"] == 0
        b.record(_fake_data(self.NAMES, 4), _FakeResult(4), "s")
        b.close()
        assert b.snapshot()["chunks"] == 1

    def test_schema_change_retires_old_chunks(self, tmp_path):
        """A restart with a different column schema must not rewrite
        _meta.json over chunks framed with the old one — old rows would
        parse misaligned into the new columns and retrain on garbage.
        The old log retires wholesale to a superseded subdir."""
        from shifu_tpu_torch.loop.traffic import (
            TrafficLog,
            list_chunks,
            traffic_columns,
            traffic_dir,
            traffic_source,
        )

        a = TrafficLog(str(tmp_path), traffic_columns(self.NAMES),
                       sample=1.0, chunk_rows=4)
        a.record(_fake_data(self.NAMES, 4), _FakeResult(4), "s")
        a.close()
        assert len(list_chunks(str(tmp_path))) == 1
        new_cols = traffic_columns(self.NAMES + ["extra_col"])
        b = TrafficLog(str(tmp_path), new_cols, sample=1.0, chunk_rows=4)
        # active dir holds ONLY the new schema; old files retired intact
        assert list_chunks(str(tmp_path)) == []
        retired = os.path.join(traffic_dir(str(tmp_path)), "superseded-1")
        assert len(glob.glob(os.path.join(retired, "traffic-*.psv"))) == 1
        assert os.path.isfile(os.path.join(retired, "_meta.json"))
        b.record(_fake_data(self.NAMES + ["extra_col"], 4),
                 _FakeResult(4), "s")
        b.close()
        _factory, names = traffic_source(str(tmp_path))
        assert names == new_cols  # readback sees one coherent schema
        # matching-schema restart still keeps everything (no retirement)
        c = TrafficLog(str(tmp_path), new_cols, sample=1.0, chunk_rows=4)
        c.record(_fake_data(self.NAMES + ["extra_col"], 4),
                 _FakeResult(4), "s")
        c.close()
        assert len(list_chunks(str(tmp_path))) == 2

    def test_readback_without_log_raises(self, tmp_path):
        from shifu_tpu_torch.loop.traffic import traffic_source

        with pytest.raises(FileNotFoundError):
            traffic_source(str(tmp_path))


class TestFleetTrafficLog:
    """ISSUE-18 fleet sharing: N serve processes append to ONE log under
    their (sanitized) lease ids; consumers read the union."""

    NAMES = ["a", "b"]

    def _log(self, root, writer, n=4):
        from shifu_tpu_torch.loop.traffic import TrafficLog, traffic_columns

        log = TrafficLog(str(root), traffic_columns(self.NAMES),
                         sample=1.0, chunk_rows=4, writer=writer)
        log.record(_fake_data(self.NAMES, n), _FakeResult(n), "sha0")
        log.close()
        return log

    def test_writer_id_sanitizes_and_never_parses_as_seq(self):
        from shifu_tpu_torch.loop.traffic import _CHUNK_RE, writer_id

        # lease ids are host-pid-token (resilience/lease.py)
        wid = writer_id("box.example-4242-deadbeef")
        assert wid == "box_example_4242_deadbeef"
        for raw in ("12345", "", "007-x"):
            wid = writer_id(raw)
            m = _CHUNK_RE.match(f"traffic-{wid}-00001.psv")
            assert m and m.group(1) == wid, (raw, wid)

    def test_union_in_seq_then_writer_order_and_scope_filter(
            self, tmp_path):
        from shifu_tpu_torch.loop.traffic import (
            chunk_writer,
            list_chunks,
            list_writers,
        )

        self._log(tmp_path, "hostB_1_aa")
        self._log(tmp_path, "hostA_2_bb")
        self._log(tmp_path, "hostA_2_bb", n=4)  # second chunk, seq 2
        union = [os.path.basename(p) for p in list_chunks(str(tmp_path))]
        assert union == ["traffic-hostA_2_bb-00001.psv",
                         "traffic-hostB_1_aa-00001.psv",
                         "traffic-hostA_2_bb-00002.psv"]
        assert list_writers(str(tmp_path)) == ["hostA_2_bb",
                                               "hostB_1_aa"]
        only_a = list_chunks(str(tmp_path), scope="hostA_2_bb")
        assert [chunk_writer(p) for p in only_a] == ["hostA_2_bb"] * 2

    def test_per_writer_sequences_are_independent(self, tmp_path):
        """Two processes appending concurrently never race on a shared
        sequence: each writer numbers its OWN chunks, and a restart
        resumes after its own highest seq, ignoring the peer's."""
        self._log(tmp_path, "w1")
        self._log(tmp_path, "w2")
        self._log(tmp_path, "w1")  # restart of writer 1
        names = sorted(os.path.basename(p) for p in glob.glob(
            str(tmp_path / ".shifu/runs/traffic/traffic-*.psv")))
        assert names == ["traffic-w1-00001.psv", "traffic-w1-00002.psv",
                         "traffic-w2-00001.psv"]

    def test_set_writer_rebases_sequence_post_lease(self, tmp_path):
        """The server names its writer only after the lease grant;
        set_writer on a live log must re-derive the next seq from the
        new writer's own chunks."""
        from shifu_tpu_torch.loop.traffic import TrafficLog, traffic_columns

        self._log(tmp_path, "lease1")  # pre-existing chunk of lease1
        log = TrafficLog(str(tmp_path), traffic_columns(self.NAMES),
                         sample=1.0, chunk_rows=4)
        log.set_writer("lease1")
        log.record(_fake_data(self.NAMES, 4), _FakeResult(4), "s")
        log.close()
        assert log.snapshot()["writer"] == "lease1"
        names = sorted(os.path.basename(p) for p in glob.glob(
            str(tmp_path / ".shifu/runs/traffic/traffic-*.psv")))
        assert names == ["traffic-lease1-00001.psv",
                         "traffic-lease1-00002.psv"]

    def test_readback_unions_all_writers(self, tmp_path):
        from shifu_tpu_torch.loop.traffic import traffic_source

        self._log(tmp_path, "w1")
        self._log(tmp_path, "w2")
        factory, _names = traffic_source(str(tmp_path))
        rows = sum(c.n_rows for c in factory())
        assert rows == 8
        solo, _ = traffic_source(str(tmp_path), scope="w2")
        assert sum(c.n_rows for c in solo()) == 4


# ---------------------------------------------------------------------------
# drift monitor
# ---------------------------------------------------------------------------


class TestDriftMonitor:
    def test_unshifted_replay_stays_quiet(self, model_set, column_configs):
        from shifu_tpu_torch.loop.drift import DriftMonitor

        mon = DriftMonitor(column_configs, threshold=0.2, min_rows=64)
        assert mon.enabled
        mon.fold_host(_training_raw(model_set))
        v = mon.verdict()
        assert v["status"] == "ok"
        # replaying the training distribution itself: everything quiet
        assert v["maxPsi"] < 0.05, v["psi"]

    def test_shifted_replay_crosses_threshold_and_degrades(
            self, model_set, column_configs, tmp_path):
        from shifu_tpu_torch.loop.drift import DriftMonitor
        from shifu_tpu_torch.serve.health import HealthMonitor

        names, rows, _ = make_binary_dataset(n_rows=400, seed=21)
        shifted = []
        for r in rows:
            r = list(r)
            # covariate shift: num_0 (field 1) scaled + offset far out of
            # its training bins
            try:
                r[1] = f"{float(r[1]) * 4.0 + 25.0:.6g}"
            except ValueError:
                pass
            shifted.append(r)
        mon = DriftMonitor(column_configs, threshold=0.2, min_rows=64)
        mon.fold_host(_raw_batch(names, shifted))
        health = HealthMonitor()
        ledger_root = str(tmp_path)
        v = mon.check_degrade(health, ledger_root, model_sha="abc123")
        assert v is not None and v["status"] == "drift"
        assert "num_0" in v["driftedColumns"]
        assert v["psi"]["num_0"] > 0.2
        assert health.snapshot()["status"] == "degraded"
        # exactly ONE machine-readable recommendation manifest
        recs = glob.glob(os.path.join(ledger_root,
                                      ".shifu/runs/recommend-*.json"))
        assert len(recs) == 1
        rec = json.load(open(recs[0]))["recommendation"]
        assert rec["action"] == "retrain"
        assert rec["modelSetSha"] == "abc123"
        assert "num_0" in rec["drift"]["driftedColumns"]
        # a second breach on the same columns stamps no second manifest
        mon.check_degrade(health, ledger_root, model_sha="abc123")
        assert len(glob.glob(os.path.join(
            ledger_root, ".shifu/runs/recommend-*.json"))) == 1

    def test_reset_mid_flush_drops_old_window_counts(
            self, model_set, column_configs):
        """A promotion reset() landing while a window flush is between
        its swap (under the lock) and its merge-back must DROP the old
        version's counts instead of resurrecting them into the zeroed
        host fold — the new version's PSI must start from a clean
        slate."""
        from shifu_tpu_torch.loop.drift import DriftMonitor

        mon = DriftMonitor(column_configs, threshold=0.2, min_rows=64)
        assert mon.enabled
        fired = []

        class ResetOnFetch:
            """A window whose device->host copy lands mid-flush, with
            the promotion's reset() racing it."""

            def cpu(self):
                fired.append(1)
                mon.reset()  # the promotion, exactly mid-flush
                return torch.ones(mon.total_slots)

        mon.note_window(ResetOnFetch(), 8)
        mon.flush()
        assert fired
        assert float(mon._host.sum()) == 0.0  # old counts dropped
        # and post-reset traffic still folds normally
        mon.note_window(torch.ones(mon.total_slots), 8)
        mon.flush()
        assert float(mon._host.sum()) == float(mon.total_slots)
        # the fold-ADOPTION path is guarded the same way: a window read
        # before the reset must not be adopted after it (the registry
        # passes window()'s generation back through note_window)
        _w, gen = mon.window()
        mon.reset()
        mon.note_window(torch.full((mon.total_slots,), 7.0), 8, gen=gen)
        assert mon._rows == 0 and not mon._windows  # stale: dropped
        w, gen = mon.window()
        mon.note_window(w + 1.0, 8, gen=gen)  # current gen: adopted
        mon.flush()
        assert float(mon._host.sum()) == float(mon.total_slots)
        # a fold whose BASE window a concurrent flush already merged
        # must be DROPPED (its token's flush epoch is stale)
        w, tok = mon.window()
        mon.note_window(w + 1.0, 8, gen=tok)
        mon.flush()          # merges w+1.0; bumps the key's epoch
        before = float(mon._host.sum())
        mon.note_window(w + 1.0, 8, gen=tok)  # stale epoch: dropped
        mon.flush()
        assert float(mon._host.sum()) == before
        # and a fresh token folds normally again
        w, tok = mon.window()
        mon.note_window(w + 1.0, 8, gen=tok)
        mon.flush()
        assert float(mon._host.sum()) == before + float(mon.total_slots)

    def test_reset_reopens_the_degrade_loop(self, model_set,
                                            column_configs, tmp_path):
        """After a promote acts on the recommendation, reset() clears the
        monitor so drift on the NEW version's traffic degrades and
        recommends AGAIN — the closed loop closes more than once."""
        from shifu_tpu_torch.loop.drift import DriftMonitor
        from shifu_tpu_torch.serve.health import HealthMonitor

        names, rows, _ = make_binary_dataset(n_rows=400, seed=22)
        shifted = []
        for r in rows:
            r = list(r)
            try:
                r[1] = f"{float(r[1]) * 4.0 + 25.0:.6g}"
            except ValueError:
                pass
            shifted.append(r)
        mon = DriftMonitor(column_configs, threshold=0.2, min_rows=64)
        health = HealthMonitor()
        ledger_root = str(tmp_path)
        mon.fold_host(_raw_batch(names, shifted))
        assert mon.check_degrade(health, ledger_root,
                                 model_sha="v1")["status"] == "drift"
        # promote path: recommendation acted on — health clears, monitor
        # resets (what ScoringServer.promote_candidate does)
        health.clear_degraded()
        mon.reset()
        assert health.snapshot()["status"] == "ok"
        assert mon.verdict()["rows"] == 0
        # the new version drifts too: re-degrades + SECOND recommendation
        mon.fold_host(_raw_batch(names, shifted))
        v = mon.check_degrade(health, ledger_root, model_sha="v2")
        assert v["status"] == "drift"
        assert health.snapshot()["status"] == "degraded"
        recs = sorted(glob.glob(os.path.join(
            ledger_root, ".shifu/runs/recommend-*.json")))
        assert len(recs) == 2
        assert json.load(open(recs[1]))["recommendation"][
            "modelSetSha"] == "v2"

    def test_clear_degraded_spares_crash_degrades(self):
        """A promote clears the STICKY (drift) degrade only: scoring
        crashes degrade through their own hysteresis, and routing full
        traffic back onto a still-crashing replica because an unrelated
        promote landed would be wrong."""
        from shifu_tpu_torch.serve.health import HealthMonitor

        h = HealthMonitor()
        h.note_crash("worker died")
        assert h.snapshot()["status"] == "degraded"
        h.clear_degraded()  # promote acts on drift, not on crashes
        assert h.snapshot()["status"] == "degraded"
        # a PURE drift degrade (no crash underneath) DOES clear
        h2 = HealthMonitor()
        h2.note_degraded("psi over threshold")
        h2.clear_degraded()
        assert h2.snapshot()["status"] == "ok"

    def test_clear_degraded_keeps_layered_crash_degrade(self):
        """Crash degrade + drift degrade can LAYER; promoting away the
        drift must leave the crash degrade (and its clean-batch
        hysteresis) underneath."""
        from shifu_tpu_torch.serve.health import HealthMonitor

        h = HealthMonitor(ok_after=2)
        h.note_crash("worker died")
        h.note_degraded("psi over threshold")
        h.clear_degraded()  # promote acted on the drift only
        snap = h.snapshot()
        assert snap["status"] == "degraded"
        assert snap["reason"] == "worker died"  # crash cause restored
        h.note_ok()
        h.note_ok()  # hysteresis resumes and heals the crash degrade
        assert h.snapshot()["status"] == "ok"

    def test_check_degrade_returns_verdict_when_quiet(
            self, model_set, column_configs):
        """One verdict computation per cadence: the quiet path hands the
        verdict back instead of None, so callers never call verdict()
        a second time."""
        from shifu_tpu_torch.loop.drift import DriftMonitor

        mon = DriftMonitor(column_configs, threshold=0.2, min_rows=64)
        mon.fold_host(_training_raw(model_set))
        v = mon.check_degrade()
        assert v is not None and v["status"] == "ok"

    def test_warming_below_min_rows_never_degrades(self, column_configs):
        from shifu_tpu_torch.loop.drift import DriftMonitor

        mon = DriftMonitor(column_configs, threshold=0.0, min_rows=10_000)
        names, rows, _ = make_binary_dataset(n_rows=50, seed=33)
        mon.fold_host(_raw_batch(names, rows))
        v = mon.verdict()
        assert v["status"] == "warming"
        assert v["driftedColumns"] == []
        assert mon.check_degrade() is None or v["status"] != "drift"

    def test_fused_fold_matches_host_fold(self, model_set, column_configs):
        """The traced in-program fold and the host fallback fold must
        agree bin-for-bin — one drift definition, two execution paths."""
        from shifu_tpu_torch.loop.drift import DriftMonitor
        from shifu_tpu_torch.serve.registry import ModelRegistry

        fused_mon = DriftMonitor(column_configs, threshold=0.2,
                                 min_rows=64)
        reg = ModelRegistry(os.path.join(model_set, "models"),
                            drift=fused_mon, device="cpu")
        assert reg.fused
        raw = _training_raw(model_set)
        reg.score_raw(raw)
        host_mon = DriftMonitor(column_configs, threshold=0.2, min_rows=64)
        host_mon.fold_host(raw)
        a = fused_mon.psi_by_column()
        b = host_mon.psi_by_column()
        assert set(a) == set(b)
        for k in a:
            assert a[k] == pytest.approx(b[k], abs=1e-9), k
        # and the raw counts themselves are identical
        assert np.array_equal(fused_mon._host, host_mon._host)

    def test_warm_does_not_pollute_drift_window(self, model_set,
                                                column_configs):
        """Startup warm-up scores synthetic all-"0" rows; they are not
        traffic and must fold NOTHING into the drift monitor — else they
        burn the min-rows warm-up and skew the PSI baseline."""
        from shifu_tpu_torch.loop.drift import DriftMonitor
        from shifu_tpu_torch.serve.registry import ModelRegistry

        mon = DriftMonitor(column_configs, threshold=0.2, min_rows=64)
        reg = ModelRegistry(os.path.join(model_set, "models"), drift=mon,
                            device="cpu")
        reg.warm([1, 16])
        assert mon.verdict()["rows"] == 0
        assert reg.drift_live  # restored for real traffic
        reg.score_raw(_training_raw(model_set))
        assert mon.verdict()["rows"] > 0

    @pytest.mark.parametrize("with_drift", [False, True])
    def test_program_price_near_the_op_level_count(
            self, model_set, column_configs, with_drift):
        """The zoo's price of a bucket (`program_bytes`, counted from the
        torch calls of its first call) against every aten op's new
        result in the same call: at most the op-level bytes (temporaries
        inside one call are not seen), and within 5% of them."""
        from torch.utils._python_dispatch import TorchDispatchMode

        from shifu_tpu_torch.loop.drift import DriftMonitor
        from shifu_tpu_torch.serve.registry import ModelRegistry, _block

        class OpLevel(TorchDispatchMode):
            nbytes = 0

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                flat = [t for t in (list(args) + list((kwargs or {})
                                                      .values()))
                        if isinstance(t, torch.Tensor)]
                seen = {t.untyped_storage().data_ptr() for t in flat}
                outs = out if isinstance(out, (tuple, list)) else [out]
                for t in outs:
                    if isinstance(t, torch.Tensor) \
                            and t.untyped_storage().data_ptr() not in seen:
                        self.nbytes += _block(t.untyped_storage().nbytes())
                return out

        mon = (DriftMonitor(column_configs, threshold=0.2, min_rows=64)
               if with_drift else None)
        reg = ModelRegistry(os.path.join(model_set, "models"), drift=mon,
                            device="cpu")
        reg.warm([1, 64])
        for bucket in (8, 64):
            st = reg._staging[bucket]
            args = (reg._drift_window()[0],) if with_drift else ()
            with torch.inference_mode(), OpLevel() as ops:
                reg._program(st.host, *args)
            price = reg.program_bytes(bucket)
            assert 0.95 * ops.nbytes <= price <= ops.nbytes, bucket

    def test_column_with_mismatched_counts_not_monitored(
            self, column_configs):
        import copy

        from shifu_tpu_torch.loop.drift import DriftMonitor

        ccs = copy.deepcopy(column_configs)
        victim = next(c for c in ccs
                      if c.column_binning.bin_boundary
                      and c.column_binning.bin_count_pos)
        victim.column_binning.bin_count_pos = [1, 2]  # wrong arity
        victim.column_binning.bin_count_neg = [1, 2]
        mon = DriftMonitor(ccs, threshold=0.2, min_rows=1)
        assert victim.column_name not in [c.name for c in mon.cols]


# ---------------------------------------------------------------------------
# hot-swap + shadow scoring
# ---------------------------------------------------------------------------


def _perturbed_candidate(model_set, tmp_path, delta=1e-3):
    """A candidate dir whose single NN model differs slightly (new sha,
    near-identical scores)."""
    from shifu_tpu_torch.models.nn import NNModelSpec

    cand = str(tmp_path / "candidate")
    os.makedirs(cand, exist_ok=True)
    spec = NNModelSpec.load(os.path.join(model_set, "models", "model0.nn"))
    spec.params[-1]["b"] = np.asarray(spec.params[-1]["b"]) + delta
    spec.save(os.path.join(cand, "model0.nn"))
    return cand


class TestHotSwap:
    def test_stage_shadow_agree_promote(self, model_set, tmp_path):
        from shifu_tpu_torch.loop.hotswap import SwappableRegistry
        from shifu_tpu_torch.serve.registry import ModelRegistry

        with _Props(shifu_loop_shadowSample="1.0"):
            sw = SwappableRegistry(
                ModelRegistry(os.path.join(model_set, "models"), device="cpu"))
            old_sha = sw.sha
            cand = _perturbed_candidate(model_set, tmp_path)
            staged = sw.stage(cand)
            assert staged["sha"] != old_sha
            raw = _training_raw(model_set)
            res = sw.score_raw(raw)
            sw.observe(raw, res)
            snap = sw.shadow_snapshot()
            assert snap["rows"] == raw.n_rows
            assert snap["errors"] == 0
            # +1e-3 on the output bias: full agreement at tolerance 5.0
            assert snap["agreement"] == 1.0
            assert snap["maxAbsDelta"] < 5.0
            out = sw.promote()
            assert out["from"] == old_sha and out["to"] == staged["sha"]
            assert sw.sha == staged["sha"]
            assert sw.shadow_snapshot() is None

    def test_promote_without_stage_raises(self, model_set):
        from shifu_tpu_torch.loop.hotswap import SwappableRegistry
        from shifu_tpu_torch.serve.registry import ModelRegistry

        sw = SwappableRegistry(
            ModelRegistry(os.path.join(model_set, "models"), device="cpu"))
        with pytest.raises(ValueError):
            sw.promote()

    def test_stage_rejects_schema_change(self, model_set, tmp_path):
        from shifu_tpu_torch.loop.hotswap import SwappableRegistry
        from shifu_tpu_torch.models.nn import NNModelSpec
        from shifu_tpu_torch.serve.registry import ModelRegistry

        spec = NNModelSpec.load(
            os.path.join(model_set, "models", "model0.nn"))
        spec.norm_specs = spec.norm_specs[:-1]  # drop an input column
        spec.layer_sizes = list(spec.layer_sizes)
        cand = str(tmp_path / "bad_candidate")
        os.makedirs(cand)
        spec.save(os.path.join(cand, "model0.nn"))
        sw = SwappableRegistry(
            ModelRegistry(os.path.join(model_set, "models"), device="cpu"))
        with pytest.raises(ValueError, match="schema"):
            sw.stage(cand)

    def test_swap_under_load_loses_nothing(self, model_set, tmp_path):
        """The acceptance pin: concurrent scoring across a hot-swap —
        every request answered exactly once, per-version counters account
        for every row, both versions served."""
        from shifu_tpu_torch.loop.hotswap import SwappableRegistry
        from shifu_tpu_torch.serve.queue import AdmissionQueue
        from shifu_tpu_torch.serve.registry import ModelRegistry
        from shifu_tpu_torch.serve.server import Scorer

        before = _snapshot_counters()
        with _Props(shifu_loop_shadowSample="1.0"):
            sw = SwappableRegistry(
                ModelRegistry(os.path.join(model_set, "models"), device="cpu"))
            old_sha = sw.sha
            cand = _perturbed_candidate(model_set, tmp_path)
            scorer = Scorer(sw, AdmissionQueue(256), max_wait_ms=1.0)
            names = list(sw.input_columns)
            rec = {c: "0.5" for c in names}
            n_threads, per_thread, rows_per = 4, 30, 3
            errors = []
            answered = [0] * n_threads
            swapped = threading.Event()

            def client(ti):
                for _ in range(per_thread):
                    try:
                        res = scorer.score_batch([rec] * rows_per,
                                                 timeout=30.0)
                        assert len(res.mean) == rows_per
                        answered[ti] += rows_per
                    except Exception as e:  # noqa: BLE001
                        errors.append(e)

            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(n_threads)]
            for t in threads:
                t.start()
            # stage + promote mid-flight
            sw.stage(cand)
            swapped.set()
            out = sw.promote()
            for t in threads:
                t.join(60)
            scorer.close()
            assert not errors, errors[:3]
            total = n_threads * per_thread * rows_per
            assert sum(answered) == total
            after = _snapshot_counters()
            per_version = _counter_delta(before, after,
                                         "serve.version.records")
            assert sum(per_version.values()) == total, per_version
            # the swap happened mid-load: the new version answered the
            # tail (the old may have answered everything before the swap
            # on a fast promote, so only the new sha is REQUIRED)
            assert any(out["to"] in k for k in per_version), per_version

    def test_scored_sha_survives_a_promote(self, model_set, tmp_path):
        """The observer attributes a batch to the version that SCORED it:
        a promote landing between the score and the observe must not
        re-stamp the batch with the new sha."""
        from shifu_tpu_torch.loop.hotswap import SwappableRegistry
        from shifu_tpu_torch.serve.registry import ModelRegistry

        sw = SwappableRegistry(
            ModelRegistry(os.path.join(model_set, "models"), device="cpu"))
        old_sha = sw.sha
        sw.score_raw(_training_raw(model_set))
        sw.stage(_perturbed_candidate(model_set, tmp_path))
        sw.promote()
        assert sw.sha != old_sha          # the NEXT batch is the new set
        assert sw.scored_sha == old_sha   # the last batch stays the old

    def test_shadow_delta_binning_matches_observe(self):
        """The vectorized add_binned path (ShadowStats.note) lands every
        observation in the same bucket a per-value observe() would —
        including exact bucket edges and the +inf overflow."""
        from shifu_tpu_torch.loop.hotswap import SCORE_DELTA_BUCKETS
        from shifu_tpu_torch.obs.metrics import Histogram

        d = np.abs(np.asarray([0.0, 0.4, 0.5, 0.7, 3.0, -2.0, 1e6],
                              dtype=np.float64))
        bulk = Histogram(buckets=SCORE_DELTA_BUCKETS)
        binned = np.bincount(
            np.searchsorted(np.asarray(bulk.buckets), d, side="left"),
            minlength=len(bulk.buckets))
        bulk.add_binned(binned.tolist(), float(d.sum()), int(d.size),
                        float(d.min()), float(d.max()))
        ref = Histogram(buckets=SCORE_DELTA_BUCKETS)
        for v in d:
            ref.observe(float(v))
        got, want = bulk.as_dict(), ref.as_dict()
        assert got["counts"] == want["counts"]
        assert got["count"] == want["count"]
        assert got["sum"] == pytest.approx(want["sum"])
        assert (got["min"], got["max"]) == (want["min"], want["max"])

    def test_nan_shadow_delta_is_disagreement_not_crash(self):
        """A candidate emitting NaN scores must show up as disagreement
        in the gate evidence — not kill the observer pass."""
        from shifu_tpu_torch.loop.hotswap import ShadowStats

        stats = ShadowStats(tolerance=0.5)
        stats.note(np.asarray([0.1, np.nan, 0.2, np.inf]))
        snap = stats.snapshot()
        assert snap["rows"] == 4
        assert snap["agreement"] == pytest.approx(0.5)  # NaN/inf disagree
        assert snap["maxAbsDelta"] == np.inf

    def test_shadow_sample_zero_disables_shadow_scoring(
            self, model_set, tmp_path):
        """shadowSample=0 means OFF (like the traffic log's sample<=0),
        not one-batch-in-a-million."""
        from shifu_tpu_torch.loop.hotswap import SwappableRegistry
        from shifu_tpu_torch.serve.registry import ModelRegistry

        with _Props(shifu_loop_shadowSample="0"):
            sw = SwappableRegistry(
                ModelRegistry(os.path.join(model_set, "models"), device="cpu"))
            sw.stage(_perturbed_candidate(model_set, tmp_path))
            raw = _training_raw(model_set)
            res = sw.score_raw(raw)
            sw.observe(raw, res)
            assert sw.shadow_snapshot()["rows"] == 0

    def test_promote_bound_to_expected_sha(self, model_set, tmp_path):
        """promote(expected_sha) refuses a shadow that is not the
        candidate the gate evidence described."""
        from shifu_tpu_torch.loop.hotswap import SwappableRegistry
        from shifu_tpu_torch.serve.registry import ModelRegistry

        sw = SwappableRegistry(
            ModelRegistry(os.path.join(model_set, "models"), device="cpu"))
        cand = _perturbed_candidate(model_set, tmp_path)
        staged = sw.stage(cand)
        with pytest.raises(ValueError, match="re-staged"):
            sw.promote(expected_sha="0" * 16)
        assert sw.shadow_snapshot() is not None  # still staged
        out = sw.promote(expected_sha=staged["sha"])
        assert out["to"] == staged["sha"]

    def test_shadow_error_contained(self, model_set, tmp_path):
        from shifu_tpu_torch.loop.hotswap import SwappableRegistry
        from shifu_tpu_torch.serve.registry import ModelRegistry

        with _Props(shifu_loop_shadowSample="1.0"):
            sw = SwappableRegistry(
                ModelRegistry(os.path.join(model_set, "models"), device="cpu"))
            cand = _perturbed_candidate(model_set, tmp_path)
            sw.stage(cand)
            sw._shadow.score_raw = None  # simulate a candidate crash
            raw = _training_raw(model_set)
            res = sw.score_raw(raw)  # live path unaffected
            sw.observe(raw, res)     # shadow failure contained
            snap = sw.shadow_snapshot()
            assert snap["errors"] == 1
            assert len(res.mean) == raw.n_rows


# ---------------------------------------------------------------------------
# promote gates
# ---------------------------------------------------------------------------


class TestPromoteGates:
    def _shadow(self, **kw):
        base = {"sha": "c" * 16, "rows": 500, "errors": 0,
                "agreement": 0.99, "tolerance": 5.0}
        base.update(kw)
        return base

    def _rec(self):
        return {"recommendation": {
            "action": "retrain", "modelSetSha": "a" * 16,
            "drift": {"driftedColumns": ["num_0"], "maxPsi": 0.31}}}

    def test_all_gates_pass(self):
        from shifu_tpu_torch.loop.promote import evaluate_gates

        d = evaluate_gates(self._shadow(), self._rec(),
                           agree_min=0.95, min_rows=64)
        assert d["promote"] is True
        assert d["gates"]["shadow"]["ok"] and d["gates"]["drift"]["ok"]
        assert d["gates"]["drift"]["recommendation"]["maxPsi"] == 0.31

    @pytest.mark.parametrize("shadow,why", [
        (None, "no shadow stats"),
        ({"rows": 10, "errors": 0, "agreement": 1.0}, "10 shadow rows"),
        ({"rows": 500, "errors": 2, "agreement": 1.0}, "errored"),
        ({"rows": 500, "errors": 0, "agreement": 0.5}, "agreement"),
    ])
    def test_shadow_gate_failures(self, shadow, why):
        from shifu_tpu_torch.loop.promote import evaluate_gates

        d = evaluate_gates(shadow, self._rec(),
                           agree_min=0.95, min_rows=64)
        assert d["promote"] is False
        assert why in d["gates"]["shadow"]["reason"]

    def test_shadow_gate_rejects_foreign_evidence(self):
        """Agreement earned by a previously staged candidate must not
        green-light a different one."""
        from shifu_tpu_torch.loop.promote import evaluate_gates

        d = evaluate_gates(self._shadow(), self._rec(),
                           agree_min=0.95, min_rows=64,
                           candidate_sha="d" * 16)
        assert d["promote"] is False
        assert "not the candidate" in d["gates"]["shadow"]["reason"]
        # matching sha (or unknown candidate sha): evidence accepted
        ok = evaluate_gates(self._shadow(), self._rec(),
                            agree_min=0.95, min_rows=64,
                            candidate_sha="c" * 16)
        assert ok["promote"] is True

    def test_drift_gate_rejects_stale_recommendation(self):
        """A recommendation stamped against an older active sha was
        already acted on — it must not justify rollouts forever."""
        from shifu_tpu_torch.loop.promote import evaluate_gates

        d = evaluate_gates(self._shadow(), self._rec(),
                           agree_min=0.95, min_rows=64,
                           active_sha="b" * 16)  # rec targets "a"*16
        assert d["promote"] is False
        assert "already acted on" in d["gates"]["drift"]["reason"]
        ok = evaluate_gates(self._shadow(), self._rec(),
                            agree_min=0.95, min_rows=64,
                            active_sha="a" * 16)
        assert ok["promote"] is True

    def test_drift_gate_blocks_without_recommendation(self):
        from shifu_tpu_torch.loop.promote import evaluate_gates

        d = evaluate_gates(self._shadow(), None,
                           agree_min=0.95, min_rows=64)
        assert d["promote"] is False
        assert "no retrain recommendation" in d["gates"]["drift"]["reason"]
        d2 = evaluate_gates(self._shadow(), None, agree_min=0.95,
                            min_rows=64, require_drift=False)
        assert d2["promote"] is True

    def test_offline_swap_is_recoverable(self, tmp_path):
        from shifu_tpu_torch.loop.promote import offline_swap

        root = str(tmp_path)
        os.makedirs(os.path.join(root, "models"))
        open(os.path.join(root, "models", "model0.nn"), "w").write("old")
        cand = os.path.join(root, "models.candidate")
        os.makedirs(cand)
        open(os.path.join(cand, "model0.nn"), "w").write("new")
        out = offline_swap(root, cand)
        assert open(os.path.join(root, "models", "model0.nn")).read() \
            == "new"
        assert open(os.path.join(
            root, "models.previous", "model0.nn")).read() == "old"
        assert out["models"].endswith("models")

    def test_run_promote_writes_manifest_and_exit_codes(self, tmp_path):
        from shifu_tpu_torch.loop.promote import run_promote

        root = str(tmp_path)
        # no shadow stats, no recommendation -> held (exit 1) + manifest
        assert run_promote(root, None) == 1
        (p,) = glob.glob(os.path.join(root, ".shifu/runs/promote-*.json"))
        m = json.load(open(p))["promote"]
        assert m["decision"]["promote"] is False
        assert not m["decision"]["gates"]["shadow"]["ok"]




# ---------------------------------------------------------------------------
# drift: the port's fold against the JAX fold
# ---------------------------------------------------------------------------


def _jax_monitor(model_set):
    from shifu_tpu.config import load_column_config_list as jload
    from shifu_tpu.loop.drift import DriftMonitor as JDrift

    return JDrift(jload(os.path.join(model_set, "ColumnConfig.json")),
                  threshold=0.2, min_rows=64)


@pytest.mark.parametrize("shift", [None, 31])
def test_window_counts_equal_the_jax_fold(model_set, column_configs, shift):
    """The same featurized batch (the port's featurize; the JAX featurize
    can hit ROADMAP C.1 here) through the port's device fold and the JAX
    `traced_fold`: equal window counts; through each package's PSI: equal
    within 1e-12. Where the JAX `fold_host` runs, its counts too."""
    import jax.numpy as jnp

    from shifu_tpu.stats.psi import psi_from_counts as jpsi
    from shifu_tpu_torch.loop.drift import DriftMonitor

    if shift is None:
        data = _training_raw(model_set)
    else:
        data = _raw_batch(*_shifted_rows(shift))
    mon = DriftMonitor(column_configs, threshold=0.2, min_rows=64)
    jmon = _jax_monitor(model_set)
    assert [(c.name, c.kind, c.offset, c.n_slots) for c in mon.cols] == [
        (c.name, c.kind, c.offset, c.n_slots) for c in jmon.cols]
    vals, codes = mon.featurize(data)
    n = data.n_rows
    valid = np.ones(n, np.float32)
    valid[-3:] = 0.0  # padding rows fold nothing
    want = np.asarray(jmon.traced_fold(
        jmon.device_consts(), jnp.zeros(jmon.total_slots, jnp.float32),
        jnp.asarray(vals), jnp.asarray(codes), jnp.asarray(valid)))
    got = mon.fold(mon.device_consts("cpu"),
                   torch.zeros(mon.total_slots), torch.as_tensor(vals),
                   torch.as_tensor(codes).long(),
                   torch.as_tensor(valid)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.sum() == (n - 3) * len(mon.cols)
    mon.note_window(torch.as_tensor(got), n - 3)
    counts = mon.counts()
    for c in mon.cols:
        sl = counts[c.offset:c.offset + c.n_slots]
        assert abs(mon.psi_by_column()[c.name]
                   - jpsi(c.expected, sl)) <= 1e-12
    try:
        jmon.fold_host(data)
    except ValueError as e:  # ROADMAP C.1: the JAX parse writes into a
        assert "read-only" in str(e)  # read-only pandas buffer
    else:
        host = DriftMonitor(column_configs, threshold=0.2, min_rows=64)
        host.fold_host(data)
        np.testing.assert_array_equal(host.counts(), jmon._host)


def test_fold_drops_out_of_range_ids_and_clips_codes(column_configs):
    """Codes past a coded column's slots clip to its missing slot (as the
    JAX fold clips), non-finite values go to the missing slot, and the
    window stays f32 and exact."""
    from shifu_tpu_torch.loop.drift import DriftMonitor

    mon = DriftMonitor(column_configs, threshold=0.2, min_rows=1)
    n = 5
    vals = torch.tensor([[np.nan, np.inf, -np.inf, 1e30, -1e30]] * len(
        mon.numeric_cols), dtype=torch.float32).T.contiguous()
    codes = torch.tensor([[-5, 0, 999, 1, 10 ** 6]] * len(
        mon.coded_cols)).T.contiguous()
    out = mon.fold(mon.device_consts(), torch.zeros(mon.total_slots),
                   vals, codes, torch.ones(n))
    assert out.dtype == torch.float32 and float(out.sum()) == n * len(
        mon.cols)
    for k, c in enumerate(mon.numeric_cols):
        sl = out[c.offset:c.offset + c.n_slots]
        assert float(sl[-1]) == 3.0  # nan, +inf, -inf: missing
        assert float(sl[0]) == 1.0 and float(sl[-2]) == 1.0
    for c in mon.coded_cols:
        sl = out[c.offset:c.offset + c.n_slots]
        assert float(sl[0]) >= 2.0 and float(sl[-1]) >= 2.0


# ---------------------------------------------------------------------------
# the server: drift by default, the traffic log, /admin/*, promote
# ---------------------------------------------------------------------------


def _http(url, doc=None, timeout=30.0):
    data = None if doc is None else json.dumps(doc).encode()
    req = urllib.request.Request(
        url, data=data, headers={"Content-Type": "application/json"},
        method="GET" if doc is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _wait(pred, timeout=20.0):
    import time

    end = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < end, "timed out"
        time.sleep(0.02)


def _serve_root(model_set, tmp_path):
    root = str(tmp_path / "serve")
    shutil.copytree(model_set, root,
                    ignore=shutil.ignore_patterns(".shifu", "tmp"))
    return root


def test_server_folds_drift_logs_traffic_and_promotes(model_set, tmp_path):
    """One port server on a model set with ColumnConfig: the drift fold
    rides every batch by default; unshifted requests stay ok, shifted
    ones past driftMinRows degrade /healthz and write ONE recommendation;
    the traffic log reads back every row sent; /admin/stage, /admin/shadow
    and `shifu promote --serve-url` swap in the candidate (its scores
    after), clear the degrade and reset the monitor."""
    from shifu_tpu_torch.loop.promote import run_promote
    from shifu_tpu_torch.loop.traffic import traffic_source
    from shifu_tpu_torch.serve.server import ScoringServer

    root = _serve_root(model_set, tmp_path)
    cand = _perturbed_candidate(model_set, tmp_path)
    with _Props(shifu_loop_logSample="1.0", shifu_loop_logChunkRows="64",
                shifu_loop_driftMinRows="200",
                shifu_loop_driftCheckBatches="1",
                shifu_loop_shadowSample="1.0"):
        srv = ScoringServer(root=root, port=0, replicas=1, device="cpu")
        srv.start()
        base = f"http://127.0.0.1:{srv.port}"
        try:
            assert srv.drift is not None and srv.traffic is not None
            old_sha = srv.registry.sha
            assert srv.registry.snapshot()["driftMonitored"] == len(
                srv.drift.cols)
            data = _training_raw(model_set)
            cols = srv.registry.input_columns
            recs = [{c: str(data.column(c)[i]) for c in cols}
                    for i in range(200)]
            sent = 0
            for a in range(0, 200, 40):
                code, _doc = _http(f"{base}/score",
                                   {"records": recs[a:a + 40]})
                assert code == 200
                sent += 40
            _wait(lambda: srv._observed_batches == 5)
            code, health = _http(f"{base}/healthz")
            assert health["status"] == "ok"
            assert health["drift"]["status"] == "ok"
            names, rows = _shifted_rows(41)
            shifted = [dict(zip(names, r)) for r in rows[:200]]
            for a in range(0, 200, 40):
                code, _doc = _http(f"{base}/score",
                                   {"records": shifted[a:a + 40]})
                assert code == 200
                sent += 40
            _wait(lambda: srv._observed_batches == 10)
            code, health = _http(f"{base}/healthz")
            assert health["status"] == "degraded"
            assert "num_0" in health["drift"]["driftedColumns"]
            assert "psi drift" in health["reason"]
            recs_path = glob.glob(os.path.join(
                root, ".shifu/runs/recommend-*.json"))
            assert len(recs_path) == 1
            # the window counts are a host fold of the same rows
            host = type(srv.drift)(srv.column_configs, min_rows=1)
            host.fold_host(_raw_batch(cols, [[r.get(c) for c in cols]
                                             for r in recs]))
            host.fold_host(_raw_batch(names, rows[:200]))
            np.testing.assert_array_equal(srv.drift.counts(), host.counts())
            # stage, shadow evidence, promote through the CLI's entry
            code, doc = _http(f"{base}/admin/stage", {"modelsDir": cand})
            assert code == 200 and doc["staged"]["rows"] == 0
            for a in range(0, 120, 40):
                assert _http(f"{base}/score",
                             {"records": recs[a:a + 40]})[0] == 200
                sent += 40
            # the observer runs after a batch's answers: wait for it
            _wait(lambda: _http(f"{base}/admin/shadow")[1]["shadow"][
                "rows"] == 120)
            code, doc = _http(f"{base}/admin/shadow")
            assert doc["shadow"]["rows"] == 120
            assert doc["shadow"]["agreement"] == 1.0
            assert run_promote(root, cand, serve_url=base) == 0
            code, health = _http(f"{base}/healthz")
            assert health["status"] == "ok" and "drift" not in health
            assert srv.registry.sha == doc["shadow"]["sha"]
            assert srv.drift.verdict()["rows"] == 0
            code, got = _http(f"{base}/score", {"records": recs[:16]})
            sent += 16
        finally:
            srv.shutdown(10)
    from shifu_tpu_torch.serve.registry import ModelRegistry

    want = ModelRegistry(cand, device="cpu").score_records(recs[:16])
    np.testing.assert_allclose([s["mean"] for s in got["scores"]],
                               want.mean, atol=2e-3)
    factory, tnames = traffic_source(root)
    chunks = list(factory())
    assert sum(c.n_rows for c in chunks) == sent
    shas = np.concatenate([c.column("shifu_model_sha") for c in chunks])
    assert set(shas) == {old_sha, doc["shadow"]["sha"]}
    assert list(shas).count(doc["shadow"]["sha"]) == 16
    from shifu_tpu_torch.obs.ledger import list_runs

    (manifest,) = list_runs(root, step="serve")
    assert manifest["traffic"]["chunks"] >= 1
    assert manifest["drift"]["rows"] == 16
    (p,) = glob.glob(os.path.join(root, ".shifu/runs/promote-*.json"))
    pm = json.load(open(p))["promote"]
    assert pm["mode"] == "http" and pm["decision"]["promote"] is True
    assert glob.glob(os.path.join(root, ".shifu/runs/swap-*.json"))


def test_promote_refuses_sets_and_stale_shas(model_set, tmp_path):
    from shifu_tpu_torch.serve.server import ScoringServer

    root = _serve_root(model_set, tmp_path)
    cand = _perturbed_candidate(model_set, tmp_path)
    srv = ScoringServer(root=root, port=0, replicas=2, device="cpu").start()
    base = f"http://127.0.0.1:{srv.port}"
    try:
        assert _http(f"{base}/admin/shadow") == (
            200, {"active": srv.registry.sha, "shadow": None})
        assert _http(f"{base}/admin/shadow?set=a")[0] == 409
        assert _http(f"{base}/admin/stage",
                     {"modelsDir": cand, "set": "a"})[0] == 409
        code, doc = _http(f"{base}/admin/stage", {"modelsDir": cand})
        assert code == 200 and len(doc["staged"]["replicas"]) == 2
        code, doc = _http(f"{base}/admin/promote", {"sha": "0" * 16})
        assert code == 409 and "re-staged" in doc["error"]
        code, doc = _http(f"{base}/admin/promote",
                          {"sha": srv.registry.shadow_snapshot()["sha"]})
        assert code == 200 and doc["replicas"] == 2
        assert len(glob.glob(os.path.join(root,
                                          ".shifu/runs/swap-*.json"))) == 2
    finally:
        srv.shutdown(10)


def test_run_promote_offline_modes_and_lease_dir(model_set, tmp_path):
    """Offline: the gates read the newest serve manifest's shadow and the
    newest recommendation; a pass swaps models/ (exit 0), --force is
    recorded. A lease directory: live leases make it a fleet round (a
    fenced peer that never acks aborts it at the deadline: held, exit 1,
    nothing touched); `--serve-url` with two live leases exits 2 (one
    process of a fleet); a torn or expired lease is no peer."""
    from shifu_tpu_torch.loop.promote import run_promote
    from shifu_tpu_torch.obs.ledger import RunLedger
    from shifu_tpu_torch import obs
    from shifu_tpu_torch.serve.registry import (find_model_paths,
                                                model_set_sha)

    root = _serve_root(model_set, tmp_path)
    cand = _perturbed_candidate(model_set, tmp_path)
    cand_sha = model_set_sha(find_model_paths(cand))
    active = model_set_sha(find_model_paths(os.path.join(root, "models")))
    ledger = RunLedger(root)
    ledger.write("serve", 1, status="ok", exit_status=0, started_at=1.0,
                 elapsed_seconds=0.0, argv=[], registry=obs.registry(),
                 extra={"serve": {"shadow": {
                     "sha": cand_sha, "rows": 500, "errors": 0,
                     "agreement": 1.0}}})
    assert run_promote(root, cand) == 1  # no recommendation: held
    ledger.write("recommend", 1, status="ok", exit_status=0,
                 started_at=2.0, elapsed_seconds=0.0, argv=[],
                 registry=obs.registry(),
                 extra={"recommendation": {"modelSetSha": active,
                                           "drift": {"maxPsi": 0.4}}})
    peers = os.path.join(root, ".shifu", "runs", "peers")
    os.makedirs(peers)
    import time

    def write_lease(lid, ttl_ms=300.0, age_s=0.0):
        path = os.path.join(peers, f"{lid}.lease.json")
        with open(path, "w") as fh:
            json.dump({"schema": "shifu.lease/1", "leaseId": lid,
                       "host": "h", "pid": 1, "token": "t", "epoch": 1,
                       "ttlMs": ttl_ms, "renewedAt": time.time() - age_s,
                       "info": {}}, fh)
        return path

    leases = [write_lease("h-1-x", ttl_ms=60_000.0),
              write_lease("h-2-y", ttl_ms=60_000.0)]
    assert run_promote(root, cand, serve_url="http://127.0.0.1:9") == 2
    for path in leases:
        os.remove(path)
    # a live peer that never acks: the round aborts at its deadline
    leases = [write_lease("h-3-z", ttl_ms=300.0)]
    assert run_promote(root, cand) == 1
    assert os.path.isdir(cand)
    held = sorted((p for p in glob.glob(os.path.join(
        root, ".shifu/runs/promote-*.json")) if ".traces." not in p),
        key=lambda p: int(p.rsplit("-", 1)[1].split(".")[0]))
    doc = json.load(open(held[-1]))["promote"]
    assert doc["mode"] == "fleet" and not doc["round"]["committed"]
    assert "no ack" in doc["round"]["reason"]
    os.remove(leases[0])
    # torn and long-expired lease files are no peers: offline again
    open(os.path.join(peers, "h-4-w.lease.json"), "w").write("{}")
    write_lease("h-5-v", ttl_ms=100.0, age_s=60.0)
    assert run_promote(root, cand) == 0
    assert model_set_sha(find_model_paths(
        os.path.join(root, "models"))) == cand_sha
    assert os.path.isdir(os.path.join(root, "models.previous"))
    # (the fleet round leaves its trace spans beside its manifest)
    runs = sorted((p for p in glob.glob(os.path.join(
        root, ".shifu/runs/promote-*.json")) if ".traces." not in p),
        key=lambda p: int(p.rsplit("-", 1)[1].split(".")[0]))
    docs = [json.load(open(p)) for p in runs]
    assert [d["exitStatus"] for d in docs] == [1, 1, 0]
    assert docs[2]["promote"]["mode"] == "offline"
    assert run_promote(root, None, force=True) == 2  # forced, no candidate
    assert run_promote(root, None, set_name="a") == 2


def test_cli_serve_traffic_log_and_promote_cli(model_set, tmp_path):
    """`python -m shifu_tpu_torch serve --traffic-log 0.5` (a subprocess):
    half-sampled rows land in chunks the log reads back, SIGTERM drains
    and flushes them; then `python -m shifu_tpu_torch promote` offline,
    held by the drift gate (exit 1), forced past it (exit 0)."""
    import signal
    import subprocess
    import sys

    from shifu_tpu_torch import cli
    from shifu_tpu_torch.loop.traffic import log_meta, traffic_source

    root = _serve_root(model_set, tmp_path)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "shifu_tpu_torch", "serve", "--device", "cpu",
         "--port", "0", "--traffic-log", "0.5",
         "-Dshifu.loop.logChunkRows=16"],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("listening on 127.0.0.1:"), (
            line + proc.stderr.read())
        port = int(line.split(":")[1].split()[0])
        data = _training_raw(model_set)
        cols = [c for c in data.names if c != "diagnosis"]
        for a in range(0, 80, 20):
            recs = [{c: str(data.column(c)[i]) for c in cols}
                    for i in range(a, a + 20)]
            assert _http(f"http://127.0.0.1:{port}/score",
                         {"records": recs})[0] == 200
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
    meta, chunks = log_meta(root)
    assert meta["sample"] == 0.5 and chunks
    factory, names = traffic_source(root)
    rows = sum(c.n_rows for c in factory())
    assert 0 < rows < 80
    assert names[-4:] == ["shifu_score_mean", "shifu_model_sha",
                          "shifu_trace", "shifu_ts"]
    cand = _perturbed_candidate(model_set, tmp_path)
    cwd = os.getcwd()
    try:
        os.chdir(root)
        assert cli.main(["promote", "--candidate", cand]) == 1
        assert cli.main(["promote", "--candidate", cand, "--force"]) == 0
    finally:
        os.chdir(cwd)
    assert os.path.isdir(os.path.join(root, "models.previous"))

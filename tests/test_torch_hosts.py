"""The port's multi-host lifecycle (`HostPlan`, `parallel/hostsync.py`,
the divergence stamps, the per-host checkpoint families, and init /
stats / norm / eval split over hosts) against the JAX package's and
against one host, on the CPU.

Hosts are threads with explicit `host_plan=` (the knobs are
process-global, and a sequential schedule deadlocks on the barrier), as
the JAX package's own tests run them. Contracts:
  * the plans, the part exchange and the stamps: exact;
  * on integral data (integer values, unit weights, categories of
    distinct frequencies), 2 hosts write ColumnConfig.json,
    count_info.json, NormalizedData and CleanedData byte-identical to 1
    host: every sum is exact, so the merge order moves nothing;
  * the port's 2-host ColumnConfig.json against the JAX package's 2-host
    run: byte-identical, as the streamed stats parity test holds one
    host on integral data (the JAX side at one lifecycle shard).
"""

import contextlib
import io
import json
import os
import pickle
import shutil
import threading

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from shifu_tpu.analysis import sanitize as jsanitize  # noqa: E402
from shifu_tpu.data.pipeline import HostPlan as JHostPlan  # noqa: E402
from shifu_tpu.data.pipeline import ShardPlan as JShardPlan  # noqa: E402
from shifu_tpu.processor.stats import StatsProcessor as JStatsProcessor  # noqa: E402
from shifu_tpu.utils import environment as jenv  # noqa: E402
from shifu_tpu_torch.analysis import sanitize  # noqa: E402
from shifu_tpu_torch.data.pipeline import HostPlan, ShardPlan  # noqa: E402
from shifu_tpu_torch.parallel import hostsync  # noqa: E402
from shifu_tpu_torch.processor.evaluate import EvalProcessor  # noqa: E402
from shifu_tpu_torch.processor.init import InitProcessor  # noqa: E402
from shifu_tpu_torch.processor.norm import NormProcessor  # noqa: E402
from shifu_tpu_torch.processor.stats import StatsProcessor  # noqa: E402
from shifu_tpu_torch.resilience import checkpoint as ckpt_mod  # noqa: E402
from shifu_tpu_torch.utils import environment as penv  # noqa: E402
from tests.helpers import make_model_set, write_dataset  # noqa: E402
from tests.test_torch_config import jax_inline_ingest  # noqa: E402
from tests.test_torch_obs import counts, host_counts, obs_scope  # noqa: E402

ROWS = 1200
CHUNK = 100  # 12 chunks: 6 a host
STREAM = {"shifu.ingest.forceStreaming": "true",
          "shifu.ingest.chunkRows": str(CHUNK),
          "shifu.lifecycle.shards": "1",
          "shifu.lifecycle.hostWaitMs": "60000"}


@contextlib.contextmanager
def props(envs=(penv,), **kv):
    """Properties set in each of `envs` for a block, then cleared."""
    for env in envs:
        for k, v in kv.items():
            env.set_property(k, v)
    try:
        yield
    finally:
        for env in envs:
            for k in kv:
                env._props.pop(k, None)


def run_hosts(fn, n_hosts=2, timeout=300):
    """fn(host_index) once a host on concurrent threads; the first
    failure re-raised with its host."""
    errs = {}

    def run(h):
        try:
            fn(h)
        except Exception as e:  # re-raised below with the host attached
            errs[h] = e

    ts = [threading.Thread(target=run, args=(h,), daemon=True)
          for h in range(n_hosts)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=timeout)
    assert not any(t.is_alive() for t in ts), "host thread hung"
    if errs:
        h = min(errs)
        raise AssertionError(f"host {h} failed: {errs[h]!r}") from errs[h]


def _distinct_freq(rng, n, tokens):
    """n tokens whose counts all differ (no tie can reorder the bins
    across merge orders): weights 2^k, shuffled."""
    w = np.array([2.0 ** k for k in range(len(tokens), 0, -1)])
    counts = np.floor(n * w / w.sum()).astype(int)
    counts[0] += n - counts.sum()
    vals = np.repeat(np.arange(len(tokens)), counts)
    rng.shuffle(vals)
    return [tokens[v] for v in vals]


def make_host_set(root, n_rows=ROWS, seed=21, algorithm="RF"):
    """Integral data: a P/N target, 4 integer columns with missing
    tokens, 2 categoricals of distinct frequencies, unit weights."""
    rng = np.random.default_rng(seed)
    names = ["y"] + [f"n{j}" for j in range(4)] + ["c0", "c1"]
    y = rng.random(n_rows) < 0.4
    c0 = _distinct_freq(rng, n_rows, ["aa", "bb", "cc", "dd"])
    c1 = _distinct_freq(rng, n_rows, ["k0", "k1", "k2", "k3", "k4"])
    rows = []
    for i in range(n_rows):
        r = ["P" if y[i] else "N"]
        for j in range(4):
            r.append("?" if rng.random() < 0.02 else
                     str(int(rng.integers(0, 30) + 3 * y[i] * (j % 2))))
        r += [c0[i], c1[i]]
        rows.append(r)
    make_model_set(root, n_rows=40, algorithm=algorithm)
    data_path, header_path = write_dataset(os.path.join(root, "hostdata"),
                                           names, rows)
    path = os.path.join(root, "ModelConfig.json")
    mc = json.load(open(path))
    ds = mc["dataSet"]
    ds.update(dataPath=data_path, headerPath=header_path,
              targetColumnName="y", posTags=["P"], negTags=["N"])
    mc["evals"] = [dict(mc["evals"][0], dataSet=dict(
        mc["evals"][0]["dataSet"], dataPath=data_path,
        headerPath=header_path, dataDelimiter="|"))] if mc.get(
            "evals") else []
    with open(path, "w") as fh:
        json.dump(mc, fh, indent=2)
    return root


def _bytes(root, rel):
    with open(os.path.join(root, rel), "rb") as fh:
        return fh.read()


def _tree(d):
    return {f: _bytes(d, f) for f in sorted(os.listdir(d))}


@pytest.fixture(scope="module")
def inited(tmp_path_factory):
    """The integral set after a one-host port init."""
    root = make_host_set(str(tmp_path_factory.mktemp("hosts") / "src"))
    assert InitProcessor(root, device="cpu").run() == 0
    return root


# ---- plans -----------------------------------------------------------------

@pytest.mark.parametrize("H, h", [(1, 0), (2, 0), (2, 1), (3, 2)])
def test_host_plan_matches_jax(H, h):
    p, j = HostPlan(H, h), JHostPlan(n_hosts=H, host_index=h)
    K = 17
    for f in ("host_of", "owns", "local_index"):
        assert [getattr(p, f)(c) for c in range(K)] == \
            [getattr(j, f)(c) for c in range(K)]
    assert (p.active, p.is_merge_host) == (j.active, j.is_merge_host)
    owned = [c for c in range(K) if p.owns(c)]
    assert len(owned) <= -(-K // H)
    assert [p.local_index(c) for c in owned] == list(range(len(owned)))
    for bad in (H, -1):
        with pytest.raises(ValueError):
            HostPlan(H, bad)
        with pytest.raises(ValueError):
            JHostPlan(n_hosts=H, host_index=bad)


def test_host_plan_knobs_and_counters():
    with props(**{"shifu.lifecycle.hosts": "4",
                  "shifu.lifecycle.hostIndex": "2"}):
        hp = HostPlan()
    assert (hp.n_hosts, hp.host_index) == (4, 2)
    assert (HostPlan().n_hosts, HostPlan().host_index) == (1, 0)
    with obs_scope():
        hp.record(10, "norm")
        hp.record(5, "norm")
        assert host_counts("host.chunks", "norm") == {"2": 2}
        assert host_counts("host.rows", "norm") == {"2": 15}


@pytest.mark.parametrize("S", [1, 2, 4])
def test_shard_plan_with_host_matches_jax(S):
    K = 24
    items = [(c, c * 3) for c in range(K)]
    for h in range(2):
        p = ShardPlan(S, host=HostPlan(2, h))
        j = JShardPlan(S, host=JHostPlan(n_hosts=2, host_index=h))
        assert [p.shard_of(c) for c in range(K)] == \
            [j.shard_of(c) for c in range(K)]
        cursors = [c * 5 - 1 for c in range(S)]
        assert list(p.resume_slice(items, cursors)) == \
            list(j.resume_slice(items, cursors))
        per_shard = [sum(1 for c in range(K) if p.host.owns(c)
                         and p.shard_of(c) == s) for s in range(S)]
        assert sum(per_shard) == K // 2
        assert max(per_shard) <= -(-(K // 2) // S)


# ---- the part exchange -----------------------------------------------------

def test_publish_await_in_host_order(tmp_path):
    root, sha = str(tmp_path), "cafe" * 10
    with obs_scope():
        for h in (1, 0):  # published out of order on purpose
            hostsync.publish_part(
                root, "stats-pass1", HostPlan(2, h), sha,
                arrays={"acc": np.full(3, h, np.float64)},
                meta={"nRows": 10 + h}, blob=pickle.dumps({"host": h}))
        parts = hostsync.await_parts(root, "stats-pass1", HostPlan(2, 0),
                                     sha, timeout_ms=5000)
        assert counts("host.parts_published", "host") == {"0": 1, "1": 1}
        assert counts("host.parts_merged", "step") == {"stats-pass1": 2}
    assert [p[1]["nRows"] for p in parts] == [10, 11]
    assert [int(p[0]["acc"][0]) for p in parts] == [0, 1]
    assert [pickle.loads(p[2])["host"] for p in parts] == [0, 1]
    assert hostsync.part_path(root, "s", 3).endswith(
        os.path.join(".shifu", "runs", "hosts", "s", "part-h003.npz"))


def test_await_ignores_foreign_sha_and_times_out(tmp_path):
    root = str(tmp_path)
    hostsync.publish_part(root, "norm", HostPlan(2, 1), "old-sha",
                          arrays={"x": np.zeros(1)})
    # another host count is foreign too
    hostsync.publish_part(root, "norm", HostPlan(3, 0), "new-sha",
                          arrays={"x": np.zeros(1)})
    with pytest.raises(TimeoutError) as ei:
        hostsync.await_parts(root, "norm", HostPlan(2, 0), "new-sha",
                             timeout_ms=200, poll_s=0.01)
    assert "[0, 1]" in str(ei.value) and "hostWaitMs" in str(ei.value)
    with props(**{"shifu.lifecycle.hostWaitMs": "150"}):
        assert hostsync.host_wait_ms_setting() == 150.0
        with pytest.raises(TimeoutError, match="150ms"):
            hostsync.await_parts(root, "norm", HostPlan(2, 0), "new-sha",
                                 poll_s=0.01)
    assert hostsync.host_wait_ms_setting() == hostsync.DEFAULT_WAIT_MS


def test_clear_part_removes_only_own(tmp_path):
    root = str(tmp_path)
    for h in (0, 1):
        hostsync.publish_part(root, "s", HostPlan(2, h), "sha",
                              arrays={"x": np.zeros(1)})
    hostsync.clear_part(root, "s", HostPlan(2, 0))
    hostsync.clear_part(root, "s", HostPlan(2, 0))  # twice: a no-op
    assert not os.path.exists(hostsync.part_path(root, "s", 0))
    assert os.path.exists(hostsync.part_path(root, "s", 1))


# ---- the divergence stamps ---------------------------------------------------

def _header(path):
    with np.load(path) as z:
        return json.loads(bytes(z[hostsync.META_KEY].tobytes()).decode())


def test_divergence_stamp_equal_in_both_packages():
    san, jsan = sanitize.Sanitizer(["divergence"]), \
        jsanitize.Sanitizer(["divergence"])
    for step, h, keys in (("stats-pass1", 0, ["nValid", "nPos"]),
                          ("stats-pass1", 0, ["nValid", "nPos"]),
                          ("norm", 1, ["featParts", "nRows"])):
        got = san.barrier_stamp(step, h, "feed" * 10, keys)
        want = jsan.barrier_stamp(step, h, "feed" * 10, keys)
        assert got == want
    assert san.barrier_stamp("x", 0, "a", ["k"]) != \
        san.barrier_stamp("x", 0, "b", ["k"])


def test_armed_two_host_merge_is_clean_and_stamped(tmp_path):
    root, sha = str(tmp_path), "feed" * 10
    san = sanitize.Sanitizer(["divergence"])

    def host(h):
        plan = HostPlan(2, h)
        hostsync.publish_part(root, "stats", plan, sha,
                              arrays={"acc": np.full(3, h, np.float64)},
                              meta={"nRows": 10 + h})
        parts = hostsync.await_parts(root, "stats", plan, sha,
                                     timeout_ms=60000)
        assert [p[1]["nRows"] for p in parts] == [10, 11]

    with sanitize.activate(san):
        run_hosts(host)
    v = san.verdict()
    assert v["clean"] is True
    assert v["divergence"]["stampsPublished"] == 2
    assert v["divergence"]["barriersChecked"] == 2
    h0 = _header(hostsync.part_path(root, "stats", 0))["sanitize"]
    h1 = _header(hostsync.part_path(root, "stats", 1))["sanitize"]
    assert h0 == h1 and h0["seq"] == 1
    # unarmed: no stamp
    hostsync.publish_part(root, "u", HostPlan(1, 0), sha)
    assert "sanitize" not in _header(hostsync.part_path(root, "u", 0))


def test_corrupted_peer_digest_refuses_merge(tmp_path):
    root, sha = str(tmp_path), "dead" * 10
    san = sanitize.Sanitizer(["divergence"])
    with sanitize.activate(san):
        for h in (0, 1):
            hostsync.publish_part(root, "stats", HostPlan(2, h), sha,
                                  arrays={"acc": np.full(3, h, np.float64)})
        path = hostsync.part_path(root, "stats", 1)
        with np.load(path) as z:
            payload = {k: z[k] for k in z.files}
        header = json.loads(
            bytes(payload[hostsync.META_KEY].tobytes()).decode())
        header["sanitize"]["digest"] = "deadbeefdeadbeef"
        payload[hostsync.META_KEY] = np.frombuffer(
            json.dumps(header, sort_keys=True).encode("utf-8"),
            dtype=np.uint8)
        buf = io.BytesIO()
        np.savez(buf, **payload)
        with open(path, "wb") as fh:
            fh.write(buf.getvalue())
        with pytest.raises(sanitize.DivergenceError,
                           match="host 1 diverged from host 0 — "
                                 "digest mismatch"):
            hostsync.await_parts(root, "stats", HostPlan(2, 0), sha,
                                 timeout_ms=5000)
    v = san.verdict()
    assert v["clean"] is False and v["divergence"]["trips"] == 1
    assert v["events"][0]["stage"] == "stats"


# ---- the per-host checkpoint families ----------------------------------------

def _family(base, **kw):
    return ckpt_mod.ShardedStreamCheckpoint(base, "sha" * 12, n_shards=2,
                                            every=1, **kw)


def _save(ck):
    ck.save([(s, {"c": np.arange(3)}, None, None) for s in range(2)],
            (None, None, None))


def test_host_count_change_rejects_family(tmp_path):
    base = str(tmp_path / "stream")
    _save(_family(base, n_hosts=2, host_index=0))
    assert _family(base, n_hosts=2, host_index=0).load() is not None
    # the same file names (host 0 of 3) but the chunk -> host
    # assignment moved: the whole family is rejected
    assert _family(base, n_hosts=3, host_index=0).load() is None


def test_per_host_families_disjoint_and_legacy_named_at_one_host(tmp_path):
    import glob

    base = str(tmp_path / "stream")
    for h in (0, 1):
        _save(_family(base, n_hosts=2, host_index=h))
    h0 = sorted(glob.glob(base + "-h000-*"))
    h1 = sorted(glob.glob(base + "-h001-*"))
    assert h0 and h1 and not set(h0) & set(h1)
    for h in (0, 1):
        cursors, _per, shared = _family(base, n_hosts=2,
                                        host_index=h).load()
        assert cursors == [0, 1] and shared[1]["host"] == h
    # a multi-host clear stays in its own family
    _family(base, n_hosts=2, host_index=0).clear()
    assert not glob.glob(base + "-h000-*") and glob.glob(base + "-h001-*")
    # one host keeps the un-prefixed names, and its clear sweeps the
    # per-host families an earlier fleet left
    solo = str(tmp_path / "solo")
    _save(_family(solo))
    assert glob.glob(solo + "-shard*") and not glob.glob(solo + "-h0*")
    _save(_family(solo, n_hosts=2, host_index=1))
    _family(solo).clear()
    assert not glob.glob(solo + "*")
    # the multi-host shard files carry the stamp the JAX family does
    z = np.load(str(tmp_path / "stream-h001-shard00000-b.ckpt.npz"))
    head = json.loads(bytes(z["__meta__"].tobytes()).decode())
    assert {"hosts": 2, "host": 1, "shards": 2}.items() <= \
        head["meta"].items()


# ---- two hosts against one, and against the JAX package ----------------------

def _copy(src, dst):
    shutil.copytree(src, dst)
    return dst


def test_init_autotype_two_hosts_byte_identical(tmp_path):
    one = make_host_set(str(tmp_path / "one"))
    two = make_host_set(str(tmp_path / "two"))
    with props(**STREAM):
        assert InitProcessor(one, device="cpu").run() == 0
        plans = [HostPlan(2, h) for h in range(2)]
        with obs_scope():
            run_hosts(lambda h: InitProcessor(
                two, device="cpu", host_plan=plans[h]).run())
            chunks = host_counts("host.chunks", "init.autotype")
    for rel in ("ColumnConfig.json",
                os.path.join("tmp", "autotype", "count_info.json")):
        assert _bytes(one, rel) == _bytes(two, rel), rel
    # each host folded its own 6 chunks
    assert chunks == {"0": 6, "1": 6}


@pytest.fixture(scope="module")
def stats_pair(inited, tmp_path_factory):
    """Streamed stats on one host and on two: (one root, two root, the
    two hosts' obs counters, their processors)."""
    base = tmp_path_factory.mktemp("stats_pair")
    one = _copy(inited, str(base / "one"))
    two = _copy(inited, str(base / "two"))
    plans = [HostPlan(2, h) for h in range(2)]
    with props(**STREAM):
        proc = StatsProcessor(one, device="cpu")
        assert proc.run() == 0
        procs = [StatsProcessor(two, device="cpu", host_plan=plans[h])
                 for h in range(2)]
        with obs_scope() as reg:
            run_hosts(lambda h: procs[h].run())
            snap = reg.snapshot()
    return one, two, snap, procs


def test_stats_two_hosts_byte_identical(stats_pair):
    one, two, snap, procs = stats_pair
    assert _bytes(one, "ColumnConfig.json") == \
        _bytes(two, "ColumnConfig.json")
    for stage in ("stats.pass1", "stats.pass2"):
        per_host = host_counts("host.chunks", stage, snap)
        assert per_host == {"0": 6, "1": 6}, stage
    rows = sum(host_counts("host.rows", "stats.pass2", snap).values())
    assert rows == ROWS
    assert all({"barrier1", "barrier2"} <= set(p.timings) for p in procs)
    # the run cleared its checkpoint families; the parts stay
    assert ckpt_mod.list_resumable(two) == []
    assert sorted(os.listdir(os.path.join(two, hostsync.HOSTS_SUBDIR))) \
        == ["stats-pass1", "stats-pass2"]


def test_stats_two_hosts_match_jax_two_hosts(inited, stats_pair,
                                              tmp_path):
    two = stats_pair[1]
    jroot = _copy(inited, str(tmp_path / "jax"))
    with props((jenv,), **STREAM), jax_inline_ingest():
        run_hosts(lambda h: JStatsProcessor(
            jroot, host_plan=JHostPlan(n_hosts=2, host_index=h)).run())
    assert _bytes(jroot, "ColumnConfig.json") == \
        _bytes(two, "ColumnConfig.json")


def test_norm_two_hosts_byte_identical(stats_pair, tmp_path):
    one = _copy(stats_pair[0], str(tmp_path / "one"))
    two = _copy(stats_pair[0], str(tmp_path / "two"))
    plans = [HostPlan(2, h) for h in range(2)]
    with props(**STREAM):
        assert NormProcessor(one, device="cpu").run() == 0
        with obs_scope():
            run_hosts(lambda h: NormProcessor(
                two, device="cpu", host_plan=plans[h]).run())
            chunks = host_counts("host.chunks", "norm")
    for sub in ("NormalizedData", "CleanedData"):
        d = os.path.join("tmp", "norm", sub)
        a, b = _tree(os.path.join(one, d)), _tree(os.path.join(two, d))
        assert list(a) == list(b) and a == b, sub
        assert not any(f.startswith(".part-") for f in b)
    assert chunks == {"0": 6, "1": 6}


def test_eval_runs_on_the_merge_host_only(stats_pair, tmp_path):
    root = _copy(stats_pair[0], str(tmp_path / "ev"))
    assert EvalProcessor(root, run_name="", device="cpu",
                         host_plan=HostPlan(2, 1)).run() == 0
    assert not os.path.exists(os.path.join(root, "evals"))


def test_paths_that_cannot_merge_raise(inited, tmp_path):
    from shifu_tpu_torch.config.model_config import ModelConfig
    from shifu_tpu_torch.stats.engine import compute_stats_streaming

    mc = ModelConfig.load(os.path.join(inited, "ModelConfig.json"))
    with pytest.raises(ValueError, match="checkpoint_root"):
        compute_stats_streaming(mc, [], lambda: iter(()),
                                torch.device("cpu"),
                                host_plan=HostPlan(2, 0))

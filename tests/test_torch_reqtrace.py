"""The port's request traces (`shifu_tpu_torch/obs/reqtrace.py`), the
metrics time series, the server's `/metrics` and `/admin/traces`, and the
`trace` / `top` / `runs` CLIs, against the JAX package.

* `RequestTrace` and `TraceBuffer`: the same stages give the same
  summaries, the head-sampling stride and the slow-tail capture are the
  JAX ones, the ring is bounded (`serve.trace.dropped`), and a trace file
  the port writes is one the JAX `load_trace_file` reads, with the same
  Chrome-trace events; `stitch_trace_files` and the table/detail text
  equal the JAX functions'.
* `MetricsSnapshotter`: the windows the port writes reconstruct the
  registry's snapshots, and the JAX reader reconstructs the same ones.
* The port's server: `/metrics` is the registry's Prometheus text with
  the request counter equal to the requests sent, `/admin/traces` holds a
  request sent with `X-Shifu-Trace`, and the shutdown writes the serve
  manifest and its trace file.
* `shifu trace`, `shifu runs --traces` and `shifu top --once` print what
  the JAX CLI prints over the same files (`top` over a live port server,
  read back as JSON).
"""

import json
import os
import threading
import urllib.request

import numpy as np
import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

from shifu_tpu.obs import reqtrace as jrt  # noqa: E402
from shifu_tpu.obs import timeseries as jts  # noqa: E402
from shifu_tpu_torch.obs import reqtrace as rt  # noqa: E402
from shifu_tpu_torch.obs import timeseries as ts  # noqa: E402
from shifu_tpu_torch.obs.metrics import MetricsRegistry  # noqa: E402
from tests.test_torch_obs import counts, obs_scope  # noqa: E402


def _trace(mod, tid, stages, attrs):
    t = mod.RequestTrace(trace_id=tid, sampled=True)
    t._t0 = 100.0
    t.started_unix = 1_700_000_000.0
    for stage, off, dur in stages:
        t.add_stage(stage, dur, t0=100.0 + off)
    t.annotate(**attrs)
    t.total_seconds = sum(d for _s, _o, d in stages) + 0.001
    return t


STAGES = [("featurize", 0.0, 0.002), ("featurize", 0.002, 0.001),
          ("queue", 0.003, 0.0005), ("coalesce", 0.0035, 0.0001),
          ("device", 0.0036, 0.004), ("d2h", 0.0076, 0.0002),
          ("serialize", 0.0078, 0.0003)]


def _buffers(n=6, capacity=4):
    """The same offered traces in each package's buffer."""
    out = []
    for mod in (rt, jrt):
        buf = mod.TraceBuffer(capacity=capacity, sample=1.0, slow_ms=0)
        for i in range(n):
            stages = [(s, o, d * (i + 1)) for s, o, d in STAGES]
            buf.offer(_trace(mod, f"t{i}", stages,
                             {"replica": str(i % 2), "rows": i}))
        buf.note_batch("0", ["t4", "t5"], requests=2, rows=9,
                       started_unix=1_700_000_000.5, dur_s=0.004)
        out.append(buf)
    return out


def test_summaries_ring_and_chrome_events_equal_jax():
    p, j = _buffers()
    assert p.traces() == j.traces()
    snap_p, snap_j = p.snapshot(), j.snapshot()
    assert snap_p == snap_j and snap_p["dropped"] == 2
    assert p.slowest(3, stage="device") == j.slowest(3, stage="device")

    def strip(doc):
        return [{k: v for k, v in e.items() if k != "pid"}
                for e in doc["traceEvents"]]

    assert strip(p.to_chrome_trace()) == strip(j.to_chrome_trace())
    assert rt.format_trace_table(p.traces()) == \
        jrt.format_trace_table(j.traces())
    assert rt.format_trace_detail(p.traces()[0], path="x.json") == \
        jrt.format_trace_detail(j.traces()[0], path="x.json")


def test_head_sampling_slow_capture_and_drop_counter():
    buf = rt.TraceBuffer(capacity=100, sample=0.25, slow_ms=0)
    jbuf = jrt.TraceBuffer(capacity=100, sample=0.25, slow_ms=0)
    assert [buf.head_sampled() for _ in range(100)] == \
        [jbuf.head_sampled() for _ in range(100)]
    slow_only = rt.TraceBuffer(capacity=10, sample=0.0, slow_ms=5.0)
    fast, slow = rt.RequestTrace(), rt.RequestTrace()
    fast.total_seconds, slow.total_seconds = 0.001, 0.05
    assert slow_only.offer(fast) is False
    assert slow_only.offer(slow) is True
    assert slow_only.get(slow.trace_id)["id"] == slow.trace_id
    assert rt.clean_trace_id('evil"id\nwith|stuff') == \
        jrt.clean_trace_id('evil"id\nwith|stuff') == "evil_id_with_stuff"
    assert len({rt.new_trace_id() for _ in range(500)}) == 500
    with obs_scope():
        ring = rt.TraceBuffer(capacity=2, sample=1.0, slow_ms=0)
        for _ in range(5):
            t = rt.RequestTrace(sampled=True)
            t.total_seconds = 0.001
            ring.offer(t)
        assert counts("serve.trace.dropped", None) == {"": 3}


def test_trace_files_read_by_jax_and_stitched_alike(tmp_path):
    p, j = _buffers()
    runs = tmp_path / ".shifu" / "runs"
    pa = p.write_traces(str(runs / "serve-1.traces.json"))
    jb = j.write_traces(str(runs / "serve-2.traces.json"))
    doc = jrt.load_trace_file(pa)
    assert doc["shifuTraces"] == p.traces()
    assert doc["summary"] == p.snapshot()
    assert rt.trace_files(str(tmp_path)) == jrt.trace_files(str(tmp_path))
    sp = rt.stitch_trace_files([pa, jb], str(tmp_path / "a.json"))
    sj = jrt.stitch_trace_files([pa, jb], str(tmp_path / "b.json"))
    for s in (sp, sj):
        for src in s["summary"]["sources"]:
            src.pop("path")
    assert sp == sj


def test_capture_stages_fan_out_on_one_thread():
    with rt.capture_stages() as cap:
        rt.note_stage("device", 0.25, t0=1.0)
        rt.note_attr(sha="abc")
    assert cap.stages == [("device", 0.25, 1.0)]
    assert cap.attrs == {"sha": "abc"}
    rt.note_stage("device", 1.0)  # no capture open: a no-op
    with rt.capture_stages(enabled=False) as none:
        assert none is None


def test_snapshotter_windows_reconstruct_and_jax_reads_them(tmp_path):
    reg = MetricsRegistry()
    snap = ts.MetricsSnapshotter(str(tmp_path), "host-1-solo",
                                 registry_cb=lambda: reg, snapshot_ms=1e6,
                                 chunk_windows=3, retain_chunks=2)
    wants = []
    for i in range(10):
        reg.counter("serve.requests", format="json").inc(i + 1)
        reg.gauge("g").set(i)
        reg.histogram("h", buckets=(0.1, 1.0)).observe(0.05 * i)
        reg.series("s").append(i, i * 0.5)
        snap.tick()
        wants.append(reg.snapshot())
    got = ts.read_windows(str(tmp_path), "host-1-solo")
    jgot = jts.read_windows(str(tmp_path), "host-1-solo")
    assert [w["metrics"] for w in got] == [w["metrics"] for w in jgot]
    assert got[-1]["metrics"] == wants[-1]
    # a rotation every 3 windows retires all but the 2 newest chunks
    assert [os.path.basename(c) for c in
            ts.list_chunks(str(tmp_path), "host-1-solo")] == \
        ["obs-00002.json", "obs-00003.json", "obs-00004.json"]
    assert len(got) == 7
    assert ts.last_snapshot(str(tmp_path), "host-1-solo")["metrics"] == \
        wants[-1]
    w = ts.encode_window(wants[0], wants[1], 5.0)
    assert w == jts.encode_window(wants[0], wants[1], 5.0)
    assert ts.apply_window(wants[0], w) == wants[1]


# ---- the server and the CLIs ---------------------------------------------------------

N_REQUESTS = 5
TRACE_ID = "smoke-trace-1"


def _post(url, recs, headers=None):
    req = urllib.request.Request(
        url, data=json.dumps({"records": recs}).encode("utf-8"),
        headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.headers.get(rt.TRACE_HEADER), json.loads(r.read())


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A port server on a model set: N requests, one with X-Shifu-Trace;
    /metrics, /admin/traces and `top --once --json` read live; then a
    clean shutdown (manifest + trace file)."""
    from shifu_tpu_torch import obs
    from shifu_tpu_torch.serve.server import ScoringServer
    from tests.test_torch_serve import records, write_model_set

    root = write_model_set(str(tmp_path_factory.mktemp("served")))
    obs.reset()
    srv = ScoringServer(root=root, port=0, replicas=1, max_wait_ms=1,
                        device="cpu").start()
    base = f"http://127.0.0.1:{srv.port}"
    out = {"root": root}
    try:
        echoed = [_post(f"{base}/score", records(3, seed=i),
                        {rt.TRACE_HEADER: TRACE_ID} if i == 2 else None)
                  for i in range(N_REQUESTS)]
        out["echoed"] = echoed
        with urllib.request.urlopen(f"{base}/metrics", timeout=10) as r:
            out["metrics_ctype"] = r.headers["Content-Type"]
            out["metrics"] = r.read().decode("utf-8")
        with urllib.request.urlopen(f"{base}/admin/traces",
                                    timeout=10) as r:
            out["traces"] = json.loads(r.read())
        from shifu_tpu_torch.obs.top import fetch_view, render_frame

        payload, samples = fetch_view(base)
        out["frame"] = render_frame(payload, samples, qps=None)
        out["top_rc"], out["top_json"] = _top_once_json(base)
    finally:
        out["shutdown"] = srv.shutdown(10)
    out["manifest"] = srv.manifest_path
    return out


def _top_once_json(base):
    import contextlib
    import io

    from shifu_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["top", "--once", "--json", "--url", base])
    return rc, json.loads(buf.getvalue())


def test_metrics_count_the_requests_sent(served):
    from shifu_tpu_torch.obs.metrics import parse_prometheus

    assert served["metrics_ctype"].startswith("text/plain")
    samples = parse_prometheus(served["metrics"])
    n = sum(v for k, v in samples.items()
            if k.startswith("serve_requests_total"))
    assert n == N_REQUESTS
    assert any(k.startswith("serve_stage_seconds_bucket")
               for k in samples)
    hdr, doc = served["echoed"][2]
    assert hdr == TRACE_ID and doc["trace"] == TRACE_ID


def test_admin_traces_holds_the_traced_request(served):
    doc = served["traces"]
    ids = [t["id"] for t in doc["traces"]]
    assert TRACE_ID in ids
    (t,) = [t for t in doc["traces"] if t["id"] == TRACE_ID]
    for stage in ("featurize", "route", "queue", "coalesce", "device",
                  "d2h", "serialize"):
        assert stage in t["stages"], stage
    assert t["attrs"]["replica"] == "0"


def test_top_renders_and_parses_the_live_server(served):
    assert served["top_rc"] == 0
    payload = served["top_json"]
    assert payload["liveProcesses"] == 1
    assert payload["stages"]["device"]["count"] >= 1
    assert "requests" in served["frame"]


def test_shutdown_writes_the_manifest_and_trace_file(served):
    with open(served["manifest"]) as fh:
        m = json.load(fh)
    assert m["step"] == "serve" and m["status"] == "ok"
    assert m["traces"]["count"] >= 1
    assert os.path.isfile(os.path.join(served["root"],
                                       m["traces"]["path"]))
    programs = m["profile"]["programs"]
    assert programs["serve.fused_score"]["synced"] is True
    assert programs["serve.fused_score"]["dispatches"] >= N_REQUESTS


@pytest.mark.parametrize("argv", [
    ["trace"], ["trace", "--json"], ["trace", "--slowest", "2"],
    ["trace", "--slowest", "3", "--stage", "device"],
    ["trace", "--show", TRACE_ID], ["trace", "--show", "nope"],
    ["trace", "--fleet"], ["runs", "--traces"], ["runs", "--step", "serve"],
])
def test_cli_prints_the_jax_text(served, argv, monkeypatch, capsys):
    from shifu_tpu import cli as jcli
    from shifu_tpu_torch import cli

    monkeypatch.chdir(served["root"])
    rc = cli.main(list(argv))
    port_out = capsys.readouterr().out
    jrc = jcli.main(list(argv))
    assert (rc, port_out) == (jrc, capsys.readouterr().out)
    if argv == ["trace"]:
        assert TRACE_ID in port_out


def test_serving_request_stages_under_scorer(served):
    """The in-process Scorer path makes and finishes its own trace:
    stage histograms and the SLO without HTTP."""
    from shifu_tpu_torch.serve.server import Scorer

    class _Reg:
        input_columns = ["a"]

        def score_raw(self, data):
            from shifu_tpu_torch.eval.scorer import ScoreResult

            z = np.zeros(data.n_rows, np.float32)
            return ScoreResult(model_scores=z[:, None], mean=z, max=z,
                               min=z, median=z, model_names=["m"],
                               model_widths=[1])

    with obs_scope():
        sc = Scorer(_Reg(), max_wait_ms=0.5)
        try:
            done = threading.Event()

            def go():
                sc.score_batch([{"a": "1"}], timeout=10)
                done.set()

            threading.Thread(target=go).start()
            assert done.wait(20)
        finally:
            sc.close(10)
        assert counts("serve.requests", "format") == {"json": 1}
        assert sum(counts("serve.router.routed", "replica").values()) == 1


def test_fleet_score_rows_per_replica_equal_jax(tmp_path):
    """`serve.score.rows` is one series a replica in both packages: the
    same rows scored on each replica's registry give the same Prometheus
    lines."""
    from shifu_tpu import obs as jobs
    from shifu_tpu.serve.fleet import ReplicaFleet as JFleet
    from shifu_tpu_torch import obs
    from shifu_tpu_torch.serve.fleet import ReplicaFleet
    from tests.test_torch_serve import write_model_set
    from tests.test_torch_serve_registry import parity_records

    models = os.path.join(write_model_set(str(tmp_path)), "models")

    def rows_lines(text):
        return sorted(line for line in text.splitlines()
                      if line.startswith("serve_score_rows"))

    got = {}
    for name, build, kw, mod in (
            ("port", ReplicaFleet.build, {"device": "cpu"}, obs),
            ("jax", JFleet.build, {}, jobs)):
        mod.reset()
        fleet = build(models, n_replicas=2, **kw)
        try:
            for i, n in ((0, 3), (1, 5), (1, 2)):
                reg = fleet.replicas[i].registry
                reg.score_records(parity_records(reg.input_columns, n=n,
                                                 tokens=False))
            got[name] = rows_lines(mod.registry().to_prometheus())
        finally:
            fleet.close(10)
    assert got["port"] == got["jax"]
    assert [line.split(" ")[0] for line in got["port"]] == [
        'serve_score_rows_total{replica="0"}',
        'serve_score_rows_total{replica="1"}']

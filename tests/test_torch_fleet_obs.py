"""The port's fleet metrics federation (`obs/fleetview.py`), its per-tenant
SLO settings and `shifu top` over the fleet views, against the JAX
package's tests/test_fleet_obs.py.

Held against the JAX package: `fleetview.merge` of the same samples
renders the same Prometheus text, byte for byte, in either fold order,
and `slo_summary` gives the same document; `collect` reads an expired
peer's last counters from its on-disk time series; `render_frame` draws
the same frame. The two-server cases start port servers on the CPU and
close them in their `finally`, so no lease thread outlives a test.
"""

import json
import os
import time
import urllib.request

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from shifu_tpu.obs import fleetview as jfleetview  # noqa: E402
from shifu_tpu.obs import top as jtop  # noqa: E402
from shifu_tpu.obs.metrics import MetricsRegistry as JRegistry  # noqa: E402
from shifu_tpu.utils import environment as jenv  # noqa: E402
from shifu_tpu_torch.obs import fleetview, timeseries, top  # noqa: E402
from shifu_tpu_torch.obs.metrics import (  # noqa: E402
    MetricsRegistry,
    parse_prometheus,
)
from shifu_tpu_torch.resilience import lease  # noqa: E402
from shifu_tpu_torch.serve import health  # noqa: E402
from shifu_tpu_torch.utils import environment  # noqa: E402


class _Props:
    """Set properties in both packages' environments."""

    def __init__(self, **props):
        self.props = props

    def __enter__(self):
        for k, v in self.props.items():
            environment.set_property(k, v)
            jenv.set_property(k, v)
        return self

    def __exit__(self, *exc):
        for k in self.props:
            environment.set_property(k, "")
            jenv.set_property(k, "")


def _fill(reg, requests, queue_depth, stage_ms, tenant_slo=None):
    reg.counter("serve.requests", format="json", replica="0").inc(requests)
    reg.gauge("serve.queue.depth", tenant="t1", replica="0") \
        .set(queue_depth)
    reg.timer("serve.batch_seconds", replica="0").add(0.25, 3)
    h = reg.histogram("serve.stage_seconds", stage="device", replica="0")
    for ms in stage_ms:
        h.observe(ms / 1e3)
    for tenant, (good, bad) in (tenant_slo or {}).items():
        reg.counter("serve.slo.good", tenant=tenant).inc(good)
        reg.counter("serve.slo.bad", tenant=tenant).inc(bad)
    return reg


def _samples(registry_cls):
    """Three processes' samples (one expired, one unreadable live one) in
    one package's registry type."""
    a = _fill(registry_cls(), 3, 2, [10, 20], {"quiet": (99, 1)})
    b = _fill(registry_cls(), 4, 5, [30], {"ant": (10, 90)})
    b.gauge("serve.breaker.open", replica="0").set(1.0)
    c = _fill(registry_cls(), 9, 7, [45], {"quiet": (5, 0)})

    def sample(lid, reg, live=True):
        return {"leaseId": lid, "live": live, "source": "test",
                "metrics": None if reg is None else reg.snapshot(),
                "info": {}, "ageMs": 0.0}

    return [sample("proc-b", b), sample("proc-a", a),
            sample("proc-c", c, live=False), sample("proc-d", None)]


def test_merge_renders_the_jax_prometheus_text_byte_for_byte():
    got = fleetview.merge(_samples(MetricsRegistry)).to_prometheus()
    want = jfleetview.merge(_samples(JRegistry)).to_prometheus()
    assert got == want
    # any process answering renders the same text: the fold is sorted
    rev = fleetview.merge(list(reversed(_samples(MetricsRegistry))))
    assert rev.to_prometheus() == got
    flat = fleetview.merge(_samples(MetricsRegistry)).snapshot()
    assert flat["counters"][
        'serve.requests{format="json",replica="0"}'] == 16.0
    assert flat["counters"]["fleet.collect.errors"] == 1.0  # proc-d
    assert not any("proc-c" in k for k in flat["gauges"])  # expired
    assert flat["gauges"][
        'serve.queue.depth{agg="sum",replica="0",tenant="t1"}'] == 7.0


def test_slo_summary_matches_jax():
    with _Props(**{"shifu.serve.sloTarget": "0.99",
                   "shifu.serve.slo.ant.target": "0.5"}):
        got = fleetview.slo_summary(fleetview.merge(
            _samples(MetricsRegistry)))
        want = jfleetview.slo_summary(jfleetview.merge(
            _samples(JRegistry)))
    assert got == want
    ant, quiet = got["tenants"]["ant"], got["tenants"]["quiet"]
    assert ant["target"] == 0.5
    assert ant["burn"] == pytest.approx(0.9 / 0.5)
    # the expired proc-c keeps its counters: 1 bad of 105
    assert quiet["burn"] == pytest.approx(1 / 105 / 0.01, abs=1e-4)
    reg = fleetview.merge(_samples(MetricsRegistry))
    jreg = jfleetview.merge(_samples(JRegistry))
    assert fleetview.stage_quantiles(reg) == \
        jfleetview.stage_quantiles(jreg)


def test_tenant_slo_settings_fall_back_to_fleet_wide():
    with _Props(**{"shifu.serve.sloMs": "50",
                   "shifu.serve.sloTarget": "0.99"}):
        assert health.tenant_slo_ms("t9") == 50.0
        assert health.tenant_slo_target("t9") == 0.99
        with _Props(**{"shifu.serve.slo.t9.ms": "250",
                       "shifu.serve.slo.t9.target": "0.5"}):
            assert health.tenant_slo_ms("t9") == 250.0
            assert health.tenant_slo_target("t9") == 0.5
            assert health.tenant_slo_ms("other") == 50.0
            # a tenant's tracker resolves its own settings first, and
            # its series carry the tenant label
            t = health.SloTracker(labels={"tenant": "t9"})
            assert (t.slo_ms, t.target) == (250.0, 0.5)
            assert health.SloTracker().slo_ms == 50.0


def test_collect_reads_expired_peer_from_disk(tmp_path):
    root = str(tmp_path)
    reg = MetricsRegistry()
    reg.counter("serve.slo.bad", tenant="a").inc(4)
    snap = timeseries.MetricsSnapshotter(
        root, "dead-1", lambda: reg, snapshot_ms=10_000,
        chunk_windows=4, retain_chunks=2)
    snap.tick()
    os.makedirs(lease.peers_dir(root), exist_ok=True)
    with open(os.path.join(lease.peers_dir(root),
                           "dead-1" + lease.LEASE_SUFFIX), "w") as fh:
        json.dump({"schema": "shifu.lease/1", "leaseId": "dead-1",
                   "host": "h", "pid": 1, "token": "tok", "epoch": 1,
                   "ttlMs": 100.0, "renewedAt": time.time() - 60.0,
                   "info": {}}, fh)
    samples = fleetview.collect(root, self_id="me",
                                self_snapshot=MetricsRegistry().snapshot)
    by_id = {s["leaseId"]: s for s in samples}
    assert by_id["me"]["live"] and by_id["me"]["source"] == "local"
    dead = by_id["dead-1"]
    assert not dead["live"] and dead["source"] == "disk"
    assert dead["metrics"]["counters"]['serve.slo.bad{tenant="a"}'] == 4.0
    # the JAX collector reads the port's windows and lease alike
    jsamples = jfleetview.collect(root, self_id="me",
                                  self_snapshot=JRegistry().snapshot)
    assert [(s["leaseId"], s["live"], s["source"]) for s in jsamples] == \
        [(s["leaseId"], s["live"], s["source"]) for s in samples]


def test_render_frame_matches_jax():
    def payload(mod, reg):
        with _Props(**{"shifu.serve.sloTarget": "0.99"}):
            slo = mod.slo_summary(reg)
        return {
            "liveProcesses": 2, "expiredProcesses": 1,
            "answeredBy": "proc-a", "slo": slo,
            "stages": mod.stage_quantiles(reg),
            "processes": [
                {"leaseId": "proc-a", "live": True, "source": "local",
                 "ageMs": 12.0, "info": {"status": "serving"}},
                {"leaseId": "proc-c", "live": False, "source": "disk",
                 "ageMs": 99000.0, "info": {}},
            ],
        }

    reg = fleetview.merge(_samples(MetricsRegistry))
    jreg = jfleetview.merge(_samples(JRegistry))
    samples = parse_prometheus(reg.to_prometheus())
    frame = top.render_frame(payload(fleetview, reg), samples, qps=12.5)
    jframe = jtop.render_frame(payload(jfleetview, jreg), samples,
                               qps=12.5)
    assert frame == jframe
    assert "2 live / 1 expired" in frame and "1/1 OPEN" in frame
    assert top.total_requests(samples) == 16.0


# ---------------------------------------------------------------------------
# the fleet routes of two servers on one root
# ---------------------------------------------------------------------------


def _write_set(root):
    from shifu_tpu_torch.models.nn import NNModelSpec, init_params

    cols = [f"c{i}" for i in range(4)]
    sizes = [len(cols), 3, 1]
    specs = [{"name": c, "kind": "value", "outNames": [c], "mean": 0.0,
              "std": 1.0, "fill": 0.0, "zscore": True} for c in cols]
    models = os.path.join(root, "models")
    os.makedirs(models)
    NNModelSpec(layer_sizes=sizes, activations=["tanh"],
                input_columns=cols, norm_specs=specs,
                params=init_params(sizes, seed=0)).save(
        os.path.join(models, "model0.nn"))
    return cols


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.read().decode("utf-8")


def test_fleet_routes_answer_from_either_server(tmp_path):
    from shifu_tpu_torch import obs
    from shifu_tpu_torch.serve.server import ScoringServer

    root = str(tmp_path)
    cols = _write_set(root)
    obs.reset()
    servers = []
    try:
        for _ in range(2):
            servers.append(ScoringServer(root=root, port=0, replicas=1,
                                         device="cpu").start())
        a, b = servers
        assert a.lease_id != b.lease_id
        assert {p["leaseId"] for p in lease.scan(root)} == {a.lease_id,
                                                            b.lease_id}
        rec = {c: "0.5" for c in cols}
        req = urllib.request.Request(
            f"http://127.0.0.1:{a.port}/score",
            json.dumps({"records": [rec] * 3}).encode(),
            {"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            assert r.status == 200
        doc = json.loads(_get(f"http://127.0.0.1:{a.port}"
                              "/admin/metrics.json"))
        assert doc["schema"] == fleetview.METRICS_JSON_SCHEMA
        assert doc["leaseId"] == a.lease_id and "counters" in doc["metrics"]
        views = [json.loads(_get(f"http://127.0.0.1:{s.port}"
                                 "/fleet/healthz")) for s in servers]
        assert [v["liveProcesses"] for v in views] == [2, 2]
        assert [v["answeredBy"] for v in views] == [a.lease_id, b.lease_id]
        # both processes share this test's obs registry: each sample is
        # the same snapshot, and either answer folds the same sums
        sums = []
        for s in servers:
            text = _get(f"http://127.0.0.1:{s.port}/fleet/metrics")
            flat = parse_prometheus(text)
            sums.append(sum(v for k, v in flat.items()
                            if k.startswith("serve_requests_total")))
        assert sums[0] == sums[1] == 2 * 1.0
        # /healthz's peer view is the heartbeat's (a beat a renewal)
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline:
            h = json.loads(_get(f"http://127.0.0.1:{a.port}/healthz"))
            if h["peers"]["liveProcesses"] == 2:
                break
            time.sleep(0.05)
        assert h["peers"]["liveProcesses"] == 2
        assert h["peers"]["leaseId"] == a.lease_id
        payload, samples = top.fetch_view(f"http://127.0.0.1:{a.port}")
        assert payload["liveProcesses"] == 2
        assert np.isclose(top.total_requests(samples), 2.0)
    finally:
        for s in servers:
            s.shutdown(10)
    assert lease.scan(root) == []  # both leases released

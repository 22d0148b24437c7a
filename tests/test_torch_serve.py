"""The port's serving stack on the CPU: admission queue, micro-batcher,
health and circuit breaker, replica fleet, HTTP server and the `serve`
CLI (`shifu_tpu_torch/serve/`), the cases of the JAX package's
tests/test_serve.py and tests/test_wire.py for each.

The batcher cases use a fake `score_fn`. The fleet, server and CLI cases
serve a model set made with the port's own `.nn` writer: three models on
one norm plan holding value columns, a table column and a one-hot column
(the JAX parity of the registry itself is tests/test_torch_serve_registry.py).
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from shifu_tpu_torch.cli import main as cli_main  # noqa: E402
from shifu_tpu_torch.data.reader import ColumnarData  # noqa: E402
from shifu_tpu_torch.eval.scorer import ScoreResult  # noqa: E402
from shifu_tpu_torch.models.nn import NNModelSpec, init_params  # noqa: E402
from shifu_tpu_torch.serve import wire  # noqa: E402
from shifu_tpu_torch.serve.batcher import (  # noqa: E402
    DeadlineExceededError,
    MicroBatcher,
)
from shifu_tpu_torch.serve.fleet import ReplicaFleet  # noqa: E402
from shifu_tpu_torch.serve.health import (  # noqa: E402
    BREAKER_CLOSED,
    BREAKER_HALF_OPEN,
    BREAKER_OPEN,
    CircuitBreaker,
)
from shifu_tpu_torch.serve.queue import (  # noqa: E402
    AdmissionQueue,
    RejectedError,
)
from shifu_tpu_torch.serve.registry import ModelRegistry  # noqa: E402
from shifu_tpu_torch.serve.server import (  # noqa: E402
    ScoringServer,
    _result_rows,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM = ["num_0", "num_1", "num_2", "num_3"]
CATS = ["red", "green", "blue"]


def write_model_set(root, n_models=3):
    """models/model<i>.nn: value columns NUM, cat_0 through a table,
    cat_1 one-hot (3 categories and the missing slot)."""
    rng = np.random.default_rng(11)
    specs = [{"name": c, "kind": "value", "outNames": [c],
              "fill": float(rng.normal()), "mean": float(rng.normal()),
              "std": float(rng.uniform(0.5, 2)), "zscore": True,
              "boundaries": [float("-inf"), 0.0]} for c in NUM]
    specs.append({"name": "cat_0", "kind": "table", "outNames": ["cat_0"],
                  "table": [float(v) for v in rng.normal(size=4)],
                  "categories": CATS})
    specs.append({"name": "cat_1", "kind": "onehot",
                  "outNames": [f"cat_1_{k}" for k in range(4)],
                  "categories": CATS})
    sizes = [len(NUM) + 1 + 4, 8, 1]
    models = os.path.join(root, "models")
    os.makedirs(models)
    for b in range(n_models):
        NNModelSpec(layer_sizes=sizes, activations=["tanh"],
                    input_columns=NUM + ["cat_0", "cat_1"],
                    norm_type="ZSCALE_ONEHOT", norm_specs=specs,
                    params=init_params(sizes, seed=b)).save(
            os.path.join(models, f"model{b}.nn"))
    return root


@pytest.fixture(scope="module")
def model_set(tmp_path_factory):
    return write_model_set(str(tmp_path_factory.mktemp("serve_set")))


def records(n, seed=0):
    """Floats, an int column, None, absent fields, unseen categories."""
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n):
        r = {c: float(np.round(rng.normal(), 4)) for c in NUM[:3]}
        r["num_3"] = int(rng.integers(-2, 3))
        r["cat_0"] = (CATS + ["never", "?"])[i % 5]
        r["cat_1"] = (CATS + ["é-∅"])[(i + 1) % 4]
        recs.append(r)
    recs[0]["num_0"] = None
    del recs[min(1, n - 1)]["cat_1"]
    return recs


def _fake_result(values):
    m = np.asarray(values, np.float64)[:, None]
    return ScoreResult(model_scores=m, mean=m[:, 0], max=m[:, 0],
                       min=m[:, 0], median=m[:, 0],
                       model_names=["fake"], model_widths=[1])


def _one_row(v):
    return ColumnarData(names=["v"],
                        raw={"v": np.asarray([str(v)], object)}, n_rows=1)


def _values(data):
    return [float(x) for x in data.column("v")]


# ---------------------------------------------------------------------------
# micro-batcher + admission queue (tests/test_serve.py TestBatcherQueue)
# ---------------------------------------------------------------------------


class TestBatcherQueue:
    def test_coalescing_and_padding_aware_unpacking(self):
        batch_sizes = []
        gate = threading.Event()

        def score(data):
            gate.wait(10)
            vals = _values(data)
            batch_sizes.append(len(vals))
            return _fake_result(vals)

        batcher = MicroBatcher(score, AdmissionQueue(64),
                               max_batch_rows=64, max_wait_ms=50)
        reqs = [batcher.submit(_one_row(i)) for i in range(20)]
        gate.set()
        results = [r.wait(10) for r in reqs]
        for i, res in enumerate(results):
            assert res.mean[0] == pytest.approx(float(i))
        assert 1 <= len(batch_sizes) < 20
        assert batcher.records == 20 and batcher.batches == len(batch_sizes)
        assert batcher.requests == {"json": 20}
        assert batcher.latency["json"].count == 20
        batcher.admission.close()
        batcher.join(5)

    def test_row_cap_bounds_batch_size(self):
        batch_sizes = []
        gate = threading.Event()

        def score(data):
            gate.wait(10)
            vals = _values(data)
            batch_sizes.append(len(vals))
            return _fake_result(vals)

        batcher = MicroBatcher(score, AdmissionQueue(64),
                               max_batch_rows=4, max_wait_ms=200)
        reqs = [batcher.submit(_one_row(i)) for i in range(12)]
        gate.set()
        for r in reqs:
            r.wait(10)
        assert max(batch_sizes) <= 4
        batcher.admission.close()
        batcher.join(5)

    def test_scoring_error_fans_out_not_kills_worker(self):
        calls = []

        def score(data):
            calls.append(data.n_rows)
            if len(calls) == 1:
                raise ValueError("boom")
            return _fake_result(_values(data))

        batcher = MicroBatcher(score, AdmissionQueue(8),
                               max_batch_rows=8, max_wait_ms=1)
        bad = batcher.submit(_one_row(1))
        with pytest.raises(ValueError, match="boom"):
            bad.wait(10)
        good = batcher.submit(_one_row(2))
        assert good.wait(10).mean[0] == pytest.approx(2.0)
        assert batcher.batch_errors == 1
        batcher.admission.close()
        batcher.join(5)

    def test_backpressure_sheds_fast_and_drains_clean(self):
        gate = threading.Event()
        entered = threading.Event()

        def score(data):
            entered.set()
            gate.wait(10)
            return _fake_result(_values(data))

        admission = AdmissionQueue(3)
        batcher = MicroBatcher(score, admission,
                               max_batch_rows=1, max_wait_ms=1)
        first = batcher.submit(_one_row(0))
        assert entered.wait(10)
        admitted = [batcher.submit(_one_row(i)) for i in range(1, 4)]
        t0 = time.perf_counter()
        with pytest.raises(RejectedError) as exc:
            batcher.submit(_one_row(99))
        assert exc.value.reason == "full"
        assert time.perf_counter() - t0 < 0.5  # a shed, not a timeout
        admission.close()
        with pytest.raises(RejectedError) as exc2:
            batcher.submit(_one_row(100))
        assert exc2.value.reason == "closed"
        assert admission.shed == {"full": 1, "closed": 1}
        gate.set()
        assert first.wait(10).mean[0] == pytest.approx(0.0)
        for i, req in enumerate(admitted):
            assert req.wait(10).mean[0] == pytest.approx(float(i + 1))
        batcher.join(5)
        assert not batcher.draining

    @pytest.mark.parametrize("mode", ["continuous", "barrier"])
    def test_continuous_vs_barrier(self, mode):
        """A lone request on an idle replica: continuous dispatches it at
        once, barrier holds it for the wait window; requests arriving in
        the window ride one barrier batch."""
        batch_sizes = []

        def score(data):
            batch_sizes.append(data.n_rows)
            return _fake_result(_values(data))

        batcher = MicroBatcher(score, AdmissionQueue(64),
                               max_batch_rows=64, max_wait_ms=1000,
                               batching=mode)
        assert batcher.batching == mode
        t0 = time.perf_counter()
        batcher.submit(_one_row(1)).wait(10)
        lone = time.perf_counter() - t0
        if mode == "continuous":
            assert lone < 0.5
        else:
            assert lone >= 0.95
        batch_sizes.clear()
        reqs = [batcher.submit(_one_row(i)) for i in range(5)]
        for r in reqs:
            r.wait(10)
        if mode == "barrier":
            assert batch_sizes == [5]
        assert sum(batch_sizes) == 5
        batcher.admission.close()
        batcher.join(5)

    def test_deadline_expires_before_dispatch(self):
        gate = threading.Event()
        entered = threading.Event()

        def score(data):
            entered.set()
            gate.wait(10)
            return _fake_result(_values(data))

        batcher = MicroBatcher(score, AdmissionQueue(8), max_batch_rows=1,
                               max_wait_ms=1, deadline_ms=50)
        first = batcher.submit(_one_row(0))
        assert entered.wait(10)
        late = batcher.submit(_one_row(1))
        time.sleep(0.15)
        gate.set()
        assert first.wait(10).mean[0] == 0.0
        with pytest.raises(DeadlineExceededError):
            late.wait(10)
        assert batcher.deadline_shed == 1
        batcher.admission.close()
        batcher.join(5)


class _Crash(BaseException):
    """Escapes the batcher's per-batch guard, as a dead worker would."""


def test_worker_crash_restarts_then_drains():
    """A crash answers the batch in flight, degrades health and restarts
    the worker; past the restart budget the batcher drains and answers
    everything still queued."""
    def score(data):
        if _values(data)[0] < 0:
            raise _Crash("worker died")
        return _fake_result(_values(data))

    batcher = MicroBatcher(score, AdmissionQueue(8), max_batch_rows=1,
                           max_wait_ms=1, max_restarts=1)
    with pytest.raises(RuntimeError, match="crashed mid-batch"):
        batcher.submit(_one_row(-1)).wait(10)
    assert batcher.submit(_one_row(5)).wait(10).mean[0] == 5.0
    assert batcher.restarts == 1 and batcher.crashes == 1
    assert batcher.health.state == "degraded"
    for v in (6, 7, 8):  # clean batches lift the degrade
        batcher.submit(_one_row(v)).wait(10)
    assert batcher.health.state == "ok"
    with pytest.raises(RuntimeError, match="crashed mid-batch"):
        batcher.submit(_one_row(-2)).wait(10)
    batcher.join(10)
    assert batcher.health.state == "draining"
    with pytest.raises(RejectedError):
        batcher.submit(_one_row(9))


def test_replica_devices_on_the_cpu():
    from shifu_tpu_torch.serve.fleet import replica_devices
    from shifu_tpu_torch.utils import environment

    cpu = torch.device("cpu")
    assert replica_devices(None, "cpu") == [cpu]
    assert replica_devices(0, "cpu") == [cpu]
    assert replica_devices(3, "cpu") == [cpu] * 3
    environment.set_property("shifu.serve.replicas", "2")
    try:
        assert replica_devices(None, "cpu") == [cpu] * 2
    finally:
        environment.set_property("shifu.serve.replicas", "0")


# ---------------------------------------------------------------------------
# circuit breaker
# ---------------------------------------------------------------------------


def test_breaker_trips_and_probes():
    br = CircuitBreaker(failures=2, probe_base_ms=20, probe_cap_ms=40,
                        probe_oks=1)
    assert br.admit() == "closed"
    br.note_failure("e1")
    assert br.state == BREAKER_CLOSED
    br.note_failure("e2")
    assert br.state == BREAKER_OPEN and br.trips == 1
    assert not br.routable() and br.admit() is None
    time.sleep(0.05)
    assert br.probe_due() and br.routable()
    assert br.admit() == "probe"
    assert br.state == BREAKER_HALF_OPEN
    assert not br.routable()  # one probe at a time
    br.note_failure("probe failed")  # back to open, longer backoff
    assert br.state == BREAKER_OPEN
    assert br.snapshot()["openAttempts"] == 2
    time.sleep(0.1)
    assert br.admit() == "probe"
    br.note_ok()
    assert br.state == BREAKER_CLOSED
    assert br.transitions == {"open": 2, "half_open": 2, "closed": 1}


def test_failing_replica_trips_and_fails_over(model_set):
    fleet = ReplicaFleet.build(os.path.join(model_set, "models"),
                               n_replicas=2, device="cpu",
                               max_batch_rows=64, max_wait_ms=1)
    try:
        bad = fleet.replicas[0]
        bad.breaker.failures = 1

        def broken(data):
            raise RuntimeError("device lost")

        bad.batcher.score_fn = broken
        recs = records(3)
        want = fleet.replicas[1].registry.score_records(recs)
        for _ in range(4):
            got = fleet.score_batch(recs, timeout=30)
            np.testing.assert_array_equal(got.model_scores,
                                          want.model_scores)
        assert bad.breaker.state == BREAKER_OPEN
        assert fleet.failovers >= 1
        health = fleet.health_snapshot()
        assert health["status"] == "degraded"
        assert "replica 0" in health["reason"]
    finally:
        fleet.close(10)


# ---------------------------------------------------------------------------
# fleet
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_replicas", [1, 2])
def test_fleet_gives_the_registry_bits(model_set, n_replicas):
    models = os.path.join(model_set, "models")
    reg = ModelRegistry(models, device="cpu")
    fleet = ReplicaFleet.build(models, n_replicas=n_replicas, device="cpu")
    try:
        assert len(fleet) == n_replicas
        assert [str(r.device) for r in fleet.replicas] == \
            ["cpu"] * n_replicas
        recs = records(7)
        want = reg.score_records(recs)
        via_json = fleet.score_batch(recs, timeout=30)
        decoded = wire.decode(wire.encode_records(recs))
        via_bin = fleet.score_batch(decoded, timeout=30)
        for got in (via_json, via_bin):
            for k in ("model_scores", "mean", "max", "min", "median"):
                np.testing.assert_array_equal(getattr(got, k),
                                              getattr(want, k))
        assert fleet.snapshot()["replicaCount"] == n_replicas
    finally:
        fleet.close(10)


def test_router_skips_a_draining_replica(model_set):
    fleet = ReplicaFleet.build(os.path.join(model_set, "models"),
                               n_replicas=2, device="cpu")
    try:
        fleet.replicas[0].health.set_draining("maintenance")
        for _ in range(6):
            fleet.score_batch(records(2), timeout=30)
        assert fleet.replicas[0].batcher.records == 0
        assert fleet.replicas[1].batcher.records == 12
        assert fleet.health_snapshot()["status"] == "degraded"
        fleet.replicas[1].health.set_draining("maintenance")
        with pytest.raises(RejectedError):
            fleet.score_batch(records(1), timeout=30)
        assert fleet.health_snapshot()["status"] == "draining"
    finally:
        fleet.close(10)


def test_fleet_what_waits(model_set):
    fleet = ReplicaFleet.build(os.path.join(model_set, "models"),
                               n_replicas=1, device="cpu")
    try:
        for op in (fleet.stage, fleet.promote, fleet.shadow_snapshot):
            with pytest.raises(NotImplementedError, match="A.14"):
                op("x")
    finally:
        fleet.close(10)


# ---------------------------------------------------------------------------
# HTTP server
# ---------------------------------------------------------------------------


def _post(url, body, ctype="application/json"):
    req = urllib.request.Request(
        url, data=body if isinstance(body, bytes) else body.encode(),
        headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.status, json.loads(r.read())


def _http_error(url, body, ctype="application/json"):
    with pytest.raises(urllib.error.HTTPError) as he:
        _post(url, body, ctype)
    return he.value.code, json.loads(he.value.read()), he.value.headers


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture
def server(model_set):
    srv = ScoringServer(root=model_set, port=0, replicas=1, max_wait_ms=1,
                        device="cpu").start()
    yield srv
    srv.shutdown(10)


def test_json_jsonl_and_binary_answer_the_same_rows(server):
    base = f"http://127.0.0.1:{server.port}"
    recs = records(6)
    want = _result_rows(server.registry.score_records(recs))
    status, doc = _post(f"{base}/score", json.dumps({"records": recs}))
    assert status == 200 and doc["scores"] == want
    assert doc["models"] == ["model0.nn", "model1.nn", "model2.nn"]
    jsonl = "\n".join(json.dumps(r) for r in recs)
    assert _post(f"{base}/score", jsonl,
                 "application/jsonl")[1]["scores"] == want
    assert _post(f"{base}/score", json.dumps(recs))[1]["scores"] == want
    status, doc = _post(f"{base}/score", wire.encode_records(recs),
                        wire.CONTENT_TYPE)
    assert status == 200 and doc["scores"] == want
    assert _post(f"{base}/score", json.dumps(recs[2]))[1]["scores"] == \
        want[2:3]
    batcher = server.registry.replicas[0].batcher
    assert batcher.requests == {"json": 4, "binary": 1}


def test_error_statuses_have_json_bodies(server):
    base = f"http://127.0.0.1:{server.port}"
    payload = wire.encode_records(records(3))
    for body in ("not json [", "[1, 2, 3]", "[]"):
        code, doc, _ = _http_error(f"{base}/score", body)
        assert code == 400 and "error" in doc
    for bad in (payload[:7], payload[:-2], b"XXXX" + payload[4:], b""):
        code, doc, _ = _http_error(f"{base}/score", bad, wire.CONTENT_TYPE)
        assert code == 400 and "error" in doc
    code, doc, _ = _http_error(f"{base}/score", payload,
                               "application/msgpack")
    assert code == 415 and wire.CONTENT_TYPE in doc["accepts"]
    code, doc, _ = _http_error(f"{base}/score/tenant_a", "{}")
    assert code == 404 and "single-tenant" in doc["error"]
    code, doc, _ = _http_error(f"{base}/nope", "{}")
    assert code == 404 and "error" in doc
    for path in ("/metrics", "/admin/traces", "/fleet/healthz"):
        code, doc = _get(f"{base}{path}")
        assert code == 501 and "A.14" in doc["error"], path
    code, doc, _ = _http_error(f"{base}/admin/stage", "{}")
    assert code == 501 and "A.14" in doc["error"]


def test_oversize_binary_body_is_400(server):
    from shifu_tpu_torch.utils import environment

    base = f"http://127.0.0.1:{server.port}"
    payload = wire.encode_records(records(8))
    environment.set_property("shifu.serve.wire.maxBodyMB", "0.00001")
    try:
        assert len(payload) > wire.max_body_bytes()
        code, doc, _ = _http_error(f"{base}/score", payload,
                                   wire.CONTENT_TYPE)
        assert code == 400 and "maxBodyMB" in doc["error"]
    finally:
        environment.set_property("shifu.serve.wire.maxBodyMB", "")


def test_healthz_200_then_503_while_draining(server):
    base = f"http://127.0.0.1:{server.port}"
    code, doc = _get(f"{base}/healthz")
    assert code == 200 and doc["status"] == "ok"
    assert doc["sha"] == server.registry.sha and doc["fused"] is True
    assert doc["replicaCount"] == 1 and doc["device"] == "cpu"
    server.registry.replicas[0].health.set_draining("test")
    code, doc = _get(f"{base}/healthz")
    assert code == 503 and doc["status"] == "draining"


def test_http_429_under_saturation_then_clean_drain(model_set):
    srv = ScoringServer(root=model_set, port=0, queue_depth=2,
                        max_batch_rows=1, max_wait_ms=1, replicas=1,
                        device="cpu").start()
    base = f"http://127.0.0.1:{srv.port}"
    rec = records(1)[0]
    gate = threading.Event()
    entered = threading.Event()
    batcher = srv.scorer.batcher
    orig = batcher.score_fn

    def gated(data):
        entered.set()
        gate.wait(10)
        return orig(data)

    batcher.score_fn = gated
    from shifu_tpu_torch.serve.registry import records_to_columnar

    cols = srv.registry.input_columns
    first = batcher.submit(records_to_columnar([rec], cols))
    assert entered.wait(10)
    inflight = [first] + [batcher.submit(records_to_columnar([rec], cols))
                          for _ in range(2)]
    code, doc, headers = _http_error(f"{base}/score", json.dumps(rec))
    assert code == 429 and doc["reason"] == "full"
    assert int(headers.get("Retry-After")) >= 1
    done = {}

    def finish():
        gate.set()
        done["snap"] = srv.shutdown(15)

    t = threading.Thread(target=finish)
    t.start()
    for req in inflight:
        assert req.wait(15).mean.shape == (1,)
    t.join(15)
    assert done["snap"]["replicas"][0]["batcher"]["records"] == 3
    assert srv.shutdown() is None  # only the first caller drains
    with pytest.raises(RejectedError):
        srv.scorer.score_batch([rec])


def test_server_waits_for_the_zoo(model_set):
    with pytest.raises(NotImplementedError, match="A.14"):
        ScoringServer(root=model_set, device="cpu", zoo={"a": model_set})


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=REPO, **extra)
    env.pop("JAX_PLATFORMS", None)
    return env


def test_cli_serves_and_exits_0_on_sigterm(model_set):
    proc = subprocess.Popen(
        [sys.executable, "-m", "shifu_tpu_torch", "serve", "--device", "cpu",
         "--port", "0", "--warm", "1,16"],
        cwd=model_set, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("listening on 127.0.0.1:"), (
            line + proc.stderr.read())
        assert line.rstrip().endswith("(1 replica(s))")
        port = int(line.split(":")[1].split()[0])
        status, doc = _post(f"http://127.0.0.1:{port}/score",
                            json.dumps(records(2)))
        assert status == 200 and len(doc["scores"]) == 2
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_cli_serve_without_a_card_exits_1(model_set):
    proc = subprocess.run(
        [sys.executable, "-m", "shifu_tpu_torch", "serve", "--port", "0"],
        cwd=model_set, env=_env(CUDA_VISIBLE_DEVICES=""),
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1, proc.stderr
    assert "CUDA" in proc.stderr


def test_cli_serve_zoo_exits_2(capsys):
    assert cli_main(["serve", "--zoo", "a=b", "--device", "cpu"]) == 2
    assert "A.14" in capsys.readouterr().err
    assert cli_main(["serve", "--traffic-log", "--device", "cpu"]) == 2


def test_slo_burn_rate_degrades_healthz(server):
    """shifu.serve.sloMs armed: bad requests burn the error budget and
    /healthz names the burn as its degrade reason."""
    from shifu_tpu_torch.serve.health import SloTracker

    slo = SloTracker(slo_ms=50.0, target=0.9)
    for latency in (0.01, 0.02, 0.2):
        slo.observe(latency)
    slo.observe(0.001, ok=False)  # a shed request burns budget too
    snap = slo.snapshot()
    assert (snap["good"], snap["bad"]) == (2, 2)
    assert snap["burnRate"] == pytest.approx(5.0) and snap["burning"]
    server.registry.slo = slo
    code, doc = _get(f"http://127.0.0.1:{server.port}/healthz")
    assert code == 200 and doc["status"] == "degraded"
    assert "SLO burn rate" in doc["reason"] and doc["slo"]["bad"] == 2
    assert SloTracker().enabled is False  # off unless sloMs is set

"""`shifu serve` front end: a stdlib HTTP server and the in-process Scorer
(counterpart of `shifu_tpu/serve/server.py`, single-tenant).

  POST /score    {"records": [{col: value, ...}, ...]}, a list of
                 records, one bare record, JSONL (one record a line), or
                 the columnar binary wire (`Content-Type:
                 application/x-shifu-columnar`, serve/wire.py). Answer:
                 {"models": [...], "scores": [{"mean", "max", "min",
                 "median", "models"}, ...]}. 400 on a malformed body or
                 length (or a binary body past shifu.serve.wire.maxBodyMB),
                 415 on another Content-Type, 429 with Retry-After on
                 shed, 503 on shutdown or timeout. Error bodies are JSON.
  POST /score/<set>  404: this server is single-tenant.
  GET  /healthz  200 with the fleet's health and identity; 503 while
                 draining.
  GET  /metrics  the obs registry as Prometheus text (obs/metrics.py).
  GET  /admin/traces  the retained request traces (obs/reqtrace.py) and
                 the ring's summary.
  GET|POST /admin/* (the rest), /fleet/*  501 naming ROADMAP A.14: the
                 rollout control plane (stage, promote, evict,
                 co-resident training), `/admin/metrics.json` and the
                 fleet views wait with the model zoo, leases and peers,
                 the traffic log and the drift monitor.

Request traces: an inbound `X-Shifu-Trace` header is honored (and forces
retention), otherwise a trace is kept under `shifu.trace.sample` head
sampling and `shifu.trace.slowMs` tail capture; the id is echoed in the
response header. `-Dshifu.obs.snapshotMs` arms the on-disk metrics time
series (obs/timeseries.py) under the process's solo id.

HTTP handler threads parse and answer; they never touch a tensor: every
batch is scored on its replica's batcher thread. `Scorer.score_batch` is
the same admission -> batcher -> registry path without HTTP.

`ScoringServer.shutdown()` closes admission (new requests get 503), the
batchers drain every admitted request, the listener stops, and the run
ledger gets a `serve-<seq>.json` manifest with the retained traces
beside it (`serve-<seq>.traces.json`, read by `shifu trace`).
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

from shifu_tpu_torch.analysis.racetrack import tracked_lock
from shifu_tpu_torch.eval.scorer import ScoreResult
from shifu_tpu_torch.obs import registry as obs_registry
from shifu_tpu_torch.obs import reqtrace
from shifu_tpu_torch.serve import wire
from shifu_tpu_torch.serve.batcher import MicroBatcher
from shifu_tpu_torch.serve.fleet import ReplicaFleet, ScoringReplica
from shifu_tpu_torch.serve.health import DRAINING
from shifu_tpu_torch.serve.queue import AdmissionQueue, RejectedError
from shifu_tpu_torch.utils.log import get_logger
from shifu_tpu_torch.utils.platform import DeviceLike

log = get_logger(__name__)

DEFAULT_SCORE_TIMEOUT_S = 30.0

# Content-Types read as JSON/JSONL: "" (no header) and curl -d's default
# included; anything else but the columnar type is a 415
_JSON_CONTENT_TYPES = frozenset({
    "", "application/json", "text/json", "application/jsonl",
    "application/x-ndjson", "text/plain",
    "application/x-www-form-urlencoded",
})

_WAITS = "ROADMAP A.14"
# the routes that wait, and what each is in the JAX package
_NOT_PORTED = (
    ("/admin/", "the rollout control plane (stage, promote, evict, "
                "co-resident training) and the lossless metrics snapshot "
                "a peer's fleet collector reads"),
    ("/fleet/", "the fleet-of-processes views (obs/fleetview.py)"),
)
PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4"


class Scorer:
    """In-process scoring over the fleet's router: `Scorer(registry)`
    wraps any object with `score_raw` and `input_columns` in a
    one-replica fleet (around `admission` when given);
    `Scorer(fleet=...)` routes across its replicas."""

    def __init__(self, registry=None,
                 admission: Optional[AdmissionQueue] = None,
                 max_batch_rows: Optional[int] = None,
                 max_wait_ms: Optional[float] = None,
                 max_restarts: Optional[int] = None,
                 deadline_ms: Optional[float] = None,
                 batching: Optional[str] = None,
                 fleet: Optional[ReplicaFleet] = None) -> None:
        if fleet is None:
            if registry is None:
                raise ValueError("Scorer needs a registry or a fleet")
            fleet = ReplicaFleet([ScoringReplica(
                registry, index=0, admission=admission,
                max_batch_rows=max_batch_rows, max_wait_ms=max_wait_ms,
                max_restarts=max_restarts, deadline_ms=deadline_ms,
                batching=batching)])
        self.fleet = fleet
        self.registry = fleet.replicas[0].registry
        self.health = fleet.health

    @property
    def batcher(self) -> MicroBatcher:
        return self.fleet.replicas[0].batcher

    def health_snapshot(self) -> dict:
        return self.fleet.health_snapshot()

    def retry_after_seconds(self) -> float:
        return self.fleet.retry_after_seconds()

    def score_batch(self, records,
                    timeout: Optional[float] = DEFAULT_SCORE_TIMEOUT_S,
                    trace=None) -> ScoreResult:
        """Score raw records (dicts, or a decoded binary batch); blocks
        until their micro-batch completes. RejectedError on shed.

        Tracing: with an explicit `trace` (the HTTP path) the CALLER
        finishes it; without one, a trace is made per request when
        tracing or SLO accounting is armed, and finished here (the
        latency counts against the SLO when shifu.serve.sloMs is set)."""
        own = None
        if trace is None:
            buf = reqtrace.buffer()
            if buf.active or self.fleet.slo.enabled:
                own = trace = reqtrace.RequestTrace(
                    sampled=buf.head_sampled())
        try:
            return self.fleet.score_batch(records, timeout=timeout,
                                          trace=trace)
        except Exception as e:
            if own is not None:
                own.annotate(status=type(e).__name__)
            raise
        finally:
            if own is not None:
                self.fleet.finish_trace(own)

    def close(self, timeout: Optional[float] = 30.0) -> None:
        """Stop admitting and drain every admitted request."""
        self.fleet.close(timeout)


def _result_rows(res: ScoreResult) -> List[dict]:
    return [
        {
            "mean": round(float(res.mean[i]), 4),
            "max": round(float(res.max[i]), 4),
            "min": round(float(res.min[i]), 4),
            "median": round(float(res.median[i]), 4),
            "models": [round(float(v), 4) for v in res.model_scores[i]],
        }
        for i in range(len(res.mean))
    ]


def _parse_records(body: bytes) -> List[dict]:
    """A JSON document or JSONL lines -> a list of record dicts."""
    text = body.decode("utf-8")
    try:
        doc = json.loads(text)
    except ValueError:
        records = []
        for line in text.splitlines():
            line = line.strip()
            if line:
                records.append(json.loads(line))
        return _all_objects(records)
    if isinstance(doc, list):
        return _all_objects(doc)
    if isinstance(doc, dict) and isinstance(doc.get("records"), list):
        return _all_objects(doc["records"])
    if isinstance(doc, dict):
        return [doc]
    raise ValueError("body must be a JSON record, a list of records, "
                     'a {"records": [...]} document, or JSONL lines')


def _all_objects(records: List) -> List[dict]:
    """Every record must be a JSON object (else a 400)."""
    for r in records:
        if not isinstance(r, dict):
            raise ValueError(
                f"records must be JSON objects, got {type(r).__name__}")
    return records


def load_set_configs(root: str):
    """(column configs, model config) of the model set at `root`, each
    None where its file is absent or malformed: serving degrades to
    plain scoring, never to a failed start."""
    from shifu_tpu_torch.config import ModelConfig, load_column_config_list

    ccs = mc = None
    cc_path = os.path.join(root, "ColumnConfig.json")
    mc_path = os.path.join(root, "ModelConfig.json")
    try:
        if os.path.isfile(cc_path):
            ccs = load_column_config_list(cc_path)
    except Exception as e:  # a malformed config degrades, never kills
        log.warning("cannot load %s (%s)", cc_path, e)
    try:
        if os.path.isfile(mc_path):
            mc = ModelConfig.load(mc_path)
    except Exception as e:  # a malformed config degrades, never kills
        log.warning("cannot load %s (%s)", mc_path, e)
    return ccs, mc


class _HTTPServer(ThreadingHTTPServer):
    # the listen backlog: socketserver's default of 5 drops the SYNs of a
    # burst of new connections, which then wait a second to retry
    request_queue_size = 128
    daemon_threads = True


class ScoringServer:
    """Fleet + Scorer + HTTP listener. `device=None` is the card."""

    def __init__(self, root: str = ".",
                 models_dir: Optional[str] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 queue_depth: Optional[int] = None,
                 max_batch_rows: Optional[int] = None,
                 max_wait_ms: Optional[float] = None,
                 replicas: Optional[int] = None,
                 batching: Optional[str] = None,
                 device: DeviceLike = None,
                 column_configs=None, model_config=None,
                 zoo: Optional[dict] = None) -> None:
        if zoo:
            raise NotImplementedError(
                "the multi-tenant model zoo (serve/zoo.py) is not ported "
                "yet: " + _WAITS)
        self.root = os.path.abspath(root)
        # the set's configs give an Encog EG-text model its norm plan; a
        # models_dir outside a model set still serves without them
        if column_configs is None or model_config is None:
            ccs, mc = load_set_configs(self.root)
            column_configs = column_configs or ccs
            model_config = model_config or mc
        self.column_configs = column_configs
        self.model_config = model_config
        self.registry = ReplicaFleet.build(
            models_dir or os.path.join(self.root, "models"),
            n_replicas=replicas, device=device, queue_depth=queue_depth,
            max_batch_rows=max_batch_rows, max_wait_ms=max_wait_ms,
            batching=batching, column_configs=column_configs,
            model_config=model_config)
        self.scorer = Scorer(fleet=self.registry)
        self.started_at = time.time()
        self._serve_thread: Optional[threading.Thread] = None
        self._shutdown_lock = tracked_lock("serve.server.shutdown")
        self.manifest_path: Optional[str] = None
        self._shutdown_started = False
        self._shutdown_done = threading.Event()
        try:
            self.httpd = _HTTPServer((host, port), self._handler_class())
        except BaseException:
            self.scorer.close(5.0)
            raise
        # on-disk metrics time series (obs/timeseries.py), armed by
        # -Dshifu.obs.snapshotMs: without leases (ROADMAP A.14) the
        # process snapshots under a solo id, as a lease-less JAX server
        import socket

        from shifu_tpu_torch.obs.timeseries import MetricsSnapshotter

        self.lease_id = f"{socket.gethostname()}-{os.getpid()}-solo"
        self.obs_snap = MetricsSnapshotter(self.root, self.lease_id,
                                           registry_cb=obs_registry)
        self.obs_snap.start()

    @property
    def host(self) -> str:
        return self.httpd.server_address[0]

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def health(self) -> dict:
        """The /healthz document: fleet health, identity, load."""
        health = self.scorer.health_snapshot()
        fleet = self.registry
        health.update({
            "models": len(fleet.model_names),
            "sha": fleet.sha,
            "fused": fleet.fused,
            "device": str(fleet.replicas[0].device),
            "replicaCount": len(fleet.replicas),
            "queueDepth": sum(len(r.admission) for r in fleet.replicas),
            "workerRestarts": sum(r.batcher.restarts
                                  for r in fleet.replicas),
            "uptimeSeconds": round(time.time() - self.started_at, 1),
        })
        slo = fleet.slo
        if slo.enabled:
            snap = slo.snapshot()
            health["slo"] = snap
            if snap["burning"] and health["status"] == "ok":
                health["status"] = "degraded"
                health["reason"] = (
                    f"SLO burn rate {snap['burnRate']:.2f} "
                    f"(>{slo.slo_ms:g}ms beyond the {slo.target:g} "
                    "objective)")
        return health

    def _handler_class(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # the headers and the body go out in two writes: without
            # TCP_NODELAY the body waits for the client's delayed ACK
            # (~40 ms a response on a kept-alive connection)
            disable_nagle_algorithm = True

            def log_message(self, fmt, *args):
                log.debug("http: " + fmt, *args)

            def _reply(self, code: int, payload,
                       extra_headers: Optional[dict] = None,
                       content_type: str = "application/json") -> None:
                body = (payload if isinstance(payload, bytes)
                        else json.dumps(payload).encode("utf-8"))
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                for k, v in (extra_headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _waits(self) -> bool:
                """501 for a route that is not ported yet."""
                for prefix, what in _NOT_PORTED:
                    if (self.path == prefix
                            or self.path.startswith(prefix)
                            or self.path.startswith(prefix + "?")):
                        self._reply(501, {
                            "error": f"{self.path}: {what} is not ported "
                                     f"yet: {_WAITS}"})
                        return True
                return False

            def do_GET(self):
                if self.path == "/healthz":
                    health = server.health()
                    self._reply(503 if health["status"] == DRAINING
                                else 200, health)
                    return
                if self.path == "/metrics":
                    self._reply(
                        200, obs_registry().to_prometheus().encode("utf-8"),
                        content_type=PROMETHEUS_CONTENT_TYPE)
                    return
                if self.path == "/admin/traces":
                    buf = reqtrace.buffer()
                    self._reply(200, {**buf.snapshot(),
                                      "traces": buf.traces()})
                    return
                if self._waits():
                    return
                self._reply(404, {"error": f"unknown path {self.path}"})

            def do_POST(self):
                if self.path.startswith("/score/"):
                    self._drain_body()
                    self._reply(404, {
                        "error": "this server is single-tenant: POST "
                                 "/score (per-set routes come with the "
                                 f"model zoo, {_WAITS})"})
                    return
                if self.path != "/score":
                    if not self._waits():
                        self._reply(404, {
                            "error": f"unknown path {self.path}"})
                    return
                ctype = (self.headers.get("Content-Type") or "")
                ctype = ctype.split(";", 1)[0].strip().lower()
                try:
                    length = int(self.headers.get("Content-Length", "0"))
                    if length < 0:
                        raise ValueError(length)
                except ValueError:
                    self.close_connection = True
                    self._reply(400, {"error": "bad Content-Length"})
                    return
                if ctype == wire.CONTENT_TYPE:
                    limit = wire.max_body_bytes()
                    if length > limit:
                        self.close_connection = True
                        self._reply(400, {
                            "error": f"columnar body of {length} bytes "
                                     f"exceeds shifu.serve.wire.maxBodyMB "
                                     f"({limit} bytes)"})
                        return
                    body = self.rfile.read(length)
                    try:
                        records = wire.decode(body)
                    except wire.WireFormatError as e:
                        self._reply(400, {
                            "error": f"bad columnar body: {e}"})
                        return
                    n_rows = records.n_rows
                elif ctype in _JSON_CONTENT_TYPES:
                    body = self.rfile.read(length)
                    try:
                        records = _parse_records(body)
                    except ValueError as e:  # incl. UnicodeDecodeError
                        self._reply(400, {
                            "error": f"bad request body: {e}"})
                        return
                    n_rows = len(records)
                else:
                    self._drain_body(length)
                    self._reply(415, {
                        "error": f"unsupported Content-Type {ctype!r}",
                        "accepts": sorted(
                            t for t in _JSON_CONTENT_TYPES if t
                        ) + [wire.CONTENT_TYPE]})
                    return
                if not n_rows:
                    self._reply(400, {"error": "no records in body"})
                    return
                # trace id contract: an inbound X-Shifu-Trace header is
                # honored (and FORCES retention), otherwise one is made
                # under the head-sampling / slow-capture policy; the id
                # is echoed in the response header either way
                hdr = reqtrace.clean_trace_id(
                    self.headers.get(reqtrace.TRACE_HEADER))
                buf = reqtrace.buffer()
                fleet = server.registry
                trace = None
                if hdr or buf.active or fleet.slo.enabled:
                    trace = reqtrace.RequestTrace(
                        trace_id=hdr,
                        sampled=bool(hdr) or buf.head_sampled())
                err_headers = {}

                def _failed(status: str, **attrs) -> None:
                    if trace is not None:
                        trace.annotate(status=status, **attrs)
                        fleet.finish_trace(trace)
                        err_headers[reqtrace.TRACE_HEADER] = trace.trace_id

                try:
                    res = server.scorer.score_batch(records, trace=trace)
                except RejectedError as e:
                    _failed("rejected", reason=e.reason)
                    if e.reason == "closed":
                        self._reply(503, {"error": str(e),
                                          "reason": e.reason},
                                    extra_headers=err_headers)
                        return
                    hint = server.scorer.retry_after_seconds()
                    err_headers["Retry-After"] = str(int(math.ceil(hint)))
                    self._reply(429, {"error": str(e), "reason": e.reason,
                                      "retryAfterSeconds": round(hint, 3)},
                                extra_headers=err_headers)
                    return
                except TimeoutError as e:
                    _failed("timeout")
                    self._reply(503, {"error": str(e)},
                                extra_headers=err_headers)
                    return
                except Exception as e:  # a failed batch: never a hang
                    _failed(type(e).__name__)
                    self._reply(500, {"error": f"{type(e).__name__}: {e}"},
                                extra_headers=err_headers)
                    return
                doc = {"models": fleet.model_names, "scores": None}
                if trace is None:
                    doc["scores"] = _result_rows(res)
                    self._reply(200, doc)
                    return
                # serialize is a measured stage: the response-row build
                # and JSON encode is host work the client waits on
                with trace.stage("serialize"):
                    doc["scores"] = _result_rows(res)
                    doc["trace"] = trace.trace_id
                    body = json.dumps(doc).encode("utf-8")
                fleet.finish_trace(trace)
                self._reply(200, body, extra_headers={
                    reqtrace.TRACE_HEADER: trace.trace_id})

            def _drain_body(self, length: Optional[int] = None) -> None:
                """Read an unused body so the connection stays in step."""
                if length is None:
                    try:
                        length = int(self.headers.get("Content-Length", "0"))
                    except ValueError:
                        length = 0
                if 0 < length <= wire.max_body_bytes():
                    self.rfile.read(length)
                elif length:
                    self.close_connection = True

        return Handler

    # ---- lifecycle ----
    def start(self) -> "ScoringServer":
        self._serve_thread = threading.Thread(
            target=self.httpd.serve_forever, name="shifu-serve-http",
            daemon=True)
        self._serve_thread.start()
        log.info("shifu serve listening on %s:%d (%d models, sha %s, %s)",
                 self.host, self.port, len(self.registry.model_names),
                 self.registry.sha, self.registry.replicas[0].device)
        return self

    def serve_forever(self) -> None:
        """Foreground serving (the CLI); returns after shutdown()."""
        self.start()
        self._shutdown_done.wait()

    def shutdown(self, drain_timeout: float = 30.0) -> Optional[dict]:
        """Reject new work -> drain every admitted request -> stop the
        listener -> write the serve manifest (and the retained traces).
        Returns the fleet's final snapshot to the first caller, None to
        any later one."""
        with self._shutdown_lock:
            if self._shutdown_started:
                return None
            self._shutdown_started = True
        try:
            self.scorer.close(drain_timeout)
            if self._serve_thread is not None:  # serve_forever runs
                self.httpd.shutdown()
                self._serve_thread.join(5.0)
            self.httpd.server_close()
            # final time-series window AFTER the drain: the last chunk
            # carries the terminal counter state
            self.obs_snap.stop()
            snap = self.registry.snapshot()
            self.manifest_path = self._write_manifest(snap)
            return snap
        finally:
            self._shutdown_done.set()

    def _write_manifest(self, fleet_snapshot: dict) -> Optional[str]:
        """`serve-<seq>.json` in the run ledger, with the registry, the
        profile section, the fleet snapshot, the sanitizer verdict and
        the summary of the retained traces, written beside it as
        `serve-<seq>.traces.json`."""
        import sys

        from shifu_tpu_torch import obs
        from shifu_tpu_torch.analysis import sanitize
        from shifu_tpu_torch.obs.ledger import RunLedger

        ledger = RunLedger(self.root)
        try:
            extra = {"serve": fleet_snapshot}
            san = sanitize.current()
            if san is not None and san.active:
                extra["sanitizer"] = san.verdict()
            if self.registry.slo.enabled:
                extra["slo"] = self.registry.slo.snapshot()
            if self.obs_snap.enabled:
                extra["obsTimeseries"] = self.obs_snap.snapshot()
            seq = ledger.next_seq("serve")
            buf = reqtrace.buffer()
            if buf.active or buf.count:
                written = buf.write_traces(os.path.join(
                    ledger.dir, f"serve-{seq}.traces.json"))
                extra["traces"] = dict(
                    buf.snapshot(),
                    path=(os.path.relpath(written, self.root)
                          if written else None))
            path = ledger.write(
                "serve", seq, status="ok", exit_status=0,
                started_at=self.started_at,
                elapsed_seconds=time.time() - self.started_at,
                argv=list(sys.argv), registry=obs.registry(),
                tracer=obs.tracer(), profile=obs.profiler().snapshot(),
                extra=extra)
            log.info("serve manifest -> %s", path)
            return path
        except OSError as e:  # a broken ledger must not mask shutdown
            log.warning("cannot write serve manifest: %s", e)
            return None

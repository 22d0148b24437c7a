"""`shifu serve` front end: a stdlib HTTP server and the in-process Scorer
(counterpart of `shifu_tpu/serve/server.py`).

  POST /score    {"records": [{col: value, ...}, ...]}, a list of
                 records, one bare record, JSONL (one record a line), or
                 the columnar binary wire (`Content-Type:
                 application/x-shifu-columnar`, serve/wire.py). Answer:
                 {"models": [...], "scores": [{"mean", "max", "min",
                 "median", "models"}, ...]}. 400 on a malformed body or
                 length (or a binary body past shifu.serve.wire.maxBodyMB),
                 415 on another Content-Type, 429 with Retry-After on
                 shed, 503 on shutdown or timeout. Error bodies are JSON.
  POST /score/<set>  one tenant of the model zoo (`zoo=`, serve/zoo.py;
                 `/score` is its first-registered set): 429 with
                 Retry-After while a cold tenant is admitted in the
                 background, 404 for an unknown set or a single-tenant
                 server.
  GET  /healthz  200 with the fleet's health, identity, the last drift
                 verdict, the peer processes and (zoo) the `zoo`
                 section; 503 while draining.
  GET  /metrics  the obs registry as Prometheus text (obs/metrics.py).
  GET  /admin/metrics.json  the lossless metrics snapshot a peer's fleet
                 collector merges (obs/fleetview.py).
  GET  /fleet/metrics, /fleet/healthz  every serve process under this
                 root merged: any process answers for the fleet.
  GET  /admin/traces  the retained request traces (obs/reqtrace.py) and
                 the ring's summary.
  GET  /admin/shadow  {"active": sha, "shadow": the staged candidate's
                 merged shadow evidence or null}.
  POST /admin/stage  {"modelsDir": DIR[, "set": SET]}: load + warm DIR
                 as the shadow on every replica (409 on a schema change
                 or a busy fleet); in a zoo streamed through its ledger.
  POST /admin/promote  {"sha": SHA[, "set": SET]}: rolling hot-swap of
                 the staged shadow (409 when SHA is not the staged one);
                 the sticky drift degrade clears and the drift monitor
                 resets.
  POST /admin/evict  {"set": SET}: evict a zoo tenant (409 mid-rollout,
                 with a staged shadow, or on a single-tenant server).
  POST /admin/coresident/{admit,charge,heartbeat,release}  the
                 co-resident trainer's grant plane (`HttpGrant`,
                 coresident/tenant.py) on the zoo's ledger as a
                 `priority=background` tenant: a charge that does not
                 fit answers 409 with the byte deficit (409 too without
                 --zoo), an unknown action or tenant 404.

The loop seams (loop/): with a ColumnConfig.json beside the models the
server builds a `DriftMonitor` whose fold rides every replica's scoring
program, and checks it every `shifu.loop.driftCheckBatches` batches
(past `shifu.loop.psiDegrade` /healthz degrades and a retrain
recommendation lands in the ledger); `shifu.loop.logSample` > 0 (the
CLI's `--traffic-log`) logs the served rows (`loop/traffic.py`). Both
run on the batcher's observer, after the batch's answers.

Request traces: an inbound `X-Shifu-Trace` header is honored (and forces
retention), otherwise a trace is kept under `shifu.trace.sample` head
sampling and `shifu.trace.slowMs` tail capture; the id is echoed in the
response header. `-Dshifu.obs.snapshotMs` arms the on-disk metrics time
series (obs/timeseries.py) under the process's lease id.

Every server holds a heartbeat lease under `.shifu/runs/peers/`
(serve/peers.py; `-Dshifu.lease.ttlMs=0` turns it off): the processes
serving one root see each other, a fleet-atomic `shifu promote` drives
stage, promote and rollback on each through it, and the lease id names
the process as traffic-log writer, drift reporter and time series.

HTTP handler threads parse and answer; they never touch a tensor: every
batch is scored on its replica's batcher thread. `Scorer.score_batch` is
the same admission -> batcher -> registry path without HTTP.

`ScoringServer.shutdown()` releases the lease, closes admission (new
requests get 503), the batchers drain every admitted request, the
listener stops, and the run ledger gets a `serve-<seq>.json` manifest
(with the zoo's ledger and the peer view) and the retained traces beside
it (`serve-<seq>.traces.json`, read by `shifu trace`).
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
from shifu_tpu_torch.serve.zoo import ColdStartError, load_set_configs
from shifu_tpu_torch.utils.errors import ShifuError
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
                 fleet: Optional[ReplicaFleet] = None,
                 extra_columns=None) -> None:
        if fleet is None:
            if registry is None:
                raise ValueError("Scorer needs a registry or a fleet")
            fleet = ReplicaFleet([ScoringReplica(
                registry, index=0, admission=admission,
                max_batch_rows=max_batch_rows, max_wait_ms=max_wait_ms,
                max_restarts=max_restarts, deadline_ms=deadline_ms,
                batching=batching)])
        self.fleet = fleet
        # label plumbing: raw columns (target/weight) that ride through
        # conversion and batching untouched by scoring, so the traffic
        # log keeps outcomes (absent fields log as the missing token)
        self.extra_columns = [c for c in (extra_columns or [])
                              if c not in fleet.input_columns]
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
                                          trace=trace,
                                          extra_columns=self.extra_columns)
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


class _HTTPServer(ThreadingHTTPServer):
    # the listen backlog: socketserver's default of 5 drops the SYNs of a
    # burst of new connections, which then wait a second to retry
    request_queue_size = 128
    daemon_threads = True


class ScoringServer:
    """Fleet (or model zoo) + Scorer + HTTP listener + heartbeat lease.
    `device=None` is the card. `zoo` ({name: model-set path}) serves N
    model sets on one budget (serve/zoo.py); the first-registered one
    doubles as this server's registry facade."""

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
        from shifu_tpu_torch.loop import (drift_check_batches_setting,
                                          log_sample_setting)
        from shifu_tpu_torch.loop.traffic import TrafficLog, traffic_columns

        self.root = os.path.abspath(root)
        # the process's id in the ledger, until the lease names it
        self.lease_id = ""
        self._observe_lock = tracked_lock("serve.server.observe")
        self._observed_batches = 0
        self._last_drift_verdict: Optional[dict] = None
        self._drift_check_every = max(1, drift_check_batches_setting())
        self.zoo = None
        self.traffic: Optional[TrafficLog] = None
        self.drift = None
        if zoo:
            # N model sets behind this server on one budget: per-tenant
            # drift, traffic streams and shadows live in the zoo; the
            # default (first-registered) tenant is the registry facade
            # (/healthz identity, peers, manifests)
            from shifu_tpu_torch.serve.zoo import ModelZoo

            self.zoo = ModelZoo(
                self.root, n_replicas=replicas, queue_depth=queue_depth,
                max_batch_rows=max_batch_rows, max_wait_ms=max_wait_ms,
                batching=batching, device=device)
            try:
                for name, set_path in zoo.items():
                    self.zoo.register(name, set_path)
                default = self.zoo.default_tenant
                # the default tenant must fit; later ones admit in
                # registration order into FREE budget only (evict=False:
                # only scored demand earns an eviction) and stay cold
                # past it
                self.zoo.ensure_resident(default)
                for name in list(zoo):
                    if name == default:
                        continue
                    try:
                        self.zoo.ensure_resident(name, evict=False)
                    except Exception as e:  # past-budget: stays cold
                        log.info("zoo: tenant %s stays cold at startup "
                                 "(%s)", name, e)
            except BaseException:
                self.zoo.close(5.0)
                raise
            tenant = self.zoo._get(default)
            self.column_configs = tenant.column_configs
            self.model_config = tenant.model_config
            self._registry = self.zoo.fleet_of(default)
            self._scorer = tenant.scorer
            self._finish_init(host, port)
            return
        # the set's configs give an Encog EG-text model its norm plan; a
        # models_dir outside a model set still serves without them
        if column_configs is None or model_config is None:
            ccs, mc = load_set_configs(self.root)
            column_configs = column_configs or ccs
            model_config = model_config or mc
        self.column_configs = column_configs
        self.model_config = model_config
        models_dir = models_dir or os.path.join(self.root, "models")
        # the drift baseline is the set's ColumnConfig (bins + counts),
        # over the columns the models read (serve/zoo.drift_monitor_for)
        from shifu_tpu_torch.serve.zoo import drift_monitor_for

        self.drift = drift_monitor_for(models_dir, column_configs,
                                       model_config)
        self._registry = ReplicaFleet.build(
            models_dir,
            n_replicas=replicas, device=device, queue_depth=queue_depth,
            max_batch_rows=max_batch_rows, max_wait_ms=max_wait_ms,
            batching=batching, column_configs=column_configs,
            model_config=model_config, drift=self.drift,
            observer=self._observe)
        input_columns = self._registry.input_columns
        # outcome columns (target/weight) ride the request conversion as
        # extra raw columns so label-joined traffic keeps them
        label_cols: List[str] = []
        if model_config is not None:
            for extra_col in (model_config.data_set.target_column_name,
                              model_config.data_set.weight_column_name):
                if (extra_col and extra_col not in label_cols
                        and extra_col not in input_columns):
                    label_cols.append(extra_col)
        if log_sample_setting() > 0.0:
            self.traffic = TrafficLog(self.root, traffic_columns(
                list(input_columns) + label_cols))
        self._scorer = Scorer(fleet=self._registry,
                              extra_columns=label_cols)
        self._finish_init(host, port)

    @property
    def registry(self) -> ReplicaFleet:
        """The default serving fleet. In a zoo the default tenant's fleet
        is looked up on every read: budget pressure may have evicted and
        re-admitted it, and a torn-down fleet would misreport (the last
        one stands while the tenant is cold)."""
        if self.zoo is not None:
            from shifu_tpu_torch.serve import zoo as zoo_mod

            tenant = self.zoo._get(self.zoo.default_tenant)
            if tenant.state == zoo_mod.RESIDENT and tenant.fleet is not None:
                self._registry = tenant.fleet
                self._scorer = tenant.scorer
        return self._registry

    @property
    def scorer(self) -> Scorer:
        """The default Scorer (looked up like `registry`)."""
        if self.zoo is not None:
            self.registry  # refreshes both
        return self._scorer

    def _finish_init(self, host: str, port: int) -> None:
        """The shared tail: HTTP listener, then the heartbeat lease (after
        the listener, so the lease advertises the bound port), then the
        lease id adopted as writer id and time-series name."""
        import socket

        from shifu_tpu_torch.obs.timeseries import MetricsSnapshotter
        from shifu_tpu_torch.serve.peers import PeerRegistry

        self.started_at = time.time()
        self._serve_thread: Optional[threading.Thread] = None
        self._shutdown_lock = tracked_lock("serve.server.shutdown")
        self.manifest_path: Optional[str] = None
        self._shutdown_started = False
        self._shutdown_done = threading.Event()
        try:
            self.httpd = _HTTPServer((host, port), self._handler_class())
        except BaseException:
            self._close_scoring(5.0)
            raise
        # N serve processes on one root see each other through their
        # leases; a fleet-atomic `shifu promote` drives stage, promote and
        # rollback here (off with -Dshifu.lease.ttlMs=0)
        self.peers = PeerRegistry(
            self.root,
            stage_cb=self.stage_candidate,
            promote_cb=self.promote_candidate,
            unstage_cb=self._unstage_default,
            info_cb=self._peer_info)
        self.lease_id = (self.peers.lease.lease_id if self.peers.enabled
                         else f"{socket.gethostname()}-{os.getpid()}-solo")
        # the fleet-shared traffic log: each process appends under its
        # lease id, never contending for a chunk sequence
        if self.traffic is not None:
            self.traffic.set_writer(self.lease_id)
        if self.zoo is not None:
            self.zoo.writer = self.lease_id
            for name in self.zoo.tenants():
                t = self.zoo._get(name)
                if t.traffic is not None:
                    t.traffic.set_writer(self.lease_id)
        # on-disk metrics time series (obs/timeseries.py), armed by
        # -Dshifu.obs.snapshotMs, under the lease id: a killed process
        # leaves its last windows for the survivors' /fleet views
        self.obs_snap = MetricsSnapshotter(self.root, self.lease_id,
                                           registry_cb=obs_registry)
        self.obs_snap.start()

    def _close_scoring(self, timeout: Optional[float]) -> None:
        if self.zoo is not None:
            # drains every resident tenant and flushes their traffic
            self.zoo.close(timeout)
        else:
            self.scorer.close(timeout)

    def _unstage_default(self) -> None:
        """An aborted round's rollback: in a zoo through the zoo, so the
        ledger's shadow charge and the tenant's staged flag roll back
        with the device state."""
        if self.zoo is not None:
            self.zoo.unstage(self.zoo.default_tenant)
        else:
            self.registry.unstage()

    def _peer_info(self) -> dict:
        """The health summary renewed into this process's lease file: a
        peer scan is a cheap fleet-of-processes health view."""
        fleet = self.registry
        info = {
            "port": self.port,
            "status": (self.zoo.fleet_health_snapshot()["status"]
                       if self.zoo is not None
                       else self.scorer.health.state),
            "sha": fleet.sha,
            "replicas": len(fleet.replicas),
            "queueDepth": sum(len(r.admission) for r in fleet.replicas),
        }
        if self.traffic is not None and self.traffic.writer:
            info["trafficWriter"] = self.traffic.writer
        return info

    # ---- the loop seams ----
    def _observe(self, replica, data, result) -> None:
        """Per-replica post-resolution observer: traffic log, shadow
        scoring and the cadenced drift verdict, on THAT replica's worker
        thread AFTER every request of the batch is answered; the traffic
        log and the drift monitor are fleet-wide (one log, one
        monitor)."""
        if self.traffic is not None:
            # the REPLICA's scored sha, not the fleet's: a promote
            # between the score and this observe must not re-attribute
            # the batch's logged rows
            self.traffic.record(data, result, replica.registry.scored_sha)
        replica.registry.observe(data, result)
        with self._observe_lock:
            self._observed_batches += 1
            check = (self.drift is not None
                     and self._observed_batches
                     % self._drift_check_every == 0)
        if check:
            # check_degrade returns the verdict it computed — one window
            # flush + PSI pass per cadence; outside the cadence lock (it
            # copies the window to the host)
            self._last_drift_verdict = self.drift.check_degrade(
                self.scorer.health, self.root,
                model_sha=self.registry.sha, reporter=self.lease_id)

    def stage_candidate(self, models_dir: str,
                        set_name: Optional[str] = None) -> dict:
        """Load + warm a candidate model set as the shadow version on
        EVERY replica (each onto its own device). In a zoo the stage is
        the tenant's (`set_name`, the default one when omitted), streamed
        through the budget ledger."""
        if self.zoo is not None:
            return self.zoo.stage(set_name or self.zoo.default_tenant,
                                  models_dir)
        return self.registry.stage(models_dir,
                                   column_configs=self.column_configs,
                                   model_config=self.model_config,
                                   drift=self.drift)

    def promote_candidate(self, expected_sha: Optional[str] = None,
                          set_name: Optional[str] = None) -> dict:
        """ROLLING hot-swap: the fleet promotes one replica at a time
        (requests keep flowing on the others), and each replica step
        stamps a sha-bound `swap-<seq>.json` audit manifest. Afterwards
        the sticky drift degrade clears — the recommendation was acted
        on — and the drift monitor resets, so drift on the NEW version's
        traffic re-degrades and re-recommends. `expected_sha` (from the
        gate evidence) must match the staged shadow on every replica, or
        the roll is refused before the first swap. In a zoo the promote
        is the tenant's, and the zoo moves the ledger's charge."""
        if self.zoo is not None:
            return self.zoo.promote(
                set_name or self.zoo.default_tenant, expected_sha,
                step_cb=self._write_swap_manifest)
        swap = self.registry.promote(expected_sha,
                                     step_cb=self._write_swap_manifest)
        self.scorer.health.clear_degraded()
        if self.drift is not None:
            self.drift.reset()
        self._last_drift_verdict = None
        return swap

    def _fleet_for(self, set_name: Optional[str] = None) -> ReplicaFleet:
        """The fleet whose trace and Retry-After surfaces a request uses:
        the named tenant's when resident, else the default one."""
        if self.zoo is None or not set_name:
            return self.registry
        try:
            return self.zoo.fleet_of(set_name)
        except (KeyError, ValueError):
            return self.registry

    def _write_swap_manifest(self, replica, step: dict) -> None:
        """One sha-bound audit manifest per replica promote step."""
        import sys

        from shifu_tpu_torch import obs
        from shifu_tpu_torch.obs.ledger import RunLedger

        ledger = RunLedger(self.root)
        seq = ledger.next_seq("swap")
        path = ledger.write(
            "swap", seq, status="ok", exit_status=0,
            started_at=time.time(), elapsed_seconds=0.0,
            argv=list(sys.argv), registry=obs.registry(),
            extra={"swap": dict(step,
                                fleetReplicas=len(self.registry.replicas))})
        log.info("promote step (replica %s) manifest -> %s",
                 replica.name, path)

    @property
    def host(self) -> str:
        return self.httpd.server_address[0]

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def health(self) -> dict:
        """The /healthz document: fleet health (in a zoo over the resident
        tenants: an evicted tenant's torn-down fleet does not drain the
        process), identity, load, the peers and the zoo section."""
        if self.zoo is not None:
            health = self.zoo.fleet_health_snapshot()
        else:
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
        # drift summary from the CACHED cadence verdict — a health probe
        # must never force a device copy
        v = self._last_drift_verdict
        if v is not None:
            health["drift"] = {
                "status": v["status"],
                "maxPsi": round(v["maxPsi"], 6),
                "driftedColumns": v["driftedColumns"],
                "threshold": v["threshold"],
            }
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
        # the process fleet: an expired peer is a computed degrade reason
        # (this process keeps serving; it clears when the lease is swept
        # or the peer comes back)
        if self.peers.enabled:
            health["peers"] = self.peers.snapshot()
            expired = self.peers.expired_peers()
            if expired and health["status"] == "ok":
                health["status"] = "degraded"
                health["reason"] = ("peer lease(s) expired: "
                                    + ", ".join(expired))
        if self.zoo is not None:
            # budget occupancy and tenant states; an admission in flight
            # is a non-sticky cold_start degrade
            z = self.zoo.health_snapshot()
            health["zoo"] = z
            if z["admitting"] and health["status"] == "ok":
                health["status"] = "degraded"
                health["reason"] = ("cold_start: warming tenant(s) "
                                    + ", ".join(z["admitting"]))
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
                if self.path == "/admin/metrics.json":
                    # the lossless snapshot (exact histogram state) a
                    # peer's fleet collector merges bucket for bucket
                    from shifu_tpu_torch.obs import fleetview

                    self._reply(200, {
                        "schema": fleetview.METRICS_JSON_SCHEMA,
                        "leaseId": server.lease_id,
                        "pid": os.getpid(),
                        "ts": time.time(),
                        "metrics": obs_registry().snapshot(),
                    })
                    return
                if self.path in ("/fleet/metrics", "/fleet/healthz"):
                    # any process answers for the fleet: live peers
                    # scraped, expired ones from their last on-disk
                    # window, folded in sorted lease-id order
                    from shifu_tpu_torch.obs import fleetview

                    reg, payload = fleetview.fleet_view(
                        server.root, self_id=server.lease_id,
                        self_snapshot=lambda: obs_registry().snapshot())
                    if self.path == "/fleet/metrics":
                        self._reply(
                            200, reg.to_prometheus().encode("utf-8"),
                            content_type=PROMETHEUS_CONTENT_TYPE)
                    else:
                        self._reply(200, payload)
                    return
                if (self.path == "/admin/shadow"
                        or self.path.startswith("/admin/shadow?")):
                    from urllib.parse import parse_qs, urlsplit

                    q = parse_qs(urlsplit(self.path).query)
                    set_name = (q.get("set") or [None])[0]
                    if set_name and server.zoo is None:
                        # answering the one shadow for ?set= would let
                        # promote --set gate on the wrong tenant's evidence
                        self._reply(409, {"error": "this server is "
                                                   "single-tenant "
                                                   "(no --zoo)"})
                        return
                    if set_name:
                        try:
                            fleet = server.zoo.fleet_of(set_name)
                        except (KeyError, ValueError) as e:
                            self._reply(404, {"error": str(e)})
                            return
                    else:
                        fleet = server.registry
                    self._reply(200, {"active": fleet.sha,
                                      "shadow": fleet.shadow_snapshot()})
                    return
                self._reply(404, {"error": f"unknown path {self.path}"})

            def do_POST(self):
                if self.path in ("/admin/stage", "/admin/promote",
                                 "/admin/evict"):
                    self._do_admin()
                    return
                if self.path.startswith("/admin/coresident/"):
                    self._do_coresident()
                    return
                # /score (single-tenant, or the zoo's default set) and
                # /score/<set> (one tenant of the zoo)
                set_name = None
                if self.path.startswith("/score/"):
                    set_name = self.path[len("/score/"):]
                elif self.path != "/score":
                    self._drain_body()
                    self._reply(404, {"error": f"unknown path {self.path}"})
                    return
                if server.zoo is not None:
                    set_name = set_name or server.zoo.default_tenant
                    if set_name not in server.zoo.tenants():
                        self._drain_body()
                        self._reply(404, {
                            "error": f"unknown model set {set_name!r}",
                            "sets": server.zoo.tenants()})
                        return
                elif set_name is not None:
                    self._drain_body()
                    self._reply(404, {
                        "error": "this server is single-tenant: POST "
                                 "/score (start with --zoo for per-set "
                                 "routes)"})
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
                fleet = server._fleet_for(set_name)
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
                    if server.zoo is not None:
                        res = server.zoo.score_batch(set_name, records,
                                                     trace=trace)
                    else:
                        res = server.scorer.score_batch(records,
                                                        trace=trace)
                except ColdStartError as e:
                    # a cold tenant: 429 now, with a Retry-After from the
                    # observed warm-up; the admission runs in the
                    # background. The tenant has no fleet, so the trace
                    # goes to the ring directly, not another tenant's
                    # stage histograms
                    if trace is not None:
                        trace.annotate(status="cold_start", tenant=set_name)
                        trace.finish()
                        reqtrace.buffer().offer(trace)
                        err_headers[reqtrace.TRACE_HEADER] = trace.trace_id
                    err_headers["Retry-After"] = str(
                        int(math.ceil(e.retry_after_s)))
                    self._reply(429, {
                        "error": str(e), "reason": e.reason,
                        "set": set_name,
                        "retryAfterSeconds": round(e.retry_after_s, 3)},
                        extra_headers=err_headers)
                    return
                except RejectedError as e:
                    _failed("rejected", reason=e.reason)
                    if e.reason == "closed":
                        self._reply(503, {"error": str(e),
                                          "reason": e.reason},
                                    extra_headers=err_headers)
                        return
                    hint = fleet.retry_after_seconds()
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
                # the tenant that scored names its models
                fleet = server._fleet_for(set_name)
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

            def _do_admin(self):
                """Rollout control plane: stage a candidate as the shadow
                version, promote the staged one (zero-downtime swap), or
                (zoo) evict a resident tenant. `shifu promote
                --serve-url` drives stage and promote; `set` picks the
                tenant (the zoo's default when omitted)."""
                try:
                    length = int(self.headers.get("Content-Length", "0"))
                    body = self.rfile.read(length) if length else b"{}"
                    doc = json.loads(body.decode("utf-8") or "{}")
                    if not isinstance(doc, dict):
                        raise ValueError("body must be a JSON object")
                except ValueError as e:
                    self._reply(400, {"error": f"bad request body: {e}"})
                    return
                set_name = doc.get("set") or None
                if set_name is not None and server.zoo is None:
                    self._reply(409, {"error": "this server is single-"
                                               "tenant (no --zoo)"})
                    return
                try:
                    if self.path == "/admin/evict":
                        if server.zoo is None:
                            self._reply(409, {"error": "eviction needs "
                                                       "zoo mode"})
                            return
                        if not set_name:
                            self._reply(400, {"error": "set required"})
                            return
                        server.zoo.evict(set_name, reason="admin")
                        self._reply(200, {
                            "evicted": set_name,
                            "zoo": server.zoo.health_snapshot()})
                        return
                    if self.path == "/admin/stage":
                        models_dir = doc.get("modelsDir")
                        if not models_dir:
                            self._reply(400,
                                        {"error": "modelsDir required"})
                            return
                        self._reply(200, {
                            "staged": server.stage_candidate(
                                models_dir, set_name=set_name)})
                        return
                    self._reply(200, server.promote_candidate(
                        doc.get("sha"), set_name=set_name))
                except KeyError as e:
                    self._reply(404, {"error": str(e)})
                except (ValueError, OSError, ShifuError) as e:
                    self._reply(409, {"error": str(e)})

            def _do_coresident(self):
                """The co-resident trainer's grant plane (HttpGrant,
                coresident/tenant.py): admit / charge / heartbeat /
                release against the zoo's HBM ledger as a
                `priority=background` tenant. A charge that does not
                fit answers 409 with the byte deficit — the trainer
                backs off; it NEVER evicts a serving tenant."""
                from shifu_tpu_torch.serve.zoo import LedgerFullError

                if server.zoo is None:
                    self._drain_body()
                    self._reply(409, {"error": "co-resident training "
                                               "needs zoo mode"})
                    return
                action = self.path[len("/admin/coresident/"):]
                try:
                    length = int(self.headers.get("Content-Length", "0"))
                    body = self.rfile.read(length) if length else b"{}"
                    doc = json.loads(body.decode("utf-8") or "{}")
                    if not isinstance(doc, dict):
                        raise ValueError("body must be a JSON object")
                except ValueError as e:
                    self._reply(400, {"error": f"bad request body: {e}"})
                    return
                tenant = doc.get("tenant") or ""
                zoo = server.zoo
                try:
                    if action == "admit":
                        self._reply(200, zoo.admit_background(
                            tenant, meta=doc.get("meta") or {}))
                    elif action == "charge":
                        nbytes = int(doc.get("bytes", 0))
                        if nbytes >= 0:
                            zoo.background_acquire(tenant, nbytes)
                        else:
                            zoo.background_reduce(tenant, -nbytes)
                        self._reply(200, {"charged": nbytes})
                    elif action == "heartbeat":
                        evicted = zoo.background_heartbeat(
                            tenant, int(doc.get("epoch", -1)))
                        self._reply(200, {"evicted": evicted})
                    elif action == "release":
                        zoo.background_release(
                            tenant, final=bool(doc.get("final")))
                        self._reply(200, {"released": tenant})
                    else:
                        self._reply(404, {
                            "error": f"unknown coresident action "
                                     f"{action!r}"})
                except LedgerFullError as e:
                    self._reply(409, {"error": str(e),
                                      "deficit": e.deficit})
                except KeyError as e:
                    self._reply(404, {"error": str(e)})
                except (ValueError, ShifuError) as e:
                    self._reply(409, {"error": str(e)})

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
            # the lease first: a draining process leaves the fleet
            # cleanly (file removed), it does not expire into a
            # survivor's degrade reason
            self.peers.close()
            snap = self.registry.snapshot()
            self._close_scoring(drain_timeout)
            if self._serve_thread is not None:  # serve_forever runs
                self.httpd.shutdown()
                self._serve_thread.join(5.0)
            self.httpd.server_close()
            if self.traffic is not None:
                # buffered rows become a final (short) chunk — nothing
                # logged is ever lost to shutdown
                self.traffic.close()
            # final time-series window AFTER the drain: the last chunk
            # carries the terminal counter state
            self.obs_snap.stop()
            if self.zoo is None:
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
            if self.zoo is not None:
                # the budget ledger and each tenant's detail: evictions,
                # cold starts and peak occupancy from the manifest alone
                extra["zoo"] = self.zoo.snapshot()
            san = sanitize.current()
            if san is not None and san.active:
                extra["sanitizer"] = san.verdict()
            if self.drift is not None:
                # final flush: the per-column PSI state of everything
                # this server served, with the live fold's slot counts
                extra["drift"] = dict(self.drift.verdict(),
                                      counts=self.drift.counts().tolist())
            if self.traffic is not None:
                extra["traffic"] = self.traffic.snapshot()
            if self.registry.slo.enabled:
                extra["slo"] = self.registry.slo.snapshot()
            if self.peers.enabled:
                # the last peer view before the lease went
                extra["peers"] = self.peers.snapshot()
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

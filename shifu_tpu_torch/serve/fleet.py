"""Replicated serving fleet: per-device scoring replicas behind a
drain-aware router (counterpart of `shifu_tpu/serve/fleet.py`).

  ScoringReplica    one device's scoring stack: a `ModelRegistry` whose
                    weights and constants live on THAT device, its own
                    admission queue, micro-batch worker, health and
                    circuit breaker. Replica `i` runs on
                    `cuda:(i % torch.cuda.device_count())`; replicas past
                    the card count share cards (and then their default
                    stream: correct, but serial). On `device="cpu"` every
                    replica shares the CPU.
  DrainAwareRouter  places each request on the replica with the lowest
                    expected wait (backlog / observed drain rate);
                    degraded replicas are penalized
                    (`shifu.serve.routerPenalty`), draining and
                    quarantined ones skipped, a full replica spills to
                    the next, ties rotate.
  ReplicaFleet      construction and the fleet contract: aggregate
                    health, fleet-wide Retry-After, failover of a failed
                    batch's requests to other replicas, drain on close,
                    and the rollout plane: every replica's registry is a
                    `loop/hotswap.SwappableRegistry`, so the fleet stages
                    a candidate on every replica, merges their shadow
                    evidence and promotes replica by replica.

Replica counts come from `shifu.serve.replicas` (0 = one per card).
Routing, failover and the replica count record `serve.router.*`,
`serve.failover.*` and `serve.replicas` in the obs registry;
`finish_trace` closes a request's trace into the bounded ring and the
`serve.stage_seconds{stage=,replica=}` histograms and counts it against
the SLO. The observer (the server's traffic log, shadow scoring and
drift checks) runs on each replica's batcher after the batch's answers.

The model zoo (serve/zoo.py) builds one fleet a tenant: `build(tenant=)`
puts `{"tenant": set}` on every label of the fleet's stack, `put_hook`
streams each replica's weight groups through the zoo's budget ledger
(`stage(put_hook=)` a candidate's), `cost_hook` re-prices a tenant after
a new row bucket, `memory_analysis()` sums the replicas' prices and
`release()` drops their tensors on eviction.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Callable, List, Optional, Sequence

import torch

from shifu_tpu_torch.analysis.racetrack import tracked_lock
from shifu_tpu_torch.data.reader import ColumnarData
from shifu_tpu_torch.eval.scorer import DEFAULT_SCORE_SCALE, ScoreResult
from shifu_tpu_torch.obs import registry, reqtrace
from shifu_tpu_torch.serve.batcher import (
    LATENCY_BUCKETS,
    RETRY_AFTER_MAX_S,
    RETRY_AFTER_MIN_S,
    MicroBatcher,
    ScoreRequest,
)
from shifu_tpu_torch.serve.health import (
    BREAKER_CLOSED,
    BREAKER_OPEN,
    DEGRADED,
    DRAINING,
    OK,
    CircuitBreaker,
    HealthMonitor,
    SloTracker,
)
from shifu_tpu_torch.serve.queue import AdmissionQueue, RejectedError
from shifu_tpu_torch.serve.registry import (
    ModelRegistry,
    pin_device,
    records_to_columnar,
)
from shifu_tpu_torch.serve import wire
from shifu_tpu_torch.utils import environment
from shifu_tpu_torch.utils.log import get_logger
from shifu_tpu_torch.utils.platform import DeviceLike

log = get_logger(__name__)

DEFAULT_ROUTER_PENALTY = 4.0
DEFAULT_FAILOVER_MAX = 2

def replicas_setting() -> int:
    """shifu.serve.replicas: scoring replicas (0 = one per card)."""
    return environment.get_int("shifu.serve.replicas", 0)


def failover_max_setting() -> int:
    """shifu.serve.breaker.failoverMax: replays of one request on other
    replicas after its batch failed, before it gets the error."""
    return environment.get_int("shifu.serve.breaker.failoverMax",
                               DEFAULT_FAILOVER_MAX)


def router_penalty_setting() -> float:
    """shifu.serve.routerPenalty: the expected-wait multiplier of
    degraded replicas."""
    return environment.get_float("shifu.serve.routerPenalty",
                                 DEFAULT_ROUTER_PENALTY)


def replica_devices(n_replicas: Optional[int],
                    device: DeviceLike = None) -> List[torch.device]:
    """The device of each replica. `n_replicas` None reads
    shifu.serve.replicas; 0 means one replica per card (one on the CPU).
    On cuda without an index, replica i takes card i % count."""
    dev = pin_device(device)
    n = n_replicas if n_replicas is not None else replicas_setting()
    n = int(n) if n and int(n) > 0 else 0
    if dev.type != "cuda" or (device is not None and str(device) != "cuda"):
        return [dev] * max(n, 1)  # the CPU, or one named card
    ndev = torch.cuda.device_count()
    return [torch.device("cuda", i % ndev) for i in range(n or ndev)]


class ScoringReplica:
    """One device's scoring stack (registry, queue, batcher, health,
    breaker), named `replica=<i>`."""

    def __init__(self, registry, index: int = 0,
                 admission: Optional[AdmissionQueue] = None,
                 max_batch_rows: Optional[int] = None,
                 max_wait_ms: Optional[float] = None,
                 max_restarts: Optional[int] = None,
                 deadline_ms: Optional[float] = None,
                 batching: Optional[str] = None,
                 queue_depth: Optional[int] = None,
                 observer: Optional[Callable] = None,
                 labels: Optional[dict] = None) -> None:
        self.index = int(index)
        self.name = str(self.index)
        # extra identity labels (the zoo's {"tenant": set}) ride under the
        # replica label on every serve.* series of this replica's stack
        self.labels = {**dict(labels or {}), "replica": self.name}
        self.registry = registry
        self.device = getattr(registry, "device", None)
        self.admission = (AdmissionQueue(queue_depth, labels=self.labels)
                          if admission is None else admission)
        self.health = HealthMonitor(labels=self.labels)
        self.breaker = CircuitBreaker(labels=self.labels)
        batch_observer = None
        if observer is not None:
            # the fleet observer wants to know WHICH replica resolved the
            # batch (its scored sha stamps the traffic log)
            def batch_observer(data, result, _rep=self):
                observer(_rep, data, result)
        self.batcher = MicroBatcher(
            registry.score_raw, self.admission,
            max_batch_rows=max_batch_rows, max_wait_ms=max_wait_ms,
            health=self.health, max_restarts=max_restarts,
            deadline_ms=deadline_ms, batching=batching,
            breaker=self.breaker, replica=self.index,
            observer=batch_observer, labels=labels)

    def snapshot(self) -> dict:
        snap = {
            "replica": self.name,
            **self.registry.snapshot(),
            "health": self.health.snapshot(),
            "breaker": self.breaker.snapshot(),
            "queue": self.admission.snapshot(),
            "batcher": self.batcher.snapshot(),
            "queueDepth": len(self.admission),
            "workerRestarts": self.batcher.restarts,
        }
        if self.device is not None:
            snap["device"] = str(self.device)
        return snap


class DrainAwareRouter:
    """Place each request on the replica that will dispatch it soonest:
    skip draining and quarantined replicas, rank the rest by expected
    wait (degraded ones times `penalty`), a breaker due for its probe
    first, ties round-robin. A full replica spills to the next; only
    when every one sheds does the caller see the rejection."""

    def __init__(self, replicas: Sequence[ScoringReplica],
                 penalty: Optional[float] = None) -> None:
        self.replicas = list(replicas)
        self.penalty = (router_penalty_setting() if penalty is None
                        else float(penalty))
        self._lock = tracked_lock("serve.router")
        self._rr = 0
        self.routed = 0
        self.spilled = 0
        self.rerouted = 0

    def order(self, exclude: Optional[ScoringReplica] = None
              ) -> List[ScoringReplica]:
        """Routable replicas, best placement first."""
        now = time.perf_counter()
        mono = time.monotonic()
        with self._lock:
            rr = self._rr
            self._rr += 1
        n = max(1, len(self.replicas))
        ranked = []
        for rep in self.replicas:
            if rep is exclude:
                continue  # failover never replays onto the failing one
            state = rep.health.state
            if state == DRAINING:
                continue
            if not rep.breaker.routable(mono):
                continue  # quarantined: absent
            probe = rep.breaker.probe_due(mono)
            wait = rep.batcher.expected_wait(now)
            if state == DEGRADED:
                # the +epsilon keeps an idle degraded replica behind idle
                # healthy ones
                wait = (wait + 1e-3) * self.penalty
            ranked.append((0 if probe else 1, wait,
                           (rep.index - rr) % n, rep))
        ranked.sort(key=lambda t: (t[0], t[1], t[2]))
        return [t[3] for t in ranked]

    def _place(self, rep: ScoringReplica, req: ScoreRequest) -> bool:
        """One placement under the replica's breaker grant (raises
        RejectedError on shed)."""
        grant = rep.breaker.admit()
        if grant is None:
            return False  # tripped between order() and here
        try:
            rep.admission.put(req)
        except RejectedError:
            rep.breaker.cancel(grant)  # the probe never dispatched
            raise
        return True

    def submit(self, data: ColumnarData, trace=None) -> ScoreRequest:
        """Admit one request on the best replica, spilling past full
        ones; RejectedError when none takes it."""
        order = self.order()
        if not order:
            raise RejectedError("closed")
        reg = registry()
        last: Optional[RejectedError] = None
        for i, rep in enumerate(order):
            req = ScoreRequest(data,
                               deadline_s=rep.batcher.deadline_s or None,
                               trace=trace)
            try:
                if not self._place(rep, req):
                    continue
            except RejectedError as e:
                last = e
                if i == 0:
                    # the PLANNED placement shed: everything after is a
                    # drain-around
                    self.spilled += 1
                    reg.counter("serve.router.spill", **rep.labels).inc()
                continue
            self.routed += 1
            reg.counter("serve.router.routed", **rep.labels).inc()
            if trace is not None:
                trace.annotate(replica=rep.name, spilled=bool(i))
            return req
        raise last if last is not None else RejectedError("closed")

    def resubmit(self, req: ScoreRequest,
                 exclude: Optional[ScoringReplica] = None) -> bool:
        """Failover: the same admitted request (the same completion
        event) re-enters another replica's queue. False when none could
        take it."""
        for rep in self.order(exclude=exclude):
            try:
                if not self._place(rep, req):
                    continue
            except RejectedError:
                continue
            self.rerouted += 1
            registry().counter("serve.failover.rerouted",
                               **rep.labels).inc()
            if req.trace is not None:
                req.trace.annotate(failovers=req.failovers,
                                   replica=rep.name)
            return True
        return False


class ReplicaFleet:
    """N scoring replicas, the router and the fleet contract; also the
    registry facade the server reads (`sha`, `model_names`, `fused`,
    `input_columns`, `score_records`, `warm`, `snapshot`)."""

    def __init__(self, replicas: Sequence[ScoringReplica],
                 labels: Optional[dict] = None) -> None:
        if not replicas:
            raise ValueError("a fleet needs at least one replica")
        self.replicas = list(replicas)
        self.router = DrainAwareRouter(self.replicas)
        # fleet identity labels ({"tenant": set} in a zoo) ride the
        # fleet-level series (serve.replicas, SLO, stage histograms)
        self.labels = dict(labels or {})
        # fleet-level health (shutdown); per-replica crash state lives on
        # each replica's monitor and rolls up in health_snapshot()
        self.health = HealthMonitor()
        self.slo = SloTracker(labels=self.labels)
        self.failover_max = failover_max_setting()
        self.failovers = 0
        self.failovers_exhausted = 0
        # one rollout operation (stage / unstage / promote) at a time
        self._ctl_lock = tracked_lock("serve.fleet.control")
        self._ctl_busy: Optional[str] = None
        for rep in self.replicas:
            rep.batcher.failover = (
                lambda req, error, _src=rep:
                self._failover(_src, req, error))
        registry().gauge("serve.replicas", **self.labels).set(
            len(self.replicas))

    def _failover(self, src: ScoringReplica, req: ScoreRequest,
                  error: BaseException) -> None:
        """Replay a failed batch's request on another replica, or answer
        it with the error once its budget is spent."""
        reg = registry()
        if req.failovers >= self.failover_max or len(self.replicas) < 2:
            if req.failovers:
                self.failovers_exhausted += 1
                reg.counter("serve.failover.exhausted", **src.labels).inc()
            req.fail(error)
            return
        req.failovers += 1
        self.failovers += 1
        reg.counter("serve.failover.requests", **src.labels).inc()
        if req.trace is not None:
            # the hop is a stage on the request's own trace
            with req.trace.stage("failover"):
                req.trace.annotate(failoverFrom=src.name,
                                   failoverError=type(error).__name__)
                rerouted = self.router.resubmit(req, exclude=src)
        else:
            rerouted = self.router.resubmit(req, exclude=src)
        if not rerouted:
            self.failovers_exhausted += 1
            reg.counter("serve.failover.exhausted", **src.labels).inc()
            req.fail(error)

    # ---- construction ----
    @classmethod
    def build(cls, models_dir: str, n_replicas: Optional[int] = None,
              scale: float = DEFAULT_SCORE_SCALE,
              device: DeviceLike = None,
              queue_depth: Optional[int] = None,
              max_batch_rows: Optional[int] = None,
              max_wait_ms: Optional[float] = None,
              max_restarts: Optional[int] = None,
              deadline_ms: Optional[float] = None,
              batching: Optional[str] = None,
              drift=None, column_configs=None,
              model_config=None,
              observer: Optional[Callable] = None,
              tenant: Optional[str] = None,
              put_hook=None, cost_hook=None) -> "ReplicaFleet":
        """One replica per card (see `replica_devices`), each with the
        model set on its own device behind a SwappableRegistry.
        `device=None` is the card; `drift` (one monitor) folds every
        replica's batches; `observer(replica, data, result)` runs after
        each batch's answers. `tenant` labels every series of the
        fleet's stack; `put_hook` and `cost_hook` are the zoo's ledger
        seams (serve/registry.py)."""
        from shifu_tpu_torch.loop.hotswap import SwappableRegistry

        devices = replica_devices(n_replicas, device)
        extra = {"tenant": tenant} if tenant else {}
        replicas: List[ScoringReplica] = []
        try:
            for i, dev in enumerate(devices):
                labels = {**extra, "replica": str(i)}
                reg = ModelRegistry(models_dir, scale=scale, device=dev,
                                    column_configs=column_configs,
                                    model_config=model_config,
                                    drift=drift, labels=labels,
                                    put_hook=put_hook)
                reg.cost_hook = cost_hook
                replicas.append(ScoringReplica(
                    SwappableRegistry(reg, labels=labels), index=i,
                    queue_depth=queue_depth,
                    max_batch_rows=max_batch_rows,
                    max_wait_ms=max_wait_ms, max_restarts=max_restarts,
                    deadline_ms=deadline_ms, batching=batching,
                    observer=observer, labels=extra))
        except BaseException:
            # a later replica failing (the zoo's budget refusing a group)
            # must not leak the earlier ones' worker threads or tensors:
            # the caller releases its ledger charge on this exception
            for rep in replicas:
                rep.admission.close()
                rep.batcher.join(1.0)
                rep.registry.release()
            raise
        log.info("serving fleet%s: %d replica(s) over %d device(s)",
                 f" (tenant {tenant})" if tenant else "", len(replicas),
                 len(set(devices)))
        return cls(replicas, labels=extra)

    def __len__(self) -> int:
        return len(self.replicas)

    # ---- scoring ----
    def submit(self, data: ColumnarData, trace=None) -> ScoreRequest:
        return self.router.submit(data, trace=trace)

    def score_batch(self, records, timeout: Optional[float] = None,
                    trace=None,
                    extra_columns: Optional[Sequence[str]] = None
                    ) -> ScoreResult:
        """Routed scoring of raw records: a list of dicts (the JSON path)
        or a decoded binary batch, which only conforms to the schema.
        `extra_columns` (the label columns the traffic log keeps) ride
        through untouched by scoring. A `trace`
        (obs/reqtrace.RequestTrace) rides through record conversion
        (featurize), placement (route) and the batcher stages; the
        CALLER finishes it (`finish_trace`)."""
        cols = list(self.input_columns) + [
            c for c in (extra_columns or []) if c not in self.input_columns]

        def featurize():
            if isinstance(records, ColumnarData):
                return wire.conform_columns(records, cols)
            return records_to_columnar(records, cols)

        if trace is None:
            return self.submit(featurize()).wait(timeout)
        with trace.stage("featurize"):
            data = featurize()
        trace.annotate(rows=data.n_rows)
        t0 = time.perf_counter()
        req = self.submit(data, trace=trace)
        trace.add_stage("route", time.perf_counter() - t0, t0=t0)
        return req.wait(timeout)

    # ---- request tracing / SLO ----
    def finish_trace(self, trace) -> bool:
        """Close one request's trace: offer it to the bounded ring
        (obs/reqtrace.buffer — head-sampled or slow-captured), feed the
        per-stage `serve.stage_seconds{stage=,replica=}` histograms
        (retained traces ride along as bucket exemplars) and count the
        request against the SLO. Returns True when the trace was
        retained."""
        total = trace.finish()
        kept = reqtrace.buffer().offer(trace)
        reg = registry()
        # a request shed before placement has no replica
        replica = str(trace.attrs.get("replica", "unrouted"))
        exemplar = trace.trace_id if kept else None
        for stage, dur in trace.stage_totals().items():
            reg.histogram("serve.stage_seconds", buckets=LATENCY_BUCKETS,
                          stage=stage, replica=replica,
                          **self.labels).observe(dur, exemplar=exemplar)
        # `status` is set only by the error paths: such a request got no
        # score, so it counts BAD whatever its latency
        self.slo.observe(total,
                         ok=False if "status" in trace.attrs else None)
        return kept

    # ---- registry facade (replica 0 is the canonical read) ----
    @property
    def sha(self) -> str:
        return self.replicas[0].registry.sha

    @property
    def model_names(self) -> List[str]:
        return self.replicas[0].registry.model_names

    @property
    def fused(self) -> bool:
        return self.replicas[0].registry.fused

    @property
    def input_columns(self) -> List[str]:
        return self.replicas[0].registry.input_columns

    @property
    def active_models_dir(self) -> str:
        """Dir of the version serving now (replica 0; the pre-roll sha
        check keeps the replicas on one version): what an evicting zoo
        remembers so re-admission rebuilds the promoted set."""
        return self.replicas[0].registry.active_models_dir

    def score_raw(self, data: ColumnarData) -> ScoreResult:
        """Routed scoring of one raw batch (blocks for the result)."""
        return self.submit(data).wait()

    def score_records(self, records: Sequence[dict]) -> ScoreResult:
        """Direct scoring on replica 0, not routed: the parity path."""
        return self.replicas[0].registry.score_records(records)

    def warm(self, batch_sizes: Sequence[int]) -> List[int]:
        """Warm the buckets on every replica."""
        warmed: List[int] = []
        for rep in self.replicas:
            warmed = rep.registry.warm(batch_sizes)
        return warmed

    # ---- health ----
    def health_snapshot(self) -> dict:
        """Aggregate health: one degraded replica degrades the fleet with
        the replica named; all draining (or shutdown) is draining."""
        fleet = self.health.snapshot()
        per = []
        for rep in self.replicas:
            s = rep.health.snapshot()
            s.update({"replica": rep.name,
                      "sha": rep.registry.sha,
                      "breaker": rep.breaker.snapshot(),
                      "queueDepth": len(rep.admission),
                      "workerRestarts": rep.batcher.restarts})
            if s["breaker"]["state"] != BREAKER_CLOSED and s["status"] == OK:
                s["status"] = DEGRADED
                s["reason"] = (s.get("reason")
                               or f"breaker {s['breaker']['state']}")
            per.append(s)
        bad = [p for p in per if p["status"] != OK]
        if (fleet["status"] == DRAINING
                or all(p["status"] == DRAINING for p in per)):
            status = DRAINING
            reason = fleet["reason"] or "all replicas draining"
        elif fleet["status"] == DEGRADED:
            status, reason = DEGRADED, fleet["reason"]
        elif bad:
            status = DEGRADED
            reason = "; ".join(
                f"replica {p['replica']} {p['status']}"
                + (f": {p['reason']}" if p.get("reason") else "")
                for p in bad)
        else:
            status, reason = OK, ""
        return {
            "status": status,
            "reason": reason,
            "workerCrashes": sum(p["workerCrashes"] for p in per),
            "replicas": per,
        }

    def retry_after_seconds(self) -> float:
        """Fleet Retry-After: total backlog over the summed drain rates
        of the replicas whose breaker is not open, clamped."""
        now = time.perf_counter()
        depth_total = 0
        rate_total = 0.0
        rated = False
        for rep in self.replicas:
            if rep.breaker.state == BREAKER_OPEN:
                continue
            depth, rate = rep.batcher.drain_stats(now)
            depth_total += depth
            if rate is not None:
                rate_total += rate
                rated = True
        hint = (depth_total / max(rate_total, 1e-3) if rated
                else RETRY_AFTER_MIN_S)
        return min(max(hint, RETRY_AFTER_MIN_S), RETRY_AFTER_MAX_S)

    # ---- rollout: stage / shadow evidence / rolling promote ----
    @contextmanager
    def _control(self, op: str):
        with self._ctl_lock:
            if self._ctl_busy is not None:
                raise ValueError(
                    f"fleet {self._ctl_busy} in progress — retry when "
                    "it completes")
            self._ctl_busy = op
        try:
            yield
        finally:
            with self._ctl_lock:
                self._ctl_busy = None

    def stage(self, models_dir: str, column_configs=None,
              model_config=None, drift=None,
              put_hook=None) -> Optional[dict]:
        """Stage + warm the candidate as the shadow on EVERY replica
        (each loads it onto its own device). Returns the merged shadow
        snapshot. Refused while another rollout operation is in
        flight. `put_hook` streams the candidate's weight groups through
        the zoo's ledger (SwappableRegistry.stage)."""
        with self._control("stage"):
            staged = [rep.registry.stage(models_dir,
                                         column_configs=column_configs,
                                         model_config=model_config,
                                         drift=drift, put_hook=put_hook)
                      for rep in self.replicas]
            shas = {st["sha"] for st in staged}
            if len(shas) != 1:  # same dir: only a mid-stage redeploy
                raise ValueError(
                    f"staged shadow shas diverge across replicas "
                    f"({shas}) — the candidate dir changed mid-stage; "
                    "re-stage")
            return self.shadow_snapshot()

    def unstage(self) -> None:
        with self._control("unstage"):
            for rep in self.replicas:
                rep.registry.unstage()

    def shadow_snapshot(self) -> Optional[dict]:
        """Fleet shadow evidence: the replicas' ShadowStats summed on the
        host in replica order (additive counts sum, maxAbsDelta takes
        the max), so `shifu promote`'s gates read one fleet-wide
        agreement rate, and the replicas' score-delta histograms merged
        bucket for bucket. None until every replica has a staged
        shadow."""
        per = [rep.registry.shadow_snapshot() for rep in self.replicas]
        if any(p is None for p in per):
            return None
        if len(per) == 1:
            agg = dict(per[0], replicas=per)
        else:
            agg = _reduce_shadow_stats(per)
            agg.update({
                "sha": per[0]["sha"],
                "models": per[0]["models"],
                "fused": per[0]["fused"],
                "tolerance": per[0]["tolerance"],
                "replicas": per,
            })
        delta = _merged_delta_histogram(self.replicas)
        if delta.quantile(0.5) is not None:
            agg["deltaHistogram"] = delta.as_dict()
            agg["deltaP50"] = delta.quantile(0.50)
            agg["deltaP99"] = delta.quantile(0.99)
        return agg

    def promote(self, expected_sha: Optional[str] = None,
                step_cb: Optional[Callable] = None) -> dict:
        """ROLLING promote: replicas flip shadow -> active ONE AT A TIME,
        each swap atomic under its replica's lock (the in-flight batch
        finishes on the old version, the next gathered batch scores on
        the new). The staged sha is validated across ALL replicas (and
        against `expected_sha`, the sha the caller's gate evidence
        described) BEFORE the first swap, so a refusal always happens
        with ZERO replicas swapped. `step_cb(replica, step)` fires after
        each replica's swap."""
        with self._control("promote"):
            staged = [rep.registry.shadow_snapshot()
                      for rep in self.replicas]
            missing = [rep.name for rep, st in zip(self.replicas, staged)
                       if st is None]
            if missing:
                raise ValueError("no staged candidate on replica(s) "
                                 + ",".join(missing))
            shas = {st["sha"] for st in staged}
            if len(shas) != 1:
                raise ValueError(
                    f"staged shadow shas diverge across replicas "
                    f"({shas}); re-stage before promoting")
            sha = shas.pop()
            if expected_sha and sha != expected_sha:
                raise ValueError(
                    f"staged shadow is {sha}, not the gated candidate "
                    f"{expected_sha} — it was re-staged since the gates "
                    "evaluated; re-run the gate on the current shadow")
            shadow = self.shadow_snapshot()
            steps = []
            for rep in self.replicas:
                swap = rep.registry.promote(expected_sha)
                step = {"replica": rep.name, **swap}
                steps.append(step)
                registry().counter("serve.swap.steps", **rep.labels).inc()
                if step_cb is not None:
                    try:
                        step_cb(rep, step)
                    except Exception as e:  # audit trouble must not
                        # stop the roll half-way
                        log.warning("promote step callback failed on "
                                    "replica %s: %s", rep.name, e)
            return {"from": steps[0]["from"], "to": sha,
                    "replicas": len(steps), "steps": steps,
                    "shadow": shadow}

    def memory_analysis(self) -> dict:
        """The fleet's residency price: each replica's registry
        `memory_analysis` (active and staged shadow), summed: the budget
        bounds the deployment's total."""
        per = []
        total = 0
        for rep in self.replicas:
            m = rep.registry.memory_analysis()
            per.append({"replica": rep.name, **m})
            total += int(m.get("residentBytes", 0))
        return {"replicas": per, "residentBytes": total}

    def release(self) -> int:
        """Eviction seam (zoo): release every replica's registries, their
        device tensors dropped. Call after close()."""
        return sum(rep.registry.release() for rep in self.replicas)

    def snapshot(self) -> dict:
        """Replica 0's registry view, every replica's stack, the router
        and failover counts."""
        snap = self.replicas[0].registry.snapshot()
        snap.update({
            "replicas": [rep.snapshot() for rep in self.replicas],
            "replicaCount": len(self.replicas),
            "router": {"routed": self.router.routed,
                       "spilled": self.router.spilled,
                       "rerouted": self.router.rerouted},
            "failovers": self.failovers,
            "failoversExhausted": self.failovers_exhausted,
        })
        return snap

    # ---- lifecycle ----
    def close(self, timeout: Optional[float] = 30.0) -> None:
        """Stop admitting fleet-wide and drain every replica."""
        self.health.set_draining("shutdown")
        for rep in self.replicas:
            rep.health.set_draining("shutdown")
            rep.admission.close()
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        for rep in self.replicas:
            remaining = (None if deadline is None
                         else max(0.0, deadline - time.monotonic()))
            rep.batcher.join(remaining)


def _merged_delta_histogram(replicas: Sequence[ScoringReplica]):
    """Every replica's staged-shadow score-delta histogram folded into one
    fleet histogram (the registry's exact bucket merge)."""
    from shifu_tpu_torch.loop.hotswap import SCORE_DELTA_BUCKETS
    from shifu_tpu_torch.obs.metrics import Histogram

    reg = registry()
    merged = Histogram(SCORE_DELTA_BUCKETS)
    for rep in replicas:
        merged.merge(reg.histogram("serve.shadow.score_delta",
                                   buckets=SCORE_DELTA_BUCKETS,
                                   **rep.labels))
    return merged


def _reduce_shadow_stats(per: List[dict]) -> dict:
    """The replicas' shadow stats summed in replica order, in f64 (the
    JAX package's one psum / pmax over the fleet mesh)."""
    batches = rows = agree = errors = 0
    sum_abs = 0.0
    max_abs = 0.0
    for p in per:
        batches += p["batches"]
        rows += p["rows"]
        agree += p["agreeRows"]
        errors += p["errors"]
        sum_abs += p["meanAbsDelta"] * p["rows"]
        max_abs = max(max_abs, p["maxAbsDelta"])
    rows_div = float(max(rows, 1))
    return {
        "batches": int(batches),
        "rows": int(rows),
        "agreeRows": int(agree),
        "errors": int(errors),
        "agreement": (agree / rows_div if rows else 0.0),
        "meanAbsDelta": (sum_abs / rows_div if rows else 0.0),
        "maxAbsDelta": float(max_abs),
    }

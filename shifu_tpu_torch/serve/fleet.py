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
                    batch's requests to other replicas, drain on close.

Replica counts come from `shifu.serve.replicas` (0 = one per card).
What waits for ROADMAP A.14: the hot-swap wrapper around each registry
(`loop/hotswap.SwappableRegistry`) and with it stage / unstage / promote
and the shadow evidence, the traffic log and drift observers, the model
zoo's hooks and the obs metrics.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional, Sequence

import torch

from shifu_tpu_torch.data.reader import ColumnarData
from shifu_tpu_torch.eval.scorer import DEFAULT_SCORE_SCALE, ScoreResult
from shifu_tpu_torch.serve.batcher import (
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

_WAITS = "ROADMAP A.14"


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
                 queue_depth: Optional[int] = None) -> None:
        self.index = int(index)
        self.name = str(self.index)
        self.registry = registry
        self.device = getattr(registry, "device", None)
        self.admission = (AdmissionQueue(queue_depth)
                          if admission is None else admission)
        self.health = HealthMonitor()
        self.breaker = CircuitBreaker()
        self.batcher = MicroBatcher(
            registry.score_raw, self.admission,
            max_batch_rows=max_batch_rows, max_wait_ms=max_wait_ms,
            health=self.health, max_restarts=max_restarts,
            deadline_ms=deadline_ms, batching=batching,
            breaker=self.breaker, replica=self.index)

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
        self._lock = threading.Lock()
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

    def submit(self, data: ColumnarData) -> ScoreRequest:
        """Admit one request on the best replica, spilling past full
        ones; RejectedError when none takes it."""
        order = self.order()
        if not order:
            raise RejectedError("closed")
        last: Optional[RejectedError] = None
        for i, rep in enumerate(order):
            req = ScoreRequest(data,
                               deadline_s=rep.batcher.deadline_s or None)
            try:
                if not self._place(rep, req):
                    continue
            except RejectedError as e:
                last = e
                if i == 0:
                    self.spilled += 1
                continue
            self.routed += 1
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
            return True
        return False


class ReplicaFleet:
    """N scoring replicas, the router and the fleet contract; also the
    registry facade the server reads (`sha`, `model_names`, `fused`,
    `input_columns`, `score_records`, `warm`, `snapshot`)."""

    def __init__(self, replicas: Sequence[ScoringReplica]) -> None:
        if not replicas:
            raise ValueError("a fleet needs at least one replica")
        self.replicas = list(replicas)
        self.router = DrainAwareRouter(self.replicas)
        # fleet-level health (shutdown); per-replica crash state lives on
        # each replica's monitor and rolls up in health_snapshot()
        self.health = HealthMonitor()
        self.slo = SloTracker()
        self.failover_max = failover_max_setting()
        self.failovers = 0
        self.failovers_exhausted = 0
        for rep in self.replicas:
            rep.batcher.failover = (
                lambda req, error, _src=rep:
                self._failover(_src, req, error))

    def _failover(self, src: ScoringReplica, req: ScoreRequest,
                  error: BaseException) -> None:
        """Replay a failed batch's request on another replica, or answer
        it with the error once its budget is spent."""
        if req.failovers >= self.failover_max or len(self.replicas) < 2:
            if req.failovers:
                self.failovers_exhausted += 1
            req.fail(error)
            return
        req.failovers += 1
        self.failovers += 1
        if not self.router.resubmit(req, exclude=src):
            self.failovers_exhausted += 1
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
              model_config=None) -> "ReplicaFleet":
        """One replica per card (see `replica_devices`), each with the
        model set on its own device. `device=None` is the card."""
        if drift is not None:
            raise NotImplementedError(
                "the serving drift monitor is not ported yet: " + _WAITS)
        devices = replica_devices(n_replicas, device)
        replicas: List[ScoringReplica] = []
        try:
            for i, dev in enumerate(devices):
                reg = ModelRegistry(models_dir, scale=scale, device=dev,
                                    column_configs=column_configs,
                                    model_config=model_config)
                replicas.append(ScoringReplica(
                    reg, index=i, queue_depth=queue_depth,
                    max_batch_rows=max_batch_rows,
                    max_wait_ms=max_wait_ms, max_restarts=max_restarts,
                    deadline_ms=deadline_ms, batching=batching))
        except BaseException:
            # a later replica failing must not leak the earlier ones'
            # worker threads
            for rep in replicas:
                rep.admission.close()
                rep.batcher.join(1.0)
            raise
        log.info("serving fleet: %d replica(s) over %d device(s)",
                 len(replicas), len(set(devices)))
        return cls(replicas)

    def __len__(self) -> int:
        return len(self.replicas)

    # ---- scoring ----
    def submit(self, data: ColumnarData) -> ScoreRequest:
        return self.router.submit(data)

    def score_batch(self, records, timeout: Optional[float] = None
                    ) -> ScoreResult:
        """Routed scoring of raw records: a list of dicts (the JSON path)
        or a decoded binary batch, which only conforms to the schema."""
        cols = list(self.input_columns)
        if isinstance(records, ColumnarData):
            data = wire.conform_columns(records, cols)
        else:
            data = records_to_columnar(records, cols)
        return self.submit(data).wait(timeout)

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

    # ---- what waits ----
    def stage(self, *args, **kwargs):
        raise NotImplementedError(
            "staging a shadow model set (loop/hotswap.py) is not ported "
            "yet: " + _WAITS)

    unstage = promote = shadow_snapshot = stage

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

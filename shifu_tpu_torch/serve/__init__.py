"""shifu_tpu_torch.serve: online scoring on the card (counterpart of
`shifu_tpu/serve/`).

A model registry that loads a model set once and scores raw records in
one fused program of torch ops (registry.py), a micro-batcher with
continuous or barrier batching into power-of-two row buckets
(batcher.py), a bounded admission queue that sheds explicitly
(queue.py), health, circuit breaker and SLO state (health.py), a fleet of
per-card replicas behind a drain-aware router (fleet.py), the columnar
binary wire format (wire.py), a stdlib HTTP front end with the
in-process Scorer (server.py), the multi-tenant model zoo on one
device-memory budget (zoo.py) and the heartbeat leases that make N serve
processes on one root a fleet (peers.py).

    from shifu_tpu_torch.serve import ScoringServer

    server = ScoringServer(root=".", device="cpu")  # models/ of the set
    server.start()                                  # POST /score, /healthz
    ...
    server.shutdown()                               # drain, then stop

Knobs (-Dk=v properties): shifu.serve.replicas (0 = one per card),
shifu.serve.batching (continuous | barrier), shifu.serve.queueDepth (a
replica's admission depth, 128), shifu.serve.maxBatchRows (1024),
shifu.serve.maxWaitMs (barrier window, 2.0), shifu.serve.deadlineMs,
shifu.serve.routerPenalty, shifu.serve.wire.maxBodyMB, the
shifu.serve.breaker.* settings and shifu.serve.sloMs/sloTarget (a zoo
tenant's own shifu.serve.slo.<set>.ms/target first),
shifu.serve.hbmBudgetMB (the zoo's budget of allocated device bytes,
0 = unbounded), shifu.serve.zoo.warmupMs (the cold-start Retry-After
before any admission was observed), shifu.lease.ttlMs/renewMs/
sweepAfterMs (the heartbeat leases; ttlMs=0 turns them off).

Multi-tenant: `shifu serve --zoo name=path,...` serves N model sets
behind per-set `POST /score/<set>` routes (zoo.py): budget-accounted
LRU residency, cold tenants answered 429 + Retry-After, streamed shadow
staging.

Request traces (shifu.trace.sample, slowMs, maxTraces), the obs metrics
behind /metrics, the metrics time series (shifu.obs.snapshotMs) and the
shutdown manifest come from `shifu_tpu_torch/obs/`; the drift monitor,
the traffic log, the hot-swap rollout (stage, shadow, promote) and the
promote gates and the fleet-atomic promotion round from
`shifu_tpu_torch/loop/`; the co-resident trainer (`coresident/`) rides
the zoo's background tenants through `/admin/coresident/*`.
"""

from shifu_tpu_torch.serve.batcher import MicroBatcher, ScoreRequest
from shifu_tpu_torch.serve.fleet import (
    DrainAwareRouter,
    ReplicaFleet,
    ScoringReplica,
)
from shifu_tpu_torch.serve.health import CircuitBreaker, HealthMonitor
from shifu_tpu_torch.serve.peers import PeerRegistry
from shifu_tpu_torch.serve.queue import AdmissionQueue, RejectedError
from shifu_tpu_torch.serve.registry import ModelRegistry
from shifu_tpu_torch.serve.server import Scorer, ScoringServer
from shifu_tpu_torch.serve.zoo import ColdStartError, HbmLedger, ModelZoo

__all__ = [
    "AdmissionQueue",
    "CircuitBreaker",
    "ColdStartError",
    "DrainAwareRouter",
    "HbmLedger",
    "HealthMonitor",
    "MicroBatcher",
    "ModelRegistry",
    "ModelZoo",
    "PeerRegistry",
    "RejectedError",
    "ReplicaFleet",
    "ScoreRequest",
    "Scorer",
    "ScoringReplica",
    "ScoringServer",
]

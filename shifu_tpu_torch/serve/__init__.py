"""shifu_tpu_torch.serve: online scoring on the card (counterpart of
`shifu_tpu/serve/`, single-tenant).

A model registry that loads a model set once and scores raw records in
one fused program of torch ops (registry.py), a micro-batcher with
continuous or barrier batching into power-of-two row buckets
(batcher.py), a bounded admission queue that sheds explicitly
(queue.py), health, circuit breaker and SLO state (health.py), a fleet of
per-card replicas behind a drain-aware router (fleet.py), the columnar
binary wire format (wire.py), and a stdlib HTTP front end with the
in-process Scorer (server.py).

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
shifu.serve.breaker.* settings and shifu.serve.sloMs/sloTarget.

Request traces (shifu.trace.sample, slowMs, maxTraces), the obs metrics
behind /metrics, the metrics time series (shifu.obs.snapshotMs) and the
shutdown manifest come from `shifu_tpu_torch/obs/`; the drift monitor,
the traffic log, the hot-swap rollout (stage, shadow, promote) and the
promote gates from `shifu_tpu_torch/loop/`. What waits for ROADMAP
A.14: the model zoo (A.14.4), leases and peers (A.14.7).
"""

from shifu_tpu_torch.serve.batcher import MicroBatcher, ScoreRequest
from shifu_tpu_torch.serve.fleet import (
    DrainAwareRouter,
    ReplicaFleet,
    ScoringReplica,
)
from shifu_tpu_torch.serve.health import CircuitBreaker, HealthMonitor
from shifu_tpu_torch.serve.queue import AdmissionQueue, RejectedError
from shifu_tpu_torch.serve.registry import ModelRegistry
from shifu_tpu_torch.serve.server import Scorer, ScoringServer

__all__ = [
    "AdmissionQueue",
    "CircuitBreaker",
    "DrainAwareRouter",
    "HealthMonitor",
    "MicroBatcher",
    "ModelRegistry",
    "RejectedError",
    "ReplicaFleet",
    "ScoreRequest",
    "Scorer",
    "ScoringReplica",
    "ScoringServer",
]

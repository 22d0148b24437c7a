"""Dynamic micro-batching: coalesce concurrent requests into one dispatch
(counterpart of `shifu_tpu/serve/batcher.py`).

The batcher sits between the admission queue and the registry and closes
each batch by one of two policies (`shifu.serve.batching`):

  continuous (default): requests coalesce in the queue while the
      previous batch is on the device, and the batch closes on capacity
      (`shifu.serve.maxBatchRows`) or the moment the queue runs dry, never
      on a clock: a lone request on an idle replica goes at once.
  barrier: the batch also waits up to `shifu.serve.maxWaitMs` (default
      2.0 ms) after its first request, for comparison and for
      deployments that want a minimum coalescing window.

Coalesced rows score in one registry call (padded there to the row
bucket) and the result is sliced back per request. One worker thread
keeps the order FIFO; each request resolves through its own event.

The worker runs under a supervisor: a crash answers every request of the
batch in flight (through the fleet's failover when there is one, else
with the error) and restarts the worker up to
`shifu.serve.maxWorkerRestarts` times; health degrades until clean
batches return. Every batch outcome goes to the replica's circuit
breaker. A request that outlives `shifu.serve.deadlineMs` before dispatch
is shed with `DeadlineExceededError`. The observed drain rate gives the
429 Retry-After hint.

Two fault seams (`resilience/faults.py`): `serve` fires outside the
per-batch guard, so an injected fault there crashes the worker and the
supervisor answers the batch in flight; `serve.dispatch` fires inside
it, with the replica's index, so `device_dead@replica=N` fails replica
N's batches, its breaker counts them and the fleet fails over.

The JAX package records serve.* counters and latency histograms in its
metrics registry and per-request trace stages; here the counters are
plain numbers on the batcher (`batches`, `records`, `requests`, ...) and
the latencies a histogram over the same pinned edges (`latency`). The
request traces wait for ROADMAP A.14.
"""

from __future__ import annotations

import bisect
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from shifu_tpu_torch.data.reader import ColumnarData
from shifu_tpu_torch.eval.scorer import ScoreResult
from shifu_tpu_torch.resilience import faults
from shifu_tpu_torch.serve.health import HealthMonitor
from shifu_tpu_torch.serve.queue import AdmissionQueue
from shifu_tpu_torch.utils import environment
from shifu_tpu_torch.utils.log import get_logger

log = get_logger(__name__)

DEFAULT_MAX_BATCH_ROWS = 1024
DEFAULT_MAX_WAIT_MS = 2.0
DEFAULT_MAX_WORKER_RESTARTS = 5
DEFAULT_DEADLINE_MS = 30_000.0
BATCHING_CONTINUOUS = "continuous"
BATCHING_BARRIER = "barrier"
# Retry-After clamp: never "come back now" while shedding, never more
# than half a minute on a stale estimate
RETRY_AFTER_MIN_S = 1.0
RETRY_AFTER_MAX_S = 30.0
DRAIN_WINDOW_S = 10.0

# the JAX package's pinned histogram edges: doubling from 100 µs
LATENCY_BUCKETS = tuple(0.0001 * 2 ** k for k in range(16)) + (float("inf"),)
BATCH_ROWS_BUCKETS = tuple(float(2 ** k) for k in range(14)) + (float("inf"),)


def max_batch_rows_setting() -> int:
    return environment.get_int("shifu.serve.maxBatchRows",
                               DEFAULT_MAX_BATCH_ROWS)


def max_wait_ms_setting() -> float:
    raw = environment.get_property("shifu.serve.maxWaitMs", "")
    try:
        return float(raw) if raw else DEFAULT_MAX_WAIT_MS
    except ValueError:
        return DEFAULT_MAX_WAIT_MS


def max_worker_restarts_setting() -> int:
    return environment.get_int("shifu.serve.maxWorkerRestarts",
                               DEFAULT_MAX_WORKER_RESTARTS)


def batching_setting() -> str:
    """shifu.serve.batching: continuous | barrier (unknown values are
    continuous)."""
    raw = environment.get_property("shifu.serve.batching", "").strip()
    return (BATCHING_BARRIER if raw.lower() == BATCHING_BARRIER
            else BATCHING_CONTINUOUS)


def deadline_ms_setting() -> float:
    """shifu.serve.deadlineMs: per-request budget from admission to
    dispatch (0 disables)."""
    raw = environment.get_property("shifu.serve.deadlineMs", "")
    try:
        return float(raw) if raw else DEFAULT_DEADLINE_MS
    except ValueError:
        return DEFAULT_DEADLINE_MS


class Histogram:
    """Counts over fixed upper edges (the last one +inf), with the sum."""

    def __init__(self, edges: Sequence[float]) -> None:
        self.edges = tuple(edges)
        self.counts = [0] * len(self.edges)
        self.count = 0
        self.sum = 0.0

    def observe(self, v: float) -> None:
        self.counts[bisect.bisect_left(self.edges, v)] += 1
        self.count += 1
        self.sum += v

    def snapshot(self) -> dict:
        return {"buckets": ["inf" if e == float("inf") else e
                            for e in self.edges],
                "counts": list(self.counts), "count": self.count,
                "sum": self.sum}


class DeadlineExceededError(TimeoutError):
    """The request outlived shifu.serve.deadlineMs before dispatch."""


class ScoreRequest:
    """One admitted request: a raw columnar slice and its completion."""

    __slots__ = ("data", "n_rows", "enqueued_at", "popped_at", "deadline",
                 "_done", "result", "error", "failovers", "wire_format")

    def __init__(self, data: ColumnarData,
                 deadline_s: Optional[float] = None) -> None:
        self.data = data
        self.n_rows = data.n_rows
        self.wire_format = data.wire_format
        self.enqueued_at = time.perf_counter()
        self.popped_at = self.enqueued_at
        self.deadline = (self.enqueued_at + deadline_s
                         if deadline_s else None)
        self._done = threading.Event()
        self.result: Optional[ScoreResult] = None
        self.error: Optional[BaseException] = None
        # replays on another replica after a failed batch (bounded by the
        # fleet's failover budget); one event, so never answered twice
        self.failovers = 0

    def expired(self, now: Optional[float] = None) -> bool:
        return (self.deadline is not None
                and (now or time.perf_counter()) > self.deadline)

    def resolve(self, result: ScoreResult) -> None:
        self.result = result
        self._done.set()

    def fail(self, error: BaseException) -> None:
        self.error = error
        self._done.set()

    def wait(self, timeout: Optional[float] = None) -> ScoreResult:
        if not self._done.wait(timeout):
            raise TimeoutError("score request did not complete in time")
        if self.error is not None:
            raise self.error
        return self.result


def concat_batches(datas: Sequence[ColumnarData]) -> ColumnarData:
    """Riders' batches -> one. A column every rider sent typed with one
    dtype stays typed; otherwise it goes to strings (promoting an i64
    rider next to an f64 one would print "3" as "3.0")."""
    if len(datas) == 1:
        return datas[0]
    names = datas[0].names
    raw = {}
    for name in names:
        typed = [d.typed_column(name) for d in datas]
        if (typed[0] is not None
                and all(t is not None and t.dtype == typed[0].dtype
                        for t in typed)):
            raw[name] = np.concatenate(typed)
        else:
            raw[name] = np.concatenate([
                np.asarray(d.column(name), dtype=object) for d in datas])
    return ColumnarData(names=list(names), raw=raw,
                        n_rows=sum(d.n_rows for d in datas),
                        missing_values=datas[0].missing_values)


def slice_result(res: ScoreResult, start: int, stop: int) -> ScoreResult:
    return ScoreResult(
        model_scores=res.model_scores[start:stop],
        mean=res.mean[start:stop],
        max=res.max[start:stop],
        min=res.min[start:stop],
        median=res.median[start:stop],
        model_names=res.model_names,
        model_widths=res.model_widths,
    )


class MicroBatcher:
    """Admission-queue consumer: coalesce -> score -> fan results out,
    under a supervisor that restarts a crashed worker (bounded) with the
    queue kept and the batch in flight answered request by request."""

    def __init__(self, score_fn: Callable[[ColumnarData], ScoreResult],
                 admission: AdmissionQueue,
                 max_batch_rows: Optional[int] = None,
                 max_wait_ms: Optional[float] = None,
                 health: Optional[HealthMonitor] = None,
                 max_restarts: Optional[int] = None,
                 deadline_ms: Optional[float] = None,
                 batching: Optional[str] = None,
                 breaker=None, replica: Optional[int] = None) -> None:
        self.score_fn = score_fn
        self.admission = admission
        self.breaker = breaker
        # the replica index the fleet passes: the `serve.dispatch` seam's
        # context, so `seam@replica=N` clauses target this batcher
        self.replica = replica
        # the fleet's failover hook, set by ReplicaFleet: (request, error)
        # -> replay on a healthy replica or fail under the budget. None:
        # fail directly
        self.failover: Optional[Callable[[ScoreRequest, BaseException],
                                         None]] = None
        self.batching = batching_setting() if batching is None else (
            BATCHING_BARRIER if str(batching).lower() == BATCHING_BARRIER
            else BATCHING_CONTINUOUS)
        self.health = health if health is not None else HealthMonitor()
        self.max_batch_rows = (max_batch_rows_setting()
                               if max_batch_rows is None
                               else int(max_batch_rows))
        self.max_wait_s = (max_wait_ms_setting()
                           if max_wait_ms is None
                           else float(max_wait_ms)) / 1000.0
        self.max_restarts = (max_worker_restarts_setting()
                             if max_restarts is None else int(max_restarts))
        self.deadline_s = ((deadline_ms_setting()
                            if deadline_ms is None else float(deadline_ms))
                           / 1000.0)
        self.restarts = 0
        # the counters the JAX package keeps in its metrics registry
        self.batches = 0
        self.batch_errors = 0
        self.records = 0
        self.crashes = 0
        self.deadline_shed = 0
        self.requests: Dict[str, int] = {}
        self.latency: Dict[str, Histogram] = {}
        self.batch_rows = Histogram(BATCH_ROWS_BUCKETS)
        self.score_seconds = 0.0
        self._inflight: Optional[List[ScoreRequest]] = None
        self._drained = threading.Event()  # clean drain or give-up
        # (t_done, n_requests) per batch; the lock covers the worker's
        # append racing retry_after_seconds() on handler threads
        self._drain_log: deque = deque(maxlen=64)
        self._drain_lock = threading.Lock()
        self._worker = self._spawn()

    def _spawn(self) -> threading.Thread:
        worker = threading.Thread(target=self._run,
                                  name="shifu-serve-batcher", daemon=True)
        worker.start()
        return worker

    def submit(self, data: ColumnarData) -> ScoreRequest:
        """Admit one request (raises queue.RejectedError on shed)."""
        req = ScoreRequest(data, deadline_s=self.deadline_s or None)
        self.admission.put(req)
        return req

    def _dispose(self, req: ScoreRequest, error: BaseException) -> None:
        """A request whose batch failed: the fleet's failover, or the
        error. Never left unanswered."""
        fo = self.failover
        if fo is None:
            req.fail(error)
            return
        try:
            fo(req, error)
        except Exception as fe:
            log.warning("failover handler failed: %s", fe)
            req.fail(error)

    def join(self, timeout: Optional[float] = None) -> None:
        """Wait for the drain (meaningful after admission.close())."""
        self._drained.wait(timeout)

    @property
    def draining(self) -> bool:
        return self.admission.closed and not self._drained.is_set()

    # ---- supervisor ----
    def _run(self) -> None:
        try:
            self._loop()
            self._drained.set()  # queue closed and empty
            return
        except BaseException as e:  # any worker death is survived
            self.crashes += 1
            log.warning("serve scoring worker crashed: %s: %s",
                        type(e).__name__, e)
            inflight, self._inflight = self._inflight, None
            err = RuntimeError(f"scoring worker crashed mid-batch: {e}")
            for r in inflight or []:
                self._dispose(r, err)
            if self.breaker is not None and inflight:
                self.breaker.note_failure(
                    f"worker crash: {type(e).__name__}")
            self.health.note_crash(
                f"scoring worker crashed: {type(e).__name__}")
            if self.restarts >= self.max_restarts:
                log.error("serve worker restart budget (%d) exhausted; "
                          "draining", self.max_restarts)
                self.health.set_draining("worker restart budget exhausted")
                self.admission.close()
                drain_err = RuntimeError(
                    "scoring worker unavailable (restart budget "
                    "exhausted)")
                while True:
                    req = self.admission.get(timeout=0)
                    if req is None:
                        break
                    self._dispose(req, drain_err)
                self._drained.set()
                return
            self.restarts += 1
            log.info("restarting serve scoring worker (%d/%d)",
                     self.restarts, self.max_restarts)
            self._worker = self._spawn()

    def _gather(self) -> Optional[List[ScoreRequest]]:
        """Block for the next request, then coalesce. None: the queue is
        closed and drained."""
        first = self.admission.get()
        if first is None:
            return None
        first.popped_at = time.perf_counter()
        batch = [first]
        # registered with the supervisor at once (the same list, so
        # later appends show): a popped request is answerable only
        # through _inflight if the worker dies while coalescing
        self._inflight = batch
        rows = first.n_rows
        deadline = (None if self.batching == BATCHING_CONTINUOUS
                    else time.perf_counter() + self.max_wait_s)
        while rows < self.max_batch_rows:
            if deadline is None:
                nxt = self.admission.get(timeout=0)
            else:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                nxt = self.admission.get(timeout=remaining)
            if nxt is None:
                break
            nxt.popped_at = time.perf_counter()
            batch.append(nxt)
            rows += nxt.n_rows
        return batch

    def _loop(self) -> None:
        while True:
            batch = self._gather()
            if batch is None:
                return
            now = time.perf_counter()
            live: List[ScoreRequest] = []
            for r in batch:
                if r.expired(now):
                    self.deadline_shed += 1
                    r.fail(DeadlineExceededError(
                        "request exceeded shifu.serve.deadlineMs before "
                        "dispatch"))
                else:
                    live.append(r)
            batch = live
            if not batch:
                self._inflight = None
                continue
            # _inflight stays set until every request has its answer: a
            # crash below (the injected `serve` fault on the next line
            # too) is answered by the supervisor
            self._inflight = batch
            faults.fault_point("serve")
            rows = sum(r.n_rows for r in batch)
            self.batches += 1
            self.batch_rows.observe(rows)
            t0 = time.perf_counter()
            try:
                # a failed batch, not a crashed worker: the breaker counts
                # it and failover replays its requests elsewhere
                faults.fault_point("serve.dispatch", replica=self.replica)
                result = self.score_fn(
                    concat_batches([r.data for r in batch]))
            except Exception as e:  # per-request answers, breaker told
                log.warning("serve batch of %d requests failed: %s",
                            len(batch), e)
                self.batch_errors += 1
                if self.breaker is not None:
                    self.breaker.note_failure(f"{type(e).__name__}: {e}")
                for r in batch:
                    self._dispose(r, e)
                self._inflight = None
                continue
            now = time.perf_counter()
            self.score_seconds += now - t0
            off = 0
            for r in batch:
                r.resolve(slice_result(result, off, off + r.n_rows))
                off += r.n_rows
                fmt = r.wire_format
                hist = self.latency.get(fmt)
                if hist is None:
                    hist = self.latency[fmt] = Histogram(LATENCY_BUCKETS)
                hist.observe(now - r.enqueued_at)
                self.requests[fmt] = self.requests.get(fmt, 0) + 1
            self.records += rows
            self._inflight = None
            with self._drain_lock:
                self._drain_log.append((now, len(batch)))
            self.health.note_ok()
            if self.breaker is not None:
                self.breaker.note_ok()

    # ---- load hints ----
    def drain_stats(self, now: Optional[float] = None
                    ) -> Tuple[int, Optional[float]]:
        """(queued requests incl. the batch in flight, drained requests/s
        over the last DRAIN_WINDOW_S or None without history)."""
        if now is None:
            now = time.perf_counter()
        with self._drain_lock:
            drained = list(self._drain_log)
        recent = [(t, n) for t, n in drained if now - t <= DRAIN_WINDOW_S]
        inflight = self._inflight
        depth = len(self.admission) + (len(inflight) if inflight else 0)
        if len(recent) >= 2:
            span = max(now - recent[0][0], 1e-3)
            return depth, sum(n for _, n in recent) / span
        return depth, None

    def expected_wait(self, now: Optional[float] = None) -> float:
        """Seconds before a newly admitted request dispatches: backlog
        over the drain rate (the raw backlog without history)."""
        depth, rate = self.drain_stats(now)
        if not depth:
            return 0.0
        if rate is None:
            return float(depth)
        return depth / max(rate, 1e-3)

    def retry_after_seconds(self) -> float:
        """429 Retry-After from the observed drain rate, clamped."""
        depth, rate = self.drain_stats()
        hint = (depth / max(rate, 1e-3) if rate is not None
                else RETRY_AFTER_MIN_S)
        return min(max(hint, RETRY_AFTER_MIN_S), RETRY_AFTER_MAX_S)

    def snapshot(self) -> dict:
        return {
            "batching": self.batching,
            "batches": self.batches,
            "batchErrors": self.batch_errors,
            "records": self.records,
            "requests": dict(self.requests),
            "deadlineShed": self.deadline_shed,
            "workerCrashes": self.crashes,
            "workerRestarts": self.restarts,
            "scoreSeconds": self.score_seconds,
            "batchRows": self.batch_rows.snapshot(),
            "latencySeconds": {k: h.snapshot()
                               for k, h in self.latency.items()},
        }

"""Deterministic fault injection at the pipeline's real seams (counterpart
of `shifu_tpu/resilience/faults.py`).

`-Dshifu.faults=<spec>` arms seeded, schedule-based injectors at the
seams where production fails: the chunk reader, the prefetch worker,
checkpoint writes, the serving batcher, and SIGTERM-style preemption at
chunk and epoch boundaries. Every injector is seeded (or pinned to an
absolute event ordinal), so a chaos run is reproducible: the same spec
kills the same chunk every time, and the tests pin bit-identical resume.

Spec grammar (comma-separated clauses), the JAX package's::

    clause  := seam [ "@" trigger "=" N ] ( ":" key "=" value )*
    seam    := io | prefetch | device | ckpt | serve | preempt | slow
             | device_dead | lease_stall | peer_kill
    trigger := a counter name (fire at that counter's Nth event), or
               the literal `replica` — then N is a TARGET, not a
               schedule: the clause applies only to events fired by
               replica N (any seam may be replica-targeted)
    key     := p (probability, default 0.01; slow/lease_stall/
               device_dead default to 1.0)
             | seed (rng seed, default 0)
             | ms (sleep milliseconds, slow/lease_stall, default 50)
             | max (max firings, 0 = unlimited; scheduled, preempt and
               peer_kill clauses default to 1, probabilistic ones to 0)

Examples::

    -Dshifu.faults=io:p=0.01:seed=7,preempt@chunk=40,slow:ms=250
    -Dshifu.faults=device_dead@replica=1,preempt@epoch=3

  * `io:p=0.01:seed=7` — 1% of chunk-reader pulls raise a transient
    `InjectedFaultError` (retried by `retry.retry_call`).
  * `preempt@chunk=40` — the 40th chunk boundary raises
    `PreemptionError` (the SIGTERM analog): the step dies and resumes
    from its stream checkpoint with `--resume`.
  * `slow:ms=250` — every chunk pull stalls 250 ms.
  * `device_dead@replica=1` — serving replica 1's dispatches fail
    persistently: its breaker opens and its requests fail over.

The `device` seam is every profile dispatch (`obs/profile.py`
`dispatch`), retried under `shifu.retry.device.*`. The `lease_stall` /
`peer_kill` seams (the heartbeat leases, `resilience/lease.py` in the JAX
package) have no seam in the port yet: a clause naming one raises
`FaultSpecError` naming ROADMAP A.14 at parse, never arms silently.

Each seam calls `fault_point(counter)`; a scheduled clause fires when the
1-based per-process event count reaches N, so a resumed run counts only
the chunks it re-processes. A caller may pass an absolute `index`
(ordinal = index + 1); probabilistic draws are then a pure function of
(seed, counter, index).

Every firing counts `fault.injected{seam=}` (with `replica=` when the
firing seam carried a replica context) and every absorbed fault
`fault.survived{seam=}` in the obs registry, as in the JAX package.
"""

from __future__ import annotations

import signal
import time
import zlib
from typing import Dict, List, Optional

import numpy as np

from shifu_tpu_torch.analysis.racetrack import tracked_lock
from shifu_tpu_torch.utils import environment
from shifu_tpu_torch.utils.log import get_logger

log = get_logger(__name__)

FAULTS_PROPERTY = "shifu.faults"

SEAMS = ("io", "prefetch", "device", "ckpt", "serve", "preempt", "slow",
         "device_dead", "lease_stall", "peer_kill")
# seams the port does not reach yet, and the ROADMAP item that adds each
UNREACHED = {"lease_stall": "A.14 (resilience/lease.py heartbeats)",
             "peer_kill": "A.14 (resilience/lease.py heartbeats)"}

# seams that sleep instead of raising (latency injection)
SLEEP_SEAMS = ("slow", "lease_stall")
# seams whose bare clause means "always", not the probabilistic default
CERTAIN_SEAMS = ("slow", "lease_stall", "device_dead", "peer_kill")

DEFAULT_P = 0.01
DEFAULT_SLOW_MS = 50.0

class FaultSpecError(ValueError):
    """Malformed -Dshifu.faults spec (raised at parse, not mid-run)."""


class InjectedFaultError(RuntimeError):
    """A transient injected failure — the retry layer must absorb it."""

    def __init__(self, seam: str, ordinal: int) -> None:
        self.seam = seam
        self.ordinal = ordinal
        super().__init__(f"injected {seam} fault at event {ordinal}")


class PreemptionError(Exception):
    """SIGTERM-style preemption: the step must die cleanly and be
    resumable — it is not retryable in-process, which is why this is not
    a subclass of InjectedFaultError."""


class FaultClause:
    """One parsed clause: which counter it listens on and what it does.
    `replica` (from the `@replica=N` form) narrows any seam to events
    fired with that replica context."""

    __slots__ = ("seam", "counter", "at", "p", "seed", "ms", "max",
                 "replica", "fired", "_rng")

    def __init__(self, seam: str, counter: str, at: Optional[int],
                 p: float, seed: int, ms: float, max_firings: int,
                 replica: Optional[int] = None) -> None:
        self.seam = seam
        self.counter = counter
        self.at = at
        self.p = p
        self.seed = seed
        self.ms = ms
        self.max = max_firings
        self.replica = replica
        self.fired = 0
        self._rng = np.random.default_rng(seed)

    def should_fire(self, ordinal: int, absolute: bool) -> bool:
        if self.max and self.fired >= self.max:
            return False
        if self.at is not None:
            return ordinal == self.at
        if absolute:
            # index-keyed draw: deterministic per event, immune to how
            # many events this process (vs a resumed one) has seen
            r = np.random.default_rng(
                [self.seed, zlib.crc32(self.counter.encode()), ordinal]
            ).random()
        else:
            r = self._rng.random()
        return r < self.p

    def describe(self) -> str:
        trig = (f"@{self.counter}={self.at}" if self.at is not None
                else f":p={self.p}")
        if self.replica is not None:
            trig += f"@replica={self.replica}"
        return f"{self.seam}{trig}"


def _parse_clause(text: str) -> FaultClause:
    head, *params = text.strip().split(":")
    replica: Optional[int] = None
    at: Optional[int] = None
    counter = ""
    if "@" in head:
        seam, trigger = head.split("@", 1)
        if "=" not in trigger:
            raise FaultSpecError(
                f"'{text}': trigger must be @counter=N or @replica=N")
        counter, at_s = trigger.split("=", 1)
        try:
            at = int(at_s)
        except ValueError:
            raise FaultSpecError(f"'{text}': trigger ordinal must be int")
        if counter.strip() == "replica":
            # @replica=N is a target (which replica's events), not a
            # schedule: the clause listens on its seam's default counter
            replica, at, counter = at, None, ""
    else:
        seam = head
    seam = seam.strip()
    if seam not in SEAMS:
        raise FaultSpecError(
            f"'{text}': unknown seam '{seam}' (one of {', '.join(SEAMS)})")
    if not counter:
        # default listening counter: preempt fires at chunk boundaries,
        # slow stalls the reader, the lease seams listen on the
        # heartbeat, device_dead on the replica dispatch; everything
        # else on its own seam
        counter = {"preempt": "chunk", "slow": "io",
                   "lease_stall": "lease", "peer_kill": "lease",
                   "device_dead": "serve.dispatch"}.get(seam, seam)
    p = 1.0 if seam in CERTAIN_SEAMS else DEFAULT_P
    seed = 0
    ms = DEFAULT_SLOW_MS
    max_firings = 1 if (at is not None
                        or seam in ("preempt", "peer_kill")) else 0
    for param in params:
        if "=" not in param:
            raise FaultSpecError(f"'{text}': parameter '{param}' needs k=v")
        k, v = param.split("=", 1)
        try:
            if k == "p":
                p = float(v)
            elif k == "seed":
                seed = int(v)
            elif k == "ms":
                ms = float(v)
            elif k == "max":
                max_firings = int(v)
            else:
                raise FaultSpecError(
                    f"'{text}': unknown parameter '{k}' (p/seed/ms/max)")
        except ValueError as e:
            if isinstance(e, FaultSpecError):
                raise
            raise FaultSpecError(f"'{text}': bad value for '{k}': {v}")
    if not 0.0 <= p <= 1.0:
        raise FaultSpecError(f"'{text}': p must be in [0, 1]")
    if seam in UNREACHED:
        raise FaultSpecError(
            f"'{text}': the '{seam}' seam is not ported yet (ROADMAP "
            f"{UNREACHED[seam]}); the clause would never fire")
    return FaultClause(seam, counter.strip(), at, p, seed, ms, max_firings,
                       replica=replica)


class FaultPlan:
    """Parsed spec + per-counter event state. Thread-safe: the prefetch
    worker and the consumer hit fault points concurrently."""

    def __init__(self, clauses: List[FaultClause], spec: str = "") -> None:
        self.clauses = clauses
        self.spec = spec
        self._counts: Dict[str, int] = {}
        self._lock = tracked_lock("resilience.faults.plan")

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        clauses = [_parse_clause(c) for c in spec.split(",") if c.strip()]
        return cls(clauses, spec=spec)

    def fire(self, counter: str, index: Optional[int] = None,
             replica: Optional[int] = None) -> None:
        """Evaluate every clause listening on `counter` for this event:
        raise InjectedFaultError / PreemptionError, or sleep (the sleep
        seams). Only one raising clause acts an event (preempt before a
        transient fault); `fired` budgets are charged only on clauses
        that act, so a preempt sharing a counter with a probabilistic
        clause is deferred, not consumed. Every due sleep clause sleeps."""
        severity = {"preempt": 1}
        with self._lock:
            if index is not None:
                ordinal = index + 1
            else:
                ordinal = self._counts.get(counter, 0) + 1
                self._counts[counter] = ordinal
            due = [c for c in self.clauses
                   if c.counter == counter
                   and (c.replica is None or c.replica == replica)
                   and c.should_fire(ordinal, absolute=index is not None)]
            sleeps = [c for c in due if c.seam in SLEEP_SEAMS]
            raisers = sorted((c for c in due if c.seam not in SLEEP_SEAMS),
                             key=lambda c: severity.get(c.seam, 2))
            acting = sleeps + raisers[:1]
            for c in acting:
                c.fired += 1
        from shifu_tpu_torch.obs import registry

        rep_label = ({} if replica is None
                     else {"replica": str(replica)})
        for c in acting:
            registry().counter("fault.injected", seam=c.seam,
                               **rep_label).inc()
            if c.seam in SLEEP_SEAMS:
                time.sleep(c.ms / 1000.0)
                continue
            if c.seam == "preempt":
                log.warning("fault injection: preempting at %s event %d",
                            counter, ordinal)
                raise PreemptionError(
                    f"injected preemption at {counter} event {ordinal}")
            raise InjectedFaultError(c.seam, ordinal)


# ---------------------------------------------------------------------------
# process-global plan (environment-armed) + test override
# ---------------------------------------------------------------------------

_lock = tracked_lock("resilience.faults.module")
_plan: Optional[FaultPlan] = None
_plan_spec: Optional[str] = None
_override: Optional[FaultPlan] = None


def _current_plan() -> Optional[FaultPlan]:
    global _plan, _plan_spec
    if _override is not None:
        return _override
    spec = environment.get_property(FAULTS_PROPERTY, "") or ""
    if not spec.strip():
        return None
    with _lock:
        if spec != _plan_spec:
            _plan = FaultPlan.parse(spec)
            _plan_spec = spec
            log.info("fault injection armed: %s",
                     ", ".join(c.describe() for c in _plan.clauses))
        return _plan


def plan_active() -> bool:
    """Cheap guard for hot paths: is any fault plan armed?"""
    if _override is not None:
        return True
    spec = environment.get_property(FAULTS_PROPERTY, "") or ""
    return bool(spec.strip())


def fault_point(counter: str, index: Optional[int] = None,
                replica: Optional[int] = None) -> None:
    """Seam hook: a no-op unless a plan is armed. `index` is the absolute
    0-based event index when the caller tracks one; `replica` is the
    replica context the serving seams pass (`seam@replica=N`)."""
    plan = _current_plan()
    if plan is not None:
        plan.fire(counter, index=index, replica=replica)


def reset() -> None:
    """Fresh event counters and firing state (each lifecycle step
    re-arms): the cached plan is parsed again on next use."""
    global _plan, _plan_spec
    with _lock:
        _plan = None
        _plan_spec = None


class activate:
    """Context manager pinning an explicit plan (tests): overrides the
    environment spec for the duration."""

    def __init__(self, plan: Optional[FaultPlan]) -> None:
        self.plan = plan

    def __enter__(self) -> Optional[FaultPlan]:
        global _override
        self._prev = _override
        _override = self.plan
        return self.plan

    def __exit__(self, *exc) -> None:
        global _override
        _override = self._prev


def survived(seam: str, n: int = 1) -> None:
    """Record that `n` injected faults at `seam` were absorbed (a retry
    recovered, a resume loaded its snapshot)."""
    from shifu_tpu_torch.obs import registry

    registry().counter("fault.survived", seam=seam).inc(n)


# ---------------------------------------------------------------------------
# real preemption: SIGTERM -> PreemptionError in the main thread
# ---------------------------------------------------------------------------


def install_preemption_handler():
    """Turn SIGTERM into a PreemptionError, so a preempted lifecycle step
    unwinds through BasicProcessor.run (and its stream checkpoints stay
    resumable) instead of dying where it stands.

    Returns a restore() callable, or None off the main thread, where
    signal handlers cannot be installed."""

    def _handler(signum, frame):
        raise PreemptionError(f"signal {signum}: host preempted")

    try:
        prev = signal.signal(signal.SIGTERM, _handler)
    except ValueError:  # not in the main thread: leave signals alone
        return None

    def restore() -> None:
        try:
            signal.signal(signal.SIGTERM, prev)
        except ValueError:  # restored off the main thread: nothing to undo
            pass

    return restore

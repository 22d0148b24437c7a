"""Serve health: ok | degraded | draining with a reason, the per-replica
circuit breaker and the latency SLO tracker (counterpart of
`shifu_tpu/serve/health.py`).

  ok        scoring normally.
  degraded  still scoring, but a worker crash was survived recently: a
            router de-prioritizes (does not eject) the replica. Clears
            back to ok after `ok_after` consecutive clean batches.
  draining  not accepting work (shutdown, or the worker restart budget
            is spent): /healthz answers 503.

Transitions are monotone toward draining. The JAX package counts each
transition in its metrics registry and guards its locks with the race
tracker; here the counts are plain numbers (`transitions`) and the locks
plain `threading.Lock`s. The sticky (drift) degrade, the per-tenant SLO
settings and the metric labels wait with the drift monitor and the
model zoo (ROADMAP A.14).
"""

from __future__ import annotations

import random
import threading
import time
from collections import deque
from typing import Dict, Optional

from shifu_tpu_torch.utils import environment

OK = "ok"
DEGRADED = "degraded"
DRAINING = "draining"

# circuit-breaker states: CLOSED passes traffic, OPEN quarantines the
# replica, HALF_OPEN lets single probes through
BREAKER_CLOSED = "closed"
BREAKER_OPEN = "open"
BREAKER_HALF_OPEN = "half_open"

DEFAULT_OK_AFTER = 3

DEFAULT_BREAKER_FAILURES = 3
DEFAULT_PROBE_BASE_MS = 500.0
DEFAULT_PROBE_CAP_MS = 30_000.0
DEFAULT_PROBE_OKS = 2
# a half-open probe that never produced an outcome (shed before dispatch)
# is abandoned after this long, so a lost probe cannot wedge the replica
PROBE_ABANDON_S = 60.0

DEFAULT_SLO_TARGET = 0.99
DEFAULT_SLO_WINDOW_S = 60.0
SLO_WINDOW_EVENTS = 4096


def breaker_failures_setting() -> int:
    """shifu.serve.breaker.failures: consecutive dispatch failures that
    trip a replica's breaker open."""
    return environment.get_int("shifu.serve.breaker.failures",
                               DEFAULT_BREAKER_FAILURES)


def breaker_probe_base_ms_setting() -> float:
    """shifu.serve.breaker.probeBaseMs: the first probe backoff window."""
    return environment.get_float("shifu.serve.breaker.probeBaseMs",
                                 DEFAULT_PROBE_BASE_MS)


def breaker_probe_cap_ms_setting() -> float:
    """shifu.serve.breaker.probeCapMs: the probe backoff ceiling."""
    return environment.get_float("shifu.serve.breaker.probeCapMs",
                                 DEFAULT_PROBE_CAP_MS)


def breaker_probe_oks_setting() -> int:
    """shifu.serve.breaker.probeOks: consecutive good half-open probes
    before the breaker closes."""
    return environment.get_int("shifu.serve.breaker.probeOks",
                               DEFAULT_PROBE_OKS)


def slo_ms_setting() -> float:
    """shifu.serve.sloMs: per-request latency SLO in ms (0 = off)."""
    return environment.get_float("shifu.serve.sloMs", 0.0)


def slo_target_setting() -> float:
    """shifu.serve.sloTarget: the fraction of requests that must meet
    sloMs."""
    return environment.get_float("shifu.serve.sloTarget",
                                 DEFAULT_SLO_TARGET)


def backoff_window_ms(base_ms: float, cap_ms: float, attempt: int) -> float:
    """The capped exponential backoff window of attempt `attempt`
    (1-based; the JAX package's `resilience/retry.py` formula)."""
    return min(max(cap_ms, 0.0),
               max(base_ms, 0.0) * (2.0 ** (attempt - 1)))


class SloTracker:
    """Good/bad SLO accounting and burn rate over a rolling window. A
    request is good when its latency meets `shifu.serve.sloMs`;
    `burn_rate()` is the bad fraction over the window divided by the
    error budget (1 - target)."""

    def __init__(self, slo_ms: Optional[float] = None,
                 target: Optional[float] = None,
                 window_s: float = DEFAULT_SLO_WINDOW_S) -> None:
        self.slo_ms = float(slo_ms_setting() if slo_ms is None else slo_ms)
        if target is None:
            target = slo_target_setting()
        self.target = min(max(float(target), 0.0), 0.9999)
        self.window_s = float(window_s)
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=SLO_WINDOW_EVENTS)
        self._good = 0
        self._bad = 0

    @property
    def enabled(self) -> bool:
        return self.slo_ms > 0.0

    def observe(self, latency_s: float, ok: Optional[bool] = None) -> None:
        """Count one request. `ok=None` applies the latency test;
        `ok=False` forces a bad count (a shed or failed request got no
        score and must burn budget)."""
        if not self.enabled:
            return
        if ok is None:
            ok = latency_s * 1e3 <= self.slo_ms
        with self._lock:
            self._events.append((time.perf_counter(), ok))
            if ok:
                self._good += 1
            else:
                self._bad += 1

    def burn_rate(self, now: Optional[float] = None) -> float:
        if not self.enabled:
            return 0.0
        if now is None:
            now = time.perf_counter()
        with self._lock:
            recent = [ok for t, ok in self._events
                      if now - t <= self.window_s]
        if not recent:
            return 0.0
        bad = sum(1 for ok in recent if not ok)
        return (bad / len(recent)) / max(1e-9, 1.0 - self.target)

    def snapshot(self) -> dict:
        rate = self.burn_rate()
        with self._lock:
            return {
                "sloMs": self.slo_ms,
                "target": self.target,
                "windowSeconds": self.window_s,
                "good": self._good,
                "bad": self._bad,
                "burnRate": round(rate, 4),
                "burning": rate > 1.0,
            }


class HealthMonitor:
    """Thread-safe tri-state health with crash-recovery hysteresis."""

    def __init__(self, ok_after: int = DEFAULT_OK_AFTER) -> None:
        self._lock = threading.Lock()
        self._state = OK
        self._reason = ""
        self._ok_after = max(1, ok_after)
        self._ok_streak = 0
        self._crashes = 0
        self.transitions: Dict[str, int] = {}

    def _transition(self, state: str, reason: str) -> None:
        # the caller holds the lock
        if self._state == state:
            self._reason = reason
            return
        self._state = state
        self._reason = reason
        self.transitions[state] = self.transitions.get(state, 0) + 1

    def note_crash(self, reason: str) -> None:
        with self._lock:
            self._crashes += 1
            self._ok_streak = 0
            if self._state != DRAINING:
                self._transition(DEGRADED, reason)

    def note_ok(self) -> None:
        with self._lock:
            if self._state != DEGRADED:
                return
            self._ok_streak += 1
            if self._ok_streak >= self._ok_after:
                self._transition(OK, "")

    def set_draining(self, reason: str) -> None:
        with self._lock:
            self._transition(DRAINING, reason)

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    @property
    def reason(self) -> str:
        with self._lock:
            return self._reason

    @property
    def crashes(self) -> int:
        with self._lock:
            return self._crashes

    def snapshot(self) -> dict:
        with self._lock:
            return {"status": self._state, "reason": self._reason,
                    "workerCrashes": self._crashes}


class CircuitBreaker:
    """Per-replica circuit breaker over device-dispatch outcomes.

      closed     failures count a consecutive streak; reaching
                 `shifu.serve.breaker.failures` trips the breaker.
      open       quarantined: the router treats the replica as absent.
                 Each trip schedules a probe a jittered exponential
                 backoff away (equal jitter, never zero).
      half_open  the backoff elapsed: the router sends one live request
                 as the probe. `shifu.serve.breaker.probeOks` successes
                 close the breaker; a failure re-opens it with a doubled
                 (capped) backoff.

    A failed probe request is replayed on a healthy replica by the
    fleet's failover like any failed-batch rider."""

    def __init__(self, failures: Optional[int] = None,
                 probe_base_ms: Optional[float] = None,
                 probe_cap_ms: Optional[float] = None,
                 probe_oks: Optional[int] = None,
                 rng=None) -> None:
        self.failures = (breaker_failures_setting() if failures is None
                         else int(failures))
        self.probe_base_ms = (breaker_probe_base_ms_setting()
                              if probe_base_ms is None
                              else float(probe_base_ms))
        self.probe_cap_ms = (breaker_probe_cap_ms_setting()
                             if probe_cap_ms is None
                             else float(probe_cap_ms))
        self.probe_oks = max(1, breaker_probe_oks_setting()
                             if probe_oks is None else int(probe_oks))
        self._rng = rng or random.Random()
        self._lock = threading.Lock()
        self._state = BREAKER_CLOSED
        self._fail_streak = 0
        self._ok_streak = 0
        self._open_attempts = 0   # consecutive trips without a close
        self._open_until = 0.0    # monotonic end of the quarantine
        self._probe_inflight = False
        self._probe_started = 0.0
        self._trips = 0
        self._last_error = ""
        self.transitions: Dict[str, int] = {}

    def _probe_busy(self, now: float) -> bool:
        return (self._probe_inflight
                and now - self._probe_started < PROBE_ABANDON_S)

    def _transition(self, state: str) -> None:
        # the caller holds the lock
        if self._state == state:
            return
        self._state = state
        self.transitions[state] = self.transitions.get(state, 0) + 1

    def _probe_delay_s(self) -> float:
        window = backoff_window_ms(self.probe_base_ms, self.probe_cap_ms,
                                   max(1, self._open_attempts))
        # equal jitter: at least half the window, never zero
        return (window * (0.5 + 0.5 * self._rng.random())) / 1000.0

    def admit(self, now: Optional[float] = None) -> Optional[str]:
        """The router's placement gate: "closed" (normal traffic),
        "probe" (this request is the half-open probe) or None
        (quarantined). A probe grant never dispatched goes back through
        cancel()."""
        if now is None:
            now = time.monotonic()
        with self._lock:
            if self._state == BREAKER_CLOSED:
                return "closed"
            if self._state == BREAKER_OPEN:
                if now < self._open_until:
                    return None
                self._transition(BREAKER_HALF_OPEN)
                self._probe_inflight = True
                self._probe_started = now
                return "probe"
            if self._probe_busy(now):
                return None
            self._probe_inflight = True
            self._probe_started = now
            return "probe"

    def cancel(self, grant: Optional[str]) -> None:
        """Give back an admit() grant whose request never dispatched."""
        if grant != "probe":
            return
        with self._lock:
            self._probe_inflight = False

    def note_ok(self) -> None:
        """One successful dispatch on this replica."""
        with self._lock:
            if self._state == BREAKER_CLOSED:
                self._fail_streak = 0
                return
            if self._state == BREAKER_OPEN:
                return  # a straggler from before the trip proves nothing
            self._probe_inflight = False
            self._ok_streak += 1
            if self._ok_streak < self.probe_oks:
                return
            self._fail_streak = 0
            self._open_attempts = 0
            self._last_error = ""
            self._transition(BREAKER_CLOSED)

    def note_failure(self, error: str = "") -> None:
        """One failed dispatch on this replica."""
        with self._lock:
            if error:
                self._last_error = error
            if self._state == BREAKER_OPEN:
                return  # straggler from before the trip
            if self._state == BREAKER_HALF_OPEN:
                # the probe failed: back to quarantine, longer backoff
                self._probe_inflight = False
                self._ok_streak = 0
                self._open_attempts += 1
                self._open_until = time.monotonic() + self._probe_delay_s()
                self._transition(BREAKER_OPEN)
                return
            self._fail_streak += 1
            if self._fail_streak < self.failures:
                return
            self._ok_streak = 0
            self._open_attempts += 1
            self._trips += 1
            self._open_until = time.monotonic() + self._probe_delay_s()
            self._transition(BREAKER_OPEN)

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    @property
    def trips(self) -> int:
        with self._lock:
            return self._trips

    def probe_due(self, now: Optional[float] = None) -> bool:
        """True when the router should prefer this replica for one
        request (the probe)."""
        if now is None:
            now = time.monotonic()
        with self._lock:
            if self._state == BREAKER_OPEN:
                return now >= self._open_until
            if self._state == BREAKER_HALF_OPEN:
                return not self._probe_busy(now)
            return False

    def routable(self, now: Optional[float] = None) -> bool:
        """False when the replica is absent (open inside its backoff, or
        half-open with the probe slot taken)."""
        if now is None:
            now = time.monotonic()
        with self._lock:
            if self._state == BREAKER_CLOSED:
                return True
            if self._state == BREAKER_OPEN:
                return now >= self._open_until
            return not self._probe_busy(now)

    def snapshot(self) -> dict:
        now = time.monotonic()
        with self._lock:
            snap = {
                "state": self._state,
                "trips": self._trips,
                "failStreak": self._fail_streak,
                "openAttempts": self._open_attempts,
            }
            if self._state == BREAKER_OPEN:
                snap["probeInMs"] = round(
                    max(0.0, (self._open_until - now) * 1000.0), 1)
            if self._last_error:
                snap["lastError"] = self._last_error
            return snap

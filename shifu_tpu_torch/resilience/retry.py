"""Bounded retry with exponential backoff and full jitter (counterpart of
`shifu_tpu/resilience/retry.py`).

Wraps the transient seams — the chunk reader's `io` seam, the prefetch
worker's per-chunk transform, checkpoint writes — in a budgeted retry
loop: exponential backoff so a struggling source is not hammered, full
jitter so hosts resuming together do not retry in lockstep, and a hard
attempt budget so a persistent failure surfaces as the original
exception.

Knobs (per-seam overrides take precedence over the globals)::

    shifu.retry.max            attempt budget, default 3 (1 = no retry)
    shifu.retry.baseMs         first backoff, default 25 ms
    shifu.retry.capMs          backoff ceiling, default 2000 ms
    shifu.retry.<seam>.max     e.g. -Dshifu.retry.io.max=5

Each seam counts `retry.attempts` / `retry.recovered` /
`retry.exhausted{seam=}` in the obs registry, as in the JAX package;
recovered injected faults also count `fault.survived`.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Optional, Tuple, Type, TypeVar

from shifu_tpu_torch.resilience import faults
from shifu_tpu_torch.resilience.faults import (InjectedFaultError,
                                               PreemptionError)
from shifu_tpu_torch.utils import environment
from shifu_tpu_torch.utils.log import get_logger

log = get_logger(__name__)

T = TypeVar("T")

DEFAULT_MAX_ATTEMPTS = 3
DEFAULT_BASE_MS = 25.0
DEFAULT_CAP_MS = 2000.0

# Transient by default: injected faults and the OS-level errors flaky
# sources throw. PreemptionError is never retryable: preemption means
# "die cleanly and resume", not "try again".
DEFAULT_TRANSIENT: Tuple[Type[BaseException], ...] = (
    InjectedFaultError, OSError, TimeoutError,
)

def max_attempts(seam: str) -> int:
    return max(1, environment.get_int(
        f"shifu.retry.{seam}.max",
        environment.get_int("shifu.retry.max", DEFAULT_MAX_ATTEMPTS)))


def backoff_ms(seam: str) -> Tuple[float, float]:
    base = environment.get_float(
        f"shifu.retry.{seam}.baseMs",
        environment.get_float("shifu.retry.baseMs", DEFAULT_BASE_MS))
    cap = environment.get_float(
        f"shifu.retry.{seam}.capMs",
        environment.get_float("shifu.retry.capMs", DEFAULT_CAP_MS))
    return max(base, 0.0), max(cap, base)


def backoff_window_ms(base_ms: float, cap_ms: float, attempt: int) -> float:
    """The exponentially growing, capped backoff window of attempt
    number `attempt` (1-based); the serve breaker's probe schedule draws
    over the same window."""
    return min(max(cap_ms, 0.0),
               max(base_ms, 0.0) * (2.0 ** (attempt - 1)))


def full_jitter_delay(base_ms: float, cap_ms: float, attempt: int,
                      rng: Optional[random.Random] = None) -> float:
    """Seconds to wait before attempt number `attempt` (1-based): full
    jitter over the backoff window."""
    window = backoff_window_ms(base_ms, cap_ms, attempt)
    draw = (rng or random).random()
    return (window * draw) / 1000.0


def backoff_delay(seam: str, attempt: int,
                  rng: Optional[random.Random] = None) -> float:
    """Seconds to sleep before retry number `attempt` (1-based), under
    the seam's configured base and cap."""
    base, cap = backoff_ms(seam)
    return full_jitter_delay(base, cap, attempt, rng=rng)


def retry_call(
    fn: Callable[[], T],
    seam: str,
    retryable: Tuple[Type[BaseException], ...] = DEFAULT_TRANSIENT,
    sleeper: Callable[[float], None] = time.sleep,
    rng: Optional[random.Random] = None,
) -> T:
    """Call `fn()` under the seam's retry budget. Non-retryable
    exceptions (PreemptionError always) propagate untouched; a retryable
    one re-raises only once the budget is spent."""
    from shifu_tpu_torch.obs import registry

    budget = max_attempts(seam)
    reg = registry()
    failures = 0
    injected = 0
    while True:
        try:
            out = fn()
        except PreemptionError:
            raise
        except retryable as e:
            failures += 1
            if isinstance(e, InjectedFaultError):
                injected += 1
            if failures >= budget:
                reg.counter("retry.exhausted", seam=seam).inc()
                log.warning("%s: retry budget (%d) exhausted: %s",
                            seam, budget, e)
                raise
            reg.counter("retry.attempts", seam=seam).inc()
            delay = backoff_delay(seam, failures, rng=rng)
            log.debug("%s: attempt %d/%d failed (%s); retrying in %.0f ms",
                      seam, failures, budget, e, delay * 1000)
            sleeper(delay)
            continue
        if failures:
            reg.counter("retry.recovered", seam=seam).inc()
            if injected:
                faults.survived(seam, injected)
        return out

"""shifu_tpu_torch.obs — unified observability: metrics, tracing, run ledger
(counterpart of `shifu_tpu/obs/`).

One process-global metrics registry + span tracer, reset at the start of
each lifecycle step (BasicProcessor.run) and snapshotted into that step's
run manifest. Library code records through the module-level accessors so a
reset (new step, bench scenario, test) transparently redirects recording:

    from shifu_tpu_torch.obs import registry, span

    registry().counter("stats.rows_valid").inc(n)
    with span("stats.pass2", chunks=k):
        ...

Nested processor runs (combo invoking stats/norm/...) keep the outer step's
registry: only depth-0 begin_run() resets, every depth writes its own
manifest.

`install_jax_probes` and `obs/jaxprobe.py` have no counterpart: they
count XLA compiles and traces, and torch compiles nothing per shape.
`obs/fleetview.py` (the fleet collector behind `/fleet/*`) comes with
leases and peers (ROADMAP A.14).
"""

from __future__ import annotations

from shifu_tpu_torch.analysis.racetrack import tracked_lock
from shifu_tpu_torch.obs import profile as _profile
from shifu_tpu_torch.obs import reqtrace as _reqtrace
from shifu_tpu_torch.obs.ledger import RunLedger, format_runs, list_runs
from shifu_tpu_torch.obs.metrics import (
    MetricsRegistry,
    StageTimers,
    parse_prometheus,
)
from shifu_tpu_torch.obs.profile import ProgramProfiler
from shifu_tpu_torch.obs.tracing import Tracer

__all__ = [
    "MetricsRegistry",
    "ProgramProfiler",
    "RunLedger",
    "StageTimers",
    "Tracer",
    "begin_run",
    "end_run",
    "format_runs",
    "list_runs",
    "parse_prometheus",
    "profiler",
    "registry",
    "reset",
    "span",
    "tracer",
]

_lock = tracked_lock("obs.scope")
_registry = MetricsRegistry()
_tracer = Tracer()
_run_depth = 0


def registry() -> MetricsRegistry:
    """The process-global registry (current step's scope)."""
    return _registry


def tracer() -> Tracer:
    """The process-global span tracer (current step's scope)."""
    return _tracer


def profiler() -> ProgramProfiler:
    """The process-global program profiler (current step's scope) —
    per-seam dispatch and cost accounting (obs/profile.py)."""
    return _profile.profiler()


def span(name: str, **attrs):
    """Open a span on the current global tracer (resolved at entry, so a
    registry/tracer reset between calls is transparent)."""
    return _tracer.span(name, **attrs)


def reset() -> None:
    """Fresh registry + tracer + profiler + request-trace scope (step
    boundaries, bench scenarios, tests). The profiler's annotations
    survive — the kernels they describe do too."""
    global _registry, _tracer
    with _lock:
        _registry = MetricsRegistry()
        _tracer = Tracer()
        _profile.reset()
        _reqtrace.reset()


def begin_run() -> int:
    """Enter a step run; resets the registry/tracer at depth 0 only, so a
    composite processor's sub-steps accumulate into the outer scope.
    Returns the depth BEFORE entering (0 = outermost)."""
    global _run_depth
    with _lock:
        depth = _run_depth
        _run_depth += 1
    if depth == 0:
        reset()
    return depth


def end_run() -> None:
    global _run_depth
    with _lock:
        _run_depth = max(0, _run_depth - 1)

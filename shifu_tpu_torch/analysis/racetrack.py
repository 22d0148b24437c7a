"""Runtime race sanitizer: ``-Dshifu.sanitize=race`` lock instrumentation
(counterpart of `shifu_tpu/analysis/racetrack.py`).

The static concurrency pass (rules/concurrency.py) catches what the AST
can see — inconsistent nesting written in one file, blocking calls
syntactically inside a ``with lock:``. This module catches what only the
real thread interleavings can: the TSan analog for the host-side
coordination layer (micro-batcher, fleet router, health monitor,
prefetch workers, the obs registry).

Three instruments, all opt-in behind the ``race`` sanitizer mode:

  * ``tracked_lock(name)`` — the factory every ``self._lock =
    threading.Lock()`` site in the repo now calls. Unarmed it returns a
    **plain** ``threading.Lock`` (zero overhead — pinned in
    tests/test_racetrack.py and measured in the ``serve_latency``
    bench); armed it returns a ``TrackedLock`` that records, per
    thread, the stack of held locks with their acquisition sites, and
    on every nested acquisition adds an edge to a process-global
    lock-order graph. Two sites acquiring the same pair of lock *names*
    in opposite orders is a potential deadlock whether or not this run
    interleaved into one — the inversion is flagged the moment the
    second order is witnessed, with both witness sites in the verdict.
  * **long-hold detection** — a lock held longer than
    ``shifu.sanitize.race.holdMs`` (default 250) is recorded with its
    acquisition site. Long holds are the serve p99 killers (a device
    sync or file write under a lock every scoring thread needs);
    they're *reported*, not gated — ``clean`` stays true, matching the
    recompile watchdog's perf-bug-not-correctness-trap contract.
  * ``@guarded_by("_lock")`` — a method-level declaration that the
    named lock attribute must be held by the calling thread on entry
    (the repo's "caller holds the lock" docstring convention, made
    checkable). Unarmed the decorator returns the function untouched at
    call time beyond one flag read; armed, a violation is recorded with
    the lock name, attribute and method — recorded, and the verdict
    goes unclean, but the call proceeds (a sanitizer finding must not
    turn a survivable interleaving into an outage mid-serve).

Verdicts ride the ``shifu.sanitize/1`` ledger section:
``Sanitizer.verdict()`` (analysis/sanitize.py) embeds the tracker's
delta since the sanitizer was built, so every run manifest — lifecycle
steps and the serve shutdown — reports inversions / guard violations /
long holds beside the divergence mode's findings.
"""

from __future__ import annotations

import functools
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

from shifu_tpu_torch.utils import environment
from shifu_tpu_torch.utils.log import get_logger

log = get_logger(__name__)

DEFAULT_HOLD_MS = 250.0
# bounded event buffers: a pathological armed run must not grow without
# limit; counts keep incrementing past the cap, details stop
MAX_EVENTS = 100


def hold_ms_setting() -> float:
    """shifu.sanitize.race.holdMs — lock-hold duration (ms) above which
    an armed run records a long-hold event (0 disables)."""
    return environment.get_float("shifu.sanitize.race.holdMs",
                                 DEFAULT_HOLD_MS)


_forced: Optional[bool] = None  # test override (arm()/disarm())


def arm(on: bool = True) -> None:
    """Force arming on/off for this process (tests). ``arm(None)``
    restores environment-driven behavior."""
    global _forced
    _forced = on


def race_armed() -> bool:
    """Is the race mode armed? True when forced via arm(), else when
    -Dshifu.sanitize includes ``race`` (or ``all``). Checked at lock
    CONSTRUCTION time — arm the environment before building the objects
    whose locks you want tracked."""
    if _forced is not None:
        return _forced
    raw = (environment.get_property("shifu.sanitize", "") or "").lower()
    if not raw.strip():
        return False
    modes = {m.strip() for m in raw.split(",")}
    return "race" in modes or "all" in modes


_OWN_FILE = __file__


def _caller_site() -> str:
    """file:line of the nearest caller outside this module — the
    acquisition site the verdict quotes. One frame walk, no stack
    format: cheap enough for per-acquire use while armed."""
    f = sys._getframe(1)
    while f is not None and f.f_code.co_filename == _OWN_FILE:
        f = f.f_back
    if f is None:  # pragma: no cover - interpreter teardown
        return "?"
    path = f.f_code.co_filename
    short = (path.split("shifu_tpu_torch", 1)[-1]
             if "shifu_tpu_torch" in path else path)
    return f"{short}:{f.f_lineno} in {f.f_code.co_name}"


class RaceTracker:
    """Process-global witness state: per-thread held-lock stacks, the
    lock-order edge graph, and the three event classes."""

    def __init__(self) -> None:
        # plain Lock on purpose: the tracker must never track itself
        self._mu = threading.Lock()
        self._tls = threading.local()
        # (held_name, acquired_name) -> first witness "siteA -> siteB"
        self._edges: Dict[Tuple[str, str], str] = {}
        self.acquisitions = 0
        # counts are monotonic and NEVER capped — only the detail lists
        # stop growing (inversion details dedup per lock pair, the
        # others cap at MAX_EVENTS), so a delta-scoped verdict taken
        # late still reports every violation on its watch
        self.inversions: List[dict] = []
        self.inversion_count = 0
        self.long_holds: List[dict] = []
        self.long_hold_count = 0
        self.guard_violations: List[dict] = []
        self.guard_violation_count = 0

    # ---- per-thread held stack ----
    def _held(self) -> list:
        h = getattr(self._tls, "held", None)
        if h is None:
            h = []
            self._tls.held = h
        return h

    def held_names(self) -> List[str]:
        return [name for (_lk, name, _site, _t0) in self._held()]

    def holds(self, lock: "TrackedLock") -> bool:
        return any(lk is lock for (lk, _n, _s, _t) in self._held())

    # ---- witness recording ----
    def note_acquire(self, lock: "TrackedLock", site: str) -> None:
        held = self._held()
        b = lock.name
        inverted = 0
        with self._mu:
            self.acquisitions += 1
            for (_lk, a, asite, _t0) in held:
                if a == b:
                    # two same-named instances nested (e.g. two labeled
                    # metric locks): no order exists between instances
                    # of one name class, so no edge
                    continue
                edge = f"{asite} -> {site}"
                self._edges.setdefault((a, b), edge)
                rev = self._edges.get((b, a))
                if rev is not None:
                    # EVERY witnessed reversal counts (a sanitizer
                    # scoped after the first occurrence must still see
                    # a repeat on its watch); the detail dedups per pair
                    self.inversion_count += 1
                    inverted += 1
                    if not any(set(iv["locks"]) == {a, b}
                               for iv in self.inversions):
                        self.inversions.append({
                            "locks": sorted((a, b)),
                            "order": {f"{a} -> {b}": edge,
                                      f"{b} -> {a}": rev},
                            "thread": threading.current_thread().name,
                        })
        held.append((lock, b, site, time.perf_counter()))
        # the registry mirror acquires TRACKED metric locks, which
        # re-enter note_acquire -> self._mu: it must run after release
        for _ in range(inverted):
            self._count("inversions")

    def note_release(self, lock: "TrackedLock") -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] is lock:
                _lk, name, site, t0 = held.pop(i)
                budget = hold_ms_setting()
                if budget > 0:
                    ms = (time.perf_counter() - t0) * 1e3
                    if ms > budget:
                        with self._mu:
                            self.long_hold_count += 1
                            if len(self.long_holds) < MAX_EVENTS:
                                self.long_holds.append({
                                    "lock": name,
                                    "heldMs": round(ms, 2),
                                    "site": site,
                                    "thread":
                                        threading.current_thread().name,
                                })
                        self._count("long_holds")  # outside _mu: the
                        # mirror acquires tracked metric locks
                return
        # release of a lock this thread never tracked (acquired before
        # arming): nothing to unwind

    def note_guard_violation(self, lock_name: str, attr: str,
                             method: str) -> None:
        with self._mu:
            self.guard_violation_count += 1
            if len(self.guard_violations) < MAX_EVENTS:
                self.guard_violations.append({
                    "lock": lock_name,
                    "attr": attr,
                    "method": method,
                    "held": self.held_names(),
                    "thread": threading.current_thread().name,
                })
        self._count("guard_violations")  # outside _mu (tracked locks)

    def _count(self, kind: str) -> None:
        # mirrored into the metrics registry (like sanitizer.* trips) so
        # /metrics and ledger counter tables see race activity without
        # parsing verdicts; lazy import keeps this module obs-free
        # until a violation actually happens
        try:
            from shifu_tpu_torch.obs import registry

            registry().counter(f"sanitizer.race.{kind}").inc()
        except Exception as e:  # a broken registry must not break the tracker
            log.debug("race tracker: cannot mirror %s counter: %s",
                      kind, e)

    # ---- verdict plumbing (delta-scoped, like fault counters) ----
    def mark(self) -> Tuple[int, int, int, int]:
        with self._mu:
            return (self.inversion_count, self.long_hold_count,
                    self.guard_violation_count, self.acquisitions)

    def verdict(self, mark: Optional[Tuple[int, int, int, int]] = None
                ) -> dict:
        i0, h0, g0, a0 = mark or (0, 0, 0, 0)
        with self._mu:
            # counts come from the uncapped counters; event details
            # past MAX_EVENTS were dropped, so a mark taken after the
            # cap slices an empty detail delta while the count delta
            # still reports every violation
            return {
                "acquisitions": self.acquisitions - a0,
                "inversions": self.inversion_count - i0,
                "inversionEvents": [
                    dict(e) for e in self.inversions[
                        min(i0, len(self.inversions)):]],
                "guardViolations": self.guard_violation_count - g0,
                "guardViolationEvents": [
                    dict(e) for e in self.guard_violations[
                        min(g0, len(self.guard_violations)):]],
                "holdMsBudget": hold_ms_setting(),
                "longHolds": self.long_hold_count - h0,
                "longHoldEvents": [
                    dict(e) for e in self.long_holds[
                        min(h0, len(self.long_holds)):]],
            }

    def reset(self) -> None:
        """Tests only: a fresh graph + event lists (held stacks are
        per-thread and drain naturally)."""
        with self._mu:
            self._edges.clear()
            self.inversions = []
            self.inversion_count = 0
            self.long_holds = []
            self.long_hold_count = 0
            self.guard_violations = []
            self.guard_violation_count = 0
            self.acquisitions = 0


_TRACKER = RaceTracker()


def tracker() -> RaceTracker:
    return _TRACKER


class TrackedLock:
    """threading.Lock with acquisition witnessing (armed mode only)."""

    __slots__ = ("name", "_lock")

    def __init__(self, name: str) -> None:
        self.name = name
        self._lock = threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            _TRACKER.note_acquire(self, _caller_site())
        return ok

    def release(self) -> None:
        _TRACKER.note_release(self)
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> "TrackedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"TrackedLock({self.name!r}, locked={self.locked()})"


def tracked_lock(name: str):
    """The lock factory every ``_lock`` site uses: a plain
    ``threading.Lock`` when the race mode is unarmed (zero overhead —
    the common case), a ``TrackedLock`` carrying `name` when armed.
    `name` identifies the lock *class* (e.g. ``"loop.traffic"``), not
    the instance: the lock-order graph is over name classes, which is
    exactly the granularity a deadlock argument needs."""
    if race_armed():
        return TrackedLock(name)
    return threading.Lock()


def guarded_by(lock_attr: str):
    """Declare that a method may only run with ``self.<lock_attr>``
    held by the calling thread (the "caller holds the lock" docstring
    convention, made checkable). Unarmed: one flag read per call.
    Armed: a violation is recorded in the tracker (and the sanitizer
    verdict goes unclean) but the call proceeds — sanitizer findings
    report, they don't convert survivable interleavings into outages.

    The static pass reads the decorator too: a ``@guarded_by``-declared
    method is exempt from SH201's with-lock requirement (its callers
    carry the obligation)."""

    def deco(fn):
        qual = getattr(fn, "__qualname__", fn.__name__)

        @functools.wraps(fn)
        def wrapper(self, *args, **kwargs):
            if race_armed():
                lock = getattr(self, lock_attr, None)
                if isinstance(lock, TrackedLock):
                    if not _TRACKER.holds(lock):
                        _TRACKER.note_guard_violation(
                            lock.name, lock_attr, qual)
                elif lock is not None and hasattr(lock, "locked"):
                    # plain lock (constructed before arming): the best
                    # checkable claim is "held by someone"
                    if not lock.locked():
                        _TRACKER.note_guard_violation(
                            f"<untracked {lock_attr}>", lock_attr, qual)
            return fn(self, *args, **kwargs)

        wrapper.__shifu_guarded_by__ = lock_attr
        return wrapper

    return deco

"""Runtime sanitizer, the `divergence` and `race` modes (counterpart of
those parts of `shifu_tpu/analysis/sanitize.py`).

`-Dshifu.sanitize=divergence` arms a multi-host lockstep witness at the
host barriers of `parallel/hostsync.py`: every part published while
armed carries a stamp — a monotone per-(step, host) sequence id and a
digest of (config sha, barrier step, publishing call site, merge-key
order). An awaiting host that sees a peer's digest differ from its own,
or its sequence out of order, raises `DivergenceError` instead of
merging divergent state. The stamps are the JAX package's, byte for
byte, so both packages compute the same digest for the same barrier.

`-Dshifu.sanitize=race` arms the lock instrumentation of
analysis/racetrack.py: every `tracked_lock` built while armed witnesses
its acquisitions, and the verdict's `race` section reports the lock-order
inversions, `guarded_by` breaches (both make the verdict unclean) and
long holds (reported only) since the sanitizer was built. Locks are
tracked from CONSTRUCTION, so set the property before building the
objects whose locks should be watched.

The JAX package's other modes (`transfer`, `nan`, `recompile`) watch jit
transfer guards, NaN traps and compile counters; they are ROADMAP A.14
here and raise when named.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import threading
import traceback
from typing import Dict, List, Optional, Sequence

from shifu_tpu_torch.utils import environment
from shifu_tpu_torch.utils.log import get_logger

log = get_logger(__name__)

SCHEMA = "shifu.sanitize/1"
MODES = ("divergence", "race")
# the JAX package's other modes, and the ROADMAP item that ports them
UNPORTED_MODES = ("transfer", "nan", "recompile")


class DivergenceError(RuntimeError):
    """A host barrier saw divergent peer state while the divergence mode
    was armed: a peer's stamp digest differs from this host's (another
    config, call site or merge-key order) or its barrier sequence is out
    of order. Raised instead of merging."""


_lock = threading.Lock()
_current: Optional["Sanitizer"] = None


def modes_from_environment() -> List[str]:
    """Parse -Dshifu.sanitize (also 'all'); an unknown mode raises, and
    so does a mode the port has not ported yet, so a typo or a missing
    port cannot silently disarm the run."""
    raw = (environment.get_property("shifu.sanitize", "") or "").strip()
    if not raw:
        return []
    if raw.lower() == "all":
        raise ValueError("shifu.sanitize=all: the modes "
                         f"{', '.join(UNPORTED_MODES)} are not ported yet "
                         "(ROADMAP A.14); name divergence,race")
    modes = [m.strip().lower() for m in raw.split(",") if m.strip()]
    unported = [m for m in modes if m in UNPORTED_MODES]
    if unported:
        raise ValueError(f"shifu.sanitize: mode(s) {', '.join(unported)} "
                         "are not ported yet (ROADMAP A.14)")
    unknown = [m for m in modes if m not in MODES]
    if unknown:
        raise ValueError(
            f"shifu.sanitize: unknown mode(s) {', '.join(unknown)} "
            f"(known: {', '.join(MODES + UNPORTED_MODES)})")
    return modes


def _barrier_call_site() -> str:
    """module:function of the nearest stack frame outside the sanitizer
    and hostsync plumbing — the publish site whose identity the digest
    pins (not the line number: an edit between restarts is not
    divergence)."""
    skip = ("sanitize.py", "hostsync.py")
    for frame in reversed(traceback.extract_stack()[:-1]):
        base = frame.filename.rsplit("/", 1)[-1]
        if base not in skip:
            return f"{base}:{frame.name}"
    return "?"


class Sanitizer:
    """One armed sanitizer scope (a lifecycle step)."""

    def __init__(self, modes: Sequence[str]) -> None:
        self.modes = frozenset(modes)
        unknown = self.modes - set(MODES)
        if unknown:
            raise ValueError(f"unknown or unported sanitizer mode(s): "
                             f"{sorted(unknown)} (ROADMAP A.14)")
        self.divergence_trips = 0
        self.divergence_stamps = 0
        self.divergence_checks = 0
        self.events: List[dict] = []
        self._barrier_seq: Dict[tuple, int] = {}
        # race-mode scope: the verdict reports the tracker's DELTA from
        # this sanitizer's construction (the tracker is process-global)
        from shifu_tpu_torch.analysis import racetrack

        self._race_mark = racetrack.tracker().mark()

    @property
    def active(self) -> bool:
        return bool(self.modes)

    def barrier_stamp(self, step: str, host_index: int, sha: str,
                      merge_keys: Sequence[str]) -> dict:
        """The stamp publish_part embeds while armed: the per-(step,
        host) sequence id and the digest of (config sha, step, call
        site, merge-key order)."""
        with _lock:
            key = (step, int(host_index))
            seq = self._barrier_seq.get(key, 0) + 1
            self._barrier_seq[key] = seq
            self.divergence_stamps += 1
        digest = hashlib.sha256(json.dumps({
            "configSha": sha,
            "step": step,
            "site": _barrier_call_site(),
            "mergeKeys": list(merge_keys),
        }, sort_keys=True).encode("utf-8")).hexdigest()[:16]
        return {"seq": seq, "digest": digest}

    def check_barrier_stamps(self, step: str, own_host: int,
                             own_stamp: Optional[dict],
                             peer_stamps: Dict[int, Optional[dict]]
                             ) -> None:
        """Hold every peer's stamp against this host's at an await_parts
        barrier; raise DivergenceError on the first mismatch."""
        with _lock:
            self.divergence_checks += 1
        if own_stamp is None:
            return  # this host published unarmed
        for host, stamp in sorted(peer_stamps.items()):
            if host == own_host:
                continue
            problem = None
            if stamp is None:
                problem = ("peer published NO divergence stamp — fleet "
                           "is not uniformly armed")
            elif stamp.get("digest") != own_stamp.get("digest"):
                problem = (f"digest mismatch: peer {stamp.get('digest')}"
                           f" != own {own_stamp.get('digest')} (config "
                           f"sha, call-site or merge-key order differs)")
            elif stamp.get("seq") != own_stamp.get("seq"):
                problem = (f"out-of-order barrier sequence: peer "
                           f"{stamp.get('seq')} != own "
                           f"{own_stamp.get('seq')}")
            if problem:
                detail = (f"barrier '{step}': host {host} diverged from "
                          f"host {own_host} — {problem}")
                with _lock:
                    self.divergence_trips += 1
                    self.events.append({"kind": "divergence.trips",
                                        "stage": step, "detail": detail})
                log.warning("sanitizer[divergence] trip in %s: %s", step,
                            detail[:300])
                raise DivergenceError(
                    f"sanitizer[divergence] {detail}; refusing to merge")

    def verdict(self) -> dict:
        from shifu_tpu_torch.analysis import racetrack

        race_armed = "race" in self.modes
        race = {"armed": race_armed}
        race_dirty = 0
        if race_armed:
            race.update(racetrack.tracker().verdict(self._race_mark))
            # inversions + guard violations are correctness findings;
            # long holds are a perf hazard — reported, never gating
            race_dirty = race["inversions"] + race["guardViolations"]
        return {
            "schema": SCHEMA,
            "modes": sorted(self.modes),
            "race": race,
            "divergence": {
                "armed": "divergence" in self.modes,
                "trips": self.divergence_trips,
                "stampsPublished": self.divergence_stamps,
                "barriersChecked": self.divergence_checks,
            },
            "events": list(self.events),
            "clean": not (race_dirty or self.divergence_trips),
        }


def from_environment() -> Sanitizer:
    return Sanitizer(modes_from_environment())


def current() -> Optional[Sanitizer]:
    return _current


@contextlib.contextmanager
def activate(san: Sanitizer):
    """Make `san` the process-current sanitizer, so the hostsync seams
    find it; nested activation restores the previous one on exit."""
    global _current
    with _lock:
        prev, _current = _current, san
    try:
        yield san
    finally:
        with _lock:
            _current = prev


def _divergence_active() -> Optional[Sanitizer]:
    san = _current
    if san is not None and "divergence" in san.modes:
        return san
    return None


def barrier_stamp(step: str, host_index: int, sha: str,
                  merge_keys: Sequence[str]) -> Optional[dict]:
    """hostsync.publish_part seam: the stamp for the part header, or None
    when the divergence mode is disarmed."""
    san = _divergence_active()
    if san is None:
        return None
    return san.barrier_stamp(step, host_index, sha, merge_keys)


def check_barrier_stamps(step: str, own_host: int,
                         own_stamp: Optional[dict],
                         peer_stamps: Dict[int, Optional[dict]]) -> None:
    """hostsync.await_parts seam: validate peers before the merge; a
    no-op when disarmed."""
    san = _divergence_active()
    if san is None:
        return
    san.check_barrier_stamps(step, own_host, own_stamp, peer_stamps)

"""Span tracing: nested wall-clock spans serialized as a Chrome trace.

`with tracer.span("stats.pass2", rows=n):` records start/end/duration and
attributes; the collected events serialize to the Chrome-trace JSON format
(`chrome://tracing` / Perfetto "traceEvents" with ph="X" complete events),
one file per lifecycle step next to the run manifest (obs/ledger.py).

Thread-safe: the streaming pipeline's prefetch worker opens spans on its own
thread; events carry the recording thread id so overlap between the parse
thread and the device thread is visible as parallel tracks.

Bounded: the event store is a ring of `-Dshifu.trace.maxEvents` entries
(knob read at construction — obs.reset()/step boundaries re-read it). A
long-running `shifu serve` used to grow `_events` forever; now overflow
drops the OLDEST span and counts `trace.dropped`, so the newest spans —
the ones a shutdown manifest wants — survive at bounded memory.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

from shifu_tpu_torch.analysis.racetrack import tracked_lock
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional

from shifu_tpu_torch.utils import environment

DEFAULT_MAX_EVENTS = 65536


def max_events_setting() -> int:
    """shifu.trace.maxEvents — span-event ring capacity (per Tracer)."""
    return environment.get_int("shifu.trace.maxEvents", DEFAULT_MAX_EVENTS)


class Tracer:
    def __init__(self, max_events: Optional[int] = None) -> None:
        self._lock = tracked_lock("obs.tracing")
        self.max_events = max(1, (max_events_setting()
                                  if max_events is None else int(max_events)))
        self._events: deque = deque(maxlen=self.max_events)
        self._dropped = 0
        self._local = threading.local()
        # one wall-clock anchor so perf_counter offsets render as absolute-ish
        self._t0 = time.perf_counter()

    def _stack(self) -> List[str]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = []
            self._local.stack = st
        return st

    def current_path(self) -> str:
        """Dotted path of the innermost open span on this thread ("" if none)."""
        return "/".join(self._stack())

    @contextmanager
    def span(self, name: str, **attrs: Any) -> Iterator[Dict[str, Any]]:
        """Record a nested span; yields the mutable attrs dict so callers can
        attach results discovered mid-span (row counts, output paths)."""
        stack = self._stack()
        stack.append(name)
        args = dict(attrs)
        t0 = time.perf_counter()
        try:
            yield args
        finally:
            t1 = time.perf_counter()
            stack.pop()
            event = {
                "name": name,
                "ph": "X",
                "ts": (t0 - self._t0) * 1e6,  # Chrome trace wants microseconds
                "dur": (t1 - t0) * 1e6,
                "pid": os.getpid(),
                "tid": threading.get_ident(),
                "args": {k: _jsonable(v) for k, v in args.items()},
            }
            if stack:
                event["args"]["parent"] = "/".join(stack)
            overflow = False
            with self._lock:
                if len(self._events) == self._events.maxlen:
                    self._dropped += 1  # deque evicts the oldest span
                    overflow = True
                self._events.append(event)
            if overflow:
                from shifu_tpu_torch.obs import registry

                registry().counter("trace.dropped").inc()

    @property
    def events(self) -> List[dict]:
        with self._lock:
            return [dict(e) for e in self._events]

    @property
    def dropped(self) -> int:
        """Spans evicted by the -Dshifu.trace.maxEvents ring."""
        with self._lock:
            return self._dropped

    def span_seconds(self, name: str) -> float:
        """Total recorded duration of all spans with this name (seconds)."""
        with self._lock:
            return sum(e["dur"] for e in self._events
                       if e["name"] == name) / 1e6

    def to_chrome_trace(self) -> dict:
        with self._lock:
            events = sorted(self._events, key=lambda e: e["ts"])
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def save(self, path: str) -> Optional[str]:
        """Write the Chrome-trace JSON; returns the path (None if no spans)."""
        with self._lock:
            if not self._events:
                return None
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as fh:
            json.dump(self.to_chrome_trace(), fh)
        return path


def _jsonable(v: Any) -> Any:
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)

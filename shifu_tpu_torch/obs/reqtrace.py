"""Request-scoped distributed tracing for the serving fleet.

One end-to-end latency histogram cannot explain a p99: with N replicas
and continuous batching, tail latency is a routing/coalescing/convoy
question, and answering it takes per-request, per-stage evidence
(TensorFlow's timeline tooling exists for exactly this reason —
aggregate counters can't attribute a tail). Every admitted request gets
a `RequestTrace`:

  * a **trace id** — honoring an inbound `X-Shifu-Trace` header (the
    caller's distributed-tracing context), else generated — echoed in
    the response header and stamped into the traffic log so
    `shifu retrain`/`shifu promote` manifests carry serve→train→promote
    lineage;
  * a **per-stage timeline** over the whole serve path:

      featurize   raw record parse + host featurize + device_put
      route       drain-aware router placement + admission
      queue       admission queue wait (enqueue → worker pop)
      coalesce    micro-batch bucket wait (pop → dispatch)
      device      fused-program dispatch wall-clock
      d2h         result device_get
      serialize   response row build + JSON encode (HTTP path)

Retention is bounded and two-policy (`TraceBuffer`): **head sampling**
(`-Dshifu.trace.sample`, a deterministic stride like the shadow
sampler) keeps a representative slice, and **tail capture** keeps every
request slower than `-Dshifu.trace.slowMs` regardless of the sample —
the slow ones are the evidence. The ring holds at most
`-Dshifu.trace.maxTraces` traces; overflow drops the oldest and counts
`serve.trace.dropped`, so serve memory stays bounded at any uptime.

Stage durations also feed the `serve.stage_seconds{stage=,replica=}`
histograms (serve/fleet.py `finish_trace`), whose bucket samples carry
OpenMetrics exemplar trace ids — /metrics links straight to a captured
trace. Batcher bucket records (`note_batch`) witness which requests
shared a dispatch: the convoy evidence. Everything serializes as a
Chrome-trace/Perfetto-loadable JSON file next to the serve manifest
(`serve-<seq>.traces.json`), which `shifu trace` reads back.

Stage capture is thread-local (`capture_stages`/`note_stage`): the
micro-batcher opens a capture around the fused dispatch, the registry
notes featurize/device/d2h into it, and the batcher fans the captured
batch-level stages out to every request that rode the bucket — no
signature changes through the SwappableRegistry indirection.
"""

from __future__ import annotations

import itertools
import json
import os
import random
import re
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

from shifu_tpu_torch.analysis.racetrack import tracked_lock
from shifu_tpu_torch.fs.listing import sorted_glob
from shifu_tpu_torch.utils import environment

TRACES_SCHEMA = "shifu.traces/1"
STAGES = ("featurize", "route", "queue", "coalesce", "device", "d2h",
          "serialize")
TRACE_HEADER = "X-Shifu-Trace"

DEFAULT_TRACE_SAMPLE = 0.05
DEFAULT_SLOW_MS = 100.0
DEFAULT_MAX_TRACES = 512

_ID_RE = re.compile(r"[^A-Za-z0-9_.:-]")
_FILE_RE = re.compile(r"^(?P<step>.+)-(?P<seq>\d+)\.traces\.json$")


def trace_sample_setting() -> float:
    """shifu.trace.sample — head-sampling fraction of requests whose
    traces are retained (0 = only the slow tail is captured)."""
    return environment.get_float("shifu.trace.sample", DEFAULT_TRACE_SAMPLE)


def trace_slow_ms_setting() -> float:
    """shifu.trace.slowMs — tail capture: every request slower than this
    is retained regardless of head sampling (0 disables)."""
    return environment.get_float("shifu.trace.slowMs", DEFAULT_SLOW_MS)


def trace_max_traces_setting() -> int:
    """shifu.trace.maxTraces — retained-trace ring capacity."""
    return environment.get_int("shifu.trace.maxTraces", DEFAULT_MAX_TRACES)


# id generation runs once per request on the serve hot path, so it must
# not release the GIL: uuid4/os.urandom is a syscall per call, and a GIL
# release point in a 16-thread handler pool costs switch-interval-scale
# convoy waits (measured ~1.5 ms on p50). A process-seeded Mersenne
# prefix + monotone sequence is unique without ever leaving Python.
_ID_RAND = random.Random()  # seeded from urandom ONCE at import
_ID_PREFIX = f"{os.getpid() & 0xFFFF:04x}{_ID_RAND.getrandbits(16):04x}"
_ID_SEQ = itertools.count(1)


def new_trace_id() -> str:
    return f"{_ID_PREFIX}{next(_ID_SEQ) & 0xFFFFFFFF:08x}"


def clean_trace_id(raw: Optional[str]) -> Optional[str]:
    """Sanitize an inbound header id: it lands in metrics exemplars, the
    traffic log and file names, so it must stay token-shaped."""
    if not raw:
        return None
    cleaned = _ID_RE.sub("_", raw.strip())[:64]
    return cleaned or None


class RequestTrace:
    """One request's id + per-stage timeline. Stages are appended by the
    handler thread (featurize/route/serialize) and the replica's batcher
    worker (queue/coalesce/device/d2h) — never concurrently on the
    request's happy path, because the handler blocks on the request
    event between its stages and the worker's."""

    __slots__ = ("trace_id", "sampled", "started_unix", "_t0", "timeline",
                 "attrs", "total_seconds")

    def __init__(self, trace_id: Optional[str] = None,
                 sampled: bool = False) -> None:
        self.trace_id = clean_trace_id(trace_id) or new_trace_id()
        self.sampled = bool(sampled)
        self.started_unix = time.time()
        self._t0 = time.perf_counter()
        self.timeline: List[Tuple[str, float, float]] = []
        self.attrs: Dict[str, object] = {}
        self.total_seconds: Optional[float] = None

    def add_stage(self, stage: str, seconds: float,
                  t0: Optional[float] = None) -> None:
        """Record one stage duration; `t0` is the stage's absolute
        perf_counter start (defaults to now - seconds)."""
        if t0 is None:
            t0 = time.perf_counter() - seconds
        self.timeline.append((stage, t0 - self._t0, float(seconds)))

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add_stage(name, time.perf_counter() - t0, t0)

    def annotate(self, **attrs) -> None:
        self.attrs.update(attrs)

    def finish(self) -> float:
        """Close the trace (idempotent); returns total seconds."""
        if self.total_seconds is None:
            self.total_seconds = time.perf_counter() - self._t0
        return self.total_seconds

    def stage_totals(self) -> Dict[str, float]:
        """Summed seconds per stage (a stage split across components —
        e.g. featurize in the front end AND in the registry — sums)."""
        out: Dict[str, float] = {}
        for stage, _off, dur in list(self.timeline):
            out[stage] = out.get(stage, 0.0) + dur
        return out

    def summary(self) -> dict:
        total = self.finish()
        return {
            "id": self.trace_id,
            "sampled": self.sampled,
            "startedUnix": round(self.started_unix, 3),
            "totalMs": round(total * 1e3, 3),
            "stages": {k: round(v * 1e3, 3)
                       for k, v in self.stage_totals().items()},
            "timeline": [[stage, round(off * 1e3, 3), round(dur * 1e3, 3)]
                         for stage, off, dur in list(self.timeline)],
            "attrs": dict(self.attrs),
        }


# ---------------------------------------------------------------------------
# thread-local batch stage capture (batcher worker <-> registry seam)
# ---------------------------------------------------------------------------

_tl = threading.local()


class StageCapture:
    """One dispatch's captured batch-level evidence: stage durations
    (fanned out to every request that rode the bucket) plus attributes
    like the model-set sha that scored the batch (version lineage —
    attributable across a mid-roll promote)."""

    __slots__ = ("stages", "attrs")

    def __init__(self) -> None:
        self.stages: List[Tuple[str, float, Optional[float]]] = []
        self.attrs: Dict[str, object] = {}


@contextmanager
def capture_stages(enabled: bool = True):
    """Collect `note_stage`/`note_attr` calls on THIS thread — the
    batcher wraps the fused dispatch so the registry's featurize/device/
    d2h notes land here and fan out to every request in the bucket."""
    if not enabled:
        yield None
        return
    prev = getattr(_tl, "capture", None)
    cap = StageCapture()
    _tl.capture = cap
    try:
        yield cap
    finally:
        _tl.capture = prev


def note_stage(stage: str, seconds: float,
               t0: Optional[float] = None) -> None:
    """Record a stage duration into the active capture (no-op without
    one — the un-traced hot path pays one thread-local read)."""
    cap = getattr(_tl, "capture", None)
    if cap is not None:
        cap.stages.append((stage, float(seconds), t0))


def note_attr(**attrs) -> None:
    """Attach batch-level attributes (e.g. scoredSha) to the active
    capture; they annotate every request in the bucket."""
    cap = getattr(_tl, "capture", None)
    if cap is not None:
        cap.attrs.update(attrs)


# ---------------------------------------------------------------------------
# bounded retained-trace ring
# ---------------------------------------------------------------------------


class TraceBuffer:
    """Ring of retained traces + batch (convoy) records, memory-bounded.

    Head sampling uses the deterministic every-k-th stride the shadow
    sampler uses (k = round(1/sample)); tail capture retains anything
    slower than `slow_ms`. Overflow drops the OLDEST retained trace and
    counts `serve.trace.dropped` — the ring never grows."""

    def __init__(self, capacity: Optional[int] = None,
                 sample: Optional[float] = None,
                 slow_ms: Optional[float] = None) -> None:
        self.capacity = max(1, (trace_max_traces_setting()
                                if capacity is None else int(capacity)))
        self.sample = (trace_sample_setting() if sample is None
                       else float(sample))
        self.slow_ms = (trace_slow_ms_setting() if slow_ms is None
                        else float(slow_ms))
        self._lock = tracked_lock("obs.reqtrace")
        self._ring: deque = deque(maxlen=self.capacity)
        self._batches: deque = deque(maxlen=self.capacity)
        # lock-free request tick (itertools.count is C-atomic): the
        # stride draw runs once per admitted request on the hot path,
        # where a shared lock would serialize handler threads
        self._tick = itertools.count()
        self._stride = max(1, int(round(1.0 / max(self.sample, 1e-6))))
        # offered counts lock-free (itertools.count): the common case —
        # an unretained trace — must not take the ring lock at all, or
        # a batch's worth of handler threads convoy on it per dispatch
        self._offered = itertools.count()
        self._offered_n = 0
        self._dropped = 0

    @property
    def active(self) -> bool:
        return self.sample > 0.0 or self.slow_ms > 0.0

    def head_sampled(self) -> bool:
        """Deterministic stride draw for the next request."""
        if self.sample <= 0.0:
            return False
        if self.sample >= 1.0:
            return True
        return next(self._tick) % self._stride == 0

    def offer(self, trace: RequestTrace) -> bool:
        """Finish + maybe retain a trace; True when it entered the ring
        (the caller attaches metric exemplars only for retained ids)."""
        total_ms = trace.finish() * 1e3
        keep = trace.sampled or (self.slow_ms > 0.0
                                 and total_ms >= self.slow_ms)
        self._offered_n = next(self._offered) + 1
        if not keep:
            return False
        overflow = False
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self._dropped += 1
                overflow = True
            self._ring.append(trace)
        if overflow:
            from shifu_tpu_torch.obs import registry

            registry().counter("serve.trace.dropped").inc()
        return True

    def note_batch(self, replica: str, trace_ids: List[str],
                   requests: int, rows: int, started_unix: float,
                   dur_s: float) -> None:
        """Record one micro-batch bucket: which traces shared a dispatch
        (the convoy witness in the exported trace file)."""
        with self._lock:
            self._batches.append({
                "replica": str(replica),
                "traces": list(trace_ids),
                "requests": int(requests),
                "rows": int(rows),
                "startedUnix": float(started_unix),
                "durMs": round(dur_s * 1e3, 3),
            })

    # ---- read side ----
    @property
    def count(self) -> int:
        with self._lock:
            return len(self._ring)

    def traces(self, last: Optional[int] = None) -> List[dict]:
        """Retained trace summaries, newest first."""
        with self._lock:
            kept = list(self._ring)
        out = [t.summary() for t in reversed(kept)]
        return out[:last] if last is not None else out

    def slowest(self, n: int = 10, stage: Optional[str] = None
                ) -> List[dict]:
        """Top-n summaries by total ms (or by one stage's ms)."""
        return slowest_summaries(self.traces(), n, stage=stage)

    def get(self, trace_id: str) -> Optional[dict]:
        with self._lock:
            kept = list(self._ring)
        for t in reversed(kept):
            if t.trace_id == trace_id:
                return t.summary()
        return None

    def snapshot(self) -> dict:
        with self._lock:
            kept = list(self._ring)
            offered, dropped = self._offered_n, self._dropped
        slowest_t = max(kept, key=lambda t: t.finish(), default=None)
        return {
            "count": len(kept),
            "offered": offered,
            "dropped": dropped,
            "sample": self.sample,
            "slowMs": self.slow_ms,
            "capacity": self.capacity,
            "slowestMs": (round(slowest_t.finish() * 1e3, 3)
                          if slowest_t is not None else None),
            "slowestId": (slowest_t.trace_id
                          if slowest_t is not None else None),
        }

    # ---- Chrome-trace / Perfetto export ----
    def to_chrome_trace(self) -> dict:
        """Perfetto-loadable JSON object: one track (tid) per retained
        request, stage X-events on a shared unix-µs timebase, plus one
        batcher track per replica whose bucket spans list the trace ids
        that coalesced together."""
        with self._lock:
            kept = list(self._ring)
            batches = list(self._batches)
        pid = os.getpid()
        events: List[dict] = []
        for i, t in enumerate(kept):
            tid = i + 1
            events.append({"name": "thread_name", "ph": "M", "pid": pid,
                           "tid": tid,
                           "args": {"name": f"req {t.trace_id}"}})
            base_us = t.started_unix * 1e6
            total = t.finish()
            events.append({
                "name": "request", "ph": "X", "ts": base_us,
                "dur": total * 1e6, "pid": pid, "tid": tid,
                "args": {"trace": t.trace_id,
                         **{k: _jsonable(v) for k, v in t.attrs.items()}},
            })
            for stage, off, dur in list(t.timeline):
                events.append({
                    "name": stage, "ph": "X", "ts": base_us + off * 1e6,
                    "dur": dur * 1e6, "pid": pid, "tid": tid,
                    "args": {"trace": t.trace_id, "parent": "request"},
                })
        replicas = sorted({b["replica"] for b in batches})
        for r in replicas:
            tid = 100_000 + replicas.index(r)
            events.append({"name": "thread_name", "ph": "M", "pid": pid,
                           "tid": tid,
                           "args": {"name": f"batcher replica {r}"}})
        for b in batches:
            tid = 100_000 + replicas.index(b["replica"])
            events.append({
                "name": f"batch[{b['requests']}]", "ph": "X",
                "ts": b["startedUnix"] * 1e6, "dur": b["durMs"] * 1e3,
                "pid": pid, "tid": tid,
                "args": {"traces": b["traces"], "rows": b["rows"],
                         "replica": b["replica"]},
            })
        events.sort(key=lambda e: e.get("ts", 0.0))
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def write_traces(self, path: str) -> Optional[str]:
        """Write the Perfetto-loadable trace file (plus the summaries
        `shifu trace` reads back); None when nothing was retained."""
        doc = self.to_chrome_trace()
        with self._lock:
            empty = not self._ring
        if empty:
            return None
        doc["schema"] = TRACES_SCHEMA
        doc["shifuTraces"] = self.traces()
        doc["summary"] = self.snapshot()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(doc, fh)
        os.replace(tmp, path)
        return path


# ---------------------------------------------------------------------------
# process-global buffer (obs.reset() scope, like registry()/tracer())
# ---------------------------------------------------------------------------

_buffer: Optional[TraceBuffer] = None
_buffer_lock = tracked_lock("obs.reqtrace.scope")


def buffer() -> TraceBuffer:
    """The process-global request-trace ring; created lazily so the
    knobs bind AFTER -D parsing, re-read on obs.reset(). Double-checked:
    the steady-state read is lock-free (this runs per request on the
    serve hot path)."""
    global _buffer
    buf = _buffer
    if buf is not None:
        return buf
    with _buffer_lock:
        if _buffer is None:
            _buffer = TraceBuffer()
        return _buffer


def reset() -> None:
    global _buffer
    with _buffer_lock:
        _buffer = None


# ---------------------------------------------------------------------------
# ledger read side (`shifu trace` — jax-free)
# ---------------------------------------------------------------------------


def trace_files(root: str = ".") -> List[str]:
    """`<step>-<seq>.traces.json` files under <root>/.shifu/runs — the
    top-level ledger dir AND any per-run/per-process subdirectory one
    level down (a fleet member may ledger under its own dir) — newest
    (highest seq, then mtime) first, so `shifu trace --show <id>` and
    `--fleet` accept ids from ANY run or process, not just the newest
    serve run's file."""
    from shifu_tpu_torch.obs.ledger import runs_dir

    out = []
    base = runs_dir(root)
    for pattern in ("*.traces.json", os.path.join("*", "*.traces.json")):
        for path in sorted_glob(os.path.join(base, pattern)):
            m = _FILE_RE.match(os.path.basename(path))
            if m:
                out.append((int(m.group("seq")),
                            os.path.getmtime(path), path))
    return [p for _s, _t, p in sorted(out, reverse=True)]


FLEET_TRACE_BASENAME = "fleet.traces.json"  # no -<seq>: never re-globbed


def stitch_trace_files(paths: List[str], out_path: str) -> Optional[dict]:
    """Merge many shifu.traces/1 exports (one per process/run) into ONE
    Perfetto-loadable document: each source file becomes its own track
    group (pids remapped per file, `process_name` metadata from the file
    stem), with every span kept on the shared unix-µs timebase — so a
    promote round's coordinator and participant spans, which share the
    round trace id, line up across processes in one view. Returns the
    stitched doc (None when no source file was readable); unreadable or
    non-trace files are skipped, not fatal."""
    events: List[dict] = []
    summaries: List[dict] = []
    sources: List[dict] = []
    for path in paths:
        try:
            doc = load_trace_file(path)
        except (OSError, ValueError):
            continue
        pid = len(sources) + 1
        label = os.path.basename(path)
        if label.endswith(".traces.json"):
            label = label[: -len(".traces.json")]
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "args": {"name": label}})
        for e in doc.get("traceEvents", []):
            e = dict(e)
            e["pid"] = pid
            events.append(e)
        for s in doc.get("shifuTraces", []):
            s = dict(s)
            s["file"] = label
            summaries.append(s)
        sources.append({"path": path, "label": label,
                        "traces": len(doc.get("shifuTraces", []))})
    if not sources:
        return None
    events.sort(key=lambda e: e.get("ts", 0.0))
    out = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "schema": TRACES_SCHEMA,
        "shifuTraces": summaries,
        "summary": {"count": len(summaries), "stitched": True,
                    "sources": sources},
    }
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    tmp = out_path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(out, fh)
    os.replace(tmp, out_path)
    return out


def load_trace_file(path: str) -> dict:
    with open(path) as fh:
        doc = json.load(fh)
    if doc.get("schema") != TRACES_SCHEMA:
        raise ValueError(f"{path} is not a {TRACES_SCHEMA} file")
    return doc


def slowest_summaries(summaries: List[dict], n: int,
                      stage: Optional[str] = None) -> List[dict]:
    """Top-n by total ms, or by one stage's summed ms (requests that
    never entered the stage rank last)."""
    if stage is not None:
        def key(s):
            return s.get("stages", {}).get(stage, -1.0)
    else:
        def key(s):
            return s.get("totalMs", 0.0)
    return sorted(summaries, key=key, reverse=True)[:max(0, n)]


def dominant_stage(summary: dict) -> str:
    stages = summary.get("stages") or {}
    if not stages:
        return "-"
    return max(stages.items(), key=lambda kv: kv[1])[0]


def format_trace_table(summaries: List[dict]) -> str:
    """Human table for `shifu trace` listings."""
    if not summaries:
        return "(no traces captured — serve with -Dshifu.trace.sample>0 " \
               "or send an X-Shifu-Trace header)"
    header = (f"{'TRACE':<18} {'TOTAL ms':>9} {'DOMINANT':<10} "
              f"{'REPLICA':>7} STAGES (ms)")
    lines = [header]
    for s in summaries:
        stages = s.get("stages") or {}
        stage_str = " ".join(
            f"{k}={stages[k]:.2f}" for k in STAGES if k in stages)
        lines.append(
            f"{s.get('id', '?'):<18} {s.get('totalMs', 0.0):>9.2f} "
            f"{dominant_stage(s):<10} "
            f"{str(s.get('attrs', {}).get('replica', '-')):>7} "
            f"{stage_str}")
    return "\n".join(lines)


def format_trace_detail(summary: dict, path: Optional[str] = None) -> str:
    """Full per-stage timeline for `shifu trace --show <id>`."""
    lines = [f"trace {summary.get('id')}  total "
             f"{summary.get('totalMs', 0.0):.3f} ms"
             + (f"  ({path})" if path else "")]
    for k, v in sorted((summary.get("attrs") or {}).items()):
        lines.append(f"  {k}: {v}")
    lines.append(f"  {'STAGE':<10} {'AT ms':>10} {'DUR ms':>10}")
    for stage, off, dur in summary.get("timeline") or []:
        lines.append(f"  {stage:<10} {off:>10.3f} {dur:>10.3f}")
    if path:
        lines.append(f"open {path} in Perfetto (ui.perfetto.dev) for the "
                     "batch-convoy view")
    return "\n".join(lines)


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)

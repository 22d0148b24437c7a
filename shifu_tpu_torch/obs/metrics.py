"""Thread-safe metrics registry: counters, gauges, histograms, timers, series
(counterpart of `shifu_tpu/obs/metrics.py`, the same code: the same
operations give the same snapshot and byte-equal Prometheus text).

The reference's only run-level numbers are Hadoop job counters plus per-phase
wall-clock log lines (SURVEY §5); TensorFlow's summary/event system shows a
training stack needs a first-class metrics stream instead. This registry is
that stream for the port: every lifecycle step, the streaming pipeline,
the trainers and eval record into it, `BasicProcessor.run()` snapshots it into
the run manifest (obs/ledger.py), and the Prometheus/JSON exporters make the
same state scrapeable and diffable.

Kinds:
  Counter    monotonically increasing float (row counts, compile counts)
  Gauge      last-written value (AUC, column counts)
  Histogram  fixed-bucket distribution (value counts + sum/min/max)
  Timer      wall-clock accumulator: seconds + calls — the
             `utils/timing.StageTimers` kind
             (StageTimers below is the multi-stage facade over it)
  Series     (step, value) time series (per-epoch loss curves)

Metric identity is (name, sorted labels); all kinds are safe to update from
the prefetch worker thread and the consumer thread concurrently.
"""

from __future__ import annotations

import bisect
import json
import re
import time
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional, Tuple

from shifu_tpu_torch.analysis.racetrack import tracked_lock

DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                   1.0, 2.5, 5.0, 10.0, float("inf"))

LabelsKey = Tuple[Tuple[str, str], ...]


def _labels_key(labels: Dict[str, str]) -> LabelsKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _escape(v: str) -> str:
    # Prometheus exposition escaping for label values: \ and " (label
    # values come from user config — eval-set names — so this is load-bearing
    # for both valid scrape output and the lossless JSON round-trip)
    return v.replace("\\", "\\\\").replace('"', '\\"')


def _unescape(v: str) -> str:
    return v.replace('\\"', '"').replace("\\\\", "\\")


def _label_str(labels: LabelsKey) -> str:
    if not labels:
        return ""
    return "{" + ",".join(f'{k}="{_escape(v)}"' for k, v in labels) + "}"


def sanitize_name(name: str) -> str:
    """Prometheus metric names allow [a-zA-Z0-9_:] only."""
    return re.sub(r"[^a-zA-Z0-9_:]", "_", name)


class Counter:
    __slots__ = ("_lock", "_value")

    def __init__(self) -> None:
        self._lock = tracked_lock("obs.metrics.counter")
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    __slots__ = ("_lock", "_value")

    def __init__(self) -> None:
        self._lock = tracked_lock("obs.metrics.gauge")
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    __slots__ = ("_lock", "buckets", "_counts", "_sum", "_count",
                 "_min", "_max", "_exemplars")

    def __init__(self, buckets: Tuple[float, ...] = DEFAULT_BUCKETS) -> None:
        self._lock = tracked_lock("obs.metrics.histogram")
        self.buckets = tuple(sorted(buckets))
        if self.buckets[-1] != float("inf"):
            self.buckets = self.buckets + (float("inf"),)
        self._counts = [0] * len(self.buckets)
        self._sum = 0.0
        self._count = 0
        self._min = float("inf")
        self._max = float("-inf")
        # per-bucket last (value, trace id): /metrics links a slow
        # bucket straight to a captured request trace (OpenMetrics
        # exemplar annotations on the _bucket samples)
        self._exemplars: Dict[int, Tuple[float, str]] = {}

    def observe(self, v: float, exemplar: Optional[str] = None) -> None:
        v = float(v)
        # first bucket with v <= bound, C-speed (the last bound is +inf,
        # so any non-NaN value lands in range) — observe runs per
        # request on the serve path, where a Python linear scan is
        # measurable. NaN (v != v) counts in NO bucket, matching the
        # old linear scan's no-match behavior (bisect would mis-place
        # it in bucket 0).
        i = bisect.bisect_left(self.buckets, v) if v == v else -1
        with self._lock:
            if i >= 0:
                self._counts[i] += 1
                if exemplar is not None:
                    self._exemplars[i] = (v, str(exemplar))
            self._sum += v
            self._count += 1
            self._min = min(self._min, v)
            self._max = max(self._max, v)

    def add_binned(self, counts, total: float, n: int,
                   vmin: float, vmax: float) -> None:
        """Bulk merge pre-binned observations under ONE lock acquisition.
        The caller binned with the same `v <= bucket` rule observe()
        uses (e.g. np.searchsorted(buckets, values, side="left")) into
        one count per bucket — the batch path for hot loops where a
        per-value observe() would serialize on the lock."""
        if n <= 0:
            return
        with self._lock:
            for i, c in enumerate(counts):
                if c:
                    self._counts[i] += int(c)
            self._sum += float(total)
            self._count += int(n)
            self._min = min(self._min, float(vmin))
            self._max = max(self._max, float(vmax))

    def as_dict(self) -> dict:
        with self._lock:
            out = {
                "buckets": ["inf" if b == float("inf") else b
                            for b in self.buckets],
                "counts": list(self._counts),
                "sum": self._sum,
                "count": self._count,
                "min": self._min if self._count else None,
                "max": self._max if self._count else None,
            }
            if self._exemplars:
                out["exemplars"] = {
                    str(i): [v, eid]
                    for i, (v, eid) in sorted(self._exemplars.items())}
            return out

    @classmethod
    def from_dict(cls, d: dict) -> "Histogram":
        """Rebuild a histogram from its as_dict() form (the snapshot/
        JSON shape) — the read half of the lossless round-trip."""
        buckets = tuple(float("inf") if b == "inf" else float(b)
                        for b in d["buckets"])
        hist = cls(buckets)
        with hist._lock:
            hist._counts = [int(c) for c in d["counts"]]
            hist._sum = float(d["sum"])
            hist._count = int(d["count"])
            hist._min = (float(d["min"]) if d.get("min") is not None
                         else float("inf"))
            hist._max = (float(d["max"]) if d.get("max") is not None
                         else float("-inf"))
            hist._exemplars = {
                int(i): (float(v), str(eid))
                for i, (v, eid) in (d.get("exemplars") or {}).items()}
        return hist

    def merge(self, other: "Histogram") -> None:
        """EXACT merge of another histogram into this one: per-bucket
        counts, sum, count, min/max all add/combine losslessly — the ONE
        way snapshots are ever folded together (fleet federation, shadow
        evidence, bench report folding), so merged == recomputed-from-raw
        holds by construction. Requires identical pinned bucket edges
        (the serve path's exponential edges are pinned for exactly this)
        and raises ValueError on any mismatch rather than resampling.

        Exemplars: an existing local exemplar wins (it is linkable in
        THIS process's trace evidence); empty slots adopt the other's."""
        if self.buckets != other.buckets:
            raise ValueError(
                f"histogram bucket edges differ: {self.buckets} vs "
                f"{other.buckets} — exact merge needs identical pinned "
                "edges")
        # sequential snapshot-then-apply (never nest the two same-named
        # tracked locks): other's state is copied out under its lock,
        # folded in under ours
        with other._lock:
            counts = list(other._counts)
            o_sum, o_count = other._sum, other._count
            o_min, o_max = other._min, other._max
            o_ex = dict(other._exemplars)
        with self._lock:
            for i, c in enumerate(counts):
                if c:
                    self._counts[i] += c
            self._sum += o_sum
            self._count += o_count
            self._min = min(self._min, o_min)
            self._max = max(self._max, o_max)
            for i, ex in o_ex.items():
                self._exemplars.setdefault(i, ex)

    def quantile(self, q: float) -> Optional[float]:
        with self._lock:
            return quantile_from_counts(self.buckets, self._counts, q)


def quantile_from_counts(buckets, counts, q: float) -> Optional[float]:
    """Bucket-interpolated quantile (the Prometheus histogram_quantile
    rule: linear within the target bucket, the lower edge of the first
    bucket as 0). Shared by Histogram.quantile, the fleet view and
    `shifu top` (which recovers counts from scraped `_bucket{le=}`
    cumulative samples). Returns None on an empty histogram; a quantile
    landing in the +inf overflow bucket reports that bucket's lower
    edge (the largest finite bound)."""
    total = sum(counts)
    if total <= 0:
        return None
    q = min(max(float(q), 0.0), 1.0)
    rank = q * total
    seen = 0.0
    for i, c in enumerate(counts):
        if not c:
            continue
        seen += c
        if seen >= rank:
            hi = buckets[i]
            lo = buckets[i - 1] if i else 0.0
            if hi == float("inf"):
                return float(lo)
            frac = 1.0 - (seen - rank) / c
            return float(lo + (hi - lo) * frac)
    return float(buckets[-2]) if len(buckets) > 1 else None


class Timer:
    """Wall-clock accumulator (seconds + call count) — the StageTimers kind."""

    __slots__ = ("_lock", "_seconds", "_calls")

    def __init__(self) -> None:
        self._lock = tracked_lock("obs.metrics.timer")
        self._seconds = 0.0
        self._calls = 0

    def add(self, seconds: float, calls: int = 1) -> None:
        with self._lock:
            self._seconds += seconds
            self._calls += calls

    @contextmanager
    def time(self) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(time.perf_counter() - t0)

    @property
    def seconds(self) -> float:
        with self._lock:
            return self._seconds

    @property
    def calls(self) -> int:
        with self._lock:
            return self._calls


class Series:
    """(step, value) time series — per-epoch loss curves and the like."""

    __slots__ = ("_lock", "_points")

    def __init__(self) -> None:
        self._lock = tracked_lock("obs.metrics.series")
        self._points: List[List[float]] = []

    def append(self, step: float, value: float) -> None:
        with self._lock:
            self._points.append([float(step), float(value)])

    @property
    def points(self) -> List[List[float]]:
        with self._lock:
            return [list(p) for p in self._points]

    @property
    def last(self) -> Optional[float]:
        with self._lock:
            return self._points[-1][1] if self._points else None


class MetricsRegistry:
    """Label-aware, thread-safe registry with Prometheus + JSON exporters."""

    def __init__(self) -> None:
        self._lock = tracked_lock("obs.metrics.registry")
        self._counters: Dict[Tuple[str, LabelsKey], Counter] = {}
        self._gauges: Dict[Tuple[str, LabelsKey], Gauge] = {}
        self._histograms: Dict[Tuple[str, LabelsKey], Histogram] = {}
        self._timers: Dict[Tuple[str, LabelsKey], Timer] = {}
        self._series: Dict[Tuple[str, LabelsKey], Series] = {}

    def _get(self, store: dict, name: str, labels: dict, factory):
        key = (name, _labels_key(labels))
        with self._lock:
            m = store.get(key)
            if m is None:
                m = factory()
                store[key] = m
            return m

    # ---- accessors (get-or-create) ----
    def counter(self, name: str, **labels) -> Counter:
        return self._get(self._counters, name, labels, Counter)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(self._gauges, name, labels, Gauge)

    def histogram(self, name: str,
                  buckets: Tuple[float, ...] = DEFAULT_BUCKETS,
                  **labels) -> Histogram:
        return self._get(self._histograms, name, labels,
                         lambda: Histogram(buckets))

    def timer(self, name: str, **labels) -> Timer:
        return self._get(self._timers, name, labels, Timer)

    def series(self, name: str, **labels) -> Series:
        return self._get(self._series, name, labels, Series)

    def stage_timers(self, prefix: str) -> "StageTimers":
        """A StageTimers facade whose stages are registry timers named
        `prefix` with a `stage` label — streaming-pipeline timings recorded
        through it land in the run manifest, not just a log line."""
        return StageTimers(registry=self, prefix=prefix)

    # ---- snapshots ----
    def snapshot(self) -> dict:
        """Nested JSON-able view of the full registry state."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            histograms = dict(self._histograms)
            timers = dict(self._timers)
            series = dict(self._series)
        out: dict = {"counters": {}, "gauges": {}, "histograms": {},
                     "timers": {}, "series": {}}
        for (name, labels), c in sorted(counters.items()):
            out["counters"][name + _label_str(labels)] = c.value
        for (name, labels), g in sorted(gauges.items()):
            out["gauges"][name + _label_str(labels)] = g.value
        for (name, labels), h in sorted(histograms.items()):
            out["histograms"][name + _label_str(labels)] = h.as_dict()
        for (name, labels), t in sorted(timers.items()):
            out["timers"][name + _label_str(labels)] = {
                "seconds": t.seconds, "calls": t.calls}
        for (name, labels), s in sorted(series.items()):
            out["series"][name + _label_str(labels)] = s.points
        return out

    def is_empty(self) -> bool:
        with self._lock:
            return not (self._counters or self._gauges or self._histograms
                        or self._timers or self._series)

    # ---- JSON exporter (lossless round-trip via from_json) ----
    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.snapshot(), indent=indent, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "MetricsRegistry":
        snap = json.loads(text)
        reg = cls()
        for key, v in snap.get("counters", {}).items():
            name, labels = _parse_key(key)
            reg.counter(name, **labels).inc(v)
        for key, v in snap.get("gauges", {}).items():
            name, labels = _parse_key(key)
            reg.gauge(name, **labels).set(v)
        for key, h in snap.get("histograms", {}).items():
            name, labels = _parse_key(key)
            buckets = tuple(float("inf") if b == "inf" else float(b)
                            for b in h["buckets"])
            hist = reg.histogram(name, buckets=buckets, **labels)
            hist.merge(Histogram.from_dict(h))
        for key, t in snap.get("timers", {}).items():
            name, labels = _parse_key(key)
            reg.timer(name, **labels).add(t["seconds"], t["calls"])
        for key, pts in snap.get("series", {}).items():
            name, labels = _parse_key(key)
            s = reg.series(name, **labels)
            for step, value in pts:
                s.append(step, value)
        return reg

    # ---- Prometheus text exporter ----
    def flatten(self) -> Dict[str, float]:
        """Flat {prometheus_sample_name: value} — exactly the samples
        to_prometheus() emits (series are JSON-only; their last value is
        exported as a `<name>_last` gauge sample)."""
        flat: Dict[str, float] = {}
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            histograms = dict(self._histograms)
            timers = dict(self._timers)
            series = dict(self._series)
        for (name, labels), c in counters.items():
            flat[sanitize_name(name) + "_total" + _label_str(labels)] = c.value
        for (name, labels), g in gauges.items():
            flat[sanitize_name(name) + _label_str(labels)] = g.value
        for (name, labels), t in timers.items():
            base = sanitize_name(name)
            flat[base + "_seconds_total" + _label_str(labels)] = t.seconds
            flat[base + "_calls_total" + _label_str(labels)] = float(t.calls)
        for (name, labels), h in histograms.items():
            base = sanitize_name(name)
            d = h.as_dict()
            cum = 0
            for b, n in zip(d["buckets"], d["counts"]):
                cum += n
                le = "+Inf" if b == "inf" else repr(float(b))
                bl = _labels_key(dict(labels, le=le))
                flat[base + "_bucket" + _label_str(bl)] = float(cum)
            flat[base + "_sum" + _label_str(labels)] = d["sum"]
            flat[base + "_count" + _label_str(labels)] = float(d["count"])
        for (name, labels), s in series.items():
            last = s.last
            if last is not None:
                flat[sanitize_name(name) + "_last" + _label_str(labels)] = last
        return flat

    def _bucket_exemplars(self) -> Dict[str, Tuple[float, str]]:
        """{_bucket sample key: (value, trace id)} — same key shape as
        flatten(), so to_prometheus can annotate the matching lines."""
        with self._lock:
            histograms = dict(self._histograms)
        out: Dict[str, Tuple[float, str]] = {}
        for (name, labels), h in histograms.items():
            if not h._exemplars:  # bare emptiness peek (GIL-atomic):
                continue          # skip the second locked snapshot for
                                  # the common exemplar-less histogram
            base = sanitize_name(name)
            d = h.as_dict()
            for i, (v, eid) in (d.get("exemplars") or {}).items():
                b = d["buckets"][int(i)]
                le = "+Inf" if b == "inf" else repr(float(b))
                bl = _labels_key(dict(labels, le=le))
                out[base + "_bucket" + _label_str(bl)] = (float(v), eid)
        return out

    def to_prometheus(self) -> str:
        lines: List[str] = []
        types: Dict[str, str] = {}
        with self._lock:
            for (name, _), _c in self._counters.items():
                types[sanitize_name(name) + "_total"] = "counter"
            for (name, _), _g in self._gauges.items():
                types[sanitize_name(name)] = "gauge"
            for (name, _), _h in self._histograms.items():
                types[sanitize_name(name)] = "histogram"
        for base in sorted(types):
            lines.append(f"# TYPE {base} {types[base]}")
        flat = self.flatten()
        exemplars = self._bucket_exemplars()
        for sample in sorted(flat):
            line = f"{sample} {_fmt_value(flat[sample])}"
            ex = exemplars.get(sample)
            if ex is not None:
                # OpenMetrics exemplar: the slow bucket names the trace
                # id whose request landed in it (evidence, not a sample)
                v, eid = ex
                line += f' # {{trace_id="{_escape(eid)}"}} {_fmt_value(v)}'
            lines.append(line)
        return "\n".join(lines) + ("\n" if lines else "")


def _fmt_value(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    return repr(float(v))


def _parse_key(key: str) -> Tuple[str, Dict[str, str]]:
    """Invert `name{a="b",...}` snapshot/sample keys (escape-aware)."""
    if "{" not in key:
        return key, {}
    name, rest = key.split("{", 1)
    rest = rest.rstrip("}")
    labels: Dict[str, str] = {}
    for k, v in re.findall(r'(\w+)="((?:[^"\\]|\\.)*)"', rest):
        labels[k] = _unescape(v)
    return name, labels


def parse_prometheus(text: str) -> Dict[str, float]:
    """Parse the exporter's text format back to {sample_name: value} —
    the round-trip counterpart of MetricsRegistry.flatten()."""
    out: Dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        # exemplar annotations (` # {trace_id="..."} v`) are evidence
        # riding the sample line, not part of the sample value —
        # anchored at end-of-line so a label VALUE containing " # "
        # (label values only escape \ and ") can never be truncated
        line = re.sub(r' # \{[^{}]*\} \S+$', '', line)
        sample, _, value = line.rpartition(" ")
        if value == "+Inf":
            out[sample] = float("inf")
        elif value == "-Inf":
            out[sample] = float("-inf")
        else:
            out[sample] = float(value)
    return out


class StageTimers:
    """Named wall-clock accumulators (seconds + call counts).

    The pipeline's stage timers, backed by registry Timer metrics:
    constructed with a registry (or via `MetricsRegistry.stage_timers`),
    each stage is the registry timer `prefix{stage=<stage>}` and the timings
    land in the run manifest; constructed bare (`StageTimers()`), it keeps
    the original self-contained behavior for library/test use.

    Thread-safe either way: the prefetch worker times parse/bincode while
    the consumer thread times device/sync against the same instance.
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 prefix: str = "stage") -> None:
        self._registry = registry
        self._prefix = prefix
        self._lock = tracked_lock("obs.metrics.stage_timers")
        self._stages: Dict[str, Timer] = {}

    def _stage(self, stage: str) -> Timer:
        with self._lock:
            t = self._stages.get(stage)
            if t is None:
                if self._registry is not None:
                    t = self._registry.timer(self._prefix, stage=stage)
                else:
                    t = Timer()
                self._stages[stage] = t
            return t

    def add(self, stage: str, seconds: float, calls: int = 1) -> None:
        self._stage(stage).add(seconds, calls)

    @contextmanager
    def timer(self, stage: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(stage, time.perf_counter() - t0)

    def seconds(self, stage: str) -> float:
        return self._stage(stage).seconds

    def calls(self, stage: str) -> int:
        return self._stage(stage).calls

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            stages = dict(self._stages)
        return {
            k: {"seconds": round(t.seconds, 4), "calls": t.calls}
            for k, t in stages.items()
        }

    def summary(self) -> str:
        """One log-friendly line: "parse 1.21s/12 | device 0.43s/12"."""
        with self._lock:
            stages = dict(self._stages)
        if not stages:
            return "(no stages timed)"
        return " | ".join(
            f"{k} {t.seconds:.2f}s/{t.calls}" for k, t in stages.items()
        )

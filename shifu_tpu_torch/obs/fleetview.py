"""Fleet metrics federation: merge every serve process into one view
(counterpart of `shifu_tpu/obs/fleetview.py`).

PR 14 made shifu a fleet of serve PROCESSES named by heartbeat leases,
but /metrics stayed per-process — the operator of the actual production
unit had no single pane of glass, and the SLO was measured per-process
when it is a property of the service. This module is the one-hop
aggregation tree (PAPERS.md's In-Network Aggregation argument: every
peer publishes, any peer merges — no dedicated collector process to
die):

  collect()   scans the lease directory (resilience/lease.py names the
              fleet). A LIVE peer is scraped over loopback HTTP
              (`GET /admin/metrics.json`, the lossless snapshot the
              lease's advertised port serves); an EXPIRED peer falls
              back to the last on-disk time-series window it left
              behind (obs/timeseries.py) — its FINAL counters survive
              its death.
  merge()     folds the samples into a fresh MetricsRegistry with exact
              semantics: counters and timers SUM; histograms merge
              bucket-exact via the single Histogram.merge primitive
              (every serve histogram uses pinned edges, so merged ==
              recomputed-from-raw); gauges are only meaningful for LIVE
              processes and carry a `process=<leaseId>` label plus
              min/max/sum aggregate series (`agg=` label) — an expired
              peer's gauges are dropped (its queue depth is not 7, it
              is dead), its counters kept.
  slo_summary() fleet-level AND per-tenant SLO burn from the merged
              `serve.slo.good/bad{tenant=}` counters (cumulative bad
              fraction over the error budget, per-tenant targets from
              serve/health.py's knobs).

Samples are folded in sorted-leaseId order, so every peer computes the
SAME merged totals — `/fleet/metrics` answers identically (bit-exact
counter sums) no matter which process is asked.
"""

from __future__ import annotations

import json
import time
import urllib.request
from typing import Callable, Dict, List, Optional, Tuple

from shifu_tpu_torch.obs.metrics import (
    Histogram,
    MetricsRegistry,
    _parse_key,
    quantile_from_counts,
)
from shifu_tpu_torch.obs import timeseries
from shifu_tpu_torch.resilience import lease
from shifu_tpu_torch.utils import environment
from shifu_tpu_torch.utils.log import get_logger

log = get_logger(__name__)

METRICS_JSON_PATH = "/admin/metrics.json"
METRICS_JSON_SCHEMA = "shifu.obs.metrics/1"

DEFAULT_FETCH_TIMEOUT_MS = 1000.0


def fetch_timeout_ms_setting() -> float:
    """shifu.obs.fleet.timeoutMs — per-peer scrape timeout for the
    fleet metrics collector."""
    return environment.get_float("shifu.obs.fleet.timeoutMs",
                                 DEFAULT_FETCH_TIMEOUT_MS)


def _fetch_peer(host: str, port: int, timeout_s: float) -> dict:
    url = f"http://{host}:{port}{METRICS_JSON_PATH}"
    with urllib.request.urlopen(url, timeout=timeout_s) as resp:
        doc = json.loads(resp.read().decode("utf-8"))
    if not isinstance(doc, dict) or "metrics" not in doc:
        raise ValueError(f"malformed metrics document from {url}")
    return doc


def collect(root: str, self_id: Optional[str] = None,
            self_snapshot: Optional[Callable] = None,
            timeout_s: Optional[float] = None) -> List[dict]:
    """One sample per leased process: ``{"leaseId", "live", "source"
    ("local"|"http"|"disk"|"none"), "metrics" (snapshot dict or None),
    "info", "ageMs", "error"?}``. The caller's own process samples
    locally via `self_snapshot()` (no HTTP hop to self); peers scrape
    over the port their lease advertises; expired (or unreachable)
    peers fall back to their on-disk time-series."""
    if timeout_s is None:
        timeout_s = fetch_timeout_ms_setting() / 1000.0
    samples: List[dict] = []
    seen_self = False
    for doc in lease.scan(root):
        lid = doc["leaseId"]
        info = doc.get("info") or {}
        sample = {"leaseId": lid, "live": not doc["expired"],
                  "source": "none", "metrics": None, "info": info,
                  "ageMs": doc["ageMs"]}
        if self_id is not None and lid == self_id:
            seen_self = True
            sample["live"] = True  # we are demonstrably running
            if self_snapshot is not None:
                sample["metrics"] = self_snapshot()
                sample["source"] = "local"
            samples.append(sample)
            continue
        if not doc["expired"] and info.get("port"):
            try:
                fetched = _fetch_peer(info.get("host") or "127.0.0.1",
                                      int(info["port"]), timeout_s)
                sample["metrics"] = fetched.get("metrics")
                sample["source"] = "http"
                samples.append(sample)
                continue
            except Exception as e:  # scrape failure degrades to disk —
                # a wedged peer's last windows beat an empty row
                sample["error"] = str(e)
        disk = timeseries.last_snapshot(root, lid)
        if disk is not None:
            sample["metrics"] = disk["metrics"]
            sample["source"] = "disk"
            sample["diskTs"] = disk["ts"]
        samples.append(sample)
    if self_id is not None and not seen_self and self_snapshot is not None:
        # leases disabled (-Dshifu.lease.ttlMs=0): a fleet of one still
        # answers its own /fleet endpoints
        samples.append({"leaseId": self_id, "live": True,
                        "source": "local", "metrics": self_snapshot(),
                        "info": {}, "ageMs": 0.0})
    return samples


def merge(samples: List[dict]) -> MetricsRegistry:
    """Fold samples (sorted by lease id — every peer computes identical
    totals) into a fresh registry with the semantics in the module
    docstring. Per-process series (`shifu.series`) are not federated —
    they are a per-run time axis, and obs/timeseries.py is the
    cross-process one."""
    reg = MetricsRegistry()
    conflicts = 0
    errors = 0
    # gauge aggregates: (name, labels-items) -> list of values
    agg: Dict[Tuple, List[float]] = {}
    for s in sorted(samples, key=lambda x: x["leaseId"]):
        m = s.get("metrics")
        if not m:
            if not s["live"]:
                continue
            errors += 1  # a live peer we could not read is a data hole
            continue
        lid = s["leaseId"]
        for key, v in m.get("counters", {}).items():
            name, labels = _parse_key(key)
            reg.counter(name, **labels).inc(v)
        for key, t in m.get("timers", {}).items():
            name, labels = _parse_key(key)
            reg.timer(name, **labels).add(t.get("seconds", 0.0),
                                          int(t.get("calls", 0)))
        for key, h in m.get("histograms", {}).items():
            name, labels = _parse_key(key)
            other = Histogram.from_dict(h)
            hist = reg.histogram(name, buckets=other.buckets, **labels)
            try:
                hist.merge(other)
            except ValueError:
                # unmergeable edges across processes (a knob-skewed
                # deployment): counted, never resampled
                conflicts += 1
        if not s["live"]:
            continue  # a dead process has no CURRENT state: no gauges
        for key, v in m.get("gauges", {}).items():
            name, labels = _parse_key(key)
            reg.gauge(name, **dict(labels, process=lid)).set(v)
            agg.setdefault((name, tuple(sorted(labels.items()))),
                           []).append(float(v))
    for (name, litems), values in agg.items():
        labels = dict(litems)
        reg.gauge(name, **dict(labels, agg="min")).set(min(values))
        reg.gauge(name, **dict(labels, agg="max")).set(max(values))
        reg.gauge(name, **dict(labels, agg="sum")).set(sum(values))
    live = sum(1 for s in samples if s["live"])
    reg.gauge("fleet.processes.live").set(live)
    reg.gauge("fleet.processes.expired").set(len(samples) - live)
    if conflicts:
        reg.counter("fleet.merge.conflicts").inc(conflicts)
    if errors:
        reg.counter("fleet.collect.errors").inc(errors)
    return reg


def slo_summary(reg: MetricsRegistry,
                snap: Optional[dict] = None) -> dict:
    """Fleet + per-tenant SLO burn from the MERGED good/bad counters:
    cumulative bad fraction over the error budget (1 - target). The
    rolling-window burn stays per-process (each SloTracker's gauge rides
    the merge with its process= label); this is the fleet-lifetime
    number the smoke asserts survives a member's death."""
    from shifu_tpu_torch.serve.health import slo_target_setting, \
        tenant_slo_target

    good: Dict[str, float] = {}
    bad: Dict[str, float] = {}
    if snap is None:
        snap = reg.snapshot()
    for key, v in snap.get("counters", {}).items():
        name, labels = _parse_key(key)
        if name not in ("serve.slo.good", "serve.slo.bad"):
            continue
        tenant = labels.get("tenant", "")
        store = good if name == "serve.slo.good" else bad
        store[tenant] = store.get(tenant, 0.0) + v

    def _scope(g: float, b: float, target: float) -> dict:
        total = g + b
        frac = (b / total) if total else 0.0
        return {"good": int(g), "bad": int(b),
                "badFraction": round(frac, 6),
                "target": target,
                "burn": round(frac / max(1e-9, 1.0 - target), 4)}

    tenants = sorted(set(good) | set(bad))
    out = {
        "fleet": _scope(sum(good.values()), sum(bad.values()),
                        slo_target_setting()),
        "tenants": {
            t: _scope(good.get(t, 0.0), bad.get(t, 0.0),
                      tenant_slo_target(t) if t else slo_target_setting())
            for t in tenants},
    }
    reg.gauge("fleet.slo.burn").set(out["fleet"]["burn"])
    for t, scope in out["tenants"].items():
        if t:
            reg.gauge("fleet.slo.burn", tenant=t).set(scope["burn"])
    return out


def stage_quantiles(reg: MetricsRegistry,
                    qs: Tuple[float, ...] = (0.5, 0.99),
                    snap: Optional[dict] = None) -> dict:
    """Per-stage latency quantiles from the merged
    `serve.stage_seconds{stage=}` histograms (all replica/process series
    of one stage folded bucket-exact first) — the numbers `shifu top`
    and /fleet/healthz print."""
    per_stage: Dict[str, Histogram] = {}
    if snap is None:
        snap = reg.snapshot()
    for key, h in snap.get("histograms", {}).items():
        name, labels = _parse_key(key)
        if name != "serve.stage_seconds":
            continue
        stage = labels.get("stage", "?")
        other = Histogram.from_dict(h)
        have = per_stage.get(stage)
        if have is None:
            per_stage[stage] = other
        else:
            try:
                have.merge(other)
            except ValueError:
                continue
    out = {}
    for stage, hist in sorted(per_stage.items()):
        d = hist.as_dict()
        if not d["count"]:
            continue
        out[stage] = {"count": d["count"]}
        for q in qs:
            out[stage][f"p{int(q * 100)}"] = quantile_from_counts(
                hist.buckets, d["counts"], q)
    return out


def fleet_view(root: str, self_id: Optional[str] = None,
               self_snapshot: Optional[Callable] = None,
               timeout_s: Optional[float] = None
               ) -> Tuple[MetricsRegistry, dict]:
    """collect + merge + summarize: the merged registry (what
    /fleet/metrics renders as Prometheus text) and the JSON payload
    /fleet/healthz serves."""
    samples = collect(root, self_id=self_id, self_snapshot=self_snapshot,
                      timeout_s=timeout_s)
    reg = merge(samples)
    # one snapshot of the merged registry feeds both summaries — this
    # runs per /fleet scrape inside the serving process, where every
    # extra full-registry walk is GIL time taken from request threads
    snap = reg.snapshot()
    slo = slo_summary(reg, snap=snap)
    live = [s for s in samples if s["live"]]
    expired = [s for s in samples if not s["live"]]
    payload = {
        "ts": time.time(),
        "answeredBy": self_id,
        "liveProcesses": len(live),
        "expiredProcesses": len(expired),
        "processes": [
            {k: s[k] for k in
             ("leaseId", "live", "source", "ageMs", "info", "error")
             if k in s}
            for s in samples],
        "slo": slo,
        "stages": stage_quantiles(reg, snap=snap),
    }
    return reg, payload

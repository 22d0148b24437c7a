"""`shifu top` — a terminal dashboard over one serving process
(counterpart of `shifu_tpu/obs/top.py`).

The JAX `shifu top` polls a fleet member's `/fleet/healthz` and
`/fleet/metrics`, the merged view of every process that holds a lease.
The port's `shifu serve` has no leases or peers yet (ROADMAP A.14), so
`/fleet/*` answers 501 and the port's `top` reads ONE process: its
`GET /metrics` (Prometheus text, parsed back through `parse_prometheus`)
and its `GET /healthz`, and builds the same payload for that solo
process (`solo_view`). Per refresh it renders:

  * QPS — the `serve.requests` counter delta between two polls over
    the wall-clock between them (a rate needs two samples; the first
    frame shows `-`),
  * per-stage p50/p99 from the `serve.stage_seconds` histograms (every
    replica's series of a stage folded bucket-exact),
  * SLO burn from the `serve.slo.good/bad` counters,
  * circuit-breaker states (`serve.breaker.open{replica=}`),
  * the process row (its /healthz status).

`--once` renders a single frame without clearing the screen (scripts,
CI smoke); the interactive loop repaints with plain ANSI clears — no
curses, nothing beyond the stdlib and obs/metrics parsing.
"""

from __future__ import annotations

import json
import sys
import time
import urllib.error
import urllib.request
from typing import Dict, Optional, Tuple

from shifu_tpu_torch.obs.metrics import (_parse_key, parse_prometheus,
                                         quantile_from_counts)

REQUEST_SAMPLE = "serve_requests_total"


def _http_get(url: str, timeout_s: float = 5.0) -> bytes:
    with urllib.request.urlopen(url, timeout=timeout_s) as resp:
        return resp.read()


def fetch_view(base_url: str,
               timeout_s: float = 5.0) -> Tuple[dict, Dict[str, float]]:
    """One poll: (the solo payload, the /metrics flat samples)."""
    samples = parse_prometheus(
        _http_get(base_url + "/metrics", timeout_s).decode("utf-8"))
    try:
        health = json.loads(
            _http_get(base_url + "/healthz", timeout_s).decode("utf-8"))
    except urllib.error.HTTPError as e:  # 503 while draining: the body
        health = json.loads(e.read().decode("utf-8"))  # is the health
    return solo_view(base_url, health, samples), samples


def _stage_quantiles(samples: Dict[str, float],
                     qs: Tuple[float, ...] = (0.5, 0.99)) -> dict:
    """Per-stage quantiles from the `serve_stage_seconds_bucket`
    cumulative samples, every replica's series of a stage summed bucket
    by bucket (the edges are pinned, so the sum is exact)."""
    cum: Dict[str, Dict[float, float]] = {}
    for key, v in samples.items():
        name, labels = _parse_key(key)
        if name != "serve_stage_seconds_bucket":
            continue
        le = labels.get("le", "+Inf")
        edge = float("inf") if le == "+Inf" else float(le)
        per = cum.setdefault(labels.get("stage", "?"), {})
        per[edge] = per.get(edge, 0.0) + v
    out = {}
    for stage, per in sorted(cum.items()):
        edges = sorted(per)
        counts, prev = [], 0.0
        for e in edges:
            counts.append(per[e] - prev)
            prev = per[e]
        total = int(sum(counts))
        if not total:
            continue
        out[stage] = {"count": total}
        for q in qs:
            out[stage][f"p{int(q * 100)}"] = quantile_from_counts(
                edges, counts, q)
    return out


def _slo(samples: Dict[str, float], health: dict) -> dict:
    good = bad = 0.0
    for key, v in samples.items():
        name, _labels = _parse_key(key)
        if name == "serve_slo_good_total":
            good += v
        elif name == "serve_slo_bad_total":
            bad += v
    target = float((health.get("slo") or {}).get("target", 0.0) or 0.0)
    total = good + bad
    frac = (bad / total) if total else 0.0
    return {"fleet": {"good": int(good), "bad": int(bad),
                      "badFraction": round(frac, 6), "target": target,
                      "burn": round(frac / max(1e-9, 1.0 - target), 4)},
            "tenants": {}}


def solo_view(base_url: str, health: dict,
              samples: Dict[str, float]) -> dict:
    """The payload the JAX `/fleet/healthz` serves, for one process."""
    return {
        "ts": time.time(),
        "answeredBy": base_url,
        "liveProcesses": 1,
        "expiredProcesses": 0,
        "processes": [{"leaseId": base_url, "live": True,
                       "source": "self", "ageMs": 0.0,
                       "info": {"status": health.get("status")}}],
        "slo": _slo(samples, health),
        "stages": _stage_quantiles(samples),
        "health": health,
    }


def total_requests(samples: Dict[str, float]) -> float:
    """Fleet-lifetime request count: `serve.requests` summed over every
    label combination (format, replica — the fleet merge already summed
    processes)."""
    total = 0.0
    for key, v in samples.items():
        name, _labels = _parse_key(key)
        if name == REQUEST_SAMPLE:
            total += v
    return total


def _group_gauge(samples: Dict[str, float], name: str,
                 label: str) -> Dict[str, float]:
    """Sum a merged gauge's per-process samples by one label, skipping
    the min/max/sum aggregate series (they would double-count)."""
    out: Dict[str, float] = {}
    for key, v in samples.items():
        n, labels = _parse_key(key)
        if n != name or "agg" in labels:
            continue
        k = labels.get(label, "")
        out[k] = out.get(k, 0.0) + v
    return out


def _open_breakers(samples: Dict[str, float]) -> Tuple[int, list]:
    """(total breaker count, [label dict of each OPEN one])."""
    total, open_ = 0, []
    for key, v in samples.items():
        n, labels = _parse_key(key)
        if n != "serve_breaker_open" or "agg" in labels:
            continue
        total += 1
        if v >= 1.0:
            open_.append(labels)
    return total, open_


def render_frame(payload: dict, samples: Dict[str, float],
                 qps: Optional[float] = None) -> str:
    """One dashboard frame as plain text (pure — tests pin it without a
    server)."""
    lines = []
    slo = payload.get("slo") or {}
    fleet_slo = slo.get("fleet") or {}
    lines.append(
        f"shifu top — {payload.get('liveProcesses', 0)} live / "
        f"{payload.get('expiredProcesses', 0)} expired process(es) — "
        f"answered by {payload.get('answeredBy') or '?'}")
    qps_s = "-" if qps is None else f"{qps:.1f}"
    good = fleet_slo.get("good", 0)
    bad = fleet_slo.get("bad", 0)
    lines.append(
        f"qps {qps_s}   requests {int(total_requests(samples))}   "
        f"slo burn {fleet_slo.get('burn', 0.0):g} "
        f"(bad {bad}/{good + bad}, "
        f"target {fleet_slo.get('target', 0.0):g})")
    stages = payload.get("stages") or {}
    if stages:
        lines.append("")
        lines.append(f"{'STAGE':<10} {'P50 ms':>9} {'P99 ms':>9} "
                     f"{'COUNT':>9}")
        for stage in sorted(stages):
            row = stages[stage]
            p50, p99 = row.get("p50"), row.get("p99")
            lines.append(
                f"{stage:<10} "
                f"{(p50 * 1e3 if p50 is not None else 0.0):>9.3f} "
                f"{(p99 * 1e3 if p99 is not None else 0.0):>9.3f} "
                f"{row.get('count', 0):>9}")
    tenants = slo.get("tenants") or {}
    hbm = _group_gauge(samples, "serve_zoo_tenant_hbm_bytes", "tenant")
    queues = _group_gauge(samples, "serve_queue_depth", "tenant")
    names = sorted((set(tenants) | set(hbm) | set(queues)) - {""})
    if names:
        lines.append("")
        lines.append(f"{'TENANT':<16} {'SLO BURN':>9} {'HBM MB':>9} "
                     f"{'QUEUE':>6}")
        for t in names:
            scope = tenants.get(t) or {}
            lines.append(
                f"{t:<16} {scope.get('burn', 0.0):>9g} "
                f"{hbm.get(t, 0.0) / 1e6:>9.1f} "
                f"{int(queues.get(t, 0.0)):>6}")
    background = payload.get("background") or {}
    if background:
        lines.append("")
        lines.append(f"{'TRAINER':<16} {'STATE':<9} {'EPOCH':>6} "
                     f"{'STAGES':>7} {'HBM MB':>9} {'EVICTS':>7}")
        for t in sorted(background):
            b = background[t] or {}
            state = ("evicting" if b.get("evictRequested")
                     else "resident")
            stages = b.get("stages")
            lines.append(
                f"{t:<16} {state:<9} {b.get('epoch', -1):>6} "
                f"{(str(stages) if stages else '-'):>7} "
                f"{b.get('hbmMB', 0.0):>9.1f} "
                f"{b.get('evictions', 0):>7}")
    n_breakers, open_b = _open_breakers(samples)
    if n_breakers:
        lines.append("")
        if open_b:
            where = ", ".join(
                f"{b.get('replica', '?')}@{b.get('process', '?')}"
                for b in open_b)
            lines.append(f"breakers: {len(open_b)}/{n_breakers} OPEN "
                         f"({where})")
        else:
            lines.append(f"breakers: all {n_breakers} closed")
    processes = payload.get("processes") or []
    if processes:
        lines.append("")
        lines.append(f"{'PROCESS':<34} {'LIVE':<5} {'SOURCE':<6} "
                     f"{'AGE ms':>9}  STATUS")
        for p in processes:
            info = p.get("info") or {}
            status = info.get("status") or ("-" if p.get("live")
                                            else "expired")
            lines.append(
                f"{p.get('leaseId', '?'):<34} "
                f"{('yes' if p.get('live') else 'no'):<5} "
                f"{p.get('source', '?'):<6} "
                f"{p.get('ageMs', 0.0):>9.0f}  {status}")
    return "\n".join(lines)


def run_top(url: str, interval_s: float = 2.0, once: bool = False,
            as_json: bool = False) -> int:
    """The `shifu top` loop. Returns a process exit code."""
    url = url.rstrip("/")
    prev: Optional[Tuple[float, float]] = None
    try:
        while True:
            try:
                payload, samples = fetch_view(url)
            except Exception as e:  # unreachable/restarting server
                msg = f"shifu top: cannot reach {url}: {e}"
                if once:
                    print(msg, file=sys.stderr)
                    return 2
                sys.stdout.write("\x1b[2J\x1b[H" + msg + "\n")
                sys.stdout.flush()
                time.sleep(interval_s)
                continue
            now = time.monotonic()
            total = total_requests(samples)
            qps = None
            if prev is not None and now > prev[0]:
                # counters only grow; a NEGATIVE delta means the fleet's
                # membership changed under us — show 0, not nonsense
                qps = max(0.0, total - prev[1]) / (now - prev[0])
            prev = (now, total)
            if once:
                if as_json:
                    print(json.dumps(payload, indent=2, sort_keys=True))
                else:
                    print(render_frame(payload, samples, qps))
                return 0
            sys.stdout.write("\x1b[2J\x1b[H"
                             + render_frame(payload, samples, qps) + "\n")
            sys.stdout.flush()
            time.sleep(interval_s)
    except KeyboardInterrupt:
        return 0

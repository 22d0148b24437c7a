"""ProgramProfiler: per-seam dispatch and cost accounting (counterpart of
`shifu_tpu/obs/profile.py`).

Every hot path of the port funnels through a handful of dispatch seams
(the tree grower's histogram / scan / routing / error calls, the NN and
WDL epoch loops, the serve registry's batch program). This module makes
each seam self-accounting under the JAX package's seam names: per seam
the current obs scope accumulates the dispatch count, FLOPs and bytes
(scaled by `scaled(k)` for a dispatch that runs k loop bodies), and
wall-clock.

Timing: a `sync=True` seam calls `torch.cuda.synchronize(device)` on the
device of its result before it stops the clock (the JAX package calls
`jax.block_until_ready`), so its seconds are device seconds and the
program is `synced: true`. A `sync=False` seam adds NO synchronisation:
it records the host dispatch time and is flagged `synced: false`. The
profiler never puts a sync on a hot path that the JAX path lacks.

Cost: torch has no XLA `cost_analysis()`, so an eager seam reports
`costSource: "unavailable"` and counts dispatches only. The kernel
entries of ops/hist_kernel.py pass the analytic count of their bound
(`cost=(flops, bytes)`, the bytes each input is read once and each
output written once, and the operations of the work) and report
`costSource: "analytic"` — the port's one difference from the JAX
`shifu.profile/1` schema, whose values are "xla" and "unavailable".
`peakHbmBytes`, `argBytes`, `compileSeconds` and `programsCompiled` stay
in every row and stay 0: nothing is lowered or compiled per shape.

This is also the `device` fault/retry seam (`-Dshifu.faults=device...`),
as in the JAX package. `-Dshifu.profile.mode=off` makes every seam a
plain call.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

from shifu_tpu_torch.analysis.racetrack import tracked_lock

SCHEMA = "shifu.profile/1"

_tls = threading.local()

# a seam's cost: None (unavailable), (flops, bytes), or a callable of the
# dispatch's (args, kwargs) that returns (flops, bytes)
Cost = Union[None, Tuple[float, float], Callable[..., Tuple[float, float]]]


def _mode() -> str:
    from shifu_tpu_torch.utils import environment

    return (environment.get_property("shifu.profile.mode", "on")
            or "on").strip().lower()


class _CostEntry:
    """One dispatch's cost numbers and where they came from."""

    __slots__ = ("flops", "bytes_accessed", "source")

    def __init__(self, flops: Optional[float] = None,
                 bytes_accessed: Optional[float] = None,
                 source: str = "unavailable") -> None:
        self.flops = flops
        self.bytes_accessed = bytes_accessed
        self.source = source


@contextmanager
def scaled(k: float):
    """Multiply cost attribution for dispatches inside: a trainer that
    runs its loop body k times per dispatch wraps the dispatch in
    `scaled(k)` so FLOPs/bytes count k bodies."""
    prev = getattr(_tls, "scale", 1.0)
    _tls.scale = max(1.0, float(k))
    try:
        yield
    finally:
        _tls.scale = prev


def _current_scale() -> float:
    return getattr(_tls, "scale", 1.0)


class ProgramProfiler:
    """Per-obs-scope accumulator (reset with the registry/tracer)."""

    def __init__(self) -> None:
        self._lock = tracked_lock("obs.profile.profiler")
        self._programs: Dict[str, Dict[str, Any]] = {}

    # ---- recording ----
    def _stats(self, name: str) -> Dict[str, Any]:
        st = self._programs.get(name)
        if st is None:
            st = {
                "dispatches": 0, "scaledDispatches": 0.0, "flops": 0.0,
                "bytesAccessed": 0.0, "peakHbmBytes": 0.0, "argBytes": 0.0,
                "compileSeconds": 0.0, "programsCompiled": 0,
                "deviceSeconds": 0.0, "dispatchSeconds": 0.0,
                "syncedDispatches": 0, "costSource": "unavailable",
            }
            self._programs[name] = st
        return st

    def annotate(self, name: str, **kv: Any) -> None:
        """Attach kernel/program shaping facts (chosen block sizes, knob
        values) to seam `name`; they ride into every snapshot so a
        tuning sweep can read WHICH shaping produced WHICH roofline
        numbers from the manifest alone. Stored PROCESS-globally:
        annotations describe built kernels, which survive obs.reset()
        too — a build in an earlier scope must still be visible in a
        later scope's manifest."""
        with _ann_lock:
            _annotations_store.setdefault(name, {}).update(kv)

    def record_dispatch(self, name: str, entry: Optional[_CostEntry],
                        scale: float, seconds: float, sync: bool) -> None:
        with self._lock:
            st = self._stats(name)
            st["dispatches"] += 1
            # work units: scaled(k) dispatches count k loop bodies, so
            # cross-run diffs can normalize per body, not per call
            st["scaledDispatches"] += max(1.0, float(scale))
            st["dispatchSeconds"] += seconds
            if sync:
                st["syncedDispatches"] += 1
                st["deviceSeconds"] += seconds
            if entry is not None and entry.source != "unavailable":
                st["costSource"] = entry.source
                if entry.flops:
                    st["flops"] += entry.flops * scale
                if entry.bytes_accessed:
                    st["bytesAccessed"] += entry.bytes_accessed * scale

    # ---- views ----
    def snapshot(self, peaks=None) -> dict:
        """The manifest `profile` section: per-program table + totals,
        joined with the chip peak envelope into roofline terms."""
        from shifu_tpu_torch.obs import costmodel

        if peaks is None:
            peaks = costmodel.detect()
        with self._lock:
            progs = {k: dict(v) for k, v in self._programs.items()}
        with _ann_lock:
            annotations = {k: dict(v)
                           for k, v in _annotations_store.items()}
        out_programs = {}
        for name, st in sorted(progs.items()):
            synced = (st["dispatches"] > 0
                      and st["syncedDispatches"] == st["dispatches"])
            flops = st["flops"] or None
            bytes_ = st["bytesAccessed"] or None
            derived = costmodel.derive(
                flops, bytes_, st["deviceSeconds"] if synced else None,
                peaks)
            out_programs[name] = {
                "dispatches": st["dispatches"],
                "scaledDispatches": round(st["scaledDispatches"], 1),
                "flops": st["flops"],
                "bytesAccessed": st["bytesAccessed"],
                "peakHbmBytes": st["peakHbmBytes"],
                "argBytes": st["argBytes"],
                "compileSeconds": round(st["compileSeconds"], 4),
                "programsCompiled": st["programsCompiled"],
                "deviceSeconds": round(st["deviceSeconds"], 4),
                "dispatchSeconds": round(st["dispatchSeconds"], 4),
                "synced": synced,
                "costSource": st["costSource"],
                **derived,
            }
        tot = {"flops": 0.0, "bytesAccessed": 0.0, "peakHbmBytes": 0.0,
               "dispatches": 0, "deviceSeconds": 0.0, "compileSeconds": 0.0}
        all_synced = bool(out_programs)
        device_s = 0.0  # unrounded, so totals MFU matches the rows'
        for name, p in out_programs.items():
            tot["flops"] += p["flops"]
            tot["bytesAccessed"] += p["bytesAccessed"]
            tot["peakHbmBytes"] = max(tot["peakHbmBytes"],
                                      p["peakHbmBytes"])
            tot["dispatches"] += p["dispatches"]
            tot["deviceSeconds"] += p["deviceSeconds"]
            tot["compileSeconds"] += p["compileSeconds"]
            device_s += progs[name]["deviceSeconds"]
            all_synced = all_synced and p["synced"]
        tot["deviceSeconds"] = round(tot["deviceSeconds"], 4)
        tot["compileSeconds"] = round(tot["compileSeconds"], 4)
        tot.update(costmodel.derive(
            tot["flops"] or None, tot["bytesAccessed"] or None,
            device_s if all_synced and device_s else None, peaks))
        out = {
            "schema": SCHEMA,
            "chip": costmodel.peaks_dict(peaks),
            "programs": out_programs,
            "totals": tot,
        }
        if annotations:
            out["annotations"] = annotations
        return out


_profiler = ProgramProfiler()

# program-shaping annotations: process-global on purpose (see
# ProgramProfiler.annotate) — reset() preserves them
_annotations_store: Dict[str, Dict[str, Any]] = {}
_ann_lock = tracked_lock("obs.profile.annotations")


def profiler() -> ProgramProfiler:
    """The process-global profiler (current obs scope)."""
    return _profiler


def annotate(name: str, **kv) -> None:
    """Record program-shaping facts against seam `name` in the current
    obs scope (see ProgramProfiler.annotate)."""
    _profiler.annotate(name, **kv)


def reset() -> None:
    """Fresh per-scope accumulator (called from obs.reset()); the
    annotations deliberately survive."""
    global _profiler
    _profiler = ProgramProfiler()


# ---------------------------------------------------------------------------
# dispatch seams
# ---------------------------------------------------------------------------


def _first_tensor(out):
    """The first torch tensor in a dispatch result (nested tuples,
    lists, dict values and the attributes of a carry object), or None."""
    import torch

    stack = [out]
    while stack:
        x = stack.pop(0)
        if isinstance(x, torch.Tensor):
            return x
        if isinstance(x, (tuple, list)):
            stack.extend(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif hasattr(x, "__dict__"):
            stack.extend(vars(x).values())
    return None


def _synchronize(out) -> None:
    """`torch.cuda.synchronize` on the device of the result's first
    tensor; a CPU result (or none) needs nothing: eager CPU ops are done
    when they return."""
    t = _first_tensor(out)
    if t is not None and t.is_cuda:
        import torch

        torch.cuda.synchronize(t.device)


def _cost_entry(cost: Cost, args: tuple, kwargs: dict) -> _CostEntry:
    if cost is None:
        return _CostEntry()
    flops, bytes_ = cost(*args, **kwargs) if callable(cost) else cost
    return _CostEntry(float(flops) or None, float(bytes_) or None,
                      "analytic")


def dispatch(name: str, fn: Callable, *args, sync: bool = True,
             cost: Cost = None, **kwargs):
    """Run `fn(*args, **kwargs)` through the profiler under seam `name`.

    sync=True synchronizes the result's card before the clock stops
    (accurate device wall-clock — use where the caller synchronizes
    right after anyway); sync=False leaves the dispatch asynchronous and
    flags the program `synced: false` in snapshots. `cost` is the
    analytic (flops, bytes) of the work, or a callable of the
    dispatch's arguments that returns it.

    This is also the `device` fault/retry seam: with a fault plan armed
    (-Dshifu.faults=device...) the whole dispatch runs under the
    `shifu.retry.device.*` budget — a seam's program recomputes from its
    inputs, so re-running it on a transient runtime error is safe. The
    guard keeps the unfaulted hot path free of the extra frame.
    """
    from shifu_tpu_torch.resilience import faults as _faults

    if _faults.plan_active():
        from shifu_tpu_torch.resilience import retry as _retry

        def _attempt():
            _faults.fault_point("device")
            return _dispatch_inner(name, fn, args, kwargs, sync, cost)

        return _retry.retry_call(
            _attempt, seam="device",
            retryable=_retry.DEFAULT_TRANSIENT + (RuntimeError,))
    return _dispatch_inner(name, fn, args, kwargs, sync, cost)


def _dispatch_inner(name, fn, args, kwargs, sync, cost):
    if _mode() == "off":
        return fn(*args, **kwargs)
    entry = _cost_entry(cost, args, kwargs)
    scale = _current_scale()
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    if sync:
        _synchronize(out)
    _profiler.record_dispatch(name, entry, scale,
                              time.perf_counter() - t0, sync)
    return out


class ProfiledProgram:
    """Callable proxy a dispatch seam can cache in place of the raw
    callable; attribute access passes through."""

    def __init__(self, name: str, fn: Callable, *, sync: bool = False,
                 cost: Cost = None) -> None:
        self.profile_name = name
        self.fn = fn
        self.sync = sync
        self.cost = cost

    def __call__(self, *args, **kwargs):
        return dispatch(self.profile_name, self.fn, *args,
                        sync=self.sync, cost=self.cost, **kwargs)

    def __getattr__(self, item):
        return getattr(self.fn, item)


def wrap(name: str, fn: Callable, *, sync: bool = False,
         cost: Cost = None) -> ProfiledProgram:
    return ProfiledProgram(name, fn, sync=sync, cost=cost)


# ---------------------------------------------------------------------------
# rendering + diffing (shared by `shifu profile` and `shifu runs --diff`;
# pure stdlib, the JAX package's text)
# ---------------------------------------------------------------------------


def _fmt_count(v: Optional[float]) -> str:
    if v is None:
        return "-"
    v = float(v)
    for unit, div in (("T", 1e12), ("G", 1e9), ("M", 1e6), ("k", 1e3)):
        if abs(v) >= div:
            return f"{v / div:.2f}{unit}"
    if v != int(v):
        return f"{v:.4f}"
    return f"{v:.0f}"


def format_profile(manifest: dict) -> str:
    """Human per-program table for one manifest's profile section."""
    prof = manifest.get("profile") or {}
    programs = prof.get("programs") or {}
    head = (f"{manifest.get('step', '?')}-{manifest.get('seq', '?')} "
            f"[{manifest.get('status', '?')}]")
    chip = prof.get("chip") or {}
    if chip:
        head += (f"  chip={chip.get('name')} "
                 f"peak={chip.get('peakTflops')}TF/"
                 f"{chip.get('peakHbmGBs')}GBps ({chip.get('source')})")
    lines = [head]
    if not programs:
        lines.append("  (no profiled programs in this manifest)")
        return "\n".join(lines)
    lines.append(
        f"  {'PROGRAM':<24} {'DISP':>6} {'FLOPS':>9} {'BYTES':>9} "
        f"{'PEAK HBM':>9} {'COMPILE':>8} {'DEVICE':>8} {'TFLOP/s':>8} "
        f"{'MFU':>7} {'AI':>7} ROOFLINE")
    def _opt(v, spec):
        return "-" if v is None else format(v, spec)

    for name, p in programs.items():
        dev = (f"{p.get('deviceSeconds', 0.0):.3f}s"
               if p.get("synced") else
               f"~{p.get('dispatchSeconds', 0.0):.3f}s")
        lines.append(
            f"  {name:<24} {p.get('dispatches', 0):>6} "
            f"{_fmt_count(p.get('flops')):>9} "
            f"{_fmt_count(p.get('bytesAccessed')):>9} "
            f"{_fmt_count(p.get('peakHbmBytes')):>9} "
            f"{p.get('compileSeconds', 0.0):>7.3f}s {dev:>8} "
            f"{_opt(p.get('achievedTflops'), '.4f'):>8} "
            f"{_opt(p.get('mfu'), '.4f'):>7} "
            f"{_opt(p.get('arithmeticIntensity'), '.2f'):>7} "
            f"{p.get('roofline') or '-'}")
    tot = prof.get("totals") or {}
    if tot:
        lines.append(
            f"  {'TOTAL':<24} {tot.get('dispatches', 0):>6} "
            f"{_fmt_count(tot.get('flops')):>9} "
            f"{_fmt_count(tot.get('bytesAccessed')):>9} "
            f"{_fmt_count(tot.get('peakHbmBytes')):>9} "
            f"{tot.get('compileSeconds', 0.0):>7.3f}s "
            f"{tot.get('deviceSeconds', 0.0):>7.3f}s "
            f"{_opt(tot.get('achievedTflops'), '.4f'):>8} "
            f"{_opt(tot.get('mfu'), '.4f'):>7} "
            f"{_opt(tot.get('arithmeticIntensity'), '.2f'):>7} "
            f"{tot.get('roofline') or '-'}")
    return "\n".join(lines)


class DiffRow(dict):
    """One diffed key: {key, a, b, delta, pct, flag}."""


def _diff_rows(a: Dict[str, float], b: Dict[str, float]) -> List[DiffRow]:
    rows: List[DiffRow] = []
    for key in sorted(set(a) | set(b)):
        va, vb = a.get(key), b.get(key)
        if va is None:
            rows.append(DiffRow(key=key, a=None, b=vb, delta=None,
                                pct=None, flag="added"))
        elif vb is None:
            rows.append(DiffRow(key=key, a=va, b=None, delta=None,
                                pct=None, flag="removed"))
        elif va != vb:
            pct = ((vb - va) / abs(va) * 100.0) if va else None
            rows.append(DiffRow(key=key, a=va, b=vb, delta=vb - va,
                                pct=pct, flag="changed"))
    return rows


def render_diff(title: str, rows: List[DiffRow],
                breaches: Optional[List[str]] = None) -> str:
    """Shared diff table renderer (`shifu profile --diff`,
    `shifu runs --diff`)."""
    lines = [title]
    if not rows:
        lines.append("  (no differences)")
    else:
        lines.append(f"  {'KEY':<44} {'A':>12} {'B':>12} {'Δ':>12} "
                     f"{'Δ%':>8}  FLAG")
        for r in rows:
            pct = "-" if r["pct"] is None else f"{r['pct']:+.1f}%"
            lines.append(
                f"  {r['key']:<44} {_fmt_count(r['a']):>12} "
                f"{_fmt_count(r['b']):>12} {_fmt_count(r['delta']):>12} "
                f"{pct:>8}  {r['flag']}")
    for b in breaches or []:
        lines.append(f"  REGRESSION: {b}")
    return "\n".join(lines)


DIFF_DEFAULTS = {  # pct-increase gates; deterministic metrics only
    "flopsPct": 10.0,
    "bytesPct": 25.0,
    "hbmPct": 25.0,
    "secondsPct": 0.0,  # 0 = timing not gated (noisy by nature)
}


def diff_thresholds(overrides: Optional[dict] = None) -> dict:
    """DIFF_DEFAULTS <- -Dshifu.profile.diff.* <- explicit overrides."""
    from shifu_tpu_torch.utils import environment

    th = dict(DIFF_DEFAULTS)
    for key in th:
        th[key] = environment.get_float(f"shifu.profile.diff.{key}",
                                        th[key])
    for key, val in (overrides or {}).items():
        if val is not None:
            th[key] = float(val)
    return th


def _per_unit(p: dict, field: str) -> Optional[float]:
    """Cost per unit of work: scaledDispatches when recorded (a
    `scaled(epochs)` trainer dispatch counts epochs units, so runs with
    different epoch counts still compare per loop body), else raw
    dispatch count (older/hand-built manifests)."""
    d = p.get("scaledDispatches") or p.get("dispatches") or 0
    v = p.get(field)
    if not d or v is None:
        return None
    return v / d


def diff_profiles(ma: dict, mb: dict,
                  thresholds: Optional[dict] = None
                  ) -> Tuple[List[DiffRow], List[str]]:
    """Program-by-program regression diff of two manifests' profile
    sections (A = baseline, B = candidate). Cost metrics compare per
    unit of work (scaled dispatches) so a run with more trees/epochs
    doesn't read as a per-program regression; breaches are pct increases
    beyond the thresholds."""
    th = diff_thresholds(thresholds)
    pa = (ma.get("profile") or {}).get("programs") or {}
    pb = (mb.get("profile") or {}).get("programs") or {}
    rows: List[DiffRow] = []
    breaches: List[str] = []
    gates = (("flops", "flopsPct"), ("bytesAccessed", "bytesPct"),
             ("peakHbmBytes", "hbmPct"), ("deviceSeconds", "secondsPct"))
    for name in sorted(set(pa) | set(pb)):
        a, b = pa.get(name), pb.get(name)
        if a is None or b is None:
            rows.append(DiffRow(key=name, a=None, b=None, delta=None,
                                pct=None,
                                flag="added" if a is None else "removed"))
            continue
        for field, gate in gates:
            if field == "peakHbmBytes":  # a high-water mark, not a sum
                va, vb = a.get(field), b.get(field)
            else:
                va, vb = _per_unit(a, field), _per_unit(b, field)
            if va is None and vb is None:
                continue
            if va != vb:
                pct = ((vb - va) / abs(va) * 100.0) if va else None
                rows.append(DiffRow(key=f"{name}.{field}/unit"
                                    if field != "peakHbmBytes"
                                    else f"{name}.{field}",
                                    a=va, b=vb,
                                    delta=None if None in (va, vb)
                                    else vb - va,
                                    pct=pct, flag="changed"))
                limit = th.get(gate, 0.0)
                if limit > 0.0 and pct is not None and pct > limit:
                    breaches.append(
                        f"{name}: {field} +{pct:.1f}% > {limit:.0f}% "
                        f"({_fmt_count(va)} -> {_fmt_count(vb)})")
        da, db = a.get("dispatches", 0), b.get("dispatches", 0)
        if da != db:
            rows.append(DiffRow(key=f"{name}.dispatches", a=da, b=db,
                                delta=db - da,
                                pct=(db - da) / da * 100.0 if da else None,
                                flag="changed"))
    return rows, breaches


def diff_metric_snapshots(ma: dict, mb: dict) -> List[DiffRow]:
    """Counters/gauges diff of two manifests (`shifu runs --diff`)."""
    rows: List[DiffRow] = []
    for kind in ("counters", "gauges"):
        a = (ma.get("metrics") or {}).get(kind) or {}
        b = (mb.get("metrics") or {}).get(kind) or {}
        for r in _diff_rows(a, b):
            r["key"] = f"{kind[:-1]}:{r['key']}"
            rows.append(r)
    return rows


def resolve_manifest(root: str, ident: str) -> dict:
    """Locate one run manifest: a JSON file path, a `<step>-<seq>` id
    under <root>/.shifu/runs, or a bare step name (newest run wins)."""
    import json
    import os

    from shifu_tpu_torch.obs.ledger import list_runs, runs_dir

    if os.path.isfile(ident):
        with open(ident) as fh:
            m = json.load(fh)
        m["path"] = ident
        return m
    direct = os.path.join(runs_dir(root), f"{ident}.json")
    if os.path.isfile(direct):
        with open(direct) as fh:
            m = json.load(fh)
        m["path"] = direct
        return m
    runs = list_runs(root, step=ident, last=1)
    if runs:
        return runs[0]
    raise FileNotFoundError(
        f"no run manifest matches '{ident}' (tried a file path, "
        f"{direct}, and the newest '{ident}' step run)")

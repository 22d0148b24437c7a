"""Run ledger: one machine-readable manifest per lifecycle step
(counterpart of `shifu_tpu/obs/ledger.py`).

`BasicProcessor.run()` writes `<modelset>/.shifu/runs/<step>-<seq>.json`
after every step — success OR failure — carrying the step name, argv, config
hashes, the full metrics-registry snapshot (row counts, stage timers,
per-epoch training series, compile/transfer counters), the Chrome-trace path,
exit status, and the torch/CUDA runtime (`runtime`, where the JAX
manifest has `jax`). The reference's equivalent is
scattered Hadoop job counters and log lines that die with the console
(SURVEY §5); here "what did step X actually do" is a file you can diff.

`shifu runs [--last N] [--step S] [--json]` (cli.py) lists/inspects them.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
from typing import List, Optional

from shifu_tpu_torch.fs.listing import sorted_glob

SCHEMA = "shifu.run/1"
RUNS_SUBDIR = os.path.join(".shifu", "runs")

_MANIFEST_RE = re.compile(r"^(?P<step>.+)-(?P<seq>\d+)\.json$")


def runs_dir(root: str) -> str:
    return os.path.join(os.path.abspath(root), RUNS_SUBDIR)


def _config_hash(path: str) -> Optional[str]:
    try:
        with open(path, "rb") as fh:
            return hashlib.sha256(fh.read()).hexdigest()[:16]
    except OSError:
        return None


def torch_runtime_info() -> dict:
    """Runtime identity for the manifest: the torch and CUDA versions,
    the card count and the first card's name. Never raises — a step that
    failed before touching a device still gets a manifest."""
    try:
        import torch

        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        return {
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "deviceCount": count,
            "deviceName": torch.cuda.get_device_name(0) if count else "",
        }
    except Exception:  # pragma: no cover - torch/CUDA init failure
        return {}


class RunLedger:
    """Sequence-numbered manifest writer for one model-set root."""

    def __init__(self, root: str) -> None:
        self.root = os.path.abspath(root)
        self.dir = runs_dir(root)

    def next_seq(self, step: str) -> int:
        """1 + highest existing sequence number for this step."""
        highest = 0
        for path in sorted_glob(os.path.join(self.dir, f"{step}-*.json")):
            m = _MANIFEST_RE.match(os.path.basename(path))
            if m and m.group("step") == step:
                highest = max(highest, int(m.group("seq")))
        return highest + 1

    def manifest_path(self, step: str, seq: int) -> str:
        return os.path.join(self.dir, f"{step}-{seq}.json")

    def trace_path(self, step: str, seq: int) -> str:
        return os.path.join(self.dir, f"{step}-{seq}.trace.json")

    def write(
        self,
        step: str,
        seq: int,
        *,
        status: str,
        exit_status: int,
        started_at: float,
        elapsed_seconds: float,
        argv: List[str],
        registry,
        tracer=None,
        profile: Optional[dict] = None,
        error: Optional[str] = None,
        extra: Optional[dict] = None,
    ) -> str:
        """Write the manifest (and the step's Chrome trace beside it)."""
        import datetime

        os.makedirs(self.dir, exist_ok=True)
        trace_rel = None
        if tracer is not None:
            saved = tracer.save(self.trace_path(step, seq))
            if saved:
                trace_rel = os.path.relpath(saved, self.root)
        manifest = {
            "schema": SCHEMA,
            "step": step,
            "seq": seq,
            "status": status,
            "exitStatus": exit_status,
            "error": error,
            "argv": list(argv),
            "startedAt": datetime.datetime.fromtimestamp(
                started_at, datetime.timezone.utc
            ).isoformat(),
            "startedAtUnix": started_at,
            "elapsedSeconds": round(elapsed_seconds, 4),
            "configHashes": {
                "ModelConfig.json": _config_hash(
                    os.path.join(self.root, "ModelConfig.json")),
                "ColumnConfig.json": _config_hash(
                    os.path.join(self.root, "ColumnConfig.json")),
            },
            "runtime": torch_runtime_info(),
            "metrics": registry.snapshot(),
            "profile": profile,
            "tracePath": trace_rel,
        }
        if extra:
            manifest.update(extra)
        path = self.manifest_path(step, seq)
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(manifest, fh, indent=2, sort_keys=True)
        os.replace(tmp, path)
        return path


def list_runs(root: str, last: Optional[int] = None,
              step: Optional[str] = None) -> List[dict]:
    """Manifests under <root>/.shifu/runs, newest first; each dict gains a
    `path` key. Unparseable files are skipped."""
    out: List[dict] = []
    for path in sorted_glob(os.path.join(runs_dir(root), "*.json")):
        name = os.path.basename(path)
        if name.endswith(".trace.json") or not _MANIFEST_RE.match(name):
            continue
        try:
            with open(path) as fh:
                m = json.load(fh)
        except (OSError, ValueError):
            continue
        if step and m.get("step") != step:
            continue
        m["path"] = path
        out.append(m)
    out.sort(key=lambda m: (m.get("startedAtUnix", 0.0), m.get("seq", 0)),
             reverse=True)
    if last is not None:
        out = out[:last]
    return out


def format_runs(manifests: List[dict], show_traces: bool = False) -> str:
    """Human table for `shifu runs`; `show_traces` adds a TRACES column
    (captured request-trace count + slowest ms from the manifest's
    trace summary) so serve-run rows point at their `shifu trace`
    evidence."""
    if not manifests:
        return "(no runs recorded under .shifu/runs)"
    traces_col = f"{'TRACES':<14} " if show_traces else ""
    header = f"{'STEP':<10} {'SEQ':>4} {'STATUS':<7} {'ELAPSED':>9} " \
             f"{'STARTED (UTC)':<20} {traces_col}KEY METRICS"
    lines = [header]
    for m in manifests:
        metrics = m.get("metrics", {})
        hints = []
        counters = metrics.get("counters", {})
        for key in sorted(counters):
            base = key.split("{", 1)[0]
            if base.endswith((".rows", ".rows_valid", ".records")):
                hints.append(f"{base}={int(counters[key])}")
        gauges = metrics.get("gauges", {})
        for key in sorted(gauges):
            base = key.split("{", 1)[0]
            if base in ("eval.auc", "train.valid_error"):
                hints.append(f"{base}={gauges[key]:.4f}")
        n_series = len(metrics.get("series", {}))
        if n_series:
            hints.append(f"series={n_series}")
        started = (m.get("startedAt") or "")[:19]
        tr_cell = ""
        if show_traces:
            tr = m.get("traces") or {}
            if tr.get("count"):
                slowest = tr.get("slowestMs")
                tr_cell = (f"{tr['count']}@{slowest:.1f}ms"
                           if slowest is not None else str(tr["count"]))
            else:
                tr_cell = "-"
            tr_cell = f"{tr_cell:<14} "
        lines.append(
            f"{m.get('step', '?'):<10} {m.get('seq', 0):>4} "
            f"{m.get('status', '?'):<7} "
            f"{m.get('elapsedSeconds', 0.0):>8.2f}s "
            f"{started:<20} {tr_cell}{', '.join(hints[:4])}"
        )
    return "\n".join(lines)

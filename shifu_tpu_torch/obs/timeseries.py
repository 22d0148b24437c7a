"""On-disk metrics time-series: rotating delta-encoded snapshot chunks
(counterpart of `shifu_tpu/obs/timeseries.py`).

/metrics, run manifests and request traces each describe one process at
one instant (scrape time or shutdown). This module gives each serving
process a durable TIME AXIS:
a low-overhead snapshotter thread periodically captures the process
MetricsRegistry and appends delta-encoded windows to atomic rotating
chunk files under ``.shifu/runs/obs/<leaseId>/``: whole files land via
temp + os.replace, sequence numbers only grow, and a ``_meta.json``
sidecar names the schema. A SIGKILLed process therefore leaves its last
windows behind — its final counters survive the process — and
regression tooling gets real per-window series instead of only shutdown
manifests. The directory is named by the serving process's lease id
(resilience/lease.py), so the fleet collector (obs/fleetview.py) joins
it against the peer scan; a lease-less server (`-Dshifu.lease.ttlMs=0`)
snapshots under the solo id ``<hostname>-<pid>-solo``.

Encoding, per window:

  * the FIRST window of every chunk is a FULL registry snapshot, so
    each chunk file is self-contained — bounded retention can drop old
    chunks without breaking reconstruction;
  * later windows are DELTAS against the previous window: counters as
    increments, timers/gauges/histograms as changed-keys-only absolute
    values, series as newly appended points. An idle process writes
    near-empty windows.

The current chunk is atomically REWRITTEN on every tick (bounded by
``chunkWindows`` windows per file), so at most the in-flight tick is
lost to a kill; at ``chunkWindows`` the sequence rotates and chunks
older than ``retainChunks`` are deleted.

Knobs: ``-Dshifu.obs.snapshotMs`` (0 = off), ``-Dshifu.obs.
chunkWindows``, ``-Dshifu.obs.retainChunks``.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from typing import Callable, List, Optional

from shifu_tpu_torch.analysis.racetrack import tracked_lock
from shifu_tpu_torch.fs.listing import sorted_glob
from shifu_tpu_torch.utils import environment
from shifu_tpu_torch.utils.log import get_logger

log = get_logger(__name__)

OBS_SUBDIR = os.path.join(".shifu", "runs", "obs")
META_FILE = "_meta.json"
TIMESERIES_SCHEMA = "shifu.obs.timeseries/1"

_CHUNK_RE = re.compile(r"^obs-(\d+)\.json$")

DEFAULT_CHUNK_WINDOWS = 8
DEFAULT_RETAIN_CHUNKS = 16


def snapshot_ms_setting() -> float:
    """shifu.obs.snapshotMs — metrics time-series snapshot cadence for
    the on-disk per-process chunk files (0 disables the snapshotter)."""
    return environment.get_float("shifu.obs.snapshotMs", 0.0)


def chunk_windows_setting() -> int:
    """shifu.obs.chunkWindows — snapshot windows per rotating chunk
    file (the current chunk is atomically rewritten each tick)."""
    return environment.get_int("shifu.obs.chunkWindows",
                               DEFAULT_CHUNK_WINDOWS)


def retain_chunks_setting() -> int:
    """shifu.obs.retainChunks — rotated chunk files kept per process
    (older ones are deleted; each chunk is self-contained)."""
    return environment.get_int("shifu.obs.retainChunks",
                               DEFAULT_RETAIN_CHUNKS)


def obs_dir(root: str, lease_id: str) -> str:
    """One process's time-series dir: ``<root>/.shifu/runs/obs/<leaseId>``.
    The lease id (resilience/lease.py) is the
    fleet-wide process name,
    so the collector can join these dirs against the peer scan."""
    return os.path.join(os.path.abspath(root), OBS_SUBDIR, str(lease_id))


def list_chunks(root: str, lease_id: str) -> List[str]:
    """Chunk files in sequence (append) order."""
    out = []
    for path in sorted_glob(os.path.join(obs_dir(root, lease_id),
                                       "obs-*.json")):
        m = _CHUNK_RE.match(os.path.basename(path))
        if m:
            out.append((int(m.group(1)), path))
    return [p for _s, p in sorted(out)]


# ---- delta encoding ----
def _hist_changed(prev: Optional[dict], cur: dict) -> bool:
    return (prev is None or prev.get("count") != cur.get("count")
            or prev.get("sum") != cur.get("sum"))


def encode_window(prev: Optional[dict], cur: dict, ts: float) -> dict:
    """One window: full when `prev` is None, else the delta described in
    the module docstring. `prev`/`cur` are MetricsRegistry.snapshot()
    dicts; neither is mutated."""
    if prev is None:
        return {"ts": ts, "full": True, "metrics": cur}
    w: dict = {"ts": ts}
    counters = {k: v - prev.get("counters", {}).get(k, 0.0)
                for k, v in cur.get("counters", {}).items()
                if v != prev.get("counters", {}).get(k, 0.0)}
    gauges = {k: v for k, v in cur.get("gauges", {}).items()
              if v != prev.get("gauges", {}).get(k)}
    timers = {k: v for k, v in cur.get("timers", {}).items()
              if v != prev.get("timers", {}).get(k)}
    hists = {k: v for k, v in cur.get("histograms", {}).items()
             if _hist_changed(prev.get("histograms", {}).get(k), v)}
    series = {}
    for k, pts in cur.get("series", {}).items():
        seen = len(prev.get("series", {}).get(k, []))
        if len(pts) > seen:
            series[k] = pts[seen:]
    for key, val in (("counters", counters), ("gauges", gauges),
                     ("timers", timers), ("histograms", hists),
                     ("series", series)):
        if val:
            w[key] = val
    return w


def apply_window(base: Optional[dict], window: dict) -> dict:
    """Fold one window into a reconstructed absolute snapshot dict
    (returns a new dict; `base` is not mutated)."""
    if window.get("full"):
        return json.loads(json.dumps(window["metrics"]))
    out = json.loads(json.dumps(base)) if base else {
        "counters": {}, "gauges": {}, "histograms": {}, "timers": {},
        "series": {}}
    for k, dv in window.get("counters", {}).items():
        out["counters"][k] = out["counters"].get(k, 0.0) + dv
    for k, v in window.get("gauges", {}).items():
        out["gauges"][k] = v
    for k, v in window.get("timers", {}).items():
        out["timers"][k] = v
    for k, v in window.get("histograms", {}).items():
        out["histograms"][k] = v
    for k, pts in window.get("series", {}).items():
        out["series"][k] = out["series"].get(k, []) + pts
    return out


def read_windows(root: str, lease_id: str) -> List[dict]:
    """Reconstructed absolute snapshots, one per window, in time order:
    ``[{"ts": <unix>, "metrics": <snapshot dict>}, ...]``. Unreadable or
    torn files are skipped (the atomic-write discipline makes torn files
    impossible in practice, but a reader must never crash on a dir a
    killed process left behind)."""
    out: List[dict] = []
    for path in list_chunks(root, lease_id):
        try:
            with open(path) as fh:
                chunk = json.load(fh)
        except (OSError, ValueError):
            continue
        if chunk.get("schema") != TIMESERIES_SCHEMA:
            continue
        base: Optional[dict] = None
        for w in chunk.get("windows", []):
            base = apply_window(base, w)
            out.append({"ts": w.get("ts", 0.0), "metrics": base})
    return out


def last_snapshot(root: str, lease_id: str) -> Optional[dict]:
    """The final reconstructed window a process left behind — what the
    fleet collector folds for an EXPIRED peer (its last counters). Only
    the newest self-contained chunk needs reading."""
    chunks = list_chunks(root, lease_id)
    if not chunks:
        return None
    try:
        with open(chunks[-1]) as fh:
            chunk = json.load(fh)
    except (OSError, ValueError):
        return None
    if chunk.get("schema") != TIMESERIES_SCHEMA:
        return None
    base: Optional[dict] = None
    ts = 0.0
    for w in chunk.get("windows", []):
        base = apply_window(base, w)
        ts = w.get("ts", ts)
    if base is None:
        return None
    return {"ts": ts, "metrics": base}


class MetricsSnapshotter:
    """Background snapshot thread for one process's registry.

    ``registry_cb`` is called at every tick (the process obs registry is
    swappable — obs.reset() — so the snapshotter must re-resolve it).
    Disarmed (snapshotMs <= 0) it is a no-op object, the SloTracker
    pattern: construction is always safe, arming is the knob's job."""

    def __init__(self, root: str, lease_id: str,
                 registry_cb: Callable,
                 snapshot_ms: Optional[float] = None,
                 chunk_windows: Optional[int] = None,
                 retain_chunks: Optional[int] = None) -> None:
        self.root = os.path.abspath(root)
        self.lease_id = str(lease_id)
        self.dir = obs_dir(root, lease_id)
        self._registry_cb = registry_cb
        self.snapshot_ms = (snapshot_ms_setting() if snapshot_ms is None
                            else float(snapshot_ms))
        self.chunk_windows = max(1, chunk_windows_setting()
                                 if chunk_windows is None
                                 else int(chunk_windows))
        self.retain_chunks = max(1, retain_chunks_setting()
                                 if retain_chunks is None
                                 else int(retain_chunks))
        self.enabled = self.snapshot_ms > 0.0
        self._lock = tracked_lock("obs.timeseries")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._prev: Optional[dict] = None
        self._windows: List[dict] = []
        self._seq = 1
        self._written = 0

    # ---- lifecycle ----
    def start(self) -> None:
        if not self.enabled or self._thread is not None:
            return
        os.makedirs(self.dir, exist_ok=True)
        self._write_meta()
        with self._lock:
            # the tick thread is not running yet, but _seq is otherwise
            # lock-guarded — keep the discipline uniform
            self._seq = self._next_seq()
        self._thread = threading.Thread(
            target=self._run, name=f"shifu-obs-snap-{self.lease_id}",
            daemon=True)
        self._thread.start()
        log.info("metrics snapshotter on: %s every %.0f ms "
                 "(%d windows/chunk, keep %d chunks)", self.dir,
                 self.snapshot_ms, self.chunk_windows, self.retain_chunks)

    def stop(self, timeout: Optional[float] = 5.0) -> None:
        """Flush a final window and stop the thread (a clean shutdown
        leaves the registry's terminal state as the last window)."""
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout)
            self._thread = None
        if self.enabled:
            self.tick()

    def _run(self) -> None:
        while not self._stop.wait(self.snapshot_ms / 1000.0):
            try:
                self.tick()
            except Exception as e:  # a disk hiccup must never kill the
                # serving process's snapshot cadence
                log.warning("metrics snapshot tick failed: %s", e)

    # ---- one window ----
    def tick(self) -> None:
        """Capture one window and atomically (re)write the current
        chunk. Also callable inline (tests, final flush)."""
        from shifu_tpu_torch.resilience.checkpoint import atomic_write_json

        reg = self._registry_cb()
        if reg is None:
            return
        snap = reg.snapshot()
        now = time.time()
        with self._lock:
            if not self._windows:
                # chunk start: full window, self-contained file
                self._windows.append(encode_window(None, snap, now))
            else:
                w = encode_window(self._prev, snap, now)
                if len(w) == 1:  # ts only: nothing changed, skip the
                    return       # rewrite (idle process, idle disk)
                self._windows.append(w)
            self._prev = snap
            seq = self._seq
            windows = list(self._windows)
            rotated = len(self._windows) >= self.chunk_windows
            if rotated:
                self._seq += 1
                self._windows = []
                self._prev = None  # next chunk restarts full
            self._written += 1
        path = os.path.join(self.dir, f"obs-{seq:05d}.json")
        atomic_write_json(path, {
            "schema": TIMESERIES_SCHEMA,
            "leaseId": self.lease_id,
            "pid": os.getpid(),
            "seq": seq,
            "windows": windows,
        })
        if rotated:
            self._retire()

    def _retire(self) -> None:
        chunks = list_chunks(self.root, self.lease_id)
        for path in chunks[:-self.retain_chunks or None]:
            try:
                os.remove(path)
            except OSError:
                pass

    # ---- layout ----
    def _next_seq(self) -> int:
        highest = 0
        for path in list_chunks(self.root, self.lease_id):
            m = _CHUNK_RE.match(os.path.basename(path))
            if m:
                highest = max(highest, int(m.group(1)))
        return highest + 1

    def _write_meta(self) -> None:
        from shifu_tpu_torch.resilience.checkpoint import atomic_write_json

        atomic_write_json(os.path.join(self.dir, META_FILE), {
            "schema": TIMESERIES_SCHEMA,
            "leaseId": self.lease_id,
            "pid": os.getpid(),
            "snapshotMs": self.snapshot_ms,
            "chunkWindows": self.chunk_windows,
            "retainChunks": self.retain_chunks,
        })

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "dir": self.dir,
                "enabled": self.enabled,
                "snapshotMs": self.snapshot_ms,
                "windows": self._written,
                "chunks": self._seq if self._written else 0,
            }

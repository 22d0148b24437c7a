"""Append-only serve-side traffic log: rotating chunk files in the ledger
(counterpart of `shifu_tpu/loop/traffic.py`).

Every scored micro-batch can leave a row-sampled trace of (raw features,
mean score, model-set sha, request trace id, unix timestamp) under
`<root>/.shifu/runs/traffic/traffic-[<writer>-]<seq>.psv`. The log is
shareable by several serve processes: each appends under its own writer
id with its own monotone sequence, and consumers read the union across
writers: a `shifu serve` process's writer id is its lease id
(`resilience/lease.py`; without a lease, `traffic-<seq>.psv`). Design
constraints, in order:

  * **Append-only + torn-write-proof.** A chunk file appears atomically
    (resilience.checkpoint.atomic_write: temp + os.replace) when its row
    buffer fills — a killed server leaves only whole chunk files, never a
    half row. Files are never rewritten; the sequence number only grows
    (across server restarts too).
  * **Just another stream.** The files are plain `|`-delimited text plus
    a `_meta.json` sidecar naming the columns, so `traffic_source()`
    hands back the same `data/stream.chunk_source` factory the streamed
    lifecycle reads through, and the underscore sidecar is invisible to
    the data-file scan.
  * **Sampled.** `-Dshifu.loop.logSample` (0..1) row-samples with a
    deterministic per-batch RNG, so a replayed stream logs the same rows.

Label plumbing: the log's schema is the caller's `columns` list — the
serve wiring passes the registry input columns PLUS the ModelConfig's
target/weight columns when it can see a ModelConfig, so records that
carry outcomes keep them; records without them log the empty missing
token.

Metrics: loop.traffic.rows / loop.traffic.sampled_out /
loop.traffic.chunks, all in the serve shutdown manifest.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from typing import List, Optional, Tuple

import numpy as np

from shifu_tpu_torch.analysis.racetrack import guarded_by, tracked_lock
from shifu_tpu_torch.fs.listing import sorted_glob
from shifu_tpu_torch.loop import log_chunk_rows_setting, log_sample_setting
from shifu_tpu_torch.utils.log import get_logger

log = get_logger(__name__)

TRAFFIC_SUBDIR = os.path.join(".shifu", "runs", "traffic")
DELIMITER = "|"
META_FILE = "_meta.json"
# scores/sha/trace/timestamp ride as ordinary columns; retrain treats
# them as meta (never features) because they are not in ColumnConfig.
# TRACE_COLUMN is the request-trace id (obs/reqtrace.py) of the request
# that produced the row — the serve -> retrain -> promote lineage key.
SCORE_COLUMN = "shifu_score_mean"
SHA_COLUMN = "shifu_model_sha"
TRACE_COLUMN = "shifu_trace"
TS_COLUMN = "shifu_ts"
# count of meta columns appended after the feature columns, in order
META_COLUMNS = (SCORE_COLUMN, SHA_COLUMN, TRACE_COLUMN, TS_COLUMN)

# chunk names carry an optional WRITER id: a fleet of serve processes
# appends to the same ledger dir as `traffic-<writer>-<seq>.psv`, each
# writer owning its own monotone sequence — no cross-process seq race,
# and readers union the writers. Legacy single-process chunks
# (`traffic-<seq>.psv`, writer group empty) stay readable. Writer ids
# are sanitized to [A-Za-z0-9_] and never all-digits (writer_id()), so
# the name grammar is unambiguous.
_CHUNK_RE = re.compile(r"^traffic-(?:([A-Za-z0-9_]+)-)?(\d+)\.psv$")


def writer_id(value: str) -> str:
    """Sanitize a lease id (host-pid-token) into a chunk-name-safe
    writer id. All-digit/empty results get a 'w' prefix
    so a writer id can never parse as a bare sequence number."""
    cleaned = re.sub(r"[^A-Za-z0-9_]", "_", value or "")
    if not cleaned or cleaned[0].isdigit():
        cleaned = "w" + cleaned  # never digit-led: can't parse as a seq
    return cleaned


def traffic_scope_setting() -> str:
    """shifu.loop.trafficScope — which writers' chunks consumers read:
    'fleet' (default) unions every serve process's log; a specific
    writer id restricts to that process's chunks (replay/debug)."""
    from shifu_tpu_torch.utils import environment

    v = environment.get_property("shifu.loop.trafficScope", "fleet")
    return (v or "fleet").strip()


def traffic_dir(root: str, stream: str = "") -> str:
    """Traffic-log dir; `stream` (a zoo tenant name) keeps each model
    set's logged traffic a SEPARATE stream under the shared ledger —
    per-tenant retrain must never mix another tenant's rows."""
    base = os.path.join(os.path.abspath(root), TRAFFIC_SUBDIR)
    return os.path.join(base, stream) if stream else base


def traffic_columns(base_columns: List[str]) -> List[str]:
    return list(base_columns) + list(META_COLUMNS)


def list_chunks(root: str, stream: str = "",
                scope: Optional[str] = None) -> List[str]:
    """Chunk files in (sequence, writer) order — the fleet union by
    default (`scope` falls back to shifu.loop.trafficScope), or one
    writer's own append order when a writer id is given."""
    scope = traffic_scope_setting() if scope is None else scope
    out = []
    for path in sorted_glob(os.path.join(traffic_dir(root, stream),
                                         "traffic-*.psv")):
        m = _CHUNK_RE.match(os.path.basename(path))
        if not m:
            continue
        writer = m.group(1) or ""
        if scope != "fleet" and writer != scope:
            continue
        out.append(((int(m.group(2)), writer), path))
    return [p for _k, p in sorted(out)]


def chunk_writer(path: str) -> Optional[str]:
    """Writer id a chunk file belongs to ('' for legacy unnamed chunks,
    None when the name is not a traffic chunk at all)."""
    m = _CHUNK_RE.match(os.path.basename(path))
    return (m.group(1) or "") if m else None


def list_writers(root: str, stream: str = "") -> List[str]:
    """Distinct writer ids with chunks on disk (legacy unnamed chunks
    report as '') — the retrain lineage manifest's evidence that the
    union spanned the fleet."""
    writers = set()
    for path in sorted_glob(os.path.join(traffic_dir(root, stream),
                                         "traffic-*.psv")):
        m = _CHUNK_RE.match(os.path.basename(path))
        if m:
            writers.add(m.group(1) or "")
    return sorted(writers)


def _sanitize(value: str) -> str:
    """Field hygiene: the log is `|`-delimited text, so the delimiter and
    newlines inside a raw value must not corrupt row framing."""
    if DELIMITER in value or "\n" in value or "\r" in value:
        return (value.replace(DELIMITER, ";")
                .replace("\n", " ").replace("\r", " "))
    return value


class TrafficLog:
    """Thread-safe rotating chunk writer for one serving process."""

    def __init__(self, root: str, columns: List[str],
                 sample: Optional[float] = None,
                 chunk_rows: Optional[int] = None,
                 seed: int = 0, stream: str = "",
                 writer: str = "") -> None:
        self.root = os.path.abspath(root)
        self.stream = stream
        self.dir = traffic_dir(root, stream)
        self.writer = writer_id(writer) if writer else ""
        self.columns = list(columns)
        self.sample = (log_sample_setting() if sample is None
                       else float(sample))
        self.chunk_rows = (log_chunk_rows_setting() if chunk_rows is None
                           else int(chunk_rows))
        self.seed = int(seed)
        self._lock = tracked_lock("loop.traffic")
        self._buffer: List[str] = []
        self._batches = 0
        self._chunks = 0  # chunks THIS process wrote (seq counts restarts)
        self._retire_mismatched_schema()
        self._seq = self._next_seq()
        # chunk writes happen outside self._lock (SH203) but must LAND
        # in sequence order: a reader (retrain --from-traffic against a
        # live server) globs the dir sorted by seq and would silently
        # skip chunk N's rows if N+1's smaller write raced onto disk
        # first. Concurrent rotators serialize among themselves on this
        # condition; recorders never touch it.
        self._write_cond = threading.Condition()
        self._next_write = self._seq
        self._write_meta()

    def _retire_mismatched_schema(self) -> None:
        """A restart with a DIFFERENT column schema must not rewrite
        _meta.json over chunks framed with the old one — every old row
        would parse misaligned into the new columns and retrain on
        garbage. The old log moves wholesale to a `superseded-<n>` subdir
        (nothing is destroyed; readers only glob the active dir)."""
        meta_path = os.path.join(self.dir, META_FILE)
        if not os.path.isfile(meta_path):
            return
        try:
            with open(meta_path) as fh:
                old = json.load(fh)
        except (OSError, ValueError):
            old = None  # unreadable meta: retire it with the chunks
        if old is not None and list(old.get("columns", [])) == self.columns:
            return
        n = 1
        while os.path.isdir(os.path.join(self.dir, f"superseded-{n}")):
            n += 1
        retired = os.path.join(self.dir, f"superseded-{n}")
        os.makedirs(retired)
        moved = 0
        for path in (sorted_glob(os.path.join(self.dir, "traffic-*.psv"))
                     + [meta_path]):
            if os.path.isfile(path):
                os.replace(path,
                           os.path.join(retired, os.path.basename(path)))
                moved += 1
        log.warning("traffic log schema changed (%s -> %s columns): "
                    "retired %d old file(s) to %s",
                    len(old.get("columns", [])) if old else "?",
                    len(self.columns), moved, retired)

    # ---- layout ----
    def set_writer(self, writer: str) -> None:
        """Adopt a writer id (a serve process's lease id, once leases
        exist) before traffic flows. The sequence restarts
        from this WRITER'S own highest chunk, so N processes on one
        ledger never contend for a sequence number."""
        with self._lock:
            self.writer = writer_id(writer)
            self._seq = self._next_seq()
            with self._write_cond:
                self._next_write = self._seq

    def _chunk_path(self, seq: int) -> str:
        name = (f"traffic-{self.writer}-{seq:05d}.psv" if self.writer
                else f"traffic-{seq:05d}.psv")
        return os.path.join(self.dir, name)

    def _next_seq(self) -> int:
        """Highest sequence among THIS writer's chunks + 1 (legacy
        unnamed chunks when no writer is set) — restarts keep the
        writer's own sequence monotone."""
        highest = 0
        for path in sorted_glob(os.path.join(self.dir, "traffic-*.psv")):
            m = _CHUNK_RE.match(os.path.basename(path))
            if m and (m.group(1) or "") == self.writer:
                highest = max(highest, int(m.group(2)))
        return highest + 1

    def _write_meta(self) -> None:
        from shifu_tpu_torch.resilience.checkpoint import atomic_write_json

        atomic_write_json(os.path.join(self.dir, META_FILE), {
            "schema": "shifu.traffic/1",
            "columns": self.columns,
            "delimiter": DELIMITER,
            "sample": self.sample,
            "chunkRows": self.chunk_rows,
        })

    # ---- write side ----
    def record(self, data, result, sha: str) -> int:
        """Log one scored batch (a ColumnarData + its ScoreResult); returns
        the number of rows actually logged after sampling."""
        from shifu_tpu_torch.obs import registry

        if self.sample <= 0.0:
            return 0
        n = data.n_rows
        with self._lock:
            self._batches += 1
            if self.sample >= 1.0:
                keep = np.arange(n)
            else:
                # deterministic per-batch draw: a replayed stream logs the
                # same rows, and restarts never re-use a stream position
                rng = np.random.default_rng([self.seed, self._batches])
                keep = np.nonzero(rng.random(n) < self.sample)[0]
            reg = registry()
            reg.counter("loop.traffic.rows").inc(len(keep))
            reg.counter("loop.traffic.sampled_out").inc(n - len(keep))
            if not len(keep):
                return 0
            ts = f"{time.time():.3f}"
            cols = [np.asarray(data.column(c), dtype=object)
                    if c in data.raw else None
                    for c in self.columns[:-len(META_COLUMNS)]]
            mean = result.mean
            # per-row request-trace ids (set by the batcher before the
            # observer runs) — rows from un-traced requests log empty
            trace_ids = getattr(data, "trace_ids", None)
            for i in keep:
                fields = [
                    _sanitize("" if col is None else str(col[i]))
                    for col in cols
                ]
                fields.append(f"{float(mean[i]):.4f}")
                fields.append(sha)
                fields.append(_sanitize(str(trace_ids[i]))
                              if trace_ids is not None
                              and i < len(trace_ids) else "")
                fields.append(ts)
                self._buffer.append(DELIMITER.join(fields))
            pending = (self._swap_chunk()
                       if len(self._buffer) >= self.chunk_rows else None)
            kept = len(keep)
        # the file write happens OUTSIDE the lock (SH203): the scoring
        # worker's next record() must never queue behind disk I/O. The
        # swap assigned this chunk its sequence number under the lock,
        # so row order across files is preserved whatever order the
        # writes land in.
        if pending is not None:
            self._write_chunk(*pending)
        return kept

    @guarded_by("_lock")
    def _swap_chunk(self) -> Optional[Tuple[int, str, List[str]]]:
        """Take the buffered rows + their chunk seq/path out of the
        shared state (caller holds the lock); the caller writes them
        outside via _write_chunk, which lands files in seq order."""
        if not self._buffer:
            return None
        seq = self._seq
        path = self._chunk_path(seq)
        rows, self._buffer = self._buffer, []
        self._seq += 1
        self._chunks += 1
        return seq, path, rows

    def _write_chunk(self, seq: int, path: str, rows: List[str]) -> None:
        from shifu_tpu_torch.obs import registry
        from shifu_tpu_torch.resilience.checkpoint import atomic_write

        # land in seq order: a reader globbing the dir mid-write must
        # never see chunk N+1 without N (it would silently skip N's
        # rows). Only concurrent rotators queue here, never recorders.
        with self._write_cond:
            while self._next_write != seq:
                self._write_cond.wait(1.0)
        try:
            atomic_write(path, ("\n".join(rows) + "\n").encode("utf-8"))
        finally:
            # bump even on a failed write so later chunks are not
            # wedged behind a disk error forever
            with self._write_cond:
                self._next_write = seq + 1
                self._write_cond.notify_all()
        registry().counter("loop.traffic.chunks").inc()
        log.debug("traffic chunk %s (%d rows)", path, len(rows))

    def flush(self) -> None:
        """Persist any buffered rows as a (possibly short) chunk."""
        with self._lock:
            pending = self._swap_chunk()
        if pending is not None:
            self._write_chunk(*pending)

    def close(self) -> None:
        self.flush()

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "dir": self.dir,
                "writer": self.writer,
                "sample": self.sample,
                "chunks": self._chunks,
                "bufferedRows": len(self._buffer),
            }


def log_meta(root: str, stream: str = "",
             scope: Optional[str] = None) -> Tuple[dict, List[str]]:
    """(parsed _meta.json, chunk paths) of the traffic log under `root`'s
    ledger — THE validation for every consumer (traffic_source, `shifu
    retrain`), so the operator guidance stays in one place. Raises
    FileNotFoundError when nothing was ever logged or no chunk has
    rotated out yet."""
    meta_path = os.path.join(traffic_dir(root, stream), META_FILE)
    if not os.path.isfile(meta_path):
        raise FileNotFoundError(
            f"no traffic log under {traffic_dir(root, stream)} — serve "
            f"with --traffic-log (or -Dshifu.loop.logSample>0) first")
    with open(meta_path) as fh:
        meta = json.load(fh)
    chunks = list_chunks(root, stream, scope=scope)
    if not chunks:
        raise FileNotFoundError(
            f"traffic log {traffic_dir(root, stream)} has no chunk "
            "files yet")
    return meta, chunks


def trace_lineage(root: str, limit: int = 8,
                  stream: str = "") -> Optional[dict]:
    """Serve -> train lineage evidence from the traffic log: how many
    logged rows carry a request-trace id (obs/reqtrace.py) and a sample
    of the ids, so retrain/promote manifests can point back at the
    exact serving evidence. A single-shard whole-log scan — the log's
    chunk files are small and this runs once per retrain, not on any
    hot path. None when the log has no trace column (pre-trace logs)."""
    try:
        meta, chunks = log_meta(root, stream)
    except FileNotFoundError:
        return None
    columns = list(meta.get("columns", []))
    if TRACE_COLUMN not in columns:
        return None
    idx = columns.index(TRACE_COLUMN)
    delim = meta.get("delimiter", DELIMITER)
    traced = 0
    total = 0
    sample: List[str] = []
    seen = set()
    for path in chunks:
        try:
            with open(path) as fh:
                for line in fh:
                    line = line.rstrip("\n")
                    if not line:
                        continue
                    total += 1
                    fields = line.split(delim)
                    tid = fields[idx] if idx < len(fields) else ""
                    if tid:
                        traced += 1
                        if tid not in seen and len(sample) < limit:
                            seen.add(tid)
                            sample.append(tid)
        except OSError:
            continue
    return {
        "traceColumn": TRACE_COLUMN,
        "rows": total,
        "tracedRows": traced,
        "sampleTraceIds": sample,
    }


def traffic_source(root: str, chunk_rows: Optional[int] = None,
                   columns: Optional[List[str]] = None,
                   missing_values=None,
                   stream: str = "",
                   scope: Optional[str] = None) -> Tuple[object, List[str]]:
    """(chunk_source factory, column names) over the logged traffic — the
    seam that makes the log just another input stream. The fleet UNION
    by default (every writer's chunks; shifu.loop.trafficScope / `scope`
    narrows to one writer). Raises FileNotFoundError when nothing was
    ever logged."""
    from shifu_tpu_torch.data.reader import DEFAULT_MISSING
    from shifu_tpu_torch.data.stream import chunk_source

    scope = traffic_scope_setting() if scope is None else scope
    meta, _ = log_meta(root, stream, scope=scope)
    names = list(meta["columns"])
    pattern = ("traffic-*.psv" if scope == "fleet"
               else f"traffic-{scope}-*.psv" if scope
               else "traffic-[0-9]*.psv")
    factory = chunk_source(
        os.path.join(traffic_dir(root, stream), pattern),
        names,
        delimiter=meta.get("delimiter", DELIMITER),
        missing_values=(tuple(missing_values) if missing_values
                        else DEFAULT_MISSING),
        chunk_rows=chunk_rows,
        columns=columns,
    )
    return factory, names

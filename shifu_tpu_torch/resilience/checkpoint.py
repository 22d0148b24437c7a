"""Atomic artifact writes and mid-stream checkpoints (counterpart of
`shifu_tpu/resilience/checkpoint.py`, one host).

`atomic_write` / `atomic_write_json` / `atomic_save_npy`: a kill
mid-write leaves either the previous complete file or the new one: write
to a temp file in the same directory, fsync, then `os.replace` (atomic
on POSIX within a filesystem).

`StreamCheckpoint`: the snapshot of a chunked fold. Every
`shifu.ckpt.everyChunks` folded chunks (default 16) the loop persists
(chunk index, fold arrays, meta) and a config sha in one `.ckpt.npz`;
`shifu <step> --resume` (`shifu.resume`) loads it, skips the folded
chunks, and because the snapshot holds the exact fold state the resumed
run is bit-identical to an unbroken one. A snapshot under another config
sha, or a corrupt one, is rejected and the run starts fresh.
`ShardedStreamCheckpoint` is the per-row-shard family of the streamed
stats, norm and eval (two slots a shard and a shared commit pointer);
under a multi-host plan each host keeps its own `-hNNN` family.
The snapshot files are the port's own; it does not read the JAX
package's. The `ckpt` fault seam sits in `atomic_write` between the
fsync and the rename, and a snapshot save retries it (`retry.py`).
"""

from __future__ import annotations

import glob
import hashlib
import io
import json
import os
import tempfile
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np

from shifu_tpu_torch.resilience import faults, retry
from shifu_tpu_torch.utils import environment
from shifu_tpu_torch.utils.log import get_logger

log = get_logger(__name__)

DEFAULT_EVERY_CHUNKS = 16
CKPT_SUBDIR = os.path.join(".shifu", "runs", "ckpt")
CKPT_SUFFIX = ".ckpt.npz"

META_KEY = "__meta__"
BLOB_KEY = "__blob__"


def _registry():
    """The obs registry (`ckpt.*` counters), imported late: obs imports
    this module's atomic writes."""
    from shifu_tpu_torch.obs import registry

    return registry()


def every_chunks_setting() -> int:
    """shifu.ckpt.everyChunks — chunks between snapshots (<= 0: none)."""
    return environment.get_int("shifu.ckpt.everyChunks",
                               DEFAULT_EVERY_CHUNKS)


def ckpt_stream_enabled() -> bool:
    """shifu.ckpt.stream — the switch of mid-stream snapshots (default
    on)."""
    return environment.get_bool("shifu.ckpt.stream", True) \
        and every_chunks_setting() > 0


def resume_requested() -> bool:
    """shifu.resume — set by the CLI's `--resume` flags."""
    return environment.get_bool("shifu.resume", False)


def atomic_write(path: str,
                 data: Union[bytes, Callable[[io.BufferedWriter], None]],
                 ) -> str:
    """Write `data` (bytes, or a writer callable) to `path` atomically."""
    path = os.path.abspath(path)
    d = os.path.dirname(path)
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix="." + os.path.basename(path),
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as fh:
            if callable(data):
                data(fh)
            else:
                fh.write(data)
            fh.flush()
            os.fsync(fh.fileno())
        # the injectable failure window: the bytes are down, the rename
        # not done — where a torn write would happen without temp+replace
        faults.fault_point("ckpt")
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:  # already replaced or never created
            pass
        raise
    return path


def atomic_write_json(path: str, obj, indent: int = 2,
                      sort_keys: bool = True) -> str:
    return atomic_write(
        path, json.dumps(obj, indent=indent, sort_keys=sort_keys,
                         default=str).encode("utf-8"))


def atomic_save_npy(path: str, array: np.ndarray) -> str:
    """Atomic `np.save`: the trainers' checkpoint write."""
    buf = io.BytesIO()
    np.save(buf, np.asarray(array))
    return atomic_write(path, buf.getvalue())


# ---------------------------------------------------------------------------
# stream checkpoints
# ---------------------------------------------------------------------------


def config_sha(ident: dict) -> str:
    """sha1 of the canonical JSON of a run's identity, 16 hex chars."""
    return hashlib.sha1(
        json.dumps(ident, sort_keys=True, default=str).encode()
    ).hexdigest()[:16]


def sectioned_sha(sections: Dict[str, dict]) -> Tuple[str, Dict[str, str]]:
    """(overall sha, per-section shas): a rejection names the section
    (data, train, ...) that changed."""
    per = {name: config_sha(ident) for name, ident in sections.items()}
    return config_sha(per), per


def resume_slice(numbered, after: int):
    """The (index, item) pairs past `after`, the chunk index a snapshot
    recorded; the indices ride along, so index-keyed draws keep."""
    for pair in numbered:
        if pair[0] > after:
            yield pair


def ckpt_dir(root: str) -> str:
    return os.path.join(os.path.abspath(root), CKPT_SUBDIR)


def ckpt_path(root: str, step: str, name: str) -> str:
    return os.path.join(ckpt_dir(root), f"{step}-{name}{CKPT_SUFFIX}")


def ckpt_base(root: str, step: str, name: str) -> str:
    """Suffix-less base of a sharded family (`<base>-shardNNNNN-a|b` and
    `<base>-shared`)."""
    return os.path.join(ckpt_dir(root), f"{step}-{name}")


class StreamCheckpoint:
    """One resumable stream's snapshot file: `save` writes (chunk index,
    arrays, meta [, blob]) atomically; `load` returns them only under the
    same config sha; `maybe_save` applies the cadence and calls
    `state_fn` only when a write is due."""

    def __init__(self, path: str, config_sha: str,
                 every: Optional[int] = None,
                 sections: Optional[Dict[str, str]] = None) -> None:
        self.path = path
        self.config_sha = config_sha
        self.sections = dict(sections) if sections else None
        self.every = every_chunks_setting() if every is None else int(every)
        self._since = 0

    def save(self, chunk_index: int,
             arrays: Optional[Dict[str, np.ndarray]] = None,
             meta: Optional[dict] = None,
             blob: Optional[bytes] = None) -> str:
        payload: Dict[str, np.ndarray] = {}
        for k, v in (arrays or {}).items():
            assert not k.startswith("__"), k
            payload[k] = np.asarray(v)
        header = {"chunkIndex": int(chunk_index),
                  "configSha": self.config_sha, "meta": meta or {}}
        if self.sections:
            header["sections"] = self.sections
        payload[META_KEY] = np.frombuffer(
            json.dumps(header, sort_keys=True).encode("utf-8"),
            dtype=np.uint8)
        if blob is not None:
            payload[BLOB_KEY] = np.frombuffer(blob, dtype=np.uint8)
        buf = io.BytesIO()
        np.savez(buf, **payload)
        data = buf.getvalue()
        # retried: a transient failure of the snapshot write must not
        # kill the stream it protects
        retry.retry_call(lambda: atomic_write(self.path, data), seam="ckpt")
        reg = _registry()
        reg.counter("ckpt.writes").inc()
        reg.counter("ckpt.bytes").inc(len(data))
        return self.path

    def maybe_save(self, chunk_index: int, state_fn: Callable[[], tuple]
                   ) -> bool:
        """Cadence-gated save after folding chunk `chunk_index`;
        `state_fn() -> (arrays, meta, blob)`."""
        if self.every <= 0:
            return False
        self._since += 1
        if self._since < self.every:
            return False
        self._since = 0
        arrays, meta, blob = state_fn()
        self.save(chunk_index, arrays=arrays, meta=meta, blob=blob)
        return True

    def load(self) -> Optional[Tuple[int, Dict[str, np.ndarray], dict,
                                     Optional[bytes]]]:
        """(chunk index, arrays, meta, blob), or None when the file is
        absent, unreadable or of another config."""
        if not os.path.isfile(self.path):
            return None
        try:
            with np.load(self.path) as z:
                header = json.loads(bytes(z[META_KEY].tobytes()).decode())
                arrays = {k: z[k] for k in z.files
                          if k not in (META_KEY, BLOB_KEY)}
                blob = (z[BLOB_KEY].tobytes()
                        if BLOB_KEY in z.files else None)
        except Exception as e:  # corrupt or truncated: start fresh
            log.warning("checkpoint %s unreadable (%s); starting fresh",
                        self.path, e)
            _registry().counter("ckpt.rejected", reason="corrupt").inc()
            return None
        if header.get("configSha") != self.config_sha:
            stored = header.get("sections") or {}
            diverged = "unknown"
            if stored and self.sections:
                diverged = ",".join(sorted(
                    k for k in set(stored) | set(self.sections)
                    if stored.get(k) != self.sections.get(k))) or "unknown"
            log.warning("checkpoint %s was built under a different config "
                        "(%s != %s; diverged section(s): %s); starting "
                        "fresh", self.path, header.get("configSha"),
                        self.config_sha, diverged)
            _registry().counter("ckpt.rejected", reason="config",
                                section=diverged).inc()
            return None
        _registry().counter("ckpt.resumes").inc()
        return int(header["chunkIndex"]), arrays, header.get("meta", {}), blob

    def clear(self) -> None:
        try:
            os.unlink(self.path)
        except OSError:  # never written or already cleared
            pass


class ShardedStreamCheckpoint:
    """The snapshot family of a sharded fold: one file a row shard (its
    cursor and local state) in two alternating slots (`-a`/`-b`), and a
    `-shared` file, written last, that commits (epoch, slot). A kill
    while the shard files are written touches only the new slot; the
    pointer still names the previous complete one. `load` rejects the
    whole family when a pointed-at file is missing, corrupt, of another
    config, epoch, shard count or host count.

    Under a multi-host plan (`n_hosts` > 1) the family is per host: host
    h's files are `<base>-h00h-...`, hold only h's cursors and local
    state, and h resumes from them alone. The committed stamp records
    the host count, and a change of it rejects the family (the chunk ->
    host assignment moved). At one host the names stay the un-prefixed
    ones. `clear` at one host also sweeps leftover per-host families; at
    several it touches only its own host's files."""

    _SLOTS = ("a", "b")

    def __init__(self, base: str, config_sha: str, n_shards: int,
                 every: Optional[int] = None,
                 sections: Optional[Dict[str, str]] = None,
                 n_hosts: int = 1, host_index: int = 0) -> None:
        self.base = base
        self.n_shards = max(1, int(n_shards))
        self.n_hosts = max(1, int(n_hosts))
        self.host_index = int(host_index)
        self.every = every_chunks_setting() if every is None else int(every)
        self._since = 0
        self._epoch = 0
        self._family = (base if self.n_hosts == 1
                        else f"{base}-h{self.host_index:03d}")
        self._shards = [
            {slot: StreamCheckpoint(
                f"{self._family}-shard{s:05d}-{slot}{CKPT_SUFFIX}",
                config_sha, every=0, sections=sections)
             for slot in self._SLOTS}
            for s in range(self.n_shards)]
        self._shared = StreamCheckpoint(
            f"{self._family}-shared{CKPT_SUFFIX}", config_sha, every=0,
            sections=sections)

    def save(self, per_shard: List[tuple], shared: tuple) -> None:
        """per_shard: [(cursor, arrays, meta, blob)] a shard; shared:
        (arrays, meta, blob), written last as the commit."""
        assert len(per_shard) == self.n_shards
        epoch = self._epoch + 1
        slot = self._SLOTS[epoch % len(self._SLOTS)]
        stamp = {"epoch": epoch, "shards": self.n_shards}
        if self.n_hosts > 1:
            stamp["hosts"] = self.n_hosts
            stamp["host"] = self.host_index
        for cks, (ci, arrays, meta, blob) in zip(self._shards, per_shard):
            cks[slot].save(ci, arrays=arrays,
                           meta={**(meta or {}), **stamp}, blob=blob)
        arrays, meta, blob = shared
        self._shared.save(-1, arrays=arrays,
                          meta={**(meta or {}), **stamp, "slot": slot},
                          blob=blob)
        self._epoch = epoch

    def maybe_save(self, state_fn: Callable[[], tuple]) -> bool:
        """Cadence-gated save, one call a folded chunk; `state_fn() ->
        (per_shard, shared)`."""
        if self.every <= 0:
            return False
        self._since += 1
        if self._since < self.every:
            return False
        self._since = 0
        self.save(*state_fn())
        return True

    def load(self):
        """(cursors, per_shard [(arrays, meta, blob)], shared (arrays,
        meta, blob)) or None."""
        shared = self._shared.load()
        if shared is None:
            return None
        meta = shared[2]
        epoch, slot = meta.get("epoch"), meta.get("slot")
        if epoch is None or slot not in self._SLOTS:
            _registry().counter("ckpt.rejected", reason="partial").inc()
            return None
        if meta.get("shards") != self.n_shards:
            log.warning("sharded checkpoint %s was written with %s shards "
                        "(now %d); starting fresh", self.base,
                        meta.get("shards"), self.n_shards)
            _registry().counter("ckpt.rejected", reason="shards").inc()
            return None
        if meta.get("hosts", 1) != self.n_hosts:
            # the chunk -> host assignment moved: every stored cursor
            # names a slice this run will never be handed
            log.warning("sharded checkpoint %s was written with %s hosts "
                        "(now %d); starting fresh", self._family,
                        meta.get("hosts", 1), self.n_hosts)
            _registry().counter("ckpt.rejected", reason="hosts").inc()
            return None
        loads = [cks[slot].load() for cks in self._shards]
        if any(ld is None for ld in loads):
            _registry().counter("ckpt.rejected", reason="partial").inc()
            return None
        if {ld[2].get("epoch") for ld in loads} != {epoch}:
            log.warning("sharded checkpoint %s slot %s is incomplete; "
                        "starting fresh", self.base, slot)
            _registry().counter("ckpt.rejected", reason="epoch").inc()
            return None
        self._epoch = int(epoch)
        return ([ld[0] for ld in loads],
                [(ld[1], ld[2], ld[3]) for ld in loads],
                (shared[1], shared[2], shared[3]))

    def clear(self) -> None:
        """Remove the whole family, stale slots and shard counts too (and,
        at one host, the per-host families of an earlier fleet run)."""
        patterns = [glob.escape(self._family) + "-shard*" + CKPT_SUFFIX]
        if self.n_hosts == 1:
            patterns.append(glob.escape(self.base) + "-h*" + CKPT_SUFFIX)
        for pattern in patterns:
            for path in sorted(glob.glob(pattern)):
                try:
                    os.unlink(path)
                except OSError:  # already gone
                    pass
        self._shared.clear()


def list_resumable(root: str) -> List[dict]:
    """The snapshots a preempted step left behind: the chunked folds'
    under <root>/.shifu/runs/ckpt and the streamed trainers' beside
    their checkpoint paths under tmp/train."""
    root = os.path.abspath(root)
    d = ckpt_dir(root)
    paths = ([os.path.join(d, n) for n in sorted(os.listdir(d))
              if n.endswith(CKPT_SUFFIX)] if os.path.isdir(d) else [])
    paths += sorted(glob.glob(os.path.join(root, "tmp", "train", "**",
                                           "*" + CKPT_SUFFIX),
                              recursive=True))
    out: List[dict] = []
    for path in paths:
        name = os.path.basename(path)[: -len(CKPT_SUFFIX)]
        if os.path.dirname(path) != d:
            # trainer snapshot: its checkpoint dir keeps members apart
            name = f"train-{os.path.basename(os.path.dirname(path))}"
        entry = {"name": name, "path": path,
                 "bytes": os.path.getsize(path),
                 "mtime": os.path.getmtime(path)}
        try:
            with np.load(path) as z:
                header = json.loads(bytes(z[META_KEY].tobytes()).decode())
            entry["chunkIndex"] = header.get("chunkIndex")
            entry["configSha"] = header.get("configSha")
            entry["meta"] = header.get("meta", {})
        except Exception:  # unreadable: listed, marked corrupt
            entry["corrupt"] = True
        out.append(entry)
    return out

"""The streamed routes' shared pieces (counterpart of
`shifu_tpu/data/pipeline.py`, one process, one card):

  * `prefetch_iter` — a bounded-queue background producer. ONE worker
    thread pulls the source iterator and applies the host-side transform
    (CSV parse, bin-coding, shard load) while the consumer's device work
    runs; up to `shifu.ingest.prefetchChunks` (default 2) transformed
    chunks sit ready in the queue. One thread and a FIFO queue keep chunk
    order, so every fold is bit-identical to the serial run;
    `prefetchChunks=0` runs the same pull and transform inline.
  * `ShardPlan` — the deterministic chunk -> row-shard assignment of the
    streamed folds (round-robin on the chunk index, `ci % S`) and the
    per-shard resume cursors. S is `shifu.lifecycle.shards`, by default
    the mesh's device count (`parallel.mesh.lifecycle_shards`: every
    card on cuda, 1 on the CPU).
    More than one host (`shifu.lifecycle.hosts` > 1, the JAX
    `HostPlan`) raises naming ROADMAP A.13.
  * `DeviceAccumulator` — the streamed stats' bin aggregates folded on
    the device across chunks. The JAX package folds f32 windows and
    flushes them to a host f64 fold; the port's `ops/binagg` already
    counts in int64 and sums in f64 (ROADMAP C.5), so the accumulator
    keeps that int64/f64 state on the device for the whole stream and
    rounds the f64 sums to f32 once, at `fetch`: one device-to-host copy
    a stream, and one a checkpoint snapshot. Shard s's state lives on
    the lifecycle mesh's device s (`parallel.mesh.lifecycle_mesh`) and
    the shards merge in shard order at `fetch` and `snapshot`. The sums
    are exact, so the fold equals the in-RAM aggregate of the same rows
    for any shard count.

`bucket_rows` (power-of-two row padding) is not ported: it bounds the
JAX package's jit shapes, and torch compiles nothing per shape. The
chaos seams of `prefetch_iter` wait for `resilience/faults.py` (A.13).
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterable, Iterator, List, Optional

import numpy as np
import torch

from shifu_tpu_torch.ops.binagg import bin_aggregate_exact
from shifu_tpu_torch.parallel.mesh import lifecycle_mesh, lifecycle_shards
from shifu_tpu_torch.utils import environment

DEFAULT_PREFETCH_CHUNKS = 2


def prefetch_chunks_setting() -> int:
    """shifu.ingest.prefetchChunks — queue depth of the background
    prefetcher (0 = serial inline execution)."""
    return environment.get_int("shifu.ingest.prefetchChunks",
                               DEFAULT_PREFETCH_CHUNKS)


def prefetch_iter(source: Iterable[Any], depth: Optional[int] = None,
                  transform: Optional[Callable[[Any], Any]] = None
                  ) -> Iterator[Any]:
    """Iterate `source` with the pull + `transform` on a background
    thread, keeping up to `depth` transformed items ready (default
    shifu.ingest.prefetchChunks; <= 0 runs inline). Items arrive in
    source order; a worker exception re-raises in the consumer at the
    failing position; abandoning the iterator stops the worker."""
    if depth is None:
        depth = prefetch_chunks_setting()

    def _produce(it: Iterator[Any]):
        item = next(it)
        return transform(item) if transform is not None else item

    if depth <= 0:
        def _serial() -> Iterator[Any]:
            it = iter(source)
            while True:
                try:
                    item = _produce(it)
                except StopIteration:
                    return
                yield item

        return _serial()

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def _put(msg) -> bool:
        while not stop.is_set():
            try:
                q.put(msg, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _work() -> None:
        try:
            it = iter(source)
        except BaseException as e:  # a failing __iter__ must not hang
            _put(("error", e))
            return
        while not stop.is_set():
            try:
                item = _produce(it)
            except StopIteration:
                _put(("end", None))
                return
            except BaseException as e:  # re-raised consumer-side
                _put(("error", e))
                return
            if not _put(("item", item)):
                return
            # drop the handed-off chunk now, not after the next pull
            item = None

    def _consume() -> Iterator[Any]:
        worker = threading.Thread(target=_work, name="shifu-prefetch",
                                  daemon=True)
        worker.start()
        try:
            while True:
                kind, val = q.get()
                if kind == "end":
                    return
                if kind == "error":
                    raise val
                yield val
                val = None  # release before blocking on the queue
        finally:
            stop.set()
            try:  # unblock a worker stuck on a full queue
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            worker.join(timeout=5.0)

    return _consume()


class ShardPlan:
    """Deterministic chunk -> row-shard assignment, `shard_of(ci) = ci %
    S` (counterpart of the JAX `ShardPlan` over the one-host `HostPlan`):
    with S shards over K chunks each shard folds at most ceil(K/S) of
    them, and a resume skips, per shard, the chunks at or below its
    cursor. Every chunk is this process's: the JAX package's multi-host
    plan (`ci % H`, per-host part files and barriers) is ROADMAP A.13,
    and `shifu.lifecycle.hosts` > 1 raises."""

    def __init__(self, n_shards: Optional[int] = None,
                 device=None) -> None:
        from shifu_tpu_torch.data.stream import check_single_host

        check_single_host()
        self.n_shards = (lifecycle_shards(device) if n_shards is None
                         else max(1, int(n_shards)))

    def shard_of(self, chunk_index: int) -> int:
        return chunk_index % self.n_shards

    def resume_slice(self, numbered: Iterable,
                     cursors: List[int]) -> Iterator:
        """The (ci, item) pairs no shard has folded yet (ci > the cursor
        of its shard); skipped chunks are never transformed."""
        for pair in numbered:
            if pair[0] > cursors[self.shard_of(pair[0])]:
                yield pair


# BinAggregates fields in order; the running state keeps the counts in
# int64 and the sums in f64, the extrema in f32
_FIELDS = ("pos", "neg", "wpos", "wneg", "vsum", "vsumsq", "vmin", "vmax",
           "vcount", "vmissing")


class DeviceAccumulator:
    """The streamed stats' bin aggregates, folded on the device chunk by
    chunk (int64 counts, f64 sums, f32 extrema), a state a row shard on
    its device of the lifecycle mesh, read back once."""

    def __init__(self, device: torch.device, n_shards: int = 1) -> None:
        self.device = device
        self.mesh = lifecycle_mesh(n_shards, device)
        self._acc: List[Optional[List[torch.Tensor]]] = [None] * n_shards
        self.rows = 0

    @staticmethod
    def _add(acc, part):
        if acc is None:
            return list(part)
        return [torch.minimum(a, p) if k == 6 else
                torch.maximum(a, p) if k == 7 else a + p
                for k, (a, p) in enumerate(zip(acc, part))]

    def fold(self, codes: np.ndarray, col_offsets: np.ndarray,
             total_slots: int, tags: np.ndarray, weights: np.ndarray,
             values: np.ndarray, shard: int = 0) -> None:
        """Copy one chunk to shard `shard`'s device, aggregate it and add
        it to that shard's state."""
        dev = self.mesh.devices[shard]
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in (codes.astype(np.int32, copy=False),
                          col_offsets.astype(np.int32, copy=False),
                          tags.astype(np.int32, copy=False),
                          weights.astype(np.float32, copy=False),
                          values.astype(np.float32, copy=False))]
        part = bin_aggregate_exact(args[0], args[1], int(total_slots),
                                   *args[2:])
        self.rows += int((tags >= 0).sum())
        self._acc[shard] = self._add(self._acc[shard], part)

    def _merged(self) -> Optional[List[torch.Tensor]]:
        """The shards' states added on the lead device in shard order."""
        out = None
        for acc in self._acc:
            if acc is not None:
                out = self._add(out, [a.to(self.mesh.lead) for a in acc])
        return out

    def fetch(self) -> Optional[List[np.ndarray]]:
        """The aggregates as float64 numpy arrays in BinAggregates field
        order, the f64 sums rounded once to f32 (as `bin_aggregate`
        rounds them); None when nothing was folded."""
        acc = self._merged()
        if acc is None:
            return None
        return [(a.float() if a.dtype == torch.float64 else a)
                .cpu().numpy().astype(np.float64) for a in acc]

    def snapshot(self) -> dict:
        """The exact running state, the shards merged, as host arrays
        (one copy)."""
        out: dict = {"rows": np.int64(self.rows)}
        acc = self._merged()
        if acc is not None:
            for name, a in zip(_FIELDS, acc):
                out[name] = a.cpu().numpy()
        return out

    def restore(self, arrays: dict) -> None:
        """A snapshot's state, held by shard 0 (the sums are exact, so
        where it sits changes no result)."""
        self.rows = int(arrays["rows"])
        self._acc = [None] * len(self._acc)
        if _FIELDS[0] in arrays:
            self._acc[0] = [torch.from_numpy(np.asarray(arrays[k])).to(
                self.mesh.lead) for k in _FIELDS]

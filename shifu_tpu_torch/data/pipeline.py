"""The streamed routes' shared pieces (counterpart of
`shifu_tpu/data/pipeline.py`, one process, one card):

  * `prefetch_iter` — a bounded-queue background producer. ONE worker
    thread pulls the source iterator and applies the host-side transform
    (CSV parse, bin-coding, shard load) while the consumer's device work
    runs; up to `shifu.ingest.prefetchChunks` (default 2) transformed
    chunks sit ready in the queue. One thread and a FIFO queue keep chunk
    order, so every fold is bit-identical to the serial run;
    `prefetchChunks=0` runs the same pull and transform inline.
  * `HostPlan` — the chunk -> host (process) assignment of the
    lifecycle data plane (`ci % H`), from `shifu.lifecycle.hosts` and
    `shifu.lifecycle.hostIndex`; the hosts' partials meet at the
    filesystem barriers of `parallel/hostsync.py`.
  * `ShardPlan` — the deterministic chunk -> row-shard assignment of the
    streamed folds (round-robin on the host's dense local chunk ordinal,
    `(ci // H) % S`) and the per-shard resume cursors. S is
    `shifu.lifecycle.shards`, by default the mesh's device count
    (`parallel.mesh.lifecycle_shards`: every card on cuda, 1 on the
    CPU).
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
JAX package's jit shapes, and torch compiles nothing per shape.
`prefetch_iter` carries the `io` and `prefetch` fault seams
(`resilience/faults.py`) when a fault plan is armed.
"""

from __future__ import annotations

import json
import queue
import threading
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional

import numpy as np
import torch

from shifu_tpu_torch.ops.binagg import bin_aggregate_exact
from shifu_tpu_torch.parallel.mesh import (lifecycle_host_index,
                                           lifecycle_hosts, lifecycle_mesh,
                                           lifecycle_shards)
from shifu_tpu_torch.resilience import faults, retry
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
    failing position; abandoning the iterator stops the worker.

    With a fault plan armed, the `io` seam fires before each pull and
    the `prefetch` seam before each transform, each under its retry
    budget. Only the injected `io` fault is retried: an exception raised
    inside `next(it)` closes a generator source, so retrying a real pull
    error would read as a clean end of stream and truncate the data. The
    transform is pure host work, so it reruns whole."""
    if depth is None:
        depth = prefetch_chunks_setting()

    def _produce(it: Iterator[Any]):
        chaos = faults.plan_active()
        if chaos:
            retry.retry_call(lambda: faults.fault_point("io"), seam="io")
        item = next(it)
        if transform is None:
            return item
        if chaos:
            def _apply(i=item):
                faults.fault_point("prefetch")
                return transform(i)

            return retry.retry_call(_apply, seam="prefetch")
        return transform(item)

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


class HostPlan:
    """Deterministic chunk -> host assignment, the per-process layer above
    `ShardPlan` (counterpart of the JAX `HostPlan`): `host_of(ci) = ci %
    H`, so with H hosts over K chunks each process folds at most
    ceil(K/H) of them, and every process derives the same partition with
    no coordination. `local_index(ci) = ci // H` numbers a host's own
    chunks densely for the shard round-robin underneath. H = 1 is the
    one-process plan: every chunk owned. `record` counts `host.chunks` /
    `host.rows` by host and stage (`counters`)."""

    def __init__(self, n_hosts: Optional[int] = None,
                 host_index: Optional[int] = None) -> None:
        self.n_hosts = (lifecycle_hosts() if n_hosts is None
                        else max(1, int(n_hosts)))
        self.host_index = (lifecycle_host_index() if host_index is None
                           else int(host_index))
        if not (0 <= self.host_index < self.n_hosts):
            raise ValueError(
                f"host index {self.host_index} outside [0, {self.n_hosts})"
                " — check -Dshifu.lifecycle.hostIndex vs"
                " -Dshifu.lifecycle.hosts")
        self.counters: Dict[str, Dict[str, int]] = {"host.chunks": {},
                                                    "host.rows": {}}

    @property
    def active(self) -> bool:
        return self.n_hosts > 1

    @property
    def is_merge_host(self) -> bool:
        """Host 0 merges the hosts' partials in host order and writes the
        final artifacts; every other host publishes its part only."""
        return self.host_index == 0

    def host_of(self, chunk_index: int) -> int:
        return chunk_index % self.n_hosts

    def owns(self, chunk_index: int) -> bool:
        return chunk_index % self.n_hosts == self.host_index

    def local_index(self, chunk_index: int) -> int:
        """Dense ordinal of an owned chunk within this host's slice."""
        return chunk_index // self.n_hosts

    def record(self, rows: int, stage: str) -> None:
        """One folded chunk of `rows` rows at `stage` on this host."""
        for name, n in (("host.chunks", 1), ("host.rows", rows)):
            d = self.counters[name]
            d[stage] = d.get(stage, 0) + int(n)

    def describe(self) -> str:
        """`host h/H` and the counters as JSON: the line a multi-host
        step logs when its barrier has passed."""
        return (f"host {self.host_index}/{self.n_hosts} counters "
                f"{json.dumps(self.counters, sort_keys=True)}")


class ShardPlan:
    """Deterministic chunk -> row-shard assignment (counterpart of the
    JAX `ShardPlan`): ownership filters first (only chunks with
    `host.owns(ci)`), then `shard_of(ci) = host.local_index(ci) % S`, so
    the S local shards divide the host's slice evenly whatever H is; at
    one host that is `ci % S`. With S shards over K owned chunks each
    shard folds at most ceil(K/S) of them, and a resume skips, per
    shard, the chunks at or below its cursor."""

    def __init__(self, n_shards: Optional[int] = None,
                 device=None, host: Optional[HostPlan] = None) -> None:
        self.n_shards = (lifecycle_shards(device) if n_shards is None
                         else max(1, int(n_shards)))
        self.host = HostPlan() if host is None else host

    def shard_of(self, chunk_index: int) -> int:
        return self.host.local_index(chunk_index) % self.n_shards

    def resume_slice(self, numbered: Iterable,
                     cursors: List[int]) -> Iterator:
        """The owned (ci, item) pairs no shard has folded yet (ci > the
        cursor of its shard); skipped chunks are never transformed."""
        for pair in numbered:
            ci = pair[0]
            if self.host.owns(ci) and ci > cursors[self.shard_of(ci)]:
                yield pair


# BinAggregates fields in order; the running state keeps the counts in
# int64 and the sums in f64, the extrema in f32
_FIELDS = ("pos", "neg", "wpos", "wneg", "vsum", "vsumsq", "vmin", "vmax",
           "vcount", "vmissing")


def add_states(acc: Optional[Dict[str, np.ndarray]],
               part: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Two exact fold states (`DeviceAccumulator.snapshot` fields) added
    on the host: sums and counts added, the extrema min / max."""
    part = {k: np.asarray(part[k]) for k in _FIELDS}
    if acc is None:
        return part
    return {k: (np.minimum(acc[k], part[k]) if k == "vmin" else
                np.maximum(acc[k], part[k]) if k == "vmax" else
                acc[k] + part[k]) for k in _FIELDS}


def rounded_state(state: Dict[str, np.ndarray]) -> List[np.ndarray]:
    """An exact fold state as `DeviceAccumulator.fetch` returns it: the
    f64 sums rounded once to f32, every field as float64, in
    BinAggregates field order."""
    out = []
    for k in _FIELDS:
        a = np.asarray(state[k])
        if a.dtype == np.float64:
            a = a.astype(np.float32)
        out.append(a.astype(np.float64))
    return out


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
        state = self.snapshot()
        return rounded_state(state) if _FIELDS[0] in state else None

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

"""Host part exchange: the merge fabric of the multi-host lifecycle
(counterpart of `shifu_tpu/parallel/hostsync.py`).

A HostPlan (data/pipeline.py) hands every process its own chunk slice;
this module brings the per-host partial results back together. Each host
publishes its partial (named numpy arrays, JSON meta and an optional
pickled blob) as one atomic npz under the model set's run ledger:

    <root>/.shifu/runs/hosts/<step>/part-h000.npz

and `await_parts` blocks until every host's part for the same stream
identity (the caller's config sha) is there, returning them in sorted
host order — the merge order that keeps multi-process artifacts
byte-identical to the one-process run. The filesystem is the medium: no
sockets, no rendezvous address, and `atomic_write` makes a kill
mid-publish invisible (the previous complete part, or none).

An awaiting host ignores parts of another config sha or host count (left
by a run of other chunk geometry or columns). A fresh run calls
`clear_part` before streaming, so a crashed fleet never leaves a part a
later barrier could take for this run's.

Each barrier records `host.parts_published{step=,host=}`,
`host.parts_merged{step=}` and the timer `host.await_seconds{step=}` in
the obs registry, as in the JAX package.
"""

from __future__ import annotations

import io
import json
import os
import time
import zipfile
from typing import Dict, List, Optional, Tuple

import numpy as np

from shifu_tpu_torch.analysis import sanitize
from shifu_tpu_torch.obs import registry
from shifu_tpu_torch.resilience.checkpoint import atomic_write
from shifu_tpu_torch.utils import environment
from shifu_tpu_torch.utils.log import get_logger

log = get_logger(__name__)

META_KEY = "__meta__"
BLOB_KEY = "__blob__"

HOSTS_SUBDIR = os.path.join(".shifu", "runs", "hosts")

DEFAULT_WAIT_MS = 600_000

Part = Tuple[Dict[str, np.ndarray], dict, Optional[bytes]]

def host_wait_ms_setting() -> float:
    """shifu.lifecycle.hostWaitMs — how long a host waits for its peers'
    parts at a barrier before failing loudly (a dead peer must surface
    as an error, not a hang)."""
    return environment.get_float("shifu.lifecycle.hostWaitMs",
                                 DEFAULT_WAIT_MS)


def parts_dir(root: str, step: str) -> str:
    return os.path.join(os.path.abspath(root), HOSTS_SUBDIR, step)


def part_path(root: str, step: str, host_index: int) -> str:
    return os.path.join(parts_dir(root, step), f"part-h{host_index:03d}.npz")


def publish_part(root: str, step: str, host_plan, sha: str,
                 arrays: Optional[Dict[str, np.ndarray]] = None,
                 meta: Optional[dict] = None,
                 blob: Optional[bytes] = None) -> str:
    """Atomically publish this host's partial for `step`."""
    payload: Dict[str, np.ndarray] = {}
    for k, v in (arrays or {}).items():
        assert not k.startswith("__"), k
        payload[k] = np.asarray(v)
    header = {
        "host": host_plan.host_index,
        "hosts": host_plan.n_hosts,
        "configSha": sha,
        "meta": meta or {},
    }
    # -Dshifu.sanitize=divergence: the lockstep stamp peers check
    stamp = sanitize.barrier_stamp(
        step, host_plan.host_index, sha,
        list(arrays or ()) + list(meta or ()))
    if stamp is not None:
        header["sanitize"] = stamp
    payload[META_KEY] = np.frombuffer(
        json.dumps(header, sort_keys=True).encode("utf-8"), dtype=np.uint8)
    if blob is not None:
        payload[BLOB_KEY] = np.frombuffer(blob, dtype=np.uint8)
    buf = io.BytesIO()
    np.savez(buf, **payload)
    path = atomic_write(part_path(root, step, host_plan.host_index),
                        buf.getvalue())
    registry().counter("host.parts_published", step=step,
                       host=str(host_plan.host_index)).inc()
    return path


def clear_part(root: str, step: str, host_plan) -> None:
    """Remove this host's own previous part (fresh runs call this before
    streaming; other hosts' parts are their live state)."""
    try:
        os.unlink(part_path(root, step, host_plan.host_index))
    except OSError:  # never published / already cleared
        pass


def _read_part(path: str, sha: str, n_hosts: int):
    """(arrays, header, blob) when the part is complete and of this
    stream (sha and host count), else None: a missing, torn or foreign
    part reads as not arrived yet."""
    try:
        with np.load(path) as z:
            header = json.loads(bytes(z[META_KEY].tobytes()).decode())
            arrays = {k: z[k] for k in z.files
                      if k not in (META_KEY, BLOB_KEY)}
            blob = z[BLOB_KEY].tobytes() if BLOB_KEY in z.files else None
    except (OSError, ValueError, KeyError, EOFError,
            zipfile.BadZipFile):  # absent or torn
        return None
    if header.get("configSha") != sha or header.get("hosts") != n_hosts:
        return None
    return arrays, header, blob


def await_parts(root: str, step: str, host_plan, sha: str,
                timeout_ms: Optional[float] = None,
                poll_s: float = 0.05) -> List[Part]:
    """Block until every host's part for (`step`, `sha`) exists; return
    [(arrays, meta, blob)] in host order 0..H-1. Raises TimeoutError
    when a peer never publishes within shifu.lifecycle.hostWaitMs."""
    H = host_plan.n_hosts
    timeout_ms = host_wait_ms_setting() if timeout_ms is None else timeout_ms
    t0 = time.monotonic()
    deadline = t0 + timeout_ms / 1000.0
    parts: Dict[int, tuple] = {}
    while True:
        for h in range(H):
            if h in parts:
                continue
            got = _read_part(part_path(root, step, h), sha, H)
            if got is not None:
                parts[h] = got
        if len(parts) == H:
            break
        if time.monotonic() >= deadline:
            missing = sorted(set(range(H)) - set(parts))
            raise TimeoutError(
                f"host barrier '{step}' timed out after {timeout_ms:.0f}ms"
                f" waiting for host part(s) {missing} under"
                f" {parts_dir(root, step)} — peer process(es) dead or"
                " launched with a different config"
                " (-Dshifu.lifecycle.hostWaitMs raises the wait)")
        time.sleep(poll_s)
    own = host_plan.host_index
    sanitize.check_barrier_stamps(
        step, own,
        parts[own][1].get("sanitize") if own in parts else None,
        {h: hdr.get("sanitize") for h, (_a, hdr, _b) in parts.items()})
    waited = time.monotonic() - t0
    reg = registry()
    reg.timer("host.await_seconds", step=step).add(waited)
    reg.counter("host.parts_merged", step=step).inc(H)
    log.info("host barrier '%s': %d parts in %.3f s", step, H, waited)
    return [(a, hdr.get("meta", {}), b)
            for a, hdr, b in (parts[h] for h in range(H))]

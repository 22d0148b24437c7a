"""Process heartbeat leases: liveness for a fleet of serve processes
(counterpart of `shifu_tpu/resilience/lease.py`).

The reference system coordinated worker membership through ZooKeeper
ephemeral znodes — a dead JVM's znode vanished and the master re-planned
around it. This package has no coordination service; what it has is
one shared filesystem root per model set (the `.shifu/runs` ledger the
traffic log and checkpoints already use). This module rebuilds the
ephemeral-node contract on that substrate:

  * every `shifu serve` process ACQUIRES a lease — one atomic JSON file
    under `<root>/.shifu/runs/peers/`, named by a per-incarnation lease
    id and carrying `(pid, token, epoch, ttlMs, renewedAt, info)`.
  * the owner RENEWS it every `ttl/3` (an atomic rewrite: `renewedAt`
    moves forward, the file mtime with it, token and epoch never change
    after acquisition — a lease whose token or epoch differs between two
    reads is a DIFFERENT incarnation, which is the fencing signal the
    fleet-atomic promote round checks before committing).
  * peers OBSERVE each other by scanning the directory: a lease whose
    `renewedAt` is more than its own `ttlMs` ago is EXPIRED — the owning
    process is dead or wedged (a wedged-but-alive process that cannot
    renew must be treated as dead: it also cannot ack a promote round).
    Expired leases are left in place as evidence (survivors surface them
    as a degrade reason) until `shifu.lease.sweepAfterMs`, after which
    any scanner garbage-collects them so a dead peer does not degrade
    the fleet forever.

Knobs::

    shifu.lease.ttlMs          lease time-to-live (default 5000; a
                               process that misses renewal this long is
                               expired; 0 disables leases entirely)
    shifu.lease.renewMs        renewal cadence (default 0 = ttlMs / 3)
    shifu.lease.sweepAfterMs   expired-lease garbage collection age
                               (default 0 = 20 x ttlMs)

The renewal loop (serve/peers.py) passes through `fault_point("lease")`,
so the chaos grammar can stall renewals (`lease_stall:ms=`) or kill the
process outright (`peer_kill@lease=N`) deterministically.
"""

from __future__ import annotations

import json
import os
import secrets
import socket
import time
from typing import Dict, List, Optional

from shifu_tpu_torch.resilience.checkpoint import atomic_write_json
from shifu_tpu_torch.utils import environment
from shifu_tpu_torch.utils.log import get_logger

log = get_logger(__name__)

PEERS_DIRNAME = os.path.join(".shifu", "runs", "peers")
LEASE_SUFFIX = ".lease.json"

DEFAULT_TTL_MS = 5000.0


def ttl_ms_setting() -> float:
    """shifu.lease.ttlMs — heartbeat lease TTL (0 disables leases)."""
    return environment.get_float("shifu.lease.ttlMs", DEFAULT_TTL_MS)


def renew_ms_setting() -> float:
    """shifu.lease.renewMs — renewal cadence (0 = ttlMs / 3)."""
    return environment.get_float("shifu.lease.renewMs", 0.0)


def sweep_after_ms_setting() -> float:
    """shifu.lease.sweepAfterMs — GC age for expired leases
    (0 = 20 x ttlMs)."""
    return environment.get_float("shifu.lease.sweepAfterMs", 0.0)


def peers_dir(root: str) -> str:
    return os.path.join(os.path.abspath(root), PEERS_DIRNAME)


class ProcessLease:
    """This process's lease file: acquire -> renew -> release.

    Single-owner by construction (the lease id embeds host, pid and a
    random token), so there is nothing to contend for — the guarantees
    come from atomic writes (a reader never sees a torn lease) and from
    the renewal contract (a stale `renewedAt` means the owner is gone).
    NOT thread-safe: exactly one heartbeat thread owns it."""

    def __init__(self, root: str, info: Optional[dict] = None,
                 ttl_ms: Optional[float] = None) -> None:
        self.root = os.path.abspath(root)
        self.ttl_ms = ttl_ms_setting() if ttl_ms is None else float(ttl_ms)
        self.token = secrets.token_hex(8)
        self.pid = os.getpid()
        self.host = socket.gethostname()
        self.lease_id = f"{self.host}-{self.pid}-{self.token[:8]}"
        # the fence: strictly increases across acquisitions on one host,
        # so (token, epoch) names exactly one incarnation — a promote
        # round prepared against this lease refuses to commit if either
        # changed (the process died and came back as someone else)
        self.epoch = time.time_ns()
        self.acquired_at = 0.0
        self.renewals = 0
        self._released = False
        self._info = dict(info or {})

    @property
    def path(self) -> str:
        return os.path.join(peers_dir(self.root),
                            self.lease_id + LEASE_SUFFIX)

    def acquire(self, info: Optional[dict] = None) -> str:
        """Write the lease file (sweeping long-expired strays first so a
        fresh fleet does not inherit a dead one's degrade evidence)."""
        from shifu_tpu_torch.obs import registry

        now = time.time()
        self.acquired_at = now
        if info is not None:
            self._info = dict(info)
        sweep_expired(self.root, now=now)
        self._write(now)
        registry().counter("peer.lease.acquired").inc()
        log.info("lease %s acquired (ttl %.0f ms) under %s",
                 self.lease_id, self.ttl_ms, peers_dir(self.root))
        return self.path

    def renew(self, info: Optional[dict] = None) -> None:
        """Atomic rewrite with a fresh `renewedAt` (and file mtime). The
        caller's info (health status, port, active sha) rides along so a
        peer scan doubles as a cheap fleet-of-processes health view."""
        from shifu_tpu_torch.obs import registry

        if self._released:
            return
        if info is not None:
            self._info = dict(info)
        self.renewals += 1
        self._write(time.time())
        if self._released:
            # a release raced this renewal (heartbeat join timed out):
            # whatever order the write and the unlink landed in, the
            # re-check guarantees the file ends gone
            try:
                os.unlink(self.path)
            except OSError:
                pass
            return
        registry().counter("peer.lease.renewals").inc()

    def _write(self, now: float) -> None:
        atomic_write_json(self.path, {
            "schema": "shifu.lease/1",
            "leaseId": self.lease_id,
            "host": self.host,
            "pid": self.pid,
            "token": self.token,
            "epoch": self.epoch,
            "ttlMs": self.ttl_ms,
            "acquiredAt": self.acquired_at,
            "renewedAt": now,
            "renewals": self.renewals,
            "info": self._info,
        })

    def release(self) -> None:
        """Clean shutdown: the lease file is removed, not left to
        expire — a drained process is not a dead one. The flag flips
        BEFORE the unlink and renew() re-checks it after writing, so a
        renewal racing the release (the heartbeat thread is joined with
        a timeout) cannot resurrect the file in either interleaving."""
        self._released = True
        try:
            os.unlink(self.path)
        except OSError:
            pass


def read_lease(path: str) -> Optional[dict]:
    """One lease file -> dict, or None when torn/unreadable (a reader
    racing the atomic replace sees the old complete file, so None means
    genuinely corrupt or already swept)."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(doc, dict) or "leaseId" not in doc:
        return None
    return doc


def scan(root: str, now: Optional[float] = None,
         exclude: Optional[str] = None) -> List[dict]:
    """All leases under the root, each annotated with `ageMs` (since the
    last renewal) and `expired` (age past the lease's own ttl). Sorted
    by lease id for deterministic fence snapshots. `exclude` drops one
    lease id (the caller's own, for peer views)."""
    d = peers_dir(root)
    if now is None:
        now = time.time()
    out: List[dict] = []
    if not os.path.isdir(d):
        return out
    for name in sorted(os.listdir(d)):
        if not name.endswith(LEASE_SUFFIX):
            continue
        doc = read_lease(os.path.join(d, name))
        if doc is None or doc["leaseId"] == exclude:
            continue
        age_ms = (now - float(doc.get("renewedAt", 0.0))) * 1000.0
        doc["ageMs"] = round(age_ms, 1)
        doc["expired"] = age_ms > float(doc.get("ttlMs", DEFAULT_TTL_MS))
        out.append(doc)
    return out


def sweep_expired(root: str, now: Optional[float] = None,
                  scanned: Optional[List[dict]] = None) -> int:
    """Garbage-collect leases expired for longer than sweepAfterMs
    (default 20 x their own ttl). Counted `peer.lease.swept`; returns
    the number removed. Recently expired leases are kept — they are the
    evidence a survivor's /healthz surfaces. `scanned` reuses a scan()
    the caller already paid for (the heartbeat observes and sweeps every
    beat — one directory read, not two)."""
    from shifu_tpu_torch.obs import registry

    if now is None:
        now = time.time()
    swept = 0
    grace = sweep_after_ms_setting()
    for doc in (scan(root, now=now) if scanned is None else scanned):
        if not doc["expired"]:
            continue
        limit = grace if grace > 0 else 20.0 * float(
            doc.get("ttlMs", DEFAULT_TTL_MS))
        if doc["ageMs"] <= limit:
            continue
        try:
            os.unlink(os.path.join(
                peers_dir(root), doc["leaseId"] + LEASE_SUFFIX))
            swept += 1
        except OSError:
            continue
    if swept:
        registry().counter("peer.lease.swept").inc(swept)
        log.info("swept %d long-expired lease(s) under %s",
                 swept, peers_dir(root))
    return swept


def fence_check(root: str, fence: List[Dict],
                now: Optional[float] = None) -> List[str]:
    """Verify a fence snapshot (the `peers` list a promote prepare
    record captured: leaseId/token/epoch per live peer) against the
    directory NOW. Returns the list of broken-fence reasons — empty
    means every fenced peer is still the same live incarnation, which
    is the precondition for a fleet-atomic commit."""
    current = {d["leaseId"]: d for d in scan(root, now=now)}
    broken: List[str] = []
    for want in fence:
        lid = want["leaseId"]
        have = current.get(lid)
        if have is None:
            broken.append(f"lease {lid} vanished mid-round")
        elif have.get("token") != want.get("token") \
                or have.get("epoch") != want.get("epoch"):
            broken.append(f"lease {lid} changed incarnation mid-round "
                          "(process restarted)")
        elif have["expired"]:
            broken.append(f"lease {lid} expired mid-round "
                          f"({have['ageMs']:.0f} ms since renewal)")
    return broken

"""Peer registry: heartbeat leases + the promote-round participant
(counterpart of `shifu_tpu/serve/peers.py`).

One `PeerRegistry` rides inside every `ScoringServer`. Its single
heartbeat thread does three things each beat:

  1. RENEW this process's lease (resilience/lease.py) with a health
     summary (status, port, active sha, queue depth) — so a peer scan
     doubles as a cheap fleet-of-processes health view.
  2. OBSERVE the other leases: live/expired counts land in the
     `peer.processes.*` gauges, a NEWLY expired peer counts
     `peer.lease.expired` once per lease, and `/healthz` surfaces
     expired peers as a computed degrade reason — survivors keep
     serving, but the balancer and the operator both see that the
     process fleet lost a member.
  3. PARTICIPATE in fleet-atomic promotion rounds (loop/rounds.py): on
     a prepare record that fences this lease, stage + validate the
     sha-bound candidate on the whole replica fleet (the PR-12 pre-roll
     validation is phase one of the protocol) and ack; then apply the
     commit (rolling in-process promote) or roll back on abort — or on
     deadline expiry with no verdict at all (a dead coordinator), after
     one final verdict read.

The beat passes through `fault_point("lease")`, so the chaos grammar
drives every transition deterministically: `lease_stall:ms=` delays
renewal past the TTL (peers see this process expire while it keeps
serving), `peer_kill@lease=N` SIGKILLs the process on its Nth beat
(mid-round, if N is chosen inside one).
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Callable, List, Optional

from shifu_tpu_torch.analysis.racetrack import tracked_lock
from shifu_tpu_torch.loop import rounds
from shifu_tpu_torch.resilience import faults, lease
from shifu_tpu_torch.utils.log import get_logger

log = get_logger(__name__)

# extra margin past a round's deadline before a participant self-aborts:
# the coordinator refuses to commit after the deadline, so a verdict
# can only land inside it — the grace absorbs scheduling skew between
# the two processes' clock reads
ROUND_GRACE_FRACTION = 0.5
# verdict-poll cadence while a round is in flight (the renewal cadence
# is too coarse to commit a round within one lease TTL)
ROUND_POLL_S = rounds.ROUND_POLL_S
_HANDLED_ROUNDS_KEPT = 16
# an aborted round's rollback can transiently collide with the fleet
# control-plane flag (an operator /admin stage in flight): retry a few
# times before surfacing the failure — a candidate an aborted round
# leaves staged is a rollout hazard, not a log line
_ROLLBACK_ATTEMPTS = 5
_ROLLBACK_RETRY_S = 0.3


@contextmanager
def _span(trace, name: str):
    """Stage span on the participant's round trace; no-op without one
    (a prepare record written by an older coordinator has no trace)."""
    if trace is None:
        yield
        return
    with trace.stage(name):
        yield


class PeerRegistry:
    """This process's lease + the peer view + the 2PC participant.

    `stage_cb(candidate_dir) -> staged snapshot dict`, `promote_cb(sha)`
    and `unstage_cb()` are the server hooks a promotion round drives;
    `info_cb() -> dict` supplies the health summary renewed into the
    lease file. Disabled entirely (no thread, no files) when the lease
    TTL knob is 0."""

    def __init__(self, root: str,
                 stage_cb: Optional[Callable] = None,
                 promote_cb: Optional[Callable] = None,
                 unstage_cb: Optional[Callable] = None,
                 info_cb: Optional[Callable] = None,
                 ttl_ms: Optional[float] = None) -> None:
        self.root = root
        self.stage_cb = stage_cb
        self.promote_cb = promote_cb
        self.unstage_cb = unstage_cb
        self.info_cb = info_cb
        ttl = lease.ttl_ms_setting() if ttl_ms is None else float(ttl_ms)
        self.enabled = ttl > 0.0
        self._lock = tracked_lock("serve.peers")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._peers: List[dict] = []
        self._expired_counted: set = set()
        # active promotion round (heartbeat thread writes, snapshot
        # reads): {round, deadline, sha, acked, ok}
        self._round: Optional[dict] = None
        self._handled: List[str] = []
        if not self.enabled:
            self.lease = None
            return
        self.lease = lease.ProcessLease(root, ttl_ms=ttl)
        renew = lease.renew_ms_setting()
        self._renew_s = (renew if renew > 0 else ttl / 3.0) / 1000.0
        self.lease.acquire(info=self._info())
        self._thread = threading.Thread(
            target=self._run, name="shifu-serve-peers", daemon=True)
        self._thread.start()

    # ---- heartbeat ----
    def _info(self) -> dict:
        if self.info_cb is None:
            return {}
        try:
            return dict(self.info_cb() or {})
        except Exception as e:  # a health summary must not kill renewal
            log.warning("peer info callback failed: %s", e)
            return {}

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self._beat()
            except Exception as e:  # heartbeat survives transient faults
                # (incl. injected lease-seam faults): a missed beat is
                # exactly what the TTL tolerates, a dead heartbeat is a
                # dead process
                log.warning("peer heartbeat failed: %s", e)
            with self._lock:
                in_round = self._round is not None
            self._stop.wait(ROUND_POLL_S if in_round else self._renew_s)

    def _beat(self) -> None:
        # the chaos seam: lease_stall sleeps here (renewal slips past
        # the TTL while the process keeps serving), peer_kill SIGKILLs
        faults.fault_point("lease")
        self.lease.renew(info=self._info())
        self._observe_peers()
        self._participate()

    def _observe_peers(self) -> None:
        from shifu_tpu_torch.obs import registry

        all_leases = lease.scan(self.root)
        peers = [p for p in all_leases
                 if p["leaseId"] != self.lease.lease_id]
        # one directory read per beat: the sweep reuses the scan
        lease.sweep_expired(self.root, scanned=all_leases)
        reg = registry()
        live = [p for p in peers if not p["expired"]]
        expired = [p for p in peers if p["expired"]]
        reg.gauge("peer.processes.live").set(len(live) + 1)  # + self
        reg.gauge("peer.processes.expired").set(len(expired))
        with self._lock:
            counted = self._expired_counted
            # a peer seen LIVE again (it was only wedged, or a false
            # expiry during its own device-heavy stage) un-counts, so a
            # later real death is counted as a fresh event
            counted.difference_update(p["leaseId"] for p in live)
            fresh = [p["leaseId"] for p in expired
                     if p["leaseId"] not in counted]
            counted.update(fresh)
            self._peers = peers
        for lid in fresh:
            reg.counter("peer.lease.expired").inc()
            log.warning("peer lease %s expired (dead or wedged process)",
                        lid)

    # ---- promotion-round participant ----
    def _participate(self) -> None:
        prep = rounds.latest_prepare(self.root)
        with self._lock:
            active = dict(self._round) if self._round else None
            handled = list(self._handled)
        if active is not None:
            self._check_verdict(active)
            return
        if prep is None or prep["round"] in handled:
            return
        self._join_round(prep)

    def _fenced(self, prep: dict) -> bool:
        me = self.lease
        for p in prep.get("peers", []):
            if (p.get("leaseId") == me.lease_id
                    and p.get("token") == me.token
                    and p.get("epoch") == me.epoch):
                return True
        return False

    def _mark_handled(self, round_id: str) -> None:
        with self._lock:
            self._handled.append(round_id)
            del self._handled[:-_HANDLED_ROUNDS_KEPT]
            self._round = None

    def _join_round(self, prep: dict) -> None:
        rid = prep["round"]
        if not self._fenced(prep):
            # prepared against a fence this incarnation is not part of
            # (we started mid-round): not ours to ack, and the
            # coordinator is not waiting for us
            log.info("promotion round %s does not fence this lease; "
                     "ignoring", rid)
            self._mark_handled(rid)
            return
        if time.time() > prep["deadlineUnix"]:
            self._mark_handled(rid)
            return
        me = self.lease
        sha = prep.get("candidateSha")
        # this participant's spans share the coordinator's round trace
        # id (stamped in the prepare record), so `shifu trace --fleet`
        # stitches both sides of the round into one timeline
        from shifu_tpu_torch.obs import reqtrace

        tr = reqtrace.RequestTrace(trace_id=prep.get("trace"),
                                   sampled=True)
        tr.annotate(role="participant", round=rid, leaseId=me.lease_id)
        try:
            if self.stage_cb is None:
                raise ValueError("this process cannot stage candidates")
            with tr.stage("stage"):
                staged = self.stage_cb(prep["candidateDir"]) or {}
            staged_sha = staged.get("sha")
            if sha and staged_sha != sha:
                # sha-bound: the candidate dir changed since the
                # coordinator hashed it — refuse, roll back our stage
                if self.unstage_cb is not None:
                    self.unstage_cb()
                raise ValueError(
                    f"staged candidate is {staged_sha}, prepare record "
                    f"says {sha} — candidate dir changed mid-round")
        except Exception as e:  # a failed stage is a NACK, not a crash
            log.warning("promotion round %s: stage failed: %s", rid, e)
            with tr.stage("ack"):
                rounds.write_ack(self.root, rid, me.lease_id, me.token,
                                 me.epoch, ok=False, reason=str(e))
            self._offer_round_trace(tr, "nack")
            self._mark_handled(rid)
            return
        # renew IMMEDIATELY after the (device-heavy) stage: the fence
        # check at commit time must see this lease fresh
        self.lease.renew(info=self._info())
        with tr.stage("ack"):
            rounds.write_ack(self.root, rid, me.lease_id, me.token,
                             me.epoch, ok=True, staged_sha=staged_sha,
                             shadow=staged if isinstance(staged, dict)
                             else None)
        grace = max((prep["deadlineUnix"] - time.time())
                    * ROUND_GRACE_FRACTION, self._renew_s)
        with self._lock:
            self._round = {"round": rid, "sha": sha,
                           "deadline": prep["deadlineUnix"],
                           "grace": grace, "trace": tr}
        log.info("promotion round %s: staged + acked candidate %s",
                 rid, staged_sha)

    def _check_verdict(self, active: dict) -> None:
        rid = active["round"]
        trace = active.get("trace")
        state = rounds.read_round(self.root, rid)
        verdict = self._apply_verdict(rid, state, active["sha"], trace)
        if verdict:
            self._mark_handled(rid)
            return
        if time.time() <= active["deadline"] + active["grace"]:
            return
        # deadline + grace passed with NO verdict: the coordinator died
        # mid-round. One FINAL read (a commit written inside the
        # deadline is durable and must win), then roll back — every
        # crash mode converges to the old version everywhere.
        state = rounds.read_round(self.root, rid)
        if not self._apply_verdict(rid, state, active["sha"], trace):
            log.warning("promotion round %s: no verdict by deadline — "
                        "rolling back to active", rid)
            rounds.write_abort(self.root, rid,
                               "no verdict by deadline (coordinator "
                               "dead?)", role="participant")
            self._rollback(rid, trace)
            self._offer_round_trace(trace, "self-abort")
        self._mark_handled(rid)

    def _apply_verdict(self, rid: str, state: dict,
                       sha: Optional[str], trace=None) -> bool:
        """Apply a commit/abort record if one exists. True when the
        round reached a verdict (and was applied)."""
        if state["commit"] is not None:
            try:
                with _span(trace, "commit"):
                    if self.promote_cb is not None:
                        self.promote_cb(state["commit"].get("sha") or sha)
                rounds.note_phase("commit", "participant")
                log.info("promotion round %s: committed -> %s", rid,
                         state["commit"].get("sha"))
            except Exception as e:  # a failed local swap after a fleet
                # commit is surfaced loudly — the process keeps serving
                # its old version and the operator re-runs promote
                log.error("promotion round %s: commit apply failed: %s",
                          rid, e)
            self._offer_round_trace(trace, "commit")
            return True
        if state["abort"] is not None:
            self._rollback(rid, trace)
            self._offer_round_trace(trace, "abort")
            return True
        return False

    def _rollback(self, rid: str, trace=None) -> None:
        with _span(trace, "rollback"):
            for attempt in range(_ROLLBACK_ATTEMPTS):
                try:
                    if self.unstage_cb is not None:
                        self.unstage_cb()
                    break
                except Exception as e:  # rollback must never take the
                    # server down — but a staged candidate an aborted
                    # round leaves behind could later be promoted by an
                    # operator, so a transient refusal (the fleet
                    # control-plane flag held by a concurrent
                    # stage/promote) is retried, not shrugged
                    if attempt + 1 == _ROLLBACK_ATTEMPTS:
                        log.error("promotion round %s: unstage failed "
                                  "after %d attempts — candidate may "
                                  "still be staged on this process: %s",
                                  rid, _ROLLBACK_ATTEMPTS, e)
                    else:
                        self._stop.wait(_ROLLBACK_RETRY_S)
        rounds.note_phase("rollback", "participant")
        log.info("promotion round %s: rolled back to active", rid)

    def _offer_round_trace(self, trace, outcome: str) -> None:
        """Retain the participant's round spans in the process trace
        ring — they land in this process's `.traces.json` ledger export
        at shutdown, where `shifu trace --fleet` finds them."""
        if trace is None:
            return
        from shifu_tpu_torch.obs import reqtrace

        trace.annotate(outcome=outcome)
        reqtrace.buffer().offer(trace)

    # ---- views ----
    def peers(self) -> List[dict]:
        with self._lock:
            return list(self._peers)

    def snapshot(self) -> dict:
        """The /healthz + manifest view: this lease, the peer processes
        (live + expired with ages), and the active round if any."""
        if not self.enabled:
            return {"enabled": False}
        with self._lock:
            peers = list(self._peers)
            active = dict(self._round) if self._round else None
        if active is not None and active.get("trace") is not None:
            # the live RequestTrace rides _round for the span calls;
            # the JSON view carries only its id
            active["trace"] = active["trace"].trace_id
        live = [p for p in peers if not p["expired"]]
        expired = [p for p in peers if p["expired"]]
        return {
            "enabled": True,
            "leaseId": self.lease.lease_id,
            "epoch": self.lease.epoch,
            "ttlMs": self.lease.ttl_ms,
            "renewals": self.lease.renewals,
            "liveProcesses": len(live) + 1,
            "expiredProcesses": len(expired),
            "round": active,
            "processes": [
                {"leaseId": p["leaseId"], "pid": p.get("pid"),
                 "ageMs": p["ageMs"], "expired": p["expired"],
                 "info": p.get("info") or {}}
                for p in peers
            ],
        }

    def expired_peers(self) -> List[str]:
        """Lease ids of currently expired peers — the /healthz degrade
        reason source."""
        with self._lock:
            return [p["leaseId"] for p in self._peers if p["expired"]]

    def close(self) -> None:
        """Stop the heartbeat and RELEASE the lease (clean shutdown is
        not death: the file is removed, peers see the fleet shrink, not
        a member expire)."""
        if not self.enabled:
            return
        self._stop.set()
        if self._thread is not None:
            self._thread.join(5.0)
        self.lease.release()

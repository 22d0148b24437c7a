"""Fleet-atomic promotion rounds: the two-phase file commit protocol
(counterpart of `shifu_tpu/loop/rounds.py`).

With N `shifu serve` processes on one model set (resilience/lease.py
gives them mutual awareness), `shifu promote` can no longer hot-swap one
process and call the fleet promoted — and the offline dir swap would
yank `models/` out from under live servers. This module is the record
layer of the replacement protocol, a two-phase commit written entirely
as atomic files under `<root>/.shifu/runs/peers/rounds/`:

  <round>-prepare.json        the coordinator fans out: candidate dir +
                              content sha, the FENCE (every currently
                              live lease's id/token/epoch), and a
                              deadline one lease TTL out.
  <round>-ack-<leaseId>.json  each fenced leaseholder stages the
                              sha-bound candidate on its whole replica
                              fleet (the PR-12 pre-roll validation is
                              exactly phase one) and acks ok/not-ok.
  <round>-commit.json         written by the coordinator ONLY on
                              unanimous ok-acks from every fenced peer,
                              with the fence re-checked immediately
                              before — this file IS the atomic commit
                              point.
  <round>-abort.json          any nack, fence break (a peer died,
                              expired, or restarted mid-round) or
                              deadline pass instead writes this; every
                              staged participant rolls back to active.

Participants that acked poll for the verdict; if NEITHER verdict lands
by `deadline + grace` (the coordinator itself died), they re-read one
final time and self-abort — so every failure mode converges to "all
processes on the old version" and a half-promoted fleet is impossible.
Readers always see complete records (atomic_write_json), and every
record is idempotent to re-read.
"""

from __future__ import annotations

import json
import os
import secrets
import time
from typing import Dict, List, Optional

from shifu_tpu_torch.resilience.checkpoint import atomic_write_json
from shifu_tpu_torch.resilience.lease import peers_dir
from shifu_tpu_torch.utils.log import get_logger

log = get_logger(__name__)

ROUNDS_DIRNAME = "rounds"
# rounds kept on disk for the audit trail; older ones are swept when a
# new round starts (the promote manifest is the durable audit record)
KEEP_ROUNDS = 8
# verdict/ack poll cadence, shared by the coordinator (loop/promote.py)
# and the participant (serve/peers.py) — one protocol, one clock
ROUND_POLL_S = 0.05


def rounds_dir(root: str) -> str:
    return os.path.join(peers_dir(root), ROUNDS_DIRNAME)


def new_round_id() -> str:
    """Sortable + collision-free: ms timestamp, then a random suffix."""
    return f"{int(time.time() * 1000):013d}-{secrets.token_hex(3)}"


def note_phase(phase: str, role: str) -> None:
    """promote.phase.* counters — every protocol step a process takes
    lands in its manifest, so a round is reconstructible per process
    (`role` = coordinator | participant)."""
    from shifu_tpu_torch.obs import registry

    registry().counter("promote.phase." + phase, role=role).inc()


def _path(root: str, name: str) -> str:
    return os.path.join(rounds_dir(root), name)


def _read_json(path: str) -> Optional[dict]:
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    return doc if isinstance(doc, dict) else None


def write_prepare(root: str, round_id: str, candidate_dir: str,
                  candidate_sha: str, fence: List[Dict],
                  deadline_unix: float,
                  trace: Optional[str] = None) -> str:
    """`trace` is the coordinator's round trace id: participants open
    their prepare/stage/ack/commit spans under the SAME id, so `shifu
    trace --fleet` stitches one cross-process view of the round."""
    sweep_rounds(root)
    note_phase("prepare", "coordinator")
    return atomic_write_json(_path(root, f"{round_id}-prepare.json"), {
        "schema": "shifu.promote_round/1",
        "round": round_id,
        "candidateDir": os.path.abspath(candidate_dir),
        "candidateSha": candidate_sha,
        "peers": fence,
        "deadlineUnix": deadline_unix,
        "startedAt": time.time(),
        "coordinatorPid": os.getpid(),
        "trace": trace,
    })


def write_ack(root: str, round_id: str, lease_id: str, token: str,
              epoch: int, ok: bool, staged_sha: Optional[str] = None,
              reason: Optional[str] = None,
              shadow: Optional[dict] = None) -> str:
    note_phase("ack", "participant")
    return atomic_write_json(
        _path(root, f"{round_id}-ack-{lease_id}.json"), {
            "round": round_id,
            "leaseId": lease_id,
            "token": token,
            "epoch": epoch,
            "ok": bool(ok),
            "stagedSha": staged_sha,
            "reason": reason,
            "shadow": shadow,
            "ackedAt": time.time(),
        })


def write_commit(root: str, round_id: str, sha: str) -> str:
    note_phase("commit", "coordinator")
    return atomic_write_json(_path(root, f"{round_id}-commit.json"), {
        "round": round_id, "sha": sha, "committedAt": time.time()})


def write_abort(root: str, round_id: str, reason: str,
                role: str = "coordinator") -> str:
    note_phase("abort", role)
    return atomic_write_json(_path(root, f"{round_id}-abort.json"), {
        "round": round_id, "reason": reason, "abortedAt": time.time()})


def read_round(root: str, round_id: str) -> dict:
    """Everything known about one round: prepare, acks by lease id, and
    the verdict (commit/abort record, at most one in a correct run —
    commit wins the read if both somehow exist, since only a committed
    round moved the models dir)."""
    d = rounds_dir(root)
    acks: Dict[str, dict] = {}
    if os.path.isdir(d):
        prefix = f"{round_id}-ack-"
        for name in sorted(os.listdir(d)):
            if name.startswith(prefix) and name.endswith(".json"):
                doc = _read_json(os.path.join(d, name))
                if doc is not None:
                    acks[doc.get("leaseId", name)] = doc
    return {
        "prepare": _read_json(_path(root, f"{round_id}-prepare.json")),
        "acks": acks,
        "commit": _read_json(_path(root, f"{round_id}-commit.json")),
        "abort": _read_json(_path(root, f"{round_id}-abort.json")),
    }


def latest_prepare(root: str) -> Optional[dict]:
    """Newest prepare record (round ids sort chronologically)."""
    d = rounds_dir(root)
    if not os.path.isdir(d):
        return None
    names = sorted((n for n in os.listdir(d)
                    if n.endswith("-prepare.json")), reverse=True)
    for name in names:
        doc = _read_json(os.path.join(d, name))
        if doc is not None:
            return doc
    return None


def sweep_rounds(root: str, keep: int = KEEP_ROUNDS) -> int:
    """Drop the files of all but the newest `keep` rounds (their outcome
    lives on in the promote manifests)."""
    d = rounds_dir(root)
    if not os.path.isdir(d):
        return 0
    rounds = sorted({n.split("-prepare.json")[0]
                     for n in os.listdir(d)
                     if n.endswith("-prepare.json")}, reverse=True)
    removed = 0
    for rid in rounds[keep:]:
        for name in sorted(os.listdir(d)):
            if name.startswith(rid + "-"):
                try:
                    os.unlink(os.path.join(d, name))
                    removed += 1
                except OSError:
                    continue
    return removed

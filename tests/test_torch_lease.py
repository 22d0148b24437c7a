"""The port's heartbeat leases (`resilience/lease.py`), peer registry
(`serve/peers.py`) and fleet-atomic promotion rounds (`loop/rounds.py`,
`loop/promote.py` fleet mode), the cases of the JAX package's
tests/test_lease.py, and the records held against the JAX package's.

Held equal to the JAX package: the keys of a lease file and of every
round record (prepare, ack, commit, abort), which either package's
processes read. The protocol is file-based, so two registries in one
process behave as two processes; every registry a test starts is closed
in its `finally` (or a fixture's teardown), so no heartbeat thread
outlives its test.
"""

import json
import os
import time

import pytest

from shifu_tpu_torch import obs
from shifu_tpu_torch.loop import rounds
from shifu_tpu_torch.resilience import lease
from shifu_tpu_torch.serve.peers import PeerRegistry
from shifu_tpu_torch.utils import environment


class _Props:
    def __init__(self, **props):
        self.props = {k.replace("_", "."): v for k, v in props.items()}

    def __enter__(self):
        for k, v in self.props.items():
            environment.set_property(k, v)
        return self

    def __exit__(self, *exc):
        for k in self.props:
            environment.set_property(k, "")


def _wait_for(pred, timeout=10.0, interval=0.02, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {msg}")


# ---------------------------------------------------------------------------
# the records against the JAX package's
# ---------------------------------------------------------------------------


def test_lease_file_has_the_jax_keys(tmp_path):
    jlease = pytest.importorskip("shifu_tpu.resilience.lease")
    pl = lease.ProcessLease(str(tmp_path / "p"), ttl_ms=5000)
    jl = jlease.ProcessLease(str(tmp_path / "j"), ttl_ms=5000)
    try:
        pdoc = lease.read_lease(pl.acquire(info={"port": 1}))
        jdoc = jlease.read_lease(jl.acquire(info={"port": 1}))
        assert set(pdoc) == set(jdoc)
        assert pdoc["schema"] == jdoc["schema"] == "shifu.lease/1"
        assert os.path.relpath(pl.path, str(tmp_path / "p")) == \
            os.path.relpath(jl.path, str(tmp_path / "j")).replace(
                jl.lease_id, pl.lease_id)
        # each package reads the other's lease file
        assert jlease.read_lease(pl.path)["leaseId"] == pl.lease_id
        assert lease.read_lease(jl.path)["leaseId"] == jl.lease_id
    finally:
        pl.release()
        jl.release()


def test_round_records_have_the_jax_keys(tmp_path):
    jrounds = pytest.importorskip("shifu_tpu.loop.rounds")
    docs = []
    for mod, root in ((rounds, str(tmp_path / "p")),
                      (jrounds, str(tmp_path / "j"))):
        rid = "0000000001000-abcdef"
        mod.write_prepare(root, rid, "/cand", "sha", [], time.time() + 5,
                          trace="round-x")
        mod.write_ack(root, rid, "p1", "t1", 1, ok=True, staged_sha="sha")
        mod.write_commit(root, rid, "sha")
        mod.write_abort(root, rid, "why")
        state = mod.read_round(root, rid)
        docs.append({k: (set(v) if isinstance(v, dict) and k != "acks"
                         else {a: set(d) for a, d in v.items()})
                     for k, v in state.items()})
        assert sorted(os.listdir(mod.rounds_dir(root))) == sorted(
            f"{rid}-{n}.json" for n in ("prepare", "ack-p1", "commit",
                                        "abort"))
    assert docs[0] == docs[1]
    # the JAX coordinator's prepare record is a prepare the port reads
    assert rounds.latest_prepare(str(tmp_path / "j"))["candidateSha"] \
        == "sha"


# ---------------------------------------------------------------------------
# lease files
# ---------------------------------------------------------------------------


def test_acquire_renew_release_roundtrip(tmp_path):
    root = str(tmp_path)
    pl = lease.ProcessLease(root, ttl_ms=5000)
    path = pl.acquire(info={"port": 1234})
    assert os.path.isfile(path)
    doc = lease.read_lease(path)
    assert (doc["leaseId"], doc["token"], doc["epoch"]) == \
        (pl.lease_id, pl.token, pl.epoch)
    assert doc["info"] == {"port": 1234}
    t0 = doc["renewedAt"]
    pl.renew(info={"port": 1234, "status": "ok"})
    doc2 = lease.read_lease(path)
    assert doc2["renewedAt"] >= t0 and doc2["renewals"] == 1
    # token and epoch never change across renewals (the fence)
    assert (doc2["token"], doc2["epoch"]) == (doc["token"], doc["epoch"])
    pl.release()
    assert not os.path.isfile(path)
    pl.renew()  # a renewal after the release cannot resurrect the file
    assert not os.path.isfile(path)


def test_scan_classifies_live_vs_expired(tmp_path):
    root = str(tmp_path)
    live = lease.ProcessLease(root, ttl_ms=60_000)
    live.acquire()
    dead = lease.ProcessLease(root, ttl_ms=100)
    dead.acquire()
    now = time.time() + 1.0
    by_id = {p["leaseId"]: p for p in lease.scan(root, now=now)}
    assert not by_id[live.lease_id]["expired"]
    assert by_id[dead.lease_id]["expired"]
    assert by_id[dead.lease_id]["ageMs"] > 100
    assert live.lease_id not in {
        p["leaseId"] for p in lease.scan(root, now=now,
                                         exclude=live.lease_id)}


def test_lease_expires_and_is_swept(tmp_path):
    obs.reset()
    root = str(tmp_path)
    fresh = lease.ProcessLease(root, ttl_ms=50)
    fresh.acquire()
    # expired (age > ttl) but not long-expired: kept as evidence
    assert lease.sweep_expired(root, now=time.time() + 0.2) == 0
    assert len(lease.scan(root)) == 1
    # age > 20 x ttl: garbage-collected, and counted
    assert lease.sweep_expired(root, now=time.time() + 2.0) == 1
    assert lease.scan(root) == []
    assert obs.registry().snapshot()["counters"]["peer.lease.swept"] == 1
    # shifu.lease.sweepAfterMs overrides the 20 x ttl default
    again = lease.ProcessLease(root, ttl_ms=50)
    again.acquire()
    with _Props(shifu_lease_sweepAfterMs="100"):
        assert lease.sweep_expired(root, now=time.time() + 0.2) == 1


def test_settings_read_the_lease_knobs():
    assert lease.ttl_ms_setting() == 5000.0
    with _Props(shifu_lease_ttlMs="1500", shifu_lease_renewMs="200"):
        assert lease.ttl_ms_setting() == 1500.0
        assert lease.renew_ms_setting() == 200.0
        assert lease.ProcessLease("/nonexistent").ttl_ms == 1500.0


def test_fence_check_detects_every_break(tmp_path):
    root = str(tmp_path)
    a = lease.ProcessLease(root, ttl_ms=60_000)
    a.acquire()
    fence = [{"leaseId": a.lease_id, "token": a.token, "epoch": a.epoch}]
    assert lease.fence_check(root, fence) == []
    broken = lease.fence_check(root, fence, now=time.time() + 120)
    assert broken and "expired" in broken[0]
    path = os.path.join(lease.peers_dir(root),
                        a.lease_id + lease.LEASE_SUFFIX)
    with open(path) as fh:
        doc = json.load(fh)
    doc["token"] = "someone-else"
    with open(path, "w") as fh:
        json.dump(doc, fh)
    broken = lease.fence_check(root, fence)
    assert broken and "incarnation" in broken[0]
    os.unlink(path)
    broken = lease.fence_check(root, fence)
    assert broken and "vanished" in broken[0]


# ---------------------------------------------------------------------------
# the peer registry (heartbeat thread)
# ---------------------------------------------------------------------------


def test_two_registries_observe_each_other(tmp_path):
    obs.reset()
    root = str(tmp_path)
    a = PeerRegistry(root, ttl_ms=2000)
    b = PeerRegistry(root, ttl_ms=2000)
    try:
        _wait_for(lambda: len(a.peers()) == 1 and len(b.peers()) == 1,
                  msg="mutual peer discovery")
        assert a.peers()[0]["leaseId"] == b.lease.lease_id
        snap = a.snapshot()
        assert snap["liveProcesses"] == 2 and snap["expiredProcesses"] == 0
        counters = obs.registry().snapshot()["counters"]
        assert counters["peer.lease.acquired"] == 2
        assert counters["peer.lease.renewals"] >= 2
    finally:
        b.close()
        a.close()
    assert lease.scan(root) == []  # released, not left to expire


def test_expired_peer_detected_and_counted_once(tmp_path):
    obs.reset()
    root = str(tmp_path)
    dead = lease.ProcessLease(root, ttl_ms=50)
    dead.acquire()
    time.sleep(0.1)
    a = PeerRegistry(root, ttl_ms=60_000)
    try:
        _wait_for(lambda: a.expired_peers() == [dead.lease_id],
                  msg="expired peer detection")
        time.sleep(0.1)
        counters = obs.registry().snapshot()["counters"]
        assert counters.get("peer.lease.expired") == 1.0
        snap = a.snapshot()
        assert snap["expiredProcesses"] == 1 and snap["liveProcesses"] == 1
        assert obs.registry().snapshot()["gauges"][
            "peer.processes.expired"] == 1.0
    finally:
        a.close()


def test_disabled_by_zero_ttl(tmp_path):
    with _Props(shifu_lease_ttlMs="0"):
        reg = PeerRegistry(str(tmp_path))
        assert not reg.enabled
        assert reg.snapshot() == {"enabled": False}
        reg.close()
    assert lease.scan(str(tmp_path)) == []


# ---------------------------------------------------------------------------
# promotion rounds: the participant
# ---------------------------------------------------------------------------


class _Participant:
    """A PeerRegistry wired to recording callbacks (the server's part)."""

    def __init__(self, root, ttl_ms=2000, sha="cand-sha",
                 stage_error=None):
        self.staged = []
        self.promoted = []
        self.unstaged = 0
        self.sha = sha
        self.stage_error = stage_error

        def stage_cb(candidate_dir):
            if self.stage_error is not None:
                raise self.stage_error
            self.staged.append(candidate_dir)
            return {"sha": self.sha}

        def promote_cb(sha):
            self.promoted.append(sha)

        def unstage_cb():
            self.unstaged += 1

        self.reg = PeerRegistry(root, stage_cb=stage_cb,
                                promote_cb=promote_cb,
                                unstage_cb=unstage_cb, ttl_ms=ttl_ms)

    def fence_entry(self):
        pl = self.reg.lease
        return {"leaseId": pl.lease_id, "token": pl.token,
                "epoch": pl.epoch}

    def close(self):
        self.reg.close()


@pytest.fixture()
def participants():
    made = []

    def make(root, **kw):
        p = _Participant(root, **kw)
        made.append(p)
        return p

    yield make
    for p in made:
        p.close()


def _prepare(root, parts, deadline_s=10.0, sha="cand-sha"):
    rid = rounds.new_round_id()
    rounds.write_prepare(root, rid, os.path.join(root, "cand"), sha,
                         [p.fence_entry() for p in parts],
                         time.time() + deadline_s)
    return rid


def test_participant_stages_acks_and_commits(tmp_path, participants):
    obs.reset()
    root = str(tmp_path)
    part = participants(root)
    rid = _prepare(root, [part])
    _wait_for(lambda: rounds.read_round(root, rid)["acks"], msg="ack")
    (ack,) = rounds.read_round(root, rid)["acks"].values()
    assert ack["ok"] and ack["stagedSha"] == "cand-sha"
    assert ack["token"] == part.reg.lease.token
    assert part.staged and not part.promoted
    rounds.write_commit(root, rid, "cand-sha")
    _wait_for(lambda: part.promoted == ["cand-sha"], msg="commit applied")
    assert part.unstaged == 0
    counters = obs.registry().snapshot()["counters"]
    assert counters.get('promote.phase.ack{role="participant"}') == 1.0
    assert counters.get('promote.phase.commit{role="participant"}') == 1.0


def test_sha_mismatch_nacks_and_rolls_back(tmp_path, participants):
    root = str(tmp_path)
    part = participants(root, sha="OTHER-sha")
    rid = _prepare(root, [part])
    _wait_for(lambda: rounds.read_round(root, rid)["acks"], msg="nack")
    (ack,) = rounds.read_round(root, rid)["acks"].values()
    assert not ack["ok"] and "changed mid-round" in ack["reason"]
    assert part.unstaged == 1 and not part.promoted


def test_abort_rolls_back_staged_candidate(tmp_path, participants):
    root = str(tmp_path)
    part = participants(root)
    rid = _prepare(root, [part])
    _wait_for(lambda: rounds.read_round(root, rid)["acks"], msg="ack")
    rounds.write_abort(root, rid, "fence broken")
    _wait_for(lambda: part.unstaged == 1, msg="rollback")
    assert not part.promoted


def test_dead_coordinator_self_aborts_after_deadline(tmp_path,
                                                     participants):
    root = str(tmp_path)
    part = participants(root, ttl_ms=600)
    rid = _prepare(root, [part], deadline_s=1.5)
    _wait_for(lambda: part.unstaged == 1, timeout=15,
              msg="deadline self-abort")
    assert not part.promoted
    state = rounds.read_round(root, rid)
    assert state["abort"] is not None
    assert "deadline" in state["abort"]["reason"]


def test_unfenced_participant_ignores_round(tmp_path, participants):
    root = str(tmp_path)
    part = participants(root)
    rid = rounds.new_round_id()
    rounds.write_prepare(root, rid, str(tmp_path / "cand"), "cand-sha",
                         [{"leaseId": "ghost", "token": "t", "epoch": 1}],
                         time.time() + 5.0)
    deadline = time.monotonic() + 1.0
    while time.monotonic() < deadline:
        assert not part.staged
        time.sleep(0.05)
    assert rounds.read_round(root, rid)["acks"] == {}


# ---------------------------------------------------------------------------
# promotion rounds: the coordinator (loop/promote.py fleet mode)
# ---------------------------------------------------------------------------


def _round(root, sha="cand-sha", deadline_ms=None):
    from shifu_tpu_torch.loop.promote import live_peers, run_promotion_round

    props = ({} if deadline_ms is None
             else {"shifu.promote.roundDeadlineMs": str(deadline_ms)})
    with _Props(**props):
        return run_promotion_round(root, os.path.join(root, "cand"), sha,
                                   live_peers(root))


def test_round_commits_only_on_unanimous_fenced_acks(tmp_path,
                                                     participants):
    root = str(tmp_path)
    a, b = participants(root), participants(root)
    out = _round(root, deadline_ms=10_000)
    assert out["committed"], out
    assert set(out["acks"]) == {a.reg.lease.lease_id, b.reg.lease.lease_id}
    _wait_for(lambda: a.promoted == b.promoted == ["cand-sha"],
              msg="both commit")
    state = rounds.read_round(root, out["round"])
    assert state["commit"]["sha"] == "cand-sha" and state["abort"] is None


def test_round_nack_aborts_and_every_peer_rolls_back(tmp_path,
                                                     participants):
    root = str(tmp_path)
    good = participants(root)
    participants(root, stage_error=ValueError("schema changed"))
    out = _round(root, deadline_ms=10_000)
    assert not out["committed"] and "refused" in out["reason"]
    _wait_for(lambda: good.unstaged == 1, msg="rollback of the acked one")
    assert not good.promoted
    assert rounds.read_round(root, out["round"])["commit"] is None


def test_round_broken_fence_aborts(tmp_path, participants):
    """A peer that restarts (a new token) after acking breaks the fence:
    the commit must not land."""
    root = str(tmp_path)
    part = participants(root)
    orig = rounds.write_ack

    def ack_then_restart(*args, **kw):
        path = orig(*args, **kw)
        lpath = part.reg.lease.path
        with open(lpath) as fh:
            doc = json.load(fh)
        doc["token"] = "reborn"
        part.reg.lease.token = "reborn"  # the next beats renew as reborn
        with open(lpath, "w") as fh:
            json.dump(doc, fh)
        return path

    rounds.write_ack = ack_then_restart
    try:
        out = _round(root, deadline_ms=10_000)
    finally:
        rounds.write_ack = orig
    assert not out["committed"]
    assert "incarnation" in out["reason"]
    _wait_for(lambda: part.unstaged == 1, msg="rollback")


def test_round_passed_deadline_aborts(tmp_path, participants):
    """A participant whose stage outlasts the deadline acks too late: the
    round aborts, and the participant rolls its stage back (when a
    loaded machine delays its beat past the deadline it never stages,
    and the round aborts all the same)."""
    root = str(tmp_path)
    slow = participants(root, ttl_ms=600)
    orig = slow.reg.stage_cb
    entered = []

    def slow_stage(candidate_dir):
        entered.append(time.time())
        time.sleep(2.0)
        return orig(candidate_dir)

    slow.reg.stage_cb = slow_stage
    out = _round(root, deadline_ms=1000)
    assert not out["committed"]
    assert "no ack" in out["reason"] or "deadline" in out["reason"]
    assert rounds.read_round(root, out["round"])["commit"] is None
    if entered:
        _wait_for(lambda: slow.unstaged == 1, timeout=15, msg="rollback")
    assert not slow.promoted


# ---------------------------------------------------------------------------
# the records
# ---------------------------------------------------------------------------


def test_round_roundtrip_and_sweep(tmp_path):
    root = str(tmp_path)
    ids = []
    for i in range(10):
        rid = f"{1000 + i:013d}-abc{i:03d}"
        ids.append(rid)
        rounds.write_prepare(root, rid, "/cand", f"sha{i}", [],
                             time.time() + 5)
    assert rounds.latest_prepare(root)["round"] == ids[-1]
    rounds.sweep_rounds(root, keep=2)
    assert rounds.read_round(root, ids[0])["prepare"] is None
    assert rounds.read_round(root, ids[-1])["prepare"] is not None


def test_read_round_collects_acks_and_verdict(tmp_path):
    root = str(tmp_path)
    rid = rounds.new_round_id()
    rounds.write_prepare(root, rid, "/cand", "sha", [], time.time())
    rounds.write_ack(root, rid, "p1", "t1", 1, ok=True, staged_sha="sha")
    rounds.write_ack(root, rid, "p2", "t2", 2, ok=False, reason="no")
    rounds.write_abort(root, rid, "one nack")
    state = rounds.read_round(root, rid)
    assert set(state["acks"]) == {"p1", "p2"}
    assert state["commit"] is None
    assert state["abort"]["reason"] == "one nack"

"""`shifu promote` — gate a candidate rollout on shadow agreement + drift
(counterpart of `shifu_tpu/loop/promote.py`).

The decision is computed from evidence:

  gate "shadow"  the staged candidate's live shadow stats (agreement rate
                 over >= `-Dshifu.loop.promoteMinRows` rows must reach
                 `-Dshifu.loop.promoteAgree`, and shadow scoring must not
                 have errored). Against a RUNNING server the stats come
                 from GET /admin/shadow; offline they come from the last
                 serve manifest's shadow snapshot, so a canary verdict is
                 decidable from the run ledger alone.
  gate "drift"   drift on the active set is the reason TO roll forward:
                 the gate BLOCKS when the ledger carries no retrain
                 recommendation (or only one stamped against another
                 active sha) and the operator did not pass
                 --no-drift-gate/--force.

Every run writes a `promote-<seq>.json` ledger manifest with the gate
evidence and the decision — promoted or held, the audit trail exists.

Execution, by what the root holds:

  http     `--serve-url`: a POST /admin/promote (zero-downtime hot-swap
           in the running server; `--set` picks a zoo tenant). Refused
           (exit 2) when more than one serve process holds a lease on
           the root: promoting one of them is a half-promoted fleet.
  fleet    live leases and no `--serve-url`: a lease-fenced two-phase
           commit over every live `shifu serve` process
           (`run_promotion_round`, the records of `loop/rounds.py`):
           each stages the candidate and acks, the commit lands only on
           unanimous acks with the fence intact, then the dir swap.
  offline  no live lease: an atomic dir swap, `models/` ->
           `models.previous/`, candidate -> `models/` (a rename sequence
           that always leaves a loadable models dir).
"""

from __future__ import annotations

import json
import os
import time
import urllib.request
from typing import Optional

from shifu_tpu_torch.loop import (
    promote_agree_setting,
    promote_min_rows_setting,
)
from shifu_tpu_torch.utils.log import get_logger

log = get_logger(__name__)

# where a candidate model set waits for `shifu promote` (`shifu retrain`
# writes it, processor/retrain.py)
DEFAULT_CANDIDATE_DIR = "models.candidate"


def _http_json(url: str, payload: Optional[dict] = None,
               timeout: float = 30.0) -> dict:
    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(
        url, data=data,
        headers={"Content-Type": "application/json"} if data else {},
        method="POST" if data is not None else "GET")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read().decode())


def latest_recommendation(root: str) -> Optional[dict]:
    """Newest retrain recommendation manifest, if the drift monitor ever
    stamped one."""
    from shifu_tpu_torch.obs.ledger import list_runs

    runs = list_runs(root, last=1, step="recommend")
    return runs[0] if runs else None


def latest_serve_shadow(root: str) -> Optional[dict]:
    """Shadow snapshot from the newest serve manifest (the offline
    evidence path)."""
    from shifu_tpu_torch.obs.ledger import list_runs

    for m in list_runs(root, step="serve"):
        shadow = (m.get("serve") or {}).get("shadow")
        if shadow:
            return shadow
    return None


def retrain_lineage(root: str, candidate_sha: Optional[str]) -> Optional[dict]:
    """Serve -> train -> promote lineage for the promote manifest: the
    retrain manifest that produced this candidate (matched by candidate
    model-set sha; newest retrain when the sha is unknown) plus the
    traffic-log trace evidence it recorded — so a promoted rollout
    points back at the exact request traces it was trained on."""
    from shifu_tpu_torch.obs.ledger import list_runs

    for m in list_runs(root, step="retrain"):
        rt = m.get("retrain") or {}
        cand = (rt.get("candidate") or {}).get("modelSetSha")
        if candidate_sha is not None and cand != candidate_sha:
            continue
        return {
            "retrainManifest": os.path.basename(m.get("path", "")),
            "parentModelSetSha": (rt.get("parent") or {}).get(
                "modelSetSha"),
            "candidateModelSetSha": cand,
            "source": (rt.get("source") or {}).get("kind"),
            "traffic": rt.get("lineage"),
        }
    return None


def evaluate_gates(shadow: Optional[dict], recommendation: Optional[dict],
                   agree_min: Optional[float] = None,
                   min_rows: Optional[int] = None,
                   require_drift: bool = True,
                   candidate_sha: Optional[str] = None,
                   active_sha: Optional[str] = None) -> dict:
    """Pure gate evaluation — the piece tests pin. Returns
    {promote: bool, gates: {...}} with one entry per gate and a reason
    for every failure.

    `candidate_sha` binds the shadow evidence to the candidate actually
    being promoted — agreement earned by a previously staged set must
    not green-light a different one. `active_sha` binds the drift gate
    to the CURRENT active set: a recommendation stamped against an
    older sha is stale (that drift was already acted on, or the set was
    replaced some other way) and blocks rather than passes. Either
    check is skipped when its sha is unknown (None)."""
    agree_min = (promote_agree_setting() if agree_min is None
                 else float(agree_min))
    min_rows = (promote_min_rows_setting() if min_rows is None
                else int(min_rows))
    gates = {}

    if shadow is None:
        gates["shadow"] = {"ok": False,
                           "reason": "no shadow stats (stage the "
                                     "candidate and let it see traffic)"}
    elif (candidate_sha and shadow.get("sha")
          and shadow["sha"] != candidate_sha):
        gates["shadow"] = {"ok": False,
                           "reason": f"shadow evidence describes "
                                     f"{shadow['sha']}, not the candidate "
                                     f"{candidate_sha} — stage THIS "
                                     "candidate and let it see traffic",
                           "stats": shadow}
    elif shadow.get("errors"):
        gates["shadow"] = {"ok": False,
                           "reason": f"shadow scoring errored "
                                     f"{shadow['errors']} time(s)",
                           "stats": shadow}
    elif shadow.get("rows", 0) < min_rows:
        gates["shadow"] = {"ok": False,
                           "reason": f"only {shadow.get('rows', 0)} shadow "
                                     f"rows (< {min_rows})",
                           "stats": shadow}
    elif shadow.get("agreement", 0.0) < agree_min:
        gates["shadow"] = {"ok": False,
                           "reason": f"agreement "
                                     f"{shadow.get('agreement', 0.0):.4f} "
                                     f"< {agree_min:g}",
                           "stats": shadow}
    else:
        gates["shadow"] = {"ok": True, "stats": shadow}

    if not require_drift:
        gates["drift"] = {"ok": True, "reason": "gate disabled"}
    elif recommendation is None:
        gates["drift"] = {"ok": False,
                          "reason": "no retrain recommendation in the "
                                    "ledger — nothing says the active set "
                                    "needs replacing (--no-drift-gate to "
                                    "override)"}
    else:
        rec = recommendation.get("recommendation", {})
        rec_summary = {
            "driftedColumns": (rec.get("drift") or {}).get(
                "driftedColumns"),
            "maxPsi": (rec.get("drift") or {}).get("maxPsi"),
            "modelSetSha": rec.get("modelSetSha"),
        }
        if (active_sha and rec.get("modelSetSha")
                and rec["modelSetSha"] != active_sha):
            gates["drift"] = {
                "ok": False,
                "reason": f"newest retrain recommendation targets sha "
                          f"{rec['modelSetSha']} but the active set is "
                          f"{active_sha} — that drift was already acted "
                          "on; nothing says the CURRENT set needs "
                          "replacing (--no-drift-gate to override)",
                "recommendation": rec_summary,
            }
        else:
            gates["drift"] = {"ok": True, "recommendation": rec_summary}
    return {"promote": all(g["ok"] for g in gates.values()),
            "gates": gates,
            "agreeMin": agree_min, "minRows": min_rows}


def _models_sha(models_dir: Optional[str]) -> Optional[str]:
    """Content sha of a model dir — the exact identity the registry
    serves under — or None when there is no readable model set there."""
    from shifu_tpu_torch.serve.registry import find_model_paths, model_set_sha

    if not models_dir or not os.path.isdir(models_dir):
        return None
    try:
        paths = find_model_paths(models_dir)
        return model_set_sha(paths) if paths else None
    except OSError:
        return None


def live_peers(root: str) -> list:
    """Live (un-expired) process leases under the root — the set a
    fleet-atomic promotion must fence."""
    from shifu_tpu_torch.resilience import lease

    return [p for p in lease.scan(root) if not p["expired"]]


def round_deadline_ms_setting() -> float:
    """shifu.promote.roundDeadlineMs — promotion-round ack deadline
    (0 = one lease TTL). Raise it for candidates whose fleet-wide
    stage + warm outlasts a TTL: fence SAFETY does not depend on the
    deadline (the fence is re-checked against the live lease files
    immediately before commit, and participants renew right after their
    device-heavy stage) — the TTL default is just the tightest deadline
    that cannot outlive its own liveness evidence."""
    from shifu_tpu_torch.utils import environment

    return environment.get_float("shifu.promote.roundDeadlineMs", 0.0)


def run_promotion_round(root: str, candidate_dir: str,
                        candidate_sha: str, peers: list) -> dict:
    """The two-phase commit coordinator (loop/rounds.py records).

    Prepare fences the CURRENT live incarnations (leaseId/token/epoch);
    every fenced peer must stage + validate the sha-bound candidate and
    ack before the deadline (one lease TTL out, or
    -Dshifu.promote.roundDeadlineMs). The commit record is written only
    after (a) unanimous ok-acks, (b) a fence re-check against the live
    lease files, (c) no abort record exists (a participant that
    self-aborted at deadline+grace writes one — its rollback must win),
    and (d) the deadline has not passed. Everything else aborts.

    The whole round runs under ONE trace id (`round-<rid>`), stamped
    into the prepare record: this coordinator's prepare/acks/fence/
    commit spans and every participant's stage/ack/commit spans share
    it, so `shifu trace --fleet` renders the round as one stitched
    cross-process timeline."""
    from shifu_tpu_torch.loop import rounds
    from shifu_tpu_torch.obs import reqtrace
    from shifu_tpu_torch.resilience import lease

    fence = [{"leaseId": p["leaseId"], "token": p["token"],
              "epoch": p["epoch"]} for p in peers]
    ttl_s = max(float(p.get("ttlMs", 5000.0)) for p in peers) / 1000.0
    deadline_s = round_deadline_ms_setting() / 1000.0 or ttl_s
    rid = rounds.new_round_id()
    deadline = time.time() + deadline_s
    rt = reqtrace.RequestTrace(trace_id=f"round-{rid}", sampled=True)
    rt.annotate(role="coordinator", round=rid, sha=candidate_sha,
                peers=len(fence))
    with rt.stage("prepare"):
        rounds.write_prepare(root, rid, candidate_dir, candidate_sha,
                             fence, deadline, trace=rt.trace_id)
    log.info("promotion round %s: prepared for %d peer(s), deadline in "
             "%.1f s", rid, len(fence), deadline_s)
    want = {f["leaseId"] for f in fence}
    out = {"round": rid, "peers": fence, "acks": {}, "committed": False,
           "deadlineUnix": deadline, "trace": rt.trace_id}

    def _finish(outcome: str) -> None:
        rt.annotate(outcome=outcome)
        reqtrace.buffer().offer(rt)

    def _abort(reason: str) -> dict:
        with rt.stage("abort"):
            rounds.write_abort(root, rid, reason)
        out["reason"] = reason
        _finish("abort")
        log.warning("promotion round %s aborted: %s", rid, reason)
        return out

    t_acks = time.perf_counter()
    while True:
        state = rounds.read_round(root, rid)
        out["acks"] = state["acks"]
        nacks = [a for a in state["acks"].values() if not a.get("ok")]
        if nacks:
            return _abort("peer " + nacks[0]["leaseId"] + " refused: "
                          + str(nacks[0].get("reason")))
        bad_sha = [a for a in state["acks"].values()
                   if a.get("stagedSha") != candidate_sha]
        if bad_sha:
            return _abort(f"peer {bad_sha[0]['leaseId']} staged "
                          f"{bad_sha[0].get('stagedSha')}, not the "
                          f"candidate {candidate_sha}")
        if want <= set(state["acks"]):
            break
        if time.time() >= deadline:
            missing = sorted(want - set(state["acks"]))
            return _abort("no ack from " + ", ".join(missing)
                          + " within the lease TTL")
        time.sleep(rounds.ROUND_POLL_S)
    rt.add_stage("acks", time.perf_counter() - t_acks, t_acks)
    # unanimous — but only the SAME incarnations that acked may commit:
    # a peer that died (lease expired/vanished) or restarted (token or
    # epoch changed) after acking cannot apply the commit, and a fleet
    # minus one is a half-promoted fleet
    with rt.stage("fence"):
        broken = lease.fence_check(root, fence)
    if broken:
        return _abort("; ".join(broken))
    if rounds.read_round(root, rid)["abort"] is not None:
        # a participant self-aborted (it judged the coordinator dead at
        # deadline+grace) — its rollback already happened and MUST win;
        # committing over it would split the fleet
        out["reason"] = "a participant aborted the round first"
        _finish("stale")
        log.warning("promotion round %s: not committing — %s",
                    rid, out["reason"])
        return out
    if time.time() >= deadline:
        # participants may already be rolling back — committing now
        # could split the fleet
        return _abort("unanimous acks arrived after the deadline")
    with rt.stage("commit"):
        rounds.write_commit(root, rid, candidate_sha)
    out["committed"] = True
    _finish("commit")
    log.info("promotion round %s: committed %s on %d peer(s)",
             rid, candidate_sha, len(fence))
    return out


def offline_swap(root: str, candidate_dir: str) -> dict:
    """Atomic-enough dir swap for a non-running model set: the current
    `models/` moves aside to `models.previous/`, the candidate renames
    into place. Both moves are single `os.replace`/`os.rename` calls, so
    a kill leaves either the old or the new layout with a loadable
    models dir recoverable by hand — never merged halves."""
    import shutil

    models = os.path.join(os.path.abspath(root), "models")
    previous = models + ".previous"
    candidate_dir = os.path.abspath(candidate_dir)
    if not os.path.isdir(candidate_dir):
        raise FileNotFoundError(f"candidate dir {candidate_dir} not found")
    if os.path.isdir(previous):
        shutil.rmtree(previous)
    if os.path.isdir(models):
        os.rename(models, previous)
    os.rename(candidate_dir, models)
    return {"models": models, "previous": previous}


def run_promote(root: str, candidate_dir: Optional[str],
                serve_url: Optional[str] = None,
                agree_min: Optional[float] = None,
                min_rows: Optional[int] = None,
                require_drift: bool = True,
                force: bool = False,
                stage_first: bool = False,
                set_name: Optional[str] = None) -> int:
    """The `shifu promote` entry point. Returns the process exit code:
    0 promoted, 1 held by a gate, 2 operational error."""
    import sys
    import time

    from shifu_tpu_torch import obs
    from shifu_tpu_torch.obs.ledger import RunLedger

    t0 = time.time()
    shadow = None
    active_sha = None
    if set_name and not serve_url:
        # a zoo tenant only exists inside a serve process: the offline
        # and fleet-round paths swap the root's models/ dir, which has
        # no per-set meaning
        log.error("promote: --set %s needs --serve-url (model-zoo "
                  "tenants live in a serving process)", set_name)
        return 2
    peers = live_peers(root)
    if serve_url and len(peers) > 1:
        # promoting ONE process of a multi-process fleet through its
        # /admin plane is exactly the half-promotion the lease-fenced
        # round exists to prevent
        log.error("promote: %d live serve processes hold leases under "
                  "%s — drop --serve-url and run the fleet-atomic "
                  "promote instead", len(peers), root)
        return 2
    mode = ("http" if serve_url
            else "fleet" if peers else "offline")
    try:
        if serve_url:
            serve_url = serve_url.rstrip("/")
            if stage_first and candidate_dir:
                stage_doc = {"modelsDir": os.path.abspath(candidate_dir)}
                if set_name:
                    stage_doc["set"] = set_name
                _http_json(f"{serve_url}/admin/stage", stage_doc)
            shadow_url = f"{serve_url}/admin/shadow"
            if set_name:
                shadow_url += f"?set={set_name}"
            resp = _http_json(shadow_url)
            shadow = resp.get("shadow")
            active_sha = resp.get("active")
        else:
            shadow = latest_serve_shadow(root)
            active_sha = _models_sha(os.path.join(os.path.abspath(root),
                                                  "models"))
    except (OSError, ValueError) as e:  # unreachable server / bad JSON
        log.error("promote: cannot reach shadow stats: %s", e)
        return 2
    recommendation = latest_recommendation(root)
    # resolved BEFORE any swap: offline_swap renames the candidate dir
    # into models/, after which the sha (and therefore the lineage
    # match below) would be unrecoverable
    candidate_sha = _models_sha(candidate_dir)
    decision = evaluate_gates(shadow, recommendation,
                              agree_min=agree_min, min_rows=min_rows,
                              require_drift=require_drift,
                              candidate_sha=candidate_sha,
                              active_sha=active_sha)
    swap = None
    error = None
    round_info = None
    if mode == "fleet":
        # the two-phase round IS the shadow-validation gate here: every
        # live leaseholder must stage the sha-bound candidate on its
        # whole replica fleet and ack. Ledger shadow evidence (if an
        # operator staged earlier) stays in the manifest as context.
        # `--force` can override the DRIFT gate, never a failed round —
        # unanimity is a safety property, not an operator preference.
        drift_ok = decision["gates"]["drift"]["ok"]
        if force and not drift_ok:
            decision["forced"] = True
        decision["promote"] = False
        if drift_ok or force:
            try:
                if not candidate_dir or candidate_sha is None:
                    raise ValueError(
                        "fleet promote needs a readable candidate dir "
                        "(default models.candidate is missing)")
                round_info = run_promotion_round(
                    root, os.path.abspath(candidate_dir),
                    candidate_sha, peers)
            except (OSError, ValueError) as e:
                error = f"{type(e).__name__}: {e}"
                round_info = None
            committed = bool(round_info and round_info["committed"])
            decision["gates"]["shadow"] = {
                "ok": committed,
                "reason": (None if committed else
                           (round_info or {}).get("reason", error)),
                "fleetValidated": committed,
                "acks": len((round_info or {}).get("acks", {})),
                "round": (round_info or {}).get("round"),
            }
            decision["promote"] = committed
            if committed:
                try:
                    # the commit record is the atomic decision; the dir
                    # swap makes it durable for future process starts
                    swap = offline_swap(root, candidate_dir)
                    swap.update({"mode": "fleet",
                                 "round": round_info["round"],
                                 "peers": len(round_info["peers"])})
                except (OSError, ValueError) as e:
                    # the fleet IS promoted (every live process swapped);
                    # only the on-disk layout lags — surfaced loudly for
                    # the operator, re-running promote converges it
                    error = (f"committed but dir swap failed: "
                             f"{type(e).__name__}: {e}")
    else:
        if force and not decision["promote"]:
            decision["forced"] = True
            decision["promote"] = True
        if decision["promote"]:
            try:
                if serve_url:
                    # bind the swap to the sha the gates evaluated: a
                    # re-staged shadow between the gate read and this POST
                    # is refused server-side (409), never rolled out blind
                    promote_doc = {"sha": (shadow or {}).get("sha")}
                    if set_name:
                        promote_doc["set"] = set_name
                    swap = _http_json(f"{serve_url}/admin/promote",
                                      promote_doc)
                else:
                    if not candidate_dir:
                        raise ValueError(
                            "offline promote needs a candidate dir "
                            "(default models.candidate is missing)")
                    swap = offline_swap(root, candidate_dir)
            except (OSError, ValueError) as e:  # failed swap: held + ledgered
                error = f"{type(e).__name__}: {e}"
                decision["promote"] = False
    # the audit trail: every promote attempt is a ledger manifest,
    # carrying the serve->train lineage of the candidate it gated
    try:
        lineage = retrain_lineage(root, candidate_sha)
    except (OSError, ValueError) as e:
        log.warning("promote: cannot resolve retrain lineage: %s", e)
        lineage = None
    try:
        ledger = RunLedger(root)
        seq = ledger.next_seq("promote")
        path = ledger.write(
            "promote", seq,
            status="ok" if error is None else "failed",
            exit_status=0 if decision["promote"] else 1,
            started_at=t0, elapsed_seconds=time.time() - t0,
            argv=list(sys.argv), registry=obs.registry(),
            error=error,
            extra={"promote": {"mode": mode,
                               "set": set_name,
                               "candidateDir": candidate_dir,
                               "decision": decision,
                               "lineage": lineage,
                               "round": round_info,
                               "swap": swap}},
        )
        log.info("promote manifest -> %s", path)
        if mode == "fleet" and round_info is not None:
            # the coordinator's round spans, beside the manifest — the
            # half `shifu trace --fleet` stitches with the participants'
            from shifu_tpu_torch.obs import reqtrace

            traces_path = os.path.join(ledger.dir,
                                       f"promote-{seq}.traces.json")
            if reqtrace.buffer().write_traces(traces_path):
                log.info("round trace -> %s", traces_path)
    except OSError as e:
        log.warning("cannot write promote manifest: %s", e)
    if error:
        log.error("promote failed: %s", error)
        return 2
    if not decision["promote"]:
        for name, g in decision["gates"].items():
            if not g["ok"]:
                log.error("promote held by %s gate: %s", name, g["reason"])
        return 1
    log.info("promoted: %s", swap)
    return 0

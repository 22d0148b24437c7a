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

Execution: with `--serve-url` the promotion is a POST /admin/promote
(zero-downtime hot-swap in the running server); without one it is an
offline atomic dir swap: `models/` -> `models.previous/`, candidate ->
`models/` (os.replace-based, torn-state-proof via a rename sequence that
always leaves a loadable models dir).

The JAX package's fleet mode (a lease-fenced two-phase commit over every
live `shifu serve` process, `loop/rounds.py`) needs leases, ROADMAP
A.14.7. A port `shifu serve` takes no lease; where lease files exist
anyway (JAX serve processes share the model set), `run_promote` exits 2
naming A.14.7 rather than promote one process of a fleet.
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

# where a candidate model set waits for `shifu promote` (the JAX
# `shifu retrain` writes it; ROADMAP A.14.6)
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


PEERS_DIRNAME = os.path.join(".shifu", "runs", "peers")


def peers_dir(root: str) -> str:
    return os.path.join(os.path.abspath(root), PEERS_DIRNAME)


def lease_files(root: str) -> list:
    """Lease files some process left under the root's peers directory
    (JAX `shifu serve` processes take them)."""
    from shifu_tpu_torch.fs.listing import sorted_glob

    return sorted_glob(os.path.join(peers_dir(root), "*.lease.json"))


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

    from shifu_tpu_torch import obs
    from shifu_tpu_torch.obs.ledger import RunLedger

    t0 = time.time()
    shadow = None
    active_sha = None
    if set_name and not serve_url:
        # a zoo tenant only exists inside a serve process: the offline
        # path swaps the root's models/ dir, which has no per-set meaning
        log.error("promote: --set %s needs --serve-url (model-zoo "
                  "tenants live in a serving process)", set_name)
        return 2
    leases = lease_files(root)
    if leases:
        # serve processes hold leases on this model set: promoting one
        # of them, or swapping models/ under them, is the half-promotion
        # the fleet round exists to prevent, and the round needs leases
        log.error("promote: %d serve process lease(s) under %s — the "
                  "fleet-atomic promote is not ported yet: ROADMAP "
                  "A.14.7", len(leases), peers_dir(root))
        return 2
    mode = "http" if serve_url else "offline"
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
                               "round": None,
                               "swap": swap}},
        )
        log.info("promote manifest -> %s", path)
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

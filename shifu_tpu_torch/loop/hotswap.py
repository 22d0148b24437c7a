"""Zero-downtime registry hot-swap with shadow scoring (counterpart of
`shifu_tpu/loop/hotswap.py`).

`SwappableRegistry` fronts the micro-batcher's `score_fn` with an
indirection the swap can flip atomically:

  * **Active** — the ModelRegistry answering live traffic. Every scored
    batch counts into per-version metrics
    (`serve.version.batches{sha=}` / `serve.version.records{sha=}`), so
    the run ledger shows exactly which model-set sha answered how many
    requests across a rollout — the per-version accounting a canary
    verdict needs.
  * **Shadow** — a staged candidate (`stage(models_dir)`) that is fully
    loaded and warmed BEFORE it ever sees traffic. While staged, a
    sampled fraction of live batches (`-Dshifu.loop.shadowSample`) is
    re-scored on the shadow OFF the request path (the batcher's
    post-resolution observer — clients never wait on it), accumulating a
    score-delta histogram (`serve.shadow.score_delta`, 0..1000 scale)
    and an agreement rate: |mean-score delta| <=
    `-Dshifu.loop.shadowTolerance` counts as agreeing. Shadow failures
    count (`serve.shadow.errors`) and never touch live traffic.
  * **Promote** — one reference assignment under the swap lock: the next
    gathered batch scores on the new version while the in-flight batch
    finishes on the old. No queue flush, no listener restart, no request
    is dropped or double-answered — the answered-per-version counters
    add up to every admitted request across the swap.

Staging warms the candidate's row buckets (`warm`) the active set has
served, so promotion costs no first-batch allocation. The model zoo's
seams: `stage(put_hook=)` streams the candidate's weight groups through
the zoo's ledger, the candidate inherits the active's `cost_hook`,
`memory_analysis()` prices active plus shadow, and `release()` drops
both (eviction). A replaced, unstaged or promoted-away version frees
when its last in-flight batch drops it.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from shifu_tpu_torch.analysis.racetrack import tracked_lock
from shifu_tpu_torch.loop import (
    shadow_sample_setting,
    shadow_tolerance_setting,
)
from shifu_tpu_torch.serve.registry import ModelRegistry
from shifu_tpu_torch.utils.log import get_logger

log = get_logger(__name__)

# pinned like serve.latency_seconds: exponential 0.25 * 2^k score-scale
# edges resolve sub-point deltas without drowning multi-hundred ones
SCORE_DELTA_BUCKETS = tuple(0.25 * 2 ** k for k in range(14)) + (
    float("inf"),)


class ShadowStats:
    """Agreement accounting for one staged candidate. `labels`
    (replica=, and tenant= in a zoo) ride the delta histogram and the
    error counter so per-tenant shadow evidence stays separable."""

    def __init__(self, tolerance: Optional[float] = None,
                 labels: Optional[dict] = None) -> None:
        self.tolerance = (shadow_tolerance_setting() if tolerance is None
                          else float(tolerance))
        self.labels = dict(labels or {})
        self._lock = tracked_lock("loop.hotswap.shadow_stats")
        self.batches = 0
        self.rows = 0
        self.agree_rows = 0
        self.errors = 0
        self.sum_abs_delta = 0.0
        self.max_abs_delta = 0.0

    def note(self, delta: np.ndarray) -> None:
        from shifu_tpu_torch.obs import registry

        d = np.abs(np.asarray(delta, dtype=np.float64))
        # a NaN delta (candidate emitted NaN scores) is maximal
        # disagreement, not a crash: +inf lands in the overflow bucket,
        # fails the tolerance test, and keeps the observer pass alive
        # (searchsorted would otherwise index past the last bucket)
        d = np.where(np.isfinite(d), d, np.inf)
        hist = registry().histogram("serve.shadow.score_delta",
                                    buckets=SCORE_DELTA_BUCKETS,
                                    **self.labels)
        if d.size:
            # one vectorized binning + one locked merge — this runs per
            # sampled batch on the single batch-resolution thread, where
            # a per-row observe() loop would eat queue headroom
            binned = np.bincount(
                np.searchsorted(np.asarray(hist.buckets), d, side="left"),
                minlength=len(hist.buckets))
            hist.add_binned(binned.tolist(), float(d.sum()), int(d.size),
                            float(d.min()), float(d.max()))
        with self._lock:
            self.batches += 1
            self.rows += d.size
            self.agree_rows += int((d <= self.tolerance).sum())
            self.sum_abs_delta += float(d.sum())
            self.max_abs_delta = max(self.max_abs_delta, float(d.max()))

    def note_error(self) -> None:
        from shifu_tpu_torch.obs import registry

        registry().counter("serve.shadow.errors", **self.labels).inc()
        with self._lock:
            self.errors += 1

    def snapshot(self) -> dict:
        with self._lock:
            rows = max(self.rows, 1)
            return {
                "batches": self.batches,
                "rows": self.rows,
                # raw count alongside the rate: the fleet's cross-replica
                # psum aggregation needs an additive quantity (rates
                # don't sum; agree-row counts do)
                "agreeRows": self.agree_rows,
                "errors": self.errors,
                "tolerance": self.tolerance,
                "agreement": (self.agree_rows / rows if self.rows else 0.0),
                "meanAbsDelta": (self.sum_abs_delta / rows
                                 if self.rows else 0.0),
                "maxAbsDelta": self.max_abs_delta,
            }


class SwappableRegistry:
    """Atomic active/shadow pair behind one `score_raw` entry point.

    In a fleet (serve/fleet.py) each replica owns one SwappableRegistry,
    so a rolling promote flips replicas one at a time; `labels`
    (typically {"replica": "<i>"}) ride the per-version serve.version.*
    counters so every answered request stays attributable to (replica,
    sha) across the roll."""

    def __init__(self, registry: ModelRegistry,
                 labels: Optional[dict] = None) -> None:
        self._lock = tracked_lock("loop.hotswap.swap")
        self.labels = dict(labels or {})
        self._active = registry
        self._shadow: Optional[ModelRegistry] = None
        self._shadow_stats: Optional[ShadowStats] = None
        self._shadow_sample = shadow_sample_setting()
        self._shadow_tick = 0
        self._last_scored_sha: Optional[str] = None
        self.swaps = 0

    # ---- live path (batcher score_fn) ----
    def score_raw(self, data):
        from shifu_tpu_torch.obs import registry as obs_registry
        from shifu_tpu_torch.obs import reqtrace

        active = self._active  # one atomic read: the swap point
        result = active.score_raw(data)
        # remembered for the post-resolution observer (same worker
        # thread): a promote landing between this score and the observe
        # must not re-attribute the batch to the NEW version
        self._last_scored_sha = active.sha
        # request traces carry the sha read at the SAME swap point, so
        # a trace stays attributed to the version that actually scored
        # it across a mid-roll promote (the traffic log's scored_sha
        # discipline, per request)
        reqtrace.note_attr(scoredSha=active.sha)
        reg = obs_registry()
        reg.counter("serve.version.batches", sha=active.sha,
                    **self.labels).inc()
        reg.counter("serve.version.records", sha=active.sha,
                    **self.labels).inc(data.n_rows)
        return result

    # ---- registry façade (what the server/front end reads) ----
    @property
    def active(self) -> ModelRegistry:
        return self._active

    @property
    def sha(self) -> str:
        return self._active.sha

    @property
    def device(self):
        return self._active.device

    @property
    def scored_sha(self) -> str:
        """Sha of the version that scored the most recently resolved
        batch — what the traffic log must stamp. Falls back to the
        active sha before any batch has scored."""
        return self._last_scored_sha or self._active.sha

    @property
    def model_names(self) -> List[str]:
        return self._active.model_names

    @property
    def active_models_dir(self) -> str:
        """Dir of the version serving now: what an evicting zoo must
        remember so re-admission rebuilds the promoted version."""
        return self._active.models_dir

    @property
    def fused(self) -> bool:
        return self._active.fused

    def memory_analysis(self) -> dict:
        """Active plus staged-shadow residency (registry
        memory_analysis), the zoo ledger's per-replica read."""
        with self._lock:  # paired read, like observe()
            active, shadow = self._active, self._shadow
        out = {"active": active.memory_analysis()}
        total = out["active"]["residentBytes"]
        if shadow is not None:
            out["shadow"] = shadow.memory_analysis()
            total += out["shadow"]["residentBytes"]
        out["residentBytes"] = total
        return out

    def release(self) -> int:
        """Eviction: release the active and any staged shadow (their
        tensors dropped, later scores refused). The owning fleet is
        already drained when the zoo calls this."""
        with self._lock:
            active, shadow = self._active, self._shadow
            self._shadow = None
            self._shadow_stats = None
        n = active.release()
        if shadow is not None:
            n += shadow.release()
        return n

    @property
    def input_columns(self) -> List[str]:
        return self._active.input_columns

    def warm(self, batch_sizes):
        return self._active.warm(batch_sizes)

    def score_records(self, records):
        from shifu_tpu_torch.serve.registry import records_to_columnar

        return self.score_raw(
            records_to_columnar(records, self.input_columns))

    # ---- shadow lifecycle ----
    def stage(self, models_dir: str, column_configs=None,
              model_config=None, drift=None, put_hook=None) -> dict:
        """Load + warm a candidate as the shadow on the active set's
        device; replaces any previously staged candidate. Returns the
        shadow summary. `put_hook(nbytes)` (serve/zoo.py) streams the
        stage: each weight group is ledger-acquired before it goes to
        the device, so a stage on a near-full budget evicts cold tenants
        group by group instead of overshooting."""
        from shifu_tpu_torch.obs import registry as obs_registry

        active = self._active
        cand = ModelRegistry(models_dir, column_configs=column_configs,
                             model_config=model_config, drift=drift,
                             device=active.device,
                             labels=getattr(active, "labels", None),
                             put_hook=put_hook)
        # the candidate inherits the active's re-pricing seam: a bucket
        # first run by shadow traffic is priced like a live one
        cand.cost_hook = getattr(active, "cost_hook", None)
        # staged: shadow scoring must not double-count drift rows the
        # active fold already saw; promotion flips the fold live
        cand.drift_live = False
        if list(cand.input_columns) != list(active.input_columns):
            raise ValueError(
                "candidate input columns differ from the active set "
                f"({len(cand.input_columns)} vs "
                f"{len(active.input_columns)}) — a hot-swap must "
                "not change the request schema")
        # warm the buckets live traffic already exercised so the first
        # post-promote batch allocates nothing
        warmed = sorted(getattr(active, "_warm_buckets", set()))
        if cand.fused and warmed:
            cand.warm(warmed)
        with self._lock:
            self._shadow = cand
            self._shadow_stats = ShadowStats(labels=self.labels)
            self._shadow_tick = 0
        obs_registry().counter("serve.swap.staged", sha=cand.sha,
                               **self.labels).inc()
        log.info("staged shadow model set %s from %s (warmed buckets %s)",
                 cand.sha, models_dir, warmed)
        return self.shadow_snapshot()

    def unstage(self) -> None:
        """Drop the staged candidate (rollback to active-only). Counted
        per sha — an aborted fleet-promotion round's rollback must be as
        visible in the ledger as the stage that preceded it."""
        with self._lock:
            shadow, self._shadow = self._shadow, None
            self._shadow_stats = None
        if shadow is not None:
            from shifu_tpu_torch.obs import registry as obs_registry

            obs_registry().counter("serve.swap.unstaged",
                                   sha=shadow.sha, **self.labels).inc()
            log.info("unstaged shadow model set %s (rolled back to "
                     "active %s)", shadow.sha, self._active.sha)

    def observe(self, data, result) -> None:
        """Post-resolution hook (batcher observer): sample live batches
        onto the shadow and accumulate score deltas. Never raises.

        The (shadow, stats) pair is read under the lock as a UNIT: a
        stage()/promote() landing between two bare reads could pair the
        old candidate with the new candidate's stats and attribute
        agreement evidence to the wrong sha (regression-pinned in
        the JAX package's tests/test_racetrack.py). Scoring itself
        happens after release — device work under the swap lock would
        block a concurrent promote for a whole shadow dispatch."""
        with self._lock:
            shadow, stats = self._shadow, self._shadow_stats
            if shadow is None or stats is None:
                return
            if self._shadow_sample <= 0.0:
                return  # off, like TrafficLog's sample<=0
            self._shadow_tick += 1
            if self._shadow_sample < 1.0:
                # deterministic stride sampling: every k-th batch
                stride = max(1, int(round(1.0 / max(self._shadow_sample,
                                                    1e-6))))
                if self._shadow_tick % stride:
                    return
        try:
            shadow_res = shadow.score_raw(data)
        except Exception as e:  # candidate bugs must not hurt live traffic
            log.warning("shadow scoring failed on %s: %s", shadow.sha, e)
            stats.note_error()
            return
        from shifu_tpu_torch.obs import registry as obs_registry

        reg = obs_registry()
        reg.counter("serve.shadow.batches", **self.labels).inc()
        reg.counter("serve.shadow.records", **self.labels).inc(data.n_rows)
        stats.note(np.asarray(shadow_res.mean)
                   - np.asarray(result.mean))

    def shadow_snapshot(self) -> Optional[dict]:
        with self._lock:  # paired read, like observe()
            shadow, stats = self._shadow, self._shadow_stats
        if shadow is None or stats is None:
            return None
        return {"sha": shadow.sha,
                "models": list(shadow.model_names),
                "fused": shadow.fused,
                **stats.snapshot()}

    def promote(self, expected_sha: Optional[str] = None) -> dict:
        """Atomically swap shadow -> active. The in-flight batch finishes
        on the old version; the next gathered batch scores on the new.
        `expected_sha` binds the swap to the candidate the caller's gate
        evidence described — if a different set was staged in between,
        the promote is refused rather than rolling out sight-unseen."""
        from shifu_tpu_torch.obs import registry as obs_registry

        with self._lock:
            if self._shadow is None:
                raise ValueError("no staged candidate to promote")
            if expected_sha and self._shadow.sha != expected_sha:
                raise ValueError(
                    f"staged shadow is {self._shadow.sha}, not the gated "
                    f"candidate {expected_sha} — it was re-staged since "
                    "the gates evaluated; re-run the gate on the current "
                    "shadow")
            old, new = self._active, self._shadow
            stats = (self._shadow_stats.snapshot()
                     if self._shadow_stats else None)
            self._active = new
            self._shadow = None
            self._shadow_stats = None
            self.swaps += 1
            new.drift_live = True
            old.drift_live = False
        obs_registry().counter("serve.swap.promotions",
                               from_sha=old.sha, to_sha=new.sha,
                               **self.labels).inc()
        log.info("promoted model set %s -> %s (swap #%d)", old.sha,
                 new.sha, self.swaps)
        return {"from": old.sha, "to": new.sha, "swaps": self.swaps,
                "shadow": stats}

    def snapshot(self) -> dict:
        snap = self._active.snapshot()
        snap["swaps"] = self.swaps
        shadow = self.shadow_snapshot()
        if shadow is not None:
            snap["shadow"] = shadow
        return snap

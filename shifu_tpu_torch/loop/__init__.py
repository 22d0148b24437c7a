"""Closed-loop continuous training: serve feeds train feeds serve
(counterpart of `shifu_tpu/loop/__init__.py`).

The reference Shifu is a one-shot pipeline (`new -> ... -> eval ->
export`); production traffic is a stream. This package closes the loop
over the existing subsystems instead of duplicating them:

  traffic.py   append-only serve-side traffic log — rotating chunk files
               under the `.shifu/runs` ledger layout, written atomically
               (resilience.checkpoint.atomic_write) and readable back
               through `data/stream.chunk_source`, so logged traffic is
               just another chunk stream every lifecycle step consumes.
  drift.py     online PSI drift — each served micro-batch is bin-coded
               against the training ColumnConfig bins inside the
               registry's one scoring program and folded into a
               per-column device window, exported via /metrics and the
               serve shutdown manifest; past the degrade threshold
               /healthz flips to `degraded` and a retrain recommendation
               manifest lands in the run ledger.
  hotswap.py   zero-downtime registry hot-swap — an atomic
               swap-by-content-sha with shadow scoring (the candidate
               scores a sampled fraction of live batches alongside the
               active set; per-version serve.* metrics + score-delta
               stats), so a canary rollout is decidable from the ledger.
  promote.py   the promotion gate: shadow agreement + drift verdict ->
               promote/hold decision, written as a `promote-<seq>.json`
               ledger manifest (`shifu promote`).

  rounds.py    the fleet-wide promotion round's records: prepare, ack,
               commit, abort under `.shifu/runs/peers/rounds/`, each
               written atomically (`shifu promote` coordinates, every
               leased serve process takes part, serve/peers.py).

`shifu retrain` (processor/retrain.py) consumes the traffic log and/or
new data through the existing ShardPlan streaming feeds, warm-starts
NN/LR from the previous model and extends GBT by appending trees.

Knobs (all -D properties):

  shifu.loop.logSample        fraction of served rows logged (default 0 =
                              off; `shifu serve --traffic-log` sets 1.0)
  shifu.loop.logChunkRows     rows per traffic chunk file (default 4096)
  shifu.loop.psiDegrade       per-column PSI that flips /healthz to
                              degraded + recommends retrain (default 0.2)
  shifu.loop.driftMinRows     live rows before drift verdicts bind
                              (default 256 — PSI over a handful of rows
                              is sampling noise, not a shift; below it
                              the verdict reports `warming`)
  shifu.loop.driftCheckBatches  batches between drift verdict checks
                              (default 32; a check flushes the window)
  shifu.loop.shadowSample     fraction of live batches the staged shadow
                              version also scores (default 0.25)
  shifu.loop.shadowTolerance  |mean-score delta| (0..1000 scale) counted
                              as agreement (default 5.0)
  shifu.loop.promoteAgree     min shadow agreement rate to promote
                              (default 0.95)
  shifu.loop.promoteMinRows   min shadow-scored rows before a promote
                              decision is meaningful (default 64)
  shifu.loop.appendTrees      GBT retrain: trees appended on new chunks
                              (default 10)
"""

from __future__ import annotations

from shifu_tpu_torch.utils import environment

DEFAULT_LOG_CHUNK_ROWS = 4096
DEFAULT_PSI_DEGRADE = 0.2
DEFAULT_DRIFT_MIN_ROWS = 256
DEFAULT_DRIFT_CHECK_BATCHES = 32
DEFAULT_SHADOW_SAMPLE = 0.25
DEFAULT_SHADOW_TOLERANCE = 5.0
DEFAULT_PROMOTE_AGREE = 0.95
DEFAULT_PROMOTE_MIN_ROWS = 64
DEFAULT_APPEND_TREES = 10


def log_sample_setting() -> float:
    return environment.get_float("shifu.loop.logSample", 0.0)


def log_chunk_rows_setting() -> int:
    return environment.get_int("shifu.loop.logChunkRows",
                               DEFAULT_LOG_CHUNK_ROWS)


def psi_degrade_setting() -> float:
    return environment.get_float("shifu.loop.psiDegrade",
                                 DEFAULT_PSI_DEGRADE)


def drift_min_rows_setting() -> int:
    return environment.get_int("shifu.loop.driftMinRows",
                               DEFAULT_DRIFT_MIN_ROWS)


def drift_check_batches_setting() -> int:
    return environment.get_int("shifu.loop.driftCheckBatches",
                               DEFAULT_DRIFT_CHECK_BATCHES)


def shadow_sample_setting() -> float:
    return environment.get_float("shifu.loop.shadowSample",
                                 DEFAULT_SHADOW_SAMPLE)


def shadow_tolerance_setting() -> float:
    return environment.get_float("shifu.loop.shadowTolerance",
                                 DEFAULT_SHADOW_TOLERANCE)


def promote_agree_setting() -> float:
    return environment.get_float("shifu.loop.promoteAgree",
                                 DEFAULT_PROMOTE_AGREE)


def promote_min_rows_setting() -> int:
    return environment.get_int("shifu.loop.promoteMinRows",
                               DEFAULT_PROMOTE_MIN_ROWS)


def append_trees_setting() -> int:
    return environment.get_int("shifu.loop.appendTrees",
                               DEFAULT_APPEND_TREES)

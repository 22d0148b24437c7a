"""Population Stability Index per column, split by the PSI unit column.

The port's own copy of `shifu_tpu/stats/psi.py`, the same code but the
categorical bin index, which the stats codes already made
(`binning.category_index`). The serve-side drift monitor
(`loop/drift.py`) reuses `psi_from_counts`, so offline PSI and online
drift share one smoothing and zero-handling definition.

Parity: the reference's PSI Pig job (PSI.pig, udf/PSICalculatorUDF.java,
driven by MapReducerStatsWorker.runPSI:594) — per-unit bin distributions per
column, PSI of each unit against the whole population, unitStats strings
written back into ColumnConfig.

State is pure bin counts (integers carried in f64), so folding chunks
and merging shards' accumulators (`merge`) is exact in any order.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from shifu_tpu_torch.config import ColumnConfig
from shifu_tpu_torch.data.reader import ColumnarData
from shifu_tpu_torch.stats.binning import category_index, numeric_bin_index
from shifu_tpu_torch.stats.metrics import psi_metric


def psi_from_counts(expected: np.ndarray, actual: np.ndarray) -> float:
    """PSI between two bin-count vectors — the one definition both the
    offline unit-split pass and the online serve drift fold use.

    Degenerate inputs are defined, not crashed on: an empty/zero side
    (no expected traffic, or no live rows yet) is PSI 0.0, and
    zero-frequency bins (a category unseen in training, or a training bin
    live traffic never hits) are eps-smoothed inside `psi_metric` so a
    single empty slot contributes a finite term instead of ±inf."""
    return psi_metric(expected, actual)


class PsiAccumulator:
    """Per-(unit, column) bin-count accumulation; feed chunks, finalize once.
    State is O(units x columns x bins) — never rows."""

    def __init__(self, columns: List[ColumnConfig], psi_column: str):
        self.psi_column = psi_column
        self.cols = [
            cc for cc in columns
            if not (cc.is_target() or cc.is_meta() or cc.is_weight())
            and (cc.column_binning.bin_category is not None
                 or cc.column_binning.bin_boundary)
        ]
        self.n_slots = [
            (len(cc.column_binning.bin_category) + 1 if cc.is_categorical()
             else len(cc.column_binning.bin_boundary) + 1)
            for cc in self.cols
        ]
        # unit -> [per-column count arrays]; overall kept separately
        self.unit_counts: Dict[str, List[np.ndarray]] = {}
        self.overall = [np.zeros(s, dtype=np.float64) for s in self.n_slots]

    def update(self, data: ColumnarData) -> None:
        if self.psi_column not in data.raw:
            raise KeyError(f"psi column {self.psi_column} not in data")
        units = np.asarray([str(u) for u in data.column(self.psi_column)])
        unit_values = sorted(set(units.tolist()))
        masks = {u: units == u for u in unit_values}
        for j, cc in enumerate(self.cols):
            if cc.is_categorical():
                idx = category_index(data, cc.column_name,
                                     cc.column_binning.bin_category)
            else:
                idx = numeric_bin_index(
                    data.numeric(cc.column_name), cc.column_binning.bin_boundary
                )
            s = self.n_slots[j]
            self.overall[j] += np.bincount(idx, minlength=s).astype(np.float64)
            for u in unit_values:
                dist = np.bincount(idx[masks[u]], minlength=s).astype(np.float64)
                per_col = self.unit_counts.setdefault(
                    u, [np.zeros(k, dtype=np.float64) for k in self.n_slots]
                )
                per_col[j] += dist

    def merge(self, other: "PsiAccumulator") -> None:
        """Fold another shard's counts in (same columns, bins and unit
        column)."""
        if (self.psi_column != other.psi_column
                or self.n_slots != other.n_slots
                or [c.column_name for c in self.cols]
                != [c.column_name for c in other.cols]):
            raise ValueError("cannot merge PSI accumulators built over "
                             "different columns/bins/unit column")
        for j in range(len(self.cols)):
            self.overall[j] += other.overall[j]
        for u, per_col in other.unit_counts.items():
            mine = self.unit_counts.setdefault(
                u, [np.zeros(k, dtype=np.float64) for k in self.n_slots])
            for j in range(len(self.cols)):
                mine[j] += per_col[j]

    def finalize(self) -> None:
        """Write psi + per-unit PSI sequence into each ColumnConfig.

        The reference emits the PSI of each unit vs the whole population
        (udf/PSICalculatorUDF.java); unit_stats keeps the full per-unit
        sequence — the drift-over-time signal — while column_stats.psi
        summarizes with the mean (unit labels are strings, so no ordering
        is assumed; consumers needing the latest period read unit_stats)."""
        unit_values = sorted(self.unit_counts)
        for j, cc in enumerate(self.cols):
            unit_psis = []
            unit_stats = []
            for u in unit_values:
                p = psi_metric(self.overall[j], self.unit_counts[u][j])
                unit_psis.append(p)
                unit_stats.append(f"{u}:{p:.6f}")
            cc.column_stats.psi = float(np.mean(unit_psis)) if unit_psis else 0.0
            cc.column_stats.unit_stats = unit_stats


def compute_psi(
    data: ColumnarData, columns: List[ColumnConfig], psi_column: str
) -> None:
    """Fill column_stats.psi and unit_stats in place (single-shot path)."""
    acc = PsiAccumulator(columns, psi_column)
    acc.update(data)
    acc.finalize()

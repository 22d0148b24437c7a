"""Closed-form column metrics from per-bin pos/neg counts.

The port's own copy of `shifu_tpu/stats/metrics.py`, the same code.

Formula parity with the reference's core/ColumnStatsCalculator.java:24
(List<T> variant, the one UpdateBinningInfoReducer feeds):

    woe      = ln((sumP + EPS) / (sumN + EPS))
    woe_i    = ln((p_i + EPS) / (n_i + EPS)),  p_i = pos_i/sumP, n_i = neg_i/sumN
    iv       = sum_i (p_i - n_i) * woe_i
    ks       = 100 * max_i |cumP_i - cumN_i|

Vectorized over many columns at once in float64 numpy: inputs are padded
[n_cols, max_bins] arrays with a valid-bin mask. (The row-dimension reduction
— millions of rows down to per-bin counts — runs on-device in ops/binagg.py;
this final [cols x bins] step is tiny and needs f64 parity, so it stays on
host.)
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

EPS = 1e-10


class ColumnMetrics(NamedTuple):
    ks: np.ndarray  # [n_cols]
    iv: np.ndarray  # [n_cols]
    woe: np.ndarray  # [n_cols]
    bin_woe: np.ndarray  # [n_cols, max_bins]
    valid: np.ndarray  # [n_cols] bool: sumP>0 and sumN>0


def column_metrics(
    pos: np.ndarray, neg: np.ndarray, mask: np.ndarray
) -> ColumnMetrics:
    """pos/neg: [n_cols, max_bins]; mask: same shape, 1 for real bins.

    Matches ColumnStatsCalculator.calculateColumnMetrics semantics; columns
    with an empty class (sumP==0 or sumN==0) are flagged invalid (the
    reference returns null there).
    """
    pos = np.asarray(pos, dtype=np.float64) * mask
    neg = np.asarray(neg, dtype=np.float64) * mask
    sum_p = pos.sum(axis=1, keepdims=True)
    sum_n = neg.sum(axis=1, keepdims=True)
    valid = (sum_p[:, 0] > 0) & (sum_n[:, 0] > 0)

    p = pos / np.maximum(sum_p, EPS)
    n = neg / np.maximum(sum_n, EPS)
    bin_woe = np.log((p + EPS) / (n + EPS)) * mask
    iv = ((p - n) * bin_woe).sum(axis=1)
    woe = np.log((sum_p[:, 0] + EPS) / (sum_n[:, 0] + EPS))

    cum_p = np.cumsum(p, axis=1)
    cum_n = np.cumsum(n, axis=1)
    ks = 100.0 * (np.abs(cum_p - cum_n) * mask).max(axis=1)
    return ColumnMetrics(ks=ks, iv=iv, woe=woe, bin_woe=bin_woe, valid=valid)


def psi_metric(
    expected: np.ndarray, actual: np.ndarray, eps: float = EPS
) -> float:
    """Population stability index between two bin distributions (counts)."""
    e = np.asarray(expected, dtype=np.float64)
    a = np.asarray(actual, dtype=np.float64)
    se, sa = e.sum(), a.sum()
    if se <= 0 or sa <= 0:
        return 0.0
    pe = e / se
    pa = a / sa
    return float(((pa - pe) * np.log((pa + eps) / (pe + eps))).sum())

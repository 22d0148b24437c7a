"""Eval metrics: confusion sweep, PR/ROC/gain bucketing, AUC (the port's
copy of `shifu_tpu/eval/metrics.py`, numpy on the host as there).

The reference streams sorted scores through a buffered confusion matrix
(core/ConfusionMatrix.java:248 bufferedComputeConfusionMatrixAndPerformance,
core/PerformanceEvaluator.java:252 bucketing, core/eval/AreaUnderCurve.java:31
trapezoid). Vectorized here: sort scores descending once, cumulative sums give
every threshold's (tp, fp, tn, fn) in one pass — the whole sweep is O(n log n)
over one score column. It stays on the host: a weighted cumsum on the card
is a parallel scan whose last bits differ, and EvalPerformance.json prints
floats by repr, so the same score file gives the JAX package's bytes only
through the same sequential numpy sums.

PerformanceObject field parity (container/PerformanceObject.java): binNum,
binLowestScore, tp/fp/tn/fn (+weighted), precision/recall/fpr (+weighted),
actionRate, liftUnit. Bucket selection parity with
PerformanceEvaluator.bucketing: FPR list keyed on fpr crossings, catch-rate
list on recall crossings, gain list on action-rate crossings.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


@dataclass
class ConfusionSweep:
    """Cumulative confusion state at each score threshold (descending).
    `block_end[i]` is True on the LAST row of each tied-score block; curves
    and AUC evaluate only there, so tied records move through the sweep as
    one unit and the result is independent of input row order."""

    scores: np.ndarray  # sorted descending
    tp: np.ndarray
    fp: np.ndarray
    fn: np.ndarray
    tn: np.ndarray
    wtp: np.ndarray
    wfp: np.ndarray
    wfn: np.ndarray
    wtn: np.ndarray
    block_end: np.ndarray
    total: int
    pos_total: float
    neg_total: float
    wpos_total: float
    wneg_total: float


def confusion_sweep(
    scores: np.ndarray, tags: np.ndarray, weights: Optional[np.ndarray] = None
) -> ConfusionSweep:
    scores = np.asarray(scores, dtype=np.float64)
    tags = np.asarray(tags, dtype=np.float64)
    w = (
        np.ones_like(scores)
        if weights is None
        else np.asarray(weights, dtype=np.float64)
    )
    order = np.argsort(-scores, kind="stable")
    s, t, w = scores[order], tags[order], w[order]
    tp = np.cumsum(t)
    fp = np.cumsum(1.0 - t)
    wtp = np.cumsum(t * w)
    wfp = np.cumsum((1.0 - t) * w)
    pos_total, neg_total = float(tp[-1]) if t.size else 0.0, float(fp[-1]) if t.size else 0.0
    wpos_total = float(wtp[-1]) if t.size else 0.0
    wneg_total = float(wfp[-1]) if t.size else 0.0
    block_end = (
        np.concatenate([s[:-1] != s[1:], [True]]) if t.size
        else np.zeros(0, dtype=bool)
    )
    return ConfusionSweep(
        scores=s,
        tp=tp,
        fp=fp,
        fn=pos_total - tp,
        tn=neg_total - fp,
        wtp=wtp,
        wfp=wfp,
        wfn=wpos_total - wtp,
        wtn=wneg_total - wfp,
        block_end=block_end,
        total=int(t.size),
        pos_total=pos_total,
        neg_total=neg_total,
        wpos_total=wpos_total,
        wneg_total=wneg_total,
    )


def area_under_curve(fpr: np.ndarray, recall: np.ndarray) -> float:
    """Trapezoid AUC over the ROC polyline incl. (0,0) and (1,1) endpoints
    (AreaUnderCurve.java:31)."""
    x = np.concatenate([[0.0], fpr, [1.0]])
    y = np.concatenate([[0.0], recall, [1.0]])
    return float(np.trapezoid(y, x))


def auc_from_sweep(cs: ConfusionSweep, weighted: bool = False) -> float:
    be = cs.block_end
    if weighted:
        fpr = cs.wfp[be] / max(cs.wneg_total, 1e-12)
        rec = cs.wtp[be] / max(cs.wpos_total, 1e-12)
    else:
        fpr = cs.fp[be] / max(cs.neg_total, 1e-12)
        rec = cs.tp[be] / max(cs.pos_total, 1e-12)
    return area_under_curve(fpr, rec)


def _perf_object(cs: ConfusionSweep, i: int, bin_num: int) -> Dict:
    tp, fp = float(cs.tp[i]), float(cs.fp[i])
    fn, tn = float(cs.fn[i]), float(cs.tn[i])
    wtp, wfp = float(cs.wtp[i]), float(cs.wfp[i])
    wfn, wtn = float(cs.wfn[i]), float(cs.wtn[i])
    pos, neg = cs.pos_total, cs.neg_total
    wpos, wneg = cs.wpos_total, cs.wneg_total
    action = (tp + fp) / max(cs.total, 1)
    waction = (wtp + wfp) / max(wpos + wneg, 1e-12)
    recall = tp / max(pos, 1e-12)
    wrecall = wtp / max(wpos, 1e-12)
    precision = tp / max(tp + fp, 1e-12)
    wprecision = wtp / max(wtp + wfp, 1e-12)
    return {
        "binNum": bin_num,
        "binLowestScore": float(cs.scores[i]),
        "tp": tp, "fp": fp, "fn": fn, "tn": tn,
        "weightedTp": wtp, "weightedFp": wfp,
        "weightedFn": wfn, "weightedTn": wtn,
        "precision": precision,
        "weightedPrecision": wprecision,
        "recall": recall,
        "weightedRecall": wrecall,
        "fpr": fp / max(neg, 1e-12),
        "weightedFpr": wfp / max(wneg, 1e-12),
        "actionRate": action,
        "weightedActionRate": waction,
        "liftUnit": recall / action if action > 0 else 0.0,
        "weightLiftUnit": wrecall / waction if waction > 0 else 0.0,
    }


@dataclass
class PerformanceResult:
    pr: List[Dict] = field(default_factory=list)
    weighted_pr: List[Dict] = field(default_factory=list)
    roc: List[Dict] = field(default_factory=list)
    weighted_roc: List[Dict] = field(default_factory=list)
    gains: List[Dict] = field(default_factory=list)
    weighted_gains: List[Dict] = field(default_factory=list)
    area_under_roc: float = 0.0
    weighted_area_under_roc: float = 0.0

    def to_json(self) -> dict:
        return {
            "version": "1.0",
            "pr": self.pr,
            "weightedPr": self.weighted_pr,
            "roc": self.roc,
            "weightedRoc": self.weighted_roc,
            "gains": self.gains,
            "weightedGains": self.weighted_gains,
            "areaUnderRoc": self.area_under_roc,
            "weightedAreaUnderRoc": self.weighted_area_under_roc,
        }


def sweep_from_histogram(
    scores: np.ndarray,
    pos: np.ndarray,
    neg: np.ndarray,
    wpos: np.ndarray,
    wneg: np.ndarray,
) -> ConfusionSweep:
    """ConfusionSweep from per-unique-score tallies (descending scores).

    The streamed perf path accumulates counts per DISTINCT written score
    (the score file carries 3 decimals, so the tally is EXACT, not an
    approximation); each distinct score is one tied block, which is
    precisely the tie-aware sweep's unit."""
    order = np.argsort(-np.asarray(scores, np.float64), kind="stable")
    s = np.asarray(scores, np.float64)[order]
    p = np.asarray(pos, np.float64)[order]
    n = np.asarray(neg, np.float64)[order]
    wp = np.asarray(wpos, np.float64)[order]
    wn = np.asarray(wneg, np.float64)[order]
    tp, fp = np.cumsum(p), np.cumsum(n)
    wtp, wfp = np.cumsum(wp), np.cumsum(wn)
    pos_total = float(tp[-1]) if len(tp) else 0.0
    neg_total = float(fp[-1]) if len(fp) else 0.0
    wpos_total = float(wtp[-1]) if len(wtp) else 0.0
    wneg_total = float(wfp[-1]) if len(wfp) else 0.0
    return ConfusionSweep(
        scores=s,
        tp=tp, fp=fp, fn=pos_total - tp, tn=neg_total - fp,
        wtp=wtp, wfp=wfp, wfn=wpos_total - wtp, wtn=wneg_total - wfp,
        block_end=np.ones(len(s), dtype=bool),
        total=int(round(pos_total + neg_total)),
        pos_total=pos_total, neg_total=neg_total,
        wpos_total=wpos_total, wneg_total=wneg_total,
    )


def evaluate_performance(
    scores: np.ndarray,
    tags: np.ndarray,
    weights: Optional[np.ndarray] = None,
    n_buckets: int = 10,
) -> PerformanceResult:
    """Bucketed PR/ROC/gain lists + AUC (PerformanceEvaluator.bucketing
    crossing rules: emit a row the first time the tracked rate crosses each
    1/numBucket boundary)."""
    return evaluate_performance_from_sweep(
        confusion_sweep(scores, tags, weights), n_buckets
    )


def evaluate_performance_from_sweep(
    cs: ConfusionSweep, n_buckets: int = 10
) -> PerformanceResult:
    res = PerformanceResult()
    if cs.total == 0:
        return res
    cap = 1.0 / n_buckets

    fpr = cs.fp / max(cs.neg_total, 1e-12)
    rec = cs.tp / max(cs.pos_total, 1e-12)
    act = (cs.tp + cs.fp) / max(cs.total, 1)
    wfpr = cs.wfp / max(cs.wneg_total, 1e-12)
    wrec = cs.wtp / max(cs.wpos_total, 1e-12)
    wact = (cs.wtp + cs.wfp) / max(cs.wpos_total + cs.wneg_total, 1e-12)

    ends = np.nonzero(cs.block_end)[0]

    def pick(series) -> List[Dict]:
        out = [_first_po(cs)]
        nxt = 1
        for i in ends:
            while nxt <= n_buckets and series[i] >= nxt * cap:
                out.append(_perf_object(cs, i, nxt))
                nxt += 1
        return out

    res.roc = pick(fpr)
    res.pr = pick(rec)
    res.gains = pick(act)
    res.weighted_roc = pick(wfpr)
    res.weighted_pr = pick(wrec)
    res.weighted_gains = pick(wact)
    res.area_under_roc = auc_from_sweep(cs)
    res.weighted_area_under_roc = auc_from_sweep(cs, weighted=True)
    return res


def _first_po(cs: ConfusionSweep) -> Dict:
    po = _perf_object(cs, 0, 0)
    # reference pins the first row's NaN-prone fields (bucketing :272-282)
    po["precision"] = 1.0
    po["weightedPrecision"] = 1.0
    po["liftUnit"] = 0.0
    po["weightLiftUnit"] = 0.0
    return po


def confusion_matrix_rows(
    cs: ConfusionSweep, step: int = 0
) -> List[Dict]:
    """Per-threshold confusion rows for EvalConfusionMatrix.csv; `step`
    subsamples to at most ~1000 rows for wide datasets."""
    # Only block-end indices are valid thresholds — a row inside a
    # tied-score block would depend on input order among ties and disagree
    # with the tie-aware sweep used for curves/AUC.
    ends = np.nonzero(cs.block_end)[0]
    if step <= 0:
        step = max(1, len(ends) // 1000)
    rows = []
    for k, i in enumerate(ends[::step]):
        rows.append(_perf_object(cs, int(i), k))
    return rows

"""Multi-class prediction + confusion matrix (the port's copy of
`shifu_tpu/eval/multiclass.py`, numpy on the host).

Parity: core/ConfusionMatrix.java:625
(computeConfusionMatixForMultipleClassification) and
util/MultiClsTagPredictor.java. Three prediction regimes:

  NATIVE NN    score columns are model-major blocks of K per-class scores
               ("1,2,3 4,5,6: 1,2,3 is model 0" — ConfusionMatrix.java:760);
               per-class scores average over models, argmax wins.
  ONEVSALL     one binary model per class -> K columns; class k is "positive"
               when score_k > (1 - prior_k) * scale (the im-balance threshold,
               ConfusionMatrix.java:708-744); among positives the class with
               the LARGEST prior wins; no positive -> the largest-prior class.
  NATIVE RF    per-tree class votes (ConfusionMatrix.java:683-697) — handled
               by the tree scorer emitting per-class vote fractions, then
               argmax here like NATIVE NN.

`priors` are the per-class training frequencies (the reference reads them
from the target column's binCountPos/binCountNeg written by stats); the norm
step records them in meta.json as classPriors.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def class_priors(tags: np.ndarray, n_classes: int) -> np.ndarray:
    """Per-class frequency ratios from integer class tags (invalid < 0
    excluded) — binRatio in ConfusionMatrix.java:645-653."""
    t = np.asarray(tags)
    t = t[(t >= 0) & (t < n_classes)]
    counts = np.bincount(t.astype(np.int64), minlength=n_classes).astype(np.float64)
    total = counts.sum()
    return counts / total if total > 0 else np.full(n_classes, 1.0 / n_classes)


def predict_native(scores: np.ndarray, n_classes: int) -> np.ndarray:
    """scores [n, M*K] model-major blocks -> predicted class [n] by argmax of
    the model-averaged per-class score (ConfusionMatrix.java:758-772)."""
    n, c = scores.shape
    if c % n_classes != 0:
        raise ValueError(
            f"{c} score columns are not a multiple of {n_classes} classes"
        )
    m = c // n_classes
    per_class = scores.reshape(n, m, n_classes).mean(axis=1)
    return np.argmax(per_class, axis=1).astype(np.int32)


def predict_one_vs_all(
    scores: np.ndarray,
    priors: np.ndarray,
    scale: float = 1000.0,
) -> np.ndarray:
    """scores [n, K] (model k = class k's binary model, 0..scale). Threshold
    class k at (1 - priors[k]) * scale; among positives pick the class with
    the highest prior; if none, the globally largest-prior class
    (ConfusionMatrix.java:708-744; K == 2 special case :697-706 picks class 0
    iff its score crosses the threshold)."""
    n, k = scores.shape
    priors = np.asarray(priors, np.float64)
    if k == 2 or k == 1:
        # binary: one model decides (only model 0 is consulted)
        pred = np.where(scores[:, 0] > (1.0 - priors[0]) * scale, 0, 1)
        return pred.astype(np.int32)
    thresh = (1.0 - priors) * scale  # [K]
    positive = scores > thresh[None, :]
    # among positives, the highest-prior class; tie-break = first max
    prior_if_pos = np.where(positive, priors[None, :], -1.0)
    best_pos = np.argmax(prior_if_pos, axis=1)
    any_pos = positive.any(axis=1)
    fallback = int(np.argmax(priors))
    return np.where(any_pos, best_pos, fallback).astype(np.int32)


def confusion_matrix_multi(
    tags: np.ndarray, pred: np.ndarray, n_classes: int
) -> np.ndarray:
    """[K, K] counts, rows = actual, cols = predicted
    (confusionMatrix[tagIndex][predictIndex] ConfusionMatrix.java:781)."""
    t = np.asarray(tags, np.int64)
    p = np.asarray(pred, np.int64)
    ok = (t >= 0) & (t < n_classes) & (p >= 0) & (p < n_classes)
    flat = t[ok] * n_classes + p[ok]
    return np.bincount(flat, minlength=n_classes * n_classes).reshape(
        n_classes, n_classes
    )


def confusion_matrix_text(
    matrix: np.ndarray, class_tags: Sequence[str]
) -> str:
    """writeToConfMatrixFile layout: header of predicted tags, one row per
    actual tag."""
    lines = ["\t".join([""] + [str(t) for t in class_tags])]
    for i, t in enumerate(class_tags):
        lines.append("\t".join([str(t)] + [str(int(v)) for v in matrix[i]]))
    return "\n".join(lines) + "\n"


def multiclass_accuracy(matrix: np.ndarray) -> float:
    total = matrix.sum()
    return float(np.trace(matrix) / total) if total > 0 else 0.0

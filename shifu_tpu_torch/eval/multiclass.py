"""Multi-class helpers (counterpart of `shifu_tpu/eval/multiclass.py`).

Only `class_priors` is ported so far: the NATIVE norm writes the training
class priors into NormalizedData's meta.json. The confusion matrix and
the one-vs-all prediction come with eval (ROADMAP A.9).
"""

from __future__ import annotations

import numpy as np


def class_priors(tags: np.ndarray, n_classes: int) -> np.ndarray:
    """Per-class frequency ratios from integer class tags (invalid < 0
    excluded) — binRatio in ConfusionMatrix.java:645-653."""
    t = np.asarray(tags)
    t = t[(t >= 0) & (t < n_classes)]
    counts = np.bincount(t.astype(np.int64), minlength=n_classes).astype(np.float64)
    total = counts.sum()
    return counts / total if total > 0 else np.full(n_classes, 1.0 / n_classes)

"""Tree feature importance: split-count weighted by node coverage proxy
(counterpart of `shifu_tpu/varsel/importance.py`).

Parity: util/CommonUtils.computeTreeModelFeatureImportance (CommonUtils.java
tree FI computation) — importance per feature accumulates over every split
node; normalized to sum 1.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from shifu_tpu_torch.models.tree import TreeModelSpec


def tree_feature_importance(spec: TreeModelSpec) -> Dict[str, float]:
    F = len(spec.input_columns)
    imp = np.zeros(F, dtype=np.float64)
    for tree in spec.trees:
        # depth weighting: splits nearer the root cover more rows; the dense
        # layout encodes depth as floor(log2(node+1))
        for node, f in enumerate(tree.feature):
            if f < 0:
                continue
            depth = int(np.log2(node + 1))
            imp[f] += tree.weight / (2.0**depth)
    total = imp.sum()
    if total > 0:
        imp /= total
    return {name: float(v) for name, v in zip(spec.input_columns, imp)}

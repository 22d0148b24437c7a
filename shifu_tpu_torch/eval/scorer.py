"""Model discovery for scoring (counterpart of `shifu_tpu/eval/scorer.py`).

Only `find_model_paths` is ported so far: varsel's FI filter reads the
trained tree model with it. Batch scoring of raw records is ROADMAP A.9.
"""

from __future__ import annotations

import glob
import os
import re
from typing import List

MODEL_SUFFIXES = (".nn", ".lr", ".gbt", ".rf", ".wdl")


def find_model_paths(models_dir: str) -> List[str]:
    """models/model*.{nn,lr,gbt,rf,wdl} sorted by NUMERIC index
    (ModelSpecLoaderUtils.findModels). Numeric, not lexicographic: under
    ONEVSALL the column order is load-bearing (column k = class k), and
    lexicographic order would put model10 before model2.

    Paths are DEDUPED (overlapping globs/symlinked dirs must not score a
    model twice — duplicate columns skew the mean/median aggregates) and
    the order is fully deterministic: numeric index first, then basename —
    unindexed names land after every indexed one in basename order, never
    in whatever order the per-suffix globs happened to run."""
    out = set()
    for suf in MODEL_SUFFIXES:
        out.update(glob.glob(os.path.join(models_dir, f"model*{suf}")))

    def key(p: str):
        base = os.path.basename(p)
        m = re.search(r"model(\d+)", base)
        # (indexed-first, index, basename): the basename tie-break keeps
        # same-index files of different suffixes and ALL unindexed files
        # in one stable order regardless of glob/filesystem enumeration
        return (0, int(m.group(1)), base) if m else (1, 0, base)

    return sorted(out, key=key)

"""Reason codes — which variables drove a record's score (counterpart of
`shifu_tpu/eval/reasoner.py`).

Parity: core/Reasoner.java + udf/CalculateReasonCodeUDF.java. For every
final-selected column with a posttrain binAvgScore, the record's bin average
score IS its contribution proxy (Reasoner.ScoreDiffObject.scoreDiff =
binAvgScore[binNum]); the top-N columns by that score, mapped through the
reason-code dictionary, are the record's reasons.

Vectorized on the host: one bin-index pass per column (the norm step's
`_bin_codes_for`), one [n, C] gather, one argsort. The reason-code map
may sit on a remote source (hdfs://, s3://, ...: `fs/source.py`).
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np

from shifu_tpu_torch.fs.source import open_source


def load_reason_code_map(path: str) -> Dict[str, str]:
    """column name -> reason code. JSON object, or lines of `column,code`.
    Local path or any fs/source.py scheme (hdfs://, s3://...)."""
    with open_source(path, "rb") as fh:
        text = fh.read().decode("utf-8")
    try:
        data = json.loads(text)
        if isinstance(data, dict):
            return {str(k): str(v) for k, v in data.items()}
    except json.JSONDecodeError:
        pass
    out: Dict[str, str] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split(",", 1)
        if len(parts) == 2:
            out[parts[0].strip()] = parts[1].strip()
    return out


class Reasoner:
    """Batch reason-code calculator over raw records."""

    def __init__(self, column_configs,
                 reason_code_map: Optional[Dict[str, str]] = None,
                 num_top_variables: int = 5):
        self.reason_code_map = reason_code_map or {}
        self.num_top = num_top_variables
        # eligible: final-selected columns that posttrain scored
        # (Reasoner skips columns without binAvgScore)
        self.columns = [
            cc for cc in column_configs
            if cc.final_select and (cc.column_binning.bin_avg_score or [])
        ]

    def score_diffs(self, data) -> np.ndarray:
        """[n, C] binAvgScore of each record's bin per eligible column."""
        from shifu_tpu_torch.norm.normalizer import _bin_codes_for

        n = data.n_rows
        out = np.zeros((n, len(self.columns)), np.float64)
        for j, cc in enumerate(self.columns):
            table = np.asarray(
                [float(v) for v in cc.column_binning.bin_avg_score],
                np.float64,
            )
            codes = np.clip(_bin_codes_for(cc, data), 0, len(table) - 1)
            out[:, j] = table[codes]
        return out

    def reason_codes(self, data) -> List[List[str]]:
        """Per-record top-N reason codes, deduplicated in rank order
        (Reasoner.calculateReasonCodes sort + reasonCodeMap lookup)."""
        if not self.columns:
            return [[] for _ in range(data.n_rows)]
        diffs = self.score_diffs(data)
        order = np.argsort(-diffs, axis=1, kind="stable")
        names = [cc.column_name for cc in self.columns]
        top = min(self.num_top, len(self.columns))
        out: List[List[str]] = []
        for i in range(diffs.shape[0]):
            reasons: List[str] = []
            for j in order[i, :top]:
                code = self.reason_code_map.get(names[j], names[j])
                if code not in reasons:
                    reasons.append(code)
            out.append(reasons)
        return out

"""Normalization (counterpart of `shifu_tpu/norm/normalizer.py`).

Only `norm_columns` is ported so far: the tree `shifu train` step needs it
to match the CleanedData columns with their ColumnConfig entries. The norm
plan, the value/table kernels and the bin-code matrix come with the norm
slice (ROADMAP A.6).
"""

from __future__ import annotations

from typing import List

from shifu_tpu_torch.config import ColumnConfig


def norm_columns(columns: List[ColumnConfig]) -> List[ColumnConfig]:
    """Columns emitted into the normalized matrix: final-selected if varsel has
    run, else every good candidate with stats (NormalizeUDF emits candidates
    pre-varsel, finalSelect post-varsel — udf/NormalizeUDF.java:167-199)."""
    selected = [c for c in columns if c.final_select and c.is_feature()]
    if selected:
        return selected
    return [
        c
        for c in columns
        if c.is_feature()
        and (
            c.column_binning.bin_boundary is not None
            or c.column_binning.bin_category is not None
        )
    ]

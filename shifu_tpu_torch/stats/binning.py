"""Bin-boundary construction (the port's copy of
`shifu_tpu/stats/binning.py`; tokens follow `data/tokens.py`).

The reference builds numeric bins with a streaming SPDT histogram sketch
(core/binning/EqualPopulationBinning.java:34) because data only streams
through Pig mappers; here full columns are resident, so boundaries come from
EXACT (weighted) quantiles — strictly more accurate than the sketch, same
contract: boundary[0] = -inf, bin i covers [b[i], b[i+1]).

Methods (stats.binningMethod, container/obj/ModelStatsConf.java):
  EqualPositive / EqualNegative / EqualTotal — equal count of pos/neg/all rows
  per bin (quantiles over the respective subset); Weight* variants use the
  weight column as the mass. EqualInterval — equal-width bins over [min, max].

Categorical bins: distinct values ordered by descending frequency, capped at
``cate_max_num_bin`` (rare tail merged into the last real bin); missing is
always the extra final bin slot of the count arrays.
"""

from __future__ import annotations

from collections import Counter
from itertools import repeat
from typing import List, Optional, Sequence

import numpy as np

from shifu_tpu_torch.config.model_config import BinningMethod
from shifu_tpu_torch.data.tokens import strip_tokens, to_numeric

NEG_INF = float("-inf")


def weighted_quantile_boundaries(
    values: np.ndarray, weights: Optional[np.ndarray], max_bins: int
) -> List[float]:
    """Boundaries so each bin holds ~equal mass. values must be finite."""
    if values.size == 0:
        return [NEG_INF]
    order = np.argsort(values, kind="stable")
    v = values[order]
    if weights is None:
        cum = np.arange(1, v.size + 1, dtype=np.float64)
    else:
        cum = np.cumsum(weights[order])
    total = cum[-1]
    if total <= 0:
        return [NEG_INF]
    boundaries = [NEG_INF]
    for k in range(1, max_bins):
        target = total * k / max_bins
        idx = int(np.searchsorted(cum, target, side="left"))
        idx = min(idx, v.size - 1)
        b = float(v[idx])
        if b > boundaries[-1]:
            boundaries.append(b)
    return boundaries


def equal_interval_boundaries(values: np.ndarray, max_bins: int) -> List[float]:
    if values.size == 0:
        return [NEG_INF]
    lo, hi = float(values.min()), float(values.max())
    if hi <= lo:
        return [NEG_INF]
    step = (hi - lo) / max_bins
    boundaries = [NEG_INF]
    for k in range(1, max_bins):
        boundaries.append(lo + k * step)
    return boundaries


def numeric_boundaries(
    values: np.ndarray,
    tags: np.ndarray,
    weights: np.ndarray,
    method: BinningMethod,
    max_bins: int,
) -> List[float]:
    """values: float64 with NaN for missing; tags: {1,0,-1}; returns bin
    boundaries starting at -inf."""
    finite = np.isfinite(values)
    v = values[finite]
    t = tags[finite]
    w = weights[finite]
    if method == BinningMethod.EQUAL_INTERVAL:
        return equal_interval_boundaries(v, max_bins)
    if method in (BinningMethod.EQUAL_POSITIVE, BinningMethod.WEIGHT_EQUAL_POSITIVE):
        sel = t == 1
    elif method in (BinningMethod.EQUAL_NEGATIVE, BinningMethod.WEIGHT_EQUAL_NEGATIVE):
        sel = t == 0
    else:  # EqualTotal / WeightEqualTotal
        sel = t >= 0
    use_weights = method in (
        BinningMethod.WEIGHT_EQUAL_POSITIVE,
        BinningMethod.WEIGHT_EQUAL_NEGATIVE,
        BinningMethod.WEIGHT_EQUAL_TOTAL,
    )
    subset = v[sel]
    if subset.size == 0:  # degenerate: fall back to all rows
        subset, sel = v, np.ones(v.size, dtype=bool)
    return weighted_quantile_boundaries(
        subset, w[sel] if use_weights else None, max_bins
    )


def categorical_bins(
    raw: np.ndarray,
    missing_mask: np.ndarray,
    max_categories: int,
) -> List[str]:
    """Distinct non-missing values by descending frequency, capped. Ties
    keep their order of first appearance: `Series.value_counts()` counts
    in that order and sorts the counts with a stable sort."""
    counts = Counter(strip_tokens(raw[~missing_mask]))
    cats = [str(c) for c, _ in sorted(counts.items(), key=lambda kv: -kv[1])]
    if max_categories and len(cats) > max_categories:
        cats = cats[:max_categories]
    return cats


def numeric_bin_index(values: np.ndarray, boundaries: Sequence[float]) -> np.ndarray:
    """Vectorized BinUtils.getNumericalBinIndex (util/BinUtils.java:74):
    bin i when boundaries[i] <= v < boundaries[i+1]; NaN -> missing bin
    (= len(boundaries), the last slot)."""
    b = np.asarray(boundaries, dtype=np.float64)
    idx = np.searchsorted(b, values, side="right") - 1
    idx = np.clip(idx, 0, len(b) - 1)
    missing = ~np.isfinite(values)
    idx = np.where(missing, len(b), idx)
    return idx.astype(np.int32)


def categorical_bin_index(
    raw: np.ndarray, categories: Sequence[str], missing_mask: np.ndarray
) -> np.ndarray:
    """Value -> category position; unseen/missing -> missing bin
    (= len(categories))."""
    lookup = {c: i for i, c in enumerate(categories)}
    miss = len(categories)
    idx = np.fromiter(map(lookup.get, strip_tokens(raw), repeat(miss)),
                      dtype=np.int64, count=len(raw))
    idx[missing_mask] = miss
    return idx.astype(np.int32)


def category_index(data, name: str, categories: Sequence[str]) -> np.ndarray:
    """`categorical_bin_index` of a ColumnarData column, made once per
    column and category list: the stats codes, the correlation and the
    PSI pass all ask for it. Read-only."""
    key = ("category", name, tuple(categories))
    idx = data._index_cache.get(key)
    if idx is None:
        idx = categorical_bin_index(data.stripped(name), categories,
                                    data.missing_mask(name))
        idx.flags.writeable = False
        data._index_cache[key] = idx
    return idx


def hybrid_bin_index(
    raw: np.ndarray,
    boundaries: Sequence[float],
    categories: Sequence[str],
    missing_mask: np.ndarray,
) -> np.ndarray:
    """Hybrid (H) column bin index — Normalizer.java:622-638: try the
    categorical lookup first (hit -> |numeric bins| + category index), else
    parse as a number (numeric bin; unparseable -> the trailing missing slot
    at |numeric bins| + |categories|)."""
    nb = len(boundaries)
    miss_slot = nb + len(categories)
    lookup = {c: i for i, c in enumerate(categories)}
    ser = strip_tokens(raw)
    cat_idx = np.fromiter(map(lookup.get, ser, repeat(-1)), dtype=np.int64,
                          count=len(ser))
    vals = to_numeric(ser)
    num_idx = numeric_bin_index(vals, boundaries)
    out = np.where(
        cat_idx >= 0,
        nb + cat_idx,
        # non-finite parses ("Infinity") are missing too, like
        # ColumnarData.numeric does for pure-numeric columns
        np.where(~np.isfinite(vals), miss_slot, num_idx),
    ).astype(np.int32)
    out[np.asarray(missing_mask)] = miss_slot
    return out

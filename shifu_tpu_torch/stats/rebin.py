"""`shifu stats -rebin` — IV-driven dynamic re-binning.

The port's own copy of `shifu_tpu/stats/rebin.py`, the same code; host
only.

Parity: core/binning/ColumnConfigDynamicBinning.java (DIB path of
StatsModelProcessor): merge adjacent bins of an already-statted column,
greedily combining the pair with the most similar WOE until the target bin
count is reached (or IV loss would exceed the keep ratio). Works off the
existing bin counts — no data re-read.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np

from shifu_tpu_torch.config import ColumnConfig
from shifu_tpu_torch.utils.log import get_logger

log = get_logger(__name__)


def _woe(pos, neg, pos_total, neg_total) -> float:
    eps = 1e-10
    return math.log(
        max(pos / max(pos_total, eps), eps) / max(neg / max(neg_total, eps), eps)
    )


def _iv(pos_list, neg_list, pos_total, neg_total) -> float:
    total = 0.0
    eps = 1e-10
    for p, n in zip(pos_list, neg_list):
        pr = max(p / max(pos_total, eps), eps)
        nr = max(n / max(neg_total, eps), eps)
        total += (pr - nr) * math.log(pr / nr)
    return total


def rebin_column(cc: ColumnConfig, target_bins: int, iv_keep_ratio: float = 0.95) -> bool:
    """Merge adjacent numeric bins in place. Returns True if changed.
    The trailing missing bin never merges."""
    bn = cc.column_binning
    if cc.is_categorical() or not bn.bin_boundary or not bn.bin_count_pos:
        return False
    # real bins exclude the trailing missing slot
    n_real = len(bn.bin_boundary)
    pos = [float(x) for x in bn.bin_count_pos[:n_real]]
    neg = [float(x) for x in bn.bin_count_neg[:n_real]]
    wpos = [float(x) for x in (bn.bin_weighted_pos or pos)[:n_real]]
    wneg = [float(x) for x in (bn.bin_weighted_neg or neg)[:n_real]]
    bounds = list(bn.bin_boundary)
    pos_total = sum(pos) + float(bn.bin_count_pos[-1])
    neg_total = sum(neg) + float(bn.bin_count_neg[-1])
    orig_iv = _iv(pos, neg, pos_total, neg_total)

    changed = False
    while len(bounds) > max(target_bins, 2):
        woes = [_woe(p, n, pos_total, neg_total) for p, n in zip(pos, neg)]
        diffs = [abs(woes[i + 1] - woes[i]) for i in range(len(woes) - 1)]
        k = diffs.index(min(diffs))
        merged_pos = pos[: k] + [pos[k] + pos[k + 1]] + pos[k + 2 :]
        merged_neg = neg[: k] + [neg[k] + neg[k + 1]] + neg[k + 2 :]
        new_iv = _iv(merged_pos, merged_neg, pos_total, neg_total)
        if orig_iv > 0 and new_iv < orig_iv * iv_keep_ratio:
            break
        pos, neg = merged_pos, merged_neg
        wpos = wpos[: k] + [wpos[k] + wpos[k + 1]] + wpos[k + 2 :]
        wneg = wneg[: k] + [wneg[k] + wneg[k + 1]] + wneg[k + 2 :]
        bounds.pop(k + 1)  # bin k absorbs bin k+1
        changed = True

    if not changed:
        return False
    miss_pos = float(bn.bin_count_pos[-1])
    miss_neg = float(bn.bin_count_neg[-1])
    miss_wpos = float((bn.bin_weighted_pos or [miss_pos])[-1])
    miss_wneg = float((bn.bin_weighted_neg or [miss_neg])[-1])
    bn.bin_boundary = bounds
    bn.length = len(bounds)
    bn.bin_count_pos = [int(x) for x in pos] + [int(miss_pos)]
    bn.bin_count_neg = [int(x) for x in neg] + [int(miss_neg)]
    bn.bin_weighted_pos = wpos + [miss_wpos]
    bn.bin_weighted_neg = wneg + [miss_wneg]
    all_pos = pos + [miss_pos]
    all_neg = neg + [miss_neg]
    all_wpos = wpos + [miss_wpos]
    all_wneg = wneg + [miss_wneg]
    bn.bin_pos_rate = [
        p / max(p + n, 1e-10) for p, n in zip(all_pos, all_neg)
    ]
    # Recompute count AND weighted woe/iv/ks from the merged bins so
    # downstream WEIGHT_WOE/WEIGHT_HYBRID norms read fresh tables
    # (ColumnConfigDynamicBinning recomputes both in the reference).
    from shifu_tpu_torch.stats.metrics import column_metrics

    mask = np.ones((1, len(all_pos)))
    cm = column_metrics(np.asarray([all_pos]), np.asarray([all_neg]), mask)
    wm = column_metrics(np.asarray([all_wpos]), np.asarray([all_wneg]), mask)
    bn.bin_count_woe = [float(x) for x in cm.bin_woe[0]]
    bn.bin_weighted_woe = [float(x) for x in wm.bin_woe[0]]
    st = cc.column_stats
    # same guard as the stats engine (engine.py writes metrics only for
    # valid columns): a column with an empty class gets no ks/iv, not noise
    if cm.valid[0]:
        st.iv = float(cm.iv[0])
        st.ks = float(cm.ks[0])
        st.woe = float(cm.woe[0])
    if wm.valid[0]:
        st.weighted_iv = float(wm.iv[0])
        st.weighted_ks = float(wm.ks[0])
        st.weighted_woe = float(wm.woe[0])
    return True


def rebin_columns(
    columns: List[ColumnConfig], target_bins: int, iv_keep_ratio: float = 0.95
) -> int:
    n = 0
    for cc in columns:
        if cc.final_select or not any(c.final_select for c in columns):
            if rebin_column(cc, target_bins, iv_keep_ratio):
                n += 1
    return n

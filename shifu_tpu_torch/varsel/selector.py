"""Variable selection by metric filters (counterpart of
`shifu_tpu/varsel/selector.py`).

Parity: core/VariableSelector.java:110 (selectByFilter: KS / IV / MIX
alternating / PARETO front) and the VarSelectModelProcessor auto-filter
(missing-rate / min-KS / min-IV / correlation thresholds), and the SE/ST
sensitivity wrapper's knockout scan (`sensitivity_scores`) on the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from shifu_tpu_torch.config import ColumnConfig
from shifu_tpu_torch.config.column_config import ColumnFlag


def _usable(cc: ColumnConfig) -> bool:
    return (
        cc.is_feature()
        and not cc.is_force_select()
        and cc.column_stats.ks is not None
        and cc.column_stats.iv is not None
    )


def pareto_front_order(points: List[Tuple[float, float]]) -> List[int]:
    """Indices ordered by successive pareto fronts (maximize both dims), the
    reference's sortByPareto (VariableSelector.java:393)."""
    remaining = list(range(len(points)))
    out: List[int] = []
    while remaining:
        front = []
        for i in remaining:
            dominated = any(
                points[j][0] >= points[i][0]
                and points[j][1] >= points[i][1]
                and (points[j][0] > points[i][0] or points[j][1] > points[i][1])
                for j in remaining
                if j != i
            )
            if not dominated:
                front.append(i)
        # within a front, order by ks desc
        front.sort(key=lambda i: -points[i][0])
        out.extend(front)
        in_front = set(front)
        remaining = [i for i in remaining if i not in in_front]
    return out


def select_by_filter(
    columns: List[ColumnConfig],
    filter_by: str,
    filter_num: int,
    filter_enable: bool = True,
) -> List[str]:
    """Set final_select in place; returns selected column names.

    Force-selected columns always count toward filter_num
    (VariableSelector.java:139-149)."""
    for c in columns:
        if not c.is_force_select():
            c.final_select = False

    selected: List[str] = []
    for c in columns:
        if c.is_force_select():
            c.final_select = True
            selected.append(c.column_name)

    if not filter_enable:
        return selected

    cands = [c for c in columns if _usable(c)]
    key = (filter_by or "KS").upper()
    if key == "IV":
        order = sorted(cands, key=lambda c: -(c.column_stats.iv or 0.0))
    elif key == "PARETO":
        pts = [(c.column_stats.ks or 0.0, c.column_stats.iv or 0.0) for c in cands]
        order = [cands[i] for i in pareto_front_order(pts)]
    elif key == "MIX":
        ks_sorted = sorted(cands, key=lambda c: -(c.column_stats.ks or 0.0))
        iv_sorted = sorted(cands, key=lambda c: -(c.column_stats.iv or 0.0))
        order, seen = [], set()
        for a, b in zip(ks_sorted, iv_sorted):
            for c in (a, b):
                if id(c) not in seen:
                    seen.add(id(c))
                    order.append(c)
    else:  # KS default
        order = sorted(cands, key=lambda c: -(c.column_stats.ks or 0.0))

    budget = max(0, filter_num - len(selected))
    for c in order[:budget]:
        c.final_select = True
        selected.append(c.column_name)
    return selected


@dataclass
class AutoFilterResult:
    removed: Dict[str, str]  # column -> reason


def auto_filter(
    columns: List[ColumnConfig],
    missing_rate_threshold: float = 0.98,
    min_ks: float = 0.0,
    min_iv: float = 0.0,
    correlation: Optional[np.ndarray] = None,
    correlation_names: Optional[List[str]] = None,
    correlation_threshold: float = 1.0,
) -> AutoFilterResult:
    """Flag obviously-bad candidates ForceRemove (VarSelectModelProcessor
    autoFilter: missing rate / minKs / minIv; correlation drop keeps the
    higher-IV member of each over-threshold pair)."""
    removed: Dict[str, str] = {}
    for c in columns:
        if not c.is_feature() or c.is_force_select():
            continue
        st = c.column_stats
        if (st.missing_percentage or 0.0) > missing_rate_threshold:
            removed[c.column_name] = (
                f"missing rate {st.missing_percentage:.3f} > {missing_rate_threshold}"
            )
        elif min_ks > 0 and st.ks is not None and st.ks < min_ks:
            removed[c.column_name] = f"ks {st.ks:.3f} < {min_ks}"
        elif min_iv > 0 and st.iv is not None and st.iv < min_iv:
            removed[c.column_name] = f"iv {st.iv:.3f} < {min_iv}"

    if (
        correlation is not None
        and correlation_names
        and correlation_threshold < 1.0
    ):
        by_name = {c.column_name: c for c in columns}
        n = len(correlation_names)
        for i in range(n):
            for j in range(i + 1, n):
                if abs(correlation[i, j]) < correlation_threshold:
                    continue
                a = by_name.get(correlation_names[i])
                b = by_name.get(correlation_names[j])
                if a is None or b is None:
                    continue
                if a.column_name in removed or b.column_name in removed:
                    continue
                drop = a if (a.column_stats.iv or 0) <= (b.column_stats.iv or 0) else b
                keep = b if drop is a else a
                if not drop.is_force_select():
                    removed[drop.column_name] = (
                        f"|corr|={abs(correlation[i, j]):.3f} with "
                        f"{keep.column_name} >= {correlation_threshold}"
                    )

    for c in columns:
        if c.column_name in removed:
            c.column_flag = ColumnFlag.FORCE_REMOVE
            c.final_select = False
    return AutoFilterResult(removed=removed)


def sensitivity_scores(
    params,
    activations: List[str],
    feats: np.ndarray,
    tags: np.ndarray,
    se_type: str = "SE",
    device=None,
) -> np.ndarray:
    """Per-column sensitivity: error increase when the column is knocked
    out to its mean (0 after z-scale). SE = mean squared delta of scores;
    ST = delta of MSE against labels (VarSelectMapper ColumnStatistics
    semantics). One forward a column on `device` (None = cuda), one host
    read at the end. Returns [C] float — higher = more important."""
    from shifu_tpu_torch.models.nn import forward
    from shifu_tpu_torch.utils.platform import resolve_device

    dev = resolve_device(device)
    layers = [{k: torch.as_tensor(np.asarray(v, np.float32), device=dev)
               for k, v in layer.items()} for layer in params]
    x = torch.as_tensor(np.array(feats, np.float32), device=dev)
    t = torch.as_tensor(np.asarray(tags, np.float32), device=dev)
    st = se_type.upper() == "ST"
    with torch.no_grad():
        col_means = torch.mean(x, dim=0)
        base = forward(layers, x, activations)[:, 0]
        base_mse = torch.mean((t - base) ** 2)
        scores = []
        for j in range(x.shape[1]):
            xj = x.clone()
            xj[:, j] = col_means[j]
            pj = forward(layers, xj, activations)[:, 0]
            scores.append(torch.mean((t - pj) ** 2) - base_mse if st
                          else torch.mean((base - pj) ** 2))
        return torch.stack(scores).cpu().numpy()

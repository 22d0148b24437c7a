"""All-pairs Pearson correlation of `shifu stats -correlation` (counterpart
of `column_correlation` in `shifu_tpu/stats/correlation.py`; the
chunked `StreamingCorrelation` is ROADMAP A.13).

corr = Z^T Z / (n - 1) for the mean-imputed, standardized column matrix,
on the device. The JAX function is f32 throughout; this one keeps its
f32 elementwise steps and its rounding points but accumulates every sum
(the column sums and the Gram matrix) in f64 and rounds each once to f32.
An f32 sum over 500k rows drifts by ~1e-5 with its order, which would
let the card and the CPU disagree; the f64 sums agree to the last f32
bit but for rare ties, and equal the JAX result where its sums are exact.
No TF32 enters: the product is f64.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from shifu_tpu_torch.config import ColumnConfig
from shifu_tpu_torch.data.reader import ColumnarData


def _corr_matrix(x: torch.Tensor) -> torch.Tensor:
    """x: [n, C] f32 with NaN for missing. Missing values are imputed with
    the column mean."""
    n = x.shape[0]
    denom = float(max(n - 1, 1))
    mask = ~torch.isnan(x)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    cnt = torch.clamp(mask.sum(0).to(x.dtype), min=1.0)
    mean = torch.where(mask, x, zero).double().sum(0).float() / cnt
    filled = torch.where(mask, x, mean[None, :])
    centered = filled - mean[None, :]
    ss = (centered * centered).double().sum(0).float()
    std = torch.sqrt(torch.clamp(ss / denom, min=1e-24))
    z = (centered / std[None, :]).double()
    return (z.T @ z).float() / denom


def feature_matrix(
    data: ColumnarData, columns: List[ColumnConfig]
) -> tuple[np.ndarray, List[str]]:
    """[n, C] float32 matrix over feature columns (NaN = missing);
    categorical columns enter via their bin pos-rate encoding (same trick
    the norm step uses)."""
    from shifu_tpu_torch.stats.binning import category_index

    mats = []
    names = []
    for cc in columns:
        if cc.is_target() or cc.is_meta() or cc.is_weight():
            continue
        if cc.is_categorical():
            rates = cc.column_binning.bin_pos_rate
            cats = cc.column_binning.bin_category
            if not rates or cats is None:
                continue
            idx = category_index(data, cc.column_name, cats)
            table = np.asarray(rates + [np.nan], dtype=np.float64)
            # bins beyond table (unseen) clamp to missing slot
            idx = np.clip(idx, 0, len(table) - 1)
            mats.append(table[idx].astype(np.float32))
        else:
            mats.append(data.numeric(cc.column_name).astype(np.float32))
        names.append(cc.column_name)
    if not mats:
        return np.zeros((0, 0), dtype=np.float32), []
    return np.stack(mats, axis=1), names


def column_correlation(
    data: ColumnarData, columns: List[ColumnConfig], device: torch.device
) -> tuple[np.ndarray, List[str]]:
    x, names = feature_matrix(data, columns)
    if not names:
        return np.zeros((0, 0)), []
    corr = _corr_matrix(torch.from_numpy(x).to(device))
    return corr.cpu().numpy(), names


def save_correlation_csv(path: str, corr: np.ndarray, names: List[str]) -> None:
    with open(path, "w") as fh:
        fh.write("," + ",".join(names) + "\n")
        for i, name in enumerate(names):
            row = ",".join(f"{corr[i, j]:.6f}" for j in range(len(names)))
            fh.write(f"{name},{row}\n")


def load_correlation_csv(path: str) -> tuple[np.ndarray, List[str]]:
    with open(path) as fh:
        header = fh.readline().rstrip("\n").split(",")[1:]
        rows = []
        for line in fh:
            rows.append([float(v) for v in line.rstrip("\n").split(",")[1:]])
    return np.asarray(rows), header

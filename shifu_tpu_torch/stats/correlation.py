"""All-pairs Pearson correlation of `shifu stats -correlation` (counterpart
of `column_correlation` and the streamed route's `StreamingCorrelation`
in `shifu_tpu/stats/correlation.py`).

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

from typing import List, Optional, Tuple

import numpy as np
import torch

from shifu_tpu_torch.config import ColumnConfig
from shifu_tpu_torch.data.reader import ColumnarData
from shifu_tpu_torch.obs import profile


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
    corr = profile.dispatch("stats.correlation", _corr_matrix,
                            torch.from_numpy(x).to(device), sync=False)
    return corr.cpu().numpy(), names


def _corr_moments(x: torch.Tensor):
    """Pairwise-complete accumulators of one chunk, four matmuls (the
    streaming analog of CorrelationWritable's adjusted sums,
    core/correlation/CorrelationMapper.java:50). The JAX function
    multiplies in f32; these products are f64."""
    mask = (~torch.isnan(x)).double()
    x0 = torch.nan_to_num(x.double(), nan=0.0)
    return (mask.T @ mask, x0.T @ mask, (x0 * x0).T @ mask, x0.T @ x0)


class StreamingCorrelation:
    """Chunked all-pairs Pearson with pairwise-complete missing handling,
    O(C^2) state. Chunks are shifted by the first chunk's column means
    before the moment products (Pearson is shift-invariant; without the
    shift columns with |mean| >> std cancel in the cov/var subtraction).
    Shards merging their sums must share the one shift the driver takes
    from the first chunk (`shift_of`)."""

    def __init__(self, device: torch.device,
                 shift: Optional[np.ndarray] = None):
        self.device = device
        self.names: List[str] = []
        self._acc: Optional[List[np.ndarray]] = None
        self._shift = (None if shift is None
                       else np.asarray(shift, dtype=np.float32))

    @staticmethod
    def shift_of(data: ColumnarData, columns: List[ColumnConfig]
                 ) -> Optional[np.ndarray]:
        x, names = feature_matrix(data, columns)
        if not names:
            return None
        with np.errstate(invalid="ignore"):
            shift = np.nanmean(x.astype(np.float64), axis=0)
        return np.nan_to_num(shift, nan=0.0).astype(np.float32)

    def update(self, data: ColumnarData, columns: List[ColumnConfig]
               ) -> None:
        x, names = feature_matrix(data, columns)
        if not names:
            return
        if not self.names:
            self.names = names
        if self._shift is None:
            self._shift = self.shift_of(data, columns)
        xt = torch.from_numpy(x - self._shift[None, :]).to(self.device)
        part = [a.cpu().numpy() for a in profile.dispatch(
            "stats.correlation_moments", _corr_moments, xt, sync=False)]
        if self._acc is None:
            self._acc = part
        else:
            for k in range(len(part)):
                self._acc[k] += part[k]

    def merge(self, other: "StreamingCorrelation") -> None:
        """Fold another shard's sums in (same columns, same shift)."""
        if other._acc is None:
            return
        if self._acc is None:
            self.names, self._acc = other.names, other._acc
            self._shift = other._shift
            return
        if self.names != other.names or not np.array_equal(self._shift,
                                                           other._shift):
            raise ValueError("cannot merge correlation accumulators over "
                             "different columns or shifts")
        for k in range(len(self._acc)):
            self._acc[k] += other._acc[k]

    def finalize(self) -> Tuple[np.ndarray, List[str]]:
        if self._acc is None:
            return np.zeros((0, 0)), []
        n, sx, sqx, cross = self._acc
        sy, sqy = sx.T, sqx.T
        n_safe = np.maximum(n, 1.0)
        cov = cross - sx * sy / n_safe
        var_x = np.maximum(sqx - sx * sx / n_safe, 0.0)
        var_y = np.maximum(sqy - sy * sy / n_safe, 0.0)
        denom = np.sqrt(var_x * var_y)
        with np.errstate(invalid="ignore", divide="ignore"):
            corr = np.where(denom > 0, cov / np.maximum(denom, 1e-300), 0.0)
        np.fill_diagonal(corr, 1.0)
        return corr, self.names


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

"""Bin aggregation of `shifu stats` on the device (counterpart of
`bin_aggregate` in `shifu_tpu/ops/binagg.py`; the streamed route folds
`bin_aggregate_exact` chunk by chunk in `data/pipeline.DeviceAccumulator`
where the JAX package folds f32 windows).

One pass over a flat (column offset + bin) slot space gives every
per-column per-bin count, the analog of the reference's UpdateBinningInfo
MR job (core/binning/UpdateBinningInfoMapper.java:71). The JAX function
is jnp lowered by XLA (no Pallas kernel), so this is plain PyTorch ops.

The JAX package sums everything in f32 in row order. On the card float
atomics would let the launch order decide the last bits, so:
  * `pos`/`neg` are int64 counts (`bincount`), exact at any row count
    (the JAX f32 counts stop counting past 2^24 rows in one slot);
  * `wpos`/`wneg` add the f32 weights in f64 (`index_add_`) and round
    once to f32: exact, so order-free, while the weights' exponents span
    fewer than about 29 - log2(n) bits;
  * `vsum`/`vsumsq` sum the f32 values and their f32 squares in f64 along
    each column (a reduction, no atomics) and round once to f32;
  * `vmin`, `vmax`, `vcount` and `vmissing` are exact.
On integral values with unit weights every field equals the JAX result.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class BinAggregates(NamedTuple):
    """Flat (column-offset + bin) histograms + per-numeric-column moments."""

    pos: torch.Tensor  # [total_slots] int64 positive counts
    neg: torch.Tensor  # [total_slots] int64 negative counts
    wpos: torch.Tensor  # [total_slots] f32 weighted positive
    wneg: torch.Tensor  # [total_slots] f32 weighted negative
    vsum: torch.Tensor  # [n_numeric] f32 sum of non-missing values
    vsumsq: torch.Tensor  # [n_numeric] f32 sum of squares
    vmin: torch.Tensor  # [n_numeric] f32
    vmax: torch.Tensor  # [n_numeric] f32
    vcount: torch.Tensor  # [n_numeric] int64 non-missing count
    vmissing: torch.Tensor  # [n_numeric] int64 missing count (valid-tag rows)


def bin_aggregate_exact(
    codes: torch.Tensor,  # [n, C] int32, per-column bin index (missing = last slot)
    col_offsets: torch.Tensor,  # [C] int32 prefix offsets into the flat slot space
    total_slots: int,
    tags: torch.Tensor,  # [n] int32 {1 pos, 0 neg, -1 invalid}
    weights: torch.Tensor,  # [n] float32
    values: torch.Tensor,  # [n, Cn] float32 numeric matrix, NaN = missing
) -> BinAggregates:
    """`bin_aggregate` before its one rounding: the weighted counts and
    the moment sums stay f64, so folds of chunks add exactly."""
    valid = tags >= 0
    counted = (tags == 0) | (tags == 1)
    n, c = codes.shape
    flat = codes.long() + col_offsets.long()[None, :]  # [n, C]
    # slot * 2 + (tag == 1): negatives at even, positives at odd indices
    idx = (flat * 2 + (tags == 1).long()[:, None])[counted].reshape(-1)
    counts = torch.bincount(idx, minlength=2 * total_slots).view(
        total_slots, 2)
    w = weights[counted].double()[:, None].expand(-1, c).reshape(-1)
    wsum = torch.zeros(2 * total_slots, dtype=torch.float64,
                       device=codes.device).index_add_(0, idx, w)
    wsum = wsum.view(total_slots, 2)

    missing = torch.isnan(values)
    vvalid = ~missing & valid[:, None]
    v0 = torch.where(vvalid, values, torch.zeros((), dtype=values.dtype,
                                                 device=values.device))
    vsum = v0.double().sum(0)
    vsumsq = (v0 * v0).double().sum(0)
    inf = torch.tensor(float("inf"), dtype=values.dtype, device=values.device)
    if n:
        vmin = torch.where(vvalid, values, inf).amin(0)
        vmax = torch.where(vvalid, values, -inf).amax(0)
    else:
        vmin = inf.expand(values.shape[1]).clone()
        vmax = (-inf).expand(values.shape[1]).clone()
    vcount = vvalid.sum(0)
    vmissing = (missing & valid[:, None]).sum(0)
    return BinAggregates(counts[:, 1], counts[:, 0], wsum[:, 1], wsum[:, 0],
                         vsum, vsumsq, vmin, vmax, vcount, vmissing)


def bin_aggregate(
    codes: torch.Tensor,
    col_offsets: torch.Tensor,
    total_slots: int,
    tags: torch.Tensor,
    weights: torch.Tensor,
    values: torch.Tensor,
) -> BinAggregates:
    """The aggregates of one pass, every f64 sum rounded once to f32."""
    agg = bin_aggregate_exact(codes, col_offsets, total_slots, tags,
                              weights, values)
    return agg._replace(wpos=agg.wpos.float(), wneg=agg.wneg.float(),
                        vsum=agg.vsum.float(), vsumsq=agg.vsumsq.float())

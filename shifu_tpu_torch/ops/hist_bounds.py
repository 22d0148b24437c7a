"""The work of the histogram and scan entries, counted: the bytes each
call must move (each input read once, each output written once) and the
operations it does, the counts behind each entry's roofline bound.

`chip_smoke.py` turns them into the bound times it prints beside each
kernel's measured time (`bound_ms`: the larger of bytes over the card's
memory rate and operations over its f32 rate), and the profile seams of
the tree grower (obs/profile.py, `costSource: "analytic"`) record them
as each dispatch's `flops` and `bytesAccessed`: one count for both.

`n_live` is the rows that carry weight in the call. A profile seam
cannot count them without reading the device (a sync the hot path does
not have), so its cost counts every row as live: the bound at
`n_live = n_rows`, an upper bound of the work.
"""

from __future__ import annotations

from typing import Tuple

# NVIDIA H100 SXM data sheet: HBM rate and f32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def bound_ms(ops: float, n_bytes: float) -> Tuple[float, str]:
    """(bound ms, 'bytes' or 'operations'): the larger of the two times."""
    b_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    o_ms = ops / F32_OPS_PER_S * 1e3
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


def level_counts(n_rows: int, n_live: int, F: int, code_bytes: int,
                 comp_bytes: int, L: int, T: int, s_max: int,
                 fused: bool) -> Tuple[float, float]:
    """(operations, bytes) of one moment level: the codes and component
    planes of the rows that carry weight, node ids and the row mask of
    every row, each read once; the histogram (and in fused mode the scan
    outputs) written once. Operations: 3 adds per live (row, feature),
    and ~40 f32 ops per (node, slot) for the scan."""
    read = (n_live * (F * code_bytes + 3 * comp_bytes)
            + n_rows * (4 + 1))
    write = 3 * L * T * 4
    ops = 3 * n_live * F
    if fused:
        # rank_flat i32, left_mask, 7 per-node fields
        write += L * T * 4 + L * s_max + 7 * L * 4
        ops += 40 * L * T
    return float(ops), float(read + write)


def class_level_counts(n_rows: int, n_live: int, F: int, code_bytes: int,
                       K: int, L: int, T: int,
                       fused: bool) -> Tuple[float, float]:
    """(operations, bytes) of one multi-class level: the codes (n*F), the
    class ids, weights and node ids (4 + 4 + 4 bytes a row) read once,
    the [K, L, T] f32 planes written once, and in scan mode the
    gain/rank/left-count planes and [L, K] totals. Operations: one add
    per live (row, feature), ~12 per class and ~20 more per (node, slot)
    for the class scan."""
    n_bytes = n_rows * F * code_bytes + n_rows * 12 + K * L * T * 4
    ops = n_live * F
    if fused:
        n_bytes += 3 * L * T * 4 + L * K * 4
        ops += L * T * (12 * K + 20)
    return float(ops), float(n_bytes)


def finalize_bytes(P: int, L: int, T: int) -> float:
    """The fused entry's finalize kernel: the int64 accumulator
    [P, L, T] and feat_ok read once, the f32 histogram, gain/rank/left
    count [L, T] and node totals [L, P] written once."""
    return float(P * L * T * (8 + 4) + T + L * T * 12 + L * P * 4)


def convert_bytes(P: int, L: int, T: int) -> float:
    """The histogram-only entries' finalize (convert only): the int64
    accumulator [P, L, T] read once, the f32 histogram written once."""
    return float(P * L * T * (8 + 4))


def scan_counts(P: int, L: int, lay, K: int) -> Tuple[float, float]:
    """(operations, bytes) of one scan-only entry call: the f32 planes
    [P, L, T] and feat_ok read once, gain/rank/left count [L, T] and
    node totals [L, P] written once. Operations: the pairwise rank of
    this layout's categorical segments (size^2 a node), ~40 f32 ops per
    (node, slot), ~12 per class and ~20 more in class mode."""
    T = lay.T
    n_bytes = P * L * T * 4 + T + L * T * 12 + L * P * 4
    cat = sum(int(s) ** 2 for s, o in zip(lay.slots, lay.off)
              if lay.is_cat_t[o])
    ops = L * (cat + T * ((12 * K + 20) if K >= 3 else 40))
    return float(ops), float(n_bytes)


def accumulate_bytes(n_rows: int, n_live: int, F: int, code_bytes: int,
                     P: int, L: int, T: int) -> float:
    """A level's pre-pass + accumulate: the label, weight, node id and
    active flag of every row (13 bytes) and the codes of the live rows
    read once, the int64 accumulator [P, L, T] written once."""
    return float(n_rows * 13 + n_live * F * code_bytes + P * L * T * 8)


# ---- the profile seams' costs: (flops, bytes) of one entry call ----


def _level_cost(codes, L: int, lay, low_precision: bool, codes8,
                n_classes: int, fused: bool) -> Tuple[float, float]:
    n, F = int(codes.shape[0]), int(codes.shape[1])
    code_bytes = 1 if codes8 is not None else codes.element_size()
    if n_classes >= 3:
        return class_level_counts(n, n, F, code_bytes, n_classes, L, lay.T,
                                  fused)
    return level_counts(n, n, F, code_bytes, 2 if low_precision else 4, L,
                        lay.T, lay.s_max, fused)


def hist_cost(codes, labels, weights, node_slot, active, *, L: int, lay,
              low_precision: bool = False, codes8=None, n_classes: int = 0,
              **_kw) -> Tuple[float, float]:
    """Cost of one `hist_level` / `hist_level_acc` call."""
    return _level_cost(codes, L, lay, low_precision, codes8, n_classes,
                       fused=False)


def fused_cost(codes, labels, weights, node_slot, active, feat_ok_t, *,
               L: int, lay, low_precision: bool = False, codes8=None,
               n_classes: int = 0, **_kw) -> Tuple[float, float]:
    """Cost of one `fused_level` call."""
    return _level_cost(codes, L, lay, low_precision, codes8, n_classes,
                       fused=True)


def scan_cost(hist, feat_ok_t, *, lay, n_classes: int = 0,
              **_kw) -> Tuple[float, float]:
    """Cost of one `scan_level` call."""
    return scan_counts(int(hist.shape[0]), int(hist.shape[1]), lay,
                       n_classes)

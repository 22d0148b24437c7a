"""Tree-level histogram -> split scan: CUDA kernel wrappers and their plain
PyTorch versions.

Counterpart of `shifu_tpu/ops/hist_pallas.py`. Three entries, each with
a plain version that takes the same arguments and returns the same
outputs:

    hist_level(codes, labels, weights, node_slot, active, *, L, lay, ...)
        -> hist [C, L, T] f32                (make_pallas_hist_fn)
    fused_level(codes, labels, weights, node_slot, active, feat_ok_t, *,
                L, lay, impurity, min_inst, min_gain, ...)
        -> (hist [C, L, T], scan 9-tuple)    (make_fused_level_fn)
    scan_level(hist, feat_ok_t, *, lay, impurity, min_inst, min_gain,
               n_classes)
        -> scan 9-tuple of an f32 histogram already on the device (the
           JAX package's XLA scan `_make_scan_fn`: the derived sibling of
           a subtraction level, the levels past 32 nodes)

All take `n_classes`, as the JAX entries do. Below 3 the planes are the
C = 3 moments (w, w*y, w*y^2); from 3 up (NATIVE multi-class RF) they are
C = K weighted per-class counts, `labels` holds class indices, and the
scan is the K-class gini/entropy scan with majority-class leaf values
(`tree_trainer.cls_scan`). The scan 9-tuple is the reference split
scan's: (feature, cut_rank, rank_flat, leaf_value, is_split, best_gain,
left_mask, node_cnt, left_cnt).

On CPU tensors a wrapper runs its plain version; on CUDA tensors it
launches the kernels of `csrc/hist_level.cu` or raises — there is no
fallback and no mode knob. A histogram entry is three launches: the
pre-pass (the entry's prep, and the live rows grouped by node tile), the
accumulate and the finalize; the scan entry is one. The scan kernels
write per-slot planes (gain, rank, left count, node totals:
`scan_planes_reference` is their plain version) that a shared torch
epilogue turns into the 9-tuple; segments wider than the cap take the
torch scan there. Each entry counts its kernel launches and its
plain-version calls in plain integers (`launches`, `reference_calls`),
the multi-class mode under its own names (`hist_level_mc`,
`fused_level_mc`, `scan_level_mc`).

Precision policy (the JAX package's): GBT comps travel bf16, rounded once
when the planes are built, and sum in (here: fixed-point, then) f32; RF
planes stay f32 so integer-weight counts are exact. Codes travel int8
when every feature fits 128 slots (`codes8_of`, rows padded to 16
bytes), else int32. `int_planes` (the trainer's `int_planes_of`, once a
forest) lets the kernels sum integer planes in 32-bit shared bins; the
planes are the same bits either way. `hist_level_fixed_reference` is the
kernels' exact yardstick: the same 64-bit fixed point, computed plainly.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

# widest feature segment the kernel scans itself; wider ones (the bench
# gbt_wide 2001-slot column) are scanned by the torch split scan on just
# their columns — static routing by shape, as in the JAX package
SEG_CAP = 1024
# an accumulate tile holds TILE_SLOTS slots over all its planes, within
# 16-48 KiB of shared memory (bins and feature table), so four 256-thread
# blocks share an SM's 228 KB (the sizes measured fastest on the H100,
# PERF.md)
TILE_SLOTS = 384
TILE_MIN, TILE_MAX = 16 * 1024, 48 * 1024
# shared memory one Hopper block may opt in to
SMEM_BLOCK_MAX = 232_448
# widest segment one warp of the scan kernels takes (2 slots a lane: the
# bench layouts' 33-slot segments take a warp, their 65-slot ones a block),
# the fewest such segments a level needs for warps to pay (below it every
# segment takes a block, whose latency is lower), both the fastest split
# measured on the H100; and the most warps a 256-thread scan block holds
WARP_SLOTS = 64
WARP_JOBS_MIN = 512
SCAN_WARPS = 8
# int8 codes hold every feature whose clipped code fits 0..127
_I8_SLOTS = 128
# int8 code rows are padded to this many bytes (16-byte loads)
_ROW_ALIGN = 16
# largest |value| a row adds to a 32-bit shared bin
INT32_VMAX = 2 ** 24

_IMPURITY = {"variance": 0, "friedmanmse": 1, "entropy": 2, "gini": 3}

_ENTRIES = ("hist_level", "fused_level", "scan_level", "hist_level_mc",
            "fused_level_mc", "scan_level_mc")
launches: Dict[str, int] = {k: 0 for k in _ENTRIES}
reference_calls: Dict[str, int] = {k: 0 for k in _ENTRIES}


def reset_counters() -> None:
    for d in (launches, reference_calls):
        for k in d:
            d[k] = 0


def _tt():
    from shifu_tpu_torch.train import tree_trainer

    return tree_trainer


def codes8_of(codes: torch.Tensor, lay) -> torch.Tensor:
    """[n, F] int codes -> int8 planes (counterpart of make_codes8_fn):
    exact for every feature with <= 128 slots; wider columns clamp. The
    rows are padded to a multiple of 16 bytes (the view drops the pad),
    so the accumulate kernel reads them 16 bytes at a time."""
    n, F = codes.shape
    width = max(_ROW_ALIGN, -(-F // _ROW_ALIGN) * _ROW_ALIGN)
    cap = torch.as_tensor(np.minimum(lay.clip_max, _I8_SLOTS - 1),
                          device=codes.device)
    buf = torch.zeros((n, width), dtype=torch.int8, device=codes.device)
    buf[:, :F] = torch.minimum(codes.clamp_min(0), cap[None, :])
    return buf[:, :F]


def _entry(name: str, n_classes: int) -> str:
    return name + "_mc" if n_classes >= 3 else name


def planes_of(n_classes: int) -> int:
    return n_classes if n_classes >= 3 else 3


def seg_cap_for(planes: int, smem_optin: int) -> int:
    """Widest segment the scan kernels scan themselves with `planes`
    planes: SEG_CAP, or fewer slots where (2 * planes + 3) words a slot
    of dynamic shared memory pass what a block may opt in to (K = 32
    class planes: 867 slots in 227 KB). Wider segments take the torch
    scan on their columns."""
    return max(0, min(SEG_CAP, smem_optin // ((2 * planes + 3) * 4)))


def _prep(labels, weights, node_slot, active, L: int, low_precision: bool,
          n_classes: int = 0):
    """The plain versions' prep: component planes [n, C] (inactive rows
    zeroed through the weight, bf16 for GBT; one weighted count plane a
    class for n_classes >= 3) and node ids clamped to [0, L), 0 for
    inactive rows."""
    comps = _tt().comps_of(labels, weights, active, low_precision,
                           n_classes)
    nl = torch.where(active, node_slot.clamp(0, L - 1),
                     torch.zeros_like(node_slot)).to(torch.int32)
    return comps, nl


def _live_rows(codes, comps, nl, active):
    """The active rows only: an inactive row adds zeros, so dropping it
    leaves every slot's sum as it was (the leaf-wise grower builds one
    leaf's rows out of all n at a time)."""
    if bool(active.all()):
        return codes, comps, nl
    idx = torch.nonzero(active).squeeze(1)
    return codes[idx], comps[idx], nl[idx]


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def hist_level_reference(codes, labels, weights, node_slot, active, *,
                         L: int, lay, low_precision: bool = False,
                         codes8=None, n_classes: int = 0,
                         int_planes: bool = False) -> torch.Tensor:
    """Plain version of `hist_level`: index_add_ over the flat
    node*T + off[f] + clip(code) slot of every (row, feature)."""
    reference_calls[_entry("hist_level", n_classes)] += 1
    comps, nl = _prep(labels, weights, node_slot, active, L, low_precision,
                      n_classes)
    codes, comps, nl = _live_rows(codes, comps, nl, active)
    return _tt().hist_scatter(codes, comps.float(), nl, L, lay)


def fused_level_reference(codes, labels, weights, node_slot, active,
                          feat_ok_t, *, L: int, lay, impurity: str,
                          min_inst: int, min_gain: float,
                          low_precision: bool = False, codes8=None,
                          n_classes: int = 0, int_planes: bool = False):
    """Plain version of `fused_level`: the plain histogram, then the
    reference split scan (the class scan for n_classes >= 3) over it."""
    reference_calls[_entry("fused_level", n_classes)] += 1
    tt = _tt()
    comps, nl = _prep(labels, weights, node_slot, active, L, low_precision,
                      n_classes)
    hist = tt.hist_scatter(*_live_rows(codes, comps.float(), nl, active), L,
                           lay)
    sl = tt.scan_layout(lay, hist.device)
    return hist, tt.scan_of(n_classes)(hist, feat_ok_t, sl, impurity,
                                       min_inst, min_gain)


def scan_planes_reference(hist, feat_ok_t, lay, impurity: str,
                          min_inst: int, min_gain: float, n_classes: int = 0,
                          cap: int = SEG_CAP):
    """Plain version of the scan kernels' per-slot outputs over an f32
    [P, L, T] histogram, per (node, segment): the stable rank on (key,
    slot) (numeric: the slot), the ordered left sums and the segment
    totals in f64 rounded once to f32, the gain (`moment_gain` /
    `class_gain`) and its validity. Segments wider than `cap` are left to
    the torch scan: rank = slot, gain -inf, left count 0. Returns (gain
    [L, T] f32 (-inf where invalid), rank [L, T] i32, lcnt [L, T] f32,
    tot0 [L, P] f32, segment 0's totals)."""
    tt = _tt()
    P, L, T = hist.shape
    dev = hist.device
    gain = torch.full((L, T), float("-inf"), device=dev)
    rank = torch.zeros((L, T), dtype=torch.int32, device=dev)
    lcnt = torch.zeros((L, T), device=dev)
    tot0 = torch.zeros((L, P), device=dev)
    sizes = [int(s) for s in lay.slots]
    for sz in sorted(set(sizes)):  # the segments of one width together
        fs = [f for f, s in enumerate(sizes) if s == sz]
        cols = torch.as_tensor(np.asarray(
            [np.arange(int(lay.off[f]), int(lay.off[f]) + sz) for f in fs],
            np.int64), device=dev)  # [nf, sz]
        h = hist[:, :, cols]  # [P, L, nf, sz]
        slot = torch.arange(sz, device=dev)
        f0 = fs.index(0) if 0 in fs else None
        if sz > cap:
            rank[:, cols] = slot.to(torch.int32).expand(L, len(fs), sz)
            if f0 is not None:
                tot0 = h[:, :, f0].double().sum(-1).float().T
            continue
        if n_classes >= 3:
            cnt = tt.class_sum(h)
            num = torch.zeros_like(cnt)
            for c in range(P):
                num = num + float(c) * h[c]
        else:
            cnt, num = h[0], h[1]
        mean = torch.where(cnt > 0, num / cnt.clamp_min(1e-12),
                           torch.full_like(cnt, float("inf")))
        is_cat = torch.as_tensor(lay.is_cat_t[lay.off[fs]], device=dev)
        key = torch.where(is_cat[None, :, None], mean,
                          slot.to(torch.float32).expand_as(mean))
        order = torch.argsort(key, dim=-1, stable=True)  # slot at each rank
        r = torch.empty_like(order).scatter_(-1, order,
                                             slot.expand_as(order))
        pre = torch.cumsum(h.gather(-1, order.expand_as(h)).double(),
                           dim=-1).float()  # in rank order
        left = pre.gather(-1, r.expand_as(h))
        tot = pre[..., -1:].expand_as(left)
        if n_classes >= 3:
            g, lc, rc = tt.class_gain(left, tot, impurity == "entropy")
        else:
            g, lc, rc = tt.moment_gain(impurity, left, tot)
        valid = ((lc >= min_inst) & (rc >= min_inst) & (g > min_gain)
                 & feat_ok_t[cols][None] & (r < sz - 1))
        gain[:, cols] = torch.where(valid, g, torch.full_like(g,
                                                          float("-inf")))
        rank[:, cols] = r.to(torch.int32)
        lcnt[:, cols] = lc
        if f0 is not None:
            tot0 = pre[:, :, f0, -1].T
    return gain, rank, lcnt, tot0.contiguous()


# ---------------------------------------------------------------------------
# the kernels' fixed point, plainly: the exact yardstick
# ---------------------------------------------------------------------------


def plane_shift(maxabs: float, n: int) -> int:
    """The kernels' fixed-point shift S of a plane: every bin sum is at
    most n * max|v| < 2^e, so sums of v * 2^(61 - e) stay below 2^61."""
    return 61 - math.frexp(float(maxabs) * float(n))[1]


def _shifts(maxabs: torch.Tensor, n: int, planes: int):
    """Per-plane shifts: the K class planes share one (from max|w|)."""
    s = [plane_shift(m, n) for m in maxabs.tolist()]
    return s * planes if len(s) == 1 else s


def fixed_acc_reference(codes, labels, weights, node_slot, active, *,
                        L: int, lay, low_precision: bool = False,
                        n_classes: int = 0):
    """The kernels' int64 accumulator, plainly: round(v * 2^S) in f64
    (half to even, as llrint) of every plane value, int64 index_add_ over
    the flat node*T + off[f] + clip(code) slot. Returns (acc [P, L, T]
    int64, maxabs [1 (class planes) or 3] f32)."""
    comps, nl = _prep(labels, weights, node_slot, active, L, low_precision,
                      n_classes)
    comps = comps.float()
    n, F = codes.shape
    T = lay.T
    # class planes share one shift, from max|w| (a row's weight sits in
    # one plane)
    mags = comps.abs().amax(1, keepdim=True) if n_classes >= 3 else comps.abs()
    maxabs = (mags.amax(0) if n else
              torch.zeros(mags.shape[1], device=codes.device))
    S = _shifts(maxabs, n, comps.shape[1])
    scale = torch.tensor([2.0 ** s for s in S], dtype=torch.float64,
                         device=codes.device)
    q = torch.round(comps.double() * scale[None, :]).to(torch.int64)
    off = torch.as_tensor(np.asarray(lay.off, np.int64), device=codes.device)
    clip = torch.as_tensor(np.asarray(lay.clip_max, np.int64),
                           device=codes.device)
    code = torch.minimum(codes.long().clamp_min(0), clip[None, :])
    flat = (nl.long()[:, None] * T + off[None, :] + code).reshape(-1)
    acc = torch.zeros((comps.shape[1], L * T), dtype=torch.int64,
                      device=codes.device)
    for c in range(comps.shape[1]):
        acc[c].index_add_(0, flat, q[:, c:c + 1].expand(n, F).reshape(-1))
    return acc.reshape(-1, L, T), maxabs


def fixed_planes(acc: torch.Tensor, maxabs: torch.Tensor,
                 n: int) -> torch.Tensor:
    """int64 accumulator -> f32 planes, as hist_finalize_kernel converts
    them: (float)((double)acc * 2^-S)."""
    S = _shifts(maxabs, n, acc.shape[0])
    inv = torch.tensor([2.0 ** -s for s in S], dtype=torch.float64,
                       device=acc.device)
    return (acc.double() * inv[:, None, None]).float()


def _device_shifts(maxabs: torch.Tensor, n: int, planes: int) -> torch.Tensor:
    """`_shifts` on the device, without a host read: [planes] int."""
    s = 61 - torch.frexp(maxabs.double() * float(n)).exponent.long()
    return s.expand(planes)


def merge_acc(parts) -> torch.Tensor:
    """f32 planes of the rows of several `hist_level_acc` calls, as one
    call over all of them converts them: each call's sums rescaled to the
    shift of the total (n summed, max|v| the largest), added in int64,
    converted once. Exact, so the planes of one call over every row, while
    each plane value is a multiple of the total's unit (2^-S, about
    2^-42 at 500,000 rows of unit-scale values). The parts may lie on
    several devices (a mesh's shards): each part's sums and max|v| are
    copied to the first part's device, where they add in part order."""
    lead = parts[0][0].device
    parts = [(acc.to(lead, non_blocking=True),
              m.to(lead, non_blocking=True), rows)
             for acc, m, rows in parts]
    P = parts[0][0].shape[0]
    n = sum(int(p[2]) for p in parts)
    maxabs = torch.stack([p[1] for p in parts]).amax(0)
    s_all = _device_shifts(maxabs, n, P)
    total = torch.zeros_like(parts[0][0])
    for acc, m, rows in parts:
        shift = _device_shifts(m, rows, P) - s_all
        total += torch.bitwise_right_shift(acc, shift[:, None, None])
    inv = torch.ldexp(torch.ones(P, dtype=torch.float64,
                                 device=total.device), -s_all)
    return (total.double() * inv[:, None, None]).float()


def hist_level_fixed_reference(codes, labels, weights, node_slot, active, *,
                               L: int, lay, low_precision: bool = False,
                               n_classes: int = 0) -> torch.Tensor:
    """The exact fixed-point plain version of the kernels' planes: what
    `hist_level` computes on the card, bit for bit in every mode (GBT's
    float moments included). Used by the tests and chip_smoke.py, never
    by the main path."""
    acc, maxabs = fixed_acc_reference(
        codes, labels, weights, node_slot, active, L=L, lay=lay,
        low_precision=low_precision, n_classes=n_classes)
    return fixed_planes(acc, maxabs, codes.shape[0])


# ---------------------------------------------------------------------------
# the accumulate plan, and plain versions of the pre-pass and accumulate
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AccPlan:
    """How the accumulate cuts a level: node groups of `l_n` nodes, and
    slot ranges `ttiles` [n_tt, 5] (f_lo, f_hi, t_lo, t_w, features of the
    ranges before) that end on feature boundaries (a feature wider than a
    tile is split); a tile is one group x one slot range. `NF` features
    in all; `smem` bytes of shared memory a block: a `tab_bytes` feature
    table, then planes x l_n x (widest t_w) bins of 4 (`bins32`) or 8
    bytes."""

    planes: int
    bins32: bool
    l_n: int
    n_groups: int
    ttiles: np.ndarray
    NF: int
    tab_bytes: int
    smem: int


def _align16(x: int) -> int:
    return -(-x // 16) * 16


def tile_bytes_for(planes: int, bins32: bool) -> int:
    """Shared memory of one accumulate tile (see TILE_SLOTS)."""
    return min(TILE_MAX, max(TILE_MIN,
                             planes * (4 if bins32 else 8) * TILE_SLOTS))


def plan_accumulate(lay, L: int, n_classes: int = 0, bins32: bool = False,
                    tile_bytes: Optional[int] = None) -> AccPlan:
    """Tiles of at most `tile_bytes` (`tile_bytes_for`) of shared memory:
    slot ranges packed greedily from whole features, then as many nodes a
    group as the widest range leaves room for."""
    P = planes_of(n_classes)
    tile = (tile_bytes_for(P, bins32) if tile_bytes is None
            else int(tile_bytes))
    bb = P * (4 if bins32 else 8)  # bytes of one slot over all planes
    cap1 = (tile - 16) // bb  # slots of a one-feature, one-node tile
    if cap1 < 1:
        raise ValueError(f"{P} planes do not fit a {tile}-byte tile")
    ranges = []
    cur = None  # [f_lo, f_hi, t_lo, t_w]
    for f, s in enumerate(int(x) for x in lay.slots):
        o = int(lay.off[f])
        if s > cap1:  # wider than a tile: split over several
            if cur is not None:
                ranges.append(cur)
                cur = None
            ranges += [[f, f + 1, o + a, min(cap1, s - a)]
                       for a in range(0, s, cap1)]
        elif (cur is not None and (cur[3] + s) * bb
              + _align16(8 * (cur[1] - cur[0] + 1)) <= tile):
            cur[1], cur[3] = f + 1, cur[3] + s
        else:
            if cur is not None:
                ranges.append(cur)
            cur = [f, f + 1, o, s]
    if cur is not None:
        ranges.append(cur)
    if not ranges:
        raise ValueError("the layout has no features")
    nf = [r[1] - r[0] for r in ranges]
    before = np.cumsum([0] + nf[:-1])
    ttiles = np.asarray([r + [int(b)] for r, b in zip(ranges, before)],
                        np.int32)
    max_tw = int(ttiles[:, 3].max())
    tab_bytes = _align16(8 * max(nf))
    l_n = max(1, min(L, (tile - tab_bytes) // max(1, bb * max_tw)))
    n_groups = -(-L // l_n)
    l_n = -(-L // n_groups)
    return AccPlan(planes=P, bins32=bool(bins32), l_n=l_n, n_groups=n_groups,
                   ttiles=ttiles, NF=int(sum(nf)), tab_bytes=tab_bytes,
                   smem=tab_bytes + bb * l_n * max_tw)


def group_rows_reference(labels, weights, node_slot, active, *, L: int,
                         plan: AccPlan, low_precision: bool = False,
                         n_classes: int = 0):
    """Plain version of the pre-pass (`hist_group_kernel`): the entry's
    prep, and the live rows (active, weight != 0) counting-sorted by node
    group. Returns (gstart [groups + 1], rows [live], meta [live] = node
    in group | class << 16, vals [live, 1 or 3] f32 (w, or the moments,
    bf16-rounded for GBT), maxabs [1 or 3]), all int64 but vals and
    maxabs; rows keep row order inside a group (the kernel's order there
    is any)."""
    w = torch.where(active, weights, torch.zeros_like(weights))
    live = w != 0
    nl = node_slot.long().clamp(0, L - 1)
    if n_classes >= 3:
        cls = labels.to(torch.int32).clamp(0, n_classes - 1).long()
        vals = w[:, None]
    else:
        cls = torch.zeros_like(nl)
        wy = w * labels
        vals = torch.stack([w, wy, wy * labels], dim=1)
        if low_precision:
            vals = vals.to(torch.bfloat16).float()
    idx = torch.nonzero(live)[:, 0]
    g = nl[idx] // plan.l_n
    order = torch.argsort(g, stable=True)
    rows, g = idx[order], g[order]
    counts = torch.bincount(g, minlength=plan.n_groups)
    gstart = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    meta = (nl[rows] - g * plan.l_n) | (cls[rows] << 16)
    maxabs = (vals[rows].abs().amax(0) if len(rows) else
              torch.zeros(vals.shape[1], device=vals.device))
    return gstart, rows, meta, vals[rows], maxabs


def accumulate_reference(codes, grouped, *, L: int, lay, plan: AccPlan,
                         n: int, blocks: int = 7) -> torch.Tensor:
    """Plain version of `hist_accumulate_kernel` over the pre-pass's
    groups, step for step: the pairs of all tiles cut into `blocks` equal
    spans, each block's rows of each tile summed in its own bins (32-bit
    bins: the integer values, flushed times 2^S every row_cap rows, a row
    whose values are not integers of at most 2^24 going to the global
    accumulator as round(v * 2^S); 64-bit bins: round(v * 2^S)), and the
    flush into the int64 accumulator. Raises if a 32-bit bin would pass
    2^31 - 1. Returns acc [P, L, T] int64."""
    gstart, rows, meta, vals, maxabs = grouped
    dev = vals.device
    P, T, NF = plan.planes, lay.T, plan.NF
    S = _shifts(maxabs, n, P)
    scale = torch.tensor([2.0 ** s for s in S[:vals.shape[1]]],
                         dtype=torch.float64, device=dev)
    vmax = max([1.0] + [min(float(m), INT32_VMAX) for m in maxabs.tolist()])
    fits32 = plan.bins32 and min(S) >= 0
    row_cap = (int((2 ** 31 - 1) / math.ceil(vmax)) if plan.bins32
               else 1 << 62)
    off = torch.as_tensor(np.asarray(lay.off, np.int64), device=dev)
    clip = torch.as_tensor(np.asarray(lay.clip_max, np.int64), device=dev)
    acc = torch.zeros(P * L * T, dtype=torch.int64, device=dev)
    gs_all = [int(x) for x in gstart.tolist()]
    W = gs_all[-1] * NF
    for b in range(blocks):
        w0, w1 = W * b // blocks, W * (b + 1) // blocks
        if w0 >= w1:
            continue
        for g in range(plan.n_groups):
            gs, cnt = gs_all[g], gs_all[g + 1] - gs_all[g]
            if gs * NF >= w1:
                break
            if cnt == 0:
                continue
            l_lo = g * plan.l_n
            lg = min(plan.l_n, L - l_lo)
            for f_lo, f_hi, t_lo, t_w, nf_pre in plan.ttiles.tolist():
                nf = f_hi - f_lo
                ts = gs * NF + cnt * nf_pre
                if ts >= w1:
                    break
                if ts + cnt * nf <= w0:
                    continue
                ra = -(-(w0 - ts) // nf) if w0 > ts else 0
                rb = min(cnt, -(-(w1 - ts) // nf))
                for c0 in range(ra, rb, row_cap):
                    seg = slice(gs + c0, gs + min(rb, c0 + row_cap))
                    _tile_rows(acc, codes, rows[seg], meta[seg], vals[seg],
                               off, clip, f_lo, f_hi, t_lo, t_w, l_lo, lg,
                               L, T, S, scale, plan.bins32, fits32)
    return acc.reshape(P, L, T)


def _tile_rows(acc, codes, rows, meta, vals, off, clip, f_lo, f_hi, t_lo,
               t_w, l_lo, lg, L, T, S, scale, bins32, fits32):
    """One block's rows of one tile (accumulate_reference): shared bins
    [P, lg, t_w], then the flush."""
    cls_mode = vals.shape[1] == 1
    P = acc.numel() // (L * T)
    nbins = lg * t_w
    l = meta & 0xFFFF
    c = meta >> 16
    code = torch.minimum(codes[rows][:, f_lo:f_hi].long().clamp_min(0),
                         clip[None, f_lo:f_hi])
    t = off[None, f_lo:f_hi] + code - t_lo
    ok = (t >= 0) & (t < t_w)
    q64 = torch.round(vals.double() * scale[None, :]).to(torch.int64)
    if bins32:
        in_smem = (fits32 & (vals == torch.trunc(vals))
                   & (vals.abs() <= INT32_VMAX)).all(1)
        q = torch.where(in_smem[:, None], vals.to(torch.int64), 0)
    else:
        in_smem = torch.ones(len(rows), dtype=torch.bool, device=vals.device)
        q = q64
    bins = torch.zeros(P * nbins, dtype=torch.int64, device=vals.device)
    nv = vals.shape[1]
    for j in range(nv):
        plane = c if cls_mode else torch.full_like(c, j)
        sh = ok & in_smem[:, None]
        idx = (plane * nbins + l * t_w)[:, None] + t
        bins.index_add_(0, idx[sh], q[:, j:j + 1].expand_as(t)[sh])
        gl = ok & ~in_smem[:, None]
        gidx = ((plane * L + l_lo + l) * T + t_lo)[:, None] + t
        acc.index_add_(0, gidx[gl], q64[:, j:j + 1].expand_as(t)[gl])
    k = torch.arange(P * nbins, device=vals.device)
    cc, rem = k // nbins, k % nbins
    if bins32:
        if bool((bins.abs() > 2 ** 31 - 1).any()):
            raise OverflowError("a 32-bit shared bin passed 2^31 - 1")
        # S >= 0 wherever a bin is not 0
        mult = torch.tensor([1 << s if s >= 0 else 0 for s in S],
                            dtype=torch.int64, device=vals.device)
        bins = bins * mult[cc]
    dst = (cc * L + l_lo + rem // t_w) * T + t_lo + rem % t_w
    acc.index_add_(0, dst, bins)


# ---------------------------------------------------------------------------
# the scan kernels' work division
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ScanPlan:
    """How the scan kernels divide a level into (node, feature) jobs:
    features `warp_feats` (at most `wseg` <= WARP_SLOTS slots) take a
    warp each, `warps` to a block, node-major; `block_feats` (the rest,
    past the cap included) a block each. Dynamic shared memory a block,
    `smem` bytes: (2P + 3) words a slot, `wseg` slots a warp or `bseg`
    slots for a block job (segments past the cap need none)."""

    warp_feats: np.ndarray
    block_feats: np.ndarray
    wseg: int
    warps: int
    bseg: int
    smem: int

    def jobs(self, L: int):
        """(block, warp or -1, node, feature) of every job, in the
        kernels' index math (`scan_jobs` in csrc/hist_level.cu)."""
        n_w, n_b = len(self.warp_feats), len(self.block_feats)
        warp_blocks = -(-L * n_w // self.warps)
        out = [(j // self.warps, j % self.warps, j // n_w,
                int(self.warp_feats[j % n_w])) for j in range(L * n_w)]
        out += [(warp_blocks + j, -1, j // n_b, int(self.block_feats[j % n_b]))
                for j in range(L * n_b)]
        return out


def plan_scan(lay, planes: int, cap: int, L: int,
              smem_optin: int = SMEM_BLOCK_MAX) -> ScanPlan:
    """At a level of L nodes, segments up to a warp's share (WARP_SLOTS,
    and at most the cap) take a warp where there are at least
    WARP_JOBS_MIN of them; a block holds as many warps as their
    (2 * planes + 3) words a slot of the widest such segment fit in
    `smem_optin`, at most SCAN_WARPS. Every other segment takes a
    block."""
    words = (2 * planes + 3) * 4
    sizes = [int(s) for s in lay.slots]
    w_cap = min(WARP_SLOTS, cap)
    if L * sum(s <= w_cap for s in sizes) < WARP_JOBS_MIN:
        w_cap = 0
    warp_f = [f for f, s in enumerate(sizes) if s <= w_cap]
    block_f = [f for f, s in enumerate(sizes) if s > w_cap]
    wseg = max((sizes[f] for f in warp_f), default=0)
    warps = (max(1, min(SCAN_WARPS, smem_optin // (words * wseg))) if wseg
             else 1)
    bseg = max((sizes[f] for f in block_f if sizes[f] <= cap), default=0)
    return ScanPlan(warp_feats=np.asarray(warp_f, np.int32),
                    block_feats=np.asarray(block_f, np.int32), wseg=wseg,
                    warps=warps, bseg=bseg,
                    smem=max(warps * words * wseg, words * bseg))


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

_LIB = None
_DEV_CACHE: Dict[tuple, object] = {}


def _lib():
    global _LIB
    if _LIB is None:
        from shifu_tpu_torch.ops import build

        lib = build.load("hist_level")
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        LL = ctypes.c_longlong
        lib.hist_accumulate.argtypes = [
            P, I, LL,          # codes, code_is_i8, code_stride
            P, P, P, I, P,     # labels, weights, node, node_is_i64, active
            I, I, I, I,        # n, L, T, K
            I, I, I, I,        # lowp, bins32, l_n, n_groups
            P, I, I, I, I,     # ttile, n_tt, NF, tab_bytes, smem
            P, P,              # off, clip
            P, LL, P, P, P]    # ws, ws_bytes, maxabs, acc, stream
        lib.hist_accumulate.restype = I
        lib.hist_ws_bytes.argtypes = [I, I, I]
        lib.hist_ws_bytes.restype = LL
        # the scan plan, options and outputs, shared by both scan entries
        scan_args = [P, P, P,          # off, slots, is_cat
                     P, I, P, I,       # wfeat, n_w, bfeat, n_b
                     I, I, I, I, I,    # wseg, warps, bseg, cap, smem
                     P, I, F, F,       # featok, impurity, min_inst, min_gain
                     P, P, P, P, P]    # gain, rank, lcnt, tot0, stream
        lib.hist_convert.argtypes = [P, P, I, I, I, I, I, P, P]
        lib.hist_finalize.argtypes = [P, P, I, I, I, I, I, P] + scan_args
        lib.hist_scan.argtypes = [P, I, I, I, I] + scan_args
        for fn in (lib.hist_convert, lib.hist_finalize, lib.hist_scan):
            fn.restype = I
        for fn in (lib.hist_seg_cap, lib.hist_smem_optin):
            fn.argtypes, fn.restype = [], I
        if lib.hist_seg_cap() != SEG_CAP:
            raise RuntimeError("csrc/hist_level.cu SEG_CAP differs from "
                               "hist_kernel.SEG_CAP")
        _LIB = lib
    return _LIB


def seg_cap(planes: int, dev: torch.device) -> int:
    """`seg_cap_for` on the device's shared-memory opt-in limit."""
    key = ("segcap", planes, str(dev))
    cap = _DEV_CACHE.get(key)
    if cap is None:
        with torch.cuda.device(dev):
            cap = seg_cap_for(planes, _lib().hist_smem_optin())
        _DEV_CACHE[key] = cap
    return cap


def _feature_arrays(lay, dev: torch.device):
    key = ("feat", lay.key, str(dev))
    arrs = _DEV_CACHE.get(key)
    if arrs is None:
        is_cat_f = np.asarray(lay.is_cat_t[lay.off], np.int32) \
            if len(lay.slots) else np.zeros(0, np.int32)
        arrs = tuple(torch.as_tensor(np.ascontiguousarray(a, np.int32),
                                     device=dev)
                     for a in (lay.off, lay.clip_max, lay.slots, is_cat_f))
        _DEV_CACHE[key] = arrs
    return arrs


def _plan(lay, L: int, n_classes: int, bins32: bool, dev: torch.device):
    """The accumulate plan and its slot ranges on the device (cached)."""
    key = ("plan", lay.key, L, planes_of(n_classes), bins32, str(dev))
    got = _DEV_CACHE.get(key)
    if got is None:
        plan = plan_accumulate(lay, L, n_classes, bins32)
        got = (plan, torch.as_tensor(plan.ttiles, device=dev))
        _DEV_CACHE[key] = got
    return got


def _ws_bytes(n: int, n_groups: int, cls_mode: bool, dev) -> int:
    key = ("ws", n, n_groups, cls_mode, str(dev))
    got = _DEV_CACHE.get(key)
    if got is None:
        with torch.cuda.device(dev):
            got = int(_lib().hist_ws_bytes(n, n_groups, int(cls_mode)))
        _DEV_CACHE[key] = got
    return got


def _scan_plan(lay, planes: int, cap: int, L: int, dev: torch.device):
    """The scan plan of a level and its feature lists on the device
    (cached)."""
    key = ("scan", lay.key, planes, cap, L, str(dev))
    got = _DEV_CACHE.get(key)
    if got is None:
        with torch.cuda.device(dev):
            plan = plan_scan(lay, planes, cap, L, _lib().hist_smem_optin())
        got = (plan, torch.as_tensor(plan.warp_feats, device=dev),
               torch.as_tensor(plan.block_feats, device=dev))
        _DEV_CACHE[key] = got
    return got


def _wide_layout(lay, dev: torch.device, cap: int = SEG_CAP):
    """(wide feature ids, their flat columns, their scan layout) for the
    features wider than `cap`, which the kernel does not scan; None when
    every feature fits."""
    key = ("wide", lay.key, cap, str(dev))
    if key in _DEV_CACHE:
        return _DEV_CACHE[key]
    wide = [f for f, s in enumerate(int(x) for x in lay.slots) if s > cap]
    out = None
    if wide:
        tt = _tt()
        cols = np.concatenate([np.arange(int(lay.off[f]),
                                         int(lay.off[f]) + int(lay.slots[f]))
                               for f in wide])
        sub = tt.make_layout([int(lay.slots[f]) for f in wide],
                             [bool(lay.is_cat_t[lay.off[f]]) for f in wide])
        out = (torch.as_tensor(np.asarray(wide, np.int64), device=dev),
               torch.as_tensor(cols, device=dev), tt.scan_layout(sub, dev))
    _DEV_CACHE[key] = out
    return out


def _check(t: torch.Tensor, name: str, dtypes, shape, dev,
           contiguous: bool = True) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} "
                           f"({torch.cuda.get_device_name()})")


def _check_codes8(t: torch.Tensor, n: int, F: int, dev) -> None:
    """codes8 must be `codes8_of`'s int8 rows, padded to 16 bytes."""
    _check(t, "codes8", (torch.int8,), (n, F), dev, contiguous=False)
    if (t.stride(1) != 1 or t.stride(0) < F or t.stride(0) % _ROW_ALIGN
            or t.data_ptr() % _ROW_ALIGN):
        raise ValueError("codes8 must be codes8_of's int8 rows, padded to "
                         f"{_ROW_ALIGN} bytes")


def _on_device(entry):
    """Run a card entry with its first tensor's device current, so the
    library's `cudaGetDevice` (the workspace plan, the shared-memory
    opt-in) sees the device whose stream the kernels launch on."""
    @functools.wraps(entry)
    def run(t, *args, **kw):
        if t.device.type != "cuda":
            return entry(t, *args, **kw)
        with torch.cuda.device(t.device):
            return entry(t, *args, **kw)
    return run


def _accumulate(codes, codes8, labels, weights, node_slot, active, L: int,
                lay, low_precision: bool, n_classes: int, int_planes: bool):
    """Checks the inputs, launches the pre-pass and the accumulate
    (hist_accumulate) on the entry's own labels, weights, node ids and
    active mask. Returns (acc int64 [P, L, T], maxabs, n, feature
    arrays)."""
    dev = codes.device
    n, F = codes.shape
    if F != len(lay.slots):
        raise ValueError(f"codes has {F} features, layout has "
                         f"{len(lay.slots)}")
    if n >= 2 ** 31:
        raise ValueError(f"{n} rows: the kernels index rows in 32 bits")
    if codes8 is not None and lay.s_max <= _I8_SLOTS:
        src, is_i8 = codes8, 1
        _check_codes8(src, n, F, dev)
    else:
        src, is_i8 = codes, 0
        _check(src, "codes", (torch.int32,), (n, F), dev)
    for t, nm in ((labels, "labels"), (weights, "weights")):
        _check(t, nm, (torch.float32,), (n,), dev)
    _check(node_slot, "node_slot", (torch.int32, torch.int64), (n,), dev)
    _check(active, "active", (torch.bool,), (n,), dev)
    cls_mode = n_classes >= 3
    P = planes_of(n_classes)
    off, clip, slots, is_cat = _feature_arrays(lay, dev)
    plan, ttiles = _plan(lay, L, n_classes, bool(int_planes), dev)
    acc = torch.empty((P, L, lay.T), dtype=torch.int64, device=dev)
    maxabs = torch.empty(1 if cls_mode else 3, dtype=torch.float32,
                         device=dev)
    ws = torch.empty(_ws_bytes(n, plan.n_groups, cls_mode, dev),
                     dtype=torch.uint8, device=dev)
    rc = _lib().hist_accumulate(
        src.data_ptr(), is_i8, src.stride(0), labels.data_ptr(),
        weights.data_ptr(), node_slot.data_ptr(),
        int(node_slot.dtype == torch.int64), active.data_ptr(), n, L, lay.T,
        n_classes if cls_mode else 0, int(low_precision), int(plan.bins32),
        plan.l_n, plan.n_groups, ttiles.data_ptr(), len(plan.ttiles),
        plan.NF, plan.tab_bytes, plan.smem, off.data_ptr(),
        clip.data_ptr(), ws.data_ptr(), ws.numel(), maxabs.data_ptr(),
        acc.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "hist_accumulate launch")
    return acc, maxabs, n, (off, clip, slots, is_cat)


def _scan_planes(hist, lay, feats, n_classes: int, scan, fixed=None):
    """One scan launch over a level's histogram hist [P, L, T]: with
    `fixed`, the fused entry's (acc, maxabs, n), hist_finalize converts
    the int64 accumulator into `hist` as it scans; else hist_scan reads
    the f32 `hist`. Returns the per-slot planes (gain, rank, lcnt,
    tot0)."""
    fok, impurity, min_inst, min_gain, cap = scan
    off, _clip, slots, is_cat = feats
    dev = hist.device
    P, L, T = hist.shape
    plan, wfeat, bfeat = _scan_plan(lay, P, cap, L, dev)
    gain = torch.empty((L, T), dtype=torch.float32, device=dev)
    rank = torch.empty((L, T), dtype=torch.int32, device=dev)
    lcnt = torch.empty((L, T), dtype=torch.float32, device=dev)
    tot0 = torch.empty((L, P), dtype=torch.float32, device=dev)
    rest = (off.data_ptr(), slots.data_ptr(), is_cat.data_ptr(),
            wfeat.data_ptr(), len(plan.warp_feats), bfeat.data_ptr(),
            len(plan.block_feats), plan.wseg, plan.warps, plan.bseg, cap,
            plan.smem, fok.data_ptr(), _IMPURITY[impurity], float(min_inst),
            float(min_gain), gain.data_ptr(), rank.data_ptr(),
            lcnt.data_ptr(), tot0.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    cls_mode = int(n_classes >= 3)
    if fixed is not None:
        acc, maxabs, n = fixed
        rc = _lib().hist_finalize(acc.data_ptr(), maxabs.data_ptr(), n, L, T,
                                  P, cls_mode, hist.data_ptr(), *rest)
        _raise_on(rc, "hist_finalize launch")
    else:
        rc = _lib().hist_scan(hist.data_ptr(), L, T, P, cls_mode, *rest)
        _raise_on(rc, "hist_scan launch")
    return gain, rank, lcnt, tot0


@_on_device
def hist_level(codes, labels, weights, node_slot, active, *, L: int, lay,
               low_precision: bool = False,
               codes8: Optional[torch.Tensor] = None,
               n_classes: int = 0, int_planes: bool = False) -> torch.Tensor:
    """Histogram-only entry: [C, L, T] f32 per-node slot sums of
    (w, w*y, w*y^2), or of w per class for n_classes >= 3, over active
    rows. `int_planes`: every plane value is an integer (32-bit shared
    bins on the card; the same planes)."""
    if codes.device.type == "cpu":
        return hist_level_reference(codes, labels, weights, node_slot,
                                    active, L=L, lay=lay,
                                    low_precision=low_precision,
                                    n_classes=n_classes)
    if codes.device.type != "cuda":
        raise ValueError(f"unsupported device {codes.device}")
    acc, maxabs, n, _feats = _accumulate(codes, codes8, labels, weights,
                                         node_slot, active, L, lay,
                                         low_precision, n_classes,
                                         int_planes)
    hist = torch.empty_like(acc, dtype=torch.float32)
    rc = _lib().hist_convert(acc.data_ptr(), maxabs.data_ptr(), n, L, lay.T,
                             hist.shape[0], int(n_classes >= 3),
                             hist.data_ptr(),
                             torch.cuda.current_stream(acc.device).cuda_stream)
    _raise_on(rc, "hist_convert launch")
    launches[_entry("hist_level", n_classes)] += 1
    return hist


@_on_device
def hist_level_acc(codes, labels, weights, node_slot, active, *, L: int,
                   lay, low_precision: bool = False,
                   codes8: Optional[torch.Tensor] = None,
                   n_classes: int = 0, int_planes: bool = False):
    """`hist_level` on the card without its conversion: (acc int64
    [C, L, T] fixed-point sums, maxabs, n rows), for a caller that adds
    several calls' sums before one conversion (`merge_acc`: the streamed
    grower, a call a shard). Two launches, the pre-pass and the
    accumulate, counted as `hist_level`'s."""
    if codes.device.type != "cuda":
        raise ValueError(f"hist_level_acc runs on the card, not on "
                         f"{codes.device}")
    acc, maxabs, n, _feats = _accumulate(codes, codes8, labels, weights,
                                         node_slot, active, L, lay,
                                         low_precision, n_classes,
                                         int_planes)
    launches[_entry("hist_level", n_classes)] += 1
    return acc, maxabs, n


@_on_device
def fused_level(codes, labels, weights, node_slot, active, feat_ok_t, *,
                L: int, lay, impurity: str, min_inst: int, min_gain: float,
                low_precision: bool = False,
                codes8: Optional[torch.Tensor] = None, n_classes: int = 0,
                int_planes: bool = False):
    """Fused entry for one tree level: (hist [C, L, T], scan 9-tuple)."""
    if codes.device.type == "cpu":
        return fused_level_reference(codes, labels, weights, node_slot,
                                     active, feat_ok_t, L=L, lay=lay,
                                     impurity=impurity, min_inst=min_inst,
                                     min_gain=min_gain,
                                     low_precision=low_precision,
                                     n_classes=n_classes)
    if codes.device.type != "cuda":
        raise ValueError(f"unsupported device {codes.device}")
    if impurity not in _IMPURITY:
        raise ValueError(f"unknown impurity {impurity!r}")
    dev = codes.device
    _check(feat_ok_t, "feat_ok_t", (torch.bool,), (lay.T,), dev)
    cap = seg_cap(planes_of(n_classes), dev)
    acc, maxabs, n, feats = _accumulate(codes, codes8, labels, weights,
                                        node_slot, active, L, lay,
                                        low_precision, n_classes, int_planes)
    hist = torch.empty_like(acc, dtype=torch.float32)
    planes = _scan_planes(hist, lay, feats, n_classes,
                          (feat_ok_t, impurity, min_inst, min_gain, cap),
                          fixed=(acc, maxabs, n))
    launches[_entry("fused_level", n_classes)] += 1
    return hist, _epilogue(hist, planes, feat_ok_t, lay, impurity, min_inst,
                           min_gain, n_classes, cap)


@_on_device
def scan_planes(hist, feat_ok_t, *, lay, impurity: str, min_inst: int,
                min_gain: float, n_classes: int = 0):
    """The scan kernel's per-slot planes (gain, rank, lcnt, tot0; see
    `scan_planes_reference`, their plain version, which a CPU tensor
    gets) of an f32 [C, L, T] histogram, and the segment cap they were
    scanned under."""
    if hist.device.type == "cpu":
        return scan_planes_reference(hist, feat_ok_t, lay, impurity,
                                     min_inst, min_gain, n_classes), SEG_CAP
    if hist.device.type != "cuda":
        raise ValueError(f"unsupported device {hist.device}")
    if impurity not in _IMPURITY:
        raise ValueError(f"unknown impurity {impurity!r}")
    dev = hist.device
    P = planes_of(n_classes)
    if hist.dim() != 3:
        raise ValueError(f"hist has shape {tuple(hist.shape)}, expected "
                         f"({P}, L, {lay.T})")
    _check(hist, "hist", (torch.float32,), (P, hist.shape[1], lay.T), dev)
    _check(feat_ok_t, "feat_ok_t", (torch.bool,), (lay.T,), dev)
    cap = seg_cap(P, dev)
    return _scan_planes(hist, lay, _feature_arrays(lay, dev), n_classes,
                        (feat_ok_t, impurity, min_inst, min_gain, cap)), cap


@_on_device
def scan_level(hist, feat_ok_t, *, lay, impurity: str, min_inst: int,
               min_gain: float, n_classes: int = 0):
    """Scan-only entry: the split-scan 9-tuple of an f32 [C, L, T]
    histogram (moments, or K class planes for n_classes >= 3). On the
    CPU the plain scan (`tree_trainer.scan_of`); on the card one launch
    of hist_scan_kernel (`scan_planes`) and the fused entry's epilogue,
    which scans the segments wider than the cap in torch."""
    name = _entry("scan_level", n_classes)
    if hist.device.type == "cpu":
        reference_calls[name] += 1
        tt = _tt()
        return tt.scan_of(n_classes)(hist, feat_ok_t,
                                     tt.scan_layout(lay, hist.device),
                                     impurity, min_inst, min_gain)
    kw = dict(impurity=impurity, min_inst=min_inst, min_gain=min_gain,
              n_classes=n_classes)
    planes, cap = scan_planes(hist, feat_ok_t, lay=lay, **kw)
    launches[name] += 1
    return _epilogue(hist, planes, feat_ok_t, lay, cap=cap, **kw)


def _epilogue(hist, planes, feat_ok_t, lay, impurity, min_inst, min_gain,
              n_classes: int = 0, cap: int = SEG_CAP):
    """Kernel planes -> the reference split-scan 9-tuple: best gain wins,
    ties go to the smallest ordered position start + rank; features wider
    than `cap` are scanned by the torch scan and merged in. Node stats
    come from the segment-0 totals: (count, mean label), or for K classes
    (count summed in class order, first majority class)."""
    tt = _tt()
    gain, rank, lcnt, tot0 = planes
    dev = gain.device
    L, T = gain.shape
    sl = tt.scan_layout(lay, dev)
    wide = _wide_layout(lay, dev, cap)
    o = sl.start_t[None, :] + rank.long()  # ordered position per slot
    if wide is not None:  # the torch scan owns these columns' positions
        o[:, wide[1]] = T
    gmax = gain.max(dim=-1).values
    cand = gain == gmax[:, None]
    obest = torch.where(cand, o, torch.full_like(o, T)).min(dim=-1).values
    best = torch.argmax((o == obest[:, None]).to(torch.int32), dim=-1)
    feature = sl.seg_t[best]
    cut_rank = rank.gather(1, best[:, None])[:, 0].long()
    left_cnt = lcnt.gather(1, best[:, None])[:, 0]
    best_gain = gmax
    rank_flat = rank

    if wide is not None:
        wide_ids, cols, wsl = wide
        (f_w, cut_w, rank_w, _lv, _sp, g_w, _lm, _nc,
         lc_w) = tt.scan_of(n_classes)(hist[:, :, cols], feat_ok_t[cols],
                                       wsl, impurity, min_inst, min_gain)
        f_wg = wide_ids[f_w.long()]
        o_w = sl.off_f[f_wg] + cut_w.long()
        take_w = (g_w > best_gain) | ((g_w == best_gain) & (o_w < obest))
        feature = torch.where(take_w, f_wg, feature)
        cut_rank = torch.where(take_w, cut_w.long(), cut_rank)
        left_cnt = torch.where(take_w, lc_w, left_cnt)
        best_gain = torch.where(take_w, g_w, best_gain)
        rank_flat = rank_flat.clone()
        rank_flat[:, cols] = rank_w

    is_split = torch.isfinite(best_gain)
    if n_classes >= 3:
        node_cnt = tt.class_sum(tot0.T)
        leaf_value = torch.argmax(tot0, dim=1).to(torch.float32)
    else:
        node_cnt = tot0[:, 0]
        leaf_value = tot0[:, 1] / node_cnt.clamp_min(1e-12)
    left_mask = tt.left_mask_of(rank_flat, feature, cut_rank, is_split, sl)
    return (feature.to(torch.int32), cut_rank.to(torch.int32), rank_flat,
            leaf_value, is_split, best_gain, left_mask, node_cnt, left_cnt)

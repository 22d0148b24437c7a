"""Tree-level histogram -> split scan: CUDA kernel wrappers and their plain
PyTorch versions.

Counterpart of `shifu_tpu/ops/hist_pallas.py`. Two entries, each with a
plain version that takes the same arguments and returns the same outputs:

    hist_level(codes, labels, weights, node_slot, active, *, L, lay, ...)
        -> hist [C, L, T] f32                (make_pallas_hist_fn)
    fused_level(codes, labels, weights, node_slot, active, feat_ok_t, *,
                L, lay, impurity, min_inst, min_gain, ...)
        -> (hist [C, L, T], scan 9-tuple)    (make_fused_level_fn)

Both take `n_classes`, as the JAX entries do. Below 3 the planes are the
C = 3 moments (w, w*y, w*y^2); from 3 up (NATIVE multi-class RF) they are
C = K weighted per-class counts, `labels` holds class indices, and the
scan is the K-class gini/entropy scan with majority-class leaf values
(`tree_trainer.cls_scan`). The scan 9-tuple is the reference split
scan's: (feature, cut_rank, rank_flat, leaf_value, is_split, best_gain,
left_mask, node_cnt, left_cnt).

On CPU tensors a wrapper runs its plain version; on CUDA tensors it
launches the kernel of `csrc/hist_level.cu` or raises — there is no
fallback and no mode knob. Each entry counts its kernel launches and its
plain-version calls in plain integers (`launches`, `reference_calls`),
the multi-class mode under its own names (`hist_level_mc`,
`fused_level_mc`).

Precision policy (the JAX package's): GBT comps travel bf16, rounded once
when the planes are built, and sum in (here: fixed-point, then) f32; RF
planes stay f32 so integer-weight counts are exact. Codes travel int8
when every feature fits 128 slots (`codes8_of`), else int32.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np
import torch

# widest feature segment the kernel scans itself; wider ones (the bench
# gbt_wide 2001-slot column) are scanned by the torch split scan on just
# their columns — static routing by shape, as in the JAX package
SEG_CAP = 1024
# int64 bins of one accumulate tile: 3 planes x 8192 x 8 B = 192 KiB of
# the 227 KB of shared memory a Hopper block may use; K class planes
# share the same budget (3 * 8192 // K bins a plane)
SMEM_BINS = 8192
# fewest rows worth a block of its own
_ROW_MIN = 2048
# int8 codes hold every feature whose clipped code fits 0..127
_I8_SLOTS = 128

_IMPURITY = {"variance": 0, "friedmanmse": 1, "entropy": 2, "gini": 3}

_ENTRIES = ("hist_level", "fused_level", "hist_level_mc", "fused_level_mc")
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
    exact for every feature with <= 128 slots; wider columns clamp."""
    cap = torch.as_tensor(np.minimum(lay.clip_max, _I8_SLOTS - 1),
                          device=codes.device)
    return torch.minimum(codes.clamp_min(0), cap[None, :]).to(torch.int8)


def _entry(name: str, n_classes: int) -> str:
    return name + "_mc" if n_classes >= 3 else name


def planes_of(n_classes: int) -> int:
    return n_classes if n_classes >= 3 else 3


def seg_cap_for(planes: int, smem_optin: int) -> int:
    """Widest segment the finalize kernel scans itself with `planes`
    planes: SEG_CAP, or fewer slots where (2 * planes + 3) words a slot
    of dynamic shared memory pass what a block may opt in to (K = 32
    class planes: 867 slots in 227 KB). Wider segments take the torch
    scan on their columns."""
    return max(0, min(SEG_CAP, smem_optin // ((2 * planes + 3) * 4)))


def _nl_of(node_slot, active, L: int):
    return torch.where(active, node_slot.clamp(0, L - 1),
                       torch.zeros_like(node_slot)).to(torch.int32)


def _prep(labels, weights, node_slot, active, L: int, low_precision: bool,
          n_classes: int = 0):
    """Component planes [n, C] (inactive rows zeroed through the weight,
    bf16 for GBT; one weighted count plane a class for n_classes >= 3)
    and node ids clamped to [0, L), 0 for inactive rows."""
    comps = _tt().comps_of(labels, weights, active, low_precision,
                           n_classes)
    return comps, _nl_of(node_slot, active, L)


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def hist_level_reference(codes, labels, weights, node_slot, active, *,
                         L: int, lay, low_precision: bool = False,
                         codes8=None, n_classes: int = 0) -> torch.Tensor:
    """Plain version of `hist_level`: index_add_ over the flat
    node*T + off[f] + clip(code) slot of every (row, feature)."""
    reference_calls[_entry("hist_level", n_classes)] += 1
    comps, nl = _prep(labels, weights, node_slot, active, L, low_precision,
                      n_classes)
    return _tt().hist_scatter(codes, comps.float(), nl, L, lay)


def fused_level_reference(codes, labels, weights, node_slot, active,
                          feat_ok_t, *, L: int, lay, impurity: str,
                          min_inst: int, min_gain: float,
                          low_precision: bool = False, codes8=None,
                          n_classes: int = 0):
    """Plain version of `fused_level`: the plain histogram, then the
    reference split scan (the class scan for n_classes >= 3) over it."""
    reference_calls[_entry("fused_level", n_classes)] += 1
    tt = _tt()
    comps, nl = _prep(labels, weights, node_slot, active, L, low_precision,
                      n_classes)
    hist = tt.hist_scatter(codes, comps.float(), nl, L, lay)
    sl = tt.scan_layout(lay, hist.device)
    return hist, tt.scan_of(n_classes)(hist, feat_ok_t, sl, impurity,
                                       min_inst, min_gain)


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
        lib.hist_accumulate.argtypes = [P, I, P, I, P, I, I, I, I, P, P, P,
                                        I, I, I, I, P, P, P]
        lib.hist_accumulate.restype = I
        lib.hist_accumulate_cls.argtypes = [P, I, P, P, P, I, I, I, I, I, P,
                                            P, P, I, I, I, I, P, P, P]
        lib.hist_accumulate_cls.restype = I
        lib.hist_finalize.argtypes = [P, P, I, I, I, I, I, I, I, P, P, P, P,
                                      I, I, F, F, P, P, P, P, P, P]
        lib.hist_finalize.restype = I
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


def _tiles(lay, L: int, planes: int = 3) -> Tuple[np.ndarray, int]:
    """Accumulate tiles [k, 6] (f_lo, f_hi, t_lo, t_w, l_lo, l_n): flat
    slot ranges x node ranges of at most 3 * SMEM_BINS // planes bins a
    plane. Returns (tiles, bins a plane of the largest tile)."""
    T = lay.T
    cap = max(1, 3 * SMEM_BINS // planes)
    n_tt = -(-T // cap)
    t_w = -(-T // n_tt)
    l_n = max(1, min(L, cap // t_w))
    n_lt = -(-L // l_n)
    l_n = -(-L // n_lt)
    tiles = []
    for t_lo in range(0, T, t_w):
        tw = min(t_w, T - t_lo)
        f_lo = int(lay.seg_of_t[t_lo])
        f_hi = int(lay.seg_of_t[t_lo + tw - 1]) + 1
        for l_lo in range(0, L, l_n):
            tiles.append((f_lo, f_hi, t_lo, tw, l_lo, min(l_n, L - l_lo)))
    return np.asarray(tiles, np.int32), t_w * l_n


def _plan(lay, L: int, n: int, planes: int, dev: torch.device):
    key = ("plan", lay.key, L, n, planes, str(dev))
    plan = _DEV_CACHE.get(key)
    if plan is None:
        tiles, smem_bins = _tiles(lay, L, planes)
        k = len(tiles)
        max_nf = int((tiles[:, 1] - tiles[:, 0]).max())
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        splits = max(1, min(-(-n // _ROW_MIN), -(-2 * sms // k)))
        while -(-n // splits) * max_nf >= 2**31:
            splits *= 2
        rows_per = max(1, -(-n // splits))
        splits = max(1, -(-n // rows_per))
        plan = (torch.as_tensor(tiles, device=dev), k, splits, rows_per,
                smem_bins)
        _DEV_CACHE[key] = plan
    return plan


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


def _check(t: torch.Tensor, name: str, dtypes, shape, dev) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} "
                           f"({torch.cuda.get_device_name()})")


def _accumulate(codes, codes8, labels, weights, node_slot, active, L: int,
                lay, low_precision: bool, n_classes: int):
    """Checks the inputs, launches hist_accumulate (moment planes) or
    hist_accumulate_cls (class planes: class ids and weights, one atomic
    a (row, feature)). Returns (acc int64 [P, L, T], maxabs, n, feature
    arrays)."""
    dev = codes.device
    n, F = codes.shape
    if F != len(lay.slots):
        raise ValueError(f"codes has {F} features, layout has "
                         f"{len(lay.slots)}")
    if codes8 is not None and lay.s_max <= _I8_SLOTS:
        src, is_i8 = codes8, 1
        _check(src, "codes8", (torch.int8,), (n, F), dev)
    else:
        src, is_i8 = codes, 0
        _check(src, "codes", (torch.int32,), (n, F), dev)
    for t, nm in ((labels, "labels"), (weights, "weights")):
        _check(t, nm, (torch.float32,), (n,), dev)
    _check(node_slot, "node_slot", (torch.int32, torch.int64), (n,), dev)
    _check(active, "active", (torch.bool,), (n,), dev)
    P = planes_of(n_classes)
    off, clip, slots, is_cat = _feature_arrays(lay, dev)
    tiles, k, splits, rows_per, smem_bins = _plan(lay, L, n, P, dev)
    acc = torch.empty((P, L, lay.T), dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if n_classes >= 3:
        # a row adds its weight to exactly one class plane: the kernel
        # takes the class id and the weight instead of [n, K] comps
        cls = labels.to(torch.int32).clamp(0, n_classes - 1).contiguous()
        w = torch.where(active, weights, torch.zeros_like(weights))
        nl = _nl_of(node_slot, active, L)
        maxabs = (w.abs().amax()[None] if n else
                  torch.zeros(1, device=dev)).contiguous()
        rc = _lib().hist_accumulate_cls(
            src.data_ptr(), is_i8, cls.data_ptr(), w.data_ptr(),
            nl.data_ptr(), n, F, lay.T, L, n_classes, off.data_ptr(),
            clip.data_ptr(), tiles.data_ptr(), k, splits, rows_per,
            smem_bins, maxabs.data_ptr(), acc.data_ptr(), stream)
        _raise_on(rc, "hist_accumulate_cls launch")
        return acc, maxabs, n, (off, clip, slots, is_cat)
    comps, nl = _prep(labels, weights, node_slot, active, L, low_precision)
    comps = comps.contiguous()
    maxabs = (comps.float().abs().amax(0) if n else
              torch.zeros(3, device=dev)).contiguous()
    rc = _lib().hist_accumulate(
        src.data_ptr(), is_i8, comps.data_ptr(),
        int(comps.dtype == torch.bfloat16), nl.data_ptr(), n, F, lay.T, L,
        off.data_ptr(), clip.data_ptr(), tiles.data_ptr(), k, splits,
        rows_per, smem_bins, maxabs.data_ptr(), acc.data_ptr(), stream)
    _raise_on(rc, "hist_accumulate launch")
    return acc, maxabs, n, (off, clip, slots, is_cat)


def _finalize(acc, maxabs, n: int, L: int, lay, feats, n_classes: int,
              scan=None):
    dev = acc.device
    off, _clip, slots, is_cat = feats
    T, F = lay.T, len(lay.slots)
    P = planes_of(n_classes)
    cls_mode = int(n_classes >= 3)
    hist = torch.empty((P, L, T), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _lib()
    if scan is None:
        rc = lib.hist_finalize(acc.data_ptr(), maxabs.data_ptr(), n, L, T, F,
                               P, cls_mode, SEG_CAP, off.data_ptr(),
                               slots.data_ptr(), is_cat.data_ptr(), None, 0,
                               0, 0.0, 0.0, hist.data_ptr(), None, None,
                               None, None, stream)
        _raise_on(rc, "hist_finalize launch")
        return hist, None
    fok, impurity, min_inst, min_gain, cap = scan
    gain = torch.empty((L, T), dtype=torch.float32, device=dev)
    rank = torch.empty((L, T), dtype=torch.int32, device=dev)
    lcnt = torch.empty((L, T), dtype=torch.float32, device=dev)
    tot0 = torch.empty((L, P), dtype=torch.float32, device=dev)
    rc = lib.hist_finalize(acc.data_ptr(), maxabs.data_ptr(), n, L, T, F, P,
                           cls_mode, cap, off.data_ptr(), slots.data_ptr(),
                           is_cat.data_ptr(), fok.data_ptr(), 1,
                           _IMPURITY[impurity], float(min_inst),
                           float(min_gain), hist.data_ptr(),
                           gain.data_ptr(), rank.data_ptr(),
                           lcnt.data_ptr(), tot0.data_ptr(), stream)
    _raise_on(rc, "hist_finalize launch")
    return hist, (gain, rank, lcnt, tot0)


def hist_level(codes, labels, weights, node_slot, active, *, L: int, lay,
               low_precision: bool = False,
               codes8: Optional[torch.Tensor] = None,
               n_classes: int = 0) -> torch.Tensor:
    """Histogram-only entry: [C, L, T] f32 per-node slot sums of
    (w, w*y, w*y^2), or of w per class for n_classes >= 3, over active
    rows."""
    if codes.device.type == "cpu":
        return hist_level_reference(codes, labels, weights, node_slot,
                                    active, L=L, lay=lay,
                                    low_precision=low_precision,
                                    n_classes=n_classes)
    if codes.device.type != "cuda":
        raise ValueError(f"unsupported device {codes.device}")
    acc, maxabs, n, feats = _accumulate(codes, codes8, labels, weights,
                                        node_slot, active, L, lay,
                                        low_precision, n_classes)
    hist, _ = _finalize(acc, maxabs, n, L, lay, feats, n_classes)
    launches[_entry("hist_level", n_classes)] += 1
    return hist


def fused_level(codes, labels, weights, node_slot, active, feat_ok_t, *,
                L: int, lay, impurity: str, min_inst: int, min_gain: float,
                low_precision: bool = False,
                codes8: Optional[torch.Tensor] = None, n_classes: int = 0):
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
                                        low_precision, n_classes)
    fok = feat_ok_t.to(torch.float32)
    hist, planes = _finalize(acc, maxabs, n, L, lay, feats, n_classes,
                             scan=(fok, impurity, min_inst, min_gain, cap))
    launches[_entry("fused_level", n_classes)] += 1
    return hist, _epilogue(hist, planes, feat_ok_t, lay, impurity, min_inst,
                           min_gain, n_classes, cap)


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

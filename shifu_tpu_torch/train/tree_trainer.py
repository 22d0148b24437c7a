"""GBT/RF histogram tree builder, level-wise, on one device or a mesh.

Counterpart of `shifu_tpu/train/tree_trainer.py` on its fused path
(`_get_tree_program` with no mesh and no hoisted one-hot, driven by
`train_trees`). What DTMaster/DTWorker do across a cluster happens here as
a loop of device ops over a FLAT per-feature slot layout:

    histogram  [C, L, T], T = sum(slots_f): per node, per slot sums of
               (w, w*y, w*y^2) (C = 3), or for NATIVE multi-class RF
               (n_classes = K >= 3) one weighted count plane a class
               (C = K). Every level with L <= 32 nodes runs the fused
               histogram -> split-scan entry `ops.hist_kernel.
               fused_level`; deeper levels run `hist_level` and the
               scan-only entry `scan_level`, as does the derived sibling.
    split scan ordered prefix sums per (node, feature segment): numeric
               segments keep slot order, categorical segments sort by mean
               label (K classes: by expected class index) inside static
               segment boundaries; gain by impurity (variance /
               friedmanmse / entropy / gini; K classes: the K-class gini
               or entropy mass drop, `cls_scan`). Multi-class leaves hold
               the majority class index; the forest votes.
    reuse      histogram SUBTRACTION: from level 1 on, only the SMALLER
               child of each split is built (a half-width histogram); the
               sibling is parent - built. Planes stay f32 (the JAX
               package's default: its f64 chain follows jax x64, off by
               default). RF planes under integer weights are exact, so RF
               forests equal the plain run's bit for bit.

On a CUDA device the histogram and scan entries launch the kernels of
`csrc/hist_level.cu`; on the CPU they run their plain versions (the
scans below). Random
draws are numpy `default_rng` streams keyed exactly as the JAX package
keys them, so one seed gives the same valid split, feature subsets, RF
bags and DART keep masks in both packages.

Two more growers drive the histogram-only and scan-only entries from the
host, as the JAX package's do: `build_tree_leafwise` (max_leaves > 0,
the best-gain leaf split first, explicit child pointers) and the
host-batched `build_tree` (2**max_depth past the stats-memory node
batch: a level's nodes in batches of at most that many). `train_trees`
routes between the three as the JAX `train_trees` does.

`train_trees(mesh=)` shards the rows over a `parallel.mesh.Mesh` (the
JAX package's `shard_map` growers): each shard builds its histogram with
the histogram-only entry, the lead device merges the partials in shard
order (`_Rows.hist`) and scans them with the scan-only entry, and every
shard routes its own rows by the level's decisions. The fused entry is a
one-device path only.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from shifu_tpu_torch.models.tree import (DenseTree, TreeModelSpec,
                                         traverse_trees)
from shifu_tpu_torch.obs import profile
from shifu_tpu_torch.ops import hist_bounds, hist_kernel
from shifu_tpu_torch.parallel.mesh import (mesh_device, pad_rows, psum,
                                           shard_rows)
from shifu_tpu_torch.utils.log import get_logger
from shifu_tpu_torch.utils.platform import DeviceLike

log = get_logger(__name__)

# widest level (in nodes) that takes the fused histogram + scan entry;
# deeper levels run the histogram-only entry and the scan-only entry
_FUSED_SCAN_L_CAP = 32

# rows per block of the final level's node-total contraction
_LEAF_BLK = 65536


@dataclass
class TreeTrainConfig:
    algorithm: str = "GBT"  # GBT | RF
    tree_num: int = 100
    max_depth: int = 6
    max_leaves: int = -1  # > 0 switches to leaf-wise growth
    impurity: str = "variance"  # variance | friedmanmse | entropy | gini
    loss: str = "squared"  # squared | log (GBT label relabeling)
    learning_rate: float = 0.05
    min_instances_per_node: int = 5
    min_info_gain: float = 0.0
    feature_subset_strategy: str = "ALL"
    bagging_sample_rate: float = 1.0
    bagging_with_replacement: bool = True
    valid_set_rate: float = 0.1
    dropout_rate: float = 0.0  # GBT DART-style per-row drop
    early_stop_rounds: int = 0
    enable_early_stop: bool = False  # DTEarlyStopDecider windowed decider
    max_stats_memory_mb: int = 256  # histogram node-batch budget
    hist_subtraction: bool = True  # build smaller child, derive the sibling
    n_classes: int = 0  # >= 3: NATIVE RF multi-class (majority-vote leaves)
    seed: int = 0

    @classmethod
    def from_model_config(cls, mc, trainer_id: int = 0) -> "TreeTrainConfig":
        """TrainModelProcessor's DT param wiring (tree_trainer.py:98-133 of
        the JAX package): trainer `i` gets the seed i * 977 + 13."""
        t = mc.train
        alg = t.algorithm.value if hasattr(t.algorithm, "value") else str(t.algorithm)

        def g(key, default):
            v = t.get_param(key, default)
            return default if v is None else v

        alg = "RF" if alg in ("RF", "DT") else "GBT"
        return cls(
            algorithm=alg,
            tree_num=int(g("TreeNum", 100 if alg == "GBT" else 10)),
            max_depth=int(g("MaxDepth", 6 if alg == "GBT" else 10)),
            max_leaves=int(g("MaxLeaves", -1)),
            impurity=str(g("Impurity", "variance")).lower(),
            loss=str(g("Loss", "squared")).lower(),
            learning_rate=float(g("LearningRate", 0.05)),
            dropout_rate=float(g("DropoutRate", 0.0)),
            min_instances_per_node=int(g("MinInstancesPerNode", 5)),
            min_info_gain=float(g("MinInfoGain", 0.0)),
            feature_subset_strategy=str(
                g("FeatureSubsetStrategy", "ALL")
            ).upper(),
            bagging_sample_rate=float(t.bagging_sample_rate or 1.0),
            bagging_with_replacement=bool(t.bagging_with_replacement),
            valid_set_rate=float(t.valid_set_rate or 0.1),
            early_stop_rounds=int(g("EarlyStopRounds", 0)),
            enable_early_stop=bool(g("EnableEarlyStop", False)),
            max_stats_memory_mb=int(g("MaxStatsMemoryMB", 256)),
            hist_subtraction=bool(g("TreeHistSubtraction", True)),
            n_classes=(len(mc.tags())
                       if (mc.is_multi_classification()
                           and not t.is_one_vs_all()) else 0),
            seed=trainer_id * 977 + 13,
        )


def subset_count(strategy: str, n_features: int) -> int:
    s = strategy.upper()
    if s in ("ALL", ""):
        return n_features
    if s == "HALF":
        return max(1, n_features // 2)
    if s == "ONETHIRD":
        return max(1, n_features // 3)
    if s == "TWOTHIRDS":
        return max(1, (2 * n_features) // 3)
    if s == "QUARTER":
        return max(1, n_features // 4)
    if s in ("SQRT", "AUTO"):
        return max(1, int(math.sqrt(n_features)))
    if s == "LOG2":
        return max(1, int(math.log2(max(n_features, 2))))
    return n_features


# ---------------------------------------------------------------------------
# static per-feature slot layout
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FeatureLayout:
    """Flat per-feature slot addressing: feature f owns slots
    [off[f], off[f]+slots[f]) of a T-wide axis."""

    slots: np.ndarray  # [F] int32
    off: np.ndarray  # [F] int32 segment starts
    T: int
    seg_of_t: np.ndarray  # [T] feature id per flat slot
    pos_in_seg: np.ndarray  # [T] slot rank within its segment
    seg_start_t: np.ndarray  # [T]
    seg_size_t: np.ndarray  # [T]
    is_cat_t: np.ndarray  # [T] bool
    clip_max: np.ndarray  # [F] slots-1
    s_max: int
    key: tuple = ()


_LAYOUTS: Dict[tuple, FeatureLayout] = {}


def make_layout(slots: List[int], is_cat: List[bool]) -> FeatureLayout:
    key = (tuple(int(s) for s in slots), tuple(bool(c) for c in is_cat))
    lay = _LAYOUTS.get(key)
    if lay is not None:
        return lay
    slots_np = np.asarray(slots, np.int32)
    off = np.zeros(len(slots), np.int32)
    off[1:] = np.cumsum(slots_np[:-1])
    T = int(slots_np.sum())
    seg = np.repeat(np.arange(len(slots), dtype=np.int32), slots_np)
    pos = np.arange(T, dtype=np.int32) - off[seg]
    lay = FeatureLayout(
        slots=slots_np, off=off, T=T, seg_of_t=seg, pos_in_seg=pos,
        seg_start_t=off[seg], seg_size_t=slots_np[seg],
        is_cat_t=np.asarray(is_cat, bool)[seg],
        clip_max=np.maximum(slots_np - 1, 0),
        s_max=int(slots_np.max()) if len(slots) else 1, key=key)
    _LAYOUTS[key] = lay
    return lay


@dataclass(frozen=True)
class ScanLayout:
    """Device copies of the layout arrays the split scan reads."""

    is_cat_t: torch.Tensor  # [T] bool
    seg_t: torch.Tensor  # [T] long
    pos_t: torch.Tensor  # [T] long
    start_t: torch.Tensor  # [T] long
    size_t: torch.Tensor  # [T] long
    off_f: torch.Tensor  # [F] long
    clip_f: torch.Tensor  # [F] long
    seg0_size: int
    s_max: int


_SCAN_LAYOUTS: Dict[tuple, ScanLayout] = {}


def scan_layout(lay: FeatureLayout, device: torch.device) -> ScanLayout:
    key = (lay.key, str(device))
    sl = _SCAN_LAYOUTS.get(key)
    if sl is None:
        as_long = lambda a: torch.as_tensor(  # noqa: E731
            np.asarray(a, np.int64), device=device)
        sl = ScanLayout(
            is_cat_t=torch.as_tensor(lay.is_cat_t, device=device),
            seg_t=as_long(lay.seg_of_t), pos_t=as_long(lay.pos_in_seg),
            start_t=as_long(lay.seg_start_t), size_t=as_long(lay.seg_size_t),
            off_f=as_long(lay.off), clip_f=as_long(lay.clip_max),
            seg0_size=int(lay.slots[0]) if len(lay.slots) else 1,
            s_max=lay.s_max)
        _SCAN_LAYOUTS[key] = sl
    return sl


# ---------------------------------------------------------------------------
# plain histogram, split scan, leaf totals
# ---------------------------------------------------------------------------


def comps_of(labels: torch.Tensor, weights: torch.Tensor,
             active: torch.Tensor, low_precision: bool,
             n_classes: int = 0) -> torch.Tensor:
    """[n, 3] component planes (w, w*y, w*y^2), or for n_classes >= 3 the
    [n, K] planes w * [cls == c] (`_make_comps_of`; labels are class
    indices), inactive rows zeroed through the weight; bf16 (one
    rounding) when low_precision."""
    w = torch.where(active, weights, torch.zeros_like(weights))
    if n_classes >= 3:
        cls = labels.to(torch.int32).clamp(0, n_classes - 1)
        return torch.stack([w * (cls == c).to(torch.float32)
                            for c in range(n_classes)], dim=1)
    wy = w * labels
    comps = torch.stack([w, wy, wy * labels], dim=1)
    return comps.to(torch.bfloat16) if low_precision else comps


def int_planes_of(labels: torch.Tensor, weights: torch.Tensor,
                  n_classes: int, low_precision: bool) -> bool:
    """Whether every histogram plane value of a forest is an integer, so
    the kernels may sum them in their exact 32-bit shared bins: the row
    weights are integers (an RF bag multiplies them by integer counts)
    and, for the moment planes (w, w*y, w*y^2), so are the labels. GBT's
    bf16 residual planes never are. Decided once a forest (one host
    sync), never once a level."""
    if low_precision:
        return False

    def whole(t):
        return bool(torch.all(torch.isfinite(t) & (t == torch.trunc(t))))

    return whole(weights) and (n_classes >= 3 or whole(labels))


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Exactly rounded f32 a * b + c, as a fused multiply-add gives it
    (CUDA's fmaf, XLA's contracted multiply-add): the f64 product of two
    f32 values is exact, TwoSum gives the f64 sum's error, and rounding
    that sum to odd before the one f32 rounding keeps the double rounding
    exact (Boldo and Melquiond, 2008)."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    bits = s.view(torch.int64)
    fix = (err != 0) & ((bits & 1) == 0)
    step = torch.sign(err).to(torch.int64) * torch.sign(s).to(torch.int64)
    return torch.where(fix, bits + step, bits).view(torch.float64).float()


def class_sum(planes: torch.Tensor) -> torch.Tensor:
    """Sum over the leading (class) axis in class order c = 0..K-1, as
    the kernels add their class terms."""
    acc = planes[0]
    for c in range(1, planes.shape[0]):
        acc = acc + planes[c]
    return acc


def hist_scatter(codes: torch.Tensor, comps: torch.Tensor, nl: torch.Tensor,
                 L: int, lay: FeatureLayout) -> torch.Tensor:
    """Plain histogram (counterpart of `_make_hist_fn`'s scatter lowering):
    index_add_ of each f32 plane over node*T + off[f] + clip(code).
    `nl` is already clamped to [0, L) and `comps` zeroed on inactive
    rows."""
    dev = codes.device
    n, F = codes.shape
    T = lay.T
    off = torch.as_tensor(np.asarray(lay.off, np.int64), device=dev)
    clip = torch.as_tensor(np.asarray(lay.clip_max, np.int64), device=dev)
    code = torch.minimum(codes.long().clamp_min(0), clip[None, :])
    flat = (nl.long()[:, None] * T + off[None, :] + code).reshape(-1)
    planes = []
    for c in range(comps.shape[1]):
        vals = comps[:, c:c + 1].expand(n, F).reshape(-1)
        planes.append(torch.zeros(L * T, dtype=torch.float32, device=dev)
                      .index_add_(0, flat, vals).reshape(L, T))
    return torch.stack(planes)


def left_mask_of(rank_flat, feature, cut_rank, is_split,
                 sl: ScanLayout) -> torch.Tensor:
    """Model-facing mask over ORIGINAL codes [L, s_max]."""
    dev = rank_flat.device
    s_range = torch.arange(sl.s_max, device=dev)
    f = feature.long()
    f_clip = sl.clip_f[f]
    s_idx = torch.minimum(s_range[None, :], f_clip[:, None])
    flat_idx = sl.off_f[f][:, None] + s_idx
    ranks = rank_flat.gather(1, flat_idx)
    return ((ranks <= cut_rank[:, None])
            & (s_range[None, :] <= f_clip[:, None])
            & is_split[:, None])


def _scan_order(sec: torch.Tensor, sl: ScanLayout) -> torch.Tensor:
    """`jnp.lexsort((sec, seg))` per row, reproduced by two stable sorts
    (by key, then by segment): the original index per ordered position."""
    o1 = torch.argsort(sec, dim=-1, stable=True)
    o2 = torch.argsort(sl.seg_t[o1], dim=-1, stable=True)
    return o1.gather(1, o2)


def _seg_sums(planes: torch.Tensor, order: torch.Tensor, sl: ScanLayout):
    """Inclusive left sums in the ordered layout and segment totals of
    [..., L, T] planes. The running sums cross every segment of the row;
    in f64 they stay exact for integer-valued planes however wide the
    row, so each segment's left/total sums round once to f32, like the
    kernel's per-segment scan (an f32 running sum stops being exact past
    2^24; ROADMAP C.2)."""
    idx = order.expand(planes.shape)
    c = torch.cumsum(planes.gather(-1, idx).double(), dim=-1)
    start_prev = (sl.start_t - 1).clamp_min(0)
    end_idx = sl.start_t + sl.size_t - 1
    has_prev = sl.start_t > 0
    base = torch.where(has_prev, c[..., start_prev], torch.zeros_like(c))
    return (c - base).float(), (c[..., end_idx] - base).float()


def _scan_tail(gain, lcnt, rcnt, order, feat_ok_t, sl: ScanLayout,
               min_inst: int, min_gain: float, node_cnt, leaf_value):
    """Validity, the best ordered position (first max wins), rank_flat and
    the model-facing mask: the shared end of both scans."""
    L, T = gain.shape
    inf = torch.tensor(float("inf"), device=gain.device)
    valid = ((lcnt >= min_inst) & (rcnt >= min_inst) & (gain > min_gain)
             & feat_ok_t[None, :]
             & (sl.pos_t < sl.size_t - 1)[None, :])  # cut at segment end
    gain = torch.where(valid, gain, -inf)

    best = torch.argmax(gain, dim=-1)  # ordered position, first max wins
    best_gain = gain.gather(1, best[:, None])[:, 0]
    left_cnt = lcnt.gather(1, best[:, None])[:, 0]
    feature = sl.seg_t[best]
    cut_rank = sl.pos_t[best]
    is_split = torch.isfinite(best_gain)
    rank_flat = torch.zeros((L, T), dtype=torch.int32, device=gain.device)
    rank_flat.scatter_(1, order,
                       sl.pos_t.to(torch.int32)[None, :].expand(L, T))
    left_mask = left_mask_of(rank_flat, feature, cut_rank, is_split, sl)
    return (feature.to(torch.int32), cut_rank.to(torch.int32), rank_flat,
            leaf_value, is_split, best_gain, left_mask, node_cnt, left_cnt)


def moment_gain(impurity: str, left: torch.Tensor, tot: torch.Tensor):
    """Gain of a cut after each ordered position from the left and the
    segment-total moment planes [3, ...] (count, sum y, sum y^2) of the
    same shape, by impurity (variance / friedmanmse / entropy / gini),
    in the f32 operations of the kernel's `split_gain`. Returns (gain,
    lcnt, rcnt)."""
    lcnt, ls1, ls2 = left
    tcnt, ts1, ts2 = tot
    rcnt, rs1, rs2 = tcnt - lcnt, ts1 - ls1, ts2 - ls2

    def sse(c, s, q):
        return q - s * s / c.clamp_min(1e-12)

    def gini_mass(c, p):
        ng = c - p
        return c - (p * p + ng * ng) / c.clamp_min(1e-12)

    def entropy_mass(c, p):
        pr = p / c.clamp_min(1e-12)
        q = 1.0 - pr
        h = -(pr * torch.log2(pr.clamp_min(1e-12))
              + q * torch.log2(q.clamp_min(1e-12)))
        return c * h

    if impurity == "entropy":
        gain = (entropy_mass(tcnt, ts1) - entropy_mass(lcnt, ls1)
                - entropy_mass(rcnt, rs1))
    elif impurity == "gini":
        gain = (gini_mass(tcnt, ts1) - gini_mass(lcnt, ls1)
                - gini_mass(rcnt, rs1))
    elif impurity == "friedmanmse":
        ml = ls1 / lcnt.clamp_min(1e-12)
        mr = rs1 / rcnt.clamp_min(1e-12)
        d = ml - mr
        gain = lcnt * rcnt / tcnt.clamp_min(1e-12) * (d * d)
    else:  # variance
        gain = sse(tcnt, ts1, ts2) - sse(lcnt, ls1, ls2) - sse(rcnt, rs1,
                                                              rs2)
    return gain, lcnt, rcnt


def class_gain(left: torch.Tensor, tot: torch.Tensor, entropy: bool):
    """K-class gain of a cut after each ordered position from the left
    and segment-total class planes [K, ...] of the same shape: the mass
    drop total*h_tot - left*h_left - right*h_right, gini h = 1 - sum_c
    p_c^2 or entropy h = -sum_c p_c log2 p_c, class terms summed
    c = 0..K-1 in order. It rounds as the JAX package's XLA scan does on
    the CPU, which contracts each class term and the side masses into
    fused multiply-adds (`fma32`); the CUDA kernel uses `fmaf` at the
    same places. Returns (gain, lcnt, rcnt), the counts summed in class
    order."""
    right = tot - left
    lcnt, rcnt = class_sum(left), class_sum(right)
    tcnt = lcnt + rcnt

    def impurity_of(parts, total):
        # each class term a fused multiply-add onto the running sum
        p = parts / total.clamp_min(1e-12)[None]
        q = torch.log2(p.clamp_min(1e-12)) if entropy else p
        acc = torch.zeros_like(total)
        for c in range(parts.shape[0]):
            acc = fma32(p[c], q[c], acc)
        return -acc if entropy else 1.0 - acc

    # contracted as fma(-right, h_right, fma(total, h_tot, -(left*h_left)))
    h_l = impurity_of(left, lcnt)
    gain = fma32(-rcnt, impurity_of(right, rcnt),
                 fma32(tcnt, impurity_of(tot, tcnt), -(lcnt * h_l)))
    return gain, lcnt, rcnt


def split_scan(hist: torch.Tensor, feat_ok_t: torch.Tensor, sl: ScanLayout,
               impurity: str, min_inst: int, min_gain: float):
    """Best split per node from the flat histogram (counterpart of
    `_make_split_scan`). The ordered layout is `jnp.lexsort((sec, seg))`;
    empty categories key +inf and sort last, ties keep slot order; gain
    by `moment_gain`.

    Returns (feature [L] i32, cut_rank [L] i32, rank_flat [L, T] i32,
    leaf_value [L], is_split [L] bool, best_gain [L], left_mask
    [L, s_max] bool, node_cnt [L], left_cnt [L])."""
    cnt, s1 = hist[0], hist[1]
    L, T = cnt.shape
    inf = torch.tensor(float("inf"), device=hist.device)
    mean = torch.where(cnt > 0, s1 / cnt.clamp_min(1e-12), inf)
    sec = torch.where(sl.is_cat_t[None, :], mean,
                      sl.pos_t.to(torch.float32)[None, :].expand(L, T))
    order = _scan_order(sec, sl)
    left, tot = _seg_sums(hist, order, sl)
    gain, lcnt, rcnt = moment_gain(impurity, left, tot)
    # node stats: segment 0's totals (its end in the running sum)
    node_cnt = tot[0][:, 0]
    leaf_value = tot[1][:, 0] / node_cnt.clamp_min(1e-12)
    return _scan_tail(gain, lcnt, rcnt, order, feat_ok_t, sl, min_inst,
                      min_gain, node_cnt, leaf_value)


def cls_scan(hist: torch.Tensor, feat_ok_t: torch.Tensor, sl: ScanLayout,
             impurity: str, min_inst: int, min_gain: float):
    """Multi-class split scan over per-class count planes [K, L, T]
    (counterpart of `_make_cls_scan`, NATIVE RF classification). The
    categorical key is the expected class index sum_c c*h_c / sum_c h_c
    (+inf for empty slots); the gain is `class_gain`'s K-class gini or
    entropy mass drop (hist_pallas.py:416-427); variance/friedmanmse fall
    back to gini, as in the JAX package. Running sums in f64, each
    segment's sums rounded once (the C.2 repair). Leaf value = majority
    class index (first on ties). Returns the same 9-tuple as
    `split_scan`."""
    K, L, T = hist.shape
    inf = torch.tensor(float("inf"), device=hist.device)
    cnt = class_sum(hist)
    ex = torch.zeros_like(cnt)
    for c in range(K):
        ex = ex + float(c) * hist[c]
    mean = torch.where(cnt > 0, ex / cnt.clamp_min(1e-12), inf)
    sec = torch.where(sl.is_cat_t[None, :], mean,
                      sl.pos_t.to(torch.float32)[None, :].expand(L, T))
    order = _scan_order(sec, sl)
    left, tot = _seg_sums(hist, order, sl)
    gain, lcnt, rcnt = class_gain(left, tot, impurity == "entropy")
    node_class = tot[:, :, 0]  # [K, L] segment-0 class totals
    node_cnt = class_sum(node_class)
    leaf_value = torch.argmax(node_class, dim=0).to(torch.float32)
    return _scan_tail(gain, lcnt, rcnt, order, feat_ok_t, sl, min_inst,
                      min_gain, node_cnt, leaf_value)


def scan_of(n_classes: int):
    """The split scan for the histogram's planes."""
    return cls_scan if n_classes >= 3 else split_scan


def leaf_acc(labels, weights, node, active, L: int,
             n_classes: int = 0) -> torch.Tensor:
    """Final-level node totals [C, L] = per node (sum w, sum w*y), or the
    K per-class weighted counts, without a per-slot histogram
    (counterpart of `_make_leaf_fn`). A blocked one-hot contraction keeps
    the sum order fixed, so two runs on the card give the same bits
    (float atomics would not)."""
    dev = labels.device
    n = labels.shape[0]
    nl = torch.where(active, node.clamp(0, L - 1), torch.zeros_like(node))
    comps = comps_of(labels, weights, active, False, n_classes)
    if n_classes < 3:
        comps = comps[:, :2]
    acc = torch.zeros((comps.shape[1], L), dtype=torch.float32, device=dev)
    ids = torch.arange(L, device=dev)
    for a in range(0, n, _LEAF_BLK):
        oh = (nl[a:a + _LEAF_BLK, None] == ids[None, :]).to(torch.float32)
        acc = acc + comps[a:a + _LEAF_BLK].T @ oh
    return acc


def leaf_values(acc: torch.Tensor, n_classes: int = 0) -> torch.Tensor:
    """`leaf_acc` totals -> leaf values: the mean label, or the majority
    class index (first on ties, as jnp.argmax)."""
    if n_classes >= 3:
        return torch.argmax(acc, dim=0).to(torch.float32)
    return acc[1] / acc[0].clamp_min(1e-12)


# ---------------------------------------------------------------------------
# histogram subtraction plan
# ---------------------------------------------------------------------------


def _node_batch_size(T: int, max_stats_memory_mb: int,
                     n_classes: int = 0) -> int:
    """Nodes per histogram batch under the stats-memory budget
    (DTMaster.java:450-467): the [C, L, T] f32 histogram must fit."""
    planes = n_classes if n_classes >= 3 else 3
    budget = max(1, max_stats_memory_mb) * (1 << 20)
    return max(1, budget // (planes * 4 * max(T, 1)))


def _sub_level_fits(L: int, batch_cap: int, acc64: bool = False) -> bool:
    """Memory gate for subtraction at a level of L nodes, in [C, 1, T]
    node planes: retained parent + built half + reconstructed level."""
    f = 2 if acc64 else 1
    half = max(L // 2, 1)
    planes = half * (f + 1) + L * f + (L if acc64 else 0)
    return planes <= batch_cap


def _sub_plan(cfg: TreeTrainConfig, batch_cap: int) -> tuple:
    """Static per-level subtraction decisions (cfg-only, so a resumed run
    picks the same plan). The accumulator chain is pinned to f32."""
    return tuple(
        d >= 1 and cfg.hist_subtraction
        and _sub_level_fits(2 ** d, batch_cap)
        for d in range(cfg.max_depth + 1))


def _plan_counts(sub_levels: tuple, enabled: bool) -> Tuple[int, int, int]:
    """(built, derived, fallback) node-histogram counts of one tree."""
    built = derived = fallback = 0
    for d, sub in enumerate(sub_levels):
        L = 2 ** d
        if sub:
            built += L // 2
            derived += L // 2
        else:
            built += L
            if enabled and d >= 1:
                fallback += 1
    return built, derived, fallback


def _record_hist_counters(built: int, derived: int, fallback: int) -> None:
    """Run-ledger counters for the subtraction win (`tree.hist.built` /
    `tree.hist.derived` / `tree.hist.fallback_rebuilds`, units =
    node-histograms resp. fallback batch rebuilds)."""
    from shifu_tpu_torch.obs import registry

    reg = registry()
    if built:
        reg.counter("tree.hist.built").inc(built)
    if derived:
        reg.counter("tree.hist.derived").inc(derived)
    if fallback:
        reg.counter("tree.hist.fallback_rebuilds").inc(fallback)


def _hist(entry, *args, **kw):
    """A histogram entry call under the `tree.hist` seam, its cost the
    entry's analytic count (ops/hist_bounds.py)."""
    return profile.dispatch("tree.hist", entry, *args, sync=False,
                            cost=hist_bounds.hist_cost, **kw)


def _scan(hist, feat_ok_t, **kw):
    """`scan_level` under the `tree.split_scan` seam."""
    return profile.dispatch("tree.split_scan", hist_kernel.scan_level, hist,
                            feat_ok_t, sync=False,
                            cost=hist_bounds.scan_cost, **kw)


def _sub_row_masks(node, active, left_small):
    """Rows of the built (smaller) children: (parent-slot node ids,
    build-row mask)."""
    built_lsb = torch.where(left_small, 0, 1)
    parent = node >> 1
    return parent, active & ((node & 1) == built_lsb[parent.long()])


def _interleave_children(left_small, built, derived):
    """Per-parent (built, derived) child values in level order [2*Lh,...]:
    the built child sits at 2p when the parent's left side was smaller."""
    Lh = built.shape[0]
    ls = left_small.reshape((Lh,) + (1,) * (built.ndim - 1))
    lh = torch.where(ls, built, derived)
    rh = torch.where(ls, derived, built)
    return torch.stack([lh, rh], dim=1).reshape((2 * Lh,) + built.shape[1:])


def _derive(p_hist, built, p_split, left_small):
    """Sibling = parent - built (zero under non-split parents); returns
    (derived [C, Lh, T], reconstructed level [C, 2*Lh, T])."""
    derived = torch.where(p_split[None, :, None], p_hist - built,
                          torch.zeros_like(p_hist))
    full = torch.stack([_interleave_children(left_small, built[c], derived[c])
                        for c in range(built.shape[0])])
    return derived, full


# ---------------------------------------------------------------------------
# one level-wise tree
# ---------------------------------------------------------------------------


def _route_rows(codes, node, active, resting, L: int, out, sl: ScanLayout):
    """Settle the rows of non-split nodes at (L-1) + slot and send the
    rest to slot 2i / 2i+1 of the next level (`row_update`). Returns
    (node, active, resting)."""
    (bf, br, rank_flat, _lv, is_split, _g, _lm, _nc, _lc) = out
    nl = node.clamp(0, L - 1).long()
    settled = active & ~is_split[nl]
    resting = torch.where(settled, (L - 1) + nl, resting)
    f = torch.where(is_split, bf, torch.zeros_like(bf))[nl].long()
    code = codes.gather(1, f[:, None])[:, 0].long()
    cf = sl.off_f[f] + torch.minimum(code.clamp_min(0), sl.clip_f[f])
    goes_left = rank_flat[nl, cf] <= br[nl]
    still = is_split[nl] & active
    node = torch.where(still, torch.where(goes_left, 2 * nl, 2 * nl + 1),
                       torch.zeros_like(nl)).to(torch.int32)
    return node, still, resting


class _Rows:
    """The rows of one tree: on one device, or over a mesh's row shards.
    Per shard s its inputs (`codes[s]`, `codes8[s]`, `labels[s]`,
    `weights[s]` on `mesh.devices[s]`) and its level state (`node`,
    `active`, `resting`). `hist` builds a level's histogram: on one
    device one `hist_level` call; on a mesh one call a shard, merged on
    the lead device in shard order (JAX: the histogram-only kernel per
    device inside shard_map, then the psum). On the card each shard's
    fixed-point sums merge unconverted (`hist_level_acc`, `merge_acc`):
    the planes of one call over every row. On the CPU the shards' f32
    planes add in f64 and round once: exact for integer planes (RF, and
    every NATIVE count plane), so RF forests equal the one-device forest
    bit for bit."""

    def __init__(self, mesh, codes, codes8, labels, weights, kw: dict):
        self.mesh = mesh
        self.codes, self.codes8 = codes, codes8
        self.labels, self.weights = labels, weights
        self.kw = kw
        self.node = [torch.zeros(c.shape[0], dtype=torch.int32,
                                 device=c.device) for c in codes]
        self.active = [torch.ones(c.shape[0], dtype=torch.bool,
                                  device=c.device) for c in codes]
        self.resting = [torch.zeros(c.shape[0], dtype=torch.long,
                                    device=c.device) for c in codes]

    @property
    def lead(self) -> torch.device:
        return self.codes[0].device

    def hist(self, L: int, select=None) -> torch.Tensor:
        """[C, L, T] f32 histogram on the lead device of the rows that
        `select(node, active) -> (node slot, build mask)` picks on each
        shard (default: the level's active rows at their node)."""
        parts = []
        for s, c in enumerate(self.codes):
            nd, ac = self.node[s], self.active[s]
            if select is not None:
                nd, ac = select(nd, ac)
            args = (c, self.labels[s], self.weights[s], nd, ac)
            kw = dict(L=L, codes8=self.codes8[s], **self.kw)
            if self.mesh is None:
                return _hist(hist_kernel.hist_level, *args, **kw)
            parts.append(_hist(hist_kernel.hist_level_acc, *args, **kw)
                         if c.device.type == "cuda"
                         else _hist(hist_kernel.hist_level, *args, **kw))
        if self.lead.type == "cuda":
            return hist_kernel.merge_acc(parts)
        return psum([p.double() for p in parts], self.mesh).float()

    def route(self, out, L: int, lay) -> None:
        """Each shard routes its own rows by the level's decisions, copied
        once to each device."""
        on: Dict[torch.device, tuple] = {}
        for s, c in enumerate(self.codes):
            dev = c.device
            if dev not in on:
                on[dev] = tuple(x.to(dev) for x in out)
            self.node[s], self.active[s], self.resting[s] = (
                profile.dispatch(
                    "tree.row_update", _route_rows, c, self.node[s],
                    self.active[s], self.resting[s], L, on[dev],
                    scan_layout(lay, dev), sync=False))

    def leaf_totals(self, L: int, n_classes: int) -> torch.Tensor:
        """`leaf_acc` node totals of the final level on the lead device:
        a shard's f32 totals, added in f64 in shard order, rounded once."""
        parts = [leaf_acc(self.labels[s], self.weights[s], self.node[s],
                          self.active[s], L, n_classes)
                 for s in range(len(self.codes))]
        if self.mesh is None:
            return parts[0]
        return psum([p.double() for p in parts], self.mesh).float()

    def settle(self, L: int) -> None:
        """Rows still active rest at the final level's node."""
        self.resting = [torch.where(a, (L - 1) + nd.long(), r) for nd, a, r
                        in zip(self.node, self.active, self.resting)]

    def gather(self, leaf_flat: torch.Tensor) -> List[torch.Tensor]:
        """Each shard's rows' values at their resting slot."""
        return [leaf_flat.to(r.device)[r] for r in self.resting]


def _grow_tree(rows: _Rows, feat_ok_t, *, lay, cfg, sub_levels: tuple):
    """One level-wise tree (counterpart of `_get_tree_program`'s body).
    Returns (feat_flat, mask_flat, leaf_flat, row_pred a shard) — the
    flat arrays are the DenseTree level-order layout. On one device the
    levels of at most `_FUSED_SCAN_L_CAP` nodes take the fused entry; on
    a mesh never (JAX `_pallas_state`: a shard's histogram is a partial
    until merged), every level `rows.hist` then `scan_level`."""
    D = cfg.max_depth
    dev = rows.lead
    fuse = rows.mesh is None
    min_inst = max(cfg.min_instances_per_node, 1)
    K = cfg.n_classes
    skw = dict(impurity=cfg.impurity, min_inst=min_inst,
               min_gain=cfg.min_info_gain)
    feats_l, masks_l, leaves_l = [], [], []
    prev = None  # retained parent level (hist, is_split, lcnt, ncnt)

    def scan(hist):
        return _scan(hist, feat_ok_t, lay=lay, n_classes=K, **skw)

    def fused(node, active, L):
        return profile.dispatch(
            "tree.pallas_fused", hist_kernel.fused_level,
            rows.codes[0], rows.labels[0], rows.weights[0], node, active,
            feat_ok_t, L=L, codes8=rows.codes8[0], sync=False,
            cost=hist_bounds.fused_cost, **rows.kw, **skw)

    for d in range(D):
        L = 2 ** d
        if prev is not None:
            p_hist, p_split, p_lcnt, p_ncnt = prev
            left_small = p_lcnt <= p_ncnt - p_lcnt

            def half(nd, ac, ls=left_small):
                return _sub_row_masks(nd, ac, ls.to(nd.device))

            if fuse and L // 2 <= _FUSED_SCAN_L_CAP:
                # the kernel grows only the smaller child (histogram and
                # its scan in one pass); the sibling derives in torch and
                # takes the scan-only entry, then both interleave per
                # parent
                built, scan_b = fused(*half(rows.node[0], rows.active[0]),
                                      L // 2)
                derived, hist = profile.dispatch(
                    "tree.hist_derive", _derive, p_hist, built, p_split,
                    left_small, sync=False)
                out = tuple(_interleave_children(left_small, xb, xd)
                            for xb, xd in zip(scan_b, scan(derived)))
            else:
                built = rows.hist(L // 2, half)
                _derived, hist = profile.dispatch(
                    "tree.hist_derive", _derive, p_hist, built, p_split,
                    left_small, sync=False)
                out = scan(hist)
        elif fuse and L <= _FUSED_SCAN_L_CAP:
            hist, out = fused(rows.node[0], rows.active[0], L)
        else:
            hist = rows.hist(L)
            out = scan(hist)
        (bf, _br, _rank, lv, is_split, _g, lm, nc, lc) = out
        prev = ((hist, is_split, lc, nc)
                if d + 1 < D and sub_levels[d + 1] else None)
        rows.route(out, L, lay)
        feats_l.append(torch.where(is_split, bf, torch.full_like(bf, -1)))
        masks_l.append(lm)
        leaves_l.append(lv)

    # final level: node totals only (no per-slot histogram)
    L2 = 2 ** D
    leaves_l.append(leaf_values(rows.leaf_totals(L2, K), K))
    rows.settle(L2)
    feat_flat = torch.cat(feats_l + [torch.full((L2,), -1, dtype=torch.int32,
                                                device=dev)])
    mask_flat = torch.cat(masks_l + [torch.zeros((L2, lay.s_max),
                                                 dtype=torch.bool,
                                                 device=dev)])
    leaf_flat = torch.cat(leaves_l)
    return feat_flat, mask_flat, leaf_flat, rows.gather(leaf_flat)


def build_tree(rows: _Rows, feat_ok_t, *, lay, cfg, sub_levels: tuple,
               batch_cap: int) -> DenseTree:
    """One level-wise tree driven level by level from the host
    (counterpart of `build_tree`'s batched loop, taken when 2**max_depth
    nodes pass the stats-memory node batch `batch_cap`). A level builds
    its histogram one of three ways: the smaller children only, the
    sibling derived from the retained parent (`sub_levels`); a full
    rebuild kept for the next level's derivation; or batches of at most
    `batch_cap` nodes, each scanned as it is built and dropped. Each
    histogram is `rows.hist`'s (on a mesh, a call a shard, merged). The
    final level's leaf values come from its scan; `rows.resting` holds
    each row's resting slot."""
    D = cfg.max_depth
    dev = rows.lead
    K = cfg.n_classes

    def scan(h):
        return _scan(h, feat_ok_t, lay=lay, impurity=cfg.impurity,
                     min_inst=cfg.min_instances_per_node,
                     min_gain=cfg.min_info_gain, n_classes=K)

    sub_on = cfg.hist_subtraction
    n_built = n_derived = n_fallback = 0
    feats_l, masks_l, leaves_l = [], [], []
    prev = None  # retained parent level (hist, is_split, lcnt, ncnt)
    for depth in range(D + 1):
        L = 2 ** depth
        final = depth == D
        # retention for the next level's derivation implies that level
        # passed the gate, so this level is at most cap/4 nodes: one batch
        retain_next = (not final) and sub_on and sub_levels[depth + 1]
        level_hist = None
        if prev is not None:  # half-width build + derive
            p_hist, p_split, p_lcnt, p_ncnt = prev
            left_small = p_lcnt <= p_ncnt - p_lcnt
            built = rows.hist(L // 2, lambda nd, ac: _sub_row_masks(
                nd, ac, left_small.to(nd.device)))
            _derived, level_hist = profile.dispatch(
                "tree.hist_derive", _derive, p_hist, built, p_split,
                left_small, sync=False)
            out = scan(level_hist)
            n_built += L // 2
            n_derived += L // 2
        elif retain_next:  # full rebuild, kept whole for the next level
            level_hist = rows.hist(L)
            out = scan(level_hist)
            n_built += L
            if sub_on and depth >= 1:
                n_fallback += 1
        else:  # budget-batched full rebuild, each batch dropped once scanned
            parts = []
            for b0 in range(0, L, batch_cap):
                Lb = min(batch_cap, L - b0)
                parts.append(scan(rows.hist(Lb, lambda nd, ac, b0=b0, Lb=Lb: (
                    nd - b0, ac & (nd >= b0) & (nd < b0 + Lb)))))
            out = tuple(torch.cat(xs) for xs in zip(*parts))
            n_built += L
            if sub_on and depth >= 1:
                n_fallback += -(-L // batch_cap)
        (bf, _br, _rank, lv, is_split, _g, lm, nc, lc) = out
        if final:  # leaf values of the deepest nodes, leftovers settle
            leaves_l.append(lv)
            feats_l.append(torch.full((L,), -1, dtype=torch.int32,
                                      device=dev))
            masks_l.append(torch.zeros((L, lay.s_max), dtype=torch.bool,
                                       device=dev))
            rows.settle(L)
            break
        prev = (level_hist, is_split, lc, nc) if retain_next else None
        rows.route(out, L, lay)
        feats_l.append(torch.where(is_split, bf, torch.full_like(bf, -1)))
        masks_l.append(lm)
        leaves_l.append(lv)
    _record_hist_counters(n_built, n_derived, n_fallback)
    return DenseTree(
        feature=torch.cat(feats_l).cpu().numpy().astype(np.int32),
        left_mask=torch.cat(masks_l).cpu().numpy().astype(bool),
        leaf_value=torch.cat(leaves_l).cpu().numpy().astype(np.float32))


def build_tree_leafwise(codes, codes8, labels, weights, feat_ok_t, *, lay,
                        cfg, batch_cap: int, lowp: bool,
                        int_planes: bool = False
                        ) -> Tuple[DenseTree, torch.Tensor]:
    """Leaf-wise growth under max_leaves (counterpart of
    `build_tree_leafwise`; DTMaster.java:137's toSplitQueue splits the
    best-gain leaf first). Each split evaluates only the two new leaves,
    each a one-node histogram (`hist_level` at L = 1 over the rows of
    that leaf) and its scan. A split leaf's histogram is kept while
    (kept + 1) node planes fit `batch_cap`; its split then builds the
    smaller child only and derives the sibling as parent - built (f32,
    as the JAX package without x64). Nodes append parent before child,
    so children get explicit pointers and the tree may be lopsided.
    Returns (tree, resting node id [n])."""
    dev = codes.device
    n = codes.shape[0]
    K = cfg.n_classes
    kw = dict(lay=lay, low_precision=lowp, codes8=codes8, n_classes=K,
              int_planes=int_planes)
    max_nodes = 2 * cfg.max_leaves - 1
    node_id = torch.zeros(n, dtype=torch.int32, device=dev)
    slot0 = torch.zeros(n, dtype=torch.int32, device=dev)

    # the growing tree on the host, parent before child
    feature, left_c, right_c = [-1], [-1], [-1]
    leaf_val = [0.0]
    masks = [np.zeros(lay.s_max, bool)]
    depth_of = {0: 0}
    # leaf id -> (gain, feature, cut rank, rank row [T], mask, lcnt, ncnt)
    candidates: Dict[int, tuple] = {}
    stored: Dict[int, torch.Tensor] = {}  # leaf id -> its [C, 1, T] hist
    sub_on = cfg.hist_subtraction
    n_built = n_derived = n_fallback = 0

    def build_hist(lid: int) -> torch.Tensor:
        return hist_kernel.hist_level(codes, labels, weights, slot0,
                                      node_id == lid, L=1, **kw)

    def evaluate(lid: int, hist: torch.Tensor) -> None:
        """The candidate split of one leaf from its (built or derived)
        histogram; one host copy of its scalars and mask."""
        (f, c, r, lv, sp, g, m, nc, lc) = hist_kernel.scan_level(
            hist, feat_ok_t, lay=lay, impurity=cfg.impurity,
            min_inst=cfg.min_instances_per_node,
            min_gain=cfg.min_info_gain, n_classes=K)
        h = torch.cat([torch.stack([x[0].double() for x in
                                    (lv, sp, g, f, c, lc, nc)]),
                       m[0].double()]).cpu().numpy()
        leaf_val[lid] = float(h[0])
        if h[1] and depth_of[lid] < cfg.max_depth:
            candidates[lid] = (float(h[2]), int(h[3]), int(h[4]), r[0],
                               h[7:] > 0.5, float(h[5]), float(h[6]))
            if sub_on and len(stored) + 1 <= batch_cap:
                stored[lid] = hist

    evaluate(0, build_hist(0))
    n_built += 1
    n_leaves = 1
    while n_leaves < cfg.max_leaves and candidates:
        best_id = max(candidates, key=lambda k: candidates[k][0])
        (_gain, bf, cut, rank_row, mask_row, lcnt,
         ncnt) = candidates.pop(best_id)
        parent_hist = stored.pop(best_id, None)
        li, ri = len(feature), len(feature) + 1
        if ri > max_nodes:
            break
        feature[best_id] = bf
        left_c[best_id] = li
        right_c[best_id] = ri
        masks[best_id] = mask_row
        for _ in range(2):
            feature.append(-1)
            left_c.append(-1)
            right_c.append(-1)
            leaf_val.append(0.0)
            masks.append(np.zeros(lay.s_max, bool))
        depth_of[li] = depth_of[ri] = depth_of[best_id] + 1
        # reroute the rows of the split leaf
        code = codes[:, bf].long().clamp(0, int(lay.clip_max[bf]))
        goes_left = rank_row[int(lay.off[bf]) + code] <= cut
        sel = node_id == best_id
        node_id = torch.where(sel & goes_left, li,
                              torch.where(sel, ri, node_id))
        n_leaves += 1
        if parent_hist is not None:
            # build the smaller child, derive the sibling from the parent
            smaller, larger = ((li, ri) if lcnt <= ncnt - lcnt
                               else (ri, li))
            built = build_hist(smaller)
            derived = parent_hist - built
            evaluate(smaller, built)
            evaluate(larger, derived)
            n_built += 1
            n_derived += 1
        else:
            evaluate(li, build_hist(li))
            evaluate(ri, build_hist(ri))
            n_built += 2
            if sub_on:
                n_fallback += 1
    _record_hist_counters(n_built, n_derived, n_fallback)
    tree = DenseTree(feature=np.asarray(feature, np.int32),
                     left_mask=np.stack(masks).astype(bool),
                     leaf_value=np.asarray(leaf_val, np.float32),
                     left=np.asarray(left_c, np.int32),
                     right=np.asarray(right_c, np.int32))
    return tree, node_id


# ---------------------------------------------------------------------------
# early stop (dt/DTEarlyStopDecider.java:49)
# ---------------------------------------------------------------------------


class _MinQueue:
    def __init__(self, capacity: int):
        self.capacity = capacity
        self.restart()

    def restart(self):
        self.min = float("inf")
        self.size = -1

    def add(self, v: float) -> bool:
        self.min = min(self.min, v)
        self.size += 1
        return self.size >= self.capacity

    def pop_min(self) -> float:
        m = self.min
        self.restart()
        return m


class _AverageQueue:
    def __init__(self, capacity: int):
        self.capacity = capacity
        self.arr = [0.0] * capacity
        self.restart()

    def restart(self):
        self.total = 0
        self.sum = 0.0

    def add(self, v: float) -> bool:
        idx = self.total % self.capacity
        self.total += 1
        if self.total <= self.capacity:
            self.sum += v
            self.arr[idx] = self.sum / self.total
            return False
        self.sum += v - self.arr[idx]
        self.arr[idx] = self.sum / self.capacity
        return True

    def gain(self) -> float:
        cur = (self.total - 1) % self.capacity
        last = (self.total - 2) % self.capacity
        return self.arr[last] - self.arr[cur]


class DTEarlyStopDecider:
    """Windowed early stop: min over a window feeds a moving average; when
    the average's gain stays ~zero for 3 windows the decider restarts, and
    3 restarts mean stop (MAGIC_NUMBER=3, NEARLY_ZERO=1e-6)."""

    MAGIC = 3
    NEARLY_ZERO = 1e-6

    def __init__(self, tree_depth: int):
        if tree_depth <= 0:
            raise ValueError("tree depth must be positive")
        self.min_queue = _MinQueue(tree_depth * self.MAGIC)
        self.avg_queue = _AverageQueue(tree_depth)
        self.gain_zero_count = 0
        self.restart_count = 0

    def add(self, validation_error: float) -> bool:
        if self.min_queue.add(validation_error):
            m = self.min_queue.pop_min()
            if self.avg_queue.add(m):
                if self.avg_queue.gain() < self.NEARLY_ZERO:
                    self.gain_zero_count += 1
                    if self.gain_zero_count >= self.MAGIC:
                        self.avg_queue.restart()
                        self.restart_count += 1
                        self.gain_zero_count = 0
                else:
                    self.gain_zero_count = 0
        return self.can_stop()

    def can_stop(self) -> bool:
        return self.restart_count >= self.MAGIC


# ---------------------------------------------------------------------------
# full training run
# ---------------------------------------------------------------------------


@dataclass
class TreeTrainResult:
    spec: TreeModelSpec
    train_error: float
    valid_error: float


def _errors(score, y, vm):
    """(train_err, valid_err) mean squared error on each side of the
    valid split (device scalars)."""
    sq = (y - score) ** 2
    zero = torch.zeros_like(sq)
    v = torch.where(vm, sq, zero).sum() / vm.sum().clamp_min(1)
    t = torch.where(~vm, sq, zero).sum() / (~vm).sum().clamp_min(1)
    return t, v


def _cls_errors(votes, y, vm):
    """(train_err, valid_err) misclassification rate of the forest's
    majority vote (counterpart of `_get_cls_errors_program`; ties go to
    the first class)."""
    err = (torch.argmax(votes, dim=1).to(torch.float32) != y).to(
        torch.float32)
    zero = torch.zeros_like(err)
    v = torch.where(vm, err, zero).sum() / vm.sum().clamp_min(1)
    t = torch.where(~vm, err, zero).sum() / (~vm).sum().clamp_min(1)
    return t, v


def _votes_of(trees: List[DenseTree], codes, n_classes: int):
    """[n, K] per-class votes of an existing forest (resume: the workers'
    re-derivation of the prediction state)."""
    n = codes.shape[0]
    votes = torch.zeros((n, n_classes), dtype=torch.float32,
                        device=codes.device)
    if trees:
        per_tree = traverse_trees(trees, codes)
        for col in range(per_tree.shape[1]):
            votes = votes + _one_vote(per_tree[:, col], n_classes)
    return votes


def _one_vote(tree_pred, n_classes: int) -> torch.Tensor:
    cls = tree_pred.to(torch.int64).clamp(0, n_classes - 1)
    return torch.nn.functional.one_hot(cls, n_classes).to(torch.float32)


def _score_existing(trees: List[DenseTree], codes) -> torch.Tensor:
    """Raw GBT prediction of an existing forest, folded tree by tree like
    the live run (a pairwise sum would round differently on resume)."""
    score = torch.zeros(codes.shape[0], dtype=torch.float32,
                        device=codes.device)
    if not trees:
        return score
    per_tree = traverse_trees(trees, codes)
    for t in range(per_tree.shape[1]):
        score = score + per_tree[:, t]
    return score


def _as_device(a, dtype, dev):
    if isinstance(a, torch.Tensor):
        return a.to(device=dev, dtype=dtype).contiguous()
    np_dt = {torch.int32: np.int32, torch.float32: np.float32}[dtype]
    a = np.ascontiguousarray(np.asarray(a, np_dt))
    if not a.flags.writeable:
        # a read-only buffer (a memory map, another library's array):
        # on the CPU the tensor would share it, and a write through the
        # tensor is undefined, so it gets its own copy
        a = a.copy()
    return torch.as_tensor(a, device=dev)


def _assemble(trees: List, deferred: List[tuple]) -> None:
    """Device results -> DenseTrees, one host copy for the backlog."""
    if not deferred:
        return
    f_all = torch.stack([f for _k, _w, f, _m, _lv in deferred]).cpu().numpy()
    m_all = torch.stack([m for _k, _w, _f, m, _lv in deferred]).cpu().numpy()
    l_all = torch.stack([lv for _k, _w, _f, _m, lv in deferred]).cpu().numpy()
    for i, (k, weight_k, _f, _m, _lv) in enumerate(deferred):
        trees[k] = DenseTree(feature=np.asarray(f_all[i], np.int32),
                             left_mask=np.asarray(m_all[i], bool),
                             leaf_value=np.asarray(l_all[i], np.float32),
                             weight=weight_k)
    deferred.clear()


def _sharded_errors(row_err: List[torch.Tensor], vm: List[torch.Tensor],
                    real: List[torch.Tensor], mesh):
    """(train_err, valid_err) of per-row errors over a mesh's shards: each
    shard's error sums and row counts on its real rows, added on the lead
    device in shard order (JAX: the errors program over row-sharded
    arrays, `real` masking the padding). The lists may hold several
    groups of `mesh.size` shards (a streamed set's file shards, each over
    the mesh): each group's sums `psum`, then the groups' in order."""
    S = mesh.size

    def sums(sel):
        num = cnt = None
        for g in range(0, len(sel), S):
            n_g = psum([torch.where(m, e, torch.zeros_like(e)).sum()
                        for e, m in zip(row_err[g:g + S], sel[g:g + S])],
                       mesh)
            c_g = psum([m.sum() for m in sel[g:g + S]], mesh)
            num = n_g if num is None else num + n_g
            cnt = c_g if cnt is None else cnt + c_g
        return num / cnt.clamp_min(1)

    return (sums([~v & r for v, r in zip(vm, real)]),
            sums([v & r for v, r in zip(vm, real)]))


def train_trees(
    codes,
    tags,
    weights,
    slots: List[int],
    is_cat: List[bool],
    columns: List[str],
    cfg: TreeTrainConfig,
    boundaries: Optional[List] = None,
    categories: Optional[List] = None,
    progress_cb=None,
    init_trees: Optional[List[DenseTree]] = None,
    init_valid_errors: Optional[List[float]] = None,
    checkpoint_cb: Optional[
        Callable[[int, List[DenseTree], List[float]], None]] = None,
    device: DeviceLike = None,
    mesh=None,
) -> TreeTrainResult:
    """Full GBT/RF training run on one device (`device=None` = cuda), or
    over the row shards of `mesh` (`parallel.mesh.Mesh`; its devices
    replace `device`; the DTWorker row shards). On a mesh the rows pad to
    a multiple of the shard count with zero weight after every draw, so
    the valid split, the bags and the feature subsets are the
    one-device run's (JAX `train_trees`); a one-shard mesh is the
    one-device run. Leaf-wise growth ignores the mesh, with the JAX
    package's warning.

    `init_trees` continues from an existing forest: per-tree draws are
    keyed by (seed, tree index), so trees k..N after loading 0..k-1
    reproduce the uninterrupted run. `checkpoint_cb(k, trees,
    valid_errors)` fires after each tree."""
    leaf_wise = cfg.max_leaves > 0
    if mesh is not None and leaf_wise:
        log.warning("leaf-wise growth runs single-device; ignoring mesh")
        device, mesh = mesh.lead, None
    mesh, dev = mesh_device(mesh, device)
    n, F = codes.shape
    valid_mask = np.random.default_rng([cfg.seed, 999_983]).random(n) \
        < cfg.valid_set_rate
    if mesh is None:
        codes_s = [_as_device(codes, torch.int32, dev)]
        y_s = [_as_device(tags, torch.float32, dev)]
        w_t = _as_device(weights, torch.float32, dev)
        vm_s = [torch.as_tensor(valid_mask, device=dev)]
        base_w_s = [torch.where(vm_s[0], torch.zeros_like(w_t), w_t)]
        real_s = None

        def split(a):
            return [torch.as_tensor(a, device=dev)]
    else:
        def host(a, dt):
            a = a.cpu().numpy() if isinstance(a, torch.Tensor) else a
            return np.asarray(a, dt)

        def split(a):  # zero rows to a multiple of the shards, sharded
            return shard_rows(pad_rows([np.asarray(a)], mesh.size)[0][0],
                              mesh)

        codes_s = split(host(codes, np.int32))
        y_s = split(host(tags, np.float32))
        base_w_s = split(np.where(valid_mask, 0.0, host(weights, np.float32))
                         .astype(np.float32))
        vm_s = split(valid_mask)
        real_s = split(np.ones(n, dtype=bool))
    slots_np = np.asarray(slots, dtype=np.int32)
    is_cat_np = np.asarray(is_cat, dtype=bool)
    lay = make_layout([int(s) for s in slots_np], [bool(c) for c in is_cat_np])
    batch_cap = _node_batch_size(lay.T, cfg.max_stats_memory_mb,
                                 cfg.n_classes)
    is_cls = cfg.n_classes >= 3
    if is_cls and cfg.algorithm == "GBT":
        raise ValueError(
            "NATIVE multi-class tree training is RF-only (the reference "
            "supports GBT multi-class via ONEVSALL, "
            "TrainModelProcessor.java:341-349)"
        )

    def keep_of(k):  # DART keep mask of tree k, a shard
        return split((np.random.default_rng([cfg.seed, k, 777]).random(n)
                      >= cfg.dropout_rate).astype(np.float32))

    k_sub = subset_count(cfg.feature_subset_strategy, F)
    trees: List = list(init_trees or [])
    start_k = len(trees)
    lr = cfg.learning_rate
    is_gbt = cfg.algorithm == "GBT"
    log_loss = cfg.loss == "log"

    # prediction state re-derived from loaded trees on resume: GBT keeps
    # the raw sum F(x), RF the running mean, classification per-class votes
    votes = ([_votes_of(trees, c, cfg.n_classes) for c in codes_s]
             if is_cls else None)
    if start_k and not is_cls:
        if is_gbt and cfg.dropout_rate > 0.0:
            # DART resume: regenerate each tree's keyed keep mask
            ss = []
            for c in codes_s:
                per_tree = traverse_trees(trees, c)
                ss.append([torch.zeros(c.shape[0], dtype=torch.float32,
                                       device=c.device), per_tree])
            for col in range(len(trees)):
                keeps = keep_of(col) if col > 0 else None
                for i, (acc, per_tree) in enumerate(ss):
                    contrib = per_tree[:, col]
                    if keeps is not None:
                        contrib = contrib * keeps[i]
                    ss[i][0] = acc + contrib
            s = [acc for acc, _ in ss]
        else:
            s = [_score_existing(trees, c) for c in codes_s]
        pred = s if is_gbt else [x / start_k for x in s]
    else:
        pred = [torch.zeros(c.shape[0], dtype=torch.float32, device=c.device)
                for c in codes_s]
    valid_errors: List = list(init_valid_errors or [])[:start_k]
    bad_rounds = 0
    decider = (DTEarlyStopDecider(cfg.max_depth)
               if cfg.enable_early_stop else None)
    for idx, v in enumerate(valid_errors):
        if decider is not None:
            decider.add(v)
        if cfg.early_stop_rounds and idx >= 1:
            bad_rounds = bad_rounds + 1 if v > min(valid_errors[:idx + 1]) \
                else 0
    terr = 0.0
    need_sync = bool(progress_cb or checkpoint_cb or cfg.early_stop_rounds
                     or decider is not None)

    # leaf-wise under max_leaves; else the level-wise tree of `_grow_tree`
    # while its widest level fits the stats-memory node batch, else the
    # host-batched `build_tree`
    fused = not leaf_wise and 2 ** cfg.max_depth <= batch_cap
    sub_levels = _sub_plan(cfg, batch_cap)
    sub_counts = _plan_counts(sub_levels[:cfg.max_depth],
                              cfg.hist_subtraction)
    lowp = is_gbt  # bf16 component planes for GBT; RF stays exact f32
    # (multi-class is RF-only, so its count planes are f32 too)
    # int8 code planes, hoisted once per forest (codes are tree- and
    # level-independent), when every feature fits 128 slots
    codes8_s = [hist_kernel.codes8_of(c, lay) if lay.s_max <= 128 else None
                for c in codes_s]
    # RF planes under integer weights (and, for the moments, labels) are
    # integers: the kernels' 32-bit shared bins, decided once a forest
    # (padding rows add zeros, integers)
    int_planes = all(int_planes_of(y, w, cfg.n_classes, lowp)
                     for y, w in zip(y_s, base_w_s))
    hkw = dict(lay=lay, low_precision=lowp, n_classes=cfg.n_classes,
               int_planes=int_planes)
    fot_all = (torch.ones(lay.T, dtype=torch.bool, device=dev)
               if k_sub >= F else None)

    # per-tree draws keyed by (seed, tree index), as the JAX package
    feat_oks: Dict[int, np.ndarray] = {}
    bags: Dict[int, np.ndarray] = {}
    for k in range(start_k, cfg.tree_num):
        rng_k = np.random.default_rng([cfg.seed, k])
        if cfg.algorithm == "RF":
            if cfg.bagging_with_replacement:
                bags[k] = rng_k.poisson(cfg.bagging_sample_rate, size=n)
            else:
                bags[k] = rng_k.random(n) < cfg.bagging_sample_rate
        feat_ok = np.zeros(F, dtype=bool)
        if k_sub >= F:
            feat_ok[:] = True
        else:
            feat_ok[rng_k.choice(F, size=k_sub, replace=False)] = True
        feat_oks[k] = feat_ok

    deferred: List[tuple] = []
    err_pairs: List[tuple] = []
    for k in range(start_k, cfg.tree_num):
        if cfg.algorithm == "RF":
            bag = split(bags[k].astype(np.uint16).astype(np.float32))
            w_k = [w * b for w, b in zip(base_w_s, bag)]
            labels_k = y_s
        else:  # GBT: fit the negative loss gradient
            w_k = base_w_s
            labels_k = [(y - 1.0 / (1.0 + torch.exp(-p)) if log_loss
                         else y - p) for y, p in zip(y_s, pred)]
        fot = fot_all if fot_all is not None else torch.as_tensor(
            feat_oks[k][lay.seg_of_t], device=dev)
        weight_k = 1.0 if (is_gbt and k == 0) else (lr if is_gbt else 1.0)
        if leaf_wise:
            # the leaf-wise grower syncs with the host as it goes: its
            # trees come back one at a time
            tree, node_id = build_tree_leafwise(
                codes_s[0], codes8_s[0], labels_k[0], w_k[0], fot, lay=lay,
                cfg=cfg, batch_cap=batch_cap, lowp=lowp,
                int_planes=int_planes)
            tree.weight = weight_k
            trees.append(tree)
            tree_pred = [torch.as_tensor(tree.leaf_value,
                                         device=dev)[node_id.long()]]
        else:
            rows = _Rows(mesh, codes_s, codes8_s, labels_k, w_k, hkw)
            if fused:
                feats_d, masks_d, leaves_d, tree_pred = _grow_tree(
                    rows, fot, lay=lay, cfg=cfg, sub_levels=sub_levels)
                _record_hist_counters(*sub_counts)
                deferred.append((k, weight_k, feats_d, masks_d, leaves_d))
                trees.append(None)  # assembled from `deferred`
            else:  # host-batched: its trees come back one at a time
                tree = build_tree(rows, fot, lay=lay, cfg=cfg,
                                  sub_levels=sub_levels, batch_cap=batch_cap)
                tree.weight = weight_k
                trees.append(tree)
                tree_pred = rows.gather(torch.as_tensor(tree.leaf_value,
                                                        device=dev))

        if is_cls:
            votes = [v + _one_vote(tp, cfg.n_classes)
                     for v, tp in zip(votes, tree_pred)]
            if mesh is None:
                t_e, v_e = profile.dispatch(
                    "tree.errors", _cls_errors, votes[0], y_s[0], vm_s[0],
                    sync=False)
            else:
                t_e, v_e = profile.dispatch(
                    "tree.errors", _sharded_errors,
                    [(torch.argmax(v, dim=1).to(torch.float32) != y)
                     .to(torch.float32) for v, y in zip(votes, y_s)],
                    vm_s, real_s, mesh, sync=False)
        else:
            if is_gbt:
                if cfg.dropout_rate > 0.0 and k > 0:
                    # DART-ish per-row dropout of this tree's contribution
                    # to the running prediction (never the model)
                    pred = [p + weight_k * tp * kp for p, tp, kp
                            in zip(pred, tree_pred, keep_of(k))]
                else:
                    pred = [p + weight_k * tp
                            for p, tp in zip(pred, tree_pred)]
                score = [(1.0 / (1.0 + torch.exp(-p)) if log_loss
                          else p.clamp(0.0, 1.0)) for p in pred]
            else:  # RF running mean over trees built so far
                pred = [tp if k == 0 else (p * k + tp) / (k + 1)
                        for p, tp in zip(pred, tree_pred)]
                score = [p.clamp(0.0, 1.0) for p in pred]
            if mesh is None:
                t_e, v_e = profile.dispatch(
                    "tree.errors", _errors, score[0], y_s[0], vm_s[0],
                    sync=False)
            else:
                t_e, v_e = profile.dispatch(
                    "tree.errors", _sharded_errors,
                    [(y - sc) ** 2 for y, sc in zip(y_s, score)], vm_s,
                    real_s, mesh, sync=False)
        if not need_sync:
            err_pairs.append((t_e, v_e))
            valid_errors.append(None)  # filled after the final sync
            continue
        _assemble(trees, deferred)
        terr, verr = float(t_e), float(v_e)
        valid_errors.append(verr)
        if progress_cb:
            progress_cb(k + 1, terr, verr)
        if checkpoint_cb:
            checkpoint_cb(k + 1, trees, valid_errors)
        if decider is not None and decider.add(verr):
            log.info("windowed early stop after %d trees "
                     "(DTEarlyStopDecider)", k + 1)
            break
        if cfg.early_stop_rounds and len(valid_errors) > 1:
            if verr > min(valid_errors):
                bad_rounds += 1
                if bad_rounds >= cfg.early_stop_rounds:
                    log.info("early stop after %d trees", k + 1)
                    break
            else:
                bad_rounds = 0

    _assemble(trees, deferred)
    if err_pairs:
        host = torch.stack([torch.stack(p) for p in err_pairs]).cpu().numpy()
        errs = [(float(t), float(v)) for t, v in host]
        terr = errs[-1][0]
        j = 0
        for i in range(len(valid_errors)):
            if valid_errors[i] is None:
                valid_errors[i] = errs[j][1]
                j += 1

    spec = TreeModelSpec(
        algorithm=cfg.algorithm,
        trees=trees,
        input_columns=list(columns),
        slots=[int(s) for s in slots],
        boundaries=boundaries or [None] * F,
        categories=categories or [None] * F,
        loss=cfg.loss,
        learning_rate=lr,
        init_pred=0.0,
        convert_to_prob="SIGMOID" if cfg.loss == "log" else "RAW",
        train_error=terr,
        valid_error=valid_errors[-1] if valid_errors else None,
        n_classes=cfg.n_classes,
    )
    return TreeTrainResult(spec=spec, train_error=terr,
                           valid_error=valid_errors[-1] if valid_errors
                           else 0.0)

"""Larger-than-memory GBT/RF: the bin-code shards stream once per tree
level (counterpart of `shifu_tpu/train/streaming_tree.py`, one card).

The per-row STATE of tree building (labels, weights, node, activity,
resting node, prediction: a few bytes a row) stays on the device for
every shard; only the [n, F] code matrix is too big, and it streams from
the mmap'd CleanedData shards:

    per level:  for each shard s (read on the prefetch thread):
                    copy the int16 codes to the device, widen to int32
                    (and int8 `codes8_of` rows when every feature fits)
                    route its rows by the PREVIOUS level's decisions
                    hist += hist_level(codes_s, ...)   (CUDA kernel)
                    drop the shard's codes
                split scan of the merged histogram     (scan_level)
    last level: node totals a shard where the in-memory route of the
                depth takes them (`leaf_acc`), else as above

The merge-then-scan is DTWorker partial stats -> DTMaster merge
(dt/DTMaster.java:297-310) with disk shards standing in for workers. It
calls the histogram-only and scan-only entries the host-driven growers
call; never `fused_level`, whose scan would see one shard's histogram.
On the card each shard's call returns its fixed-point sums unconverted
(`hist_level_acc`), and `merge_acc` adds them at the whole set's shift
and converts once: the planes of one call over every row, as the
in-memory grower's. On the CPU the shards' f32 planes add in f32 in
shard order, as the JAX streamed grower adds them. A subtraction level
builds the smaller children and derives the siblings with `_derive`.

The draws are the in-memory trainer's: one valid split `default_rng(
[seed, 999_983])` over the concatenated row order, bags and feature
subsets keyed by [seed, k], DART keep masks by [seed, k, 777]. Integer
planes (RF under integer weights, and every NATIVE count plane) are
exact under any summation order below 2^24, so RF and NATIVE RF forests
equal the in-memory forest bit for bit. On the card GBT moment planes
are the in-memory ones too (while every bf16 plane value is a multiple
of the whole set's fixed-point unit) and its leaves the in-memory
route's but for the f32 rounding of the shards' node totals; on the CPU
the planes round a shard at a time, so GBT scores agree within the JAX
package's 0.03. The errors
are the in-memory trainer's `_errors` over the scores of every shard's
rows, so where the forests are equal the model file is the in-memory
route's byte for byte (the JAX streamed trainer adds f32 shard sums in
f64: its errors agree to about 1e-8).

`htod` counts the host-to-device bytes, copies and seconds of the code
shards (pageable, synchronous copies).
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from shifu_tpu_torch.data.pipeline import prefetch_iter
from shifu_tpu_torch.models.tree import (DenseTree, TreeModelSpec,
                                         traverse_trees)
from shifu_tpu_torch.norm.dataset import read_meta
from shifu_tpu_torch.ops import hist_kernel
from shifu_tpu_torch.parallel.mesh import mesh_device, round_up_rows
from shifu_tpu_torch.train.tree_trainer import (
    DTEarlyStopDecider,
    TreeTrainConfig,
    TreeTrainResult,
    _cls_errors,
    _derive,
    _errors,
    _node_batch_size,
    _one_vote,
    _record_hist_counters,
    _route_rows,
    _score_existing,
    _sharded_errors,
    _sub_plan,
    _sub_row_masks,
    _votes_of,
    int_planes_of,
    leaf_acc,
    leaf_values,
    make_layout,
    scan_layout,
    subset_count,
)
from shifu_tpu_torch.utils.log import get_logger
from shifu_tpu_torch.utils.platform import DeviceLike

log = get_logger(__name__)

# host-to-device copies of code shards: bytes, copies, seconds
htod: Dict[str, float] = {"bytes": 0, "copies": 0, "seconds": 0.0}


class CodesFeed:
    """Shard loader over CleanedData codes-*.npy (mmap'd)."""

    def __init__(self, data_dir: str):
        self.data_dir = data_dir
        self.meta = read_meta(data_dir)
        self.n_shards = len(self.meta.shard_rows)
        self.n_rows = self.meta.n_rows

    def _load(self, prefix: str, s: int) -> np.ndarray:
        return np.load(os.path.join(self.data_dir, f"{prefix}-{s:05d}.npy"),
                       mmap_mode="r")

    def codes(self, s: int) -> np.ndarray:
        """Shard s's codes as stored (int16 below 2^15 slots), in RAM."""
        return np.array(self._load("codes", s))

    def tags(self, s: int) -> np.ndarray:
        return self._load("tags", s)

    def weights(self, s: int) -> np.ndarray:
        return self._load("weights", s)


def _to_device(host: np.ndarray, dev: torch.device, lay):
    """One shard's codes on the device: the stored dtype copied, widened
    to int32 there, and the int8 rows of `codes8_of` on the card when
    every feature fits 128 slots."""
    cuda = dev.type == "cuda"
    if cuda:  # the copy waits for queued work anyway; time the copy alone
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    codes = torch.from_numpy(host).to(dev)
    htod["seconds"] += time.perf_counter() - t0
    htod["bytes"] += host.nbytes
    htod["copies"] += 1
    codes = codes.to(torch.int32)
    codes8 = (hist_kernel.codes8_of(codes, lay)
              if cuda and lay.s_max <= 128 else None)
    return codes, codes8


def _iter_codes(feed: CodesFeed, work: List[dict], lay, mesh=None):
    """(work item, codes, codes8) a piece, the disk read on the prefetch
    thread: host RAM holds at most prefetchChunks + 2 shards of codes.
    On one device a piece is a file shard; on a mesh each file shard's
    rows pad to a multiple of the shard count and split into one block a
    mesh shard (`_pieces`), each copied to its device."""
    items = iter(work)
    for host in prefetch_iter(range(feed.n_shards), transform=feed.codes):
        if mesh is None:
            blocks = [host]
        else:
            rows = round_up_rows(host.shape[0], mesh)
            b = rows // mesh.size
            pad = np.zeros((rows - host.shape[0],) + host.shape[1:],
                           host.dtype)
            host = np.concatenate([host, pad]) if len(pad) else host
            blocks = [host[j * b:(j + 1) * b] for j in range(mesh.size)]
        for block in blocks:
            wk = next(items)
            codes, codes8 = _to_device(block, wk["dev"], lay)
            yield wk, codes, codes8


def _pieces(feed: CodesFeed, mesh, dev) -> List[dict]:
    """Row pieces of the set, in file-shard order: (file shard, global
    offset of its first row, its real rows, its rows with padding, its
    device). One a file shard on one device; on a mesh one a (file
    shard, mesh shard), padded with zero-weight rows."""
    out = []
    offset = 0
    for s, rows in enumerate(feed.meta.shard_rows):
        if mesh is None:
            out.append(dict(file=s, offset=offset, real=rows, rows=rows,
                            dev=dev))
        else:
            b = round_up_rows(rows, mesh) // mesh.size
            for j, d in enumerate(mesh.devices):
                out.append(dict(file=s, offset=offset + j * b,
                                real=max(0, min(b, rows - j * b)), rows=b,
                                dev=d))
        offset += rows
    return out


def _padded(a: np.ndarray, pc: dict) -> np.ndarray:
    """Piece `pc`'s slice of the set-wide row array `a`, zero-padded."""
    out = np.zeros((pc["rows"],) + a.shape[1:], a.dtype)
    out[:pc["real"]] = a[pc["offset"]:pc["offset"] + pc["real"]]
    return out


def _on(out: tuple, dev, cache: dict) -> tuple:
    """A level's decisions on `dev`, copied once a device."""
    if dev not in cache:
        cache[dev] = tuple(x.to(dev) for x in out)
    return cache[dev]


def _scanner(lay, cfg, fot):
    def scan(hist):
        return hist_kernel.scan_level(
            hist, fot, lay=lay, impurity=cfg.impurity,
            min_inst=max(cfg.min_instances_per_node, 1),
            min_gain=cfg.min_info_gain, n_classes=cfg.n_classes)
    return scan


def _builders(kw, dev):
    """(build, merge): one shard's histogram of a node batch, and the
    merge of a batch's shard histograms (see the module docstring)."""
    if dev.type == "cuda":
        def build(codes, codes8, wk, node_slot, rows, L):
            return hist_kernel.hist_level_acc(
                codes, wk["labels"], wk["w"], node_slot, rows, L=L,
                codes8=codes8, **kw)
        return build, hist_kernel.merge_acc

    def build(codes, codes8, wk, node_slot, rows, L):
        return hist_kernel.hist_level(codes, wk["labels"], wk["w"],
                                      node_slot, rows, L=L, **kw)

    def merge(hists):
        out = hists[0]
        for h in hists[1:]:
            out = out + h
        return out

    return build, merge


def _grow_levelwise_streamed(feed, work, lay, cfg, fot, kw, dev, mesh=None
                             ) -> DenseTree:
    """One level-wise tree. Each shard applies the previous level's
    decisions the next time its codes are on the device, so one shard's
    codes are resident at a time and a level costs one copy a shard.
    Node batches honor the stats-memory budget as the in-memory
    host-batched grower does (DTMaster.java:450-467). The final level
    follows the in-memory route of the same depth: where 2**max_depth
    nodes fit a batch (`_grow_tree`), its leaves are node totals
    (`leaf_acc`, f32 components, the shards' totals added in f64), else
    a scanned histogram (`build_tree`, and the JAX streamed grower at
    every depth). On a mesh each piece routes by the decisions copied to
    its device, and every piece's histogram joins the one merge of the
    level. Sets each work item's "resting" slot."""
    D = cfg.max_depth
    scan = _scanner(lay, cfg, fot)
    build, merge = _builders(kw, dev)
    batch_cap = _node_batch_size(lay.T, cfg.max_stats_memory_mb,
                                 cfg.n_classes)
    leaf_totals = 2 ** D <= batch_cap
    sub_levels = _sub_plan(cfg, batch_cap)
    sub_on = cfg.hist_subtraction
    n_built = n_derived = n_fallback = 0
    feats_l, masks_l, leaves_l = [], [], []
    pending = None  # the previous level's (scan 9-tuple, L)
    prev = None  # retained parent level (hist, is_split, lcnt, ncnt)
    for depth in range(D + 1):
        L = 2 ** depth
        if depth == D and leaf_totals:
            acc = None
            on: dict = {}
            for wk, codes, _codes8 in _iter_codes(feed, work, lay, mesh):
                wk["node"], wk["active"], wk["resting"] = _route_rows(
                    codes, wk["node"], wk["active"], wk["resting"],
                    pending[1], _on(pending[0], wk["dev"], on),
                    scan_layout(lay, wk["dev"]))
                a = leaf_acc(wk["labels"], wk["w"], wk["node"],
                             wk["active"], L, cfg.n_classes).double().to(dev)
                acc = a if acc is None else acc + a
                del codes, _codes8
            leaves_l.append(leaf_values(acc.float(), cfg.n_classes))
            feats_l.append(torch.full((L,), -1, dtype=torch.int32,
                                      device=dev))
            masks_l.append(torch.zeros((L, lay.s_max), dtype=torch.bool,
                                       device=dev))
            for wk in work:
                wk["resting"] = torch.where(
                    wk["active"], (L - 1) + wk["node"].long(), wk["resting"])
            break
        use_sub = prev is not None
        retain_next = (depth < D and sub_on and sub_levels[depth + 1]
                       and not (leaf_totals and depth + 1 == D))
        if use_sub:  # shards build the smaller children, half width
            p_hist, p_split, p_lcnt, p_ncnt = prev
            left_small = p_lcnt <= p_ncnt - p_lcnt
            ranges = [(0, L // 2)]
        else:
            ranges = [(b0, min(batch_cap, L - b0))
                      for b0 in range(0, L, batch_cap)]
        parts: List[list] = [[] for _ in ranges]
        on = {}
        for wk, codes, codes8 in _iter_codes(feed, work, lay, mesh):
            if pending is not None:
                wk["node"], wk["active"], wk["resting"] = _route_rows(
                    codes, wk["node"], wk["active"], wk["resting"],
                    pending[1], _on(pending[0], wk["dev"], on),
                    scan_layout(lay, wk["dev"]))
            for bi, (b0, Lb) in enumerate(ranges):
                if use_sub:
                    nd, rows = _sub_row_masks(wk["node"], wk["active"],
                                              left_small.to(wk["dev"]))
                else:
                    nd = wk["node"] - b0
                    rows = (wk["active"] & (wk["node"] >= b0)
                            & (wk["node"] < b0 + Lb))
                parts[bi].append(build(codes, codes8, wk, nd, rows, Lb))
            del codes, codes8  # before the next shard lands
        parts = [merge(p) for p in parts]
        pending = None
        if use_sub:
            _derived, hist = _derive(p_hist, parts[0], p_split, left_small)
            out = scan(hist)
            n_built += L // 2
            n_derived += L // 2
        else:
            outs = [scan(h) for h in parts]
            out = (outs[0] if len(outs) == 1
                   else tuple(torch.cat(xs) for xs in zip(*outs)))
            hist = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
            n_built += L
            if sub_on and depth >= 1:
                n_fallback += len(ranges)
        (bf, _br, _rank, lv, is_split, _g, lm, nc, lc) = out
        if depth == D:  # final level: leaves, leftovers settle
            leaves_l.append(lv)
            feats_l.append(torch.full((L,), -1, dtype=torch.int32,
                                      device=dev))
            masks_l.append(torch.zeros((L, lay.s_max), dtype=torch.bool,
                                       device=dev))
            for wk in work:
                wk["resting"] = torch.where(
                    wk["active"], (L - 1) + wk["node"].long(), wk["resting"])
            break
        prev = (hist, is_split, lc, nc) if retain_next else None
        pending = (out, L)
        feats_l.append(torch.where(is_split, bf, torch.full_like(bf, -1)))
        masks_l.append(lm)
        leaves_l.append(lv)
    _record_hist_counters(n_built, n_derived, n_fallback)
    return DenseTree(
        feature=torch.cat(feats_l).cpu().numpy().astype(np.int32),
        left_mask=torch.cat(masks_l).cpu().numpy().astype(bool),
        leaf_value=torch.cat(leaves_l).cpu().numpy().astype(np.float32))


def _grow_leafwise_streamed(feed, work, lay, cfg, fot, kw, dev
                            ) -> DenseTree:
    """Leaf-wise growth with streamed histograms (DTMaster.java:137
    toSplitQueue): the split queue and the growing tree are host state;
    each split re-streams the shards once to apply its reroute and build
    the new leaves' histograms (`hist_level` at L = 1), the smaller child
    only when the parent's histogram was kept. Sets each work item's
    "node" to its rows' final node ids."""
    scan = _scanner(lay, cfg, fot)
    build, merge = _builders(kw, dev)
    max_nodes = 2 * cfg.max_leaves - 1
    feature, left_c, right_c = [-1], [-1], [-1]
    leaf_val = [0.0]
    masks = [np.zeros(lay.s_max, bool)]
    depth_of = {0: 0}
    candidates: Dict[int, tuple] = {}
    stored: Dict[int, torch.Tensor] = {}  # leaf id -> its [C, 1, T] hist
    sub_on = cfg.hist_subtraction
    batch_cap = _node_batch_size(lay.T, cfg.max_stats_memory_mb,
                                 cfg.n_classes)
    n_built = n_derived = n_fallback = 0
    pending = None  # (split leaf, feature, cut, rank row, left, right)

    def sweep(leaf_ids: List[int]) -> Dict[int, torch.Tensor]:
        """One pass over the shards: the pending reroute, then each
        listed leaf's histogram, summed over shards."""
        nonlocal pending
        hists: Dict[int, list] = {lid: [] for lid in leaf_ids}
        for wk, codes, codes8 in _iter_codes(feed, work, lay):
            if pending is not None:
                best_id, bf, cut, rank_row, li, ri = pending
                code = codes[:, bf].long().clamp(0, int(lay.clip_max[bf]))
                goes_left = rank_row[int(lay.off[bf]) + code] <= cut
                sel = wk["node"] == best_id
                wk["node"] = torch.where(sel & goes_left, li,
                                         torch.where(sel, ri, wk["node"]))
            zero = torch.zeros_like(wk["node"])
            for lid in leaf_ids:
                hists[lid].append(build(codes, codes8, wk, zero,
                                        (wk["node"] == lid) & wk["active"],
                                        1))
            del codes, codes8
        pending = None
        return {lid: merge(h) for lid, h in hists.items()}

    def evaluate(lid: int, hist: torch.Tensor) -> None:
        (f, c, r, lv, sp, g, m, nc, lc) = scan(hist)
        h = torch.cat([torch.stack([x[0].double() for x in
                                    (lv, sp, g, f, c, lc, nc)]),
                       m[0].double()]).cpu().numpy()
        leaf_val[lid] = float(h[0])
        if h[1] and depth_of[lid] < cfg.max_depth:
            candidates[lid] = (float(h[2]), int(h[3]), int(h[4]), r[0],
                               h[7:] > 0.5, float(h[5]), float(h[6]))
            if sub_on and len(stored) + 1 <= batch_cap:
                stored[lid] = hist

    evaluate(0, sweep([0])[0])
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
        pending = (best_id, bf, cut, rank_row, li, ri)
        n_leaves += 1
        if parent_hist is not None:
            smaller, larger = ((li, ri) if lcnt <= ncnt - lcnt
                               else (ri, li))
            built = sweep([smaller])[smaller]
            evaluate(smaller, built)
            evaluate(larger, parent_hist - built)
            n_built += 1
            n_derived += 1
        else:
            hists = sweep([li, ri])
            evaluate(li, hists[li])
            evaluate(ri, hists[ri])
            n_built += 2
            if sub_on:
                n_fallback += 1
    _record_hist_counters(n_built, n_derived, n_fallback)
    return DenseTree(feature=np.asarray(feature, np.int32),
                     left_mask=np.stack(masks).astype(bool),
                     leaf_value=np.asarray(leaf_val, np.float32),
                     left=np.asarray(left_c, np.int32),
                     right=np.asarray(right_c, np.int32))


def _resume_state(feed, shard_state, trees, cfg, lay, n_total,
                  mesh=None) -> None:
    """Re-derive each piece's prediction state from a loaded forest (the
    in-memory trainer's resume, piece by piece)."""
    start_k = len(trees)
    is_gbt = cfg.algorithm == "GBT"
    for st, (_wk, codes, _c8) in zip(shard_state, _iter_codes(
            feed, shard_state, lay, mesh)):
        dev = st["dev"]
        if cfg.n_classes >= 3:
            st["votes"] = _votes_of(trees, codes, cfg.n_classes)
        elif is_gbt and cfg.dropout_rate > 0.0:
            per_tree = traverse_trees(trees, codes)
            s = torch.zeros(st["rows"], dtype=torch.float32, device=dev)
            for col in range(per_tree.shape[1]):
                contrib = per_tree[:, col]
                if col > 0:
                    keep = (np.random.default_rng([cfg.seed, col, 777])
                            .random(n_total) >= cfg.dropout_rate)
                    contrib = contrib * torch.as_tensor(
                        _padded(keep.astype(np.float32), st),
                        device=dev)
                s = s + contrib
            st["pred"] = s
        else:
            s = _score_existing(trees, codes)
            st["pred"] = s if is_gbt else s / start_k


def train_trees_streamed(
    codes_dir: str,
    slots: List[int],
    is_cat: List[bool],
    columns: List[str],
    cfg: TreeTrainConfig,
    tags_override: Optional[np.ndarray] = None,
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
    """GBT/RF streamed from the CleanedData shards of `codes_dir` on one
    device (`device=None` = cuda), or with each file shard's rows split
    over the row shards of `mesh` (JAX `train_trees_streamed(mesh=)`:
    padded with zero-weight rows to `round_up_rows`, every piece's
    histogram in the level's one merge). `tags_override` [n] replaces the
    shards' tags (ONEVSALL members). `init_trees` continues a forest and
    `checkpoint_cb(k, trees, valid_errors)` fires after each tree, as in
    the in-memory `train_trees`. Leaf-wise growth ignores the mesh."""
    if mesh is not None and cfg.max_leaves and cfg.max_leaves > 0:
        log.warning("leaf-wise growth runs single-device; ignoring mesh")
        device, mesh = mesh.lead, None
    mesh, dev = mesh_device(mesh, device)
    K = cfg.n_classes
    is_cls = K >= 3
    if is_cls and cfg.algorithm == "GBT":
        raise ValueError("NATIVE multi-class tree training is RF-only")
    feed = CodesFeed(codes_dir)
    F = len(slots)
    lay = make_layout([int(s) for s in slots], [bool(c) for c in is_cat])
    is_gbt = cfg.algorithm == "GBT"
    log_loss = cfg.loss == "log"
    lr = cfg.learning_rate
    lowp = is_gbt  # bf16 component planes for GBT, as in memory
    n_total = feed.n_rows

    # ONE valid draw over the concatenated rows, file shard by file shard
    rng_valid = np.random.default_rng([cfg.seed, 999_983])
    ys, ws, valids = [], [], []
    offset = 0
    for s in range(feed.n_shards):
        rows = feed.meta.shard_rows[s]
        valid = rng_valid.random(rows) < cfg.valid_set_rate
        y = (tags_override[offset:offset + rows] if tags_override is not None
             else np.asarray(feed.tags(s)))
        ys.append(np.asarray(y, np.float32))
        ws.append(np.where(valid, 0.0, np.asarray(feed.weights(s),
                                                  np.float32))
                  .astype(np.float32))
        valids.append(valid)
        offset += rows
    y_np = np.concatenate(ys) if ys else np.zeros(0, np.float32)
    w_np = np.concatenate(ws) if ws else np.zeros(0, np.float32)
    vm_np = np.concatenate(valids) if valids else np.zeros(0, bool)
    # per-piece resident state (padding: zero weight, not real)
    shard_state: List[dict] = []
    for pc in _pieces(feed, mesh, dev):
        d, rows = pc["dev"], pc["rows"]
        shard_state.append({
            **pc,
            "y": torch.as_tensor(_padded(y_np, pc), device=d),
            "base_w": torch.as_tensor(_padded(w_np, pc), device=d),
            "valid": torch.as_tensor(_padded(vm_np, pc), device=d),
            "is_real": torch.as_tensor(_padded(np.ones(n_total, bool), pc),
                                    device=d),
            "pred": torch.zeros(rows, dtype=torch.float32, device=d),
            "votes": (torch.zeros((rows, K), dtype=torch.float32,
                                  device=d) if is_cls else None),
        })
    # the integer planes decided once a forest over every row, so each
    # piece's calls take the same shared-bin width
    int_planes = all(int_planes_of(st["y"], st["base_w"], K, lowp)
                     for st in shard_state)
    kw = dict(lay=lay, low_precision=lowp, n_classes=K,
              int_planes=int_planes)

    trees: List[DenseTree] = list(init_trees or [])
    start_k = len(trees)
    if start_k:
        _resume_state(feed, shard_state, trees, cfg, lay, n_total, mesh)
    valid_errors: List[float] = list(init_valid_errors or [])[:start_k]
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
    k_sub = subset_count(cfg.feature_subset_strategy, F)

    for k in range(start_k, cfg.tree_num):
        rng_k = np.random.default_rng([cfg.seed, k])
        bag_all = None
        if cfg.algorithm == "RF":
            bag_all = (rng_k.poisson(cfg.bagging_sample_rate, size=n_total)
                       if cfg.bagging_with_replacement
                       else rng_k.random(n_total) < cfg.bagging_sample_rate)
        feat_ok = np.zeros(F, dtype=bool)
        if k_sub >= F:
            feat_ok[:] = True
        else:
            feat_ok[rng_k.choice(F, size=k_sub, replace=False)] = True
        fot = torch.as_tensor(feat_ok[lay.seg_of_t], device=dev)

        work = []
        for st in shard_state:
            d, rows = st["dev"], st["rows"]
            if bag_all is not None:
                w_k = st["base_w"] * torch.as_tensor(
                    _padded(bag_all, st).astype(np.uint16)
                    .astype(np.float32), device=d)
                labels = st["y"]
            else:
                w_k = st["base_w"]
                labels = (st["y"] - 1.0 / (1.0 + torch.exp(-st["pred"]))
                          if log_loss else st["y"] - st["pred"])
            work.append({
                "labels": labels, "w": w_k, "dev": d,
                "node": torch.zeros(rows, dtype=torch.int32, device=d),
                "active": torch.ones(rows, dtype=torch.bool, device=d),
                "resting": torch.zeros(rows, dtype=torch.long, device=d),
            })

        weight_k = 1.0 if (is_gbt and k == 0) else (lr if is_gbt else 1.0)
        if cfg.max_leaves and cfg.max_leaves > 0:
            tree = _grow_leafwise_streamed(feed, work, lay, cfg, fot, kw,
                                           dev)
            for wk in work:
                wk["resting"] = wk["node"].long()  # explicit node ids
        else:
            tree = _grow_levelwise_streamed(feed, work, lay, cfg, fot, kw,
                                            dev, mesh)
        tree.weight = weight_k
        trees.append(tree)

        drop_all = None
        if is_gbt and cfg.dropout_rate > 0.0 and k > 0:
            drop_all = (np.random.default_rng([cfg.seed, k, 777])
                        .random(n_total) >= cfg.dropout_rate)
        scores = []
        for wk, st in zip(work, shard_state):
            tree_pred = torch.as_tensor(tree.leaf_value,
                                        device=st["dev"])[wk["resting"]]
            if is_cls:
                st["votes"] = st["votes"] + _one_vote(tree_pred, K)
                scores.append(st["votes"])
                continue
            if is_gbt:
                if drop_all is not None:
                    tree_pred = tree_pred * torch.as_tensor(
                        _padded(drop_all.astype(np.float32), st),
                        device=st["dev"])
                st["pred"] = st["pred"] + weight_k * tree_pred
                score = (1.0 / (1.0 + torch.exp(-st["pred"])) if log_loss
                         else st["pred"].clamp(0.0, 1.0))
            else:
                st["pred"] = (tree_pred if k == 0
                              else (st["pred"] * k + tree_pred) / (k + 1))
                score = st["pred"].clamp(0.0, 1.0)
            scores.append(score)
        if mesh is None:
            errors = _cls_errors if is_cls else _errors
            t_e, v_e = errors(torch.cat(scores),
                              torch.cat([st["y"] for st in shard_state]),
                              torch.cat([st["valid"] for st in shard_state]))
        else:
            row_err = [((torch.argmax(sc, dim=1).to(torch.float32)
                         != st["y"]).to(torch.float32) if is_cls
                        else (st["y"] - sc) ** 2)
                       for sc, st in zip(scores, shard_state)]
            t_e, v_e = _sharded_errors(
                row_err, [st["valid"] for st in shard_state],
                [st["is_real"] for st in shard_state], mesh)
        terr, verr = float(t_e), float(v_e)  # one host read a tree
        valid_errors.append(verr)
        if progress_cb:
            progress_cb(k + 1, terr, verr)
        if checkpoint_cb:
            checkpoint_cb(k + 1, trees, valid_errors)
        if decider is not None and decider.add(verr):
            log.info("streamed windowed early stop after %d trees", k + 1)
            break
        if cfg.early_stop_rounds and len(valid_errors) > 1:
            if verr > min(valid_errors):
                bad_rounds += 1
                if bad_rounds >= cfg.early_stop_rounds:
                    log.info("streamed early stop after %d trees", k + 1)
                    break
            else:
                bad_rounds = 0

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

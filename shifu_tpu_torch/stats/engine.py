"""Stats engine (counterpart of `build_codes`, `_prepare_rows`,
`compute_stats`, `compute_stats_streaming`, `_write_back` and
`_column_slot_layout` in `shifu_tpu/stats/engine.py`).

Pipeline parity with MapReducerStatsWorker.doStats
(core/processor/stats/MapReducerStatsWorker.java:105): purify -> sample ->
per-column bins -> bin-hit aggregation -> KS/IV/WOE -> ColumnConfig update.
The bins and codes are built on the host; the codes, values, tags and
weights go to the device once, and `ops/binagg.bin_aggregate` reduces
them there. The streamed route makes two passes over the chunks:
sketches (bins), then each chunk's codes folded on the device
(`data/pipeline.DeviceAccumulator`).
"""

from __future__ import annotations

import math
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from shifu_tpu_torch.config import ColumnConfig
from shifu_tpu_torch.config.model_config import ModelConfig
from shifu_tpu_torch.data.purify import combined_mask
from shifu_tpu_torch.data.reader import (ColumnarData, make_tags_for,
                                         make_weights)
from shifu_tpu_torch.obs import profile, registry, span
from shifu_tpu_torch.ops.binagg import bin_aggregate
from shifu_tpu_torch.stats.binning import (
    categorical_bins,
    category_index,
    hybrid_bin_index,
    numeric_bin_index,
    numeric_boundaries,
)
from shifu_tpu_torch.stats.metrics import column_metrics
from shifu_tpu_torch.utils.log import get_logger

log = get_logger(__name__)

# Reference caps categorical cardinality at 10k (shifuconfig:107-108).
MAX_CATEGORY_SIZE = 10_000


def build_codes(
    data: ColumnarData,
    stats_cols: List[ColumnConfig],
) -> Tuple[np.ndarray, np.ndarray, List[int], np.ndarray, List[ColumnConfig]]:
    """Assign each row a bin code for every stats column.

    Returns (codes [n, C] int32, col_offsets [C], slots_per_col, values
    [n, Cn] float32 numeric matrix, numeric_cols). The slot layout comes
    from _column_slot_layout, the one definition of it."""
    n = data.n_rows
    slots, col_offsets, numeric_cols = _column_slot_layout(stats_cols)
    codes = np.zeros((n, len(stats_cols)), dtype=np.int32)
    numeric_mat: List[np.ndarray] = []
    for j, cc in enumerate(stats_cols):
        if cc.is_categorical():
            cats = cc.column_binning.bin_category or []
            codes[:, j] = category_index(data, cc.column_name, cats)
        elif cc.is_hybrid():
            # hybrid: numeric bins then category bins then missing
            # (Normalizer.java:622-638); numeric moments come from the
            # parseable values only
            bounds = cc.column_binning.bin_boundary or [float("-inf")]
            cats = cc.column_binning.bin_category or []
            miss = data.missing_mask(cc.column_name)
            codes[:, j] = hybrid_bin_index(
                data.column(cc.column_name), bounds, cats, miss
            )
            numeric_mat.append(data.numeric(cc.column_name).astype(np.float32))
        else:
            bounds = cc.column_binning.bin_boundary or [float("-inf")]
            vals = data.numeric(cc.column_name)
            codes[:, j] = numeric_bin_index(vals, bounds)
            numeric_mat.append(vals.astype(np.float32))
    values = (
        np.stack(numeric_mat, axis=1)
        if numeric_mat
        else np.zeros((n, 0), dtype=np.float32)
    )
    return codes, col_offsets, slots, values, numeric_cols


def _prepare_rows(
    mc: ModelConfig, data: ColumnarData, seed, sample_rate: float,
    sample_neg_only: bool, fold_multiclass: bool = False,
) -> Tuple[ColumnarData, np.ndarray, np.ndarray]:
    """purify + invalid-tag drop + sampling (reference samples in the Pig
    job). `seed` may be a sequence (streaming passes [seed, chunk_idx] so
    both passes sample identically).

    `fold_multiclass` (stats callers): fold K class-index tags to
    class0-vs-rest so the binary bin aggregation (binagg counts tags==1 pos /
    ==0 neg) still sees EVERY valid row and binCountPos+binCountNeg ==
    n_valid_rows. Norm callers keep the class indices — they ARE the
    training targets."""
    ds = mc.data_set
    mask = combined_mask(ds.filter_expressions, data.raw, data.n_rows)
    tags_all = make_tags_for(mc, data.column(ds.target_column_name))
    if fold_multiclass and mc.is_multi_classification():
        tags_all = np.where(tags_all > 0, 1, tags_all).astype(tags_all.dtype)
    mask &= tags_all >= 0
    if sample_rate < 1.0:
        rng = np.random.default_rng(seed)
        keep = rng.random(data.n_rows) < sample_rate
        if sample_neg_only:
            keep |= tags_all >= 1
        mask &= keep
    if not mask.all():  # else the same rows: keep the column caches
        data = data.select_rows(mask)
    tags = tags_all[mask]
    weights = make_weights(data, ds.weight_column_name)
    return data, tags, weights


def compute_stats(
    mc: ModelConfig,
    columns: List[ColumnConfig],
    data: ColumnarData,
    device: torch.device,
    seed: int = 0,
    timings: Optional[Dict[str, float]] = None,
) -> None:
    """Fill stats + binning for every non-target/meta/weight column, in
    place. `timings`, when given, receives the seconds of each host stage
    (prepare, bins, codes, copy, aggregate, write_back) and the device
    milliseconds of the aggregate (`aggregate_device_ms`, cuda only)."""
    t = {} if timings is None else timings
    t0 = time.perf_counter()
    data, tags, weights = _prepare_rows(
        mc, data, seed, mc.stats.sample_rate, mc.stats.sample_neg_only,
        fold_multiclass=True,
    )
    n_pos, n_neg = int((tags == 1).sum()), int((tags == 0).sum())
    log.info("stats over %d rows (%d pos / %d neg)", data.n_rows,
             n_pos, n_neg)

    stats_cols = [
        c for c in columns if not (c.is_target() or c.is_meta() or c.is_weight())
    ]
    reg = registry()
    reg.counter("stats.rows_valid").inc(data.n_rows)
    reg.counter("stats.rows_pos").inc(n_pos)
    reg.counter("stats.rows_neg").inc(n_neg)
    reg.gauge("stats.columns").set(len(stats_cols))
    timers = reg.stage_timers("stats.stage")

    # ---- pass 1: bin construction (host, exact quantiles) ----
    max_bins = mc.stats.max_num_bin
    cate_max = mc.stats.cate_max_num_bin or MAX_CATEGORY_SIZE
    t1 = time.perf_counter()
    t["prepare"] = t1 - t0
    for cc in stats_cols:
        if cc.is_categorical():
            miss = data.missing_mask(cc.column_name)
            cats = categorical_bins(data.column(cc.column_name), miss, cate_max)
            cc.column_binning.bin_category = cats
            cc.column_binning.bin_boundary = None
            cc.column_binning.length = len(cats)
        elif cc.is_hybrid():
            # hybrid: numeric boundaries from parseable values PLUS
            # categories from non-parseable non-missing tokens
            # (udf/stats/NumericalVarStats hybrid handling)
            vals = data.numeric(cc.column_name)
            miss = data.missing_mask(cc.column_name)
            bounds = numeric_boundaries(
                vals, tags, weights, mc.stats.binning_method, max_bins
            )
            unparseable = np.isnan(vals) & ~miss
            cats = categorical_bins(
                data.column(cc.column_name)[unparseable],
                np.zeros(int(unparseable.sum()), dtype=bool),
                cate_max,
            ) if unparseable.any() else []
            cc.column_binning.bin_boundary = bounds
            cc.column_binning.bin_category = cats
            cc.column_binning.length = len(bounds) + len(cats)
        else:
            vals = data.numeric(cc.column_name)
            bounds = numeric_boundaries(
                vals, tags, weights, mc.stats.binning_method, max_bins
            )
            cc.column_binning.bin_boundary = bounds
            cc.column_binning.bin_category = None
            cc.column_binning.length = len(bounds)
    t2 = time.perf_counter()
    t["bins"] = t2 - t1
    timers.add("bins", t2 - t1)

    # ---- pass 2: one aggregation over the code matrix, on the device ----
    with span("stats.aggregate", rows=data.n_rows, columns=len(stats_cols)), \
            timers.timer("aggregate"):
        codes, col_offsets, slots, values, numeric_cols = build_codes(
            data, stats_cols)
        total_slots = int(sum(slots))
        t3 = time.perf_counter()
        t["codes"] = t3 - t2
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
                for a in (codes, col_offsets, tags.astype(np.int32),
                          weights.astype(np.float32), values)]
        cuda = device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(device)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        t4 = time.perf_counter()
        t["copy"] = t4 - t3
        if cuda:
            ev[0].record()
        agg = profile.dispatch("stats.bin_aggregate", bin_aggregate,
                               args[0], args[1], total_slots, *args[2:],
                               sync=False)
        if cuda:
            ev[1].record()
        agg = [a.cpu().numpy() for a in agg]
        t5 = time.perf_counter()
        t["aggregate"] = t5 - t4
        if cuda:
            t["aggregate_device_ms"] = ev[0].elapsed_time(ev[1])

    medians = []
    for cc in numeric_cols:
        vals = data.numeric(cc.column_name)
        finite = vals[np.isfinite(vals)]
        medians.append(float(np.median(finite)) if finite.size else None)
    cat_missing = {}
    for cc in stats_cols:
        if cc.is_categorical():
            miss = data.missing_mask(cc.column_name)
            cat_missing[cc.column_name] = (
                int(miss.sum()),
                float(miss.mean()) if data.n_rows else 0.0,
            )

    _write_back(
        stats_cols,
        slots,
        col_offsets,
        *agg,
        medians=medians,
        cat_missing=cat_missing,
        numeric_cols=numeric_cols,
        n_valid_rows=int((tags >= 0).sum()),
    )
    t["write_back"] = time.perf_counter() - t5


def _write_back(
    stats_cols: List[ColumnConfig],
    slots: List[int],
    col_offsets: np.ndarray,
    pos: np.ndarray,
    neg: np.ndarray,
    wpos: np.ndarray,
    wneg: np.ndarray,
    vsum: np.ndarray,
    vsumsq: np.ndarray,
    vmin: np.ndarray,
    vmax: np.ndarray,
    vcount: np.ndarray,
    vmissing: np.ndarray,
    numeric_cols: List[ColumnConfig],
    medians: List[Optional[float]],
    cat_missing: Dict[str, Tuple[int, float]],
    n_valid_rows: int,
) -> None:
    """Fill ColumnStats/ColumnBinning from flat bin aggregates (the f32
    sums and the int64 counts of `bin_aggregate`)."""
    # ---- metrics: vectorized KS/IV/WOE over padded [C, max_slots] ----
    max_slots = max(slots) if slots else 1
    C = len(stats_cols)
    pos_pad = np.zeros((C, max_slots), dtype=np.float64)
    neg_pad = np.zeros_like(pos_pad)
    wpos_pad = np.zeros_like(pos_pad)
    wneg_pad = np.zeros_like(pos_pad)
    bin_mask = np.zeros_like(pos_pad)
    for j, cc in enumerate(stats_cols):
        o, s = col_offsets[j], slots[j]
        pos_pad[j, :s] = pos[o : o + s]
        neg_pad[j, :s] = neg[o : o + s]
        wpos_pad[j, :s] = wpos[o : o + s]
        wneg_pad[j, :s] = wneg[o : o + s]
        bin_mask[j, :s] = 1.0
    cm = column_metrics(pos_pad, neg_pad, bin_mask)
    wcm = column_metrics(wpos_pad, wneg_pad, bin_mask)

    ks, iv, woe, bin_woe, cvalid = cm.ks, cm.iv, cm.woe, cm.bin_woe, cm.valid
    wks, wiv, wwoe, wbin_woe = wcm.ks, wcm.iv, wcm.woe, wcm.bin_woe
    num_index = {id(cc): k for k, cc in enumerate(numeric_cols)}

    for j, cc in enumerate(stats_cols):
        s = slots[j]
        st = cc.column_stats
        bn = cc.column_binning
        bn.bin_count_pos = [int(x) for x in pos_pad[j, :s]]
        bn.bin_count_neg = [int(x) for x in neg_pad[j, :s]]
        bn.bin_weighted_pos = [float(x) for x in wpos_pad[j, :s]]
        bn.bin_weighted_neg = [float(x) for x in wneg_pad[j, :s]]
        tot = pos_pad[j, :s] + neg_pad[j, :s]
        with np.errstate(invalid="ignore", divide="ignore"):
            rate = np.where(tot > 0, pos_pad[j, :s] / np.maximum(tot, 1e-12), 0.0)
        bn.bin_pos_rate = [float(x) for x in rate]
        if bool(cvalid[j]):
            bn.bin_count_woe = [float(x) for x in bin_woe[j, :s]]
            bn.bin_weighted_woe = [float(x) for x in wbin_woe[j, :s]]
            st.ks = float(ks[j])
            st.iv = float(iv[j])
            st.woe = float(woe[j])
            st.weighted_ks = float(wks[j])
            st.weighted_iv = float(wiv[j])
            st.weighted_woe = float(wwoe[j])
        st.total_count = n_valid_rows

        k = num_index.get(id(cc))
        if k is not None:
            cnt = float(vcount[k])
            st.missing_count = int(vmissing[k])
            st.missing_percentage = (
                float(vmissing[k]) / max(n_valid_rows, 1) if n_valid_rows else 0.0
            )
            if cnt > 0:
                mean = float(vsum[k]) / cnt
                st.mean = mean
                var = max(float(vsumsq[k]) / cnt - mean * mean, 0.0)
                # sample std like the reference (BasicStatsCalculator)
                st.std_dev = math.sqrt(var * cnt / max(cnt - 1, 1.0))
                st.min = float(vmin[k])
                st.max = float(vmax[k])
                st.median = medians[k]
        else:
            miss_cnt, miss_pct = cat_missing.get(cc.column_name, (0, 0.0))
            st.missing_count = miss_cnt
            st.missing_percentage = miss_pct
            # Categorical stats are over the posrate-encoded variable (the
            # reference's CategoricalVarStats maps value -> binPosRate then
            # runs BasicStats) — closed form from the bin counts, incl. the
            # missing bin. Norm's categorical z-scale depends on these.
            tot_all = float(tot.sum())
            if tot_all > 0:
                mean = float((tot * rate).sum() / tot_all)
                e2 = float((tot * rate * rate).sum() / tot_all)
                var = max(e2 - mean * mean, 0.0)
                st.mean = mean
                st.std_dev = math.sqrt(var * tot_all / max(tot_all - 1.0, 1.0))
                occupied = rate[tot > 0]
                st.min = float(occupied.min()) if occupied.size else None
                st.max = float(occupied.max()) if occupied.size else None
            else:
                st.mean = None


def _column_slot_layout(
    stats_cols: List[ColumnConfig],
) -> Tuple[List[int], np.ndarray, List[ColumnConfig]]:
    """(slots_per_col, col_offsets, numeric_cols) from finalized bins —
    the same layout build_codes derives per chunk, but computable with
    zero chunks in hand (a resumed pass 2 may have none left)."""
    slots: List[int] = []
    numeric_cols: List[ColumnConfig] = []
    for cc in stats_cols:
        if cc.is_categorical():
            slots.append(len(cc.column_binning.bin_category or []) + 1)
        elif cc.is_hybrid():
            slots.append(
                len(cc.column_binning.bin_boundary or [float("-inf")])
                + len(cc.column_binning.bin_category or []) + 1)
            numeric_cols.append(cc)
        else:
            slots.append(
                len(cc.column_binning.bin_boundary or [float("-inf")]) + 1)
            numeric_cols.append(cc)
    col_offsets = np.zeros(len(stats_cols), dtype=np.int32)
    if slots:
        col_offsets[1:] = np.cumsum(slots[:-1])
    return slots, col_offsets, numeric_cols


def _stats_config_sha(mc: ModelConfig, stats_cols: List[ColumnConfig],
                      seed: int, n_shards: int):
    """(sha, sections) of a streamed stats run: chunk geometry, shards,
    sampling and columns in `data`, the binning in `stats`."""
    from shifu_tpu_torch.data.stream import chunk_rows_setting
    from shifu_tpu_torch.resilience.checkpoint import sectioned_sha

    return sectioned_sha({
        "data": {
            "chunkRows": chunk_rows_setting(),
            "shards": n_shards,
            "sampleRate": mc.stats.sample_rate,
            "sampleNegOnly": mc.stats.sample_neg_only,
            "seed": seed,
            "columns": [(c.column_name, str(c.column_type))
                        for c in stats_cols],
        },
        "stats": {
            "method": str(mc.stats.binning_method),
            "maxBins": mc.stats.max_num_bin,
            "cateMax": mc.stats.cate_max_num_bin,
        },
    })


def compute_stats_streaming(
    mc: ModelConfig,
    columns: List[ColumnConfig],
    chunk_factory,
    device: torch.device,
    seed: int = 0,
    checkpoint_root: Optional[str] = None,
    resume: bool = False,
    timings: Optional[Dict[str, float]] = None,
    host_plan=None,
) -> None:
    """Bounded-memory stats: two passes over a re-iterable chunk stream
    (`chunk_factory()` -> chunks).

    Pass 1 folds every chunk into per-column sketches (the SPDT histogram
    of the reference's EqualPopulationBinning for numeric bins, moments,
    a capped categorical counter), one sketch set a row shard (ShardPlan:
    chunk ci on shard ci % S), merged in shard order at bin
    finalization. Pass 2 bin-codes each chunk on the prefetch thread and
    folds it on the device (DeviceAccumulator: int64 counts, f64 sums),
    read back once. Peak host memory is one chunk x (2 + prefetch depth)
    plus the sketches. Chunk ci samples by [seed, ci], so both passes
    and a resume see the same rows.

    With `checkpoint_root`, every shifu.ckpt.everyChunks chunks each
    shard's cursor, counters and sketches land in its own snapshot and
    the device fold in the shared one (ShardedStreamCheckpoint);
    `resume=True` continues mid-pass, bit-identical to an unbroken run.
    `timings` receives the seconds of pass 1, the bins, pass 2 and the
    write-back.

    Under a multi-host plan (`host_plan`, or the shifu.lifecycle.hosts /
    hostIndex knobs) both passes fold only this host's chunks (ci % H),
    and the hosts meet at two barriers under `checkpoint_root`
    (`parallel/hostsync.py`): after pass 1 every host publishes its
    shards' sketches and row counts and merges all hosts' in host-major,
    then shard, order (the same bins everywhere); after pass 2 every
    host publishes its exact fold (int64 counts, f64 sums, not rounded)
    and adds all hosts' in host order, rounding once. The checkpoint
    family is per host. The `chunk` fault seam fires before each fold."""
    import pickle

    from shifu_tpu_torch.config.model_config import BinningMethod
    from shifu_tpu_torch.data.pipeline import (DeviceAccumulator, ShardPlan,
                                               add_states, prefetch_iter,
                                               rounded_state)
    from shifu_tpu_torch.parallel import hostsync
    from shifu_tpu_torch.resilience import checkpoint as ckpt_mod
    from shifu_tpu_torch.resilience import faults
    from shifu_tpu_torch.stats.sketch import (CategoricalSketch,
                                              NumericSketch)

    t = {} if timings is None else timings
    t0 = time.perf_counter()
    stats_cols = [c for c in columns
                  if not (c.is_target() or c.is_meta() or c.is_weight())]
    method = mc.stats.binning_method
    max_bins = mc.stats.max_num_bin
    cate_max = mc.stats.cate_max_num_bin or MAX_CATEGORY_SIZE
    use_weights = method in (BinningMethod.WEIGHT_EQUAL_POSITIVE,
                             BinningMethod.WEIGHT_EQUAL_NEGATIVE,
                             BinningMethod.WEIGHT_EQUAL_TOTAL)

    def bin_subset(tags: np.ndarray) -> np.ndarray:
        if method in (BinningMethod.EQUAL_POSITIVE,
                      BinningMethod.WEIGHT_EQUAL_POSITIVE):
            return tags == 1
        if method in (BinningMethod.EQUAL_NEGATIVE,
                      BinningMethod.WEIGHT_EQUAL_NEGATIVE):
            return tags == 0
        return tags >= 0

    plan = ShardPlan(device=device, host=host_plan)
    S = plan.n_shards
    hp = plan.host
    if hp.active and checkpoint_root is None:
        raise ValueError(
            "multi-host streaming stats needs the shared model-set root "
            "(checkpoint_root) for the host part exchange")

    def _fresh() -> Dict[str, object]:
        return {cc.column_name: (CategoricalSketch() if cc.is_categorical()
                                 else NumericSketch(max_bins=max_bins))
                for cc in stats_cols}

    sketches = [_fresh() for _ in range(S)]
    shard_valid = np.zeros(S, dtype=np.int64)
    shard_pos = np.zeros(S, dtype=np.int64)
    shard_neg = np.zeros(S, dtype=np.int64)
    cursors1 = [-1] * S
    cursors2 = [-1] * S
    acc = DeviceAccumulator(device, S)
    ck = None
    phase: Optional[str] = None
    sha, sections = _stats_config_sha(mc, stats_cols, seed, S)
    if hp.active and not resume:
        # a fresh fleet run: this host's parts of an earlier run must not
        # satisfy a peer's barrier
        hostsync.clear_part(checkpoint_root, "stats-pass1", hp)
        hostsync.clear_part(checkpoint_root, "stats-pass2", hp)
    if checkpoint_root is not None and ckpt_mod.ckpt_stream_enabled():
        ck = ckpt_mod.ShardedStreamCheckpoint(
            ckpt_mod.ckpt_base(checkpoint_root, "stats", "stream"), sha, S,
            sections=sections, n_hosts=hp.n_hosts,
            host_index=hp.host_index)
        loaded = ck.load() if resume else None
        if loaded is not None:
            cursors, per_shard, shared = loaded
            phase = shared[1].get("phase")
            for s, (_arrays, meta, blob) in enumerate(per_shard):
                sketches[s] = pickle.loads(blob)
                shard_valid[s] = int(meta["nValid"])
                shard_pos[s] = int(meta["nPos"])
                shard_neg[s] = int(meta["nNeg"])
            if phase == "pass1":
                cursors1 = list(cursors)
            elif phase == "pass2":
                cursors2 = list(cursors)
                acc.restore(shared[0])
            faults.survived("preempt")
            log.info("resuming streaming stats from %s (shard cursors %s)",
                     phase, list(cursors))
        elif not resume:
            ck.clear()  # a stale snapshot must not resurface

    def _states(cursors, phase_name, shared_arrays=None):
        per_shard = [(cursors[s], None,
                      {"nValid": int(shard_valid[s]),
                       "nPos": int(shard_pos[s]),
                       "nNeg": int(shard_neg[s])},
                      pickle.dumps(sketches[s])) for s in range(S)]
        return per_shard, (shared_arrays, {"phase": phase_name}, None)

    def _prepared(numbered):
        ci, chunk = numbered
        chunk, tags, weights = _prepare_rows(
            mc, chunk, [seed, ci], mc.stats.sample_rate,
            mc.stats.sample_neg_only, fold_multiclass=True)
        return ci, chunk, tags, weights

    def _prep1(numbered):
        """`_prepared`, then the column parses the sketches read, all on
        the prefetch thread."""
        ci, chunk, tags, weights = _prepared(numbered)
        for cc in stats_cols if chunk.n_rows else ():
            if cc.is_categorical():
                chunk.column(cc.column_name)
                chunk.missing_mask(cc.column_name)
            else:
                chunk.numeric(cc.column_name)
        return ci, chunk, tags, weights

    # ---- pass 1: each shard folds its chunks into its own sketches ----
    if phase in (None, "pass1"):
        for ci, chunk, tags, weights in prefetch_iter(
                plan.resume_slice(enumerate(chunk_factory()), cursors1),
                transform=_prep1):
            # preemption seam: between folds, so a snapshot always holds
            # whole chunks
            faults.fault_point("chunk")
            s = plan.shard_of(ci)
            cursors1[s] = ci
            if chunk.n_rows:
                plan.record(s, chunk.n_rows, "stats.pass1")
                hp.record(chunk.n_rows, "stats.pass1")
                shard_valid[s] += chunk.n_rows
                shard_pos[s] += int((tags == 1).sum())
                shard_neg[s] += int((tags == 0).sum())
                bm = bin_subset(tags)
                for cc in stats_cols:
                    sk = sketches[s][cc.column_name]
                    if cc.is_categorical():
                        sk.update(chunk.column(cc.column_name),
                                  chunk.missing_mask(cc.column_name))
                    else:
                        sk.update(chunk.numeric(cc.column_name), bm,
                                  weights if use_weights else None)
            if ck is not None:
                ck.maybe_save(lambda: _states(cursors1, "pass1"))
        if ck is not None:  # pass 1 done: a resume never repeats it
            ck.save(*_states([-1] * S, "pass1-done"))
    t1 = time.perf_counter()
    t["pass1"] = t1 - t0
    if hp.active:
        # pass-1 barrier: publish this host's shards' sketches and
        # counters, merge every host's (each host derives the same bins)
        hostsync.publish_part(
            checkpoint_root, "stats-pass1", hp, sha,
            arrays={"nValid": shard_valid, "nPos": shard_pos,
                    "nNeg": shard_neg},
            blob=pickle.dumps(sketches))
        parts1 = hostsync.await_parts(checkpoint_root, "stats-pass1", hp,
                                      sha)
        sketch_sets = [sk for _a, _m, blob in parts1
                       for sk in pickle.loads(blob)]
        n_valid_rows = int(sum(a["nValid"].sum() for a, _m, _b in parts1))
        n_pos = int(sum(a["nPos"].sum() for a, _m, _b in parts1))
        n_neg = int(sum(a["nNeg"].sum() for a, _m, _b in parts1))
        t["barrier1"] = time.perf_counter() - t1
    else:
        sketch_sets = sketches
        n_valid_rows = int(shard_valid.sum())
        n_pos, n_neg = int(shard_pos.sum()), int(shard_neg.sum())
    reg = registry()
    reg.counter("stats.rows_valid").inc(n_valid_rows)
    reg.counter("stats.rows_pos").inc(n_pos)
    reg.counter("stats.rows_neg").inc(n_neg)
    reg.gauge("stats.columns").set(len(stats_cols))
    log.info("streaming stats pass 1: %d rows (%d pos / %d neg) over %d "
             "shard(s) x %d host(s)", n_valid_rows, n_pos, n_neg, S,
             hp.n_hosts)
    t1 = time.perf_counter()

    # ---- merge the shards' sketches in host-major, then shard, order
    # (a copy: the per-shard ones stay as snapshotted; the hosts' came
    # off the barrier as copies) and finalize the bins ----
    merged = (pickle.loads(pickle.dumps(sketch_sets[0]))
              if ck is not None and not hp.active else sketch_sets[0])
    for other in sketch_sets[1:]:
        for name, sk in merged.items():
            sk.merge(other[name])
    for cc in stats_cols:
        sk = merged[cc.column_name]
        bn = cc.column_binning
        if cc.is_categorical():
            cats = sk.top_categories(cate_max)
            bn.bin_category = cats
            bn.bin_boundary = None
            bn.length = len(cats)
            continue
        if method == BinningMethod.EQUAL_INTERVAL:
            lo, hi = sk.min, sk.max
            if np.isfinite(lo) and np.isfinite(hi) and hi > lo:
                step = (hi - lo) / max_bins
                bounds = [float("-inf")] + [lo + k * step
                                            for k in range(1, max_bins)]
            else:
                bounds = [float("-inf")]
        else:
            hist = sk.hist if sk.hist.total_weight > 0 else sk.hist_all
            bounds = hist.boundaries(max_bins)
        bn.bin_boundary = bounds
        bn.bin_category = None
        bn.length = len(bounds)
    t2 = time.perf_counter()
    t["bins"] = t2 - t1

    # ---- pass 2: bin codes folded on the device ----
    slots, col_offsets, numeric_cols = _column_slot_layout(stats_cols)
    total_slots = int(sum(slots))

    def _coded(numbered):
        ci, chunk, tags, weights = _prepared(numbered)
        if not chunk.n_rows:
            return ci, None
        codes, _offs, _sl, values, _nc = build_codes(chunk, stats_cols)
        return ci, (codes, tags, weights, values)

    n_chunks = 0  # chunks this host folds in pass 2 (stats.chunks)
    for ci, item in prefetch_iter(
            plan.resume_slice(enumerate(chunk_factory()), cursors2),
            transform=_coded):
        if item is not None:
            n_chunks += 1
            faults.fault_point("chunk")
            codes, tags, weights, values = item
            acc.fold(codes, col_offsets, total_slots, tags, weights, values,
                     shard=plan.shard_of(ci))
            plan.record(plan.shard_of(ci), len(tags), "stats.pass2")
            hp.record(len(tags), "stats.pass2")
        cursors2[plan.shard_of(ci)] = ci
        if ck is not None:
            ck.maybe_save(lambda: _states(cursors2, "pass2",
                                          acc.snapshot()))
    if hp.active:
        # pass-2 barrier: the exact (unrounded) folds, added in host
        # order and rounded once, as one process rounds its shards' sum
        t_b = time.perf_counter()
        state = acc.snapshot()
        state.pop("rows")
        hostsync.publish_part(checkpoint_root, "stats-pass2", hp, sha,
                              arrays=state, meta={"chunks": n_chunks})
        parts2 = hostsync.await_parts(checkpoint_root, "stats-pass2", hp,
                                      sha)
        exact = None
        for h_arrays, _meta, _blob in parts2:
            if h_arrays:  # else that host's slice kept no rows
                exact = add_states(exact, h_arrays)
        agg = None if exact is None else rounded_state(exact)
        n_chunks = int(sum(m.get("chunks", 0) for _a, m, _b in parts2))
        t["barrier2"] = time.perf_counter() - t_b
        log.info("streaming stats: %s", hp.describe())
    else:
        agg = acc.fetch()
    reg.counter("stats.chunks").inc(n_chunks)
    t3 = time.perf_counter()
    t["pass2"] = t3 - t2
    if ck is not None:
        ck.clear()  # stream complete
    if agg is None:
        log.warning("streaming stats: no rows survived filtering")
        return
    medians = [merged[cc.column_name].median for cc in numeric_cols]
    cat_missing = {
        cc.column_name: (int(merged[cc.column_name].missing),
                         float(merged[cc.column_name].missing)
                         / max(n_valid_rows, 1))
        for cc in stats_cols if cc.is_categorical()}
    _write_back(stats_cols, slots, col_offsets, *agg, medians=medians,
                cat_missing=cat_missing, numeric_cols=numeric_cols,
                n_valid_rows=n_valid_rows)
    t["write_back"] = time.perf_counter() - t3

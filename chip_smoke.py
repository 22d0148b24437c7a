#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`shifu_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--out chiprun_out/chip_smoke.json]

Phases, each of which must pass:

1. build   compiles `shifu_tpu_torch/csrc/hist_level.cu` with nvcc for
           sm_90a (a fresh build, never a cached library).
2. kernels holds the histogram entries of the histogram -> split-scan
           kernels (`fused_level`, `hist_level`) against their plain PyTorch
           versions on the card, at the bench `gbt` shape (L = 1..32,
           bf16 planes, int8 codes), the bench `rf` shape (L = 64 and 128,
           histogram only, f32 planes) and the bench `gbt_wide` shape (int32
           codes, one 2,001-slot categorical, which takes the wide route;
           L = 1, 8, 32); then the
           multi-class mode of both (`fused_level_mc`, `hist_level_mc`) at
           the bench `rf` shape with K = 3, 5, 8 (past the 48 KB static
           shared-memory limit) and 32 (past a full 1,024-slot segment):
           fused at L = 1..32, histogram only at L = 64 and 128. Every
           mode's planes are bit-equal to the exact fixed-point plain
           version (`hist_level_fixed_reference`), integer planes also to
           the f32 plain version; gini scan tuples exact, entropy gains at
           rtol 1e-6. It times kernel, plain version and, where there is
           one, the library call, and, from the torch profiler, the
           pre-pass, accumulate and finalize kernels' device time and the
           device launches of one entry call. Then the scan-only entry
           (`scan_level`, `scan_level_mc`) at the main path's shapes:
           derived siblings of bench `gbt` (L = 1, 16, bf16) and `rf`
           (L = 32), the L = 128 levels, K = 3/5/8/32, node totals past
           2^24 and a bench `gbt_wide` level (its 2,001-slot column takes
           the torch scan): per-slot planes against
           `scan_planes_reference` and the 9-tuple against the plain
           scan, bit for bit on integer planes; timed beside the plain
           torch scan the parent's main path ran.
3. gbt     bench `gbt` (500k x 30 x 33 slots, 5 trees, depth 6): CleanedData
           written with `write_codes`, `load_codes`, `train_trees` on cuda,
           a second run bit-equal, the `.gbt` saved, loaded and scored on
           cuda, scores within atol 0.03 of the same run on the CPU.
4. rf      bench `rf` (500k x 30, 10 trees, depth 8): reaches both kernel
           entries; the forest is bit-equal to the CPU run's.
5. native  `shifu train` NATIVE RF, the slice's main path: a model set
           (ModelConfig.json: RF, NATIVE, 5 class tags, TreeNum 10,
           MaxDepth 8, TWOTHIRDS, gini; ColumnConfig.json; CleanedData of
           the bench `rf` shape) written with the port's own modules, then
           `TrainProcessor(root, device="cuda").run()` twice (the model
           files byte-identical), both multi-class entries launched and no
           plain version called, `model0.rf` round-tripped, scored on cuda
           ([n, 5] votes, rows sum to 1), and the CPU run's model file
           byte-identical to the card's.
6. ova     `shifu train` ONEVSALL GBT: 3 classes, 100k rows of the bench
           `gbt` shape, 5 trees, depth 6: three `model<k>.gbt`, a second
           card run bit-equal, scores within 0.03 of the CPU run.

7. raw     `shifu init` + `shifu stats -correlation -psi` from raw text:
           200,000 pipe-delimited rows of the bench `rf` width (a 0/1
           target, a weight column of exact f32 values in [0.5, 2), 20
           numeric columns printed %.5f with 2% missing tokens, 10
           categorical columns of up to 64 tokens, a 12-value unit column
           for -psi; about 50 MB, under the in-RAM memory budget) written
           from --seed; `InitProcessor` then `StatsProcessor` twice on the
           card and once on the CPU, each on its own copy, all in this
           process, and a stats run again under the profiler on the first
           card run's copy. The card runs' ColumnConfig.json, autotype
           JSON and correlation CSV are byte-identical (the profiled run's
           too); the CPU run's equal the card's but for `mean`
           and `stdDev` (f32 sums, engine.py) and the correlation values,
           within rtol 1e-6 atol 1e-6. It prints rows/s of each step, the
           stats step's host split (parse, prepare, bins, codes, copy,
           aggregate, write-back, correlation, psi; the aggregate's device
           ms) of the second card run, unprofiled, and the idle share of
           the profiled run's device busy against that run's stats time.

8. prep    the chain `shifu norm` -> `varsel` -> `norm` -> `train` on
           phase 7's card model sets after their stats: varSelect KS, 20
           of the 30 candidates, the auto-filter with correlationThreshold
           0.9; norm ZSCALE (value columns and categorical posrate tables
           on the device); RF, 10 trees, depth 8, TWOTHIRDS. Twice on the
           card, once on the CPU on a copy of the first card set taken
           after stats, and a norm run again under the profiler: the
           NormalizedData, CleanedData (20 columns after varsel) and
           post-varsel ColumnConfig.json of all runs byte-identical, the
           card runs' model0.rf too; the CPU forest's scores within 0.03
           of the card's (the weight column's sums are exact on the card
           and f32 on the CPU, as GBT's are). It prints the second card run's norm rows/s
           and split (read, normalize, write, bincode; the normalize
           stage's device ms), varsel s, train s and trees/s, and the
           idle share of the profiled norm run.

9. nn      NN/LR on the card, torch ops and cuBLAS (no kernel of its own;
           TF32 and bf16 reduced-precision reductions off): (a) bench
           `SMALL` (1,000,000 x 30, hidden [50] tanh, RPROP, valid 0.1,
           50 epochs, seed 1) in bf16 then f32, two card runs of each
           with bit-equal weights (the second timed: row-epochs/s,
           TFLOP/s by bench.py's formula), a profiled bf16 run (device
           busy, idle share), and a CPU f32 run whose final valid error
           is within 1e-3 of the card's; (b) bench `DENSE` (131,072 x
           1024, [2048, 2048], 30 epochs) in bf16 the same way and once
           in f32, and the first epoch's f32 descent gradient on 8,192
           rows from one init on the card and the CPU, max |dg| <= 1e-4 x
           max |g|; (c) `shifu train` NN (hidden [50] tanh, bagging 5, 30
           epochs) on phase 8's selected 200,000-row set, twice on the
           card (five model files, byte-identical) and once on the CPU
           (valid errors within 1e-3); (d) varsel filterBy SE (10 of 20)
           on the same sets, the card and the CPU selecting the same
           columns.

10. eval  `shifu posttrain` then `shifu eval -run` on the card, no kernel
           of its own (the norm plan's torch ops, the MLP's cuBLAS GEMMs,
           the forest traversal's gathers): a held-out raw file of phase
           7's width, 200,000 rows written from --seed + 1, which `eval
           -new` points each model set at; (a) phase 9(c)'s NN set (five
           `.nn` on 20 selected columns: norm plan -> forward) and (b)
           phase 8's RF set (`model0.rf`, 10 trees, depth 8:
           `codes_from_raw` -> traversal). Each twice on the card, once on
           the CPU, and the score stage once more under the profiler (it
           must rewrite the same bytes). The card runs' score file,
           EvalPerformance.json, confusion CSV, gain chart, post-posttrain
           ColumnConfig.json and feature-importance file byte-identical;
           the CPU run's tag and weight columns identical, its scores
           within 0.001, AUC within 1e-6, binAvgScore within 0.01. It
           prints eval rows/s and the stage split of the second card run
           (read, normalize or codes, forward with its device ms by CUDA
           events, aggregate, write, perf), posttrain seconds, the idle
           share of the profiled score stage and the AUC.

11. serve `shifu serve` on the card, no kernel of its own (the registry's
           fused program: the norm plan's torch ops, the MLPs' cuBLAS
           GEMMs, the aggregates): (a) phase 9(c)'s NN set through
           `ModelRegistry(device="cuda")`, every bucket warmed, phase
           10's held-out rows in 1,024-row batches, twice (bit-identical),
           within 2e-3 score units of the `ModelRunner` on the card and of
           a CPU registry; the first 1,024 rows as JSON records (strings,
           and typed numbers) and as the binary wire, bit for bit alike;
           the largest |d| of 64 rows batched vs scored alone (printed,
           not gated). (b) bench.py's `SERVE` set (30 columns, [50] tanh,
           3 bags, a queue of 256) through `ScoringServer` over HTTP on
           127.0.0.1: 240 single-record JSON requests at closed-loop
           concurrency 1, 4 and 16 and again at 16 with barrier batching,
           240 binary requests of 64 rows; p50, p99, QPS; every request
           answered 200, /healthz 200, a clean drain. (c) phase 8's RF set
           through the registry's `ModelRunner` fallback, bit-equal to the
           runner. (d) a 1-row and a 1,024-row batch under the profiler:
           device launches, exactly one HtoD and one DtoH memcpy (gated),
           device busy against the unprofiled wall, the host split.

12. growers the leaf-wise and host-batched growers through the histogram-
           only and scan-only entries, then the lifecycle's two ends:
           (a) leaf-wise GBT on bench `gbt` (MaxLeaves 32, MaxDepth 10,
           5 trees) and (b) leaf-wise RF on bench `rf` (MaxLeaves 64,
           MaxDepth 10, 10 trees); (c) host-batched GBT on bench
           `gbt_wide` (MaxDepth 12 at the default MaxStatsMemoryMB 256:
           a node batch of 2,437, the 2,048-node level one batch, the
           4,096-node level two) and (d) host-batched RF on bench `rf`
           (MaxDepth 8, MaxStatsMemoryMB 1: a node batch of 66, the 128-
           and 256-node levels in 2 and 4 batches). Each twice on the card
           (bit-equal forests, child pointers included), `hist_level` and
           `scan_level` launched as the `tree.hist.*` counters and the level plan
           say, no plain version called and no plain torch scan but on
           (c)'s 2,001-slot column; one tree unprofiled and profiled
           (device busy, idle share); RF's first trees bit-equal to a CPU
           run's (3 trees), GBT's scores within 0.03 of a CPU run's (5
           and 2 trees). (e) `new` twice (the same files but for the
           creation time); `export` pmml, onebagging, columnstats,
           woemapping (and corr) on phase 9(c)'s NN set and phase 8's RF
           set, twice, byte-identical; `encode` of phase 10's held-out
           rows with phase 8's RF set and of (b)'s leaf-wise forest (3
           trees on 100,000 rows, raw values written back from the codes)
           as a model set, on the card and the CPU byte-identical, the
           leaf ids those of the child pointers; `combo -new NN,GBT,LR
           -init -run -eval` on a 20,000-row raw set from --seed + 2 on
           the card and the CPU: the same spec and member configs, the NN
           member's scores within 10 x1000 units, the GBT member's within
           10 on average (100 trees drift apart on near-tied gains), each
           member's AUC and the combo's within 0.01.
13. wdl    (~120 s) WDL, the reference formats and `convert`; no kernel
           of its own (torch gathers by indexing, whose backward sums in
           a fixed order on the card, cuBLAS GEMMs, autograd). First the
           backward of both gathers, indexing and `embedding`, three
           times at bench `WDL`'s first field and at its 10 stacked
           fields: indexing must give the same bits each time on the
           card, `embedding` on the CPU (the other is reported); then
           their forward and backward timed in two designs, one gather
           a field against one over the stacked tables. (a)
           `train_wdl` at bench `WDL` (200,000 rows, 20 dense, 10 fields
           of vocab 100, embed 8, [100, 50] relu, 20 epochs, valid 0.1,
           seed 1; data from --seed): two card runs bit-equal, the second
           timed (row-epochs/s), a third profiled (device busy, idle
           share, largest items), the CPU run's valid error within 1e-3
           with the same iterations; (b) `train_wdl_bagged` at the same
           shape, 5 members, two card runs bit-equal. (c) phase 7's raw
           set (phase 8's card2 copy, `varsel -reset`) switched to WDL
           ([100, 50] relu, embed 8, ADAM 0.05, bagging 3, 5 epochs): `norm`, then
           `train` through the CLI twice on the card (model files
           byte-identical) and once with `--device cpu` (headers equal
           but for the two errors, which agree within 1e-3). (d)
           posttrain + `eval -run` of (c)'s set on phase 10's held-out
           rows as in phase 10 (card runs byte-identical; CPU scores
           0.001, AUC 1e-6). (e) the set through `ScoringServer` over
           HTTP (the ModelRunner fallback): 64 held-out rows as JSON, the
           scores (d)'s. (f) `convert -toref` of (c)'s model0.wdl scored
           as a reference WDL, and `-toeg` of phase 9's model0.nn scored
           as EG text, each within 1e-5 relative of the native file on
           20,000 held-out rows; `-tozip` then `-tobin` of the `.wdl`,
           the `.nn` and phase 8's `.rf` byte-identical to the originals.

14. stream the streamed (larger-than-memory) lifecycle. (a) bench `gbt`,
           bench `rf`, NATIVE RF (phase 5's model set) and leaf-wise GBT
           (bench `gbt`, 32 leaves), each written as 8 CleanedData
           shards and trained by `train_trees_streamed` on the card
           twice (bit-equal): `hist_level(_mc)` a shard a level (a
           built leaf) and `scan_level(_mc)` a level (a leaf) but the
           last, whose leaves are node totals, as the hist counters and
           the shard count predict, never a fused entry or a plain
           version; RF and NATIVE bit-equal to phases 4's and 5's
           in-memory forests (NATIVE's valid error too) and to the
           first tree of a CPU streamed run, GBT scores within 0.03 of
           the in-memory card run's; trees/s, HtoD bytes and ms a level,
           one run profiled. (b) phase 7's raw rows (the first
           100,000, without the weight column: unit weights keep the RF
           planes integers) with both memory budgets below the data, 4
           chunks: stats -correlation -psi -> norm (and norm -shuffle)
           -> train RF, NN, WDL -> eval -run (RF) on 50,000 of phase
           10's held-out rows, every step streamed, twice on the card
           (byte-identical artifacts); the RF model file equal to the
           in-RAM route's on the same bins; rows/s of each step against
           the in-RAM route's; the RF train profiled; the CPU run:
           stats (phase 7's contract), norm bytes, NN and WDL valid
           errors within 1e-3, eval of the card's models (scores 0.001,
           AUC 1e-6). (c) a streamed norm and a streamed eval stopped by
           a hook of the phase after one chunk, then resumed:
           byte-identical to the unbroken runs.

15. mesh   data-parallel training over a device mesh: a virtual mesh of
           4 row shards on cuda:0 (`data_mesh(virtual=4)`), which runs
           every line of the meshed path but the copies between cards.
           (a) bench `gbt`, `rf` and NATIVE RF (phase 5's CleanedData and
           config) through `train_trees(mesh=)`, twice (bit-equal): RF
           and NATIVE bit-equal to phases 4's and 5's `mesh=None`
           forests, GBT scores within 0.03 of phase 3's (the largest
           difference printed); `hist_level(_mc)` 4 x the levels,
           `scan_level(_mc)` once a level, `fused_level(_mc)` never, no
           plain version; trees/s, busy and idle share of a profiled
           run, and the merge of one level (`merge_acc` of 4 parts,
           held equal to one call over every row) in ms. (b) the
           host-batched grower at bench `gbt_wide` (depth 12, 2 trees)
           on the mesh, bit-equal to `mesh=None`. (c) phase 14(a)'s 8
           CleanedData shards of bench `rf` streamed on the mesh (3
           trees, each file shard's rows split over the 4 shards), the
           first trees of phase 14(a)'s forest. (d) bench `SMALL` (f32)
           and bench `WDL` on the mesh, twice (bit-equal): the same
           iterations as `mesh=None`, valid errors within 1e-4; row-
           epochs/s, `SMALL`'s TFLOP/s. (e) phase 14(b)'s streamed stats
           -correlation -psi and norm at `shifu.lifecycle.shards=4` and
           1: the categorical columns' stats and bins, every column's
           counts and extrema and its bins' total counts alike; the
           files and the numeric columns whose bins differ printed (pass
           1 merges the shards' numeric sketches in shard order, an
           approximate merge, as the JAX package does). (f) where `torch.cuda.device_count() > 1`:
           the kernel entries on cuda:1 with cuda:0 current against
           their plain versions, bench `rf` and `SMALL` over every card;
           on one card one line says so.

Every main-path run (phases 3-6 and 8's train) must launch the scan entry
once for each subtraction level of each tree (bench `gbt` 25, `rf` 70,
NATIVE 70, ONEVSALL 75, the prep chain's RF 70) and run no plain torch
scan on the card.

The `kernels` line counts every counted run's launches, phase 15's
meshed runs among them (`mesh_launches` apart).

It prints the card and its power limit, a `kernels` JSON line, and as its
last line {"ok": true, "device": {...}}. It exits non-zero without a CUDA
device, outside a checkout of the repository, or when any phase fails.
The per-shape details go to --out.

    python3 chip_smoke.py --entries [--package-root DIR]

only times one call of each entry at the shapes of the `kernels` line
and at the bench `gbt` L = 32 and `gbt_wide` L = 1, 8, 32 levels (the
scan entry where the package has one; entry
ms; device ms of its kernels and device launches a call, from the
profiler), with `shifu_tpu_torch` imported from DIR (default: this
checkout), appends a line to entries.jsonl beside the --out file and
exits: run it on an unpacked earlier commit and on this one in turns to
compare them on one card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# bench.py's tree configurations (GBT, RF, GBT_WIDE)
GBT = dict(n=500_000, f=30, bins=32, trees=5, depth=6)
RF = dict(n=500_000, numeric=20, cat65=10, trees=10, depth=8)
WIDE = dict(n=200_000, numeric=180, cat64=19, wide_cat=2000)

GBT_SCORE_ATOL = 0.03  # the JAX package's kernel-on/off tolerance

SPLIT_FIELDS = ("feature", "cut_rank", "rank_flat", "leaf_value", "is_split",
                "best_gain", "left_mask", "node_cnt", "left_cnt")
EXACT_FIELDS = ("feature", "cut_rank", "rank_flat", "is_split", "left_mask",
                "node_cnt", "left_cnt")


class PhaseFailed(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseFailed(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------


def time_ms(torch, fn, reps: int = 7, warm: int = 2) -> float:
    """Median CUDA-event time of one call, after warm-up."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _device_times(prof, reps: int) -> dict:
    """Device microseconds per call by kernel name, from a profile."""
    import torch

    out = {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = float(getattr(ev, "device_time_total", 0.0)
                   or getattr(ev, "cuda_time_total", 0.0))
        out[ev.key] = out.get(ev.key, 0.0) + us / reps
    return out


def _profile(torch, **kw):
    """A torch profiler of the device that keeps every event it records
    (acc_events, where this torch has it); `kw` go to the profiler."""
    import inspect

    from torch.profiler import ProfilerActivity, profile

    if "acc_events" in inspect.signature(profile).parameters:
        kw["acc_events"] = True
    return profile(activities=[ProfilerActivity.CUDA], **kw)


def _device_counts(prof, reps: int) -> dict:
    """Device launches per call by kernel name, from a profile."""
    import torch

    out = {}
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            out[ev.key] = out.get(ev.key, 0) + ev.count / reps
    return out


# the port's CUDA kernels, by the name the profiler gives them
HIST_KERNELS = (("prepass", "hist_group_kernel"),
                ("accumulate", "hist_accumulate"),
                ("finalize", "hist_finalize_kernel"),
                ("scan", "hist_scan_kernel"))


def device_split_ms(torch, fn, reps: int = 5,
                    once: str = "hist_accumulate") -> dict:
    """Per call, from the torch profiler: device time of each of the
    port's kernels, of everything the call ran on the device, and the
    number of device launches (kernels, copies, fills) of one call. None
    where the profiler recorded no device activity, or lost some of it
    (the kernel `once` not once a call)."""
    fn()
    torch.cuda.synchronize()
    # a profile that lost events is taken again, and after a few such
    # profiles not measured
    for _attempt in range(4):
        with _profile(torch) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        counts = _device_counts(prof, reps)
        whole = sum(c for n, c in counts.items() if once in n) == 1
        if whole:
            break
    times = _device_times(prof, reps)
    if not times or not whole:
        return dict({f"{k}_ms": None for k, _n in HIST_KERNELS},
                    device_busy_ms=None, device_launches=None)
    pick = lambda k: sum(v for n, v in times.items() if k in n) / 1e3  # noqa
    out = {f"{k}_ms": pick(name) for k, name in HIST_KERNELS}
    out.update(device_busy_ms=sum(times.values()) / 1e3,
               device_launches=sum(counts.values()))
    return out


def profile_run(torch, fn, wall_s: float) -> dict:
    """Device busy time of one run of `fn` under the torch profiler, its
    share of `wall_s` (the same run's time unprofiled), and the kernels
    that took most device time."""
    torch.cuda.synchronize()
    with _profile(torch) as prof:
        fn()
        torch.cuda.synchronize()
    return profile_summary(prof, wall_s)


def profile_summary(prof, wall_s: float, top: int = 8) -> dict:
    """`profile_run`'s fields from a profile of one run of `wall_s`."""
    times = _device_times(prof, 1)
    if not times:
        return dict(device_busy_s=None, idle_share=None, top_kernels=[],
                    hist_kernels={})
    busy = sum(times.values()) / 1e6
    ranked = sorted(times.items(), key=lambda kv: -kv[1])[:top]
    counts = _device_counts(prof, 1)
    hist = {k: dict(ms=sum(v for n, v in times.items() if name in n) / 1e3,
                    launches=int(sum(c for n, c in counts.items()
                                     if name in n)))
            for k, name in HIST_KERNELS}
    return dict(device_busy_s=busy, idle_share=max(0.0, 1.0 - busy / wall_s),
                top_kernels=[[k[:80], v / 1e3] for k, v in ranked],
                hist_kernels=hist)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

ENTRIES = ("fused_level", "hist_level", "scan_level", "fused_level_mc",
           "hist_level_mc", "scan_level_mc")
# class counts of the multi-class checks: 5 is the main path's (phase 5),
# 8 passes the 48 KB static shared-memory limit, 32 passes the point
# where a 1,024-slot segment of 32 planes fits in 227 KB
MC_KS = (3, 5, 8, 32)
MC_MAIN_K = 5


class KernelStats:
    def __init__(self):
        self.max_abs_err = {k: 0.0 for k in ENTRIES}
        self.timed = {}  # entry -> dict(ms, plain_ms, bound_ms, ...)
        self.timed_mc = {}  # (entry, K) -> the same
        self.cases = []

    def err(self, name: str, a, b) -> float:
        e = float((a.double() - b.double()).abs().max()) if a.numel() else 0.0
        self.max_abs_err[name] = max(self.max_abs_err[name], e)
        return e


def _level_case(torch, dev, codes_np, L: int, seed: int,
                float_labels: bool, poisson: bool):
    """Level inputs on the card: node ids in [0, L), 90% rows active;
    0/1 labels (integer-valued planes) or residual-like float labels."""
    rng = np.random.default_rng(seed)
    n = codes_np.shape[0]
    if float_labels:
        y = (rng.random(n) - 0.35).astype(np.float32)
    else:
        y = (codes_np[:, 0] + codes_np[:, 1] >= 32).astype(np.float32)
    w = (rng.poisson(1.0, size=n) if poisson
         else np.ones(n)).astype(np.float32)
    node = rng.integers(0, L, size=n).astype(np.int32)
    act = rng.random(n) < 0.9
    t = lambda a: torch.as_tensor(a).to(dev)  # noqa: E731
    return t(y), t(w), t(node), t(act)


def _live_rows(w, act) -> int:
    return int(((w != 0) & act).sum())


def check_fixed(torch, hk, tag, hist, codes, y, w, node, act, kw):
    """The kernel's planes against the exact fixed-point plain version:
    bit for bit, in every mode."""
    keep = ("L", "lay", "low_precision", "n_classes")
    hf = hk.hist_level_fixed_reference(codes, y, w, node, act,
                                       **{k: kw[k] for k in keep if k in kw})
    check(torch.equal(hist, hf), f"{tag}: planes differ from the fixed-point "
          f"plain version (max abs err "
          f"{float((hist.double() - hf.double()).abs().max())})")


def check_fused(torch, hk, stats, tag, codes, codes8, lay, L, y, w, node,
                act, fok, lowp, exact, timed=False):
    # the trainer's int_planes: RF planes (f32) of integers
    kw = dict(L=L, lay=lay, impurity="variance", min_inst=5, min_gain=0.0,
              low_precision=lowp, int_planes=exact and not lowp)
    h1, o1 = hk.fused_level(codes, y, w, node, act, fok, codes8=codes8, **kw)
    h2, o2 = hk.fused_level(codes, y, w, node, act, fok, codes8=codes8, **kw)
    hp, op = hk.fused_level_reference(codes, y, w, node, act, fok, **kw)
    torch.cuda.synchronize()
    check(torch.equal(h1, h2) and all(torch.equal(a, b)
                                      for a, b in zip(o1, o2)),
          f"{tag}: two kernel launches differ")
    check(torch.equal(h1[0], hp[0]), f"{tag}: count plane differs")
    check_fixed(torch, hk, tag, h1, codes, y, w, node, act, kw)
    e = stats.err("fused_level", h1, hp)
    if exact:
        check(torch.equal(h1, hp), f"{tag}: integer-valued planes differ "
              f"(max abs err {e})")
        for nm, a, b in zip(SPLIT_FIELDS, op, o1):
            if nm in EXACT_FIELDS:
                check(torch.equal(a, b), f"{tag}: {nm} differs")
            else:
                fin = torch.isfinite(a)
                check(torch.equal(fin, torch.isfinite(b))
                      and torch.allclose(a[fin], b[fin], rtol=1e-6, atol=0),
                      f"{tag}: {nm} beyond rtol 1e-6")
                stats.err("fused_level", torch.where(fin, a, 0),
                          torch.where(fin, b, 0))
        agree = 1.0
    else:
        agree = float((o1[0] == op[0]).float().mean())
    case = dict(case=tag, entry="fused_level", L=L, n=int(codes.shape[0]),
                T=lay.T, exact_planes=exact, max_abs_err=e,
                split_feature_agreement=agree)
    if timed:
        case.update(_time_entry(torch, hk, "fused_level", codes, codes8, lay,
                                L, y, w, node, act, fok, kw))
    stats.cases.append(case)
    print(f"  {tag}: ok (max abs err {e:.3g}"
          + (f", kernel {case['ms']:.4f} ms, plain {case['plain_ms']:.4f} ms,"
             f" bound {case['bound_ms']:.4f} ms" + _split(case)
             if timed else "") + ")")
    return case


def check_hist(torch, hk, stats, tag, codes, codes8, lay, L, y, w, node, act,
               lowp, timed=False):
    kw = dict(L=L, lay=lay, low_precision=lowp, int_planes=not lowp)
    h1 = hk.hist_level(codes, y, w, node, act, codes8=codes8, **kw)
    h2 = hk.hist_level(codes, y, w, node, act, codes8=codes8, **kw)
    hp = hk.hist_level_reference(codes, y, w, node, act, **kw)
    torch.cuda.synchronize()
    check(torch.equal(h1, h2), f"{tag}: two kernel launches differ")
    check_fixed(torch, hk, tag, h1, codes, y, w, node, act, kw)
    e = stats.err("hist_level", h1, hp)
    check(torch.equal(h1, hp), f"{tag}: integer-valued planes differ "
          f"(max abs err {e})")
    case = dict(case=tag, entry="hist_level", L=L, n=int(codes.shape[0]),
                T=lay.T, exact_planes=True, max_abs_err=e)
    if timed:
        case.update(_time_entry(torch, hk, "hist_level", codes, codes8, lay,
                                L, y, w, node, act, None, kw))
    stats.cases.append(case)
    print(f"  {tag}: ok (max abs err {e:.3g}"
          + (f", kernel {case['ms']:.4f} ms, plain {case['plain_ms']:.4f} ms,"
             f" bincount {case['library_ms']:.4f} ms, bound "
             f"{case['bound_ms']:.4f} ms" + _split(case)
             if timed else "") + ")")
    return case


def _split(case) -> str:
    if case["device_busy_ms"] is None:
        return "; profiler: device time lost or not recorded, not measured"
    bounds = {"accumulate": case.get("acc_bound_ms"),
              "finalize": case.get("finalize_bound_ms")}
    parts = []
    for k, _name in HIST_KERNELS:
        ms, b = case.get(f"{k}_ms"), bounds.get(k)
        if ms:
            with_pre = ", with the pre-pass" if k == "accumulate" else ""
            parts.append(f"{k} {ms:.4f} ms" + (
                f" (bound {b:.4f} ms{with_pre})" if b is not None else ""))
    return (f"; profiler: {', '.join(parts)}, device busy "
            f"{case['device_busy_ms']:.4f} ms in "
            f"{case['device_launches']:.0f} device launches a call")


def _time_entry(torch, hk, entry, codes, codes8, lay, L, y, w, node, act,
                fok, kw):
    n, F = codes.shape
    K = kw.get("n_classes", 0)
    fused = entry.startswith("fused_level")
    if fused:
        def kern():
            hk.fused_level(codes, y, w, node, act, fok, codes8=codes8, **kw)

        def plain():
            hk.fused_level_reference(codes, y, w, node, act, fok, **kw)
        library = None
    else:
        def kern():
            hk.hist_level(codes, y, w, node, act, codes8=codes8, **kw)

        def plain():
            hk.hist_level_reference(codes, y, w, node, act, **kw)
        # the yardstick: one torch.bincount per plane over the flat
        # node*T + slot index (computed outside the timed region)
        off = torch.as_tensor(lay.off.astype(np.int64), device=codes.device)
        clip = torch.as_tensor(lay.clip_max.astype(np.int64),
                               device=codes.device)
        code = torch.minimum(codes.long().clamp_min(0), clip[None, :])
        nl = torch.where(act, node.long().clamp(0, L - 1),
                         torch.zeros_like(node.long()))
        flat = (nl[:, None] * lay.T + off[None, :] + code).reshape(-1)
        wa = torch.where(act, w, torch.zeros_like(w))
        if K >= 3:  # one weighted count plane a class
            cls = y.long().clamp(0, K - 1)
            comps = [wa * (cls == c) for c in range(K)]
        else:
            comps = [wa, wa * y, wa * y * y]
        planes = [c[:, None].expand(n, F).reshape(-1) for c in comps]

        def library():
            for p in planes:
                torch.bincount(flat, weights=p, minlength=L * lay.T)
    # the bounds: the package's counts, which the tree grower's profile
    # seams record too, over the H100 SXM's HBM and f32 rates
    from shifu_tpu_torch.ops import hist_bounds as hb

    cb = 1 if codes8 is not None else 4
    pb = 2 if kw.get("low_precision") else 4
    n_live, P = _live_rows(w, act), hk.planes_of(K)
    bound, by = hb.bound_ms(*(
        hb.class_level_counts(n, n_live, F, cb, K, L, lay.T, fused)
        if K >= 3 else
        hb.level_counts(n, n_live, F, cb, pb, L, lay.T, lay.s_max, fused)))
    acc_bound = hb.bound_ms(0.0, hb.accumulate_bytes(
        n, n_live, F, cb, P, L, lay.T))[0]
    fin = hb.bound_ms(0.0, (hb.finalize_bytes if fused else
                            hb.convert_bytes)(P, L, lay.T))[0]
    return dict(ms=time_ms(torch, kern), plain_ms=time_ms(torch, plain),
                library_ms=(time_ms(torch, library) if library else None),
                bound_ms=bound, bound_by=by, acc_bound_ms=acc_bound,
                finalize_bound_ms=fin, **device_split_ms(torch, kern))


def phase_kernels(torch, dev, hk, tt, gbt_codes_np, rf_data, seed):
    stats = KernelStats()
    # bench gbt shape: 30 numeric features, 33 slots, int8 codes, bf16
    slots = [GBT["bins"] + 1] * GBT["f"]
    lay = tt.make_layout(slots, [False] * GBT["f"])
    codes = torch.as_tensor(gbt_codes_np).to(dev)
    codes8 = hk.codes8_of(codes, lay)
    fok = torch.ones(lay.T, dtype=torch.bool, device=dev)
    fok_sub = fok.clone()
    fok_sub[: int(lay.off[10])] = False  # a tree's feature subset
    for L in (1, 2, 4, 8, 16, 32):
        y, w, node, act = _level_case(torch, dev, gbt_codes_np, L,
                                      seed + L, False, False)
        check_fused(torch, hk, stats, f"gbt L={L} 0/1 planes", codes, codes8,
                    lay, L, y, w, node, act, fok_sub, True, True)
        y, w, node, act = _level_case(torch, dev, gbt_codes_np, L,
                                      seed + 100 + L, True, False)
        c = check_fused(torch, hk, stats, f"gbt L={L} float planes", codes,
                        codes8, lay, L, y, w, node, act, fok, True, False,
                        timed=True)
        if L == 1:  # level 0 of every GBT tree
            stats.timed["fused_level"] = c
    del codes, codes8

    # bench rf shape: 20 x 33 numeric + 10 x 65 categorical, f32 planes
    r_codes_np, r_slots, r_cat = rf_data
    lay = tt.make_layout(r_slots, r_cat)
    codes = torch.as_tensor(r_codes_np).to(dev)
    codes8 = hk.codes8_of(codes, lay)
    for L in (64, 128):
        y, w, node, act = _level_case(torch, dev, r_codes_np, L,
                                      seed + L, False, True)
        c = check_hist(torch, hk, stats, f"rf L={L} poisson planes", codes,
                       codes8, lay, L, y, w, node, act, False, timed=True)
        if L == 64:  # the built half of level 7 at depth 8
            stats.timed["hist_level"] = c
    fok = torch.ones(lay.T, dtype=torch.bool, device=dev)
    y, w, node, act = _level_case(torch, dev, r_codes_np, 32, seed,
                                  False, True)
    check_fused(torch, hk, stats, "rf L=32 poisson planes", codes, codes8,
                lay, 32, y, w, node, act, fok, False, True)
    del codes, codes8

    # bench gbt_wide shape: int32 codes, a feature past the segment cap
    w_codes_np, w_slots, w_cat = wide_data(seed)
    check(max(w_slots) > hk.SEG_CAP, "wide case does not take the wide route")
    lay = tt.make_layout(w_slots, w_cat)
    codes = torch.as_tensor(w_codes_np).to(dev)
    fok = torch.ones(lay.T, dtype=torch.bool, device=dev)
    for L in (1, 8, 32):
        y, w, node, act = _wide_case(torch, dev, w_codes_np, L, seed)
        check_fused(torch, hk, stats, f"gbt_wide L={L} 0/1 planes", codes,
                    None, lay, L, y, w, node, act, fok, True, True,
                    timed=True)
    torch.cuda.synchronize()
    return stats


def wide_data(seed: int):
    """bench.py bench_gbt_wide columns: 180 x 33 numeric, 19 x 65
    categorical and one 2,001-slot categorical (int32 codes)."""
    slots = ([33] * WIDE["numeric"] + [65] * WIDE["cat64"]
             + [WIDE["wide_cat"] + 1])
    is_cat = [False] * WIDE["numeric"] + [True] * (WIDE["cat64"] + 1)
    rng = np.random.default_rng(seed)
    codes = np.stack([rng.integers(0, s - 1, size=WIDE["n"])
                      for s in slots], 1).astype(np.int32)
    return codes, slots, is_cat


def _wide_case(torch, dev, codes_np, L: int, seed: int):
    """gbt_wide level inputs: 0/1 labels from the wide column, unit
    weights, node ids in [0, L), 90% rows active."""
    rng = np.random.default_rng(seed + L)
    n = codes_np.shape[0]
    y = (codes_np[:, -1] % 3 == 0).astype(np.float32)
    node = rng.integers(0, L, size=n).astype(np.int32)
    act = rng.random(n) < 0.9
    t = lambda a: torch.as_tensor(a).to(dev)  # noqa: E731
    return t(y), t(np.ones(n, np.float32)), t(node), t(act)


def _class_case(torch, dev, codes_np, L: int, K: int, seed: int):
    """Multi-class level inputs: class ids that follow a numeric and a
    categorical column, Poisson bag weights (integer planes), node ids in
    [0, L), 90% rows active."""
    rng = np.random.default_rng(seed)
    n = codes_np.shape[0]
    y = ((codes_np[:, 0] // 3 + codes_np[:, RF["numeric"]]) % K
         ).astype(np.float32)
    w = rng.poisson(1.0, size=n).astype(np.float32)
    node = rng.integers(0, L, size=n).astype(np.int32)
    act = rng.random(n) < 0.9
    t = lambda a: torch.as_tensor(a).to(dev)  # noqa: E731
    return t(y), t(w), t(node), t(act)


def check_fused_mc(torch, hk, stats, tag, codes, codes8, lay, L, K, y, w,
                   node, act, fok, impurity, timed=False):
    """Class mode, fused: planes bit-equal; gini: every field of the
    9-tuple exact; entropy: gains at rtol 1e-6 (log2f against torch's
    log2), every other field exact."""
    kw = dict(L=L, lay=lay, impurity=impurity, min_inst=5, min_gain=0.0,
              n_classes=K, int_planes=True)
    h1, o1 = hk.fused_level(codes, y, w, node, act, fok, codes8=codes8, **kw)
    h2, o2 = hk.fused_level(codes, y, w, node, act, fok, codes8=codes8, **kw)
    hp, op = hk.fused_level_reference(codes, y, w, node, act, fok, **kw)
    torch.cuda.synchronize()
    check(torch.equal(h1, h2) and all(torch.equal(a, b)
                                      for a, b in zip(o1, o2)),
          f"{tag}: two kernel launches differ")
    check_fixed(torch, hk, tag, h1, codes, y, w, node, act, kw)
    e = stats.err("fused_level_mc", h1, hp)
    check(torch.equal(h1, hp), f"{tag}: class planes differ (max abs err "
          f"{e})")
    for nm, a, b in zip(SPLIT_FIELDS, op, o1):
        if nm == "best_gain" and impurity == "entropy":
            fin = torch.isfinite(a)
            check(torch.equal(fin, torch.isfinite(b))
                  and torch.allclose(a[fin], b[fin], rtol=1e-6, atol=0),
                  f"{tag}: best_gain beyond rtol 1e-6")
            stats.err("fused_level_mc", torch.where(fin, a, 0),
                      torch.where(fin, b, 0))
        else:
            check(torch.equal(a, b), f"{tag}: {nm} differs")
    case = dict(case=tag, entry="fused_level_mc", K=K, L=L,
                n=int(codes.shape[0]), T=lay.T, impurity=impurity,
                seg_cap=hk.seg_cap(K, codes.device), max_abs_err=e,
                splits=int(o1[4].sum()))
    if timed:
        case.update(_time_entry(torch, hk, "fused_level_mc", codes, codes8,
                                lay, L, y, w, node, act, fok, kw))
    stats.cases.append(case)
    print(f"  {tag}: ok ({case['splits']} of {L} nodes split"
          + (f", kernel {case['ms']:.4f} ms, plain {case['plain_ms']:.4f}"
             f" ms, bound {case['bound_ms']:.4f} ms" + _split(case)
             if timed else "") + ")")
    return case


def check_hist_mc(torch, hk, stats, tag, codes, codes8, lay, L, K, y, w,
                  node, act, timed=False):
    kw = dict(L=L, lay=lay, n_classes=K, int_planes=True)
    h1 = hk.hist_level(codes, y, w, node, act, codes8=codes8, **kw)
    h2 = hk.hist_level(codes, y, w, node, act, codes8=codes8, **kw)
    hp = hk.hist_level_reference(codes, y, w, node, act, **kw)
    torch.cuda.synchronize()
    check(torch.equal(h1, h2), f"{tag}: two kernel launches differ")
    check_fixed(torch, hk, tag, h1, codes, y, w, node, act, kw)
    e = stats.err("hist_level_mc", h1, hp)
    check(h1.shape == (K, L, lay.T) and torch.equal(h1, hp),
          f"{tag}: class planes differ (max abs err {e})")
    plan = hk.plan_accumulate(lay, L, K, True)
    tiles = plan.n_groups * len(plan.ttiles)
    case = dict(case=tag, entry="hist_level_mc", K=K, L=L,
                n=int(codes.shape[0]), T=lay.T, tiles=tiles,
                max_abs_err=e)
    if timed:
        case.update(_time_entry(torch, hk, "hist_level_mc", codes, codes8,
                                lay, L, y, w, node, act, None, kw))
    stats.cases.append(case)
    print(f"  {tag}: ok ({tiles} accumulate tiles"
          + (f", kernel {case['ms']:.4f} ms, plain {case['plain_ms']:.4f}"
             f" ms, {K} x bincount {case['library_ms']:.4f} ms, bound "
             f"{case['bound_ms']:.4f} ms" + _split(case)
             if timed else "") + ")")
    return case


def phase_kernels_mc(torch, dev, hk, tt, stats, rf_data, seed):
    """The multi-class mode of both entries at the bench `rf` shape."""
    r_codes_np, r_slots, r_cat = rf_data
    lay = tt.make_layout(r_slots, r_cat)
    codes = torch.as_tensor(r_codes_np).to(dev)
    codes8 = hk.codes8_of(codes, lay)
    fok = torch.ones(lay.T, dtype=torch.bool, device=dev)
    fok_sub = fok.clone()
    fok_sub[: int(lay.off[10])] = False  # a tree's feature subset
    for K in MC_KS:
        print(f"  K = {K}: segment cap {hk.seg_cap(K, dev)}, finalize "
              f"shared memory {(2 * K + 3) * 4 * hk.seg_cap(K, dev)} B")
        for L in (1, 2, 4, 8, 16, 32):
            y, w, node, act = _class_case(torch, dev, r_codes_np, L, K,
                                          seed + 7 * L + K)
            c = check_fused_mc(torch, hk, stats, f"rf K={K} L={L} gini",
                               codes, codes8, lay, L, K, y, w, node, act,
                               fok_sub if L % 2 else fok, "gini",
                               timed=L == 1)
            if L == 1:
                stats.timed_mc[("fused_level_mc", K)] = c
            if L == 4:
                check_fused_mc(torch, hk, stats, f"rf K={K} L={L} entropy",
                               codes, codes8, lay, L, K, y, w, node, act,
                               fok, "entropy")
        for L in (64, 128):
            y, w, node, act = _class_case(torch, dev, r_codes_np, L, K,
                                          seed + L + K)
            c = check_hist_mc(torch, hk, stats, f"rf K={K} L={L} hist",
                              codes, codes8, lay, L, K, y, w, node, act,
                              timed=L == 64)
            if L == 64:  # the built half of level 7 at depth 8
                stats.timed_mc[("hist_level_mc", K)] = c
    del codes, codes8

    # a 900-slot categorical fits the 1,024-slot cap of 3 planes but not
    # the 867 of 32: at K = 32 it takes the wide route (the torch class
    # scan on its columns), at K = 3 the kernel scans it
    w_slots = [33] * 4 + [900]
    w_cat = [False] * 4 + [True]
    rng = np.random.default_rng(seed + 900)
    w_codes_np = np.stack([rng.integers(0, s - 1, size=200_000)
                           for s in w_slots], 1).astype(np.int32)
    lay = tt.make_layout(w_slots, w_cat)
    codes = torch.as_tensor(w_codes_np).to(dev)
    fok = torch.ones(lay.T, dtype=torch.bool, device=dev)
    for K in (3, 32):
        check(hk.seg_cap(K, dev) < 900 if K == 32
              else hk.seg_cap(K, dev) >= 900,
              f"K={K}: the 900-slot segment is not routed as intended")
        rng = np.random.default_rng(seed + K)
        y = torch.as_tensor(((w_codes_np[:, 4] // 7 + w_codes_np[:, 0]) % K)
                            .astype(np.float32)).to(dev)
        w = torch.as_tensor(rng.poisson(1.0, size=200_000)
                            .astype(np.float32)).to(dev)
        node = torch.as_tensor(rng.integers(0, 4, size=200_000)
                               .astype(np.int32)).to(dev)
        act = torch.as_tensor(rng.random(200_000) < 0.9).to(dev)
        check_fused_mc(torch, hk, stats, f"900-slot categorical K={K} L=4 "
                       "gini", codes, None, lay, 4, K, y, w, node, act, fok,
                       "gini")
    torch.cuda.synchronize()


def entry_profile(torch, dev, hk, tt, gbt_codes_np, rf_data, seed) -> list:
    """One call of each entry at the kernels line's shapes, the bench
    `gbt` L = 32 level and the bench `gbt_wide` levels L = 1, 8, 32 (int32
    codes): entry ms (CUDA events) and, from the profiler, its kernels'
    device ms and its device launches a call. The scan entry where the
    package has one (the bench `rf` L = 32 derived sibling and L = 128
    level, K = 5 at L = 32)."""
    r_codes_np, r_slots, r_cat = rf_data
    w_codes_np, w_slots, w_cat = wide_data(seed)
    g_lay = tt.make_layout([GBT["bins"] + 1] * GBT["f"], [False] * GBT["f"])
    r_lay = tt.make_layout(r_slots, r_cat)
    g_codes = torch.as_tensor(gbt_codes_np).to(dev)
    r_codes = torch.as_tensor(r_codes_np).to(dev)
    data = {"gbt": (g_codes, hk.codes8_of(g_codes, g_lay), g_lay),
            "rf": (r_codes, hk.codes8_of(r_codes, r_lay), r_lay),
            "wide": (torch.as_tensor(w_codes_np).to(dev), None,
                     tt.make_layout(w_slots, w_cat))}
    cases = []  # (name, entry, data, L, K, lowp, inputs)
    for L in (1, 32):
        cases.append((f"fused_level gbt L={L}", "fused", "gbt", L, 0, True,
                      _level_case(torch, dev, gbt_codes_np, L, seed + L,
                                  True, False)))
    cases.append(("hist_level rf L=64", "hist", "rf", 64, 0, False,
                  _level_case(torch, dev, r_codes_np, 64, seed + 64, False,
                              True)))
    for entry, L in (("fused", 1), ("hist", 64)):
        cases.append((f"{entry}_level_mc rf K=5 L={L}", entry, "rf", L, 5,
                      False, _class_case(torch, dev, r_codes_np, L, 5,
                                         seed + L)))
    for L in (1, 8, 32):
        cases.append((f"fused_level gbt_wide L={L}", "fused", "wide", L, 0,
                      True, _wide_case(torch, dev, w_codes_np, L, seed)))
    if hasattr(hk, "scan_level"):
        for L, K, derived in ((32, 0, True), (128, 0, False), (32, 5, True)):
            h = scan_hist(torch, hk, tt, dev, r_codes_np, *data["rf"], L, K,
                          seed + L + K, derived=derived)
            cases.append((f"scan_level{'_mc' if K else ''} rf K={K} L={L} "
                          f"{'derived' if derived else 'level'}", "scan",
                          "rf", L, K, False, (h, None, None, None)))
    rows = []
    for name, entry, d, L, K, lowp, (y, w, node, act) in cases:
        codes, codes8, lay = data[d]
        kw = dict(L=L, lay=lay, codes8=codes8, low_precision=lowp,
                  n_classes=K, int_planes=not lowp)
        fok = torch.ones(lay.T, dtype=torch.bool, device=dev)

        def fn():
            if entry == "fused":
                hk.fused_level(codes, y, w, node, act, fok,
                               impurity="gini" if K else "variance",
                               min_inst=5, min_gain=0.0, **kw)
            elif entry == "scan":
                hk.scan_level(y, fok, lay=lay, n_classes=K,
                              impurity="gini" if K else "variance",
                              min_inst=5, min_gain=0.0)
            else:
                hk.hist_level(codes, y, w, node, act, **kw)
        once = "hist_scan_kernel" if entry == "scan" else "hist_accumulate"
        row = dict(case=name, ms=time_ms(torch, fn), **device_split_ms(
            torch, fn, once=once))
        rows.append(row)
        print(f"  {name}: entry {row['ms']:.4f} ms" + _split(row))
    return rows


def scan_hist(torch, hk, tt, dev, codes_np, codes, codes8, lay, Lh, K,
              seed, lowp=False, w_scale=1, derived=True):
    """A histogram the scan entry takes on the main path, made on the
    card with the histogram entry: the derived sibling [P, Lh, T]
    (parents' histogram minus the built smaller children's, zero under
    parent 1, which did not split) or, without `derived`, a whole level.
    Class ids, residual-like float labels (bf16 planes, lowp) or 0/1
    labels; Poisson weights times w_scale (integer planes)."""
    rng = np.random.default_rng(seed)
    n = codes_np.shape[0]
    if K:
        y = (codes_np[:, 0] // 3 + codes_np[:, -1]) % K
    elif lowp:
        y = rng.random(n) - 0.35
    else:
        y = (codes_np[:, 0] + codes_np[:, -1]) % 3 == 0
    w = np.ones(n) if lowp else rng.poisson(1.0, size=n) * w_scale
    t = lambda a, dt: torch.as_tensor(np.asarray(a, dt)).to(dev)  # noqa
    args = (codes, t(y, np.float32), t(w, np.float32),
            t(rng.integers(0, Lh, size=n), np.int32))
    kw = dict(L=Lh, lay=lay, codes8=codes8, n_classes=K, low_precision=lowp,
              int_planes=not lowp)
    act = rng.random(n) < 0.9
    hist = hk.hist_level(*args, t(act, bool), **kw)
    if derived:
        built = hk.hist_level(*args, t(act & (rng.random(n) < 0.4), bool),
                              **kw)
        p_split = torch.arange(Lh, device=dev) != 1
        left_small = t(rng.random(Lh) < 0.5, bool)
        hist, _full = tt._derive(hist, built, p_split, left_small)
    return hist.contiguous()


def reset_obs() -> None:
    """A fresh obs scope of the port: its `tree.hist.*` counters at 0."""
    from shifu_tpu_torch import obs

    obs.reset()


def labelled(name: str, label: str) -> dict:
    """{value of `label`: count} of counter `name` in the port's obs
    registry."""
    from shifu_tpu_torch import obs
    from shifu_tpu_torch.obs.metrics import _parse_key

    out = {}
    for key, v in obs.registry().snapshot()["counters"].items():
        n, labels = _parse_key(key)
        if n == name:
            k = labels.get(label, "")
            out[k] = out.get(k, 0) + int(v)
    return out


def hist_counts() -> dict:
    """The `tree.hist.*` counters of the port's obs registry, by suffix
    (the subtraction plan's built / derived / fallback_rebuilds)."""
    from shifu_tpu_torch import obs

    reg = obs.registry()
    return {k: int(reg.counter(f"tree.hist.{k}").value)
            for k in ("built", "derived", "fallback_rebuilds")}


class PlainScans:
    """Counts the plain torch scans (`tree_trainer.split_scan` /
    `cls_scan`) that run on the card, by the width of the histogram they
    are given: on the main path they take only columns wider than the
    scan kernels' cap."""

    def __init__(self, tt):
        self.tt = tt
        self.widths = []

    def __enter__(self):
        self.saved = (self.tt.split_scan, self.tt.cls_scan)

        def counted(fn):
            def scan(hist, *a, **k):
                if hist.device.type == "cuda":
                    self.widths.append(int(hist.shape[-1]))
                return fn(hist, *a, **k)
            return scan
        self.tt.split_scan, self.tt.cls_scan = map(counted, self.saved)
        return self

    def __exit__(self, *exc):
        self.tt.split_scan, self.tt.cls_scan = self.saved


def check_scan(torch, hk, tt, stats, tag, lay, hist, fok, K, impurity,
               exact, timed=False, wide=0):
    """The scan-only entry against its plain versions: per-slot planes
    against `scan_planes_reference` and the 9-tuple against the plain
    scan, bit for bit on integer planes (entropy gains at rtol 1e-6:
    log2f against torch's log2); on bf16 planes gains and sums at rtol
    1e-5 and feature and cut equal wherever a node's two best gains
    differ by more. Where a column passes the cap (`wide` slots), the
    plain scan runs on those columns only."""
    entry = "scan_level_mc" if K >= 3 else "scan_level"
    kw = dict(impurity=impurity, min_inst=5, min_gain=0.0, n_classes=K)
    with PlainScans(tt) as ps:
        out = hk.scan_level(hist, fok, lay=lay, **kw)
    out2 = hk.scan_level(hist, fok, lay=lay, **kw)
    planes, cap = hk.scan_planes(hist, fok, lay=lay, **kw)
    ref = hk.scan_planes_reference(hist, fok, lay, cap=cap, **kw)
    plain = tt.scan_of(K)(hist, fok, tt.scan_layout(lay, hist.device),
                          impurity, 5, 0.0)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(out, out2)),
          f"{tag}: two kernel launches differ")
    check(ps.widths == ([wide] if wide else []),
          f"{tag}: the plain scan ran on widths {ps.widths}")
    check(torch.equal(planes[1], ref[1]), f"{tag}: rank differs")
    gain_tol = 1e-6 if impurity == "entropy" else 0.0
    pairs = [("gain", ref[0], planes[0], gain_tol),
             ("best_gain", plain[5], out[5], gain_tol)]
    if exact:
        pairs += [("lcnt", ref[2], planes[2], 0.0),
                  ("tot0", ref[3], planes[3], 0.0)]
        pairs += [(nm, a, b, 0.0) for nm, a, b in zip(SPLIT_FIELDS, plain, out)
                  if nm != "best_gain"]
    else:
        pairs = [(nm, a, b, 1e-5) for nm, a, b, _t in pairs]
        pairs += [("lcnt", ref[2], planes[2], 1e-5),
                  ("tot0", ref[3], planes[3], 1e-5)]
        top2 = torch.topk(ref[0], min(2, ref[0].shape[1]), dim=1).values
        clear = (top2[:, 0] - top2[:, -1]) > 1e-5 * top2[:, 0].abs()
        for i in (0, 1):
            check(torch.equal(out[i][clear], plain[i][clear]),
                  f"{tag}: {SPLIT_FIELDS[i]} differs at a clear best gain")
    e = 0.0
    for nm, a, b, tol in pairs:
        fin = torch.isfinite(a) if a.is_floating_point() else None
        if fin is None or not tol:
            check(torch.equal(a, b), f"{tag}: {nm} differs")
        else:
            check(torch.equal(fin, torch.isfinite(b))
                  and torch.allclose(b[fin], a[fin], rtol=tol, atol=0),
                  f"{tag}: {nm} beyond rtol {tol}")
        if nm in ("gain", "best_gain"):
            e = max(e, stats.err(entry, torch.where(fin, a, 0),
                                 torch.where(fin, b, 0)))
    case = dict(case=tag, entry=entry, K=K, L=int(hist.shape[1]), T=lay.T,
                impurity=impurity, seg_cap=cap, exact_planes=exact,
                max_abs_err=e, splits=int(out[4].sum()))
    if timed:
        sl = tt.scan_layout(lay, hist.device)
        P = hist.shape[0]
        from shifu_tpu_torch.ops import hist_bounds as hb

        bound, by = hb.bound_ms(*hb.scan_counts(P, hist.shape[1], lay, K))
        case.update(
            ms=time_ms(torch, lambda: hk.scan_level(hist, fok, lay=lay, **kw)),
            plain_ms=time_ms(torch, lambda: tt.scan_of(K)(
                hist, fok, sl, impurity, 5, 0.0)),
            library_ms=None, bound_ms=bound, bound_by=by,
            **device_split_ms(torch, lambda: hk.scan_level(
                hist, fok, lay=lay, **kw), once="hist_scan_kernel"))
    stats.cases.append(case)
    print(f"  {tag}: ok ({case['splits']} of {case['L']} nodes split, max "
          f"abs gain err {e:.3g}"
          + (f", entry {case['ms']:.4f} ms, plain torch scan "
             f"{case['plain_ms']:.4f} ms, bound {case['bound_ms']:.4f} ms"
             + _split(case) if timed else "") + ")")
    return case


def phase_scan(torch, dev, hk, tt, stats, gbt_codes_np, rf_data, seed):
    """The scan-only entry at the main path's shapes: the derived
    siblings of bench `gbt` (bf16 planes) and `rf`, the whole L = 128
    level of bench `rf` and of NATIVE RF (K = 5), K = 3/5/8/32 class
    planes, node totals past 2^24, and a bench `gbt_wide` level whose
    2,001-slot column passes the cap."""
    g_lay = tt.make_layout([GBT["bins"] + 1] * GBT["f"], [False] * GBT["f"])
    g_codes = torch.as_tensor(gbt_codes_np).to(dev)
    g8 = hk.codes8_of(g_codes, g_lay)
    g_fok = torch.ones(g_lay.T, dtype=torch.bool, device=dev)
    for Lh in (1, 16):
        h = scan_hist(torch, hk, tt, dev, gbt_codes_np, g_codes, g8, g_lay,
                      Lh, 0, seed + Lh, lowp=True)
        check_scan(torch, hk, tt, stats, f"gbt L={Lh} derived bf16", g_lay,
                   h, g_fok, 0, "variance", False, timed=True)
    del g_codes, g8

    r_codes_np, r_slots, r_cat = rf_data
    lay = tt.make_layout(r_slots, r_cat)
    codes = torch.as_tensor(r_codes_np).to(dev)
    c8 = hk.codes8_of(codes, lay)
    fok = torch.ones(lay.T, dtype=torch.bool, device=dev)
    fok[: int(lay.off[10])] = False  # a tree's feature subset
    mk = lambda L, K, sd, **kw: scan_hist(  # noqa: E731
        torch, hk, tt, dev, r_codes_np, codes, c8, lay, L, K, sd, **kw)
    for L, derived in ((32, True), (128, False)):
        c = check_scan(torch, hk, tt, stats,
                       f"rf L={L} {'derived' if derived else 'level'}", lay,
                       mk(L, 0, seed + L, derived=derived), fok, 0,
                       "variance", True, timed=True)
        if L == 32:
            stats.timed["scan_level"] = c
    for K, L, derived, imp in ((5, 32, True, "gini"), (5, 128, False, "gini"),
                               (5, 32, True, "entropy"),
                               (3, 32, True, "gini"), (8, 32, True, "gini"),
                               (32, 64, True, "gini")):
        c = check_scan(torch, hk, tt, stats,
                       f"rf K={K} L={L} {'derived' if derived else 'level'} "
                       f"{imp}", lay, mk(L, K, seed + L + K, derived=derived),
                       fok, K, imp, True, timed=imp == "gini")
        if (K, L) == (MC_MAIN_K, 32) and imp == "gini":
            stats.timed_mc[("scan_level_mc", K)] = c
    for K in (0, 5):
        h = mk(16, K, seed + 24 + K, w_scale=3_000_000)
        cnt = tt.class_sum(h) if K else h[0]
        check(float(cnt[:, : int(lay.slots[0])].sum(1).max()) > 2 ** 24,
              "the heavy case's node totals stay below 2^24")
        check_scan(torch, hk, tt, stats, f"rf K={K} L=16 derived, node "
                   "totals past 2^24", lay, h, fok, K,
                   "gini" if K else "variance", True)
    del codes, c8

    w_codes_np, w_slots, w_cat = wide_data(seed)
    w_lay = tt.make_layout(w_slots, w_cat)
    w_codes = torch.as_tensor(w_codes_np).to(dev)
    h = scan_hist(torch, hk, tt, dev, w_codes_np, w_codes, None, w_lay, 16,
                  0, seed + 16)
    check_scan(torch, hk, tt, stats, "gbt_wide L=16 derived", w_lay, h,
               torch.ones(w_lay.T, dtype=torch.bool, device=dev), 0,
               "variance", True, wide=max(w_slots))
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# phases 3-4: the main path
# ---------------------------------------------------------------------------


def gbt_data(seed: int):
    """bench.py bench_gbt / _bench_trees data: codes in [0, 32), labels
    from the first two columns plus noise."""
    n, F, bins = GBT["n"], GBT["f"], GBT["bins"]
    codes = np.random.default_rng(seed).integers(
        0, bins, size=(n, F)).astype(np.int32)
    rng = np.random.default_rng(seed)
    y = (codes[:, 0].astype(np.int64) + codes[:, 1]
         + rng.integers(0, 32, size=n) > 48).astype(np.float32)
    return codes, y, [bins + 1] * F, [False] * F


def rf_data(seed: int):
    """bench.py bench_rf data: 20 numeric + 10 categorical columns."""
    slots = [33] * RF["numeric"] + [65] * RF["cat65"]
    is_cat = [False] * RF["numeric"] + [True] * RF["cat65"]
    rng = np.random.default_rng(seed)
    codes = np.stack([rng.integers(0, s - 1, size=RF["n"]) for s in slots],
                     1).astype(np.int32)
    y = ((codes[:, 0] >= 16) | (codes[:, RF["numeric"]] >= 32)
         ).astype(np.float32)
    return codes, y, slots, is_cat


def forests_equal(a, b) -> bool:
    """Bit for bit, explicit child pointers included."""
    if len(a.trees) != len(b.trees):
        return False

    def same(p, q):
        return (p is None and q is None) or (
            p is not None and q is not None and np.array_equal(p, q))

    return all(np.array_equal(x.feature, y.feature)
               and np.array_equal(x.left_mask, y.left_mask)
               and np.array_equal(x.leaf_value, y.leaf_value)
               and same(x.left, y.left) and same(x.right, y.right)
               and x.weight == y.weight for x, y in zip(a.trees, b.trees))


def print_profile(rep: dict) -> None:
    p = rep["profile"]
    if p["device_busy_s"] is None:
        print("  profile: no device time recorded, not measured")
        return
    print(f"  profile: device busy {p['device_busy_s']:.4f} s of "
          f"{rep['seconds_second']:.4f} s, idle share {p['idle_share']:.3f};"
          " top kernels (ms): " + ", ".join(f"{k[:40]} {v:.2f}"
                                             for k, v in p["top_kernels"][:5]))
    print("  profile: the port's kernels in the run: " + ", ".join(
        f"{k} {v['ms']:.4f} ms in {v['launches']} launches"
        for k, v in p["hist_kernels"].items()))


# scan_level(_mc) launches of each main-path run: one a tree for every
# subtraction level (the derived sibling; past 32 nodes the whole level)
SCAN_LAUNCHES = {"gbt": 25, "rf": 70, "native": 70, "ova": 75,
                 "prep": 70}


def check_scans(name, launches, plain_widths):
    """Every split scan of a main-path run went through the kernels: the
    scan entry's launches as the level plan gives them, and no plain
    torch scan on the card (no column of these layouts passes the
    cap)."""
    got = launches["scan_level"] + launches["scan_level_mc"]
    check(got == SCAN_LAUNCHES[name],
          f"{name}: {got} scan_level launches, expected "
          f"{SCAN_LAUNCHES[name]}: {launches}")
    check(not plain_widths,
          f"{name}: the plain torch scan ran on the card: {plain_widths}")


def train_on_card(torch, hk, tt, args_, cfg):
    """One counted main-path run: counts zeroed just before, read just
    after."""
    hk.reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with PlainScans(tt) as ps:
        res = tt.train_trees(*args_, cfg, device="cuda")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return (res, secs, dict(hk.launches), dict(hk.reference_calls),
            ps.widths)


def phase_main(torch, hk, tt, pds, ptree, name, data, cfg, data_dir):
    """CleanedData -> train_trees on cuda (twice) -> model file -> scores;
    the same run on the CPU. Returns (report, launches)."""
    codes, y, slots, is_cat = data
    n, F = codes.shape
    cols = [f"f{i}" for i in range(F)]
    out = os.path.join(data_dir, name)
    pds.write_codes(out, codes, y.astype(np.int8), np.ones(n, np.float32),
                    cols, slots, n_shards=4)
    meta, c16, tags, wts = pds.load_codes(out)
    check(meta.extra["slots"] == slots and c16.shape == (n, F),
          f"{name}: CleanedData round trip")
    args_ = (c16, tags, wts, meta.extra["slots"], is_cat, meta.columns)

    res, secs, launches, refs, plain = train_on_card(torch, hk, tt, args_,
                                                     cfg)
    check(all(v == 0 for v in refs.values()),
          f"{name}: the run on the card reached a plain version: {refs}")
    check(launches["fused_level"] > 0,
          f"{name}: fused kernel never launched: {launches}")
    check_scans(name, launches, plain)
    res2, secs2, _l2, _r2, _p2 = train_on_card(torch, hk, tt, args_, cfg)
    check(forests_equal(res.spec, res2.spec),
          f"{name}: a second run on the card gave another forest")
    MEMORY_FORESTS[name] = res.spec

    prof = profile_run(torch, lambda: tt.train_trees(*args_, cfg,
                                                     device="cuda"), secs2)

    path = os.path.join(out, f"model0.{name[:3]}")
    res.spec.save(path)
    spec = ptree.TreeModelSpec.load(path)
    spec.save(path + ".again")
    with open(path, "rb") as a, open(path + ".again", "rb") as b:
        check(a.read() == b.read(), f"{name}: model file does not round-trip")
    scores = ptree.IndependentTreeModel(spec, device="cuda").compute(c16)
    check(scores.shape == (n,) and np.isfinite(scores).all()
          and (scores >= 0).all() and (scores <= 1).all(),
          f"{name}: scores not finite in [0, 1]")

    t0 = time.perf_counter()
    cpu = tt.train_trees(*args_, cfg, device="cpu")
    cpu_secs = time.perf_counter() - t0
    cpu_scores = ptree.IndependentTreeModel(cpu.spec,
                                            device="cpu").compute(c16)
    diff = float(np.abs(scores - cpu_scores).max())
    rep = dict(rows=n, trees=len(res.spec.trees), depth=cfg.max_depth,
               seconds_first=secs, seconds_second=secs2,
               trees_per_s=len(res.spec.trees) / secs2,
               row_trees_per_s=n * len(res.spec.trees) / secs2,
               valid_error=res.valid_error, cpu_valid_error=cpu.valid_error,
               cpu_seconds=cpu_secs, max_score_diff_vs_cpu=diff,
               forest_bit_equal_to_cpu=forests_equal(res.spec, cpu.spec),
               launches=launches, profile=prof)
    return rep


# ---------------------------------------------------------------------------
# phases 5-6: `shifu train` on a model set
# ---------------------------------------------------------------------------

NATIVE = dict(classes=5, trees=10, depth=8)
OVA = dict(n=100_000, classes=3, trees=5, depth=6)


def write_model_set(root, codes, cls, slots, is_cat, n_classes, alg,
                    method, params):
    """A model set the port's train step reads, written with the port's
    own config and CleanedData modules: ModelConfig.json (posTags = the
    class tags, negTags empty: classification), ColumnConfig.json (the
    target, then one selected column a feature with its bin boundaries
    or categories), tmp/norm/CleanedData."""
    from shifu_tpu_torch.config import (ColumnBinning, ColumnConfig,
                                        ColumnFlag, ColumnType,
                                        save_column_config_list)
    from shifu_tpu_torch.config.model_config import (Algorithm,
                                                     MultipleClassification,
                                                     new_model_config)
    from shifu_tpu_torch.fs.pathfinder import PathFinder
    from shifu_tpu_torch.norm.dataset import write_codes

    paths = PathFinder(root)
    os.makedirs(root, exist_ok=True)
    mc = new_model_config("Smoke", Algorithm.parse(alg))
    mc.data_set.data_path = "data"
    mc.data_set.target_column_name = "class"
    mc.data_set.pos_tags = [f"c{k}" for k in range(n_classes)]
    mc.data_set.neg_tags = []
    mc.train.multi_classify_method = MultipleClassification.parse(method)
    mc.train.params.update(params)
    mc.save(paths.model_config_path())
    columns = [ColumnConfig(column_num=0, column_name="class",
                            column_type=ColumnType.C,
                            column_flag=ColumnFlag.TARGET)]
    names = []
    for f, (sl, cat) in enumerate(zip(slots, is_cat)):
        name = f"{'cat' if cat else 'num'}_{f}"
        names.append(name)
        binning = (ColumnBinning(length=sl - 1, bin_category=[
            f"v{j}" for j in range(sl - 1)]) if cat else
            ColumnBinning(length=sl - 1, bin_boundary=[-float("inf")] + [
                float(j) for j in range(1, sl - 1)]))
        columns.append(ColumnConfig(
            column_num=f + 1, column_name=name,
            column_type=ColumnType.C if cat else ColumnType.N,
            final_select=True, column_binning=binning))
    save_column_config_list(paths.column_config_path(), columns)
    n = codes.shape[0]
    write_codes(paths.cleaned_data_dir(), codes, cls.astype(np.int8),
                np.ones(n, np.float32), names, slots, n_shards=4)
    return paths


def _model_bytes(paths, n_models, suffix):
    out = []
    for i in range(n_models):
        with open(paths.model_path(i, suffix), "rb") as fh:
            out.append(fh.read())
    return out


def run_step(torch, hk, tt, TrainProcessor, root, device):
    """One `shifu train` run: counts zeroed just before, read just after;
    on the card also the widths the plain torch scan ran on."""
    hk.reset_counters()
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    with PlainScans(tt) as ps:
        rc = TrainProcessor(root, device=device).run()
    if device == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    check(rc == 0, f"{root}: train step returned {rc}")
    return secs, dict(hk.launches), dict(hk.reference_calls), ps.widths


def phase_native(torch, hk, tt, ptree, data_dir, rf_data, seed):
    """`shifu train` NATIVE RF at the bench `rf` width: the main path."""
    from shifu_tpu_torch.processor.train import TrainProcessor

    codes, _y, slots, is_cat = rf_data
    n, K = codes.shape[0], NATIVE["classes"]
    rng = np.random.default_rng(seed + 5)
    cls = ((codes[:, 0] // 7 + (codes[:, RF["numeric"]] >= 32)
            + (codes[:, 3] >= 20)) % K)
    noise = rng.random(n) < 0.1
    cls = np.where(noise, rng.integers(0, K, size=n), cls)
    params = {"TreeNum": NATIVE["trees"], "MaxDepth": NATIVE["depth"],
              "FeatureSubsetStrategy": "TWOTHIRDS", "Impurity": "gini"}
    root = os.path.join(data_dir, "native")
    paths = write_model_set(root, codes, cls, slots, is_cat, K, "RF",
                            "NATIVE", params)

    secs, launches, refs, plain = run_step(torch, hk, tt, TrainProcessor,
                                           root, "cuda")
    check(all(v == 0 for v in refs.values()),
          f"native: the run on the card reached a plain version: {refs}")
    check(launches["fused_level_mc"] > 0 and launches["hist_level_mc"] > 0,
          f"native: a multi-class entry never launched: {launches}")
    check_scans("native", launches, plain)
    first = _model_bytes(paths, 1, "rf")
    MEMORY_FORESTS["native"] = root
    secs2, launches2, _r, _p = run_step(torch, hk, tt, TrainProcessor, root,
                                        "cuda")
    check(_model_bytes(paths, 1, "rf") == first,
          "native: a second run on the card wrote another model file")
    prof = profile_run(torch, lambda: TrainProcessor(root, device="cuda")
                       .run(), secs2)

    path = paths.model_path(0, "rf")
    spec = ptree.TreeModelSpec.load(path)
    spec.save(path + ".again")
    with open(path + ".again", "rb") as fh:
        check(fh.read() == first[0], "native: model file does not round-trip")
    check(spec.n_classes == K and len(spec.trees) == NATIVE["trees"],
          "native: the model is not a K-class forest of TreeNum trees")
    votes = ptree.IndependentTreeModel(spec, device="cuda").compute(codes)
    check(votes.shape == (n, K) and np.isfinite(votes).all()
          and np.allclose(votes.sum(1), 1.0, rtol=0, atol=1e-6),
          "native: votes are not [n, K] rows summing to 1")

    cpu_root = os.path.join(data_dir, "native-cpu")
    shutil.copytree(root, cpu_root, ignore=shutil.ignore_patterns(
        "models", "train"))
    cpu_secs, _l, _r, _p = run_step(torch, hk, tt, TrainProcessor, cpu_root,
                                    "cpu")
    cpu_bytes = _model_bytes(type(paths)(cpu_root), 1, "rf")
    check(cpu_bytes == first,
          "native: the CPU run's model file differs from the card's")
    acc = float((votes.argmax(1) == cls).mean())
    return dict(rows=n, classes=K, trees=NATIVE["trees"],
                depth=NATIVE["depth"], seconds_first=secs,
                seconds_second=secs2,
                trees_per_s=NATIVE["trees"] / secs2,
                row_trees_per_s=n * NATIVE["trees"] / secs2,
                valid_error=spec.valid_error, train_error=spec.train_error,
                vote_accuracy_all_rows=acc, cpu_seconds=cpu_secs,
                model_bytes=len(first[0]), launches=launches,
                launches_second=launches2, profile=prof)


def phase_ova(torch, hk, tt, ptree, data_dir, gbt_data_, seed):
    """`shifu train` ONEVSALL GBT: one binary forest per class."""
    from shifu_tpu_torch.processor.train import TrainProcessor

    codes_all, _y, slots, is_cat = gbt_data_
    n, K = OVA["n"], OVA["classes"]
    codes = np.ascontiguousarray(codes_all[:n])
    rng = np.random.default_rng(seed + 6)
    cls = np.minimum((codes[:, 0].astype(np.int64) + codes[:, 1]
                      + rng.integers(0, 8, size=n)) // 24, K - 1)
    params = {"TreeNum": OVA["trees"], "MaxDepth": OVA["depth"],
              "LearningRate": 0.1}
    root = os.path.join(data_dir, "ova")
    paths = write_model_set(root, codes, cls, slots, is_cat, K, "GBT",
                            "ONEVSALL", params)
    secs, launches, refs, plain = run_step(torch, hk, tt, TrainProcessor,
                                           root, "cuda")
    check(all(v == 0 for v in refs.values()),
          f"ova: the run on the card reached a plain version: {refs}")
    check(launches["fused_level"] > 0, f"ova: no fused launch: {launches}")
    check_scans("ova", launches, plain)
    first = _model_bytes(paths, K, "gbt")
    secs2, _l2, _r2, _p2 = run_step(torch, hk, tt, TrainProcessor, root,
                                    "cuda")
    check(_model_bytes(paths, K, "gbt") == first,
          "ova: a second run on the card wrote other model files")
    cpu_root = os.path.join(data_dir, "ova-cpu")
    shutil.copytree(root, cpu_root, ignore=shutil.ignore_patterns(
        "models", "train"))
    run_step(torch, hk, tt, TrainProcessor, cpu_root, "cpu")
    diffs = []
    for k in range(K):
        card = ptree.IndependentTreeModel.load(paths.model_path(k, "gbt"),
                                               device="cuda").compute(codes)
        cpu = ptree.IndependentTreeModel.load(
            os.path.join(cpu_root, "models", f"model{k}.gbt"),
            device="cpu").compute(codes)
        diffs.append(float(np.abs(card - cpu).max()))
    check(max(diffs) <= GBT_SCORE_ATOL,
          f"ova: scores differ from the CPU run by {max(diffs)} > "
          f"{GBT_SCORE_ATOL}")
    return dict(rows=n, classes=K, trees=OVA["trees"], depth=OVA["depth"],
                seconds_first=secs, seconds_second=secs2,
                trees_per_s=K * OVA["trees"] / secs2,
                max_score_diff_vs_cpu=diffs, launches=launches)


# ---------------------------------------------------------------------------
# phase 7: `shifu init` + `shifu stats` from raw text
# ---------------------------------------------------------------------------

# rows of phase 7's raw set: the host-bound phases 7-8, 9(c) and 13(c)
# take most of the run, which must end within its time limit
RAW = dict(n=200_000, numeric=20, cat=10, cat_values=64, units=12,
           missing=0.02)
RAW_TOL = dict(rtol=1e-6, atol=1e-6)  # mean, stdDev, correlation: card/CPU


def write_raw_set(root, seed, n=RAW["n"]):
    """A model set of raw pipe-delimited text at the bench `rf` width:
    a 0/1 target, a weight column of f32 values in [0.5, 2) printed
    exactly (k / 256), 20 numeric columns printed %.5f with 2% missing
    tokens ("" or "?"), 10 categorical columns of up to 64 tokens, and a
    12-value unit column (meta, the -psi unit). ModelConfig.json is
    written with the port's own config module."""
    from shifu_tpu_torch.config.model_config import (Algorithm,
                                                     new_model_config)
    from shifu_tpu_torch.fs.pathfinder import PathFinder

    rng = np.random.default_rng(seed + 7)
    y = rng.random(n) < 0.3
    names = ["label", "wt"]
    cols = [np.where(y, "1", "0").tolist(),
            list(map("%.8f".__mod__, (rng.integers(128, 512, size=n)
                                       / 256.0).tolist()))]
    for j in range(RAW["numeric"]):
        x = rng.normal(loc=y * (0.5 + 0.1 * j) * (j % 3 == 0), scale=1 + j)
        col = list(map("%.5f".__mod__, x.tolist()))
        for i in np.flatnonzero(rng.random(n) < RAW["missing"]).tolist():
            col[i] = "" if j % 2 else "?"
        names.append(f"num_{j}")
        cols.append(col)
    for j in range(RAW["cat"]):
        k = RAW["cat_values"] - 3 * j
        codes = np.minimum(rng.geometric(4.0 / k, size=n) - 1
                           + y * (j % 4), k - 1)
        names.append(f"cat_{j}")
        cols.append([f"c{j}_{c}" for c in codes.tolist()])
    names.append("unit")
    cols.append([f"u{i % RAW['units'] + 1}" for i in range(n)])
    data_dir = os.path.join(root, "data")
    os.makedirs(data_dir, exist_ok=True)
    with open(os.path.join(data_dir, "header.txt"), "w") as fh:
        fh.write("|".join(names) + "\n")
    with open(os.path.join(data_dir, "data.txt"), "w") as fh:
        fh.write("\n".join(map("|".join, zip(*cols))))
        fh.write("\n")
    with open(os.path.join(root, "meta.names"), "w") as fh:
        fh.write("unit\n")
    mc = new_model_config("RawSmoke", Algorithm.parse("RF"))
    ds = mc.data_set
    ds.data_path, ds.header_path = "data/data.txt", "data/header.txt"
    ds.target_column_name, ds.pos_tags, ds.neg_tags = "label", ["1"], ["0"]
    ds.weight_column_name, ds.meta_column_name_file = "wt", "meta.names"
    mc.stats.psi_column_name = "unit"
    mc.save(PathFinder(root).model_config_path())
    return os.path.getsize(os.path.join(data_dir, "data.txt"))


def stats_step(torch, root, device):
    """`shifu stats -correlation -psi` on `root`: its stage split."""
    from shifu_tpu_torch.processor.stats import StatsProcessor

    proc = StatsProcessor(root, correlation=True, psi=True, device=device)
    rc = proc.run()
    if device == "cuda":
        torch.cuda.synchronize()
    check(rc == 0, f"{root}: stats returned non-zero")
    return dict(proc.timings)


def artifacts(root):
    """The bytes of ColumnConfig.json, the autotype JSON and the
    correlation CSV of `root`."""
    from shifu_tpu_torch.fs.pathfinder import PathFinder

    paths = PathFinder(root)
    out = {}
    for key, path in (("columns", paths.column_config_path()),
                      ("autotype", paths.autotype_path()),
                      ("correlation", paths.correlation_path())):
        with open(path, "rb") as fh:
            out[key] = fh.read()
    return out


def init_stats(torch, root, device):
    """`shifu init` then `shifu stats -correlation -psi` on `root`: the
    seconds of each, the stats step's stage split, the artifacts' bytes."""
    from shifu_tpu_torch.processor.init import InitProcessor

    t0 = time.perf_counter()
    check(InitProcessor(root, device=device).run() == 0,
          f"{root}: init returned non-zero")
    t1 = time.perf_counter()
    split = stats_step(torch, root, device)
    t2 = time.perf_counter()
    return t1 - t0, t2 - t1, split, artifacts(root)


def _close_but(a, b, keys, path=""):
    """The first place two JSON values differ: exactly, but for the
    floats under `keys`, which must agree within RAW_TOL. None if none."""
    if isinstance(a, dict):
        if a.keys() != b.keys():
            return path
        for k in a:
            bad = _close_but(a[k], b[k], keys, f"{path}.{k}")
            if bad:
                return bad
        return None
    if isinstance(a, list):
        if len(a) != len(b):
            return path
        for i, (x, y) in enumerate(zip(a, b)):
            bad = _close_but(x, y, keys, f"{path}[{i}]")
            if bad:
                return bad
        return None
    if path.rsplit(".", 1)[-1] in keys and isinstance(a, float) \
            and isinstance(b, float):
        return None if np.isclose(b, a, **RAW_TOL) else path
    return None if a == b else path


def _corr_values(blob):
    lines = blob.decode().splitlines()
    return lines[0], np.array([[float(v) for v in ln.split(",")[1:]]
                               for ln in lines[1:]])


def phase_raw(torch, data_dir, seed):
    """init + stats from raw text, in this process: two card runs (the
    second gives the times), a stats run of the first run's model set
    under the profiler (its device busy against the second run's stats
    wall; it must rewrite the same bytes), then the CPU run."""
    base = os.path.join(data_dir, "raw")
    t0 = time.perf_counter()
    size = write_raw_set(base, seed)
    write_s = time.perf_counter() - t0
    roots = {}
    for name in ("card1", "card2", "cpu"):
        roots[name] = os.path.join(data_dir, f"raw-{name}")
        shutil.copytree(base, roots[name])
    runs = {name: init_stats(torch, roots[name], "cuda")
            for name in ("card1", "card2")}
    prof = profile_run(torch, lambda: stats_step(torch, roots["card1"],
                                                 "cuda"), runs["card2"][1])
    check(artifacts(roots["card1"]) == runs["card1"][3],
          "raw: the profiled stats run rewrote other bytes")
    runs["cpu"] = init_stats(torch, roots["cpu"], "cpu")
    n = RAW["n"]
    a, b, c = runs["card1"][3], runs["card2"][3], runs["cpu"][3]
    for key in a:
        check(a[key] == b[key],
              f"raw: two card runs wrote different {key} bytes")
    check(a["autotype"] == c["autotype"],
          "raw: the CPU run wrote another autotype JSON")
    bad = _close_but(json.loads(c["columns"]), json.loads(a["columns"]),
                     ("mean", "stdDev"))
    check(bad is None, f"raw: card and CPU ColumnConfig.json differ at {bad}")
    (ha, ca), (hc, cc) = _corr_values(a["correlation"]), _corr_values(
        c["correlation"])
    check(ha == hc and ca.shape == cc.shape
          and np.allclose(ca, cc, **RAW_TOL),
          "raw: card and CPU correlation differ past "
          f"rtol {RAW_TOL['rtol']} atol {RAW_TOL['atol']}")
    cols = {x["columnName"]: x for x in json.loads(a["columns"])}
    auto = json.loads(a["autotype"])
    for j in range(RAW["numeric"]):
        x = cols[f"num_{j}"]
        check(x["columnType"] == "N" and auto[f"num_{j}"]["distinctCount"]
              > 4096 and len(x["columnBinning"]["binBoundary"]) > 1
              and np.isfinite(x["columnStats"]["ks"])
              and x["columnStats"]["missingCount"] > 0,
              f"raw: num_{j} is not a binned numeric column")
    for j in range(RAW["cat"]):
        x = cols[f"cat_{j}"]
        check(x["columnType"] == "C" and 0 < len(
            x["columnBinning"]["binCategory"]) <= RAW["cat_values"]
            and len(x["columnStats"]["unitStats"]) == RAW["units"],
            f"raw: cat_{j} is not a binned categorical column with PSI")
    check(ca.shape == (RAW["numeric"] + RAW["cat"],) * 2
          and np.allclose(np.diag(ca), 1.0, atol=2e-6)
          and np.isfinite(ca).all(), "raw: correlation matrix malformed")
    init_s, stats_s, split, _ = runs["card2"]
    return dict(rows=n, file_bytes=size, write_seconds=write_s,
                init_seconds=init_s, stats_seconds=stats_s,
                seconds_second=stats_s,
                init_rows_per_s=n / init_s, stats_rows_per_s=n / stats_s,
                stats_split=split,
                card1_seconds=runs["card1"][:2], cpu_seconds=runs["cpu"][:2],
                cpu_stats_split=runs["cpu"][2], profile=prof)


# ---------------------------------------------------------------------------
# phase 8: the prep chain norm -> varsel -> norm -> train
# ---------------------------------------------------------------------------

PREP = dict(filter_num=20, corr=0.9, trees=RF["trees"], depth=RF["depth"])


def prep_config(root):
    """varSelect KS, 20 of the 30 candidates, the auto-filter with
    correlationThreshold 0.9; train: the bench `rf` forest (10 trees,
    depth 8, TWOTHIRDS). Written with the port's config module."""
    from shifu_tpu_torch.config.model_config import ModelConfig
    from shifu_tpu_torch.fs.pathfinder import PathFinder

    path = PathFinder(root).model_config_path()
    mc = ModelConfig.load(path)
    vs = mc.var_select
    vs.filter_by, vs.filter_num = "KS", PREP["filter_num"]
    vs.force_enable, vs.correlation_threshold = True, PREP["corr"]
    mc.train.params.update(TreeNum=PREP["trees"], MaxDepth=PREP["depth"],
                           FeatureSubsetStrategy="TWOTHIRDS")
    mc.save(path)


def norm_step(torch, root, device):
    """`shifu norm` on `root`: its seconds and its stage split."""
    from shifu_tpu_torch.processor.norm import NormProcessor

    proc = NormProcessor(root, device=device)
    t0 = time.perf_counter()
    rc = proc.run()
    if device == "cuda":
        torch.cuda.synchronize()
    check(rc == 0, f"{root}: norm returned non-zero")
    return time.perf_counter() - t0, dict(proc.timings)


def prep_artifacts(root):
    """The bytes of NormalizedData, CleanedData, ColumnConfig.json and
    models/model0.rf of `root`, by path."""
    from shifu_tpu_torch.fs.pathfinder import PathFinder

    paths = PathFinder(root)
    out = {}
    for d in (paths.normalized_data_dir(), paths.cleaned_data_dir()):
        for name in sorted(os.listdir(d)):
            with open(os.path.join(d, name), "rb") as fh:
                out[os.path.relpath(os.path.join(d, name), root)] = fh.read()
    for path in (paths.column_config_path(), paths.model_path(0, "rf")):
        with open(path, "rb") as fh:
            out[os.path.relpath(path, root)] = fh.read()
    return out


def prep_chain(torch, hk, tt, root, device):
    """norm -> varsel -> norm -> train on `root`; the train step counted
    as a main-path run (counts zeroed just before, read just after)."""
    from shifu_tpu_torch.fs.pathfinder import PathFinder
    from shifu_tpu_torch.norm.dataset import read_meta
    from shifu_tpu_torch.processor.train import TrainProcessor
    from shifu_tpu_torch.processor.varsel import VarSelProcessor

    paths = PathFinder(root)
    norm1_s, _ = norm_step(torch, root, device)
    check(len(read_meta(paths.cleaned_data_dir()).columns)
          == RAW["numeric"] + RAW["cat"],
          f"{root}: the first norm did not write every candidate")
    t0 = time.perf_counter()
    check(VarSelProcessor(root, device=device).run() == 0,
          f"{root}: varsel returned non-zero")
    varsel_s = time.perf_counter() - t0
    norm2_s, split = norm_step(torch, root, device)
    check(len(read_meta(paths.cleaned_data_dir()).columns)
          == PREP["filter_num"],
          f"{root}: the second CleanedData does not hold "
          f"{PREP['filter_num']} columns")
    train_s, launches, refs, plain = run_step(torch, hk, tt, TrainProcessor,
                                              root, device)
    return dict(norm1_seconds=norm1_s, varsel_seconds=varsel_s,
                norm_seconds=norm2_s, norm_split=split,
                train_seconds=train_s, launches=launches, refs=refs,
                plain=plain, bytes=prep_artifacts(root))


def phase_prep(torch, hk, tt, ptree, data_dir):
    """Phase 7's card model sets after their stats: the chain twice on
    the card (the second gives the times), a norm run of the first under
    the profiler (it must rewrite the same bytes), and the chain on the
    CPU on a copy of the first card set taken after stats."""
    from shifu_tpu_torch.fs.pathfinder import PathFinder
    from shifu_tpu_torch.norm.dataset import load_codes

    roots = {name: os.path.join(data_dir, f"raw-{name}")
             for name in ("card1", "card2")}
    roots["cpu"] = os.path.join(data_dir, "prep-cpu")
    shutil.copytree(roots["card1"], roots["cpu"])
    for root in roots.values():
        prep_config(root)
    runs = {name: prep_chain(torch, hk, tt, roots[name], "cuda")
            for name in ("card1", "card2")}
    for name, run_ in runs.items():
        check(all(v == 0 for v in run_["refs"].values()),
              f"prep {name}: the train on the card reached a plain version: "
              f"{run_['refs']}")
        check(run_["launches"]["fused_level"] > 0
              and run_["launches"]["hist_level"] > 0,
              f"prep {name}: a kernel entry never launched: "
              f"{run_['launches']}")
        check_scans("prep", run_["launches"], run_["plain"])
    second = runs["card2"]
    prof = profile_run(torch, lambda: norm_step(torch, roots["card1"],
                                                "cuda"),
                       second["norm_seconds"])
    check(prep_artifacts(roots["card1"]) == runs["card1"]["bytes"],
          "prep: the profiled norm run rewrote other bytes")
    runs["cpu"] = prep_chain(torch, hk, tt, roots["cpu"], "cpu")
    a = runs["card1"]["bytes"]
    model = os.path.relpath(PathFinder(roots["card1"]).model_path(0, "rf"),
                            roots["card1"])
    for name in ("card2", "cpu"):
        b = runs[name]["bytes"]
        check(sorted(a) == sorted(b), f"prep {name}: other files: "
              f"{sorted(set(a) ^ set(b))}")
        for key in sorted(a, key=lambda k: k == model):
            check(a[key] == b[key] or (name, key) == ("cpu", model),
                  f"prep: card1 and {name} wrote different bytes in {key}")
    # the weight column's k/256 weights sum past 2^24 units: the card's
    # fixed point is exact, the CPU's plain version sums in f32, so the
    # CPU forest is held like GBT's, by its scores
    paths = PathFinder(roots["card2"])
    _meta, codes, tags, _w = load_codes(paths.cleaned_data_dir())
    spec = ptree.TreeModelSpec.load(paths.model_path(0, "rf"))
    scores = ptree.IndependentTreeModel(spec, device="cuda").compute(codes)
    check(len(spec.trees) == PREP["trees"] and scores.shape == (len(tags),)
          and np.isfinite(scores).all() and (scores >= 0).all()
          and (scores <= 1).all(), "prep: the forest's scores are not "
          "finite in [0, 1]")
    cpu_spec = ptree.TreeModelSpec.load(
        PathFinder(roots["cpu"]).model_path(0, "rf"))
    cpu_scores = ptree.IndependentTreeModel(cpu_spec,
                                            device="cpu").compute(codes)
    diff = float(np.abs(scores - cpu_scores).max())
    same_splits = sum(
        np.array_equal(x.feature, y.feature)
        and np.array_equal(x.left_mask, y.left_mask)
        for x, y in zip(spec.trees, cpu_spec.trees))
    check(diff <= GBT_SCORE_ATOL, f"prep: the CPU forest's scores differ "
          f"from the card's by {diff} > {GBT_SCORE_ATOL}")
    n = RAW["n"]
    return dict(rows=n, columns_after_varsel=PREP["filter_num"],
                trees=PREP["trees"], depth=PREP["depth"],
                norm_seconds=second["norm_seconds"],
                norm_rows_per_s=n / second["norm_seconds"],
                norm_split=second["norm_split"],
                first_norm_seconds=second["norm1_seconds"],
                varsel_seconds=second["varsel_seconds"],
                seconds_second=second["norm_seconds"],
                train_seconds=second["train_seconds"],
                trees_per_s=PREP["trees"] / second["train_seconds"],
                valid_error=spec.valid_error,
                cpu_model_bit_equal=runs["cpu"]["bytes"][model] == a[model],
                max_score_diff_vs_cpu=diff, trees_same_splits_as_cpu=same_splits,
                card1_seconds={k: v for k, v in runs["card1"].items()
                               if k.endswith("seconds")},
                cpu_seconds={k: v for k, v in runs["cpu"].items()
                             if k.endswith("seconds")},
                launches=runs["card1"]["launches"], profile=prof)


# ---------------------------------------------------------------------------
# phase 9: NN/LR on the card
# ---------------------------------------------------------------------------

# bench.py:63-64 SMALL and DENSE
SMALL = dict(n=1_000_000, d=30, hidden=[50], epochs=50)
DENSE = dict(n=131_072, d=1024, hidden=[2048, 2048], epochs=30)
GRAD_ROWS = 8192  # rows of DENSE's first-epoch gradient check
NN_STEP = dict(hidden=[50], bagging=5, epochs=30, filter_num=10)
NN_TOL = 1e-3  # card vs CPU final valid error
PEAK_TFLOPS = {"bf16": 989.0, "f32": 67.0}  # H100 SXM, dense, 700 W


def mlp_flops_per_row_epoch(d: int, hidden: list) -> float:
    """Training-step matmul FLOPs a row (bench.py:216): forward 2 a MAC,
    backward 4 a MAC, less the first layer's input gradient, which is
    never computed."""
    sizes = [d] + list(hidden) + [1]
    macs = sum(a * b for a, b in zip(sizes[:-1], sizes[1:]))
    return 6.0 * macs - 2.0 * sizes[0] * sizes[1]


def nn_bench_data(spec: dict):
    """bench.py bench_nn's draws (seed 0): x [n, d], 0/1 t, unit w."""
    rng = np.random.default_rng(0)
    n, d = spec["n"], spec["d"]
    x = rng.normal(size=(n, d)).astype(np.float32)
    logits = x[:, 0] * 1.5 - x[:, 1] + 0.5 * x[:, 2] * x[:, 3]
    t = (logits + rng.normal(scale=0.5, size=n) > 0).astype(np.float32)
    return x, t, np.ones(n, dtype=np.float32)


def nn_bench_cfg(nt, spec: dict, bf16: bool):
    """bench.py bench_nn's config: tanh, RPROP, valid 0.1, seed 1."""
    return nt.NNTrainConfig(
        hidden_nodes=list(spec["hidden"]),
        activations=["tanh"] * len(spec["hidden"]),
        propagation="R", num_epochs=spec["epochs"], valid_set_rate=0.1,
        seed=1, mixed_precision=bf16)


def nn_flat_bytes(params) -> bytes:
    from shifu_tpu_torch.models.nn import flatten_params

    return flatten_params(params)[0].tobytes()


def nn_timed(torch, nt, data, cfg, device: str):
    """(seconds, TrainResult) of one train_nn call, synchronized."""
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = nt.train_nn(*data, cfg, device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter() - t0, res


def nn_bench(torch, nt, spec: dict, name: str, dtypes):
    """Two card runs of each dtype (bit-equal weights; the second timed),
    row-epochs/s and TFLOP/s by the bench.py formula, and the profile of
    one more run of the first dtype."""
    host = nn_bench_data(spec)
    dev_data = tuple(torch.as_tensor(a, device="cuda") for a in host)
    row_epochs = spec["n"] * spec["epochs"]
    flops = row_epochs * mlp_flops_per_row_epoch(spec["d"], spec["hidden"])
    out = dict(rows=spec["n"], d=spec["d"], hidden=spec["hidden"],
               epochs=spec["epochs"])
    for dt in dtypes:
        cfg = nn_bench_cfg(nt, spec, dt == "bf16")
        runs = [nn_timed(torch, nt, dev_data, cfg, "cuda") for _ in range(2)]
        check(nn_flat_bytes(runs[0][1].params)
              == nn_flat_bytes(runs[1][1].params),
              f"{name} {dt}: two card runs gave other weights")
        sec, res = runs[1]
        tflops = flops / sec / 1e12
        out[dt] = dict(seconds=sec, first_seconds=runs[0][0],
                       row_epochs_per_s=row_epochs / sec, tflops=tflops,
                       peak_share=tflops / PEAK_TFLOPS[dt],
                       valid_error=res.valid_error,
                       train_error=res.train_error,
                       iterations=res.iterations)
    dt = dtypes[0]
    cfg = nn_bench_cfg(nt, spec, dt == "bf16")
    out["seconds_second"] = out[dt]["seconds"]
    out["profile"] = profile_run(
        torch, lambda: nt.train_nn(*dev_data, cfg, device="cuda"),
        out[dt]["seconds"])
    return out, host


def nn_phase_small(torch, nt):
    """(a) bench SMALL at full width, bf16 then f32; the CPU's f32 run's
    final valid error within NN_TOL of the card's."""
    out, host = nn_bench(torch, nt, SMALL, "small", ("bf16", "f32"))
    sec, cpu = nn_timed(torch, nt, host, nn_bench_cfg(nt, SMALL, False),
                        "cpu")
    out["cpu_seconds"] = sec
    out["cpu_valid_error"] = cpu.valid_error
    for dt in ("f32", "bf16"):
        out[dt]["valid_error_diff_vs_cpu"] = abs(out[dt]["valid_error"]
                                                 - cpu.valid_error)
    check(out["f32"]["valid_error_diff_vs_cpu"] <= NN_TOL,
          f"small: the CPU's valid error {cpu.valid_error} differs from "
          f"the card's {out['f32']['valid_error']} by more than {NN_TOL}")
    return out


def nn_phase_dense(torch, nt):
    """(b) bench DENSE at full width in bf16 (two runs, bit-equal) and
    once in f32; the first epoch's f32 descent gradient on GRAD_ROWS rows
    on the card and on the CPU from the same init."""
    from shifu_tpu_torch.models.nn import flatten_params, init_params

    out, host = nn_bench(torch, nt, DENSE, "dense", ("bf16",))
    cfg = nn_bench_cfg(nt, dict(DENSE, epochs=1), False)
    sec, res = nn_timed(torch, nt, tuple(torch.as_tensor(a, device="cuda")
                                         for a in host),
                        nn_bench_cfg(nt, DENSE, False), "cuda")
    row_epochs = DENSE["n"] * DENSE["epochs"]
    tflops = (row_epochs * mlp_flops_per_row_epoch(DENSE["d"],
                                                   DENSE["hidden"])
              / sec / 1e12)
    out["f32"] = dict(seconds=sec, row_epochs_per_s=row_epochs / sec,
                      tflops=tflops, peak_share=tflops / PEAK_TFLOPS["f32"],
                      valid_error=res.valid_error, runs=1)
    flat, shapes = flatten_params(init_params(
        [DENSE["d"]] + DENSE["hidden"] + [1], seed=cfg.seed))
    sig, _valid = nt.split_and_sample(DENSE["n"], cfg)
    x, t, w = (a[:GRAD_ROWS] for a in host)
    sig = (sig[:GRAD_ROWS] * w)[None]
    grads = {}
    for dev in ("cuda", "cpu"):
        g = nt.descent_gradient(
            cfg, shapes, torch.as_tensor(flat[None], device=dev),
            *(torch.as_tensor(a, device=dev) for a in (x, t, sig)))
        grads[dev] = g.cpu().numpy()[0]
    scale = float(np.abs(grads["cpu"]).max())
    diff = float(np.abs(grads["cuda"] - grads["cpu"]).max())
    out["grad_max_abs"] = scale
    out["grad_max_abs_diff"] = diff
    check(diff <= 1e-4 * scale, f"dense: the card's first-epoch gradient "
          f"differs from the CPU's by {diff} > 1e-4 x {scale}")
    return out


def nn_step_config(root, hidden, bagging, epochs):
    """`shifu train` NN on a prepared model set: tanh, RPROP."""
    from shifu_tpu_torch.config.model_config import Algorithm, ModelConfig
    from shifu_tpu_torch.fs.pathfinder import PathFinder

    path = PathFinder(root).model_config_path()
    mc = ModelConfig.load(path)
    mc.train.algorithm = Algorithm.NN
    mc.train.params = {"NumHiddenNodes": list(hidden),
                       "ActivationFunc": ["tanh"], "Propagation": "R",
                       "LearningRate": 0.1}
    mc.train.bagging_num = bagging
    mc.train.num_train_epochs = epochs
    mc.save(path)


def nn_step(torch, root, device):
    """`shifu train` on `root`: its seconds, the model files' bytes and
    the valid errors of the val-error files."""
    from shifu_tpu_torch.fs.pathfinder import PathFinder
    from shifu_tpu_torch.processor.train import TrainProcessor

    t0 = time.perf_counter()
    check(TrainProcessor(root, device=device).run() == 0,
          f"{root}: NN train returned non-zero")
    if device == "cuda":
        torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    paths = PathFinder(root)
    models = sorted(os.listdir(paths.models_dir()))
    blobs = {}
    for name in models:
        with open(os.path.join(paths.models_dir(), name), "rb") as fh:
            blobs[name] = fh.read()
    errs = []
    for i in range(len(models)):
        with open(paths.val_error_path(i)) as fh:
            errs.append(float(fh.read()))
    return sec, blobs, errs


def varsel_se(torch, root, device, filter_num):
    """`shifu varsel` filterBy SE on `root`: seconds, the selected
    columns, the se.csv rows."""
    from shifu_tpu_torch.config import load_column_config_list
    from shifu_tpu_torch.config.model_config import ModelConfig
    from shifu_tpu_torch.fs.pathfinder import PathFinder
    from shifu_tpu_torch.processor.varsel import VarSelProcessor

    paths = PathFinder(root)
    mc = ModelConfig.load(paths.model_config_path())
    mc.var_select.filter_by, mc.var_select.filter_num = "SE", filter_num
    mc.save(paths.model_config_path())
    t0 = time.perf_counter()
    check(VarSelProcessor(root, device=device).run() == 0,
          f"{root}: varsel SE returned non-zero")
    sec = time.perf_counter() - t0
    cols = load_column_config_list(paths.column_config_path())
    with open(paths.se_report_path()) as fh:
        rows = [ln.strip() for ln in fh][1:]
    return sec, [c.column_name for c in cols if c.final_select], rows


def nn_phase_step(torch, data_dir):
    """(c) `shifu train` NN, bagging 5, on phase 8's selected 200,000-row
    model set: twice on the card (model files byte-identical), once on
    the CPU (valid errors within NN_TOL); (d) varsel SE on the same set,
    card and CPU selecting the same columns."""
    from shifu_tpu_torch.norm.dataset import read_meta
    from shifu_tpu_torch.fs.pathfinder import PathFinder

    roots = {name: os.path.join(data_dir, f"nn-{name}")
             for name in ("card1", "card2", "cpu")}
    for root in roots.values():
        shutil.copytree(os.path.join(data_dir, "raw-card2"), root)
        paths = PathFinder(root)
        # phase 8's RF model and its train files are not this step's
        shutil.rmtree(paths.models_dir())
        shutil.rmtree(paths.train_dir())
        nn_step_config(root, NN_STEP["hidden"], NN_STEP["bagging"],
                       NN_STEP["epochs"])
    runs = {name: nn_step(torch, root, "cpu" if name == "cpu" else "cuda")
            for name, root in roots.items()}
    a = runs["card1"][1]
    check(sorted(a) == [f"model{i}.nn" for i in range(NN_STEP["bagging"])],
          f"nn step: model files {sorted(a)}")
    check(runs["card2"][1] == a, "nn step: two card runs wrote other bytes")
    diffs = [abs(x - y) for x, y in zip(runs["card2"][2], runs["cpu"][2])]
    check(max(diffs) <= NN_TOL, f"nn step: the CPU's valid errors differ "
          f"from the card's by {max(diffs)} > {NN_TOL}")
    rows = read_meta(PathFinder(roots["card2"]).normalized_data_dir()).n_rows
    sec = runs["card2"][0]
    out = dict(rows=rows, columns=PREP["filter_num"],
               hidden=NN_STEP["hidden"], bagging=NN_STEP["bagging"],
               epochs=NN_STEP["epochs"], seconds=sec, rows_per_s=rows / sec,
               member_row_epochs_per_s=(rows * NN_STEP["epochs"]
                                        * NN_STEP["bagging"] / sec),
               first_seconds=runs["card1"][0], cpu_seconds=runs["cpu"][0],
               valid_errors=runs["card2"][2], cpu_valid_errors=runs["cpu"][2],
               max_valid_error_diff_vs_cpu=max(diffs))
    se = {name: varsel_se(torch, roots[name],
                          "cpu" if name == "cpu" else "cuda",
                          NN_STEP["filter_num"])
          for name in ("card1", "cpu")}
    check(se["card1"][1] == se["cpu"][1],
          f"varsel SE: the card selected {se['card1'][1]}, the CPU "
          f"{se['cpu'][1]}")
    check(len(se["card1"][1]) == NN_STEP["filter_num"],
          f"varsel SE selected {len(se['card1'][1])} columns")
    out["varsel_se"] = dict(seconds=se["card1"][0], cpu_seconds=se["cpu"][0],
                            selected=se["card1"][1],
                            se_csv_card=se["card1"][2][:5],
                            se_csv_cpu=se["cpu"][2][:5])
    return out


def phase_nn(torch, data_dir):
    """Phase 9 (a)-(d), each part printed when it has passed."""
    from shifu_tpu_torch.train import nn_trainer as nt

    nn = {}
    nn["small"] = nn_phase_small(torch, nt)
    print_bench("small", nn["small"])
    print(f"nn small: the CPU's f32 run {nn['small']['cpu_seconds']:.2f} s, "
          f"valid error {nn['small']['cpu_valid_error']:.6f} (card f32 diff "
          f"{nn['small']['f32']['valid_error_diff_vs_cpu']:.3g}, bf16 diff "
          f"{nn['small']['bf16']['valid_error_diff_vs_cpu']:.3g})")
    nn["dense"] = d = nn_phase_dense(torch, nt)
    print_bench("dense", d)
    print(f"nn dense: first-epoch f32 gradient on {GRAD_ROWS} rows, card vs"
          f" CPU max |dg| {d['grad_max_abs_diff']:.3g} (max |g| "
          f"{d['grad_max_abs']:.4g})")
    nn["step"] = nn_phase_step(torch, data_dir)
    print_step(nn["step"])
    return nn


def print_bench(name: str, b: dict) -> None:
    for dt in ("bf16", "f32"):
        r = b[dt]
        print(f"nn {name} {dt}: {b['rows']} x {b['d']}, hidden "
              f"{b['hidden']}, {b['epochs']} epochs: {r['seconds']:.4f} s"
              f", {r['row_epochs_per_s']:.6g} row-epochs/s, "
              f"{r['tflops']:.4g} TFLOP/s ({100 * r['peak_share']:.3g}% "
              f"of {PEAK_TFLOPS[dt]:g}), valid error "
              f"{r['valid_error']:.6f}")
    print_profile(b)


def print_step(st: dict) -> None:
    print(f"nn step: shifu train NN hidden {st['hidden']} tanh, bagging "
          f"{st['bagging']}, {st['epochs']} epochs on {st['rows']} rows x "
          f"{st['columns']}: {st['seconds']:.3f} s ({st['rows_per_s']:.6g} "
          f"rows/s, {st['member_row_epochs_per_s']:.6g} member-row-epochs/s;"
          f" second card run), model files byte-identical across two card "
          f"runs, CPU {st['cpu_seconds']:.2f} s with valid errors within "
          f"{st['max_valid_error_diff_vs_cpu']:.3g}")
    v = st["varsel_se"]
    print(f"nn varsel SE: {v['seconds']:.3f} s (CPU {v['cpu_seconds']:.2f} "
          f"s), card and CPU select the same {len(v['selected'])} columns")


# ---------------------------------------------------------------------------
# phase 10: posttrain and eval on the card
# ---------------------------------------------------------------------------

# the held-out raw set, phase 7's width, from --seed + 1: 200,000 rows
EVAL_ROWS = 200_000
EVAL_NAME = "smoke"
EVAL_TOL = dict(score=0.001, auc=1e-6, bin_avg=0.01)  # the CPU run's
SCORE_STAGES = ("read", "normalize", "codes", "forward", "aggregate",
                "reasons", "write")


def eval_config(root, data, header):
    """`shifu eval -new` on `root`, pointed at the held-out file. The
    model set's own Eval1 (no data path) goes first: the step's config
    check refuses an eval set without one."""
    from shifu_tpu_torch.config.model_config import ModelConfig
    from shifu_tpu_torch.fs.pathfinder import PathFinder
    from shifu_tpu_torch.processor.evaluate import EvalProcessor

    path = PathFinder(root).model_config_path()
    mc = ModelConfig.load(path)
    mc.evals = []
    mc.save(path)
    check(EvalProcessor(root, new_name=EVAL_NAME, device="cpu").run() == 0,
          f"{root}: eval -new returned non-zero")
    mc = ModelConfig.load(path)
    ds = mc.get_eval(EVAL_NAME).data_set
    ds.data_path, ds.header_path = data, header
    mc.save(path)


def set_copy(src, dst):
    """A copy of the model set `src`, its raw data linked, not copied."""
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns("data"))
    os.symlink(os.path.join(src, "data"), os.path.join(dst, "data"))


def eval_set_copy(src, dst, data, header):
    """A copy of the model set `src` (its raw data linked), its eval set
    pointed at the held-out file."""
    set_copy(src, dst)
    eval_config(dst, data, header)


def eval_artifacts(root):
    """The bytes of everything posttrain and eval write, by path."""
    from shifu_tpu_torch.fs.pathfinder import PathFinder

    paths = PathFinder(root)
    out = {}
    for path in (paths.eval_score_path(EVAL_NAME),
                 paths.eval_performance_path(EVAL_NAME),
                 paths.eval_confusion_path(EVAL_NAME),
                 paths.gain_chart_path(EVAL_NAME),
                 paths.column_config_path(),
                 paths.feature_importance_path()):
        with open(path, "rb") as fh:
            out[os.path.relpath(path, root)] = fh.read()
    return out


def posttrain_eval(torch, root, device):
    """`shifu posttrain` then `shifu eval -run` on `root`: the seconds of
    each, their stage splits, the artifacts' bytes."""
    from shifu_tpu_torch.processor.evaluate import EvalProcessor
    from shifu_tpu_torch.processor.posttrain import PostTrainProcessor

    t0 = time.perf_counter()
    post = PostTrainProcessor(root, device=device)
    check(post.run() == 0, f"{root}: posttrain returned non-zero")
    t1 = time.perf_counter()
    ev = EvalProcessor(root, run_name=EVAL_NAME, device=device)
    check(ev.run() == 0, f"{root}: eval returned non-zero")
    if device == "cuda":
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    return dict(posttrain_seconds=t1 - t0, eval_seconds=t2 - t1,
                posttrain_split=dict(post.timings), eval_split=dict(ev.timings),
                metrics=ev.metrics[EVAL_NAME], bytes=eval_artifacts(root))


def _score_table(blob):
    lines = blob.decode().splitlines()
    rows = [ln.split("|") for ln in lines[1:]]
    return lines[0], [r[:2] for r in rows], np.array(
        [[float(v) for v in r[2:]] for r in rows])


def _bin_avg(blob):
    cols = json.loads(blob)
    avg = {c["columnName"]: c["columnBinning"].pop("binAvgScore")
           for c in cols}
    return cols, avg


def check_eval_cpu(kind, card, cpu):
    """The CPU run against the card's: tag and weight columns identical,
    scores within 0.001, AUC within 1e-6, binAvgScore within 0.01, the
    rest of ColumnConfig.json equal. The largest differences."""
    score = os.path.join("evals", EVAL_NAME, "EvalScore.csv")
    (ha, ta, sa), (hc, tc, sc) = (_score_table(r["bytes"][score])
                                  for r in (card, cpu))
    check(ha == hc and ta == tc, f"eval {kind}: the CPU run's header or "
          "tag and weight columns differ from the card's")
    d_score = float(np.abs(sa - sc).max())
    check(d_score <= EVAL_TOL["score"] + 1e-9,
          f"eval {kind}: CPU scores differ by {d_score}")
    d_auc = max(abs(card["metrics"][k] - cpu["metrics"][k])
                for k in ("auc", "weighted_auc"))
    check(d_auc <= EVAL_TOL["auc"], f"eval {kind}: CPU AUC differs by "
          f"{d_auc}")
    (ca, aa), (cc, ac) = (_bin_avg(r["bytes"]["ColumnConfig.json"])
                          for r in (card, cpu))
    check(ca == cc and aa.keys() == ac.keys(),
          f"eval {kind}: the CPU run's ColumnConfig.json differs")
    d_avg = max(float(np.abs(np.subtract(aa[k], ac[k])).max())
                for k in aa if aa[k] is not None)
    check(d_avg <= EVAL_TOL["bin_avg"] + 1e-9,
          f"eval {kind}: CPU binAvgScore differs by {d_avg}")
    return dict(max_score_diff=d_score, auc_diff=d_auc,
                max_bin_avg_diff=d_avg)


def eval_one(torch, kind, src, data_dir, data, header, n_models,
             device="cuda"):
    """(a) or (b): posttrain + eval twice on the card, once on the CPU,
    and the score stage once more under the profiler (`device` "cpu" in
    a rehearsal: no profile)."""
    roots = {name: os.path.join(data_dir, f"eval-{kind}-{name}")
             for name in ("card1", "card2", "cpu")}
    for root in roots.values():
        eval_set_copy(src, root, data, header)
    runs = {name: posttrain_eval(torch, root,
                                 "cpu" if name == "cpu" else device)
            for name, root in roots.items()}
    a = runs["card1"]["bytes"]
    for key in a:
        check(a[key] == runs["card2"]["bytes"][key],
              f"eval {kind}: two card runs wrote different {key} bytes")
    second = runs["card2"]
    split = second["eval_split"]
    score_s = sum(split.get(k, 0.0) for k in SCORE_STAGES)
    from shifu_tpu_torch.processor.evaluate import EvalProcessor

    prof = dict(device_busy_s=None)
    if device == "cuda":
        prof = profile_run(torch, lambda: EvalProcessor(
            roots["card1"], score_name=EVAL_NAME, device="cuda").run(),
            score_s)
        check(eval_artifacts(roots["card1"]) == a,
              f"eval {kind}: the profiled score run rewrote other bytes")
    cpu = check_eval_cpu(kind, second, runs["cpu"])
    _h, tags, scores = _score_table(a[os.path.join("evals", EVAL_NAME,
                                                   "EvalScore.csv")])
    m = second["metrics"]
    check(m["models"] == n_models and scores.shape == (m["records"],
                                                      4 + n_models)
          and np.isfinite(scores).all() and (scores >= 0).all()
          and (scores <= 1000).all() and m["records"] == EVAL_ROWS,
          f"eval {kind}: scores not finite in [0, 1000] of shape "
          f"({EVAL_ROWS}, {4 + n_models}): {scores.shape}")
    check(0.6 < m["auc"] <= 1.0, f"eval {kind}: AUC {m['auc']}")
    return dict(rows=EVAL_ROWS, models=n_models, auc=m["auc"],
                weighted_auc=m["weighted_auc"],
                eval_seconds=second["eval_seconds"],
                eval_rows_per_s=EVAL_ROWS / second["eval_seconds"],
                score_seconds=score_s, eval_split=split,
                posttrain_seconds=second["posttrain_seconds"],
                posttrain_split=second["posttrain_split"],
                seconds_second=score_s,
                card1_seconds=[runs["card1"]["posttrain_seconds"],
                               runs["card1"]["eval_seconds"]],
                cpu_seconds=[runs["cpu"]["posttrain_seconds"],
                             runs["cpu"]["eval_seconds"]],
                cpu=cpu, profile=prof)


def phase_eval(torch, data_dir, seed):
    """Phase 10: the held-out raw set, then (a) the NN set of phase 9(c)
    and (b) the RF set of phase 8."""
    base = os.path.join(data_dir, "eval-raw")
    t0 = time.perf_counter()
    write_raw_set(base, seed + 1, n=EVAL_ROWS)
    write_s = time.perf_counter() - t0
    data = os.path.join(base, "data", "data.txt")
    header = os.path.join(base, "data", "header.txt")
    out = dict(write_seconds=write_s)
    out["nn"] = eval_one(torch, "nn", os.path.join(data_dir, "nn-card2"),
                         data_dir, data, header, NN_STEP["bagging"])
    print_eval("nn", out["nn"])
    out["rf"] = eval_one(torch, "rf", os.path.join(data_dir, "raw-card2"),
                         data_dir, data, header, 1)
    print_eval("rf", out["rf"])
    return out


def print_eval(kind, e):
    what = {"nn": f"{NN_STEP['bagging']} NN models ([50] tanh), norm plan "
                  "-> forward", "rf": f"model0.rf ({PREP['trees']} trees, "
                  f"depth {PREP['depth']}), codes_from_raw -> traverse",
            "wdl": f"{WDL_STEP['bagging']} WDL models "
                   f"({WDL_STEP['hidden']} relu, embed {WDL_STEP['embed']}),"
                   " norm plan + category codes -> forward"}[kind]
    sp = e["eval_split"]
    print(f"eval {kind}: shifu posttrain + eval -run, {what}, on "
          f"{e['rows']} held-out raw rows: eval {e['eval_seconds']:.3f} s "
          f"({e['eval_rows_per_s']:.6g} rows/s), posttrain "
          f"{e['posttrain_seconds']:.3f} s (second card run), AUC "
          f"{e['auc']:.6f} (weighted {e['weighted_auc']:.6f}); card runs "
          "byte-identical, the CPU run's scores within "
          f"{e['cpu']['max_score_diff']:.3g}, AUC within "
          f"{e['cpu']['auc_diff']:.3g}, binAvgScore within "
          f"{e['cpu']['max_bin_avg_diff']:.3g} (CPU posttrain "
          f"{e['cpu_seconds'][0]:.3f} s, eval {e['cpu_seconds'][1]:.3f} s)")
    print("  eval split (s): " + ", ".join(
        f"{k} {v:.4f}" for k, v in sp.items() if k != "forward_device_ms")
        + f"; forwards on the device {sp.get('forward_device_ms', 0.0):.4f}"
        " ms (CUDA events, copies included); posttrain split (s): "
        + ", ".join(f"{k} {v:.4f}" for k, v in e["posttrain_split"].items()))
    print_profile(e)


# ---------------------------------------------------------------------------
# phase 11: `shifu serve` on the card
# ---------------------------------------------------------------------------

SERVE_BATCH = 1024  # rows a batch in (a), the batcher's default row cap
SERVE_ALONE = 64    # rows of (a) scored alone (bucket 8) against their batch
SERVE_ATOL = 2e-3   # score units: the JAX package's fused-vs-runner gate
# bench.py's SERVE shape: 30 value columns, [50] tanh, 3 bags, a queue of
# 256, 240 requests at closed-loop concurrency 1/4/16, 64-row binary ones
SERVE = dict(cols=30, hidden=[50], bags=3, requests=240,
             concurrency=(1, 4, 16), queue_depth=256, wire_rows=64)
OUTPUTS = ("model_scores", "mean", "max", "min", "median")


def _max_diff(a, b) -> float:
    return max(float(np.abs(np.asarray(getattr(a, k), np.float64)
                            - np.asarray(getattr(b, k), np.float64)).max())
               for k in OUTPUTS)


def _bit_equal(a, b) -> bool:
    return all(np.array_equal(getattr(a, k), getattr(b, k)) for k in OUTPUTS)


def _stack(results):
    from shifu_tpu_torch.eval.scorer import ScoreResult

    return ScoreResult(**{k: np.concatenate([getattr(r, k) for r in results])
                          for k in OUTPUTS},
                       model_names=results[0].model_names,
                       model_widths=results[0].model_widths)


def held_out(data_dir):
    """Phase 10's held-out raw rows, read with the port's reader."""
    from shifu_tpu_torch.data.reader import read_columnar, read_header

    base = os.path.join(data_dir, "eval-raw", "data")
    names = read_header(os.path.join(base, "header.txt"))
    return read_columnar(os.path.join(base, "data.txt"), names)


def _rows(data, cols, start, stop):
    """Rows start..stop of `data` over `cols`, a fresh ColumnarData (no
    caches carried from an earlier run)."""
    from shifu_tpu_torch.data.reader import ColumnarData

    stop = min(stop, data.n_rows)
    return ColumnarData(names=list(cols), n_rows=stop - start,
                        raw={c: data.raw[c][start:stop] for c in cols})


def _batches(data, cols, n_rows):
    """Every row of `data` in fresh batches of `n_rows`."""
    return [_rows(data, cols, a, a + n_rows)
            for a in range(0, data.n_rows, n_rows)]


def serve_pass(torch, reg, data):
    """Every held-out row through `reg.score_raw` in SERVE_BATCH-row
    batches: (stacked result, seconds, summed host split)."""
    batches = _batches(data, reg.input_columns, SERVE_BATCH)
    split = dict(featurize=0.0, device=0.0, d2h=0.0)
    t0 = time.perf_counter()
    out = []
    for b in batches:
        out.append(reg.score_raw(b))
        for k in split:
            split[k] += reg.timings[k]
    return _stack(out), time.perf_counter() - t0, split


def _records(data, reg, n, typed):
    """The first `n` held-out rows as JSON records: every token a string,
    or (`typed`) the value columns as JSON numbers (null where the token
    is not a number), as a JSON client sends them."""
    values = {s.cc.column_name for f in reg._featurizers
              for s in f.value_specs}
    recs = []
    for i in range(n):
        r = {}
        for c in reg.input_columns:
            tok = data.raw[c][i]
            if typed and c in values:
                v = data.numeric(c)[i]
                r[c] = None if v != v else float(v)
            else:
                r[c] = tok
        recs.append(r)
    return recs


def serve_parity(torch, data_dir, data, device="cuda"):
    """(a): phase 9(c)'s NN set on the held-out rows."""
    from shifu_tpu_torch.eval.scorer import ModelRunner, find_model_paths
    from shifu_tpu_torch.serve import wire
    from shifu_tpu_torch.serve.registry import ModelRegistry

    models = os.path.join(data_dir, "nn-card2", "models")
    t0 = time.perf_counter()
    reg = ModelRegistry(models, device=device)
    warmed = reg.warm(range(1, SERVE_BATCH + 1))
    warm_s = time.perf_counter() - t0
    check(reg.fused and warmed == [8 << k for k in range(8)],
          f"serve: registry not fused or warm buckets {warmed}")
    card1, s1, split1 = serve_pass(torch, reg, data)
    card2, s2, split2 = serve_pass(torch, reg, data)
    check(_bit_equal(card1, card2), "serve: two card passes differ")
    n = data.n_rows
    w = sum(reg.model_widths)
    check(card1.model_scores.shape == (n, w)
          and all(np.isfinite(getattr(card1, k)).all() for k in OUTPUTS)
          and (card1.model_scores >= 0).all()
          and (card1.model_scores <= 1000).all(),
          f"serve: scores not finite in [0, 1000] of shape ({n}, {w})")
    runner = ModelRunner(find_model_paths(models), device=device)
    d_runner = _max_diff(card1, runner.score_raw(data))
    check(d_runner <= SERVE_ATOL,
          f"serve: card registry vs ModelRunner differ by {d_runner}")
    cpu, s_cpu, _ = serve_pass(torch, ModelRegistry(models, device="cpu"),
                               data)
    d_cpu = _max_diff(card1, cpu)
    check(d_cpu <= SERVE_ATOL,
          f"serve: card registry vs CPU registry differ by {d_cpu}")
    wire_ok = {}
    for typed in (False, True):
        recs = _records(data, reg, SERVE_BATCH, typed)
        via_json = reg.score_records(recs)
        via_bin = reg.score_raw(wire.conform_columns(
            wire.decode(wire.encode_records(recs)), reg.input_columns))
        wire_ok["typed" if typed else "strings"] = _bit_equal(via_json,
                                                              via_bin)
    check(all(wire_ok.values()),
          f"serve: JSON and binary bodies score differently: {wire_ok}")
    from shifu_tpu_torch.serve.batcher import slice_result

    cols = reg.input_columns
    batch = reg.score_raw(_rows(data, cols, 0, SERVE_BATCH))
    alone = _stack([reg.score_raw(_rows(data, cols, i, i + 1))
                    for i in range(SERVE_ALONE)])
    d_alone = _max_diff(slice_result(batch, 0, SERVE_ALONE), alone)
    return dict(rows=n, models=len(reg.model_names), columns=len(
        reg.input_columns), warm_seconds=warm_s, warm_buckets=warmed,
        seconds=s2, rows_per_s=n / s2, first_seconds=s1, split=split2,
        cpu_seconds=s_cpu, max_diff_vs_runner=d_runner,
        max_diff_vs_cpu=d_cpu, json_binary_bit_equal=wire_ok,
        max_diff_batch_vs_alone=d_alone, batches=-(-n // SERVE_BATCH))


def write_serve_set(root, seed):
    """bench.py's SERVE model set: 3 `.nn` of [30, 50, 1] tanh over 30
    value columns (z-score, random means), weights from seeds 0..2."""
    from shifu_tpu_torch.models.nn import NNModelSpec, init_params

    rng = np.random.default_rng(seed)
    cols = [f"c{i}" for i in range(SERVE["cols"])]
    sizes = [SERVE["cols"]] + SERVE["hidden"] + [1]
    models = os.path.join(root, "models")
    os.makedirs(models, exist_ok=True)
    for b in range(SERVE["bags"]):
        specs = [{"name": c, "kind": "value", "outNames": [c],
                  "mean": float(rng.normal()), "std": 1.0, "fill": 0.0,
                  "zscore": True, "boundaries": [float("-inf")]}
                 for c in cols]
        NNModelSpec(layer_sizes=sizes, activations=["tanh"],
                    input_columns=cols, norm_specs=specs,
                    params=init_params(sizes, seed=b)).save(
            os.path.join(models, f"model{b}.nn"))
    return cols


def _closed_loop(port, bodies, conc, ctype):
    """`conc` client threads, each with one keep-alive connection,
    posting its share of `bodies` in turn: (latencies s, wall s, status
    codes)."""
    import http.client
    import threading

    per = len(bodies) // conc
    lat = [[] for _ in range(conc)]
    codes = [[] for _ in range(conc)]

    def client(t):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        for body in bodies[t * per:(t + 1) * per]:
            t0 = time.perf_counter()
            conn.request("POST", "/score", body=body,
                         headers={"Content-Type": ctype})
            resp = conn.getresponse()
            resp.read()
            lat[t].append(time.perf_counter() - t0)
            codes[t].append(resp.status)
        conn.close()

    threads = [threading.Thread(target=client, args=(t,))
               for t in range(conc)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    wall = time.perf_counter() - t0
    return ([v for ts in lat for v in ts], wall,
            [c for cs in codes for c in cs])


def _latency(lat, wall) -> dict:
    a = np.asarray(lat)
    return dict(requests=int(a.size), p50_ms=float(np.percentile(a, 50)) * 1e3,
                p99_ms=float(np.percentile(a, 99)) * 1e3,
                qps=a.size / wall)


def serve_latency(torch, data_dir, seed, device="cuda"):
    """(b): bench SERVE through ScoringServer over HTTP on 127.0.0.1."""
    import urllib.request

    from shifu_tpu_torch.serve import wire
    from shifu_tpu_torch.serve.server import ScoringServer

    root = os.path.join(data_dir, "serve-bench")
    cols = write_serve_set(root, seed)
    reset_obs()  # the replica snapshot below reads the registry's series
    srv = ScoringServer(root=root, port=0, replicas=1,
                        queue_depth=SERVE["queue_depth"], device=device)
    srv.registry.warm([1, max(SERVE["concurrency"]), SERVE["wire_rows"]])
    srv.start()
    rng = np.random.default_rng(seed + 11)
    n = SERVE["requests"]
    out = {}
    codes = []
    try:
        singles = [json.dumps({c: f"{v:.4f}" for c, v in zip(
            cols, rng.normal(size=len(cols)))}).encode() for _ in range(n)]
        for conc in SERVE["concurrency"]:
            lat, wall, c = _closed_loop(srv.port, singles, conc,
                                        "application/json")
            codes += c
            out[f"json_c{conc}"] = _latency(lat, wall)
        batcher = srv.registry.replicas[0].batcher
        top = max(SERVE["concurrency"])
        batcher.batching = "barrier"
        lat, wall, c = _closed_loop(srv.port, singles, top,
                                    "application/json")
        codes += c
        out[f"barrier_c{top}"] = _latency(lat, wall)
        batcher.batching = "continuous"
        rows = SERVE["wire_rows"]
        payloads = [wire.encode_records(
            [{cc: float(v) for cc, v in zip(cols, row)}
             for row in rng.normal(size=(rows, len(cols)))])
            for _ in range(n)]
        lat, wall, c = _closed_loop(srv.port, payloads, 1,
                                    wire.CONTENT_TYPE)
        codes += c
        out[f"binary_{rows}_rows_c1"] = _latency(lat, wall)
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/healthz",
                                    timeout=30) as r:
            health = r.status
    finally:
        snap = srv.shutdown(60)
    answered = sum(1 for c in codes if c == 200)
    check(answered == len(codes), f"serve: {len(codes) - answered} of "
          f"{len(codes)} HTTP requests not answered 200")
    check(health == 200, f"serve: /healthz answered {health}")
    rep = snap["replicas"][0]
    check(rep["queue"]["queued"] == 0 and rep["queue"]["closed"]
          and rep["batcher"]["records"] == n * (len(SERVE["concurrency"])
                                                + 1 + SERVE["wire_rows"])
          and rep["batcher"]["batchErrors"] == 0,
          f"serve: no clean drain: {rep['queue']}, {rep['batcher']}")
    out.update(requests=len(codes), batches=rep["batcher"]["batches"])
    return out


def serve_trees(torch, data_dir, data, device="cuda"):
    """(c): phase 8's RF set takes the ModelRunner fallback."""
    from shifu_tpu_torch.eval.scorer import ModelRunner, find_model_paths
    from shifu_tpu_torch.serve.registry import ModelRegistry

    models = os.path.join(data_dir, "raw-card2", "models")
    reg = ModelRegistry(models, device=device)
    check(not reg.fused, "serve: the RF set was fused")
    batch = _rows(data, reg.input_columns, 0, SERVE_BATCH)
    got = reg.score_raw(batch)
    want = ModelRunner(find_model_paths(models), device=device).score_raw(
        _rows(data, reg.input_columns, 0, SERVE_BATCH))
    check(_bit_equal(got, want),
          "serve: the RF registry differs from the ModelRunner")
    return dict(rows=batch.n_rows, models=len(reg.model_names))


def serve_profile(torch, data_dir, data):
    """(d): one single-record batch and one SERVE_BATCH-row batch under
    the profiler: device launches, memcpys, busy vs wall, host split."""
    from shifu_tpu_torch.serve.registry import ModelRegistry

    reg = ModelRegistry(os.path.join(data_dir, "nn-card2", "models"),
                        device="cuda")
    reg.warm([1, SERVE_BATCH])
    out = {}
    for rows in (1, SERVE_BATCH):
        walls, splits = [], []
        for _ in range(5):  # unprofiled: the wall and the host split
            t0 = time.perf_counter()
            reg.score_raw(_rows(data, reg.input_columns, 0, rows))
            walls.append(time.perf_counter() - t0)
            splits.append(dict(reg.timings))
        wall = float(np.median(walls))
        # three calls profiled after one skipped and one warm-up call (the
        # profiler can drop the first activities of a window); a window
        # that lost events is taken again, a few times
        for _attempt in range(4):
            torch.cuda.synchronize()
            with _profile(torch, schedule=torch.profiler.schedule(
                    wait=1, warmup=1, active=3)) as prof:
                for _ in range(5):
                    reg.score_raw(_rows(data, reg.input_columns, 0, rows))
                    prof.step()
            counts = _device_counts(prof, 3)
            h2d = sum(c for k, c in counts.items() if "Memcpy HtoD" in k)
            d2h = sum(c for k, c in counts.items() if "Memcpy DtoH" in k)
            if h2d == 1 and d2h == 1:
                break
        times = _device_times(prof, 3)
        busy_s = sum(times.values()) / 1e6
        out[rows] = dict(
            launches=sum(counts.values()), h2d=h2d, d2h=d2h,
            device_busy_ms=busy_s * 1e3, wall_ms=wall * 1e3,
            idle_share=max(0.0, 1.0 - busy_s / wall) if counts else None,
            split_ms={k: float(np.median([sp[k] for sp in splits])) * 1e3
                      for k in splits[0]},
            top=[[k[:60], v / 1e3] for k, v in sorted(
                times.items(), key=lambda kv: -kv[1])[:6]])
        if counts:
            check(h2d == 1 and d2h == 1,
                  f"serve: a {rows}-row batch made {h2d} HtoD and {d2h} "
                  "DtoH copies, not one each")
    return out


def phase_serve(torch, data_dir, seed):
    """Phase 11: (a) parity, (b) latency over HTTP, (c) the tree
    fallback, (d) a profiled pass."""
    t0 = time.perf_counter()
    data = held_out(data_dir)
    out = dict(read_seconds=time.perf_counter() - t0)
    out["parity"] = serve_parity(torch, data_dir, data)
    print_serve("parity", out["parity"])
    out["latency"] = serve_latency(torch, data_dir, seed)
    print_serve("latency", out["latency"])
    out["trees"] = serve_trees(torch, data_dir, data)
    print_serve("trees", out["trees"])
    out["profile"] = serve_profile(torch, data_dir, data)
    print_serve("profile", out["profile"])
    out["seconds"] = time.perf_counter() - t0
    return out


def print_serve(part, r):
    if part == "parity":
        sp = r["split"]
        print(f"serve parity: ModelRegistry on the card, {r['models']} NN "
              f"models ({r['columns']} columns), {r['rows']} held-out rows in "
              f"{r['batches']} batches of {SERVE_BATCH}: {r['seconds']:.3f} s "
              f"({r['rows_per_s']:.6g} rows/s; second pass; split s: "
              f"featurize {sp['featurize']:.4f}, device {sp['device']:.4f}, "
              f"d2h {sp['d2h']:.4f}); warm {r['warm_seconds']:.3f} s "
              f"(buckets {r['warm_buckets']}); two passes bit-identical; "
              f"max |d| vs ModelRunner {r['max_diff_vs_runner']:.3g}, vs the "
              f"CPU registry {r['max_diff_vs_cpu']:.3g} (CPU "
              f"{r['cpu_seconds']:.3f} s); JSON = binary bit for bit "
              f"{r['json_binary_bit_equal']}; max |d| of {SERVE_ALONE} rows "
              f"batched ({SERVE_BATCH}) vs alone (bucket 8) "
              f"{r['max_diff_batch_vs_alone']:.6g} (not gated)")
    elif part == "latency":
        print(f"serve latency: bench SERVE ({SERVE['cols']} columns, "
              f"{SERVE['hidden']} tanh, {SERVE['bags']} bags, queue "
              f"{SERVE['queue_depth']}) through ScoringServer over HTTP on "
              f"127.0.0.1, {r['requests']} requests all answered 200, "
              f"{r['batches']} batches, /healthz 200, clean drain:")
        for k, v in r.items():
            if isinstance(v, dict):
                print(f"  {k}: p50 {v['p50_ms']:.3f} ms, p99 "
                      f"{v['p99_ms']:.3f} ms, {v['qps']:.1f} QPS "
                      f"({v['requests']} requests)")
    elif part == "trees":
        print(f"serve trees: phase 8's RF set through the registry's "
              f"ModelRunner fallback on {r['rows']} rows, bit-equal to the "
              "ModelRunner")
    else:
        for rows, p in r.items():
            print(f"serve profile, {rows}-row batch: {p['launches']:g} "
                  f"device launches, {p['h2d']:g} HtoD + {p['d2h']:g} DtoH "
                  "memcpy (a batch, 3 profiled), "
                  f"device busy {p['device_busy_ms']:.4f} ms of "
                  f"{p['wall_ms']:.4f} ms wall (median of 5 unprofiled; "
                  "idle share "
                  + (f"{p['idle_share']:.3f}" if p["idle_share"] is not None
                     else "not measured")
                  + "); host split (ms): " + ", ".join(
                      f"{k} {v:.4f}" for k, v in p["split_ms"].items())
                  + "; top (ms): " + ", ".join(
                      f"{k[:40]} {v:.4f}" for k, v in p["top"][:4]))


# ---------------------------------------------------------------------------
# phase 12: the leaf-wise and host-batched growers, and the lifecycle's ends
# ---------------------------------------------------------------------------

# (a)-(d): leaf-wise GBT and RF, host-batched GBT (bench gbt_wide at the
# default stats-memory budget) and RF (a 1 MB budget)
LEAFWISE_GBT = dict(leaves=32, depth=10, trees=5)
LEAFWISE_RF = dict(leaves=64, depth=10, trees=10, cpu_trees=3)
BATCHED_GBT = dict(depth=12, trees=3, cpu_trees=2)
BATCHED_RF = dict(depth=8, trees=3, memory_mb=1)
COMBO_ROWS = 20_000  # (e): the raw set `combo` runs on
# (e) card vs CPU: the NN member's scores at most 10 x1000 units apart;
# the GBT member's (100 trees, depth 6: fixed-point and f32 sums split
# near-tied gains apart over the forest) 10 units apart on average; each
# member's AUC on the rows and the combo's within 0.01
COMBO_TOL = dict(nn=10.0, gbt_mean=10.0, auc=0.01)


def batched_plan(tt, cfg, cap: int):
    """(histogram calls, built, derived, fallback rebuilds) of one
    host-batched tree, from the static subtraction plan: a level derived
    from its parent or kept for the next level is one call, any other
    level one call a batch of at most `cap` nodes."""
    sub = tt._sub_plan(cfg, cap)
    calls = built = derived = fallback = 0
    prev = False
    for d in range(cfg.max_depth + 1):
        L = 2 ** d
        retain = (d < cfg.max_depth and cfg.hist_subtraction
                  and sub[d + 1])
        if prev:
            calls, built, derived = calls + 1, built + L // 2, derived + L // 2
        elif retain:
            calls, built = calls + 1, built + L
            fallback += int(d >= 1 and cfg.hist_subtraction)
        else:
            batches = -(-L // cap)
            calls, built = calls + batches, built + L
            fallback += batches if d >= 1 and cfg.hist_subtraction else 0
        prev = retain
    return calls, built, derived, fallback


def grower_run(torch, hk, tt, args_, cfg, device):
    """One counted run: launches, plain-version calls, the plain torch
    scans on the card (their widths) and the `tree.hist.*` counters, each zeroed
    just before and read just after."""
    hk.reset_counters()
    reset_obs()
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    with PlainScans(tt) as ps:
        res = tt.train_trees(*args_, cfg, device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    return dict(res=res, seconds=time.perf_counter() - t0,
                launches=dict(hk.launches), refs=dict(hk.reference_calls),
                plain=list(ps.widths), counters=hist_counts())


def _scores(ptree, spec, codes, device):
    return ptree.IndependentTreeModel(spec, device=device).compute(codes)


def grower_case(torch, hk, tt, ptree, name, data, cfg, cpu_trees, plan,
                device="cuda", wide=()):
    """(a)-(d): the grower on the card twice (bit-equal forests), its
    launches against the `tree.hist.*` counters (leaf-wise: one `hist_level` a
    built node, one `scan_level` a built or derived one; host-batched:
    `plan` = batched_plan), no plain version called and no plain torch
    scan but on the `wide` columns; one tree unprofiled and profiled
    (device busy, idle share); then `cpu_trees` trees on the CPU: RF
    bit-equal to the card's first trees, GBT scores within
    GBT_SCORE_ATOL."""
    codes, y, slots, is_cat = data
    n, F = codes.shape
    args_ = (codes, y, np.ones(n, np.float32), slots, is_cat,
             [f"f{i}" for i in range(F)])
    mc = "_mc" if cfg.n_classes >= 3 else ""
    first = grower_run(torch, hk, tt, args_, cfg, device)
    second = grower_run(torch, hk, tt, args_, cfg, device)
    res, launches, cnt = first["res"], first["launches"], first["counters"]
    check(forests_equal(res.spec, second["res"].spec),
          f"{name}: a second run on the card gave another forest")
    check(all(v == 0 for v in first["refs"].values()) or device == "cpu",
          f"{name}: the run on the card reached a plain version: "
          f"{first['refs']}")
    check(set(first["plain"]) <= set(wide),
          f"{name}: the plain torch scan ran on the card: {first['plain']}")
    counted = first["refs"] if device == "cpu" else launches
    hist, scan = counted["hist_level" + mc], counted["scan_level" + mc]
    check(counted["fused_level" + mc] == 0,
          f"{name}: the fused entry ran: {counted}")
    trees = len(res.spec.trees)
    if cfg.max_leaves > 0:
        check(all(t.left is not None for t in res.spec.trees),
              f"{name}: a tree without child pointers")
        check(hist == cnt["built"] and scan == cnt["built"] + cnt["derived"]
              and cnt["derived"] > 0,
              f"{name}: launches {counted} against hist_counters {cnt}")
    else:
        calls, built, derived, fallback = plan
        check(hist == scan == trees * calls,
              f"{name}: launches {counted}, expected {trees * calls} each")
        check(cnt == dict(built=trees * built, derived=trees * derived,
                          fallback_rebuilds=trees * fallback),
              f"{name}: hist_counters {cnt} against the plan {plan}")
    one = dataclasses.replace(cfg, tree_num=1)
    t0 = time.perf_counter()
    tt.train_trees(*args_, one, device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    tree_s = time.perf_counter() - t0
    prof = (profile_run(torch, lambda: tt.train_trees(*args_, one,
                                                      device=device), tree_s)
            if device == "cuda" else None)

    cpu_cfg = dataclasses.replace(cfg, tree_num=cpu_trees)
    t0 = time.perf_counter()
    cpu = tt.train_trees(*args_, cpu_cfg, device="cpu")
    cpu_s = time.perf_counter() - t0
    head = dataclasses.replace(res.spec, trees=res.spec.trees[:cpu_trees])
    out = dict(rows=n, T=int(sum(slots)), trees=trees, depth=cfg.max_depth,
               max_leaves=cfg.max_leaves, seconds_first=first["seconds"],
               seconds_second=second["seconds"],
               trees_per_s=trees / second["seconds"],
               tree_seconds=tree_s, cpu_trees=cpu_trees, cpu_seconds=cpu_s,
               nodes=[int(t.n_nodes) for t in res.spec.trees],
               valid_error=res.valid_error, launches=launches,
               hist_counters=cnt, plain_scan_widths=sorted(
                   set(first["plain"])), profile=prof)
    if cfg.algorithm == "RF":
        check(forests_equal(head, cpu.spec),
              f"{name}: the card's first {cpu_trees} trees differ from the "
              "CPU run's")
        out["bit_equal_to_cpu"] = True
    else:
        diff = float(np.abs(_scores(ptree, head, codes, device)
                            - _scores(ptree, cpu.spec, codes, "cpu")).max())
        check(diff <= GBT_SCORE_ATOL,
              f"{name}: scores differ from the CPU run by {diff} > "
              f"{GBT_SCORE_ATOL}")
        out["max_score_diff_vs_cpu"] = diff
    return out


def growers_data(seed: int):
    """(c)'s bench gbt_wide rows with 0/1 labels from a numeric and the
    wide column."""
    codes, slots, is_cat = wide_data(seed)
    rng = np.random.default_rng(seed + 12)
    y = ((codes[:, 0] >= 16) ^ (codes[:, -1] % 3 == 0)
         ^ (rng.random(codes.shape[0]) < 0.1)).astype(np.float32)
    return codes, y, slots, is_cat


def write_forest_set(root, spec, codes, y):
    """A raw model set for a forest of bench `rf` codes: numeric column f
    holds its code as the raw value (bin boundaries -inf, 1, 2, ...),
    categorical column f the token `v<code>`, the target 0/1;
    ColumnConfig.json and ModelConfig.json from the port's own config
    module, the forest under models/."""
    from shifu_tpu_torch.config import (ColumnBinning, ColumnConfig,
                                        ColumnFlag, ColumnType,
                                        save_column_config_list)
    from shifu_tpu_torch.config.model_config import (Algorithm,
                                                     new_model_config)
    from shifu_tpu_torch.fs.pathfinder import PathFinder

    paths = PathFinder(root)
    os.makedirs(os.path.join(root, "data"), exist_ok=True)
    mc = new_model_config("Forest", Algorithm.parse(spec.algorithm))
    ds = mc.data_set
    ds.data_path, ds.header_path = "data/data.txt", "data/header.txt"
    ds.target_column_name, ds.pos_tags, ds.neg_tags = "label", ["1"], ["0"]
    mc.save(paths.model_config_path())
    columns = [ColumnConfig(column_num=0, column_name="label",
                            column_type=ColumnType.C,
                            column_flag=ColumnFlag.TARGET)]
    cols = [np.where(y > 0, "1", "0")]
    for f, name in enumerate(spec.input_columns):
        cats = spec.categories[f]
        columns.append(ColumnConfig(
            column_num=f + 1, column_name=name,
            column_type=ColumnType.C if cats else ColumnType.N,
            final_select=True, column_binning=ColumnBinning(
                length=spec.slots[f] - 1, bin_category=cats,
                bin_boundary=spec.boundaries[f])))
        cols.append(np.char.add("v", codes[:, f].astype(str)) if cats
                    else codes[:, f].astype(str))
    save_column_config_list(paths.column_config_path(), columns)
    with open(os.path.join(root, ds.header_path), "w") as fh:
        fh.write("|".join(["label"] + list(spec.input_columns)) + "\n")
    with open(os.path.join(root, ds.data_path), "w") as fh:
        fh.write("\n".join(map("|".join, zip(*[c.tolist() for c in cols]))))
        fh.write("\n")
    os.makedirs(paths.models_dir(), exist_ok=True)
    spec.save(paths.model_path(0, "rf"))


def _file_tree(root, skip=()):
    """relative path -> bytes of every file under `root`."""
    out = {}
    for d, _dirs, files in os.walk(root):
        for f in files:
            rel = os.path.relpath(os.path.join(d, f), root)
            if not rel.startswith(skip):
                with open(os.path.join(d, f), "rb") as fh:
                    out[rel] = fh.read()
    return out


def ends_new(base):
    """`new` twice: the same files but for the creation time."""
    from shifu_tpu_torch.processor.create import run_new

    trees = []
    for i in range(2):
        root = os.path.join(base, f"new{i}")
        check(run_new("Smoke", "GBT", root=root) == 0, "new returned 1")
        files = _file_tree(root)
        mc = json.loads(files["Smoke/ModelConfig.json"])
        mc["basic"].pop("description")
        files["Smoke/ModelConfig.json"] = json.dumps(mc).encode()
        trees.append(files)
    check(trees[0] == trees[1] and len(trees[0]) == 5,
          f"new: two runs wrote other files: {sorted(trees[0])}")
    return sorted(trees[0])


EXPORTS = {"nn": ("pmml", "onebagging", "columnstats", "woemapping"),
           "rf": ("pmml", "onebagging", "columnstats", "woemapping", "corr")}


def ends_export(kind, root):
    """`export -t <type>` of each type twice on one set: the same
    bytes."""
    from shifu_tpu_torch.processor.export import ExportProcessor

    out_dir = os.path.join(root, "export")
    shutil.rmtree(out_dir, ignore_errors=True)
    files = {}
    for t in EXPORTS[kind]:
        check(ExportProcessor(root, kind=t).run() == 0,
              f"export {kind} -t {t} returned 1")
        files.update(_file_tree(out_dir))
    again = {}
    for t in EXPORTS[kind]:
        ExportProcessor(root, kind=t).run()
        again.update(_file_tree(out_dir))
    check(files == again and len(files) >= len(EXPORTS[kind]),
          f"export {kind}: two runs wrote other bytes")
    return {k: len(v) for k, v in files.items()}


def ends_encode(name, root, dataset=None, device="cuda"):
    """`encode` on the card and on the CPU: byte-identical EncodedData.
    Returns (bytes, [card seconds, cpu seconds])."""
    from shifu_tpu_torch.processor.encode import EncodeProcessor

    out = os.path.join(root, "tmp", "encode", "EncodedData")
    got, secs = [], []
    for device in (device, "cpu"):
        t0 = time.perf_counter()
        check(EncodeProcessor(root, dataset=dataset, device=device).run()
              == 0, f"encode {name} on {device} returned 1")
        secs.append(time.perf_counter() - t0)
        with open(out, "rb") as fh:
            got.append(fh.read())
    check(got[0] == got[1], f"encode {name}: the card and the CPU wrote "
          "other bytes")
    return got[0], secs


def ends_combo(base, seed, device="cuda"):
    """`combo -new NN,GBT,LR -init -run -eval` on a 20,000-row raw set,
    on the card and on the CPU: the same spec and member configs, member
    scores and the AUC within COMBO_TOL."""
    from shifu_tpu_torch.config.model_config import ModelConfig
    from shifu_tpu_torch.processor.combo import ComboProcessor

    runs = []
    for i, device in enumerate((device, "cpu")):
        root = os.path.join(base, f"combo-{i}")
        write_raw_set(root, seed + 2, n=COMBO_ROWS)
        path = os.path.join(root, "ModelConfig.json")
        mc = ModelConfig.load(path)
        # the members' model sets sit one directory down: no meta file
        mc.data_set.meta_column_name_file = ""
        mc.stats.psi_column_name = ""
        mc.save(path)
        t0 = time.perf_counter()
        check(ComboProcessor(root, new_algs="NN,GBT,LR",
                             device=device).run() == 0, "combo -new")
        check(ComboProcessor(root, do_init=True, do_run=True, do_eval=True,
                             device=device).run() == 0,
              f"combo on {device} returned non-zero")
        secs = time.perf_counter() - t0
        with open(os.path.join(root, "evals", "Combo",
                               "EvalPerformance.json")) as fh:
            auc = json.load(fh)["areaUnderRoc"]
        scores = np.loadtxt(os.path.join(root, "assembler_LR", "data",
                                         "data.txt"), delimiter="|")
        configs = {}
        for d in ("sub_0_NN", "sub_1_GBT", "assembler_LR"):
            with open(os.path.join(root, d, "ModelConfig.json")) as fh:
                configs[d] = json.load(fh)
            configs[d]["basic"].pop("description")  # its creation time
        with open(os.path.join(root, "ComboTrain.json"), "rb") as fh:
            configs["spec"] = fh.read()
        runs.append(dict(seconds=secs, auc=auc, scores=scores,
                         configs=configs))
    a, b = runs
    check(a["configs"] == b["configs"],
          "combo: the card and the CPU wrote other specs or member configs")
    check(a["scores"].shape == b["scores"].shape
          and np.array_equal(a["scores"][:, 0], b["scores"][:, 0]),
          "combo: the assembler's rows differ")
    from shifu_tpu_torch.eval.metrics import evaluate_performance

    tags = a["scores"][:, 0]
    d = np.abs(a["scores"][:, 1:] - b["scores"][:, 1:])
    aucs = [[evaluate_performance(r["scores"][:, m], tags).area_under_roc
             for m in (1, 2)] for r in (a, b)]
    check(d[:, 0].max() <= COMBO_TOL["nn"]
          and d[:, 1].mean() <= COMBO_TOL["gbt_mean"]
          and np.abs(np.subtract(*aucs)).max() <= COMBO_TOL["auc"]
          and abs(a["auc"] - b["auc"]) <= COMBO_TOL["auc"]
          and 0.5 < a["auc"] <= 1.0,
          f"combo: NN scores {d[:, 0].max()} apart, GBT scores "
          f"{d[:, 1].mean()} apart on average, member AUCs {aucs}, AUC "
          f"{a['auc']} vs {b['auc']}")
    return dict(rows=COMBO_ROWS, seconds=a["seconds"],
                cpu_seconds=b["seconds"], auc=a["auc"], cpu_auc=b["auc"],
                member_aucs=aucs[0], cpu_member_aucs=aucs[1],
                max_nn_score_diff=float(d[:, 0].max()),
                max_gbt_score_diff=float(d[:, 1].max()),
                mean_gbt_score_diff=float(d[:, 1].mean()))


def phase_growers(torch, hk, tt, ptree, data_dir, gbt, rf, seed,
                  device="cuda"):
    """Phase 12: (a)-(d) the growers, (e) the lifecycle's ends."""
    t_all = time.perf_counter()
    out = {}
    gcfg = dict(algorithm="GBT", learning_rate=0.1, valid_set_rate=0.1,
                seed=3)
    rcfg = dict(algorithm="RF", feature_subset_strategy="TWOTHIRDS",
                valid_set_rate=0.1, seed=3)
    out["leafwise_gbt"] = grower_case(
        torch, hk, tt, ptree, "leafwise_gbt", gbt, tt.TreeTrainConfig(
            tree_num=LEAFWISE_GBT["trees"], max_depth=LEAFWISE_GBT["depth"],
            max_leaves=LEAFWISE_GBT["leaves"], **gcfg),
        LEAFWISE_GBT["trees"], None, device)
    print_grower("leafwise_gbt", out["leafwise_gbt"])
    lay_rf = tt.make_layout(rf[2], rf[3])
    # (e) scores (b)'s forest from raw values: numeric code k is the
    # value k, categorical code k the token v<k>
    bounds = [None if c else [-float("inf")] + [float(b)
                                                for b in range(1, s - 1)]
              for s, c in zip(rf[2], rf[3])]
    cats = [[f"v{j}" for j in range(s - 1)] if c else None
            for s, c in zip(rf[2], rf[3])]
    lw_cfg = tt.TreeTrainConfig(
        tree_num=LEAFWISE_RF["trees"], max_depth=LEAFWISE_RF["depth"],
        max_leaves=LEAFWISE_RF["leaves"], **rcfg)
    out["leafwise_rf"] = grower_case(
        torch, hk, tt, ptree, "leafwise_rf", rf, lw_cfg,
        LEAFWISE_RF["cpu_trees"], None, device)
    print_grower("leafwise_rf", out["leafwise_rf"])

    wide = growers_data(seed)
    lay_w = tt.make_layout(wide[2], wide[3])
    cap_w = tt._node_batch_size(lay_w.T, 256)
    b_cfg = tt.TreeTrainConfig(tree_num=BATCHED_GBT["trees"],
                               max_depth=BATCHED_GBT["depth"], **gcfg)
    check(2 ** b_cfg.max_depth > cap_w,
          f"batched_gbt: {2 ** b_cfg.max_depth} nodes fit the node batch "
          f"{cap_w}")
    out["batched_gbt"] = grower_case(
        torch, hk, tt, ptree, "batched_gbt", wide, b_cfg,
        BATCHED_GBT["cpu_trees"], batched_plan(tt, b_cfg, cap_w), device,
        wide=(WIDE["wide_cat"] + 1,))
    out["batched_gbt"]["node_batch"] = cap_w
    print_grower("batched_gbt", out["batched_gbt"])
    del wide
    cap_r = tt._node_batch_size(lay_rf.T, BATCHED_RF["memory_mb"])
    br_cfg = tt.TreeTrainConfig(tree_num=BATCHED_RF["trees"],
                                max_depth=BATCHED_RF["depth"],
                                max_stats_memory_mb=BATCHED_RF["memory_mb"],
                                **rcfg)
    out["batched_rf"] = grower_case(
        torch, hk, tt, ptree, "batched_rf", rf, br_cfg, BATCHED_RF["trees"],
        batched_plan(tt, br_cfg, cap_r), device)
    out["batched_rf"]["node_batch"] = cap_r
    print_grower("batched_rf", out["batched_rf"])

    # (e) the lifecycle's ends
    t0 = time.perf_counter()
    base = os.path.join(data_dir, "ends")
    os.makedirs(base, exist_ok=True)
    ends = dict(new=ends_new(base))
    # phase 9(c)'s NN set, phase 8's RF set and its copy with phase 10's
    # held-out eval set
    ends["export"] = {
        "nn": ends_export("nn", os.path.join(data_dir, "nn-card2")),
        "rf": ends_export("rf", os.path.join(data_dir, "raw-card2"))}
    enc, ends["encode_rf_seconds"] = ends_encode(
        "rf", os.path.join(data_dir, "eval-rf-card1"), EVAL_NAME, device)
    check(enc.count(b"\n") == EVAL_ROWS + 1,
          "encode rf: not one line a held-out row")
    # (b)'s leaf-wise forest as a model set on the first 100,000 rows
    n_lw = min(100_000, rf[0].shape[0])
    lw = tt.train_trees(rf[0][:n_lw], rf[1][:n_lw], np.ones(n_lw, np.float32),
                        rf[2], rf[3], [f"f{i}" for i in range(len(rf[2]))],
                        dataclasses.replace(lw_cfg, tree_num=3),
                        boundaries=bounds, categories=cats, device=device)
    lw_root = os.path.join(base, "leafwise-set")
    write_forest_set(lw_root, lw.spec, rf[0][:n_lw], rf[1][:n_lw])
    enc, ends["encode_leafwise_seconds"] = ends_encode("leafwise", lw_root,
                                                       device=device)
    ids = np.loadtxt(enc.decode().splitlines()[1:], delimiter="|",
                     dtype=np.int64)
    want = ptree.leaf_nodes(lw.spec.trees,
                            torch.as_tensor(rf[0][:n_lw])).numpy()
    check(np.array_equal(ids[:, 1:], want),
          "encode leafwise: the leaf ids are not the pointers' leaves")
    ends["combo"] = ends_combo(base, seed, device)
    ends["seconds"] = time.perf_counter() - t0
    out["ends"] = ends
    print_ends(ends)
    out["seconds"] = time.perf_counter() - t_all
    return out


def print_grower(name, g):
    what = (f"MaxLeaves {g['max_leaves']}, MaxDepth {g['depth']}"
            if g["max_leaves"] > 0 else
            f"MaxDepth {g['depth']}, node batch {g.get('node_batch')}")
    cmp = (f"the first {g['cpu_trees']} trees bit-equal to the CPU run's"
           if "bit_equal_to_cpu" in g else
           f"max |score - cpu score| {g['max_score_diff_vs_cpu']:.3g} over "
           f"{g['cpu_trees']} trees")
    print(f"growers {name}: {g['trees']} trees ({what}) on {g['rows']} rows "
          f"x T={g['T']}: {g['trees_per_s']:.3f} trees/s (second run, "
          f"{g['seconds_second']:.3f} s), two card runs bit-equal, {cmp} "
          f"(CPU {g['cpu_seconds']:.1f} s); hist_counters "
          f"{g['hist_counters']}; launches {g['launches']}")
    p = g["profile"]
    if p is not None and p["device_busy_s"] is not None:
        print(f"  one tree: {g['tree_seconds']:.4f} s, device busy "
              f"{p['device_busy_s']:.4f} s, idle share "
              f"{p['idle_share']:.3f}; top kernels (ms): " + ", ".join(
                  f"{k[:40]} {v:.2f}" for k, v in p["top_kernels"][:4]))
    elif p is not None:
        print("  one tree: no device time recorded, not measured")


def print_ends(e):
    c = e["combo"]
    print(f"ends: new ({len(e['new'])} files, two runs the same), export "
          f"nn {sorted(e['export']['nn'])}, rf {sorted(e['export']['rf'])} "
          f"(two runs byte-identical); encode phase 10's held-out rows with "
          f"phase 8's RF set card {e['encode_rf_seconds'][0]:.2f} s / CPU "
          f"{e['encode_rf_seconds'][1]:.2f} s and (b)'s leaf-wise forest "
          f"card {e['encode_leafwise_seconds'][0]:.2f} s / CPU "
          f"{e['encode_leafwise_seconds'][1]:.2f} s, byte-identical, leaf "
          f"ids by the pointers; combo NN,GBT,LR on {c['rows']} rows: card "
          f"{c['seconds']:.1f} s, CPU {c['cpu_seconds']:.1f} s, AUC "
          f"{c['auc']:.6f} (CPU {c['cpu_auc']:.6f}), member AUCs "
          f"{c['member_aucs']} (CPU {c['cpu_member_aucs']}), member scores "
          f"within {c['max_nn_score_diff']:.3g} (NN) and "
          f"{c['max_gbt_score_diff']:.3g} (GBT, mean "
          f"{c['mean_gbt_score_diff']:.3g}) x1000 units")


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# phase 13: WDL on the card, the reference formats and `shifu convert`
# ---------------------------------------------------------------------------

# bench.py:69 WDL: 200,000 rows, 20 dense columns, 10 fields of vocab 100,
# embed 8, [100, 50] relu, 20 epochs
WDL = dict(n=200_000, dense=20, wide=10, vocab=100, embed=8,
           hidden=[100, 50], epochs=20)
WDL_MEMBERS = 5  # (b)
# (c): `shifu train` WDL on phase 7's raw set, every column a candidate
WDL_STEP = dict(hidden=[100, 50], embed=8, epochs=5, bagging=3, lr=0.05)
WDL_SERVE = dict(rows=64, per_request=16)  # (e): held-out rows as JSON
CONVERT_ROWS = 20_000  # (f): held-out rows the converted files score
REF_RTOL = 1e-5  # (f): converted files' scores against the native ones


def wdl_bench_data(seed):
    """bench.py bench_wdl's draws (seed 0 there): dense [n, 20] f32,
    codes [n, 10] in [0, 100), a 0/1 target, unit weights."""
    rng = np.random.default_rng(seed)
    n = WDL["n"]
    dense = rng.normal(size=(n, WDL["dense"])).astype(np.float32)
    codes = rng.integers(0, WDL["vocab"],
                         size=(n, WDL["wide"])).astype(np.int32)
    t = (dense[:, 0] + 0.1 * codes[:, 0] - 5
         + rng.normal(scale=2.0, size=n) > 0).astype(np.float32)
    return dense, codes, t, np.ones(n, dtype=np.float32)


def wdl_bench_cfg(wt):
    """bench.py bench_wdl's config: [100, 50] relu, ADAM 0.005, embed 8,
    valid 0.1, seed 1."""
    return wt.WDLTrainConfig(hidden=list(WDL["hidden"]),
                             embed_dim=WDL["embed"],
                             num_epochs=WDL["epochs"], valid_set_rate=0.1,
                             seed=1)


def wdl_state(results) -> bytes:
    """The weights and the three numbers of each result, as bytes."""
    from shifu_tpu_torch.models.wdl import flatten_wdl

    return b"".join(flatten_wdl(r.params).tobytes() + np.asarray(
        [r.train_error, r.valid_error, r.iterations]).tobytes()
        for r in results)


def synced(torch, fn, device):
    """(seconds, result) of fn(), synchronized on the card."""
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if device == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def gather_runs(torch, codes, device, runs=3) -> dict:
    """Whether the backward of each of the two gathers gives the same
    bits in `runs` runs on `device`, at bench WDL's first field (200,000
    indices into a [100, 8] table) and at the model's embedding gather
    (the 10 fields' tables stacked, 200,000 x 10 indices). The model
    gathers by indexing on the card and by `embedding` on the CPU
    (models/wdl.py); that one must, at both shapes."""
    rng = np.random.default_rng(5)
    v, e, f = WDL["vocab"], WDL["embed"], WDL["wide"]
    out = {}
    for shape, idx_np in (("field", codes[:, 0]),
                          ("stacked", codes + v * np.arange(f))):
        idx = torch.as_tensor(idx_np, device=device).long()
        rows = v if shape == "field" else v * f
        table = torch.as_tensor(rng.normal(size=(rows, e))
                                .astype(np.float32), device=device)
        up = torch.as_tensor(rng.normal(size=(*idx.shape, e))
                             .astype(np.float32), device=device)
        for name, fn in (("index", lambda t: t[idx]),
                         ("embedding",
                          lambda t: torch.nn.functional.embedding(idx, t))):
            grads = []
            for _ in range(runs):
                t = table.clone().requires_grad_(True)
                (grad,) = torch.autograd.grad((fn(t) * up).sum(), t)
                grads.append(grad)
            out[f"{name}_{shape}"] = all(torch.equal(grads[0], g)
                                         for g in grads[1:])
    used = "index" if device == "cuda" else "embedding"
    check(out[f"{used}_field"] and out[f"{used}_stacked"],
          f"wdl: the {used} gather's backward gave other bits from run to "
          f"run on {device}: {out}")
    return out


def gather_design_ms(torch, codes, device="cuda", reps=10) -> dict:
    """The embedding gather's forward and backward on the card at bench
    WDL's shape (200,000 rows x 10 fields into tables of [100, 8]), in
    two designs, by indexing: one gather a field (10 calls, 10 sorted
    backwards) against the model's one gather over the stacked tables
    (`_gather_fields`). Median ms of `reps` synchronized runs each."""
    from shifu_tpu_torch.models.wdl import _gather_fields

    rng = np.random.default_rng(6)
    v, e, f = WDL["vocab"], WDL["embed"], WDL["wide"]
    idx = torch.as_tensor(codes, device=device).long()
    tables = [torch.as_tensor(rng.normal(size=(v, e)).astype(np.float32),
                              device=device).requires_grad_(True)
              for _ in range(f)]
    up = torch.as_tensor(rng.normal(size=(*idx.shape, e))
                         .astype(np.float32), device=device)

    def per_field():
        out = torch.stack([t[idx[:, j]] for j, t in enumerate(tables)], 1)
        return torch.autograd.grad((out * up).sum(), tables)

    def stacked():
        return torch.autograd.grad(
            (_gather_fields(tables, idx) * up).sum(), tables)

    out = {}
    for name, fn in (("per_field", per_field), ("stacked", stacked)):
        fn()  # warm
        out[f"{name}_ms"] = float(np.median(
            [synced(torch, fn, device)[0] for _ in range(reps)])) * 1e3
    return out


def wdl_bench(torch, seed, device="cuda"):
    """(a) `train_wdl` at bench WDL: two card runs bit-equal (the second
    timed), a third under the profiler, the CPU run's valid error within
    NN_TOL with the same iterations; (b) `train_wdl_bagged` at the same
    shape with WDL_MEMBERS members, two card runs bit-equal."""
    from shifu_tpu_torch.train import wdl_trainer as wt

    host = wdl_bench_data(seed)
    gathers = gather_runs(torch, host[1], device)
    on_dev = tuple(torch.as_tensor(a, device=device) for a in host)
    vocab = [WDL["vocab"]] * WDL["wide"]
    cfg = wdl_bench_cfg(wt)
    n, epochs = host[0].shape[0], WDL["epochs"]

    def single(data, dev):
        return wt.train_wdl(*data, vocab, cfg, device=dev)

    runs = [synced(torch, lambda: single(on_dev, device), device)
            for _ in range(2)]
    check(wdl_state([runs[0][1]]) == wdl_state([runs[1][1]]),
          "wdl: two card runs of train_wdl gave other weights or errors")
    sec, res = runs[1]
    check(res.iterations == epochs and np.isfinite(res.valid_error)
          and 0.0 < res.valid_error < 0.25,
          f"wdl: {res.iterations} iterations, valid error "
          f"{res.valid_error}")
    out = dict(rows=n, dense=WDL["dense"], fields=WDL["wide"],
               vocab=WDL["vocab"], embed=WDL["embed"], hidden=WDL["hidden"],
               epochs=epochs, seconds=sec, first_seconds=runs[0][0],
               seconds_second=sec, row_epochs_per_s=n * epochs / sec,
               valid_error=res.valid_error, train_error=res.train_error,
               gather_backward_bit_equal=gathers,
               gather_design=(gather_design_ms(torch, host[1], device)
                              if device == "cuda" else None))
    out["profile"] = (profile_run(torch, lambda: single(on_dev, device), sec)
                      if device == "cuda" else dict(device_busy_s=None))
    cpu_s, cpu = synced(torch, lambda: single(host, "cpu"), "cpu")
    out.update(cpu_seconds=cpu_s, cpu_valid_error=cpu.valid_error,
               valid_error_diff_vs_cpu=abs(cpu.valid_error
                                           - res.valid_error))
    check(cpu.iterations == res.iterations
          and out["valid_error_diff_vs_cpu"] <= NN_TOL,
          f"wdl: the CPU run ({cpu.iterations} iterations, valid error "
          f"{cpu.valid_error}) differs from the card's past {NN_TOL}")

    def bagged():
        return wt.train_wdl_bagged(*on_dev, vocab, cfg, WDL_MEMBERS,
                                   device=device)

    bruns = [synced(torch, bagged, device) for _ in range(2)]
    check(wdl_state(bruns[0][1]) == wdl_state(bruns[1][1]),
          "wdl bagged: two card runs gave other weights or errors")
    bsec, members = bruns[1]
    check(len({wdl_state([m]) for m in members}) == WDL_MEMBERS
          and all(np.isfinite(m.valid_error) for m in members),
          "wdl bagged: members not distinct or errors not finite")
    out["bagged"] = dict(
        members=WDL_MEMBERS, seconds=bsec, first_seconds=bruns[0][0],
        member_row_epochs_per_s=n * epochs * WDL_MEMBERS / bsec,
        train_errors=[m.train_error for m in members],
        valid_errors=[m.valid_error for m in members],
        iterations=[m.iterations for m in members])
    return out


def cli_in(root, *args):
    """`python -m shifu_tpu_torch ARGS` in `root`, in this process: its
    seconds. A non-zero exit fails the phase."""
    from shifu_tpu_torch import cli

    cwd = os.getcwd()
    os.chdir(root)
    t0 = time.perf_counter()
    try:
        rc = cli.main(list(args))
    finally:
        os.chdir(cwd)
    check(rc == 0, f"{root}: shifu {' '.join(args)} exited {rc}")
    return time.perf_counter() - t0


def wdl_step_config(root):
    """`shifu train` WDL: [100, 50] relu, embed 8, ADAM at WDL_STEP's
    rate (5 full-batch epochs at 0.005 hardly leave the init), bagging 3."""
    from shifu_tpu_torch.config.model_config import Algorithm, ModelConfig
    from shifu_tpu_torch.fs.pathfinder import PathFinder

    path = PathFinder(root).model_config_path()
    mc = ModelConfig.load(path)
    mc.train.algorithm = Algorithm.WDL
    mc.train.params = {"NumHiddenNodes": list(WDL_STEP["hidden"]),
                       "ActivationFunc": ["relu", "relu"],
                       "EmbedOutputs": WDL_STEP["embed"],
                       "LearningRate": WDL_STEP["lr"], "Optimizer": "ADAM"}
    mc.train.bagging_num = WDL_STEP["bagging"]
    mc.train.num_train_epochs = WDL_STEP["epochs"]
    mc.save(path)


def wdl_step(torch, data_dir, device="cuda"):
    """(c) phase 7's raw set (phase 8's card2 copy, varsel reset so every
    column is a candidate again) switched to WDL: norm, then train
    through the CLI twice on the card (model files byte-identical) and
    once on the CPU (the headers equal but for the two errors, which
    agree within NN_TOL)."""
    from shifu_tpu_torch.fs.pathfinder import PathFinder
    from shifu_tpu_torch.models.wdl import WDLModelSpec
    from shifu_tpu_torch.norm.dataset import read_meta

    base = os.path.join(data_dir, "wdl-base")
    set_copy(os.path.join(data_dir, "raw-card2"), base)
    paths = PathFinder(base)
    # phase 8's RF model and its train files are not this step's
    shutil.rmtree(paths.models_dir())
    shutil.rmtree(paths.train_dir())
    dev = [] if device == "cuda" else ["--device", device]
    cli_in(base, "varsel", "-reset", *dev)
    wdl_step_config(base)
    norm_s = cli_in(base, "norm", *dev)
    check(len(read_meta(paths.cleaned_data_dir()).columns)
          == RAW["numeric"] + RAW["cat"],
          "wdl step: norm did not write every column")
    roots = {name: os.path.join(data_dir, f"wdl-{name}")
             for name in ("card1", "card2", "cpu")}
    secs, blobs, specs = {}, {}, {}
    for name, root in roots.items():
        set_copy(base, root)
        secs[name] = cli_in(root, "train",
                            *(["--device", "cpu"] if name == "cpu" else dev))
        mdir = PathFinder(root).models_dir()
        blobs[name] = {m: open(os.path.join(mdir, m), "rb").read()
                       for m in sorted(os.listdir(mdir))}
        specs[name] = [WDLModelSpec.load(os.path.join(mdir, m))
                       for m in sorted(blobs[name])]
    want = [f"model{i}.wdl" for i in range(WDL_STEP["bagging"])]
    check(sorted(blobs["card1"]) == want, f"wdl step: models "
          f"{sorted(blobs['card1'])}")
    check(blobs["card1"] == blobs["card2"],
          "wdl step: two card runs wrote other model bytes")
    diffs = []
    for a, b in zip(specs["card2"], specs["cpu"]):
        ha, hb = a.header(), b.header()
        for key in ("trainError", "validError"):
            diffs.append(abs(ha.pop(key) - hb.pop(key)))
        check(ha == hb, "wdl step: the CPU model header differs from the "
              "card's beyond the two errors")
    check(max(diffs) <= NN_TOL, f"wdl step: the CPU's errors differ from "
          f"the card's by {max(diffs)} > {NN_TOL}")
    spec = specs["card2"][0]
    rows = read_meta(paths.normalized_data_dir()).n_rows
    sec = secs["card2"]
    return dict(rows=rows, dense=len(spec.dense_columns),
                fields=len(spec.cat_columns), vocab=spec.vocab_sizes,
                hidden=WDL_STEP["hidden"], embed=WDL_STEP["embed"],
                bagging=WDL_STEP["bagging"], epochs=WDL_STEP["epochs"],
                norm_seconds=norm_s, seconds=sec, first_seconds=secs["card1"],
                cpu_seconds=secs["cpu"],
                member_row_epochs_per_s=(rows * WDL_STEP["epochs"]
                                         * WDL_STEP["bagging"] / sec),
                valid_errors=[s.valid_error for s in specs["card2"]],
                cpu_valid_errors=[s.valid_error for s in specs["cpu"]],
                max_error_diff_vs_cpu=max(diffs))


def wdl_serve(torch, data_dir, data, eval_scores, device="cuda"):
    """(e) the WDL set through ScoringServer over HTTP (the registry's
    ModelRunner fallback): held-out rows as JSON records, every request
    answered 200 with (d)'s scores for the same rows (within the score
    file's and the response's rounding). A correctness check: a few
    requests time nothing worth reporting."""
    import urllib.request

    from shifu_tpu_torch.serve.server import ScoringServer

    srv = ScoringServer(root=os.path.join(data_dir, "wdl-card2"), port=0,
                        replicas=1, device=device)
    reg = srv.registry
    check(not reg.fused and len(reg.model_names) == WDL_STEP["bagging"],
          "wdl serve: the WDL set was fused or lost models")
    cols = reg.input_columns
    check(all(f"cat_{j}" in cols for j in range(RAW["cat"])),
          f"wdl serve: the record schema lacks the categoricals: {cols}")
    n, per = WDL_SERVE["rows"], WDL_SERVE["per_request"]
    recs = [{c: data.raw[c][i] for c in cols} for i in range(n)]
    srv.start()
    got, codes = [], []
    try:
        for a in range(0, n, per):
            req = urllib.request.Request(
                f"http://127.0.0.1:{srv.port}/score",
                data=json.dumps({"records": recs[a:a + per]}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as r:
                codes.append(r.status)
                body = json.loads(r.read())
            got += [[s["mean"], s["max"], s["min"], s["median"], *s["models"]]
                    for s in body["scores"]]
    finally:
        srv.shutdown(60)
    check(codes == [200] * len(codes), f"wdl serve: answers {codes}")
    diff = float(np.abs(np.asarray(got) - eval_scores[:n]).max())
    # the score file rounds to 3 places, the response to 4; the forwards
    # ran on batches of other sizes
    check(diff <= 1e-3, f"wdl serve: scores differ from eval -run's by "
          f"{diff}")
    return dict(rows=n, requests=len(codes), columns=len(cols),
                max_diff_vs_eval=diff)


def wdl_convert(torch, data_dir, data, device="cuda"):
    """(f) `convert -toref` of (c)'s model0.wdl scored through the
    ModelRunner (a RefModelAdapter) against the native file; -tozip then
    -tobin of that `.wdl`, phase 9's `.nn` and phase 8's `.rf`
    byte-identical to the originals; -toeg of the `.nn` scored as EG text
    with the set's norm plan against the native `.nn`."""
    from shifu_tpu_torch.compat.adapters import RefModelAdapter
    from shifu_tpu_torch.config import load_column_config_list
    from shifu_tpu_torch.config.model_config import ModelConfig
    from shifu_tpu_torch.eval.scorer import ModelRunner
    from shifu_tpu_torch.fs.pathfinder import PathFinder

    out_dir = os.path.join(data_dir, "convert")
    os.makedirs(out_dir)
    roots = {"wdl": os.path.join(data_dir, "wdl-card2"),
             "nn": os.path.join(data_dir, "nn-card2"),
             "rf": os.path.join(data_dir, "raw-card2")}
    src = {k: PathFinder(r).model_path(0, k) for k, r in roots.items()}
    rows = _rows(data, data.names, 0, CONVERT_ROWS)
    out = dict(rows=rows.n_rows)

    def scored(path, root, ref_kind=None):
        paths = PathFinder(root)
        runner = ModelRunner(
            [path], device=device,
            column_configs=load_column_config_list(
                paths.column_config_path()),
            model_config=ModelConfig.load(paths.model_config_path()))
        if ref_kind is not None:
            check(isinstance(runner.specs[0], RefModelAdapter)
                  and runner.specs[0].kind == ref_kind,
                  f"convert: {path} did not load as {ref_kind}")
        return runner.score_raw(rows).model_scores[:, 0].astype(np.float64)

    for kind, flag, name in (("wdl", "-toref", "model0.wdl"),
                             ("nn", "-toeg", "model0.nn")):
        conv = os.path.join(out_dir, name)
        cli_in(roots[kind], "convert", flag, src[kind], conv)
        native = scored(src[kind], roots[kind])
        got = scored(conv, roots[kind],
                     "ref-wdl" if kind == "wdl" else "eg-nn")
        rel = float((np.abs(got - native)
                     / np.maximum(np.abs(native), 1e-3)).max())
        check(rel <= REF_RTOL, f"convert {flag}: the converted {kind} "
              f"scores differ from the native by {rel} relative")
        out[f"{kind}{flag}_max_rel_diff"] = rel
    for kind, path in src.items():
        js = os.path.join(out_dir, f"{kind}.json")
        back = os.path.join(out_dir, f"back.{kind}")
        cli_in(roots[kind], "convert", "-tozip", path, js)
        cli_in(roots[kind], "convert", "-tobin", js, back)
        check(open(back, "rb").read() == open(path, "rb").read(),
              f"convert: -tozip then -tobin of {path} changed its bytes")
    out["round_trips_byte_identical"] = sorted(src)
    return out


def phase_wdl(torch, data_dir, seed, device="cuda"):
    """Phase 13: (a)-(b) the trainer at bench WDL, (c) `shifu train` WDL,
    (d) posttrain + eval -run, (e) serving, (f) convert."""
    t0 = time.perf_counter()
    out = dict(bench=wdl_bench(torch, seed, device))
    print_wdl("bench", out["bench"])
    out["step"] = wdl_step(torch, data_dir, device)
    print_wdl("step", out["step"])
    base = os.path.join(data_dir, "eval-raw", "data")
    out["eval"] = eval_one(torch, "wdl", os.path.join(data_dir, "wdl-card2"),
                           data_dir, os.path.join(base, "data.txt"),
                           os.path.join(base, "header.txt"),
                           WDL_STEP["bagging"], device)
    print_eval("wdl", out["eval"])
    blob = open(os.path.join(data_dir, "eval-wdl-card2", "evals", EVAL_NAME,
                             "EvalScore.csv"), "rb").read()
    data = held_out(data_dir)
    out["serve"] = wdl_serve(torch, data_dir, data, _score_table(blob)[2],
                             device)
    print_wdl("serve", out["serve"])
    out["convert"] = wdl_convert(torch, data_dir, data, device)
    print_wdl("convert", out["convert"])
    out["seconds"] = time.perf_counter() - t0
    return out


def print_wdl(part, r):
    if part == "bench":
        b = r["bagged"]
        print(f"wdl: train_wdl bench WDL ({r['rows']} rows, {r['dense']} "
              f"dense, {r['fields']} fields of vocab {r['vocab']}, embed "
              f"{r['embed']}, {r['hidden']} relu, {r['epochs']} epochs): "
              f"{r['seconds']:.4f} s, {r['row_epochs_per_s']:.6g} "
              f"row-epochs/s (second card run; first {r['first_seconds']:.3f}"
              f" s), valid error {r['valid_error']:.6f}; two card runs "
              f"bit-equal; CPU {r['cpu_seconds']:.2f} s, valid error "
              f"{r['cpu_valid_error']:.6f} (diff "
              f"{r['valid_error_diff_vs_cpu']:.3g})")
        print_profile(r)
        g = r["gather_backward_bit_equal"]
        print("wdl gathers: backward bit-equal over 3 runs (one field; "
              f"the 10 stacked): indexing {g['index_field']}; "
              f"{g['index_stacked']}, embedding {g['embedding_field']}; "
              f"{g['embedding_stacked']} (the model gathers by indexing on"
              " the card, by embedding on the CPU)")
        gd = r["gather_design"]
        if gd is not None:
            print("wdl gather design: forward + backward at bench WDL's "
                  f"shape, one gather a field (10 calls) "
                  f"{gd['per_field_ms']:.4f} ms, one over the stacked "
                  f"tables {gd['stacked_ms']:.4f} ms (median of 10)")
        print(f"wdl bagged: {b['members']} members, {b['seconds']:.4f} s "
              f"({b['member_row_epochs_per_s']:.6g} member-row-epochs/s; "
              "second card run), two card runs bit-equal; valid errors "
              + ", ".join(f"{v:.6f}" for v in b["valid_errors"])
              + "; train errors "
              + ", ".join(f"{v:.6f}" for v in b["train_errors"]))
    elif part == "step":
        print(f"wdl step: shifu norm + train WDL {r['hidden']} relu, embed "
              f"{r['embed']}, bagging {r['bagging']}, {r['epochs']} epochs on"
              f" {r['rows']} rows ({r['dense']} dense, {r['fields']} fields "
              f"of {max(r['vocab'])} slots at most): norm "
              f"{r['norm_seconds']:.3f} s, train {r['seconds']:.3f} s "
              f"({r['member_row_epochs_per_s']:.6g} member-row-epochs/s; "
              "second card run); model files byte-identical across two card"
              f" runs; CPU train {r['cpu_seconds']:.2f} s, headers equal but"
              f" the errors, within {r['max_error_diff_vs_cpu']:.3g}")
    elif part == "serve":
        print(f"wdl serve: the WDL set through ScoringServer over HTTP "
              f"(ModelRunner fallback, {r['columns']} record columns), "
              f"{r['rows']} held-out rows in {r['requests']} JSON requests, "
              f"all 200; max |score - eval -run's| {r['max_diff_vs_eval']:.3g}")
    else:
        print(f"wdl convert: -toref of model0.wdl scored as ref-wdl on "
              f"{r['rows']} held-out rows, max relative diff vs native "
              f"{r['wdl-toref_max_rel_diff']:.3g}; -toeg of phase 9's "
              f"model0.nn scored as EG text, {r['nn-toeg_max_rel_diff']:.3g};"
              " -tozip then -tobin byte-identical for "
              + ", ".join(r["round_trips_byte_identical"]))


# ---------------------------------------------------------------------------
# phase 14: the streamed (larger-than-memory) lifecycle
# ---------------------------------------------------------------------------

STREAM_SHARDS = 8  # (a): CleanedData shards of each streamed forest
STREAM_LEAVES = 32  # (a): leaf-wise GBT
STREAM_CPU_TREES = 1  # (a): trees of the CPU streamed runs (time)
# (b): phase 7's raw rows sliced (the time limit), 4 chunks; the budgets
# below the data's size, so that every step streams
STREAM = dict(rows=100_000, chunk=25_000, eval_rows=50_000, ingest_mb=8,
              train_mb=4, nn_hidden=[50], nn_epochs=10, wdl_epochs=5)
# the in-memory forests of phases 3-5 on the card, for (a)
MEMORY_FORESTS: dict = {}


def counted_stream(torch, hk, tt, pst, fn, device="cuda"):
    """One counted streamed run: every count zeroed just before, read
    just after. (result, seconds, launches, plain calls, plain scan
    widths, hist_counters, htod)."""
    hk.reset_counters()
    reset_obs()
    for k in pst.htod:
        pst.htod[k] = 0
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    with PlainScans(tt) as ps:
        res = fn()
    if device == "cuda":
        torch.cuda.synchronize()
    return (res, time.perf_counter() - t0, dict(hk.launches),
            dict(hk.reference_calls), ps.widths, hist_counts(),
            dict(pst.htod))


def trees_equal(a, b) -> bool:
    """The trees of `a` bit-equal to the first trees of `b`."""
    from types import SimpleNamespace

    return len(a) <= len(b) and forests_equal(
        SimpleNamespace(trees=a), SimpleNamespace(trees=b[:len(a)]))


def stream_forest(torch, hk, tt, pds, pst, name, data, cfg, data_dir,
                  device="cuda"):
    """(a) one forest: the codes as 8 CleanedData shards, then
    `train_trees_streamed` on the card twice (bit-equal), launches as
    hist_counters and the shard count predict, one run profiled, and a
    CPU run of its first trees. (report, spec)."""
    codes, y, slots, is_cat = data
    n, F = codes.shape
    cols = [f"f{i}" for i in range(F)]
    out = os.path.join(data_dir, f"stream-{name}")
    pds.write_codes(out, codes, y.astype(np.int8), np.ones(n, np.float32),
                    cols, slots, n_shards=STREAM_SHARDS)

    def train(dev, c=cfg):
        return pst.train_trees_streamed(out, slots, is_cat, cols, c,
                                        device=dev)

    res, secs, launches, refs, plain, hc, htod = counted_stream(
        torch, hk, tt, pst, lambda: train(device), device)
    mc = "_mc" if cfg.n_classes >= 3 else ""
    if device == "cuda":
        check(all(v == 0 for v in refs.values()) and not plain,
              f"stream {name}: a plain version ran on the card: {refs}, "
              f"scans {plain}")
    else:  # a CPU rehearsal counts the plain versions' calls instead
        launches = refs
    trees = len(res.spec.trees)
    if cfg.max_leaves > 0:  # a histogram a built leaf a shard
        want_hist, want_scan = (STREAM_SHARDS * hc["built"],
                                hc["built"] + hc["derived"])
    else:  # every level one batch: a histogram a shard, one scan; the
        # final level's leaves are node totals where 2**depth nodes fit
        # a batch (the in-memory route's)
        depth = cfg.max_depth + int(2 ** cfg.max_depth > tt._node_batch_size(
            sum(slots), cfg.max_stats_memory_mb, cfg.n_classes))
        levels = trees * depth
        check(hc["built"] + hc["derived"] == trees * (2 ** depth - 1)
              and hc["fallback_rebuilds"] == 0,
              f"stream {name}: hist_counters {hc}")
        want_hist, want_scan = STREAM_SHARDS * levels, levels
    got = dict(hist=launches["hist_level" + mc],
               scan=launches["scan_level" + mc],
               fused=launches["fused_level"] + launches["fused_level_mc"])
    check(got == dict(hist=want_hist, scan=want_scan, fused=0),
          f"stream {name}: launches {got}, expected hist {want_hist}, "
          f"scan {want_scan}, fused 0")
    res2, secs2, _l, _r, _p, _h, htod2 = counted_stream(
        torch, hk, tt, pst, lambda: train(device), device)
    check(forests_equal(res.spec, res2.spec),
          f"stream {name}: a second card run gave another forest")
    prof = (profile_run(torch, lambda: train(device), secs2)
            if device == "cuda" else dict(device_busy_s=None))
    levels_run = htod2["copies"] / STREAM_SHARDS
    rep = dict(rows=n, shards=STREAM_SHARDS, trees=trees,
               depth=cfg.max_depth, leaves=cfg.max_leaves,
               seconds_first=secs, seconds_second=secs2,
               trees_per_s=trees / secs2, hist_counters=hc,
               htod_bytes_per_level=htod2["bytes"] / levels_run,
               htod_ms_per_level=1e3 * htod2["seconds"] / levels_run,
               htod_copies=htod2["copies"], launches=launches,
               valid_error=res.valid_error, profile=prof)
    if name in ("rf", "native"):  # integer planes: the CPU's bits too
        cpu_cfg = dataclasses.replace(cfg, tree_num=STREAM_CPU_TREES)
        t0 = time.perf_counter()
        cpu = train("cpu", cpu_cfg)
        rep["cpu_seconds"] = time.perf_counter() - t0
        check(trees_equal(cpu.spec.trees, res.spec.trees),
              f"stream {name}: the CPU run's {STREAM_CPU_TREES} trees "
              "differ from the card's")
    return rep, res.spec


def stream_trees(torch, hk, tt, pds, ptree, pst, data_dir, gbt, rf, seed,
                 device="cuda"):
    """(a) bench `gbt`, bench `rf`, NATIVE RF (phase 5's classes) and
    leaf-wise GBT, streamed from 8 shards."""
    out = {}
    gcfg = tt.TreeTrainConfig(algorithm="GBT", tree_num=GBT["trees"],
                              max_depth=GBT["depth"], learning_rate=0.1,
                              valid_set_rate=0.1, seed=3)
    rep, spec = stream_forest(torch, hk, tt, pds, pst, "gbt", gbt, gcfg,
                              data_dir, device)
    codes = gbt[0]
    score = ptree.IndependentTreeModel(spec, device=device).compute(codes)
    mem = ptree.IndependentTreeModel(MEMORY_FORESTS["gbt"],
                                     device=device).compute(codes)
    rep["max_score_diff_vs_memory"] = float(np.abs(score - mem).max())
    check(rep["max_score_diff_vs_memory"] <= GBT_SCORE_ATOL,
          f"stream gbt: scores {rep['max_score_diff_vs_memory']} from the "
          "in-memory card run's")
    out["gbt"] = rep

    rcfg = tt.TreeTrainConfig(algorithm="RF", tree_num=RF["trees"],
                              max_depth=RF["depth"],
                              feature_subset_strategy="TWOTHIRDS",
                              valid_set_rate=0.1, seed=3)
    rep, spec = stream_forest(torch, hk, tt, pds, pst, "rf", rf, rcfg,
                              data_dir, device)
    check(forests_equal(spec, MEMORY_FORESTS["rf"]),
          "stream rf: the forest differs from phase 4's in-memory one")
    out["rf"] = rep

    # NATIVE: phase 5's model set, its CleanedData and config
    from shifu_tpu_torch.config.model_config import ModelConfig
    from shifu_tpu_torch.fs.pathfinder import PathFinder

    paths = PathFinder(MEMORY_FORESTS["native"])
    meta, c16, tags, _w = pds.load_codes(paths.cleaned_data_dir())
    ncfg = tt.TreeTrainConfig.from_model_config(
        ModelConfig.load(paths.model_config_path()))
    rep, spec = stream_forest(
        torch, hk, tt, pds, pst, "native",
        (np.asarray(c16), np.asarray(tags), rf[2], rf[3]), ncfg, data_dir,
        device)
    mem = ptree.TreeModelSpec.load(paths.model_path(0, "rf"))
    check(forests_equal(spec, mem) and spec.valid_error == mem.valid_error,
          "stream native: the forest differs from phase 5's model file")
    out["native"] = rep

    lcfg = tt.TreeTrainConfig(algorithm="GBT", tree_num=GBT["trees"],
                              max_depth=GBT["depth"] + 4,
                              max_leaves=STREAM_LEAVES, learning_rate=0.1,
                              valid_set_rate=0.1, seed=3)
    rep, spec = stream_forest(torch, hk, tt, pds, pst, "leafwise_gbt", gbt,
                              lcfg, data_dir, device)
    memory = tt.train_trees(gbt[0], gbt[1], np.ones(len(gbt[1]), np.float32),
                            gbt[2], gbt[3], [f"f{i}" for i in range(
                                gbt[0].shape[1])], lcfg, device=device)
    score = ptree.IndependentTreeModel(spec, device=device).compute(codes)
    mem = ptree.IndependentTreeModel(memory.spec,
                                     device=device).compute(codes)
    rep["max_score_diff_vs_memory"] = float(np.abs(score - mem).max())
    check(rep["max_score_diff_vs_memory"] <= GBT_SCORE_ATOL,
          f"stream leaf-wise gbt: scores {rep['max_score_diff_vs_memory']} "
          "from the in-memory card run's")
    out["leafwise_gbt"] = rep
    return out


class stream_props:
    """The streaming knobs of (b): both budgets below the data's size,
    STREAM["chunk"] rows a chunk, and any extra properties; the previous
    values come back on exit."""

    def __init__(self, **extra):
        self.props = {
            "shifu.ingest.memoryBudgetMB": str(STREAM["ingest_mb"]),
            "shifu.train.memoryBudgetMB": str(STREAM["train_mb"]),
            "shifu.ingest.chunkRows": str(STREAM["chunk"]), **extra}

    def __enter__(self):
        from shifu_tpu_torch.utils import environment

        self.saved = {k: environment.get_property(k, "")
                      for k in self.props}
        for k, v in self.props.items():
            environment.set_property(k, v)

    def __exit__(self, *exc):
        from shifu_tpu_torch.utils import environment

        for k, v in self.saved.items():
            environment.set_property(k, v)


def _head_lines(src, dst, n):
    """The first n lines of the text file `src` into `dst`."""
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    with open(src) as fi, open(dst, "w") as fo:
        for _i, line in zip(range(n), fi):
            fo.write(line)


def stream_base(torch, data_dir, device):
    """(b)'s model set: phase 7's raw rows (their first STREAM["rows"]),
    without the weight column (unit weights keep the RF planes integers,
    so the streamed forest is the in-RAM one bit for bit; float weights
    round a shard at a time), initialized in RAM, RF 10 trees depth 8;
    the held-out slice of phase 10's file beside it. (base, held-out
    data, header)."""
    from shifu_tpu_torch.config.model_config import ModelConfig
    from shifu_tpu_torch.fs.pathfinder import PathFinder
    from shifu_tpu_torch.processor.init import InitProcessor

    src, base = os.path.join(data_dir, "raw"), os.path.join(data_dir,
                                                              "stream-base")
    os.makedirs(os.path.join(base, "data"))
    for rel in ("ModelConfig.json", "meta.names",
                os.path.join("data", "header.txt")):
        shutil.copy(os.path.join(src, rel), os.path.join(base, rel))
    _head_lines(os.path.join(src, "data", "data.txt"),
                os.path.join(base, "data", "data.txt"), STREAM["rows"])
    held = os.path.join(base, "heldout")
    ev = os.path.join(data_dir, "eval-raw", "data")
    _head_lines(os.path.join(ev, "data.txt"), os.path.join(held, "data.txt"),
                STREAM["eval_rows"])
    shutil.copy(os.path.join(ev, "header.txt"), held)
    path = PathFinder(base).model_config_path()
    mc = ModelConfig.load(path)
    mc.data_set.weight_column_name = ""
    mc.save(path)
    check(InitProcessor(base, device=device).run() == 0,
          "stream: init returned non-zero")
    mc = ModelConfig.load(path)
    mc.train.params.update(TreeNum=PREP["trees"], MaxDepth=PREP["depth"],
                           FeatureSubsetStrategy="TWOTHIRDS")
    mc.save(path)
    return base, os.path.join(held, "data.txt"), os.path.join(held,
                                                              "header.txt")


def _files(root, *rels):
    """The bytes of the files (and of the files in the directories)
    `rels` of `root`, by path."""
    out = {}
    for rel in rels:
        path = os.path.join(root, rel)
        names = (sorted(os.path.join(rel, n) for n in os.listdir(path))
                 if os.path.isdir(path) else [rel])
        for name in names:
            with open(os.path.join(root, name), "rb") as fh:
                out[name] = fh.read()
    return out


NORM_DIRS = (os.path.join("tmp", "norm", "NormalizedData"),
             os.path.join("tmp", "norm", "CleanedData"))
STATS_FILES = ("ColumnConfig.json", os.path.join("tmp", "stats",
                                                  "correlation.csv"))


def _timed(torch, device, fn):
    t0 = time.perf_counter()
    rc = fn()
    if device == "cuda":
        torch.cuda.synchronize()
    return rc, time.perf_counter() - t0


def _alg_copy(root, dst, config):
    """A copy of `root` (data linked) for another algorithm's train."""
    set_copy(root, dst)
    shutil.rmtree(os.path.join(dst, "models"), ignore_errors=True)
    config(dst)


def stream_chain(torch, hk, base, root, held, device, shuffle=False):
    """(b) on a copy of `base`: every step streamed — stats -correlation
    -psi, norm (and -shuffle into a copy), train RF, NN and WDL, eval
    -run of the RF set. The seconds of each step, the launches of the RF
    train, the artifacts' bytes."""
    from shifu_tpu_torch.processor.evaluate import EvalProcessor
    from shifu_tpu_torch.processor.norm import NormProcessor
    from shifu_tpu_torch.processor.stats import StatsProcessor
    from shifu_tpu_torch.processor.train import TrainProcessor

    set_copy(base, root)
    eval_config(root, *held)
    out = {}
    with stream_props():
        stats = StatsProcessor(root, correlation=True, psi=True,
                               device=device)
        rc, out["stats_seconds"] = _timed(torch, device, stats.run)
        check(rc == 0 and "pass2" in stats.timings,
              f"{root}: the streamed stats did not run")
        norm = NormProcessor(root, device=device)
        rc, out["norm_seconds"] = _timed(torch, device, norm.run)
        check(rc == 0 and "stream" in norm.timings,
              f"{root}: the streamed norm did not run")
        if shuffle:
            sroot = root + "-shuffle"
            set_copy(root, sroot)
            rc, out["shuffle_seconds"] = _timed(
                torch, device, NormProcessor(sroot, shuffle=True,
                                             device=device).run)
            check(rc == 0, f"{sroot}: norm -shuffle returned non-zero")
            out["shuffle"] = _files(sroot, *NORM_DIRS)
        hk.reset_counters()
        rc, out["train_seconds"] = _timed(
            torch, device, TrainProcessor(root, device=device).run)
        check(rc == 0, f"{root}: the streamed RF train returned {rc}")
        out["launches"] = dict(hk.launches)
        out["refs"] = dict(hk.reference_calls)
        roots = dict(nn=root + "-nn", wdl=root + "-wdl")
        _alg_copy(root, roots["nn"], lambda r: nn_step_config(
            r, STREAM["nn_hidden"], 1, STREAM["nn_epochs"]))
        out["nn_seconds"], nn_blobs, out["nn_errors"] = nn_step(
            torch, roots["nn"], device)
        _alg_copy(root, roots["wdl"], _wdl_stream_config)
        out["wdl_seconds"], wdl_blobs, out["wdl_errors"] = nn_step(
            torch, roots["wdl"], device)
        ev = EvalProcessor(root, run_name=EVAL_NAME, device=device)
        rc, out["eval_seconds"] = _timed(torch, device, ev.run)
        check(rc == 0, f"{root}: the streamed eval returned {rc}")
        out["eval_metrics"] = dict(ev.metrics[EVAL_NAME])
    score = os.path.join("evals", EVAL_NAME)
    out["bytes"] = {**_files(root, *STATS_FILES, *NORM_DIRS,
                             os.path.join("models", "model0.rf"),
                             os.path.join(score, "EvalScore.csv"),
                             os.path.join(score, "EvalPerformance.json")),
                    **{f"nn/{k}": v for k, v in nn_blobs.items()},
                    **{f"wdl/{k}": v for k, v in wdl_blobs.items()}}
    return out


def _wdl_stream_config(root):
    wdl_step_config(root)
    from shifu_tpu_torch.config.model_config import ModelConfig
    from shifu_tpu_torch.fs.pathfinder import PathFinder

    path = PathFinder(root).model_config_path()
    mc = ModelConfig.load(path)
    mc.train.bagging_num = 1
    mc.train.num_train_epochs = STREAM["wdl_epochs"]
    mc.save(path)


def stream_in_ram(torch, base, card1, held, device):
    """The in-RAM route on the same rows: stats on a copy of `base`;
    norm, train RF and eval -run on a copy of `card1` (the streamed
    stats' bins), whose model file must equal the streamed one."""
    from shifu_tpu_torch.processor.evaluate import EvalProcessor
    from shifu_tpu_torch.processor.norm import NormProcessor
    from shifu_tpu_torch.processor.stats import StatsProcessor
    from shifu_tpu_torch.processor.train import TrainProcessor

    sroot, root = base + "-ram", card1 + "-ram"
    set_copy(base, sroot)
    out = {}
    rc, out["stats_seconds"] = _timed(torch, device, StatsProcessor(
        sroot, correlation=True, psi=True, device=device).run)
    check(rc == 0, "stream: the in-RAM stats returned non-zero")
    set_copy(card1, root)
    for step, key in ((NormProcessor, "norm_seconds"),
                      (TrainProcessor, "train_seconds")):
        rc, out[key] = _timed(torch, device,
                              step(root, device=device).run)
        check(rc == 0, f"stream: the in-RAM {key} step returned {rc}")
    rc, out["eval_seconds"] = _timed(torch, device, EvalProcessor(
        root, run_name=EVAL_NAME, device=device).run)
    check(rc == 0, "stream: the in-RAM eval returned non-zero")
    model = os.path.join("models", "model0.rf")
    out["rf_model_equal"] = _files(root, model) == _files(card1, model)
    return out


def stream_cpu(torch, base, card1, held):
    """The CPU run: stats on a copy of `base` (phase 7's contract: the
    card's bytes but mean, stdDev and correlation within RAW_TOL); norm,
    NN and WDL on a copy of the card's set after its stats (phase 8's:
    the norm bytes equal; phase 9's: the valid error within NN_TOL, for
    WDL too); eval -run of the card's models (phase 10's: scores within
    0.001, AUC within 1e-6). The CPU RF train is left out (phase 8 only
    reports it)."""
    from shifu_tpu_torch.processor.evaluate import EvalProcessor
    from shifu_tpu_torch.processor.stats import StatsProcessor

    out = {}
    sroot = base + "-cpu"
    set_copy(base, sroot)
    with stream_props():
        rc, out["stats_seconds"] = _timed(torch, "cpu", StatsProcessor(
            sroot, correlation=True, psi=True, device="cpu").run)
    check(rc == 0, "stream cpu: stats returned non-zero")
    a, c = _files(card1, *STATS_FILES), _files(sroot, *STATS_FILES)
    bad = _close_but(json.loads(c["ColumnConfig.json"]),
                     json.loads(a["ColumnConfig.json"]), ("mean", "stdDev"))
    check(bad is None, f"stream cpu: ColumnConfig.json differs at {bad}")
    corr = os.path.join("tmp", "stats", "correlation.csv")
    (ha, ca), (hc, cc) = _corr_values(a[corr]), _corr_values(c[corr])
    check(ha == hc and np.allclose(ca, cc, **RAW_TOL),
          "stream cpu: the correlation differs past RAW_TOL")
    root = card1 + "-cpu"
    set_copy(card1, root)
    for d in ("models", "evals", os.path.join("tmp", "norm")):
        shutil.rmtree(os.path.join(root, d), ignore_errors=True)
    chain = stream_chain_tail(torch, root, "cpu")
    out.update(chain)
    card = _files(card1, *NORM_DIRS)
    check(_files(root, *NORM_DIRS) == card,
          "stream cpu: the norm wrote other bytes than the card's")
    for kind in ("nn", "wdl"):
        want = float(np.mean(_val_errors(card1 + f"-{kind}")))
        got = float(np.mean(chain[f"{kind}_errors"]))
        out[f"{kind}_valid_error_diff"] = abs(got - want)
        check(abs(got - want) <= NN_TOL,
              f"stream cpu: {kind} valid error {got} vs the card's {want}")
    eroot = card1 + "-cpu-eval"
    set_copy(card1, eroot)
    ev = EvalProcessor(eroot, run_name=EVAL_NAME, device="cpu")
    with stream_props():
        rc, out["eval_seconds"] = _timed(torch, "cpu", ev.run)
    check(rc == 0, "stream cpu: eval returned non-zero")
    score = os.path.join("evals", EVAL_NAME, "EvalScore.csv")
    (hk_, tk, sk), (hp, tp, sp) = (_score_table(_files(r, score)[score])
                                   for r in (card1, eroot))
    out["eval_max_score_diff"] = float(np.abs(sk - sp).max())
    check(hk_ == hp and np.array_equal(tk, tp)
          and out["eval_max_score_diff"] <= EVAL_TOL["score"] + 1e-9,
          "stream cpu: eval scores differ from the card's past 0.001")
    perf = os.path.join("evals", EVAL_NAME, "EvalPerformance.json")
    aucs = [json.loads(_files(r, perf)[perf])["areaUnderRoc"]
            for r in (card1, eroot)]
    check(abs(aucs[0] - aucs[1]) <= EVAL_TOL["auc"],
          f"stream cpu: AUC {aucs[1]} vs the card's {aucs[0]}")
    return out


def _val_errors(root):
    from shifu_tpu_torch.fs.pathfinder import PathFinder

    with open(PathFinder(root).val_error_path(0)) as fh:
        return [float(fh.read())]


def stream_chain_tail(torch, root, device):
    """norm, then train NN and WDL, streamed on `root` (the CPU run's
    part of the chain after stats)."""
    from shifu_tpu_torch.processor.norm import NormProcessor

    out = {}
    with stream_props():
        rc, out["norm_seconds"] = _timed(
            torch, device, NormProcessor(root, device=device).run)
        check(rc == 0, f"{root}: norm returned non-zero")
        for kind, config in (("nn", lambda r: nn_step_config(
                r, STREAM["nn_hidden"], 1, STREAM["nn_epochs"])),
                             ("wdl", _wdl_stream_config)):
            dst = root + f"-{kind}"
            _alg_copy(root, dst, config)
            secs, _b, errs = nn_step(torch, dst, device)
            out[f"{kind}_seconds"], out[f"{kind}_errors"] = secs, errs
    return out


def stream_resume(torch, card1, device):
    """(c): a streamed norm and a streamed eval stopped after a chunk by
    an exception from a hook this phase installs (the shard writer's
    add; the model runner's scoring), then resumed: the unbroken run's
    bytes."""
    from shifu_tpu_torch.eval.scorer import ModelRunner
    from shifu_tpu_torch.norm import dataset as pds_mod
    from shifu_tpu_torch.processor.evaluate import EvalProcessor
    from shifu_tpu_torch.processor.norm import NormProcessor

    def stopped(owner, name, at, fn):
        real, calls = getattr(owner, name), [0]

        def hook(*a, **k):
            calls[0] += 1
            if calls[0] == at:
                raise RuntimeError("stopped by the phase's hook")
            return real(*a, **k)

        setattr(owner, name, hook)
        try:
            fn()
        except RuntimeError as e:
            check("hook" in str(e), f"stream resume: {e}")
        else:
            check(False, "stream resume: the hook never fired")
        finally:
            setattr(owner, name, real)

    out = {}
    norm_root, eval_root = card1 + "-resume-norm", card1 + "-resume-eval"
    set_copy(card1, norm_root)
    shutil.rmtree(os.path.join(norm_root, "tmp", "norm"))
    set_copy(card1, eval_root)
    shutil.rmtree(os.path.join(eval_root, "evals", EVAL_NAME))
    every = {"shifu.ckpt.everyChunks": "1"}
    with stream_props(**every):
        # chunk 0's two shards written, the hook fires in chunk 1
        stopped(pds_mod.ShardWriter, "add", 3,
                lambda: NormProcessor(norm_root, device=device).run())
        stopped(ModelRunner, "score_raw", 2,
                lambda: EvalProcessor(eval_root, score_name=EVAL_NAME,
                                      device=device).run())
    with stream_props(**every, **{"shifu.resume": "true"}):
        rc, out["norm_resume_seconds"] = _timed(
            torch, device, NormProcessor(norm_root, device=device).run)
        check(rc == 0, "stream resume: norm --resume returned non-zero")
        rc, out["eval_resume_seconds"] = _timed(
            torch, device, EvalProcessor(
                eval_root, score_name=EVAL_NAME, device=device).run)
        check(rc == 0, "stream resume: eval --resume returned non-zero")
    check(_files(norm_root, *NORM_DIRS) == _files(card1, *NORM_DIRS),
          "stream resume: the resumed norm wrote other bytes")
    score = os.path.join("evals", EVAL_NAME, "EvalScore.csv")
    check(_files(eval_root, score) == _files(card1, score),
          "stream resume: the resumed eval wrote another score file")
    return out


def stream_lifecycle(torch, hk, data_dir, device="cuda"):
    """(b) and (c): the chain twice on the card (byte-identical
    artifacts), its RF model against the in-RAM route's, once on the CPU,
    the RF train profiled, then the resumes."""
    from shifu_tpu_torch.processor.train import TrainProcessor

    base, *held = stream_base(torch, data_dir, device)
    roots = {k: os.path.join(data_dir, f"stream-{k}")
             for k in ("card1", "card2")}
    runs = {k: stream_chain(torch, hk, base, r, held, device,
                            shuffle=True)
            for k, r in roots.items()}
    a, b = runs["card1"], runs["card2"]
    for key in a["bytes"]:
        check(a["bytes"][key] == b["bytes"][key],
              f"stream: two card runs wrote different {key}")
    check(a["shuffle"] == b["shuffle"],
          "stream: two card runs' norm -shuffle differ")
    calls = a["launches"] if device == "cuda" else a["refs"]
    check(calls["hist_level"] > 0 and calls["fused_level"] == 0
          and (device != "cuda" or not any(a["refs"].values())),
          f"stream: the RF train was not the streamed kernel path: "
          f"{a['launches']}, plain {a['refs']}")
    m = b["eval_metrics"]
    check(m["records"] == STREAM["eval_rows"] and 0.6 < m["auc"] <= 1.0,
          f"stream: eval metrics {m}")
    ram = stream_in_ram(torch, base, roots["card1"], held, device)
    check(ram["rf_model_equal"],
          "stream: the streamed RF model file differs from the in-RAM "
          "route's on the same bins")
    prof = dict(device_busy_s=None)
    if device == "cuda":
        with stream_props():
            prof = profile_run(torch, lambda: TrainProcessor(
                roots["card1"], device=device).run(), b["train_seconds"])
        check(_files(roots["card1"], os.path.join("models", "model0.rf"))
              == {os.path.join("models", "model0.rf"): a["bytes"][
                  os.path.join("models", "model0.rf")]},
              "stream: the profiled train rewrote another model")
    t0 = time.perf_counter()
    cpu = stream_cpu(torch, base, roots["card1"], held)
    cpu["seconds"] = time.perf_counter() - t0
    resume = stream_resume(torch, roots["card1"], device)
    n, ne = STREAM["rows"], STREAM["eval_rows"]
    rates = {step: (ne if step == "eval" else n) / b[f"{step}_seconds"]
             for step in ("stats", "norm", "train", "eval")}
    ram_rates = {step: (ne if step == "eval" else n) / ram[f"{step}_seconds"]
                 for step in ("stats", "norm", "train", "eval")}
    seconds = {k: v for k, v in b.items()
               if k not in ("bytes", "shuffle", "refs")}
    return dict(rows=n, eval_rows=ne, chunk=STREAM["chunk"],
                seconds=seconds, rows_per_s=rates, in_ram=ram,
                in_ram_rows_per_s=ram_rates, launches=a["launches"],
                seconds_second=b["train_seconds"], profile=prof, cpu=cpu,
                resume=resume)


def phase_stream(torch, hk, tt, pds, ptree, data_dir, gbt, rf, seed,
                 device="cuda"):
    """Phase 14: (a) the streamed growers, (b) the streamed lifecycle,
    (c) resume."""
    from shifu_tpu_torch.train import streaming_tree as pst

    t0 = time.perf_counter()
    out = dict(trees=stream_trees(torch, hk, tt, pds, ptree, pst, data_dir,
                                  gbt, rf, seed, device))
    for name, r in out["trees"].items():
        print_stream_forest(name, r)
    out["lifecycle"] = stream_lifecycle(torch, hk, data_dir, device)
    print_stream_lifecycle(out["lifecycle"])
    out["seconds"] = time.perf_counter() - t0
    print(f"stream: phase 14 in {out['seconds']:.1f} s")
    return out


def print_stream_forest(name, r):
    p = r["profile"]
    busy = ("not measured" if p.get("device_busy_s") is None else
            f"busy {p['device_busy_s']:.4f} s, idle share "
            f"{p['idle_share']:.3f}")
    print(f"stream {name}: {r['trees']} trees (depth {r['depth']}"
          + (f", {r['leaves']} leaves" if r["leaves"] > 0 else "")
          + f") on {r['rows']} rows in {r['shards']} shards: "
          f"{r['trees_per_s']:.3f} trees/s (second card run, "
          f"{r['seconds_second']:.4f} s), HtoD "
          f"{r['htod_bytes_per_level']:.0f} B and "
          f"{r['htod_ms_per_level']:.4f} ms a level; {busy}; launches "
          + str({k: v for k, v in r["launches"].items() if v})
          + (f"; max |score - in-memory| {r['max_score_diff_vs_memory']:.3g}"
             if "max_score_diff_vs_memory" in r else
             "; bit-equal to the in-memory card forest and the CPU's "
             f"first {STREAM_CPU_TREES} trees (CPU {r['cpu_seconds']:.2f} s)"))


def print_stream_lifecycle(lc):
    s, ram, p = lc["seconds"], lc["in_ram"], lc["profile"]
    busy = ("not measured" if p.get("device_busy_s") is None else
            f"busy {p['device_busy_s']:.4f} s, idle share "
            f"{p['idle_share']:.3f}")
    print(f"stream lifecycle: {lc['rows']} raw rows in chunks of "
          f"{lc['chunk']}, eval {lc['eval_rows']} rows; rows/s streamed "
          "(in RAM): " + ", ".join(
              f"{k} {lc['rows_per_s'][k]:.6g} ({lc['in_ram_rows_per_s'][k]:.6g})"
              for k in ("stats", "norm", "train", "eval"))
          + f"; NN {s['nn_seconds']:.3f} s, WDL {s['wdl_seconds']:.3f} s, "
          f"norm -shuffle {s['shuffle_seconds']:.3f} s; two card runs "
          "byte-identical, the RF model the in-RAM route's bytes; RF "
          f"train {busy}, launches "
          + str({k: v for k, v in lc["launches"].items() if v}))
    c = lc["cpu"]
    print(f"  CPU run {c['seconds']:.1f} s: stats {c['stats_seconds']:.2f} s,"
          f" norm {c['norm_seconds']:.2f} s (the card's bytes), NN / WDL "
          f"valid errors {c['nn_valid_error_diff']:.3g} / "
          f"{c['wdl_valid_error_diff']:.3g} apart, eval of the card's "
          f"models: max |score diff| {c['eval_max_score_diff']:.3g}")
    r = lc["resume"]
    print(f"  resume: norm {r['norm_resume_seconds']:.3f} s and eval "
          f"{r['eval_resume_seconds']:.3f} s after a stop, byte-identical")


# ---------------------------------------------------------------------------
# phase 15: data-parallel training over a device mesh
# ---------------------------------------------------------------------------

MESH_SHARDS = 4  # a virtual mesh: 4 row shards on cuda:0
MESH_WIDE_TREES = 2  # (b): host-batched gbt_wide trees
MESH_STREAM_TREES = 3  # (c): streamed RF trees, phase 14(a)'s first ones
NN_W_TOL = dict(rtol=2e-3, atol=2e-4)  # the CPU tests' meshed-vs-one bound
MESH_ERR_TOL = 1e-4  # valid error, meshed vs mesh=None


def mesh_run(torch, hk, tt, fn, device="cuda"):
    """One counted meshed run: counts zeroed just before, read just
    after. (result, seconds, launches, plain calls, plain scan widths)."""
    hk.reset_counters()
    reset_obs()
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    with PlainScans(tt) as ps:
        res = fn()
    if device == "cuda":
        torch.cuda.synchronize()
    return (res, time.perf_counter() - t0, dict(hk.launches),
            dict(hk.reference_calls), list(ps.widths))


def mesh_forest(torch, hk, tt, name, fn, want_hist, want_scan, mc,
                device="cuda", wide=()):
    """A meshed grower twice (bit-equal forests, the second timed), its
    launches as the level plan gives them (`want_hist` histograms, S a
    level, `want_scan` scans, no fused entry), no plain version, and one
    more run profiled. A CPU rehearsal counts the plain versions' calls
    instead of launches."""
    res, secs, launches, refs, plain = mesh_run(torch, hk, tt, fn, device)
    if device == "cuda":
        check(not any(refs.values()),
              f"mesh {name}: a plain version ran on the card: {refs}")
        check(all(w in wide for w in plain),
              f"mesh {name}: the plain torch scan ran on the card: {plain}")
    else:
        launches = refs
    got = dict(hist=launches["hist_level" + mc],
               scan=launches["scan_level" + mc],
               fused=launches["fused_level"] + launches["fused_level_mc"])
    check(got == dict(hist=want_hist, scan=want_scan, fused=0),
          f"mesh {name}: launches {got}, expected hist {want_hist}, scan "
          f"{want_scan}, fused 0")
    res2, secs2, _l, _r, _p = mesh_run(torch, hk, tt, fn, device)
    spec = res.spec
    check(forests_equal(spec, res2.spec),
          f"mesh {name}: two meshed runs gave other forests")
    prof = (profile_run(torch, fn, secs2) if device == "cuda"
            else dict(device_busy_s=None))
    return spec, dict(trees=len(spec.trees), seconds_first=secs,
                      seconds_second=secs2,
                      trees_per_s=len(spec.trees) / secs2,
                      launches=launches, profile=prof)


def merge_ms(torch, hk, tt, data, L, lowp, K=0, device="cuda"):
    """The merge of one level on the mesh: MESH_SHARDS `hist_level_acc`
    parts of `data`'s rows (L nodes) added by `merge_acc`, ms (CUDA
    events; None on the CPU), and the planes against one call over
    every row (on the CPU the parts are the fixed-point plain version's,
    and the whole the plain `hist_level_fixed_reference`)."""
    codes, y, slots, is_cat = data
    lay = tt.make_layout(slots, is_cat)
    n = codes.shape[0]
    rng = np.random.default_rng(L)
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    lab = (y if K < 3 else codes[:, 0] % K).astype(np.float32)
    cols = (t(codes.astype(np.int32)), t(lab), t(np.ones(n, np.float32)),
            t(rng.integers(0, L, size=n).astype(np.int32)),
            t(rng.random(n) < 0.9))
    b = n // MESH_SHARDS
    kw = dict(L=L, lay=lay, low_precision=lowp, n_classes=K)
    if device == "cuda":
        acc_of, whole_of = hk.hist_level_acc, hk.hist_level
    else:
        def acc_of(*c, **k):
            return (*hk.fixed_acc_reference(*c, **k), c[0].shape[0])

        whole_of = hk.hist_level_fixed_reference
    parts = [acc_of(*(c[s * b:(s + 1) * b].contiguous() for c in cols),
                    **kw) for s in range(MESH_SHARDS)]
    check(torch.equal(hk.merge_acc(parts), whole_of(*cols, **kw)),
          f"mesh merge L={L}: the merged planes differ from one call's")
    if device != "cuda":
        return None
    return time_ms(torch, lambda: hk.merge_acc(parts))


def _rows_of(pds, root):
    meta, c16, tags, wts = pds.load_codes(root)
    return c16, tags, wts, meta.extra["slots"], meta.columns


def mesh_trees(torch, hk, tt, pds, ptree, data_dir, mesh, gbt, rf,
               device="cuda"):
    """(a) bench gbt, rf and NATIVE RF on the mesh against phases 3-5's
    mesh=None forests."""
    from shifu_tpu_torch.config.model_config import ModelConfig
    from shifu_tpu_torch.fs.pathfinder import PathFinder

    out = {}
    S = MESH_SHARDS
    gcfg = tt.TreeTrainConfig(algorithm="GBT", tree_num=GBT["trees"],
                              max_depth=GBT["depth"], learning_rate=0.1,
                              valid_set_rate=0.1, seed=3)
    rcfg = tt.TreeTrainConfig(algorithm="RF", tree_num=RF["trees"],
                              max_depth=RF["depth"],
                              feature_subset_strategy="TWOTHIRDS",
                              valid_set_rate=0.1, seed=3)
    paths = PathFinder(MEMORY_FORESTS["native"])
    ncfg = tt.TreeTrainConfig.from_model_config(
        ModelConfig.load(paths.model_config_path()))
    cases = (("gbt", os.path.join(data_dir, "gbt"), gcfg, gbt[3]),
             ("rf", os.path.join(data_dir, "rf"), rcfg, rf[3]),
             ("native", paths.cleaned_data_dir(), ncfg, rf[3]))
    for name, root, cfg, is_cat in cases:
        c16, tags, wts, slots, cols = _rows_of(pds, root)
        levels = cfg.tree_num * cfg.max_depth  # leaf totals at the last

        def fn(c=c16, t=tags, w=wts, s=slots, ic=is_cat, cl=cols, g=cfg):
            return tt.train_trees(c, t, w, s, ic, cl, g, mesh=mesh)

        mc = "_mc" if cfg.n_classes >= 3 else ""
        spec, rep = mesh_forest(torch, hk, tt, name, fn, S * levels, levels,
                                mc, device)
        ref = (ptree.TreeModelSpec.load(paths.model_path(0, "rf"))
               if name == "native" else MEMORY_FORESTS[name])
        if name == "gbt":
            score = ptree.IndependentTreeModel(spec, device=device).compute(
                c16)
            mem = ptree.IndependentTreeModel(ref, device=device).compute(c16)
            rep["max_score_diff_vs_one_device"] = float(
                np.abs(score - mem).max())
            check(rep["max_score_diff_vs_one_device"] <= GBT_SCORE_ATOL,
                  f"mesh gbt: scores {rep['max_score_diff_vs_one_device']}"
                  " from the mesh=None forest's")
            rep["forest_bit_equal_to_one_device"] = forests_equal(spec, ref)
        else:
            check(forests_equal(spec, ref),
                  f"mesh {name}: the forest differs from the mesh=None one")
        rep["merge_ms_a_level"] = merge_ms(
            torch, hk, tt, (np.asarray(c16), np.asarray(tags), slots,
                            is_cat),
            2 ** (cfg.max_depth - 2), name == "gbt", cfg.n_classes, device)
        out[name] = rep
        print_mesh_forest(name, rep)
    return out


def mesh_batched(torch, hk, tt, ptree, mesh, seed, device="cuda"):
    """(b) the host-batched grower at bench gbt_wide (depth 12) on the
    mesh, bit-equal to the same call with mesh=None."""
    wide = growers_data(seed)
    lay_w = tt.make_layout(wide[2], wide[3])
    cap = tt._node_batch_size(lay_w.T, 256)
    cfg = tt.TreeTrainConfig(algorithm="GBT", tree_num=MESH_WIDE_TREES,
                             max_depth=BATCHED_GBT["depth"],
                             learning_rate=0.1, valid_set_rate=0.1, seed=3)
    check(2 ** cfg.max_depth > cap, "mesh batched: the depth fits a batch")
    codes, y, slots, is_cat = wide
    n = codes.shape[0]
    args_ = (codes, y, np.ones(n, np.float32), slots, is_cat,
             [f"f{i}" for i in range(codes.shape[1])])
    t0 = time.perf_counter()
    one = tt.train_trees(*args_, cfg, device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    calls = batched_plan(tt, cfg, cap)[0] * cfg.tree_num
    spec, rep = mesh_forest(
        torch, hk, tt, "batched_gbt",
        lambda: tt.train_trees(*args_, cfg, mesh=mesh),
        MESH_SHARDS * calls, calls, "", device, wide=(WIDE["wide_cat"] + 1,))
    check(forests_equal(spec, one.spec),
          "mesh batched_gbt: the forest differs from the mesh=None one")
    rep["one_device_seconds"] = one_s
    print_mesh_forest("batched_gbt", rep)
    return rep


def mesh_streamed(torch, hk, tt, mesh, data_dir, rf, device="cuda"):
    """(c) phase 14(a)'s 8 CleanedData shards of bench rf streamed on
    the mesh: each file shard's rows split over the mesh's shards, one
    merge a level; the first trees bit-equal to phase 14(a)'s forest
    (which is phase 4's)."""
    from shifu_tpu_torch.train import streaming_tree as pst

    cfg = tt.TreeTrainConfig(algorithm="RF", tree_num=MESH_STREAM_TREES,
                             max_depth=RF["depth"],
                             feature_subset_strategy="TWOTHIRDS",
                             valid_set_rate=0.1, seed=3)
    out = os.path.join(data_dir, "stream-rf")
    cols = [f"f{i}" for i in range(len(rf[2]))]
    levels = cfg.tree_num * cfg.max_depth
    spec, rep = mesh_forest(
        torch, hk, tt, "streamed_rf",
        lambda: pst.train_trees_streamed(out, rf[2], rf[3], cols, cfg,
                                         mesh=mesh),
        STREAM_SHARDS * MESH_SHARDS * levels, levels, "", device)
    check(trees_equal(spec.trees, MEMORY_FORESTS["rf"].trees),
          "mesh streamed_rf: the trees differ from phase 14(a)'s")
    print_mesh_forest("streamed_rf", rep)
    return rep


def _nn_diff(nt, a, b) -> float:
    fa = np.concatenate([np.concatenate([p["W"].ravel(), p["b"].ravel()])
                         for p in a.params])
    fb = np.concatenate([np.concatenate([p["W"].ravel(), p["b"].ravel()])
                         for p in b.params])
    return float(np.abs(fa - fb).max())


def mesh_nets(torch, mesh, seed, device="cuda"):
    """(d) bench SMALL (f32) and bench WDL on the mesh: two meshed runs
    bit-equal (the second timed), the same iterations as mesh=None and
    valid errors within MESH_ERR_TOL; the weights' largest difference
    from mesh=None printed."""
    from shifu_tpu_torch.models.wdl import flatten_wdl
    from shifu_tpu_torch.train import nn_trainer as nt
    from shifu_tpu_torch.train import wdl_trainer as wt

    out = {}
    host = nn_bench_data(SMALL)
    on_dev = tuple(torch.as_tensor(a, device=device) for a in host)
    cfg = nn_bench_cfg(nt, SMALL, False)
    one_s, one = synced(torch, lambda: nt.train_nn(*on_dev, cfg,
                                                   device=device), device)
    runs = [synced(torch, lambda: nt.train_nn(*on_dev, cfg, mesh=mesh),
                   device) for _ in range(2)]
    check(nn_flat_bytes(runs[0][1].params) == nn_flat_bytes(runs[1][1].params),
          "mesh small: two meshed runs gave other weights")
    sec, res = runs[1]
    row_epochs = SMALL["n"] * SMALL["epochs"]
    flops = row_epochs * mlp_flops_per_row_epoch(SMALL["d"], SMALL["hidden"])
    out["small"] = dict(
        seconds=sec, one_device_seconds=one_s,
        row_epochs_per_s=row_epochs / sec,
        one_device_row_epochs_per_s=row_epochs / one_s,
        tflops=flops / sec / 1e12, iterations=res.iterations,
        valid_error=res.valid_error, one_device_valid_error=one.valid_error,
        max_weight_diff=_nn_diff(nt, res, one),
        profile=(profile_run(torch, lambda: nt.train_nn(*on_dev, cfg,
                                                        mesh=mesh), sec)
                 if device == "cuda" else dict(device_busy_s=None)))
    check(res.iterations == one.iterations
          and abs(res.valid_error - one.valid_error) <= MESH_ERR_TOL,
          f"mesh small: {res.iterations} iterations, valid error "
          f"{res.valid_error} against mesh=None's {one.iterations}, "
          f"{one.valid_error}")

    host = wdl_bench_data(seed)
    on_dev = tuple(torch.as_tensor(a, device=device) for a in host)
    vocab = [WDL["vocab"]] * WDL["wide"]
    wcfg = wdl_bench_cfg(wt)
    one_s, one = synced(torch, lambda: wt.train_wdl(*on_dev, vocab, wcfg,
                                                    device=device), device)
    runs = [synced(torch, lambda: wt.train_wdl(*on_dev, vocab, wcfg,
                                               mesh=mesh), device)
            for _ in range(2)]
    check(wdl_state([runs[0][1]]) == wdl_state([runs[1][1]]),
          "mesh wdl: two meshed runs gave other weights or errors")
    sec, res = runs[1]
    n = host[0].shape[0]
    out["wdl"] = dict(
        seconds=sec, one_device_seconds=one_s,
        row_epochs_per_s=n * WDL["epochs"] / sec,
        one_device_row_epochs_per_s=n * WDL["epochs"] / one_s,
        iterations=res.iterations, valid_error=res.valid_error,
        one_device_valid_error=one.valid_error,
        max_weight_diff=float(np.abs(flatten_wdl(res.params)
                                     - flatten_wdl(one.params)).max()))
    check(res.iterations == one.iterations
          and abs(res.valid_error - one.valid_error) <= MESH_ERR_TOL,
          f"mesh wdl: {res.iterations} iterations, valid error "
          f"{res.valid_error} against mesh=None's {one.iterations}, "
          f"{one.valid_error}")
    return out


# ColumnConfig fields the folds give alike at any shard count: integer
# counts and extrema (the device fold's int64 counts, f32 extrema)
FOLD_EXACT = ("totalCount", "missingCount", "min", "max")


def fold_diff(want: dict, got: dict) -> dict:
    """Where two ColumnConfig.json blobs of one set differ, by kind: the
    columns whose stats or bins differ at all, the numeric columns whose
    boundaries differ, and the gated differences (categorical columns,
    FOLD_EXACT fields, the bins' total positive and negative counts)."""
    out = dict(columns=[], boundaries=[], gated=[])
    for w, g in zip(json.loads(want), json.loads(got)):
        name = w["columnName"]
        if w != g:
            out["columns"].append(name)
        wb, gb = w.get("columnBinning") or {}, g.get("columnBinning") or {}
        ws, gs = w.get("columnStats") or {}, g.get("columnStats") or {}
        if wb.get("binBoundary") != gb.get("binBoundary"):
            out["boundaries"].append(name)
        if wb.get("binCategory") is not None and (wb != gb or ws != gs):
            out["gated"].append(f"{name} (categorical)")
        for k in FOLD_EXACT:
            if ws.get(k) != gs.get(k):
                out["gated"].append(f"{name}.{k}")
        for k in ("binCountPos", "binCountNeg"):
            if sum(wb.get(k) or []) != sum(gb.get(k) or []):
                out["gated"].append(f"{name}.sum({k})")
    return out


def mesh_folds(torch, data_dir, device="cuda"):
    """(e) phase 14(b)'s streamed stats -correlation -psi and norm on its
    model set at shifu.lifecycle.shards=4 (the device fold a state a
    shard, merged in shard order) and at 1. Gated: the categorical
    columns' stats and bins, every column's counts and extrema and its
    bins' total counts, alike. Reported: the files that differ and the
    numeric columns whose boundaries differ (pass 1 merges the shards'
    numeric sketches in shard order, an approximate merge)."""
    from shifu_tpu_torch.processor.norm import NormProcessor
    from shifu_tpu_torch.processor.stats import StatsProcessor

    base = os.path.join(data_dir, "stream-base")
    out, blobs = {}, {}
    for S in (MESH_SHARDS, 1):
        root = os.path.join(data_dir, f"stream-mesh{S}")
        set_copy(base, root)
        with stream_props(**{"shifu.lifecycle.shards": str(S)}):
            rc, out[f"stats_seconds_{S}"] = _timed(
                torch, device, StatsProcessor(root, correlation=True,
                                              psi=True, device=device).run)
            check(rc == 0, f"mesh folds: stats at S = {S} returned {rc}")
            rc, out[f"norm_seconds_{S}"] = _timed(
                torch, device, NormProcessor(root, device=device).run)
            check(rc == 0, f"mesh folds: norm at S = {S} returned {rc}")
        blobs[S] = _files(root, *STATS_FILES, *NORM_DIRS)
    got, want = blobs[MESH_SHARDS], blobs[1]
    out["files"] = len(want)
    out["files_differing"] = sorted(k for k in set(want) | set(got)
                                    if got.get(k) != want.get(k))
    diff = fold_diff(want["ColumnConfig.json"], got["ColumnConfig.json"])
    check(not diff["gated"], f"mesh folds: S = {MESH_SHARDS} and S = 1 "
          f"differ in {diff['gated']}")
    out.update(columns_differing=diff["columns"],
               boundaries_differing=diff["boundaries"])
    return out


def mesh_cards(torch, hk, tt, pds, data_dir, rf):
    """(f) over the real cards, where there are more than one: the
    kernel entries on cuda:1 with cuda:0 current against their plain
    versions, bench rf meshed bit-equal to phase 4's forest, SMALL's
    valid error within MESH_ERR_TOL of mesh=None. None on one card."""
    from shifu_tpu_torch.parallel.mesh import data_mesh
    from shifu_tpu_torch.train import nn_trainer as nt

    count = torch.cuda.device_count()
    if count < 2:
        return None
    d1 = torch.device("cuda", 1)
    codes, y, slots, is_cat = rf
    lay = tt.make_layout(slots, is_cat)
    n, L = 100_000, 64
    rng = np.random.default_rng(64)
    t = lambda a: torch.as_tensor(a, device=d1)  # noqa: E731
    cols = (t(codes[:n]), t(y[:n]), t(np.ones(n, np.float32)),
            t(rng.integers(0, L, size=n).astype(np.int32)),
            t(rng.random(n) < 0.9))
    fok = torch.ones(lay.T, dtype=torch.bool, device=d1)
    skw = dict(impurity="variance", min_inst=5, min_gain=0.0)
    with torch.cuda.device(0):
        h = hk.hist_level(*cols, L=L, lay=lay,
                          codes8=hk.codes8_of(cols[0], lay))
        scan = hk.scan_level(h, fok, lay=lay, **skw)
    plain = hk.hist_level_reference(*cols, L=L, lay=lay)
    want = tt.split_scan(plain, fok, tt.scan_layout(lay, d1),
                         skw["impurity"], skw["min_inst"], skw["min_gain"])
    check(torch.equal(h, plain)
          and all(torch.equal(a, b) for a, b in zip(scan, want)),
          "mesh cards: the entries on cuda:1 differ from the plain versions")
    mesh = data_mesh()
    c16, tags, wts, slots_, cols_ = _rows_of(pds, os.path.join(data_dir,
                                                               "rf"))
    rcfg = tt.TreeTrainConfig(algorithm="RF", tree_num=RF["trees"],
                              max_depth=RF["depth"],
                              feature_subset_strategy="TWOTHIRDS",
                              valid_set_rate=0.1, seed=3)
    res, secs, launches, refs, _p = mesh_run(
        torch, hk, tt, lambda: tt.train_trees(c16, tags, wts, slots_,
                                              is_cat, cols_, rcfg,
                                              mesh=mesh))
    check(forests_equal(res.spec, MEMORY_FORESTS["rf"]),
          f"mesh cards: rf over {count} cards differs from phase 4's")
    host = nn_bench_data(SMALL)
    cfg = nn_bench_cfg(nt, SMALL, False)
    one = nt.train_nn(*host, cfg, device="cuda")
    s_secs, got = synced(torch, lambda: nt.train_nn(*host, cfg, mesh=mesh),
                         "cuda")
    check(got.iterations == one.iterations
          and abs(got.valid_error - one.valid_error) <= MESH_ERR_TOL,
          f"mesh cards: SMALL over {count} cards: valid error "
          f"{got.valid_error} against {one.valid_error}")
    return dict(cards=count, rf_seconds=secs,
                rf_trees_per_s=RF["trees"] / secs, rf_launches=launches,
                small_seconds=s_secs,
                small_row_epochs_per_s=SMALL["n"] * SMALL["epochs"] / s_secs)


def phase_mesh(torch, hk, tt, pds, ptree, data_dir, gbt, rf, seed,
               device="cuda"):
    """Phase 15: (a)-(e) on a virtual mesh of MESH_SHARDS shards on
    cuda:0 (on the CPU for a rehearsal), (f) over the real cards where
    there are several."""
    from shifu_tpu_torch.parallel.mesh import data_mesh

    t0 = time.perf_counter()
    mesh = data_mesh(virtual=MESH_SHARDS, device=device)
    out = dict(shards=MESH_SHARDS)
    out["trees"] = mesh_trees(torch, hk, tt, pds, ptree, data_dir, mesh,
                              gbt, rf, device)
    out["batched_gbt"] = mesh_batched(torch, hk, tt, ptree, mesh, seed,
                                      device)
    out["streamed_rf"] = mesh_streamed(torch, hk, tt, mesh, data_dir, rf,
                                       device)
    out["nets"] = mesh_nets(torch, mesh, seed, device)
    print_mesh_nets(out["nets"])
    out["folds"] = f = mesh_folds(torch, data_dir, device)
    print(f"mesh folds: streamed stats -correlation -psi "
          f"{f[f'stats_seconds_{MESH_SHARDS}']:.3f} s and norm "
          f"{f[f'norm_seconds_{MESH_SHARDS}']:.3f} s at {MESH_SHARDS} "
          f"shards ({f['stats_seconds_1']:.3f} s, {f['norm_seconds_1']:.3f}"
          f" s at 1); counts, extrema and categorical columns alike; "
          f"{f['files'] - len(f['files_differing'])} of {f['files']} files "
          f"byte-identical (differing: {f['files_differing']}); numeric "
          f"boundaries differ in {len(f['boundaries_differing'])} columns "
          f"{f['boundaries_differing']}, stats or bins in "
          f"{len(f['columns_differing'])}")
    out["cards"] = c = (mesh_cards(torch, hk, tt, pds, data_dir, rf)
                        if device == "cuda" else None)
    if c is None:
        print("mesh cards: one card, so the real-card mesh (f) and the "
              "current-device check on cuda:1 did not run")
    else:
        print(f"mesh cards: {c['cards']} cards: the entries on cuda:1 with "
              f"cuda:0 current equal the plain versions; rf "
              f"{c['rf_trees_per_s']:.3f} trees/s bit-equal to phase 4, "
              f"SMALL {c['small_row_epochs_per_s']:.6g} row-epochs/s")
    out["launches"] = ([r["launches"] for r in out["trees"].values()]
                       + [out["batched_gbt"]["launches"],
                          out["streamed_rf"]["launches"]])
    out["seconds"] = time.perf_counter() - t0
    print(f"mesh: phase 15 in {out['seconds']:.1f} s")
    return out


def print_mesh_forest(name, r):
    p = r["profile"]
    busy = ("not measured" if p.get("device_busy_s") is None else
            f"busy {p['device_busy_s']:.4f} s, idle share "
            f"{p['idle_share']:.3f}")
    extra = ""
    if "max_score_diff_vs_one_device" in r:
        extra = (f"; max |score - mesh=None| "
                 f"{r['max_score_diff_vs_one_device']:.3g} (forest bit-"
                 f"equal: {r['forest_bit_equal_to_one_device']})")
    elif name == "streamed_rf":
        extra = "; bit-equal to phase 14(a)'s first trees"
    else:
        extra = "; bit-equal to the mesh=None forest"
    if r.get("merge_ms_a_level") is not None:
        extra += f"; merge {r['merge_ms_a_level']:.4f} ms a level"
    print(f"mesh {name}: {r['trees']} trees on {MESH_SHARDS} shards: "
          f"{r['trees_per_s']:.3f} trees/s (second meshed run, "
          f"{r['seconds_second']:.4f} s), two runs bit-equal; {busy}; "
          "launches " + str({k: v for k, v in r["launches"].items() if v})
          + extra)


def print_mesh_nets(n):
    s, w = n["small"], n["wdl"]
    p = s["profile"]
    busy = ("not measured" if p.get("device_busy_s") is None else
            f"busy {p['device_busy_s']:.4f} s, idle share "
            f"{p['idle_share']:.3f}")
    print(f"mesh small: f32 on {MESH_SHARDS} shards {s['seconds']:.4f} s, "
          f"{s['row_epochs_per_s']:.6g} row-epochs/s, {s['tflops']:.4g} "
          f"TFLOP/s (mesh=None {s['one_device_seconds']:.4f} s, "
          f"{s['one_device_row_epochs_per_s']:.6g}); valid error "
          f"{s['valid_error']:.6f} (mesh=None {s['one_device_valid_error']:.6f}"
          f"), max |dw| {s['max_weight_diff']:.3g}; {busy}")
    print(f"mesh wdl: {MESH_SHARDS} shards {w['seconds']:.4f} s, "
          f"{w['row_epochs_per_s']:.6g} row-epochs/s (mesh=None "
          f"{w['one_device_seconds']:.4f} s, "
          f"{w['one_device_row_epochs_per_s']:.6g}); valid error "
          f"{w['valid_error']:.6f} (mesh=None {w['one_device_valid_error']:.6f}"
          f"), max |dw| {w['max_weight_diff']:.3g}")


# ---------------------------------------------------------------------------
# phase 16: more than one host, and the chaos seams
# ---------------------------------------------------------------------------

HOSTS = dict(n=100_000, chunks=16, numeric=20, cat=10, wait_ms=60_000,
             chaos_rows=50_000, chaos_chunks=4, nn_epochs=8,
             kill_epochs=200, kill_every=5, serve_rows=256)
HOST_FILES = ("ColumnConfig.json",
              os.path.join("tmp", "autotype", "count_info.json"))


def write_host_set(root, seed, n=None):
    """(a)'s raw set at the bench `rf` width, integral: a 0/1 target,
    unit weights (no weight column), 20 integer-valued numeric columns
    with 2% "?" tokens, 10 categorical columns of 16 - j tokens whose
    counts all differ (no tie can reorder a bin across merge orders),
    from `seed`; RF 10 trees depth 8, its eval set the same file."""
    from shifu_tpu_torch.config.model_config import (Algorithm, EvalConfig,
                                                     RawSourceData,
                                                     new_model_config)
    from shifu_tpu_torch.fs.pathfinder import PathFinder

    n = HOSTS["n"] if n is None else n
    rng = np.random.default_rng(seed + 16)
    y = rng.random(n) < 0.3
    names, cols = ["label"], [np.where(y, "1", "0").tolist()]
    for j in range(HOSTS["numeric"]):
        x = rng.integers(0, 40 + 8 * j, size=n) + y * (3 + j % 5) * (j % 3
                                                                    == 0)
        col = list(map(str, x.tolist()))
        for i in np.flatnonzero(rng.random(n) < 0.02).tolist():
            col[i] = "?"
        names.append(f"num_{j}")
        cols.append(col)
    for j in range(HOSTS["cat"]):
        k = 16 - j
        w = np.arange(k, 0, -1, dtype=np.float64) ** 2
        counts = np.floor(n * w / w.sum()).astype(np.int64)
        counts[0] += n - counts.sum()
        codes = np.repeat(np.arange(k), counts)
        rng.shuffle(codes)
        names.append(f"cat_{j}")
        cols.append([f"c{j}_{c}" for c in codes.tolist()])
    data_dir = os.path.join(root, "data")
    os.makedirs(data_dir, exist_ok=True)
    with open(os.path.join(data_dir, "header.txt"), "w") as fh:
        fh.write("|".join(names) + "\n")
    with open(os.path.join(data_dir, "data.txt"), "w") as fh:
        fh.write("\n".join(map("|".join, zip(*cols))))
        fh.write("\n")
    mc = new_model_config("HostSmoke", Algorithm.parse("RF"))
    ds = mc.data_set
    ds.data_path, ds.header_path = "data/data.txt", "data/header.txt"
    ds.target_column_name, ds.pos_tags, ds.neg_tags = "label", ["1"], ["0"]
    mc.train.params.update(TreeNum=RF["trees"], MaxDepth=RF["depth"],
                           FeatureSubsetStrategy="TWOTHIRDS")
    ev = EvalConfig(name=EVAL_NAME, data_set=RawSourceData())
    ev.data_set.data_path, ev.data_set.header_path = (ds.data_path,
                                                      ds.header_path)
    mc.evals = [ev]
    mc.save(PathFinder(root).model_config_path())


def host_props(n_rows, chunks, **extra):
    """The streamed route at `chunks` chunks of `n_rows`, and the host
    wait: the -D properties of every step of the phase."""
    return {"shifu.ingest.forceStreaming": "true",
            "shifu.ingest.chunkRows": str(-(-n_rows // chunks)),
            "shifu.lifecycle.hostWaitMs": str(HOSTS["wait_ms"]), **extra}


class props_set:
    """Properties set in this process for a block, the previous values
    back on exit (what -Dk=v does for one CLI run)."""

    def __init__(self, values):
        self.values = values

    def __enter__(self):
        from shifu_tpu_torch.utils import environment

        self.saved = {k: environment.get_property(k, "")
                      for k in self.values}
        for k, v in self.values.items():
            environment.set_property(k, v)

    def __exit__(self, *exc):
        from shifu_tpu_torch.utils import environment

        for k, v in self.saved.items():
            environment.set_property(k, v)


HOST_LOG = dict(
    barrier=re.compile(r"host barrier '([^']+)': \d+ parts in ([0-9.]+) s"),
    step=re.compile(r"Step (\w+) finished in ([0-9.]+) s"),
    counters=re.compile(r"host (\d+)/\d+ counters (\{.*\})"))


def run_fleet(root, pkg, args, props, hosts=(0, 1), n_hosts=2,
              timeout=600):
    """`python -m shifu_tpu_torch ARGS -Dk=v...` as host h of `n_hosts`
    for each h in `hosts`, all started together in `root`: the exit
    codes, the wall seconds, and what each process's log says (its step
    seconds, barrier waits and host counters)."""
    env = dict(os.environ, PYTHONPATH=pkg)
    flags = [f"-D{k}={v}" for k, v in {
        **props, "shifu.lifecycle.hosts": str(n_hosts)}.items()]
    procs = []
    t0 = time.perf_counter()
    try:
        for h in hosts:
            log = tempfile.TemporaryFile("w+")
            procs.append((subprocess.Popen(
                [sys.executable, "-m", "shifu_tpu_torch", *args, *flags,
                 f"-Dshifu.lifecycle.hostIndex={h}"], cwd=root, env=env,
                stdout=subprocess.DEVNULL, stderr=log), log))
        rcs = [p.wait(timeout=timeout) for p, _log in procs]
    finally:
        for p, _log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    logs = []
    for (p, log), h in zip(procs, hosts):
        log.seek(0)
        text = log.read()
        log.close()
        steps = HOST_LOG["step"].findall(text)
        logs.append(dict(
            host=h, rc=p.returncode,
            step_seconds=float(steps[-1][1]) if steps else None,
            barriers={k: float(v) for k, v in
                      HOST_LOG["barrier"].findall(text)},
            counters=[json.loads(c) for _h, c in
                      HOST_LOG["counters"].findall(text)],
            tail=text[-2000:]))
    return rcs, wall, logs


def _check_fleet(what, rcs, logs, want=0):
    for lg in logs:
        check(lg["rc"] == want,
              f"hosts: {what} host {lg['host']} exited {lg['rc']}:\n"
              f"{lg['tail']}")


def _dev(device):
    """The CLI's device flags: none on the card (its default)."""
    return [] if device == "cuda" else ["--device", device]


def hosts_chains(torch, hk, data_dir, pkg, seed, device="cuda"):
    """(a): the 1-process chain in this process, then the same steps as
    two OS processes (init, stats, norm, eval) and one (train); (b) host
    1's stats killed alone, then the fleet resumed."""
    from shifu_tpu_torch.resilience import checkpoint as ckpt_mod

    base = os.path.join(data_dir, "hosts-base")
    write_host_set(base, seed)
    one, two, kill = (os.path.join(data_dir, f"hosts-{k}")
                      for k in ("one", "two", "kill"))
    set_copy(base, one)
    set_copy(base, two)
    props = host_props(HOSTS["n"], HOSTS["chunks"])
    out = dict(one={}, two={}, waits={}, chunks={})
    with props_set(props):
        for step, args in (("init", ["init"]), ("stats", ["stats"]),
                           ("norm", ["norm"]), ("train", ["train"]),
                           ("eval", ["eval", "-run"])):
            if step == "train":
                hk.reset_counters()
            out["one"][step] = cli_in(one, *args, *_dev(device))
            if step == "train":
                out["launches_one"] = dict(hk.launches)
    for step, args in (("init", ["init"]), ("stats", ["stats"]),
                       ("norm", ["norm"]), ("train", None),
                       ("eval", ["eval", "-run"])):
        if args is None:
            hk.reset_counters()
            with props_set(props):
                out["two"][step] = dict(wall=cli_in(two, "train",
                                                    *_dev(device)))
            out["launches_two"] = dict(hk.launches)
            continue
        rcs, wall, logs = run_fleet(two, pkg, args + _dev(device), props)
        _check_fleet(step, rcs, logs)
        out["two"][step] = dict(wall=wall, hosts=[lg["step_seconds"]
                                                 for lg in logs])
        out["waits"][step] = [lg["barriers"] for lg in logs]
        if step != "eval":
            per = [lg["counters"][-1]["host.chunks"] for lg in logs]
            out["chunks"][step] = per
            for stage in per[0]:
                n = [p[stage] for p in per]
                check(sum(n) == HOSTS["chunks"]
                      and max(n) <= -(-HOSTS["chunks"] // 2),
                      f"hosts: {stage} chunks a host {n}")
        if step == "init":
            set_copy(two, kill)  # (b)'s set: after init, before stats
    score = os.path.join("evals", EVAL_NAME)
    rels = (*HOST_FILES, *NORM_DIRS, os.path.join("models", "model0.rf"),
            score)
    a, b = _files(one, *rels), _files(two, *rels)
    check(sorted(a) == sorted(b), f"hosts: other files {sorted(b)}")
    for rel in a:
        check(a[rel] == b[rel],
              f"hosts: two hosts wrote another {rel} than one process")
    out["files_equal"] = len(a)
    check(out["launches_one"] == out["launches_two"],
          f"hosts: the trains launched {out['launches_one']} and "
          f"{out['launches_two']}")
    check(device != "cuda" or (out["launches_two"]["scan_level"] > 0
                               and not any(hk.reference_calls.values())),
          f"hosts: the train was not the kernel path: "
          f"{out['launches_two']}, plain {hk.reference_calls}")
    # (b): host 1 alone dies on its 3rd chunk, before its barrier
    kprops = {**props, "shifu.ckpt.everyChunks": "1"}
    rcs, wall, logs = run_fleet(kill, pkg, ["stats", *_dev(device)], {
        **kprops, "shifu.faults": "preempt@chunk=3"}, hosts=(1,))
    _check_fleet("stats preempt@chunk=3", rcs, logs, want=1)
    names = sorted(e["name"] for e in ckpt_mod.list_resumable(kill))
    check(names and all(n.startswith("stats-stream-h001-") for n in names),
          f"hosts: the killed host left {names}")
    out["kill"] = dict(wall=wall, left=names)
    rcs, wall, logs = run_fleet(kill, pkg,
                                ["stats", "--resume", *_dev(device)], kprops)
    _check_fleet("stats --resume", rcs, logs)
    out["kill"].update(resume_wall=wall,
                       resume_hosts=[lg["step_seconds"] for lg in logs],
                       chunks=[lg["counters"][-1]["host.chunks"]
                               for lg in logs])
    check(_files(kill, "ColumnConfig.json") == _files(two,
                                                      "ColumnConfig.json"),
          "hosts: the resumed fleet wrote another ColumnConfig.json")
    check(ckpt_mod.list_resumable(kill) == [],
          "hosts: a checkpoint family outlived the resumed fleet")
    return out


def _preempted(fn, what):
    """Run `fn`, which a fault plan must stop with PreemptionError."""
    from shifu_tpu_torch.resilience.faults import PreemptionError

    try:
        fn()
    except PreemptionError:
        return
    check(False, f"hosts chaos: {what} ran through its fault plan")


def _nn_chaos_config(epochs, every):
    def config(root):
        nn_step_config(root, [16], 1, epochs)
        from shifu_tpu_torch.config.model_config import ModelConfig
        from shifu_tpu_torch.fs.pathfinder import PathFinder

        path = PathFinder(root).model_config_path()
        mc = ModelConfig.load(path)
        mc.train.epochs_per_iteration = every
        mc.save(path)
    return config


def _wdl_chaos_config(root):
    _wdl_stream_config(root)
    from shifu_tpu_torch.config.model_config import ModelConfig
    from shifu_tpu_torch.fs.pathfinder import PathFinder

    path = PathFinder(root).model_config_path()
    mc = ModelConfig.load(path)
    mc.train.num_train_epochs = HOSTS["nn_epochs"]
    mc.train.epochs_per_iteration = 1
    mc.save(path)


def hosts_chaos(torch, data_dir, pkg, device="cuda"):
    """(c) on (a)'s first chaos_rows rows, one host: stats, norm and eval
    under preempt@chunk=3, the streamed NN and WDL trains under
    preempt@epoch=3, a SIGTERM sent to a streamed `shifu train`
    subprocess, each resumed; stats under io:p=0.05:seed=7. Every one
    against its unbroken run's bytes."""
    from shifu_tpu_torch.processor.evaluate import EvalProcessor
    from shifu_tpu_torch.processor.init import InitProcessor
    from shifu_tpu_torch.processor.norm import NormProcessor
    from shifu_tpu_torch.processor.stats import StatsProcessor
    from shifu_tpu_torch.processor.train import TrainProcessor
    from shifu_tpu_torch.resilience import checkpoint as ckpt_mod

    src = os.path.join(data_dir, "hosts-base")
    base = os.path.join(data_dir, "chaos-base")
    os.makedirs(os.path.join(base, "data"))
    shutil.copy(os.path.join(src, "ModelConfig.json"), base)
    shutil.copy(os.path.join(src, "data", "header.txt"),
                os.path.join(base, "data"))
    _head_lines(os.path.join(src, "data", "data.txt"),
                os.path.join(base, "data", "data.txt"), HOSTS["chaos_rows"])
    props = host_props(HOSTS["chaos_rows"], HOSTS["chaos_chunks"],
                       **{"shifu.ckpt.everyChunks": "1"})
    roots = {k: os.path.join(data_dir, f"chaos-{k}") for k in
             ("clean", "stats", "norm", "eval", "io", "nn", "nn-chaos",
              "wdl", "wdl-chaos", "kill", "kill-ref")}
    out = {}
    score = os.path.join("evals", EVAL_NAME)

    def timed(fn):
        rc, sec = _timed(torch, device, fn)
        check(rc == 0, "hosts chaos: a step returned non-zero")
        return sec

    def chaos(spec):
        return props_set({**props, "shifu.faults": spec})

    def resumed():
        return props_set({**props, "shifu.resume": "true"})

    with props_set(props):
        check(InitProcessor(base, device=device).run() == 0,
              "hosts chaos: init returned non-zero")
        clean = roots["clean"]
        set_copy(base, clean)
        for step in (StatsProcessor, NormProcessor, TrainProcessor):
            timed(step(clean, device=device).run)
        timed(EvalProcessor(clean, run_name=EVAL_NAME, device=device).run)
    # stats, norm, eval: preempt@chunk=3, then --resume
    cases = (("stats", base, (), StatsProcessor, dict(),
              ("ColumnConfig.json",)),
             ("norm", clean, (os.path.join("tmp", "norm"),),
              NormProcessor, dict(), NORM_DIRS),
             ("eval", clean, (score,), EvalProcessor,
              dict(score_name=EVAL_NAME), (os.path.join(score,
                                                        "EvalScore.csv"),)))
    for name, src_root, drop, step, kw, rels in cases:
        root = roots[name]
        set_copy(src_root, root)
        for rel in drop:
            shutil.rmtree(os.path.join(root, rel))
        with chaos("preempt@chunk=3"):
            _preempted(step(root, device=device, **kw).run, name)
        check(ckpt_mod.list_resumable(root) != [],
              f"hosts chaos: the killed {name} left no snapshot")
        with resumed():
            out[f"{name}_resume_seconds"] = timed(
                step(root, device=device, **kw).run)
        check(_files(root, *rels) == _files(clean, *rels),
              f"hosts chaos: the resumed {name} wrote other bytes")
        check(ckpt_mod.list_resumable(root) == [],
              f"hosts chaos: {name}'s snapshot outlived its resume")
    # transient io faults under the retry budget
    set_copy(base, roots["io"])
    with chaos("io:p=0.05:seed=7"):
        out["io_seconds"] = timed(StatsProcessor(roots["io"],
                                                 device=device).run)
    # the step's obs scope: its manifest's fault.* / retry.* counters
    out["io_injected"] = labelled("fault.injected", "seam")
    out["io_retries"] = labelled("retry.attempts", "seam")
    check(out["io_retries"].get("io", 0) > 0
          and labelled("fault.survived", "seam") == out["io_injected"],
          f"hosts chaos: io faults {out['io_injected']}, retries "
          f"{out['io_retries']}")
    check(_files(roots["io"], "ColumnConfig.json")
          == _files(clean, "ColumnConfig.json"),
          "hosts chaos: stats under io faults wrote other bytes")
    # the streamed NN and WDL trainers: preempt@epoch=3, then resume
    models = "models"
    for kind, config in (("nn", _nn_chaos_config(HOSTS["nn_epochs"], 1)),
                         ("wdl", _wdl_chaos_config)):
        for key in (kind, f"{kind}-chaos"):
            _alg_copy(clean, roots[key], config)
        train = {"shifu.train.forceStreaming": "true"}
        with props_set({**props, **train}):
            timed(TrainProcessor(roots[kind], device=device).run)
        with chaos("preempt@epoch=3"), props_set(train):
            _preempted(TrainProcessor(roots[f"{kind}-chaos"],
                                      device=device).run, kind)
        with resumed(), props_set(train):
            out[f"{kind}_resume_seconds"] = timed(TrainProcessor(
                roots[f"{kind}-chaos"], device=device).run)
        check(_files(roots[kind], models)
              == _files(roots[f"{kind}-chaos"], models),
              f"hosts chaos: the resumed streamed {kind} train wrote "
              "another model")
    # SIGTERM to a streamed `shifu train` subprocess, then --resume
    config = _nn_chaos_config(HOSTS["kill_epochs"], HOSTS["kill_every"])
    for key in ("kill", "kill-ref"):
        _alg_copy(clean, roots[key], config)
    kill = roots["kill"]
    state = os.path.join(kill, "tmp", "train", "checkpoint_0",
                         "weights.npy.state" + ckpt_mod.CKPT_SUFFIX)
    flags = [f"-D{k}={v}" for k, v in props.items()]
    flags.append("-Dshifu.train.forceStreaming=true")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "shifu_tpu_torch", "train", *_dev(device),
         *flags],
        cwd=kill, env=dict(os.environ, PYTHONPATH=pkg),
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        while not os.path.isfile(state):
            check(proc.poll() is None,
                  "hosts chaos: the train ended before its first snapshot")
            check(time.perf_counter() - t0 < 300,
                  "hosts chaos: no train snapshot in 300 s")
            time.sleep(0.01)
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    check(rc == 1, f"hosts chaos: SIGTERM'd train exited {rc}")
    out["sigterm_after_seconds"] = time.perf_counter() - t0
    with props_set({"shifu.train.forceStreaming": "true"}):
        out["sigterm_resume_seconds"] = cli_in(kill, "train", "--resume",
                                               *_dev(device))
        out["sigterm_ref_seconds"] = cli_in(roots["kill-ref"], "train",
                                            *_dev(device))
    check(_files(kill, models) == _files(roots["kill-ref"], models),
          "hosts chaos: the train resumed after SIGTERM wrote another "
          "model")
    return out


def hosts_serve(torch, data_dir, device="cuda"):
    """(d): the (c) NN set's model on 2 replicas on the card under
    device_dead@replica=0: every request answered with the clean run's
    scores, replica 0's breaker open."""
    from shifu_tpu_torch.data.reader import read_header
    from shifu_tpu_torch.data.stream import iter_columnar_chunks
    from shifu_tpu_torch.resilience import faults
    from shifu_tpu_torch.serve.fleet import ReplicaFleet
    from shifu_tpu_torch.serve.health import BREAKER_OPEN

    root = os.path.join(data_dir, "chaos-nn")
    src = os.path.join(data_dir, "chaos-base", "data")
    names = read_header(os.path.join(src, "header.txt"), "|")
    n = HOSTS["serve_rows"]
    batches = list(iter_columnar_chunks(os.path.join(src, "data.txt"),
                                        names, chunk_rows=8, max_rows=n))
    fleet = ReplicaFleet.build(os.path.join(root, "models"), n_replicas=2,
                               device=device)
    reset_obs()
    try:
        want = [fleet.score_batch(b, timeout=60) for b in batches]
        with faults.activate(faults.FaultPlan.parse("device_dead@replica=0")):
            t0 = time.perf_counter()
            got = [fleet.score_batch(b, timeout=60) for b in batches]
            sec = time.perf_counter() - t0
        for g, w in zip(got, want):
            check(np.array_equal(g.model_scores, w.model_scores),
                  "hosts serve: a failed-over batch scored otherwise")
        check(fleet.replicas[0].breaker.state == BREAKER_OPEN,
              "hosts serve: replica 0's breaker did not open")
        out = dict(requests=len(batches), rows=n, seconds=sec,
                   failovers=fleet.failovers,
                   injected=labelled("fault.injected", "replica"),
                   breaker0=fleet.replicas[0].breaker.state,
                   breaker1=fleet.replicas[1].breaker.state)
    finally:
        fleet.close(30)
    return out


def phase_hosts(torch, hk, data_dir, pkg, seed, device="cuda"):
    """Phase 16: (a) two hosts against one, (b) kill one host, (c) chaos
    on one host, (d) a dead replica."""
    t0 = time.perf_counter()
    out = hosts_chains(torch, hk, data_dir, pkg, seed, device)
    out["chaos"] = hosts_chaos(torch, data_dir, pkg, device)
    out["serve"] = hosts_serve(torch, data_dir, device)
    out["seconds"] = time.perf_counter() - t0
    print_hosts(out)
    return out


def print_hosts(h):
    one, two = h["one"], h["two"]
    print(f"hosts: (a) {HOSTS['n']} integral rows at bench `rf` width in "
          f"{HOSTS['chunks']} chunks; step seconds, 1 process (in this "
          "process) vs 2 host processes (wall incl. start; each host's "
          "step):")
    for step in ("init", "stats", "norm", "train", "eval"):
        t = two[step]
        print(f"  {step}: {one[step]:.3f} s vs {t['wall']:.3f} s"
              + (f" ({', '.join(f'{x:.3f}' for x in t['hosts'])})"
                 if "hosts" in t else " (one process)"))
    for step, w in h["waits"].items():
        if any(w):
            print(f"  barrier waits {step}: " + "; ".join(
                f"host {i} " + ", ".join(f"{k} {v:.3f} s"
                                         for k, v in ws.items())
                for i, ws in enumerate(w)))
    for step, per in h["chunks"].items():
        print(f"  chunks a host {step}: {per}")
    print(f"  {h['files_equal']} files byte-identical to the 1-process "
          f"chain (ColumnConfig.json, count_info.json, NormalizedData, "
          f"CleanedData, model0.rf, the eval set); train launches "
          f"{h['launches_two']}")
    k = h["kill"]
    print(f"hosts: (b) host 1's stats under preempt@chunk=3 died in "
          f"{k['wall']:.3f} s leaving {len(k['left'])} files of its own "
          f"family; the fleet --resume {k['resume_wall']:.3f} s (hosts "
          f"{k['resume_hosts']}, chunks {k['chunks']}); ColumnConfig.json "
          "byte-identical to (a), no family left")
    c = h["chaos"]
    print(f"hosts: (c) {HOSTS['chaos_rows']} rows: resumes after "
          f"preempt@chunk=3 stats {c['stats_resume_seconds']:.3f} s, norm "
          f"{c['norm_resume_seconds']:.3f} s, eval "
          f"{c['eval_resume_seconds']:.3f} s; after preempt@epoch=3 NN "
          f"{c['nn_resume_seconds']:.3f} s, WDL {c['wdl_resume_seconds']:.3f}"
          f" s; SIGTERM after {c['sigterm_after_seconds']:.3f} s, resume "
          f"{c['sigterm_resume_seconds']:.3f} s (unbroken "
          f"{c['sigterm_ref_seconds']:.3f} s); stats under io:p=0.05:seed=7"
          f" {c['io_seconds']:.3f} s, injected {c['io_injected']}, retries "
          f"{c['io_retries']}; every one byte-identical to its unbroken run")
    s = h["serve"]
    print(f"hosts: (d) device_dead@replica=0 over 2 replicas: "
          f"{s['requests']} requests ({s['rows']} rows) answered in "
          f"{s['seconds']:.3f} s with the clean scores, {s['failovers']} "
          f"failovers, injected {s['injected']}, breakers "
          f"{s['breaker0']} / {s['breaker1']}")
    print(f"hosts: phase 16 in {h['seconds']:.1f} s")


# ---------------------------------------------------------------------------
# phase 17: the observability layer (obs/, analysis/racetrack.py)
# ---------------------------------------------------------------------------

OBS = dict(gbt_trees=GBT["trees"], gbt_depth=GBT["depth"], requests=12,
           fault="device@device=40", trace_id="smoke-obs-trace")
# the tree seams of the port's grower (JAX names) and those whose cost is
# the entries' analytic count
OBS_SEAMS = ("tree.pallas_fused", "tree.split_scan", "tree.hist_derive",
             "tree.row_update", "tree.errors")
ANALYTIC_SEAMS = ("tree.pallas_fused", "tree.split_scan", "tree.hist")


def obs_set(data_dir, alg):
    """A copy of phase 8's trained card set (200,000 raw rows at the bench
    `rf` width, 20 columns after varsel), its run ledger emptied; GBT
    takes the bench `gbt` forest (5 trees, depth 6)."""
    from shifu_tpu_torch.config.model_config import Algorithm, ModelConfig
    from shifu_tpu_torch.fs.pathfinder import PathFinder

    root = os.path.join(data_dir, f"obs-{alg.lower()}")
    shutil.copytree(os.path.join(data_dir, "raw-card2"), root)
    shutil.rmtree(os.path.join(root, ".shifu"), ignore_errors=True)
    if alg == "GBT":
        path = PathFinder(root).model_config_path()
        mc = ModelConfig.load(path)
        mc.train.algorithm = Algorithm.parse("GBT")
        mc.train.params.update(TreeNum=OBS["gbt_trees"],
                               MaxDepth=OBS["gbt_depth"], LearningRate=0.1)
        mc.save(path)
    return root


def obs_train(torch, hk, root, alg, props=None, device="cuda"):
    """`shifu train` on `root` through the run envelope under `props`
    (-Dk=v): counts zeroed just before, read just after. (seconds,
    launches, the run's manifest, the model file's bytes)."""
    from shifu_tpu_torch.fs.pathfinder import PathFinder
    from shifu_tpu_torch.obs.ledger import list_runs
    from shifu_tpu_torch.processor.train import TrainProcessor

    hk.reset_counters()
    cuda = device == "cuda"
    with props_set(props or {}):
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = TrainProcessor(root, device=device).run()
        if cuda:
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    check(rc == 0, f"obs: {root}: train returned {rc}")
    (m,) = list_runs(root, step="train", last=1)
    with open(PathFinder(root).model_path(0, alg.lower()), "rb") as fh:
        model = fh.read()
    return dict(seconds=secs, launches=dict(hk.launches), manifest=m,
                model=model)


def _hist_of(m):
    c = m["metrics"]["counters"]
    return {k: int(c.get(f"tree.hist.{k}", 0))
            for k in ("built", "derived", "fallback_rebuilds")}


def _seam_of(m, name):
    return ((m.get("profile") or {}).get("programs") or {}).get(name)


def obs_envelope(torch, hk, data_dir, device="cuda"):
    """(a) RF, then GBT: on, off, off, on (-Dshifu.profile.mode=off) —
    manifests, byte-identical models, seams and counters; (b) one GBT
    run under -Dshifu.profile=xla; (c) one RF run under a `device`
    fault."""
    out = dict(runs={}, launches=[])
    models = {}  # (a)'s model bytes, by algorithm
    for alg in ("RF", "GBT"):
        root = obs_set(data_dir, alg)
        # on, off, off, on: each mode once first and once second in a pair
        runs = [obs_train(torch, hk, root, alg,
                          {"shifu.profile.mode": "off"} if i in (1, 2)
                          else None, device=device)
                for i in range(4)]
        out["launches"] += [r["launches"] for r in runs]
        on, off = runs[3], runs[2]
        models[alg] = runs[0]["model"]
        for i, r in enumerate(runs):
            m = r["manifest"]
            check(m["status"] == "ok" and m["seq"] == i + 1,
                  f"obs {alg}: run {i + 1} wrote {m['step']}-{m['seq']} "
                  f"[{m['status']}]")
            check(r["model"] == runs[0]["model"],
                  f"obs {alg}: run {i + 1} wrote other model bytes")
            check(_hist_of(m) == _hist_of(runs[0]["manifest"]),
                  f"obs {alg}: tree.hist.* {_hist_of(m)} against "
                  f"{_hist_of(runs[0]['manifest'])}")
            check(r["launches"] == runs[0]["launches"],
                  f"obs {alg}: launches {r['launches']} against "
                  f"{runs[0]['launches']}")
        hist = _hist_of(on["manifest"])
        check(hist["built"] > 0 and hist["derived"] > 0,
              f"obs {alg}: tree.hist.* {hist}")
        seams = OBS_SEAMS + (("tree.hist",) if alg == "RF" else ())
        for name in seams:
            row = _seam_of(on["manifest"], name)
            check(row is not None and row["dispatches"] > 0,
                  f"obs {alg}: seam {name} not dispatched: {row}")
            check(row["synced"] is False,
                  f"obs {alg}: seam {name} synchronized")
            if name in ANALYTIC_SEAMS:
                check(row["costSource"] == "analytic"
                      and row["bytesAccessed"] > 0,
                      f"obs {alg}: seam {name} cost {row['costSource']}")
        check(not off["manifest"]["profile"]["programs"],
              f"obs {alg}: mode off still profiled "
              f"{sorted(off['manifest']['profile']['programs'])}")
        out["runs"][alg] = dict(
            root=root, on_seconds=[runs[0]["seconds"], on["seconds"]],
            off_seconds=[runs[1]["seconds"], off["seconds"]],
            hist=hist, launches=on["launches"],
            seams={k: dict(dispatches=v["dispatches"],
                           costSource=v["costSource"],
                           bytes=v["bytesAccessed"], flops=v["flops"])
                   for k, v in on["manifest"]["profile"]["programs"]
                   .items()})
    # (b): the torch profiler's Chrome trace of one GBT run
    gbt = out["runs"]["GBT"]
    xla = obs_train(torch, hk, gbt["root"], "GBT", {"shifu.profile": "xla"},
                    device=device)
    out["launches"].append(xla["launches"])
    check(xla["model"] == models["GBT"],
          "obs: the profiled run wrote other model bytes")
    path = xla["manifest"].get("perfettoTrace")
    check(path is not None and os.path.isfile(path),
          f"obs: -Dshifu.profile=xla left no trace: {path}")
    with open(path) as fh:
        text = fh.read()
    for kernel in (("hist_accumulate_kernel", "hist_scan_kernel")
                   if device == "cuda" else ()):
        check(kernel in text, f"obs: the profiler trace names no {kernel}")
    out["xla"] = dict(trace_bytes=len(text), seconds=xla["seconds"])
    # (c): an injected device fault, retried under shifu.retry.device.*
    rf = out["runs"]["RF"]
    faulted = obs_train(torch, hk, rf["root"], "RF",
                        {"shifu.faults": OBS["fault"],
                         "shifu.retry.baseMs": "1"}, device=device)
    out["launches"].append(faulted["launches"])
    c = faulted["manifest"]["metrics"]["counters"]
    inj = c.get('fault.injected{seam="device"}', 0)
    sur = c.get('fault.survived{seam="device"}', 0)
    check(inj == 1 and sur == 1,
          f"obs: device fault injected {inj}, survived {sur}")
    check(faulted["model"] == models["RF"],
          "obs: the faulted run wrote other model bytes")
    check(_hist_of(faulted["manifest"]) == rf["hist"],
          f"obs: the faulted run's tree.hist.* "
          f"{_hist_of(faulted['manifest'])} against {rf['hist']}")
    out["fault"] = dict(injected=inj, survived=sur,
                        retries=c.get('retry.attempts{seam="device"}', 0),
                        seconds=faulted["seconds"])
    return out


def _cli_out(root, *args):
    """`python -m shifu_tpu_torch ARGS` in `root`, in this process: (exit
    code, standard output)."""
    import contextlib
    import io

    from shifu_tpu_torch import cli

    buf = io.StringIO()
    cwd = os.getcwd()
    os.chdir(root)
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(list(args))
    finally:
        os.chdir(cwd)
    return rc, buf.getvalue()


def obs_serve(torch, data_dir, root, pkg, race, device="cuda"):
    """(d)/(e): `shifu serve` on (a)'s RF models as a subprocess: N
    requests (one with X-Shifu-Trace); /metrics, /admin/traces and `shifu
    top --once --json` read live; SIGTERM; the manifest, `shifu trace`,
    `shifu runs` and `shifu profile` read after."""
    import urllib.request

    from shifu_tpu_torch.obs.ledger import list_runs
    from shifu_tpu_torch.obs.metrics import parse_prometheus
    from shifu_tpu_torch.serve.registry import ModelRegistry

    data = held_out(data_dir)
    cols = ModelRegistry(os.path.join(root, "models"),
                         device=device).input_columns
    n = OBS["requests"]
    bodies = [json.dumps({"records": [
        {c: str(data.raw[c][i * 8 + k]) for c in cols}
        for k in range(8)]}).encode("utf-8") for i in range(n)]
    flags = ["-Dshifu.obs.snapshotMs=100"]
    if race:
        flags.append("-Dshifu.sanitize=race")
    env = dict(os.environ, PYTHONPATH=pkg)
    log = tempfile.TemporaryFile("w+")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "shifu_tpu_torch", "serve", "--port", "0",
         "--warm", "8", *flags, *_dev(device)], cwd=root, env=env,
        stdout=subprocess.PIPE, stderr=log, text=True)
    out = dict(race=race)
    try:
        line = proc.stdout.readline()
        m = re.match(r"listening on ([\d.]+):(\d+)", line)
        if m is None:
            log.seek(0)
            raise PhaseFailed(f"obs serve did not start: {line!r}\n"
                              f"{log.read()[-3000:]}")
        base = f"http://{m.group(1)}:{m.group(2)}"
        out["start_seconds"] = time.perf_counter() - t0
        for i, body in enumerate(bodies):
            headers = {"Content-Type": "application/json"}
            if i == n // 2:
                headers["X-Shifu-Trace"] = OBS["trace_id"]
            req = urllib.request.Request(f"{base}/score", data=body,
                                         headers=headers)
            with urllib.request.urlopen(req, timeout=60) as r:
                doc = json.loads(r.read())
                check(r.status == 200 and len(doc["scores"]) == 8,
                      f"obs serve: request {i} answered {r.status}")
                if i == n // 2:
                    check(r.headers.get("X-Shifu-Trace") == OBS["trace_id"],
                          "obs serve: the trace id was not echoed")
        with urllib.request.urlopen(f"{base}/metrics", timeout=30) as r:
            check(r.status == 200, f"obs serve: /metrics {r.status}")
            samples = parse_prometheus(r.read().decode("utf-8"))
        got = sum(v for k, v in samples.items()
                  if k.startswith("serve_requests_total"))
        check(got == n, f"obs serve: /metrics counts {got} requests, "
                        f"{n} sent")
        out["metrics_samples"] = len(samples)
        with urllib.request.urlopen(f"{base}/admin/traces",
                                    timeout=30) as r:
            traces = json.loads(r.read())
        ids = [t["id"] for t in traces["traces"]]
        check(OBS["trace_id"] in ids,
              f"obs serve: /admin/traces lacks the traced request: {ids}")
        (tr,) = [t for t in traces["traces"] if t["id"] == OBS["trace_id"]]
        out["trace_stages_ms"] = tr["stages"]
        rc, text = _cli_out(root, "top", "--once", "--json", "--url", base)
        check(rc == 0, f"obs serve: shifu top exited {rc}")
        payload = json.loads(text)
        check(payload["liveProcesses"] == 1 and "device" in
              payload["stages"], f"obs serve: top payload {payload}")
        out["top_stages"] = payload["stages"]
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(60)
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = proc.wait(10)
        log.seek(0)
        tail = log.read()[-3000:]
        log.close()
    check(rc == 0, f"obs serve: exit {rc} after SIGTERM:\n{tail}")
    out["seconds"] = time.perf_counter() - t0
    (m,) = list_runs(root, step="serve", last=1)
    check(m["status"] == "ok" and m["traces"]["count"] >= 1,
          f"obs serve: manifest {m['status']} traces {m.get('traces')}")
    if race:
        v = m.get("sanitizer") or {}
        check(v.get("race", {}).get("armed") and v.get("clean") is True,
              f"obs serve: the race verdict is not clean: {v}")
        out["race"] = {k: v["race"][k] for k in
                       ("acquisitions", "inversions", "guardViolations",
                        "longHolds")}
    rc, text = _cli_out(root, "trace", "--show", OBS["trace_id"])
    check(rc == 0 and OBS["trace_id"] in text,
          f"obs serve: shifu trace does not list the traced request "
          f"({rc})")
    return out


def obs_readers(root):
    """`shifu runs` lists (a)'s runs; `shifu profile` renders one."""
    rc, text = _cli_out(root, "runs", "--step", "train")
    rows = [ln for ln in text.splitlines() if ln.startswith("train")]
    check(rc == 0 and len(rows) >= 4,
          f"obs: shifu runs listed {len(rows)} train runs ({rc})")
    rc, prof = _cli_out(root, "profile", "train")
    check(rc == 0 and "tree.pallas_fused" in prof and "ROOFLINE" in prof,
          f"obs: shifu profile rendered no train manifest ({rc})")
    return dict(runs_listed=len(rows), profile_lines=len(prof.splitlines()))


def phase_obs(torch, hk, data_dir, pkg, device="cuda"):
    """Phase 17: the run envelope, the seams and the counters on the
    card, a profiler trace, a device fault, and `shifu serve` with its
    /metrics, traces and the reader CLIs (plain and race-armed)."""
    t0 = time.perf_counter()
    out = obs_envelope(torch, hk, data_dir, device)
    root = out["runs"]["RF"]["root"]
    out["serve"] = obs_serve(torch, data_dir, root, pkg, False, device)
    out["serve_race"] = obs_serve(torch, data_dir, root, pkg, True, device)
    out["readers"] = obs_readers(root)
    out["seconds"] = time.perf_counter() - t0
    return out


def print_obs(o):
    for alg in ("RF", "GBT"):
        r = o["runs"][alg]
        print(f"obs: (a) shifu train {alg} on phase 8's set, runs on, off, "
              f"off, on: layer on {r['on_seconds'][0]:.3f} / "
              f"{r['on_seconds'][1]:.3f} s, off {r['off_seconds'][0]:.3f} / "
              f"{r['off_seconds'][1]:.3f} s; model bytes equal on/off; "
              f"tree.hist.* {r['hist']}")
        print("  seams: " + ", ".join(
            f"{k} {v['dispatches']} ({v['costSource']})"
            for k, v in sorted(r["seams"].items())))
    print(f"obs: (b) -Dshifu.profile=xla trace {o['xla']['trace_bytes']} "
          f"bytes naming hist_accumulate_kernel and hist_scan_kernel; "
          f"(c) {OBS['fault']}: injected {o['fault']['injected']}, "
          f"survived {o['fault']['survived']}, retries "
          f"{o['fault']['retries']}, model bytes equal")
    for key in ("serve", "serve_race"):
        s = o[key]
        print(f"obs: ({'e' if s['race'] else 'd'}) shifu serve"
              f"{' -Dshifu.sanitize=race' if s['race'] else ''}: "
              f"{OBS['requests']} requests counted by /metrics, the "
              f"traced one in /admin/traces and `shifu trace` (stages ms "
              f"{s['trace_stages_ms']}), top parsed, {s['seconds']:.1f} s"
              + (f"; race verdict clean {s['race']}" if s["race"] else ""))
    print(f"obs: shifu runs listed {o['readers']['runs_listed']} train "
          f"runs, shifu profile rendered; phase {o['seconds']:.1f} s")


def run(args) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        sys.path.insert(0, os.path.abspath(args.package_root or REPO))
        from shifu_tpu_torch.models import tree as ptree
        from shifu_tpu_torch.norm import dataset as pds
        from shifu_tpu_torch.ops import build
        from shifu_tpu_torch.ops import hist_kernel as hk
        from shifu_tpu_torch.train import tree_trainer as tt
    except ImportError as e:
        print(f"chip_smoke: the shifu_tpu_torch package is missing ({e}); "
              "run from a checkout of the repository", file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    # bf16 products reduce in f32, as XLA's do
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"card: {card}")
    report = dict(card=card, device=kind, seed=args.seed)
    t_all = time.perf_counter()

    # phase 1: build every kernel of the path from the checkout's sources
    build.load("hist_level", rebuild=True)
    report["build_seconds"] = dict(build.build_seconds)
    print(f"build: nvcc {' '.join(build.NVCC_FLAGS[:2])} "
          f"hist_level.cu in {build.build_seconds['hist_level']:.2f} s")
    report["ptxas"] = [ln.strip() for ln in
                       build.build_logs["hist_level"].splitlines()
                       if "Compiling entry" in ln or "registers" in ln
                       or "spill" in ln]
    for ln in report["ptxas"]:
        print(f"  ptxas: {ln}")

    pkg = os.path.abspath(args.package_root or REPO)
    if args.hosts_only:
        data_dir = os.path.join(build.BUILD_DIR, "smoke-data")
        shutil.rmtree(data_dir, ignore_errors=True)
        try:
            report["hosts"] = phase_hosts(torch, hk, data_dir, pkg,
                                          args.seed)
        finally:
            shutil.rmtree(data_dir, ignore_errors=True)
        if args.out:
            out = os.path.join(REPO, args.out)
            os.makedirs(os.path.dirname(out), exist_ok=True)
            with open(out, "w") as fh:
                json.dump(report, fh, indent=1)
        print(f"{card}")
        return 0
    gbt = gbt_data(args.seed)
    rf = rf_data(args.seed)
    # the measurement-only modes write beside the details file
    out_dir = os.path.join(REPO, os.path.dirname(args.out))
    if args.entries:
        rows = entry_profile(torch, dev, hk, tt, gbt[0],
                             (rf[0], rf[2], rf[3]), args.seed)
        out = os.path.join(out_dir, "entries.jsonl")
        os.makedirs(os.path.dirname(out), exist_ok=True)
        with open(out, "a") as fh:
            fh.write(json.dumps(dict(card=card, package=os.path.dirname(
                os.path.dirname(os.path.abspath(hk.__file__))),
                rows=rows)) + "\n")
        return 0

    # phase 2
    print("kernels vs plain versions:")
    stats = phase_kernels(torch, dev, hk, tt, gbt[0], (rf[0], rf[2], rf[3]),
                          args.seed)
    phase_kernels_mc(torch, dev, hk, tt, stats, (rf[0], rf[2], rf[3]),
                     args.seed)
    print("scan entry vs plain versions:")
    phase_scan(torch, dev, hk, tt, stats, gbt[0], (rf[0], rf[2], rf[3]),
               args.seed)
    report["kernel_cases"] = stats.cases

    # phases 3 and 4
    data_dir = os.path.join(build.BUILD_DIR, "smoke-data")
    shutil.rmtree(data_dir, ignore_errors=True)
    try:
        gcfg = tt.TreeTrainConfig(algorithm="GBT", tree_num=GBT["trees"],
                                  max_depth=GBT["depth"], learning_rate=0.1,
                                  valid_set_rate=0.1, seed=3)
        g = phase_main(torch, hk, tt, pds, ptree, "gbt", gbt, gcfg, data_dir)
        check(g["max_score_diff_vs_cpu"] <= GBT_SCORE_ATOL,
              f"gbt: scores differ from the CPU run by "
              f"{g['max_score_diff_vs_cpu']} > {GBT_SCORE_ATOL}")
        print(f"gbt: {g['trees']} trees depth {g['depth']} on {g['rows']} "
              f"rows: {g['trees_per_s']:.3f} trees/s "
              f"({g['row_trees_per_s']:.4g} row-trees/s, second run), "
              f"valid error {g['valid_error']:.6f} (cpu "
              f"{g['cpu_valid_error']:.6f}), max |score - cpu score| "
              f"{g['max_score_diff_vs_cpu']:.3g}, launches {g['launches']}")

        rcfg = tt.TreeTrainConfig(algorithm="RF", tree_num=RF["trees"],
                                  max_depth=RF["depth"],
                                  feature_subset_strategy="TWOTHIRDS",
                                  valid_set_rate=0.1, seed=3)
        r = phase_main(torch, hk, tt, pds, ptree, "rf", rf, rcfg, data_dir)
        check(r["launches"]["hist_level"] > 0,
              f"rf: histogram-only kernel never launched: {r['launches']}")
        check(r["forest_bit_equal_to_cpu"],
              "rf: the forest differs from the CPU run's")
        print(f"rf: {r['trees']} trees depth {r['depth']} on {r['rows']} "
              f"rows: {r['trees_per_s']:.3f} trees/s "
              f"({r['row_trees_per_s']:.4g} row-trees/s, second run), "
              f"valid error {r['valid_error']:.6f}, forest bit-equal to the "
              f"CPU run, launches {r['launches']}")
        for rep in (g, r):
            print_profile(rep)

        nat = phase_native(torch, hk, tt, ptree, data_dir, rf, args.seed)
        print(f"native: shifu train NATIVE RF, {nat['classes']} classes, "
              f"{nat['trees']} trees depth {nat['depth']} on {nat['rows']} "
              f"rows: {nat['trees_per_s']:.3f} trees/s "
              f"({nat['row_trees_per_s']:.4g} row-trees/s, second run), "
              f"valid misclassification {nat['valid_error']:.6f}, model "
              f"file bit-equal across two card runs and to the CPU run "
              f"({nat['cpu_seconds']:.1f} s), launches {nat['launches']}")
        print_profile(nat)
        ova = phase_ova(torch, hk, tt, ptree, data_dir, gbt, args.seed)
        print(f"ova: shifu train ONEVSALL GBT, {ova['classes']} forests of "
              f"{ova['trees']} trees depth {ova['depth']} on {ova['rows']} "
              f"rows: {ova['trees_per_s']:.3f} trees/s (second run), max "
              f"|score - cpu score| {max(ova['max_score_diff_vs_cpu']):.3g},"
              f" launches {ova['launches']}")
        raw = phase_raw(torch, data_dir, args.seed)
        sp = raw["stats_split"]
        print(f"raw: shifu init + stats -correlation -psi from "
              f"{raw['file_bytes'] / 1e6:.1f} MB of text, {raw['rows']} rows "
              f"x 33 columns: init {raw['init_seconds']:.3f} s "
              f"({raw['init_rows_per_s']:.6g} rows/s), stats "
              f"{raw['stats_seconds']:.3f} s ({raw['stats_rows_per_s']:.6g} "
              f"rows/s) (second card run); two card runs byte-identical, "
              f"the CPU run equal but mean/stdDev/correlation within rtol "
              f"{RAW_TOL['rtol']} atol {RAW_TOL['atol']} (CPU init "
              f"{raw['cpu_seconds'][0]:.3f} s, stats "
              f"{raw['cpu_seconds'][1]:.3f} s)")
        print("  stats split (s): " + ", ".join(
            f"{k} {v:.4f}" for k, v in sp.items()
            if k != "aggregate_device_ms")
            + f"; aggregate on the device {sp['aggregate_device_ms']:.4f} ms")
        print_profile(raw)
        prep = phase_prep(torch, hk, tt, ptree, data_dir)
        sp = prep["norm_split"]
        print(f"prep: shifu norm -> varsel -> norm -> train on phase 7's "
              f"model sets ({prep['rows']} rows): norm "
              f"{prep['norm_seconds']:.3f} s ({prep['norm_rows_per_s']:.6g} "
              f"rows/s), varsel {prep['varsel_seconds']:.3f} s keeping "
              f"{prep['columns_after_varsel']} of "
              f"{RAW['numeric'] + RAW['cat']} columns, train RF "
              f"{prep['trees']} trees depth {prep['depth']} "
              f"{prep['train_seconds']:.3f} s ({prep['trees_per_s']:.3f} "
              f"trees/s), valid error {prep['valid_error']:.6f} (second "
              "card run); NormalizedData, CleanedData, ColumnConfig.json "
              "and model0.rf byte-identical across two card runs, the "
              "first three also in the CPU run, whose forest has "
              f"{prep['trees_same_splits_as_cpu']} of {prep['trees']} trees"
              " with the card's splits and max |score - cpu score| "
              f"{prep['max_score_diff_vs_cpu']:.3g} (model bytes equal: "
              f"{prep['cpu_model_bit_equal']}; CPU norm "
              f"{prep['cpu_seconds']['norm_seconds']:.3f} s, train "
              f"{prep['cpu_seconds']['train_seconds']:.3f} s), launches "
              f"{prep['launches']}")
        print("  norm split (s): " + ", ".join(
            f"{k} {v:.4f}" for k, v in sp.items()
            if k != "normalize_device_ms")
            + f"; normalize on the device {sp['normalize_device_ms']:.4f} ms")
        print_profile(prep)
        nn = phase_nn(torch, data_dir)
        ev = phase_eval(torch, data_dir, args.seed)
        sv = phase_serve(torch, data_dir, args.seed)
        gr = phase_growers(torch, hk, tt, ptree, data_dir, gbt, rf,
                           args.seed)
        wd = phase_wdl(torch, data_dir, args.seed)
        st = phase_stream(torch, hk, tt, pds, ptree, data_dir, gbt, rf,
                          args.seed)
        me = phase_mesh(torch, hk, tt, pds, ptree, data_dir, gbt, rf,
                        args.seed)
        ho = phase_hosts(torch, hk, data_dir, pkg, args.seed)
        ob = phase_obs(torch, hk, data_dir, pkg)
        print_obs(ob)
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)
    report["gbt"], report["rf"] = g, r
    report["native"], report["ova"] = nat, ova
    report["raw"], report["prep"] = raw, prep
    report["nn"] = nn
    report["eval"] = ev
    report["serve"] = sv
    report["growers"] = gr
    report["wdl"] = wd
    report["stream"] = st
    report["mesh"] = me
    report["hosts"] = ho
    report["obs"] = ob
    grown = [gr[k]["launches"] for k in ("leafwise_gbt", "leafwise_rf",
                                         "batched_gbt", "batched_rf")]
    # the streamed grower's: (a)'s forests and (b)'s RF train
    grown += [r["launches"] for r in st["trees"].values()]
    grown.append(st["lifecycle"]["launches"])
    # phase 15's meshed runs, each counted on its own
    grown += me["launches"]
    # phase 16's two trains (after the 1-process and the 2-host chains)
    host_runs = [ho["launches_one"], ho["launches_two"]]
    grown += host_runs
    # phase 17's trains (each counted on its own)
    grown += ob["launches"]

    kernels = []
    mc_lines = ":358-365,:408-430,:540-552,:767-769"
    for name in ENTRIES:
        mc = name.endswith("_mc")
        c = (stats.timed_mc[(name, MC_MAIN_K)] if mc
             else stats.timed[name])
        launches = sum(lc[name] for lc in grown) + (
            nat["launches"][name] if mc else
            g["launches"][name] + r["launches"][name]
            + ova["launches"][name] + prep["launches"][name])
        if name.startswith("scan_level"):
            replaces = ("shifu_tpu/train/tree_trainer.py:631 _make_scan_fn "
                        "(XLA, outside pallas_call)"
                        + (", multi-class _make_cls_scan" if mc else ""))
        elif mc:
            replaces = ("shifu_tpu/ops/hist_pallas.py:526 (multi-class "
                        f"branch {mc_lines})")
        else:
            replaces = "shifu_tpu/ops/hist_pallas.py:526"
        kernels.append(dict(
            name=name, route="cuda",
            source="shifu_tpu_torch/csrc/hist_level.cu",
            replaces=replaces,
            launches=launches,
            mesh_launches=sum(lc[name] for lc in me["launches"]),
            hosts_launches=sum(lc[name] for lc in host_runs),
            obs_launches=sum(lc[name] for lc in ob["launches"]),
            max_abs_err=stats.max_abs_err[name], ms=c["ms"],
            plain_ms=c["plain_ms"], bound_ms=c["bound_ms"],
            bound_by=c["bound_by"], library_ms=c["library_ms"]))
        print(f"{name}: timed at {c['case']} (L={c['L']}, T={c['T']})")
    for (name, K), c in sorted(stats.timed_mc.items()):
        print(f"  {name} K={K}: kernel {c['ms']:.4f} ms, plain "
              f"{c['plain_ms']:.4f} ms, bound {c['bound_ms']:.4f} ms"
              + (f", library {c['library_ms']:.4f} ms"
                 if c["library_ms"] is not None else "") + _split(c))
    report["kernels"] = kernels
    report["seconds"] = time.perf_counter() - t_all
    if args.out:
        out = os.path.join(REPO, args.out)
        os.makedirs(os.path.dirname(out), exist_ok=True)
        with open(out, "w") as fh:
            json.dump(report, fh, indent=1)
    print(f"smoke: {report['seconds']:.1f} s")
    print(f"{card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the synthetic data (bench.py uses 0)")
    ap.add_argument("--out", default="chiprun_out/chip_smoke.json",
                    help="details file, relative to the repository root "
                    "('' for none)")
    ap.add_argument("--entries", action="store_true",
                    help="only time one call of each entry")
    ap.add_argument("--hosts-only", action="store_true",
                    help="build the kernels, then run phase 16 alone")
    ap.add_argument("--package-root", default="",
                    help="directory to import shifu_tpu_torch from "
                    "(default: this checkout)")
    args = ap.parse_args()
    try:
        return run(args)
    except PhaseFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())

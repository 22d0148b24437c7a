"""`shifu norm` — produce the dense normalized training matrix (counterpart
of the in-RAM path of `shifu_tpu/processor/norm.py`).

Parity: core/processor/NormalizeModelProcessor.java:67 (Normalize.pig +
udf/NormalizeUDF) and the optional MR shuffle (core/shuffle/MapReduceShuffle).
One pass builds BOTH artifacts every trainer needs —
  NormalizedData/   float32 feature shards (NN/LR/WDL input)
  CleanedData/      int16 bin-code shards (GBT/RF input; replaces the
                    reference's raw-column CleanedData, the tree engine bins
                    at the source instead of per-iteration)
Shuffle is a host-side permutation before sharding (the MR shuffle's only
purpose is balanced random shards — reference NormalizeModelProcessor.java:87).

The data is read once on the host; the value and table norms run on the
device (`norm/normalizer.py`), the bin codes on the host. A dataset past
`shifu.ingest.memoryBudgetMB` (or `shifu.ingest.forceStreaming`) takes
the streamed route: one chunked pass, one shard a chunk (or the
external shuffle), with stream checkpoints and `--resume`. Under a
multi-host plan (`HostPlan`) each host streams its own chunks into part
files (`HostPartWriter`); after the hostsync barrier the merge host
renames the union into the one-process layout, byte for byte. The in-RAM
route and -shuffle cannot split across hosts and raise the JAX
package's ValueErrors.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from shifu_tpu_torch.data.pipeline import HostPlan
from shifu_tpu_torch.data.purify import combined_mask
from shifu_tpu_torch.data.reader import (
    make_tags_for,
    make_weights,
    read_columnar,
    read_header,
)
from shifu_tpu_torch.data.stream import should_stream
from shifu_tpu_torch.norm.dataset import write_codes, write_normalized
from shifu_tpu_torch.norm.normalizer import (
    _slots,
    apply_norm_plan,
    bin_code_matrix,
    build_norm_plan,
    norm_columns,
)
from shifu_tpu_torch.processor.basic import BasicProcessor
from shifu_tpu_torch.utils.log import get_logger
from shifu_tpu_torch.utils.platform import DeviceLike

log = get_logger(__name__)


def default_shards(device: torch.device) -> int:
    """One shard a device of the kind the step runs on (the JAX package
    writes one a `jax.devices()` entry)."""
    if device.type == "cuda":
        return max(1, torch.cuda.device_count())
    return 1


class NormProcessor(BasicProcessor):
    step = "norm"

    def __init__(self, root: str = ".", shuffle: bool = False, seed: int = 0,
                 device: DeviceLike = None,
                 host_plan: Optional[HostPlan] = None):
        super().__init__(root, device=device)
        self.shuffle = shuffle
        self.seed = seed
        # an explicit HostPlan (in-process multi-host runs, tests);
        # None reads the lifecycle knobs
        self.host_plan = host_plan
        # seconds of each stage of the last run (read, normalize, write,
        # bincode; streamed: the one pass, stream) and the normalize
        # stage's device ms (cuda only)
        self.timings: Dict[str, float] = {}

    def run_step(self) -> None:
        self.setup()
        mc = self.model_config
        assert mc is not None
        ds = mc.data_set
        self.timings = t = {}

        if ds.header_path:
            names = read_header(self.resolve(ds.header_path), ds.header_delimiter)
        else:
            names = [c.column_name for c in self.column_configs]

        hp = self.host_plan if self.host_plan is not None else HostPlan()
        if should_stream(self.resolve(ds.data_path)):
            self._run_streaming(names, hp)
            return
        if hp.active:
            raise ValueError(
                "-Dshifu.lifecycle.hosts > 1 requires the streaming norm "
                "path (dataset under the memory budget loads in one "
                "process) — drop the hosts knob or lower "
                "shifu.stream.memoryBudgetMb")

        t0 = time.perf_counter()
        data = read_columnar(
            self.resolve(ds.data_path),
            names,
            delimiter=ds.data_delimiter,
            missing_values=tuple(ds.missing_or_invalid_values),
        )

        # purify + invalid-tag drop + norm sampling (NormalizeUDF filters rows
        # through DataPurifier and sampler before emitting)
        mask = combined_mask(ds.filter_expressions, data.raw, data.n_rows)
        tags_all = make_tags_for(mc, data.column(ds.target_column_name))
        mask &= tags_all >= 0
        if mc.normalize.sample_rate < 1.0:
            rng = np.random.default_rng(self.seed)
            keep = rng.random(data.n_rows) < mc.normalize.sample_rate
            if mc.normalize.sample_neg_only:
                keep |= tags_all == 1
            mask &= keep
        data = data.select_rows(mask)
        tags = tags_all[mask]
        weights = make_weights(data, ds.weight_column_name)

        if self.shuffle:
            perm = np.random.default_rng(self.seed).permutation(data.n_rows)
            data = data.select_rows(perm)
            tags = tags[perm]
            weights = weights[perm]
        t1 = time.perf_counter()
        t["read"] = t1 - t0

        plan = build_norm_plan(mc, self.column_configs)
        code_cache: dict = {}
        feats = apply_norm_plan(plan, data, device=self.device,
                                code_cache=code_cache, timings=t)
        t2 = time.perf_counter()
        t["normalize"] = t2 - t1
        n_shards = default_shards(self.device)
        out_dir = self.paths.normalized_data_dir()
        # persist the output-name -> source-column mapping so later steps
        # (SE/ST varsel under one-hot expansion) don't have to reconstruct
        # the plan against possibly-changed ColumnConfigs
        extra = {"sourceOf": plan.source_of}
        self._add_class_meta(extra, tags)
        write_normalized(
            out_dir,
            feats,
            tags,
            weights,
            plan.out_names,
            norm_type=mc.normalize.norm_type.value,
            n_shards=n_shards,
            extra=extra,
        )
        t3 = time.perf_counter()
        t["write"] = t3 - t2
        log.info(
            "normalized %d rows x %d cols (%s) -> %s [%d shards]",
            feats.shape[0], feats.shape[1], mc.normalize.norm_type.value,
            out_dir, n_shards,
        )

        # tree-model bin codes
        tree_cols = norm_columns(self.column_configs)
        codes = bin_code_matrix(tree_cols, data, cache=code_cache)
        write_codes(
            self.paths.cleaned_data_dir(),
            codes,
            tags,
            weights,
            [c.column_name for c in tree_cols],
            [_slots(c) for c in tree_cols],
            n_shards=n_shards,
        )
        t["bincode"] = time.perf_counter() - t3
        log.info("bin codes -> %s", self.paths.cleaned_data_dir())

    def _add_class_meta(self, extra: dict, tags: np.ndarray) -> None:
        """Multi-class: record the tag list + training class priors in
        meta.json — the eval confusion matrix's binRatio source (the
        reference reads binCountPos/Neg per class from the target
        ColumnConfig, ConfusionMatrix.java:645-653)."""
        mc = self.model_config
        if not mc.is_multi_classification():
            return
        from shifu_tpu_torch.eval.multiclass import class_priors

        class_tags = [str(t) for t in mc.tags()]
        extra["classTags"] = class_tags
        extra["classPriors"] = class_priors(
            np.asarray(tags), len(class_tags)
        ).tolist()

    def _stream_config_sha(self, plan, slots, n_shards):
        """(sha, sections) of a streamed norm: the norm plan and code
        layout in `norm`, chunk geometry, shard plan and sampling in
        `data`."""
        from shifu_tpu_torch.data.stream import chunk_rows_setting
        from shifu_tpu_torch.norm.normalizer import plan_to_json
        from shifu_tpu_torch.resilience.checkpoint import sectioned_sha

        return sectioned_sha({
            "norm": {"plan": plan_to_json(plan),
                     "slots": [int(s) for s in slots]},
            "data": {"seed": self.seed,
                     "sampleRate": self.model_config.normalize.sample_rate,
                     "chunkRows": chunk_rows_setting(),
                     "shards": int(n_shards)},
        })

    def _n_buckets(self) -> int:
        """Shuffle buckets: one bucket about a quarter of the memory
        budget (gzip text counted 4x), at least one a device."""
        from shifu_tpu_torch.data.stream import memory_budget_bytes
        from shifu_tpu_torch.fs.listing import expand_paths

        ds = self.model_config.data_set
        raw_bytes = sum(os.path.getsize(p) * (4 if p.endswith(".gz") else 1)
                        for p in expand_paths(self.resolve(ds.data_path)))
        return max(default_shards(self.device),
                   int(np.ceil(raw_bytes / max(memory_budget_bytes() // 4,
                                               1))))

    def _run_streaming(self, names, hp: HostPlan) -> None:
        """Bounded-memory norm: one chunked pass writes both artifacts
        (NormalizedData f32, CleanedData codes), one shard a chunk, or
        with -shuffle the two-pass external shuffle (ShuffleShardWriter).
        Chunk ci samples by [seed, ci]; the chunks divide over the
        ShardPlan, each shard keeping its cursor in its own snapshot
        file, the writers' shard lists in the shared one. The shuffle
        appends to bucket files and restarts instead of resuming.

        Multi-host: each host streams its own chunks into part files
        (HostPartWriter); the hosts exchange their part lists at the
        `norm` barrier and the merge host renames the union."""
        from shifu_tpu_torch.data.pipeline import ShardPlan, prefetch_iter
        from shifu_tpu_torch.data.stream import iter_columnar_chunks
        from shifu_tpu_torch.norm.dataset import (HostPartWriter,
                                                  ShardWriter,
                                                  ShuffleShardWriter)
        from shifu_tpu_torch.parallel import hostsync
        from shifu_tpu_torch.resilience import checkpoint as ckpt_mod
        from shifu_tpu_torch.resilience import faults
        from shifu_tpu_torch.stats.engine import _prepare_rows

        if self.shuffle and hp.active:
            raise ValueError(
                "-shuffle is not multi-host capable: the external-shuffle "
                "writer owns the global permutation and cannot be split "
                "across processes — run the shuffle norm on one process "
                "or drop -Dshifu.lifecycle.hosts")

        mc = self.model_config
        ds = mc.data_set
        t = self.timings
        t0 = time.perf_counter()
        plan = build_norm_plan(mc, self.column_configs)
        tree_cols = norm_columns(self.column_configs)
        slots = [_slots(c) for c in tree_cols]
        code_dtype = (np.int16 if (not slots or max(slots) < 2 ** 15)
                      else np.int32)
        feat_args = (self.paths.normalized_data_dir(), "features",
                     np.float32, plan.out_names,
                     mc.normalize.norm_type.value)
        code_args = (self.paths.cleaned_data_dir(), "codes", code_dtype,
                     [c.column_name for c in tree_cols], "CODES")
        if hp.active:
            feat_writer = HostPartWriter(
                *feat_args, extra={"sourceOf": plan.source_of})
            code_writer = HostPartWriter(*code_args, extra={"slots": slots})
        elif self.shuffle:
            k = self._n_buckets()
            feat_writer = ShuffleShardWriter(
                *feat_args, n_buckets=k, seed=self.seed,
                extra={"sourceOf": plan.source_of})
            code_writer = ShuffleShardWriter(*code_args, n_buckets=k,
                                             seed=self.seed,
                                             extra={"slots": slots})
        else:
            feat_writer = ShardWriter(*feat_args,
                                      extra={"sourceOf": plan.source_of})
            code_writer = ShardWriter(*code_args, extra={"slots": slots})
        if ds.filter_expressions:
            needed = None  # expressions may reference any column
        else:
            keep = {sp.cc.column_name for sp in plan.specs}
            keep.update(c.column_name for c in tree_cols)
            keep.add(ds.target_column_name)
            if ds.weight_column_name:
                keep.add(ds.weight_column_name)
            needed = [n for n in names if n in keep]

        def _normed(numbered):
            """Prefetch-thread stage: purify, sample, norm and bin-code
            one chunk; the consumer only appends to the writers."""
            ci, chunk = numbered
            chunk, tags, weights = _prepare_rows(
                mc, chunk, [self.seed, ci], mc.normalize.sample_rate,
                mc.normalize.sample_neg_only)
            if not chunk.n_rows:
                return None
            code_cache: dict = {}
            feats = apply_norm_plan(plan, chunk, device=self.device,
                                    code_cache=code_cache)
            codes = bin_code_matrix(tree_cols, chunk, cache=code_cache)
            return ci, feats, codes, tags, weights

        shard_plan = ShardPlan(device=self.device, host=hp)
        S = shard_plan.n_shards
        cursors = [-1] * S
        shard_rows = [0] * S
        n_rows = 0
        tag_counts: Dict[int, int] = {}
        ck = None
        sha, sections = self._stream_config_sha(plan, slots, S)
        if not self.shuffle and ckpt_mod.ckpt_stream_enabled():
            ck = ckpt_mod.ShardedStreamCheckpoint(
                ckpt_mod.ckpt_base(self.root, self.step, "stream"), sha, S,
                sections=sections, n_hosts=hp.n_hosts,
                host_index=hp.host_index)
            if ckpt_mod.resume_requested():
                loaded = ck.load()
                if loaded is not None:
                    cursors = list(loaded[0])
                    shard_rows = [int(m.get("rows", 0))
                                  for _a, m, _b in loaded[1]]
                    meta = loaded[2][1]
                    if hp.active:
                        feat_writer.restore(meta["featParts"])
                        code_writer.restore(meta["codeParts"])
                    else:
                        feat_writer.restore(meta["featShardRows"])
                        code_writer.restore(meta["codeShardRows"])
                    n_rows = int(meta["nRows"])
                    tag_counts = {int(k): int(v)
                                  for k, v in meta["tagCounts"].items()}
                    faults.survived("preempt")
                    log.info("resuming streaming norm (shard cursors %s)",
                             cursors)
            else:
                ck.clear()
        elif self.shuffle and ckpt_mod.resume_requested():
            log.warning("--resume with -shuffle: the external-shuffle "
                        "writer appends to bucket files and cannot resume "
                        "mid-stream; restarting from row zero")
        if hp.active and not ckpt_mod.resume_requested():
            # a fresh fleet run: this host's part of an earlier run must
            # not satisfy a peer's barrier
            hostsync.clear_part(self.root, self.step, hp)

        def _writer_state() -> dict:
            if hp.active:
                return {"featParts": {str(k): v for k, v in
                                      feat_writer.part_rows.items()},
                        "codeParts": {str(k): v for k, v in
                                      code_writer.part_rows.items()}}
            return {"featShardRows": list(feat_writer.shard_rows),
                    "codeShardRows": list(code_writer.shard_rows)}

        def _ckpt_state():
            per_shard = [(cursors[s], None, {"rows": shard_rows[s]}, None)
                         for s in range(S)]
            return per_shard, (None, {
                **_writer_state(),
                "nRows": n_rows,
                "tagCounts": {str(k): v for k, v in tag_counts.items()},
            }, None)

        chunks = iter_columnar_chunks(
            self.resolve(ds.data_path), names, delimiter=ds.data_delimiter,
            missing_values=tuple(ds.missing_or_invalid_values),
            columns=needed)
        for item in prefetch_iter(
                shard_plan.resume_slice(enumerate(chunks), cursors),
                transform=_normed):
            if item is None:
                continue
            faults.fault_point("chunk")
            ci, feats, codes, tags, weights = item
            if hp.active:
                feat_writer.add(ci, feats, tags, weights)
                code_writer.add(ci, codes, tags, weights)
            else:
                feat_writer.add(feats, tags, weights)
                code_writer.add(codes, tags, weights)
            hp.record(len(tags), "norm")
            n_rows += len(tags)
            shard = shard_plan.shard_of(ci)
            cursors[shard] = ci
            shard_rows[shard] += len(tags)
            for tg, c in zip(*np.unique(tags, return_counts=True)):
                tag_counts[int(tg)] = tag_counts.get(int(tg), 0) + int(c)
            if ck is not None:
                ck.maybe_save(_ckpt_state)
        if ck is not None:
            ck.clear()
        feat_union: Dict[int, int] = {}
        code_union: Dict[int, int] = {}
        if hp.active:
            # all-gather the hosts' part lists; every host learns the
            # union and the merged tag counts in host order
            t_b = time.perf_counter()
            hostsync.publish_part(
                self.root, self.step, hp, sha,
                meta={**_writer_state(), "nRows": n_rows,
                      "tagCounts": {str(k): int(v)
                                    for k, v in tag_counts.items()}})
            parts = hostsync.await_parts(self.root, self.step, hp, sha)
            tag_counts, n_rows = {}, 0
            for _arrays, pmeta, _blob in parts:
                feat_union.update({int(k): int(v) for k, v in
                                   pmeta["featParts"].items()})
                code_union.update({int(k): int(v) for k, v in
                                   pmeta["codeParts"].items()})
                n_rows += int(pmeta["nRows"])
                for k, v in pmeta["tagCounts"].items():
                    tag_counts[int(k)] = tag_counts.get(int(k), 0) + int(v)
            t["barrier"] = time.perf_counter() - t_b
            log.info("streaming norm: %s", hp.describe())
        if mc.is_multi_classification():
            class_tags = [str(tg) for tg in mc.tags()]
            total = max(sum(tag_counts.values()), 1)
            feat_writer.extra["classTags"] = class_tags
            feat_writer.extra["classPriors"] = [
                tag_counts.get(k, 0) / total for k in range(len(class_tags))]
        if hp.active:
            if not hp.is_merge_host:
                t["stream"] = time.perf_counter() - t0
                log.info("streaming norm host %d/%d: %d parts staged; the "
                         "merge host writes the artifacts", hp.host_index,
                         hp.n_hosts, len(feat_writer.part_rows))
                return
            feat_meta = feat_writer.merge(feat_union)
            code_writer.merge(code_union)
        else:
            feat_meta = feat_writer.close()
            code_writer.close()
        t["stream"] = time.perf_counter() - t0
        log.info("streaming norm: %d rows x %d cols (%s) -> %s [%d shards] "
                 "+ bin codes -> %s", n_rows, len(feat_meta.columns),
                 mc.normalize.norm_type.value,
                 self.paths.normalized_data_dir(),
                 len(feat_meta.shard_rows), self.paths.cleaned_data_dir())

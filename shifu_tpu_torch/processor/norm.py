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
`shifu.ingest.memoryBudgetMB` (the streamed route and its shard
writers), `--resume` and more than one host are ROADMAP A.13 and raise.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from shifu_tpu_torch.data.purify import combined_mask
from shifu_tpu_torch.data.reader import (
    make_tags_for,
    make_weights,
    read_columnar,
    read_header,
)
from shifu_tpu_torch.data.stream import check_single_host, should_stream
from shifu_tpu_torch.norm.dataset import write_codes, write_normalized
from shifu_tpu_torch.norm.normalizer import (
    _slots,
    apply_norm_plan,
    bin_code_matrix,
    build_norm_plan,
    norm_columns,
)
from shifu_tpu_torch.processor.basic import BasicProcessor
from shifu_tpu_torch.utils import environment
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
                 device: DeviceLike = None):
        super().__init__(root, device=device)
        self.shuffle = shuffle
        self.seed = seed
        # seconds of each stage of the last run (read, normalize, write,
        # bincode) and the normalize stage's device ms (cuda only)
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

        if should_stream(self.resolve(ds.data_path)):
            raise NotImplementedError(
                "streamed norm (data past -Dshifu.ingest.memoryBudgetMB, "
                "or shifu.ingest.forceStreaming) is not ported yet: "
                "ROADMAP A.13")
        check_single_host()
        if environment.get_bool("shifu.resume", False):
            raise NotImplementedError(
                "--resume resumes the streamed norm, which is not ported "
                "yet: ROADMAP A.13")

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

"""Scorer / ModelRunner: batch scoring of raw records against trained models
(counterpart of `shifu_tpu/eval/scorer.py`).

Parity: core/Scorer.java:53 (per-model dispatch, DEFAULT_SCORE_SCALE=1000,
Scorer.java:56), core/ModelRunner.java:54 (header map -> per-model scores,
mean/max/min/median aggregation). Models are loaded once; the raw eval
dataset is normalized with each model's embedded norm plan (NN/LR, WDL's
dense part), binned by its embedded boundaries (trees) or coded by its
embedded categories (WDL), and each model scores the batch in one forward
or traversal on `device`. Reference-format files (Encog EG text, the Java
binary serializers, zip specs) score through `compat.adapters`. The scale
and the aggregates are numpy on the host over the f32 score matrix, as
in the JAX package: `np.median` averages the two middle values of an
even count (`torch.median` takes the lower one) and `np.mean` of f32 is
numpy's pairwise sum.
"""

from __future__ import annotations

import glob
import json
import os
import re
import time
import weakref
from dataclasses import dataclass, field
from typing import Dict, List, Sequence

import numpy as np
import torch

from shifu_tpu_torch.data.reader import ColumnarData
from shifu_tpu_torch.utils.log import get_logger
from shifu_tpu_torch.utils.platform import DeviceLike, resolve_device

log = get_logger(__name__)

DEFAULT_SCORE_SCALE = 1000.0  # Scorer.java:56

MODEL_SUFFIXES = (".nn", ".lr", ".gbt", ".rf", ".wdl")


def find_model_paths(models_dir: str) -> List[str]:
    """models/model*.{nn,lr,gbt,rf,wdl} sorted by NUMERIC index
    (ModelSpecLoaderUtils.findModels). Numeric, not lexicographic: under
    ONEVSALL the column order is load-bearing (column k = class k), and
    lexicographic order would put model10 before model2.

    Paths are DEDUPED (overlapping globs/symlinked dirs must not score a
    model twice — duplicate columns skew the mean/median aggregates) and
    the order is fully deterministic: numeric index first, then basename —
    unindexed names land after every indexed one in basename order, never
    in whatever order the per-suffix globs happened to run."""
    out = set()
    for suf in MODEL_SUFFIXES:
        out.update(glob.glob(os.path.join(models_dir, f"model*{suf}")))

    def key(p: str):
        base = os.path.basename(p)
        m = re.search(r"model(\d+)", base)
        # (indexed-first, index, basename): the basename tie-break keeps
        # same-index files of different suffixes and ALL unindexed files
        # in one stable order regardless of glob/filesystem enumeration
        return (0, int(m.group(1)), base) if m else (1, 0, base)

    return sorted(out, key=key)


def load_model(path: str, column_configs=None, model_config=None,
               device: DeviceLike = None):
    """Dispatch on extension to the model spec (NNModelSpec for .nn/.lr,
    TreeModelSpec for .gbt/.rf, WDLModelSpec for .wdl). Reference-format
    files (Encog EG text, BinaryNNSerializer gzip, BinaryDTSerializer,
    zip spec) are sniffed by magic bytes first and wrapped in a
    RefModelAdapter on `device` (ModelSpecLoaderUtils.java:389 parity:
    one models/ dir can mix native and reference specs); an EG `.nn`
    normalizes with the plan of `column_configs` and `model_config`."""
    from shifu_tpu_torch.compat.adapters import load_ref_model

    adapter = load_ref_model(path, column_configs, model_config,
                             device=device)
    if adapter is not None:
        return adapter
    suffix = os.path.splitext(path)[1]
    if suffix in (".nn", ".lr"):
        from shifu_tpu_torch.models.nn import NNModelSpec

        return NNModelSpec.load(path)
    if suffix in (".gbt", ".rf"):
        from shifu_tpu_torch.models.tree import TreeModelSpec

        return TreeModelSpec.load(path)
    if suffix == ".wdl":
        from shifu_tpu_torch.models.wdl import WDLModelSpec

        return WDLModelSpec.load(path)
    raise ValueError(f"unknown model type: {path}")


@dataclass
class ScoreResult:
    """Per-record scores: raw per-model + aggregates, 0..scale.

    Multi-class NATIVE models contribute one column PER CLASS, model-major
    ("1,2,3 4,5,6: 1,2,3 is model 0" — ConfusionMatrix.java:760);
    `model_widths[i]` is model i's column count (1 for binary/ONEVSALL)."""

    model_scores: np.ndarray  # [n, sum(model_widths)]
    mean: np.ndarray
    max: np.ndarray
    min: np.ndarray
    median: np.ndarray
    model_names: List[str] = field(default_factory=list)
    model_widths: List[int] = field(default_factory=list)


class ModelRunner:
    """Scores batches with every model of a model set on one device.
    `timings` holds the last call's seconds of each stage (normalize,
    codes, forward, aggregate) and, on cuda, the forwards' device ms
    (`forward_device_ms`, CUDA events around each model's call: its
    host->device copy, forward or traversal, and the copy back)."""

    def __init__(self, model_paths: List[str],
                 scale: float = DEFAULT_SCORE_SCALE,
                 device: DeviceLike = None, column_configs=None,
                 model_config=None):
        if not model_paths:
            raise ValueError("no models to score with")
        self.device = resolve_device(device)
        self.paths = model_paths
        self.specs = [load_model(p, column_configs, model_config,
                                 device=self.device) for p in model_paths]
        # independent scorers are made once, with their weights on device
        self.models = [self._independent(spec) for spec in self.specs]
        self.scale = scale
        self.timings: Dict[str, float] = {}
        self._norm_cache: Dict[str, np.ndarray] = {}
        self._codes_cache: Dict[str, np.ndarray] = {}
        self._cached_data_ref = None  # weakref to the cached batch

    def _check_batch(self, data: ColumnarData) -> None:
        """Feature caches are per input batch — a new ColumnarData object
        invalidates them (model signatures alone don't identify the rows).

        Identity is held via WEAKREF, never `id()`: in a streaming loop
        the previous chunk is freed before the next one arrives, and the
        allocator routinely hands the new chunk the old address — an
        id()-keyed check then serves the PREVIOUS chunk's normalized
        features for the new chunk's rows. A dead or different referent
        always invalidates; the weakref itself keeps no chunk alive."""
        cached = (self._cached_data_ref()
                  if self._cached_data_ref is not None else None)
        if cached is not data:
            self._norm_cache.clear()
            self._codes_cache.clear()
            try:
                self._cached_data_ref = weakref.ref(data)
            except TypeError:  # un-weakrefable batch: never reuse across calls
                self._cached_data_ref = None

    def _independent(self, spec):
        from shifu_tpu_torch.compat.adapters import RefModelAdapter
        from shifu_tpu_torch.models.nn import IndependentNNModel, NNModelSpec

        if isinstance(spec, RefModelAdapter):
            return spec
        if isinstance(spec, NNModelSpec):
            return IndependentNNModel(spec, device=self.device)
        return spec.independent(device=self.device)

    def _normalized_input(self, spec, data: ColumnarData) -> np.ndarray:
        """Normalize raw records with the model's embedded norm plan; plans
        are usually identical across bagged models, so cache by the FULL
        plan signature (type + cutoff + every column table)."""
        from shifu_tpu_torch.norm.normalizer import (apply_norm_plan,
                                                     plan_from_json)

        plan_json = {
            "normType": spec.norm_type,
            "cutoff": getattr(spec, "norm_cutoff", 4.0),
            "columns": spec.norm_specs,
        }
        key = json.dumps(plan_json, sort_keys=True)
        if key in self._norm_cache:
            return self._norm_cache[key]
        t0 = time.perf_counter()
        mat = apply_norm_plan(plan_from_json(plan_json), data,
                              device=self.device)
        self._add("normalize", time.perf_counter() - t0)
        self._norm_cache[key] = mat
        return mat

    def _wdl_codes(self, spec, data: ColumnarData) -> np.ndarray:
        """Categorical index matrix for a WDL model, cached per batch like
        tree codes."""
        from shifu_tpu_torch.models.wdl import wdl_codes

        key = json.dumps(["wdl", spec.cat_columns, spec.categories],
                         sort_keys=True)
        if key in self._codes_cache:
            return self._codes_cache[key]
        t0 = time.perf_counter()
        codes = wdl_codes(spec, data)
        self._add("codes", time.perf_counter() - t0)
        self._codes_cache[key] = codes
        return codes

    def _tree_codes(self, spec, model, data: ColumnarData) -> np.ndarray:
        """Bin codes per tree model, cached by the model's own binning
        signature (different models may embed different columns/bins)."""
        key = json.dumps(
            [spec.input_columns, spec.boundaries, spec.categories],
            sort_keys=True,
        )
        if key in self._codes_cache:
            return self._codes_cache[key]
        t0 = time.perf_counter()
        codes = model.codes_from_raw(data)
        self._add("codes", time.perf_counter() - t0)
        self._codes_cache[key] = codes
        return codes

    def _add(self, key: str, value: float) -> None:
        self.timings[key] = self.timings.get(key, 0.0) + value

    def _forward(self, fn, *args) -> np.ndarray:
        """One model's call, timed on the host clock and, on cuda, by
        CUDA events."""
        cuda = self.device.type == "cuda"
        if cuda:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        t0 = time.perf_counter()
        out = fn(*args)  # ends with the copy to the host: synchronized
        self._add("forward", time.perf_counter() - t0)
        if cuda:
            ev[1].record()
            ev[1].synchronize()
            self._add("forward_device_ms", ev[0].elapsed_time(ev[1]))
        return out

    def score_raw(self, data: ColumnarData) -> ScoreResult:
        """Score raw records. NN/LR/WDL models normalize via their embedded
        plan; tree models bin via their embedded boundaries/categories,
        WDL codes via its categories (EvalScoreUDF loads models once, then
        scores row batches)."""
        from shifu_tpu_torch.compat.adapters import RefModelAdapter
        from shifu_tpu_torch.models.tree import TreeModelSpec
        from shifu_tpu_torch.models.wdl import WDLModelSpec

        self.timings = {}
        self._check_batch(data)
        cols = []
        for spec, model in zip(self.specs, self.models):
            if isinstance(spec, RefModelAdapter):
                cols.append(self._forward(spec.score_raw, data) * self.scale)
            elif isinstance(spec, TreeModelSpec):
                codes = self._tree_codes(spec, model, data)
                cols.append(self._forward(model.compute, codes) * self.scale)
            elif isinstance(spec, WDLModelSpec):
                dense = self._normalized_input(spec, data)
                wcodes = self._wdl_codes(spec, data)
                cols.append(self._forward(model.compute_parts, dense, wcodes)
                            * self.scale)
            else:
                x = self._normalized_input(spec, data)
                cols.append(self._nn_scores(spec, model, x))
        return self._aggregate(cols)

    def _nn_scores(self, spec, model, x: np.ndarray) -> np.ndarray:
        """Binary model -> [n]; NATIVE multi-class -> [n, K] per-class."""
        if spec.out_dim > 1:
            return self._forward(model.compute_all, x) * self.scale
        return self._forward(model.compute, x) * self.scale

    def score_normalized(self, feats: np.ndarray) -> ScoreResult:
        from shifu_tpu_torch.compat.adapters import RefModelAdapter
        from shifu_tpu_torch.models.nn import NNModelSpec
        from shifu_tpu_torch.models.wdl import WDLModelSpec

        self.timings = {}
        cols = []
        for spec, m in zip(self.specs, self.models):
            if isinstance(spec, WDLModelSpec):
                raise ValueError(
                    "a WDL model reads dense columns and categorical "
                    "codes, not one normalized matrix: use score_wdl")
            if isinstance(m, RefModelAdapter):
                cols.append(self._forward(m.score_normalized, feats)
                            * self.scale)
            elif isinstance(spec, NNModelSpec):
                cols.append(self._nn_scores(spec, m, feats))
            else:
                cols.append(self._forward(m.compute, feats) * self.scale)
        return self._aggregate(cols)

    def score_wdl(self, feats: np.ndarray, feat_columns: Sequence[str],
                  codes: np.ndarray, code_columns: Sequence[str]
                  ) -> ScoreResult:
        """Score a WDL set on prepared data, as training read it: each
        model's dense columns by name from `feats` (NormalizedData, its
        columns `feat_columns`), its categorical codes by name from
        `codes` (CleanedData, its columns `code_columns`)."""
        from shifu_tpu_torch.models.wdl import WDLModelSpec

        self.timings = {}
        feat_at = {c: i for i, c in enumerate(feat_columns)}
        code_at = {c: i for i, c in enumerate(code_columns)}
        cols = []
        for spec, model, path in zip(self.specs, self.models, self.paths):
            if not isinstance(spec, WDLModelSpec):
                raise ValueError(f"{path} is not a WDL model")
            dense = feats[:, [feat_at[c] for c in spec.dense_columns]]
            wcodes = codes[:, [code_at[c] for c in spec.cat_columns]]
            cols.append(self._forward(model.compute_parts, dense, wcodes)
                        * self.scale)
        return self._aggregate(cols)

    def _aggregate(self, cols: List[np.ndarray]) -> ScoreResult:
        t0 = time.perf_counter()
        mats = [c[:, None] if c.ndim == 1 else c for c in cols]
        m = np.concatenate(mats, axis=1)
        widths = [mat.shape[1] for mat in mats]
        out = ScoreResult(
            model_scores=m,
            mean=m.mean(axis=1),
            max=m.max(axis=1),
            min=m.min(axis=1),
            median=np.median(m, axis=1),
            model_names=[os.path.basename(p) for p in self.paths],
            model_widths=widths,
        )
        self._add("aggregate", time.perf_counter() - t0)
        return out

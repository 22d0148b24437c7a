"""`shifu posttrain` — bin-average scores + feature importance (counterpart
of `shifu_tpu/processor/posttrain.py`).

Parity: core/processor/PostTrainModelProcessor.java — per selected column,
the average model score of the records falling in each bin (binAvgScore
written back into ColumnConfig, :187-192), plus a feature-importance report
(FeatureImportanceMapper/Reducer). FI here: tree models use split-based
importance; NN/LR use SE knockout sensitivity.

The models score the training set's CleanedData (trees) or NormalizedData
(NN) on the device; the per-bin sums are f64 on the host in row order, as
the JAX package's `np.add.at` sums them, so two runs give the same bytes
(an `index_add_` on the card sums in an order that changes between runs).
"""

from __future__ import annotations

import os
import time
from typing import Dict

import numpy as np

from shifu_tpu_torch.norm.dataset import load_codes, load_normalized
from shifu_tpu_torch.processor.basic import BasicProcessor
from shifu_tpu_torch.utils.errors import ErrorCode, ShifuError
from shifu_tpu_torch.utils.log import get_logger
from shifu_tpu_torch.utils.platform import DeviceLike

log = get_logger(__name__)


class PostTrainProcessor(BasicProcessor):
    step = "posttrain"

    def __init__(self, root: str = ".", device: DeviceLike = None):
        super().__init__(root, device=device)
        # seconds of each stage of the last run (load, score, binavg, fi)
        self.timings: Dict[str, float] = {}

    def run_step(self) -> None:
        self.setup()
        from shifu_tpu_torch.eval.scorer import ModelRunner, find_model_paths
        from shifu_tpu_torch.models.tree import TreeModelSpec

        self.timings = t = {}
        model_paths = find_model_paths(self.paths.models_dir())
        if not model_paths:
            raise ShifuError(ErrorCode.MODEL_NOT_FOUND,
                             "run `shifu train` before posttrain")
        codes_dir = self.paths.cleaned_data_dir()
        norm_dir = self.paths.normalized_data_dir()
        if not (os.path.isdir(codes_dir) and os.path.isdir(norm_dir)):
            raise ShifuError(ErrorCode.DATA_NOT_FOUND,
                             "run `shifu norm` before posttrain")

        t0 = time.perf_counter()
        cmeta, codes, tags, _weights = load_codes(codes_dir)
        _, feats, _, _ = load_normalized(norm_dir)
        codes = np.asarray(codes)
        runner = ModelRunner(model_paths, device=self.device)
        t1 = time.perf_counter()
        t["load"] = t1 - t0
        if all(isinstance(s, TreeModelSpec) for s in runner.specs):
            scores = np.stack(
                [m.compute(codes) * runner.scale for m in runner.models],
                axis=1).mean(axis=1)
        else:
            scores = runner.score_normalized(
                np.asarray(feats, np.float32)).mean
        t2 = time.perf_counter()
        t["score"] = t2 - t1

        # ---- bin average score per column (PostTrainMapper/Reducer) ----
        by_name = {c.column_name: c for c in self.column_configs}
        slots = cmeta.extra["slots"]
        for j, name in enumerate(cmeta.columns):
            cc = by_name.get(name)
            if cc is None:
                continue
            s = int(slots[j])
            sums = np.zeros(s)
            cnts = np.zeros(s)
            np.add.at(sums, codes[:, j], scores)
            np.add.at(cnts, codes[:, j], 1.0)
            avg = np.where(cnts > 0, sums / np.maximum(cnts, 1), 0.0)
            cc.column_binning.bin_avg_score = [float(round(v, 2)) for v in avg]
        self.save_column_configs()
        t3 = time.perf_counter()
        t["binavg"] = t3 - t2

        # ---- feature importance report ----
        fi = self._feature_importance(runner, feats, tags)
        self.paths.ensure(self.paths.tmp_dir("posttrain"))
        with open(self.paths.feature_importance_path(), "w") as fh:
            fh.write("column,importance\n")
            for name, v in sorted(fi.items(), key=lambda kv: -kv[1]):
                fh.write(f"{name},{v:.8g}\n")
        t["fi"] = time.perf_counter() - t3
        log.info("posttrain done: binAvgScore for %d columns, FI -> %s",
                 len(cmeta.columns), self.paths.feature_importance_path())

    def _feature_importance(self, runner, feats, tags) -> dict:
        from shifu_tpu_torch.models.nn import NNModelSpec
        from shifu_tpu_torch.models.tree import TreeModelSpec

        spec = runner.specs[0]
        if isinstance(spec, TreeModelSpec):
            from shifu_tpu_torch.varsel.importance import \
                tree_feature_importance

            return tree_feature_importance(spec)
        if isinstance(spec, NNModelSpec):
            from shifu_tpu_torch.varsel.selector import sensitivity_scores

            scores = sensitivity_scores(
                spec.params, spec.activations, np.asarray(feats, np.float32),
                np.asarray(tags, np.float32), "SE", device=self.device,
            )
            cols = spec.input_columns or [
                f"col_{i}" for i in range(len(scores))
            ]
            return {n: float(s) for n, s in zip(cols, scores)}
        return {}

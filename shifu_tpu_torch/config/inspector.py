"""ModelInspector: per-step validation gate for ModelConfig/ColumnConfig.

The port's own copy of `shifu_tpu/config/inspector.py`, the same code and the same bytes on
disk; the port imports nothing of the JAX package.

Parity with the reference's core/validator/ModelInspector.java:93 — each
lifecycle step `probe`s only the config sections it depends on and fails fast
with an aggregated, human-readable error list before any compute is launched.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List

from shifu_tpu_torch.config.model_config import Algorithm, ModelConfig


@dataclass
class ValidateResult:
    status: bool = True
    causes: List[str] = field(default_factory=list)

    def fail(self, cause: str) -> None:
        self.status = False
        self.causes.append(cause)

    def merge(self, other: "ValidateResult") -> None:
        if not other.status:
            self.status = False
            self.causes.extend(other.causes)


class ModelStep:
    NEW = "new"
    INIT = "init"
    STATS = "stats"
    NORM = "norm"
    VARSEL = "varsel"
    TRAIN = "train"
    POSTTRAIN = "posttrain"
    EVAL = "eval"
    EXPORT = "export"


_SUPPORTED_ALGS = {
    Algorithm.NN,
    Algorithm.LR,
    Algorithm.SVM,
    Algorithm.GBT,
    Algorithm.RF,
    Algorithm.DT,
    Algorithm.WDL,
    Algorithm.TENSORFLOW,
}


def _check_data_set(mc: ModelConfig, result: ValidateResult, base_dir: str) -> None:
    ds = mc.data_set
    if not ds.data_path:
        result.fail("dataSet.dataPath is empty")
    else:
        path = ds.data_path
        if "://" in path:  # scheme-ful URI (fs/source.py is_remote)
            pass  # remote existence is the reader's job (fs/source.py)
        else:
            if not os.path.isabs(path):
                path = os.path.normpath(os.path.join(base_dir, path))
            if not os.path.exists(path):
                result.fail(f"dataSet.dataPath not found: {ds.data_path}")
    if not ds.target_column_name:
        result.fail("dataSet.targetColumnName is empty")
    overlap = set(ds.pos_tags) & set(ds.neg_tags)
    if overlap:
        result.fail(f"posTags and negTags overlap: {sorted(overlap)}")
    if not ds.pos_tags and not ds.neg_tags:
        result.fail("both dataSet.posTags and dataSet.negTags are empty")


def _check_stats(mc: ModelConfig, result: ValidateResult) -> None:
    st = mc.stats
    if st.max_num_bin <= 1:
        result.fail(f"stats.maxNumBin must be > 1, got {st.max_num_bin}")
    if not (0.0 < st.sample_rate <= 1.0):
        result.fail(f"stats.sampleRate must be in (0, 1], got {st.sample_rate}")


def _check_norm(mc: ModelConfig, result: ValidateResult) -> None:
    nm = mc.normalize
    if nm.std_dev_cut_off <= 0:
        result.fail(f"normalize.stdDevCutOff must be > 0, got {nm.std_dev_cut_off}")
    if not (0.0 < nm.sample_rate <= 1.0):
        result.fail(f"normalize.sampleRate must be in (0, 1], got {nm.sample_rate}")


def _check_varsel(mc: ModelConfig, result: ValidateResult) -> None:
    vs = mc.var_select
    if vs.filter_enable and vs.filter_num <= 0 and vs.filter_out_ratio <= 0:
        result.fail("varSelect.filterNum or filterOutRatio must be positive")
    valid_filters = {"KS", "IV", "MIX", "PARETO", "FI", "SE", "ST", "VOTED"}
    if vs.filter_by and vs.filter_by.upper() not in valid_filters:
        result.fail(
            f"varSelect.filterBy '{vs.filter_by}' not in {sorted(valid_filters)}"
        )


def _check_train(mc: ModelConfig, result: ValidateResult) -> None:
    tr = mc.train
    if tr.algorithm not in _SUPPORTED_ALGS:
        result.fail(f"train.algorithm {tr.algorithm} unsupported")
    if tr.bagging_num < 1:
        result.fail(f"train.baggingNum must be >= 1, got {tr.bagging_num}")
    if not (0.0 <= tr.valid_set_rate < 1.0):
        result.fail(f"train.validSetRate must be in [0, 1), got {tr.valid_set_rate}")
    if tr.num_train_epochs < 1:
        result.fail(f"train.numTrainEpochs must be >= 1, got {tr.num_train_epochs}")
    if not (0.0 < tr.bagging_sample_rate <= 1.0):
        result.fail(
            f"train.baggingSampleRate must be in (0, 1], got {tr.bagging_sample_rate}"
        )
    if tr.num_k_fold is not None and tr.num_k_fold > 1 and tr.is_continuous:
        result.fail("train.numKFold and isContinuous cannot both be enabled")
    if tr.algorithm == Algorithm.NN:
        layers = tr.get_param("NumHiddenLayers", 0)
        nodes = tr.get_param("NumHiddenNodes", []) or []
        funcs = tr.get_param("ActivationFunc", []) or []
        if layers and (len(nodes) != layers or len(funcs) != layers):
            result.fail(
                "NN params inconsistent: NumHiddenLayers="
                f"{layers}, NumHiddenNodes={nodes}, ActivationFunc={funcs}"
            )
    if tr.algorithm in (Algorithm.GBT, Algorithm.RF, Algorithm.DT):
        depth = tr.get_param("MaxDepth", 10)
        if not (1 <= int(depth) <= 20):
            result.fail(f"tree MaxDepth must be in [1, 20], got {depth}")
    if tr.algorithm == Algorithm.SVM:
        # the TPU build trains the liblinear path: L2-regularized hinge,
        # Const -> C (core/alg/SVMTrainer.java:38); kernel SVMs are not
        # implemented — fail at validation, not silently mid-train
        kernel = str(tr.get_param("Kernel", "linear") or "linear").lower()
        if kernel != "linear":
            result.fail(
                f"SVM Kernel={kernel!r} unsupported (linear only); "
                "use Kernel=linear or algorithm=NN")


def _check_evals(mc: ModelConfig, result: ValidateResult, base_dir: str) -> None:
    names = set()
    for e in mc.evals or []:
        if not e.name:
            result.fail("eval set with empty name")
        elif e.name in names:
            result.fail(f"duplicate eval set name: {e.name}")
        names.add(e.name)
        if not e.data_set.data_path:
            result.fail(f"eval {e.name}: dataSet.dataPath is empty")


def probe(mc: ModelConfig, step: str, base_dir: str = ".") -> ValidateResult:
    """Validate the sections required by `step` (reference ModelInspector.probe
    ModelInspector.java:113-170). Schema-level constraints run first via the
    bundled config meta (MetaFactory.java:44 parity, config/meta.py)."""
    result = ValidateResult()
    from shifu_tpu_torch.config.meta import validate_model_config

    for cause in validate_model_config(mc):
        result.fail(cause)
    if not mc.basic.name:
        result.fail("basic.name is empty")
    if mc.basic.run_mode is None:
        result.fail("basic.runMode invalid (LOCAL/MAPRED/DIST/TPU)")

    if step in (ModelStep.INIT, ModelStep.STATS, ModelStep.NORM, ModelStep.POSTTRAIN):
        _check_data_set(mc, result, base_dir)
    if step == ModelStep.STATS:
        _check_stats(mc, result)
    if step == ModelStep.NORM:
        _check_norm(mc, result)
    if step == ModelStep.VARSEL:
        _check_varsel(mc, result)
        _check_norm(mc, result)
    if step == ModelStep.TRAIN:
        _check_train(mc, result)
    if step == ModelStep.EVAL:
        _check_evals(mc, result, base_dir)
    return result

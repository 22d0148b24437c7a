"""ModelConfig: the single user-facing pipeline configuration.

The port's own copy of `shifu_tpu/config/model_config.py`, the same code and the same bytes on
disk; the port imports nothing of the JAX package.

Wire-compatible with the reference's ModelConfig.json — six sections
(container/obj/ModelConfig.java:65-95): basic, dataSet, stats, varSelect,
normalize, train, plus a list of evals (container/obj/EvalConfig.java:41).
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from shifu_tpu_torch.config.jsonbase import (
    JsonEnum,
    decode_dataclass,
    dump_json,
    encode_dataclass,
)


class RunMode(JsonEnum):
    """Execution mode. The reference has LOCAL/MAPRED/DIST
    (container/obj/ModelBasicConf.java:30); here MAPRED/DIST both mean "SPMD
    over the full device mesh" and LOCAL means single-device."""

    LOCAL = "LOCAL"
    MAPRED = "MAPRED"
    DIST = "DIST"
    TPU = "TPU"


class Algorithm(JsonEnum):
    """container/obj/ModelTrainConf.java:43-45."""

    NN = "NN"
    LR = "LR"
    SVM = "SVM"
    DT = "DT"
    RF = "RF"
    GBT = "GBT"
    TENSORFLOW = "TENSORFLOW"
    WDL = "WDL"


class BinningMethod(JsonEnum):
    """stats.binningMethod (container/obj/ModelStatsConf.java)."""

    EQUAL_POSITIVE = "EqualPositive"
    EQUAL_TOTAL = "EqualTotal"
    EQUAL_INTERVAL = "EqualInterval"
    EQUAL_NEGATIVE = "EqualNegative"
    WEIGHT_EQUAL_POSITIVE = "WeightEqualPositive"
    WEIGHT_EQUAL_NEGATIVE = "WeightEqualNegative"
    WEIGHT_EQUAL_TOTAL = "WeightEqualTotal"


class BinningAlgorithm(JsonEnum):
    """stats.binningAlgorithm — which engine builds numeric bins. All map to
    the same streaming-mergeable histogram here (SPDT-style)."""

    NATIVE = "Native"
    SPDT = "SPDT"
    SPDTI = "SPDTI"
    MUNRO_PAT = "MunroPat"
    MUNRO_PATI = "MunroPatI"
    DYNAMIC_BINNING = "DynamicBinning"


class NormType(JsonEnum):
    """normalize.normType (container/obj/ModelNormalizeConf.java:33-46)."""

    ZSCALE = "ZSCALE"
    ZSCORE = "ZSCORE"
    OLD_ZSCALE = "OLD_ZSCALE"
    OLD_ZSCORE = "OLD_ZSCORE"
    WOE = "WOE"
    WEIGHT_WOE = "WEIGHT_WOE"
    HYBRID = "HYBRID"
    WEIGHT_HYBRID = "WEIGHT_HYBRID"
    WOE_ZSCORE = "WOE_ZSCORE"
    WOE_ZSCALE = "WOE_ZSCALE"
    WEIGHT_WOE_ZSCORE = "WEIGHT_WOE_ZSCORE"
    WEIGHT_WOE_ZSCALE = "WEIGHT_WOE_ZSCALE"
    ONEHOT = "ONEHOT"
    ZSCALE_ONEHOT = "ZSCALE_ONEHOT"
    DISCRETE_ZSCORE = "DISCRETE_ZSCORE"
    DISCRETE_ZSCALE = "DISCRETE_ZSCALE"
    ASIS_WOE = "ASIS_WOE"
    ASIS_PR = "ASIS_PR"
    ZSCORE_INDEX = "ZSCORE_INDEX"
    ZSCALE_INDEX = "ZSCALE_INDEX"
    WOE_INDEX = "WOE_INDEX"
    WOE_ZSCALE_INDEX = "WOE_ZSCALE_INDEX"

    def is_woe(self) -> bool:
        return "WOE" in self.name and "ZS" not in self.name and "INDEX" not in self.name

    def is_weighted(self) -> bool:
        return self.name.startswith("WEIGHT_")


class MultipleClassification(JsonEnum):
    """train.multiClassifyMethod (container/obj/ModelTrainConf.java:54)."""

    NATIVE = "NATIVE"
    ONEVSALL = "ONEVSALL"
    ONEVSREST = "ONEVSREST"  # alias of ONEVSALL in the reference
    ONEVSONE = "ONEVSONE"  # not implemented upstream either


class MissingValueFillType(JsonEnum):
    MEAN = "MEAN"
    POSRATE = "POSRATE"
    ZERO = "ZERO"


DEFAULT_MISSING_VALUES = ["", "*", "#", "?", "null", "~"]


@dataclass
class CustomPathsMixin:
    pass


@dataclass
class ModelBasicConf:
    name: str = ""
    author: str = ""
    description: Optional[str] = None
    version: str = "0.1.0"
    run_mode: RunMode = RunMode.LOCAL
    post_train_on: bool = False
    custom_paths: Optional[Dict[str, str]] = field(default_factory=dict)


@dataclass
class RawSourceData:
    """dataSet section shared by the training set and each eval set
    (container/obj/RawSourceData.java:32)."""

    source: str = "LOCAL"
    data_path: str = ""
    data_delimiter: str = "|"
    header_path: Optional[str] = None
    header_delimiter: str = "|"
    filter_expressions: Optional[str] = ""
    weight_column_name: Optional[str] = ""


@dataclass
class ModelSourceDataConf(RawSourceData):
    target_column_name: str = ""
    pos_tags: List[str] = field(default_factory=list)
    neg_tags: List[str] = field(default_factory=list)
    missing_or_invalid_values: List[str] = field(
        default_factory=lambda: list(DEFAULT_MISSING_VALUES)
    )
    meta_column_name_file: Optional[str] = None
    categorical_column_name_file: Optional[str] = None
    autoType: bool = field(default=True, metadata={"json": "autoType"})
    auto_type_threshold: int = 10


@dataclass
class ModelStatsConf:
    max_num_bin: int = 10
    cate_max_num_bin: int = 0
    binning_method: BinningMethod = BinningMethod.EQUAL_POSITIVE
    sample_rate: float = 1.0
    sample_neg_only: bool = False
    binning_algorithm: BinningAlgorithm = BinningAlgorithm.SPDTI
    psi_column_name: Optional[str] = ""


@dataclass
class ModelVarSelectConf:
    force_enable: bool = True
    force_select_column_name_file: Optional[str] = None
    force_remove_column_name_file: Optional[str] = None
    filter_enable: bool = True
    filter_num: int = 200
    filter_out_ratio: float = 0.05
    filter_by: str = "KS"  # KS | IV | MIX | PARETO | FI | SE | ST
    wrapper_enabled: bool = False
    wrapper_num: int = 50
    wrapper_ratio: float = 0.05
    wrapper_by: str = "S"
    missing_rate_threshold: float = 0.98
    correlation_threshold: float = 1.0
    min_iv_threshold: float = 0.0
    min_ks_threshold: float = 0.0
    filter_by_se: bool = field(default=True, metadata={"json": "filterBySE"})
    params: Optional[Dict[str, Any]] = None


@dataclass
class ModelNormalizeConf:
    std_dev_cut_off: float = 4.0
    sample_rate: float = 1.0
    sample_neg_only: bool = False
    norm_type: NormType = NormType.ZSCALE
    is_parquet: bool = False
    category_missing_norm_type: MissingValueFillType = MissingValueFillType.POSRATE


@dataclass
class ModelTrainConf:
    bagging_num: int = 1
    bagging_with_replacement: bool = False
    bagging_sample_rate: float = 1.0
    valid_set_rate: float = 0.2
    num_train_epochs: int = 100
    epochs_per_iteration: int = 1
    train_on_disk: bool = False
    fix_initial_input: bool = False
    is_continuous: bool = False
    is_cross_over: bool = False
    worker_thread_count: int = 4
    up_sample_weight: float = 1.0
    num_k_fold: int = -1
    convergence_threshold: float = 0.0
    convergence_judger: str = "error"
    algorithm: Algorithm = Algorithm.NN
    multi_classify_method: MultipleClassification = MultipleClassification.NATIVE
    # legacy configs carry an explicit boolean; honored alongside the enum
    legacy_one_vs_all: bool = field(
        default=False, metadata={"json": "isOneVsAll"}
    )
    params: Dict[str, Any] = field(default_factory=dict)
    grid_config_file: Optional[str] = None
    custom_paths: Optional[Dict[str, str]] = field(default_factory=dict)

    def is_one_vs_all(self) -> bool:
        """ModelTrainConf.isOneVsAll: ONEVSALL and ONEVSREST both mean
        per-class binary models (ModelTrainConf.java:54); a legacy
        "isOneVsAll": true JSON field is honored too."""
        return self.legacy_one_vs_all or self.multi_classify_method in (
            MultipleClassification.ONEVSALL,
            MultipleClassification.ONEVSREST,
        )

    def get_param(self, key: str, default: Any = None) -> Any:
        """Params map is case-sensitive in the reference, but user configs vary;
        fall back to case-insensitive lookup."""
        if self.params is None:
            return default
        if key in self.params:
            return self.params[key]
        low = key.lower()
        for k, v in self.params.items():
            if k.lower() == low:
                return v
        return default


@dataclass
class EvalConfig:
    name: str = ""
    data_set: RawSourceData = field(default_factory=RawSourceData)
    performance_bucket_num: int = 10
    performance_score_selector: str = "mean"
    score_meta_column_name_file: Optional[str] = ""
    match_column_name: Optional[str] = ""
    pos_tags: Optional[List[str]] = None
    neg_tags: Optional[List[str]] = None
    custom_paths: Optional[Dict[str, str]] = field(default_factory=dict)
    gbt_convert_to_prob: bool = field(default=True, metadata={"json": "gbtConvertToProb"})
    gbt_score_convert_strategy: str = field(
        default="OLD_SIGMOID", metadata={"json": "gbtScoreConvertStrategy"}
    )


@dataclass
class ModelConfig:
    basic: ModelBasicConf = field(default_factory=ModelBasicConf)
    data_set: ModelSourceDataConf = field(default_factory=ModelSourceDataConf)
    stats: ModelStatsConf = field(default_factory=ModelStatsConf)
    var_select: ModelVarSelectConf = field(default_factory=ModelVarSelectConf)
    normalize: ModelNormalizeConf = field(default_factory=ModelNormalizeConf)
    train: ModelTrainConf = field(default_factory=ModelTrainConf)
    evals: List[EvalConfig] = field(default_factory=list)

    # ---- accessors mirroring the reference convenience API ----
    @property
    def model_set_name(self) -> str:
        return self.basic.name

    @property
    def algorithm(self) -> Algorithm:
        return self.train.algorithm

    def is_regression(self) -> bool:
        """Binary model with both tag sets (reference ModelConfig.java:376-384
        calls binary-with-pos+neg "regression" — score is a continuous
        probability-like output)."""
        return bool(self.data_set.pos_tags) and bool(self.data_set.neg_tags)

    def is_classification(self) -> bool:
        """Multi-class: exactly one of posTags/negTags set (reference XOR
        semantics) — each tag is its own class."""
        return bool(self.data_set.pos_tags) != bool(self.data_set.neg_tags)

    def is_multi_classification(self) -> bool:
        return self.is_classification() and len(self.tags()) > 2

    def tags(self) -> List[str]:
        return list(self.data_set.pos_tags) + list(self.data_set.neg_tags)

    def get_eval(self, name: str) -> Optional[EvalConfig]:
        for e in self.evals:
            if e.name == name:
                return e
        return None

    def is_local_mode(self) -> bool:
        return self.basic.run_mode == RunMode.LOCAL

    # ---- IO ----
    @classmethod
    def load(cls, path: str) -> "ModelConfig":
        import json

        from shifu_tpu_torch.utils.errors import ErrorCode, ShifuError

        with open(path) as fh:
            data = json.load(fh)
        try:
            return decode_dataclass(cls, data)
        except ValueError as e:
            raise ShifuError(ErrorCode.INVALID_MODEL_CONFIG, f"{path}: {e}")

    def save(self, path: str) -> None:
        dump_json(self, path)

    def to_json(self) -> dict:
        return encode_dataclass(self)


# ---------------------------------------------------------------------------
# Defaults for `shifu new` per algorithm
# (reference: ModelTrainConf.createParamsByAlg, container/obj/ModelTrainConf.java:531)
# ---------------------------------------------------------------------------

def default_train_params(alg: Algorithm) -> Dict[str, Any]:
    if alg in (Algorithm.NN, Algorithm.TENSORFLOW):
        return {
            "NumHiddenLayers": 1,
            "ActivationFunc": ["tanh"],
            "NumHiddenNodes": [50],
            "RegularizedConstant": 0.0,
            "LearningRate": 0.1,
            "Propagation": "R",
        }
    if alg == Algorithm.LR:
        return {"LearningRate": 0.1, "RegularizedConstant": 0.0, "L1orL2": "NONE"}
    if alg in (Algorithm.GBT, Algorithm.RF, Algorithm.DT):
        return {
            "TreeNum": 100 if alg == Algorithm.GBT else 10,
            "FeatureSubsetStrategy": "ALL" if alg == Algorithm.GBT else "TWOTHIRDS",
            "MaxDepth": 6 if alg == Algorithm.GBT else 10,
            "MaxStatsMemoryMB": 256,
            "Impurity": "variance",
            "LearningRate": 0.05,
            "MinInstancesPerNode": 5,
            "MinInfoGain": 0.0,
            "Loss": "squared",
        }
    if alg == Algorithm.WDL:
        return {
            "NumHiddenLayers": 2,
            "ActivationFunc": ["relu", "relu"],
            "NumHiddenNodes": [100, 50],
            "NumEmbedColumnIds": [],
            "EmbedOutputs": 8,
            "LearningRate": 0.005,
            "Optimizer": "ADAM",
            "L2Reg": 0.0,
        }
    if alg == Algorithm.SVM:
        return {"Kernel": "linear", "Const": 1.0, "Gamma": 1.0}
    return {}


def new_model_config(name: str, alg: Algorithm = Algorithm.NN) -> ModelConfig:
    mc = ModelConfig()
    mc.basic.name = name
    mc.basic.author = os.environ.get("USER", "shifu-tpu")
    mc.basic.description = "Created at %s" % datetime.datetime.now().strftime(
        "%Y-%m-%d %H:%M:%S"
    )
    mc.basic.run_mode = RunMode.LOCAL
    mc.data_set.data_path = "."
    mc.train.algorithm = alg
    mc.train.params = default_train_params(alg)
    eval_conf = EvalConfig(name="Eval1")
    eval_conf.data_set = RawSourceData()
    mc.evals = [eval_conf]
    return mc

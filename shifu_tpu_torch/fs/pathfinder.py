"""PathFinder: single source of truth for the on-disk artifact layout.

The port's own copy of `shifu_tpu/fs/pathfinder.py`, the same code and the same bytes on
disk; the port imports nothing of the JAX package.

Mirrors the contract of the reference's fs/PathFinder.java:38 — every pipeline
artifact (configs, stats outputs, normalized data, models, eval results, tmp
state) has exactly one canonical location under the model-set directory, so
steps communicate only through the filesystem and any step can be re-run.

Layout (relative to the model-set root):

    ModelConfig.json
    ColumnConfig.json
    models/                     final model specs (model0.nn, model1.gbt, ...)
    tmp/                        per-step intermediate state
      autotype/                 distinct-count sketches
      stats/                    per-column histogram shards
      norm/                     normalized dense matrix shards (.npy + meta)
      varsel/                   sensitivity outputs
      train/                    checkpoints, progress files, grid-search state
    evals/<EvalName>/           eval artifacts (scores, confusion, charts)
"""

from __future__ import annotations

import os
from typing import Optional


class PathFinder:
    MODEL_CONFIG = "ModelConfig.json"
    COLUMN_CONFIG = "ColumnConfig.json"

    def __init__(self, root: str = "."):
        self.root = os.path.abspath(root)

    # ---- config files ----
    def model_config_path(self) -> str:
        return os.path.join(self.root, self.MODEL_CONFIG)

    def column_config_path(self) -> str:
        return os.path.join(self.root, self.COLUMN_CONFIG)

    # ---- models ----
    def models_dir(self) -> str:
        return os.path.join(self.root, "models")

    def model_path(self, index: int, suffix: str) -> str:
        return os.path.join(self.models_dir(), f"model{index}.{suffix}")

    # ---- tmp per-step state ----
    def tmp_dir(self, step: Optional[str] = None) -> str:
        base = os.path.join(self.root, "tmp")
        return os.path.join(base, step) if step else base

    def autotype_path(self) -> str:
        return os.path.join(self.tmp_dir("autotype"), "count_info.json")

    def pre_train_stats_path(self) -> str:
        return os.path.join(self.tmp_dir("stats"), "pre_train_stats.json")

    def correlation_path(self) -> str:
        return os.path.join(self.tmp_dir("stats"), "correlation.csv")

    def psi_path(self) -> str:
        return os.path.join(self.tmp_dir("stats"), "psi.json")

    def normalized_data_dir(self) -> str:
        return os.path.join(self.tmp_dir("norm"), "NormalizedData")

    def normalized_validation_dir(self) -> str:
        return os.path.join(self.tmp_dir("norm"), "NormalizedValidationData")

    def cleaned_data_dir(self) -> str:
        # GBT/RF trains on "cleaned" (selected raw) columns, not z-scored ones
        # (reference TrainModelProcessor.java:1366-1372).
        return os.path.join(self.tmp_dir("norm"), "CleanedData")

    def shuffle_dir(self) -> str:
        return os.path.join(self.tmp_dir("norm"), "ShuffledData")

    def varsel_dir(self) -> str:
        return self.tmp_dir("varsel")

    def se_report_path(self) -> str:
        return os.path.join(self.varsel_dir(), "se.csv")

    def train_dir(self) -> str:
        return self.tmp_dir("train")

    def checkpoint_dir(self, trainer_id: int) -> str:
        return os.path.join(self.train_dir(), f"checkpoint_{trainer_id}")

    def tmp_model_path(self, trainer_id: int, suffix: str) -> str:
        return os.path.join(self.train_dir(), f"tmp_model{trainer_id}.{suffix}")

    def progress_path(self, trainer_id: int) -> str:
        return os.path.join(self.train_dir(), f"progress_{trainer_id}.log")

    def val_error_path(self, trainer_id: int) -> str:
        return os.path.join(self.train_dir(), f"val_error_{trainer_id}.txt")

    def feature_importance_path(self) -> str:
        return os.path.join(self.tmp_dir("posttrain"), "feature_importance.csv")

    def bin_avg_score_path(self) -> str:
        return os.path.join(self.tmp_dir("posttrain"), "bin_avg_score.json")

    # ---- evals ----
    def eval_dir(self, eval_name: str) -> str:
        return os.path.join(self.root, "evals", eval_name)

    def eval_score_path(self, eval_name: str) -> str:
        return os.path.join(self.eval_dir(eval_name), "EvalScore.csv")

    def eval_norm_path(self, eval_name: str) -> str:
        return os.path.join(self.eval_dir(eval_name), "EvalNorm.csv")

    def eval_performance_path(self, eval_name: str) -> str:
        return os.path.join(self.eval_dir(eval_name), "EvalPerformance.json")

    def eval_confusion_path(self, eval_name: str) -> str:
        return os.path.join(self.eval_dir(eval_name), "EvalConfusionMatrix.csv")

    def gain_chart_path(self, eval_name: str) -> str:
        return os.path.join(self.eval_dir(eval_name), "gainchart.html")

    # ---- export ----
    def export_dir(self) -> str:
        return os.path.join(self.root, "export")

    def pmml_path(self, index: int) -> str:
        return os.path.join(self.export_dir(), f"model{index}.pmml")

    # ---- model-set versioning (ManageModelProcessor parity) ----
    def backup_dir(self, version: str) -> str:
        return os.path.join(self.root, ".shifu", "backup", version)

    def ensure(self, path: str) -> str:
        os.makedirs(path, exist_ok=True)
        return path

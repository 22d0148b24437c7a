"""Enumerated framework errors (reference: exception/ShifuErrorCode.java)."""

from __future__ import annotations

import enum


class ErrorCode(enum.Enum):
    INVALID_MODEL_CONFIG = "invalid ModelConfig"
    INVALID_COLUMN_CONFIG = "invalid ColumnConfig"
    MODEL_CONFIG_NOT_FOUND = "ModelConfig.json not found; run `shifu new` first"
    COLUMN_CONFIG_NOT_FOUND = "ColumnConfig.json not found; run `shifu init` first"
    DATA_NOT_FOUND = "training data path not found"
    HEADER_NOT_FOUND = "header file not found"
    TARGET_NOT_FOUND = "target column not found in header"
    STATS_NOT_RUN = "column stats missing; run `shifu stats` first"
    NORM_NOT_RUN = "normalized data missing; run `shifu norm` first"
    MODEL_NOT_FOUND = "no trained model found; run `shifu train` first"
    EVAL_NOT_FOUND = "eval set not found in ModelConfig.evals"
    INVALID_ALGORITHM = "unsupported algorithm"
    INVALID_FILTER_EXPR = "invalid filter expression"
    GRID_CONFIG_INVALID = "invalid grid-search config"
    ILLEGAL_ARGUMENT = "illegal argument"


class ShifuError(Exception):
    def __init__(self, code: ErrorCode, detail: str = ""):
        self.code = code
        self.detail = detail
        msg = code.value if not detail else f"{code.value}: {detail}"
        super().__init__(msg)

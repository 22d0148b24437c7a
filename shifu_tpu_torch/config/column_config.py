"""ColumnConfig: per-column state threaded through the whole pipeline.

The port's own copy of `shifu_tpu/config/column_config.py`, the same code and the same bytes on
disk; the port imports nothing of the JAX package.

Wire-compatible with the reference's ColumnConfig.json
(container/obj/ColumnConfig.java:35, ColumnStats.java:33, ColumnBinning.java:38).

Conventions carried over from the reference:
  - ``column_type``: "N" numeric, "C" categorical, "H" hybrid
    (container/obj/ColumnType.java).
  - ``bin_boundary`` for numeric columns starts at -Infinity (serialized as the
    string "-Infinity"), bin i covers [boundary[i], boundary[i+1]).
  - All per-bin count/weight arrays have length ``len(bins) + 1``; the LAST slot
    is the missing-value bin (core/binning/UpdateBinningInfoReducer.java:180-200).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from dataclasses import dataclass, field
from typing import Any, List, Optional

from shifu_tpu_torch.config.jsonbase import JsonEnum, decode_dataclass, encode_dataclass


class ColumnType(JsonEnum):
    N = "N"  # numeric
    C = "C"  # categorical
    H = "H"  # hybrid (numeric with some category-like values)


class ColumnFlag(JsonEnum):
    FORCE_SELECT = "ForceSelect"
    FORCE_REMOVE = "ForceRemove"
    META = "Meta"
    TARGET = "Target"
    WEIGHT = "Weight"
    CANDIDATE = "Candidate"


@dataclass
class ColumnStats:
    max: Optional[float] = None
    min: Optional[float] = None
    mean: Optional[float] = None
    median: Optional[float] = None
    total_count: Optional[int] = None
    distinct_count: Optional[int] = None
    missing_count: Optional[int] = None
    std_dev: Optional[float] = None
    missing_percentage: Optional[float] = None
    woe: Optional[float] = None
    ks: Optional[float] = None
    iv: Optional[float] = None
    weighted_ks: Optional[float] = None
    weighted_iv: Optional[float] = None
    weighted_woe: Optional[float] = None
    skewness: Optional[float] = None
    kurtosis: Optional[float] = None
    psi: Optional[float] = None
    unit_stats: Optional[List[str]] = None


@dataclass
class ColumnBinning:
    length: int = 0
    bin_boundary: Optional[List[float]] = None
    bin_category: Optional[List[str]] = None
    bin_count_neg: Optional[List[int]] = None
    bin_count_pos: Optional[List[int]] = None
    bin_pos_rate: Optional[List[float]] = None
    bin_avg_score: Optional[List[float]] = None
    bin_weighted_neg: Optional[List[float]] = None
    bin_weighted_pos: Optional[List[float]] = None
    bin_count_woe: Optional[List[float]] = None
    bin_weighted_woe: Optional[List[float]] = None


@dataclass
class ColumnConfig:
    column_num: int = 0
    column_name: str = ""
    version: str = "0.2.0"
    column_type: Optional[ColumnType] = None
    column_flag: Optional[ColumnFlag] = None
    final_select: bool = False
    column_stats: ColumnStats = field(default_factory=ColumnStats)
    column_binning: ColumnBinning = field(default_factory=ColumnBinning)

    # ---- role predicates (reference ColumnConfig.java isTarget/isMeta/...) ----
    def is_target(self) -> bool:
        return self.column_flag == ColumnFlag.TARGET

    def is_meta(self) -> bool:
        return self.column_flag == ColumnFlag.META

    def is_weight(self) -> bool:
        return self.column_flag == ColumnFlag.WEIGHT

    def is_force_select(self) -> bool:
        return self.column_flag == ColumnFlag.FORCE_SELECT

    def is_force_remove(self) -> bool:
        return self.column_flag == ColumnFlag.FORCE_REMOVE

    def is_candidate(self) -> bool:
        return self.column_flag == ColumnFlag.CANDIDATE

    def is_categorical(self) -> bool:
        return self.column_type == ColumnType.C

    def is_numerical(self) -> bool:
        return self.column_type == ColumnType.N

    def is_hybrid(self) -> bool:
        return self.column_type == ColumnType.H

    # Non-target/meta/weight/force-remove column usable as a model feature.
    def is_feature(self) -> bool:
        return self.column_flag not in (
            ColumnFlag.TARGET,
            ColumnFlag.META,
            ColumnFlag.WEIGHT,
            ColumnFlag.FORCE_REMOVE,
        )

    # ---- convenience accessors mirroring the reference API ----
    @property
    def mean(self) -> Optional[float]:
        return self.column_stats.mean

    @property
    def std_dev(self) -> Optional[float]:
        return self.column_stats.std_dev

    @property
    def ks(self) -> Optional[float]:
        return self.column_stats.ks

    @property
    def iv(self) -> Optional[float]:
        return self.column_stats.iv

    @property
    def missing_percentage(self) -> Optional[float]:
        return self.column_stats.missing_percentage

    @property
    def bin_boundary(self) -> Optional[List[float]]:
        return self.column_binning.bin_boundary

    @property
    def bin_category(self) -> Optional[List[str]]:
        return self.column_binning.bin_category

    @property
    def bin_pos_rate(self) -> Optional[List[float]]:
        return self.column_binning.bin_pos_rate

    @property
    def bin_count_woe(self) -> Optional[List[float]]:
        return self.column_binning.bin_count_woe

    @property
    def bin_weighted_woe(self) -> Optional[List[float]]:
        return self.column_binning.bin_weighted_woe

    def bin_length(self) -> int:
        return self.column_binning.length


def _encode_boundary(values: Optional[List[float]]) -> Optional[List[Any]]:
    """-inf/inf floats are written as "-Infinity"/"Infinity" strings, matching
    Jackson's rendering in the reference fixtures."""
    if values is None:
        return None
    out: List[Any] = []
    for v in values:
        if v == -math.inf:
            out.append("-Infinity")
        elif v == math.inf:
            out.append("Infinity")
        else:
            out.append(v)
    return out


def column_config_to_json(cc: ColumnConfig) -> dict:
    raw = encode_dataclass(cc)
    raw["columnBinning"]["binBoundary"] = _encode_boundary(cc.column_binning.bin_boundary)
    return raw


def column_config_from_json(data: dict) -> ColumnConfig:
    # jsonbase._decode's float path already parses "-Infinity"/"Infinity"
    # boundary strings for List[float] fields.
    return decode_dataclass(ColumnConfig, data)


def save_column_config_list(path: str, columns: List[ColumnConfig]) -> None:
    # tmp + replace: concurrent readers (a peer host process polling for
    # the merge host's post-stats write, serve hot-reload) must see the
    # old or the new complete file, never a torn one
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as fh:
        json.dump([column_config_to_json(c) for c in columns], fh, indent=2)
        fh.write("\n")
    os.replace(tmp, path)


def load_column_config_list(path: str) -> List[ColumnConfig]:
    with open(path) as fh:
        data = json.load(fh)
    return [column_config_from_json(d) for d in data]

"""Normalization: the NormType bank that produces the dense training matrix
(counterpart of `shifu_tpu/norm/normalizer.py`).

Semantic parity with the reference's row-at-a-time dispatcher
(core/Normalizer.java:235-302 `normalize`, `fullNormalize`) and the Pig UDF
that drives it (udf/NormalizeUDF.java:256). Per column, a lookup table over
bin slots or z-scale parameters are built on the host; then two torch
functions run over the whole matrix on the device: `value_norm` (clamp,
subtract, divide over the [n, Cv] raw values) and `table_norm` (a gather
over padded [Ct, maxS] tables by the [n, Ct] bin codes). One-hot types
expand on the host from the same codes. The bin codes themselves are
built on the host, as in the JAX package.

Norm types (container/obj/ModelNormalizeConf.java:33-46):
  ZSCALE/ZSCORE      numeric: clamp to mean±cutoff*std then (v-mean)/std
                     (Normalizer.computeZScore:771-787); categorical: value =
                     binPosRate[bin] (missing/unseen -> posrate of the missing
                     bin or mean, Normalizer.parseRawValue:520-577 +
                     fillDefaultValue:579-592), then the same z-score.
  OLD_ZSCALE/ZSCORE  same, but categorical stays raw posrate (no z-score,
                     Normalizer.zScoreNormalize isOld branch :446-452).
  WOE / WEIGHT_WOE   binCountWoe/binWeightedWoe lookup; missing -> last bin
                     (Normalizer.woeNormalize:618-648).
  WOE_ZSCORE/ZSCALE (+WEIGHT_) z-score of the woe value, with woe mean/std
                     computed from bin counts (calculateWoeMeanAndStdDev:728).
  HYBRID/WEIGHT_HYBRID  numeric -> z-score, categorical -> (weight) woe
                     (Normalizer.hybridNormalize:683-697).
  ONEHOT             one output column per bin slot incl. missing slot
                     (Normalizer.OneHotNormalize:380-391).
  ZSCALE_ONEHOT      numeric -> z-score, categorical -> one-hot (:393-409).
  DISCRETE_ZSCORE/ZSCALE  numeric value snapped to its bin's lower boundary
                     (bin0 -> min), then z-score (:455-487).
  ASIS_WOE/ASIS_PR   numeric raw (invalid -> mean); categorical -> woe /
                     posrate (:353-378).
  ZSCORE_INDEX/ZSCALE_INDEX  numeric z-score; categorical -> bin index float,
                     missing -> len(categories) (fullNormalize:305-334).
  WOE_INDEX          numeric woe; categorical index.
  WOE_ZSCALE_INDEX   numeric woe-zscore; categorical index.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from shifu_tpu_torch.config import ColumnConfig
from shifu_tpu_torch.config.model_config import (
    MissingValueFillType,
    ModelConfig,
    NormType,
)
from shifu_tpu_torch.data.reader import ColumnarData
from shifu_tpu_torch.obs import profile
from shifu_tpu_torch.stats.binning import (
    category_index,
    hybrid_bin_index,
    numeric_bin_index,
)
from shifu_tpu_torch.utils.platform import DeviceLike, resolve_device

STD_DEV_CUTOFF = 4.0  # Normalizer.STD_DEV_CUTOFF
MIN_STD = 1e-5  # Normalizer.computeZScore: stdDev > 0.00001 guard


def norm_columns(columns: List[ColumnConfig]) -> List[ColumnConfig]:
    """Columns emitted into the normalized matrix: final-selected if varsel has
    run, else every good candidate with stats (NormalizeUDF emits candidates
    pre-varsel, finalSelect post-varsel — udf/NormalizeUDF.java:167-199)."""
    selected = [c for c in columns if c.final_select and c.is_feature()]
    if selected:
        return selected
    return [
        c
        for c in columns
        if c.is_feature()
        and (
            c.column_binning.bin_boundary is not None
            or c.column_binning.bin_category is not None
        )
    ]


def _slots(cc: ColumnConfig) -> int:
    """Bin-slot count incl. the trailing missing slot."""
    if cc.is_categorical():
        return len(cc.column_binning.bin_category or []) + 1
    if cc.is_hybrid():
        return (len(cc.column_binning.bin_boundary or [float("-inf")])
                + len(cc.column_binning.bin_category or []) + 1)
    return len(cc.column_binning.bin_boundary or [float("-inf")]) + 1


def _zscore_params(cc: ColumnConfig) -> Tuple[float, float]:
    mean = cc.column_stats.mean or 0.0
    std = cc.column_stats.std_dev or 0.0
    return mean, std


def _woe_table(cc: ColumnConfig, weighted: bool) -> np.ndarray:
    woe = (
        cc.column_binning.bin_weighted_woe
        if weighted
        else cc.column_binning.bin_count_woe
    )
    s = _slots(cc)
    if not woe:
        return np.zeros(s, dtype=np.float64)
    t = np.asarray(woe, dtype=np.float64)
    if t.size < s:
        t = np.pad(t, (0, s - t.size), constant_values=t[-1] if t.size else 0.0)
    return t[:s]


def _posrate_table(cc: ColumnConfig) -> np.ndarray:
    pr = cc.column_binning.bin_pos_rate
    s = _slots(cc)
    if not pr:
        return np.zeros(s, dtype=np.float64)
    t = np.asarray([p if p is not None else 0.0 for p in pr], dtype=np.float64)
    if t.size < s:
        t = np.pad(t, (0, s - t.size), constant_values=0.0)
    return t[:s]


def woe_mean_std(cc: ColumnConfig, weighted: bool) -> Tuple[float, float]:
    """Normalizer.calculateWoeMeanAndStdDev:728-754 — count-weighted mean/std
    of the per-bin woe values (incl. missing bin), sample-variance denominator."""
    woe = _woe_table(cc, weighted)
    pos = np.asarray(cc.column_binning.bin_count_pos or [], dtype=np.float64)
    neg = np.asarray(cc.column_binning.bin_count_neg or [], dtype=np.float64)
    s = min(len(woe), len(pos), len(neg))
    if s == 0:
        return 0.0, 0.0
    cnt = pos[:s] + neg[:s]
    total = cnt.sum()
    if total <= 1:
        return 0.0, 0.0
    ssum = float((woe[:s] * cnt).sum())
    sq = float((woe[:s] * woe[:s] * cnt).sum())
    mean = ssum / total
    std = math.sqrt(abs((sq - ssum * ssum / total) / (total - 1)))
    return mean, std


def _cat_fill_value(cc: ColumnConfig, fill: MissingValueFillType) -> float:
    """Missing/unseen categorical value -> posrate of missing bin (POSRATE)
    or column mean (Normalizer.fillDefaultValue:579-592)."""
    if fill == MissingValueFillType.POSRATE:
        pr = _posrate_table(cc)
        return float(pr[-1]) if pr.size else 0.0
    return cc.column_stats.mean or 0.0


@dataclass
class ColumnNormSpec:
    """How one input column maps into the output matrix."""

    cc: ColumnConfig
    kind: str  # "value" | "table" | "onehot"
    out_names: List[str]
    # value kind: raw numeric value, missing -> fill, then affine+clamp
    fill: float = 0.0
    mean: float = 0.0
    std: float = 0.0
    zscore: bool = True
    # table kind: per-bin-slot lookup
    table: Optional[np.ndarray] = None

    @property
    def n_out(self) -> int:
        return len(self.out_names)


@dataclass
class NormPlan:
    specs: List[ColumnNormSpec]
    norm_type: NormType
    cutoff: float

    @property
    def out_names(self) -> List[str]:
        names: List[str] = []
        for s in self.specs:
            names.extend(s.out_names)
        return names

    @property
    def n_out(self) -> int:
        return sum(s.n_out for s in self.specs)

    @property
    def source_of(self) -> Dict[str, str]:
        """output column name -> source ColumnConfig name (one-hot style
        norms expand one source into several outputs)."""
        out: Dict[str, str] = {}
        for s in self.specs:
            for on in s.out_names:
                out[on] = s.cc.column_name
        return out


def _value_spec(
    cc: ColumnConfig, cutoff: float, fill: Optional[float] = None, zscore: bool = True
) -> ColumnNormSpec:
    mean, std = _zscore_params(cc)
    return ColumnNormSpec(
        cc=cc,
        kind="value",
        out_names=[cc.column_name],
        fill=mean if fill is None else fill,
        mean=mean,
        std=std,
        zscore=zscore,
    )


def _table_spec(cc: ColumnConfig, table: np.ndarray) -> ColumnNormSpec:
    return ColumnNormSpec(
        cc=cc, kind="table", out_names=[cc.column_name], table=table
    )


def _zscored_table(
    cc: ColumnConfig, table: np.ndarray, mean: float, std: float, cutoff: float
) -> np.ndarray:
    """Fold the z-score affine+clamp into the lookup table itself — tables are
    tiny, so pre-transforming them keeps the device work a pure gather."""
    lo, hi = mean - cutoff * std, mean + cutoff * std
    t = np.clip(table, lo, hi)
    if std > MIN_STD:
        return (t - mean) / std
    return np.zeros_like(t)


def _index_table(cc: ColumnConfig) -> np.ndarray:
    """Categorical bin index as float; missing slot -> len(categories)
    (fullNormalize index branches)."""
    return np.arange(_slots(cc), dtype=np.float64)


def build_column_spec(
    cc: ColumnConfig,
    norm_type: NormType,
    cutoff: float,
    fill: MissingValueFillType,
) -> ColumnNormSpec:
    nt = norm_type
    is_cat = cc.is_categorical()
    mean, std = _zscore_params(cc)

    if nt in (NormType.WOE, NormType.WEIGHT_WOE):
        return _table_spec(cc, _woe_table(cc, nt == NormType.WEIGHT_WOE))

    if nt in (
        NormType.WOE_ZSCORE,
        NormType.WOE_ZSCALE,
        NormType.WEIGHT_WOE_ZSCORE,
        NormType.WEIGHT_WOE_ZSCALE,
    ):
        weighted = nt.name.startswith("WEIGHT_")
        t = _woe_table(cc, weighted)
        wm, ws = woe_mean_std(cc, weighted)
        return _table_spec(cc, _zscored_table(cc, t, wm, ws, cutoff))

    if nt in (NormType.HYBRID, NormType.WEIGHT_HYBRID):
        # hybridNormalize (Normalizer.java:683): NUMERICAL columns z-score,
        # everything else (categorical AND hybrid-H) takes the woe path
        if is_cat or cc.is_hybrid():
            return _table_spec(cc, _woe_table(cc, nt == NormType.WEIGHT_HYBRID))
        return _value_spec(cc, cutoff)

    if nt == NormType.ONEHOT or (nt == NormType.ZSCALE_ONEHOT and is_cat):
        s = _slots(cc)
        return ColumnNormSpec(
            cc=cc,
            kind="onehot",
            out_names=[f"{cc.column_name}_{i}" for i in range(s)],
        )
    if nt == NormType.ZSCALE_ONEHOT:
        return _value_spec(cc, cutoff)

    if nt in (NormType.DISCRETE_ZSCORE, NormType.DISCRETE_ZSCALE):
        if is_cat:
            t = _posrate_table(cc)
            t[-1] = _cat_fill_value(cc, fill)
            return _table_spec(cc, _zscored_table(cc, t, mean, std, cutoff))
        # numeric: value snapped to bin lower boundary; bin0 -> min; missing -> mean
        bounds = np.asarray(
            cc.column_binning.bin_boundary or [float("-inf")], dtype=np.float64
        )
        t = bounds.copy()
        t[0] = cc.column_stats.min if cc.column_stats.min is not None else 0.0
        t = np.append(t, mean)  # missing slot
        return _table_spec(cc, _zscored_table(cc, t, mean, std, cutoff))

    if nt in (NormType.ASIS_WOE, NormType.ASIS_PR):
        if is_cat:
            t = (
                _woe_table(cc, False)
                if nt == NormType.ASIS_WOE
                else _posrate_table(cc)
            )
            return _table_spec(cc, t)
        return _value_spec(cc, cutoff, zscore=False)

    if nt in (NormType.ZSCORE_INDEX, NormType.ZSCALE_INDEX):
        if is_cat:
            return _table_spec(cc, _index_table(cc))
        return _value_spec(cc, cutoff)

    if nt == NormType.WOE_INDEX:
        if is_cat:
            return _table_spec(cc, _index_table(cc))
        return _table_spec(cc, _woe_table(cc, False))

    if nt == NormType.WOE_ZSCALE_INDEX:
        if is_cat:
            return _table_spec(cc, _index_table(cc))
        t = _woe_table(cc, False)
        wm, ws = woe_mean_std(cc, False)
        return _table_spec(cc, _zscored_table(cc, t, wm, ws, cutoff))

    if nt in (NormType.OLD_ZSCALE, NormType.OLD_ZSCORE):
        if is_cat:
            t = _posrate_table(cc)
            t[-1] = _cat_fill_value(cc, fill)
            return _table_spec(cc, t)  # raw posrate, no z-score
        return _value_spec(cc, cutoff)

    # ZSCALE / ZSCORE / default
    if is_cat:
        t = _posrate_table(cc)
        t[-1] = _cat_fill_value(cc, fill)
        return _table_spec(cc, _zscored_table(cc, t, mean, std, cutoff))
    return _value_spec(cc, cutoff)


def build_norm_plan(
    mc: ModelConfig, columns: List[ColumnConfig]
) -> NormPlan:
    nt = mc.normalize.norm_type
    cutoff = mc.normalize.std_dev_cut_off
    # reference checkCutOff (Normalizer.java:708) rejects only null/NaN/Inf —
    # an explicit 0.0 is legal (clamps everything to the mean)
    if cutoff is None or not math.isfinite(cutoff):
        cutoff = STD_DEV_CUTOFF
    fill = mc.normalize.category_missing_norm_type
    specs = [
        build_column_spec(cc, nt, cutoff, fill) for cc in norm_columns(columns)
    ]
    return NormPlan(specs=specs, norm_type=nt, cutoff=cutoff)


# ---------------------------------------------------------------------------
# Bin codes (host)
# ---------------------------------------------------------------------------


def _bin_codes_for(
    cc: ColumnConfig, data: ColumnarData, cache: Optional[dict] = None
) -> np.ndarray:
    if cache is not None and cc.column_name in cache:
        return cache[cc.column_name]
    if cc.is_categorical():
        out = category_index(data, cc.column_name,
                             cc.column_binning.bin_category or [])
    elif cc.is_hybrid():
        out = hybrid_bin_index(
            data.column(cc.column_name),
            cc.column_binning.bin_boundary or [float("-inf")],
            cc.column_binning.bin_category or [],
            data.missing_mask(cc.column_name),
        )
    else:
        bounds = cc.column_binning.bin_boundary or [float("-inf")]
        out = numeric_bin_index(data.numeric(cc.column_name), bounds)
    if cache is not None:
        cache[cc.column_name] = out
    return out


def bin_code_matrix(
    columns: Sequence[ColumnConfig],
    data: ColumnarData,
    cache: Optional[dict] = None,
) -> np.ndarray:
    """[n_rows, n_cols] int32 bin codes — the tree engine's native input
    (replaces the reference's CleanedData raw-column path,
    TrainModelProcessor.java:1366-1372: trees consume bin indices anyway via
    DTWorker bin-index columns). `cache` shares per-column codes with
    apply_norm_plan so the binning pass runs once per column."""
    n = data.n_rows
    out = np.zeros((n, len(columns)), dtype=np.int32)
    for j, cc in enumerate(columns):
        out[:, j] = _bin_codes_for(cc, data, cache)
    return out


# ---------------------------------------------------------------------------
# The device work
# ---------------------------------------------------------------------------


def value_params(mean: np.ndarray, std: np.ndarray, zs: np.ndarray,
                 cutoff: float) -> Tuple[np.ndarray, ...]:
    """The per-column f32 operands of `value_norm`, made once on the host
    so every device clamps at the same bounds: lo, hi = mean ∓ cutoff·std
    in f32, the product rounded before the sum (XLA's CPU backend does not
    fuse them here: `tests/test_torch_norm.py` holds values at both
    bounds); the divisor (1 where std is degenerate), and the masks of
    z-scored and non-degenerate columns."""
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    span = np.float32(cutoff) * std
    lo, hi = mean - span, mean + span
    ok = std > np.float32(MIN_STD)
    safe = np.where(ok, std, np.float32(1.0))
    return lo, hi, mean, safe, ok, np.asarray(zs, np.float32) > 0


def value_norm(v: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
               mean: torch.Tensor, safe: torch.Tensor, ok: torch.Tensor,
               zs: torch.Tensor) -> torch.Tensor:
    """The per-column z-score norm over [n, Cv] f32 values (counterpart of
    `value_norm_traced`): clamp to [lo, hi] then (v-mean)/std, degenerate-std
    columns -> 0, non-zscore (ASIS) columns pass through UNclamped
    (asIsNormalize parity: only invalid values are touched, never
    clamped). The operands come from `value_params`."""
    clamped = torch.minimum(torch.maximum(v, lo[None, :]), hi[None, :])
    z = torch.where(ok[None, :], (clamped - mean[None, :]) / safe[None, :],
                    torch.zeros((), dtype=v.dtype, device=v.device))
    return torch.where(zs[None, :], z, v)


def table_norm(codes: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """The per-bin-slot lookup ([n, Ct] codes over padded [Ct, maxS]
    tables; counterpart of `table_norm_traced`)."""
    idx = torch.clamp(codes.long(), 0, tables.shape[1] - 1)
    return torch.gather(tables.T, 0, idx)


def apply_norm_plan(
    plan: NormPlan,
    data: ColumnarData,
    device: DeviceLike = None,
    code_cache: Optional[dict] = None,
    timings: Optional[Dict[str, float]] = None,
) -> np.ndarray:
    """Produce the dense normalized matrix [n_rows, plan.n_out] float32. The
    value and table matrices go to `device` (default: the card) and come
    back; one-hot columns expand on the host. `timings`, when given,
    receives the device milliseconds of the two functions
    (`normalize_device_ms`, cuda only).

    Raises ValueError when the plan is empty (stats not run / all columns
    removed) instead of crashing in concatenate.
    """
    if not plan.specs:
        raise ValueError(
            "no columns to normalize — run `shifu stats` first or check "
            "column flags/finalSelect"
        )
    dev = resolve_device(device)
    n = data.n_rows
    value_specs = [s for s in plan.specs if s.kind == "value"]
    table_specs = [s for s in plan.specs if s.kind == "table"]
    onehot_specs = [s for s in plan.specs if s.kind == "onehot"]

    inputs = {}
    # ---- value columns: one [n, Cv] matrix ----
    if value_specs:
        # missing-fill happens in float64 BEFORE the float32 cast so huge
        # finite raw values overflow to inf and get CLAMPED (reference
        # computeZScore clamps), not mistaken for missing and mean-filled
        vals64 = np.stack(
            [data.numeric(s.cc.column_name) for s in value_specs], axis=1
        )
        fill = np.asarray([s.fill for s in value_specs], dtype=np.float32)
        with np.errstate(over="ignore"):  # the overflow to inf is meant
            vals = np.where(
                np.isfinite(vals64), vals64, fill.astype(np.float64)[None, :]
            ).astype(np.float32)
        params = value_params(
            np.asarray([s.mean for s in value_specs], dtype=np.float32),
            np.asarray([s.std for s in value_specs], dtype=np.float32),
            np.asarray([1.0 if s.zscore else 0.0 for s in value_specs],
                       np.float32),
            plan.cutoff)
        inputs["value"] = [vals, *params]
    # ---- table columns: one [n, Ct] gather over padded tables ----
    if table_specs:
        codes = np.stack(
            [_bin_codes_for(s.cc, data, code_cache) for s in table_specs], axis=1
        )
        max_s = max(s.table.size for s in table_specs)
        tables = np.zeros((len(table_specs), max_s), dtype=np.float32)
        for k, s in enumerate(table_specs):
            tables[k, : s.table.size] = s.table
        inputs["table"] = [codes, tables]

    args = {k: [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in v] for k, v in inputs.items()}
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
    out = {}
    if "value" in args:
        out["value"] = profile.dispatch("norm.value_kernel", value_norm,
                                        *args["value"], sync=False)
    if "table" in args:
        out["table"] = profile.dispatch("norm.table_kernel", table_norm,
                                        *args["table"], sync=False)
    if cuda:
        ev[1].record()
    out = {k: v.cpu().numpy() for k, v in out.items()}
    if cuda and timings is not None:
        timings["normalize_device_ms"] = ev[0].elapsed_time(ev[1])

    pieces: dict = {}
    for kind, specs in (("value", value_specs), ("table", table_specs)):
        for k, s in enumerate(specs):
            pieces[id(s)] = out[kind][:, k: k + 1]

    # ---- onehot columns: host expansion (sparse -> dense slots) ----
    for s in onehot_specs:
        codes = _bin_codes_for(s.cc, data, code_cache)
        width = s.n_out
        oh = np.zeros((n, width), dtype=np.float32)
        idx = np.clip(codes, 0, width - 1)
        oh[np.arange(n), idx] = 1.0
        pieces[id(s)] = oh

    return np.concatenate([pieces[id(s)] for s in plan.specs], axis=1)


def spec_to_json(s: ColumnNormSpec) -> dict:
    """Serializable summary of one column's norm mapping — embedded in model
    specs so independent scorers can normalize raw records (the reference
    embeds NNColumnStats in BinaryNNSerializer for the same reason)."""
    d: dict = {"name": s.cc.column_name, "kind": s.kind, "outNames": s.out_names}
    if s.kind == "value":
        d.update(fill=s.fill, mean=s.mean, std=s.std, zscore=s.zscore)
    elif s.kind == "table":
        d["table"] = [float(x) for x in s.table]
    if s.cc.is_categorical():
        d["categories"] = list(s.cc.column_binning.bin_category or [])
    elif s.cc.is_hybrid():
        d["hybrid"] = True
        d["categories"] = list(s.cc.column_binning.bin_category or [])
        d["boundaries"] = [float(b) for b in (s.cc.column_binning.bin_boundary or [])]
    else:
        d["boundaries"] = [float(b) for b in (s.cc.column_binning.bin_boundary or [])]
    return d


def plan_to_json(plan: NormPlan) -> dict:
    return {
        "normType": plan.norm_type.value,
        "cutoff": plan.cutoff,
        "columns": [spec_to_json(s) for s in plan.specs],
    }


def plan_from_json(d: dict) -> NormPlan:
    """Rebuild an applicable NormPlan from a model-embedded norm summary, so
    independent scorers normalize raw eval records without ColumnConfig."""
    from shifu_tpu_torch.config.column_config import ColumnType

    specs = []
    for cd in d.get("columns", []):
        cc = ColumnConfig(column_name=cd["name"])
        if cd.get("hybrid"):
            cc.column_type = ColumnType.H
            cc.column_binning.bin_category = list(cd.get("categories", []))
            cc.column_binning.bin_boundary = [
                float(b) for b in cd.get("boundaries", [])
            ]
        elif "categories" in cd:
            cc.column_type = ColumnType.C
            cc.column_binning.bin_category = list(cd["categories"])
        else:
            cc.column_type = ColumnType.N
            cc.column_binning.bin_boundary = [float(b) for b in cd.get("boundaries", [])]
        kind = cd["kind"]
        spec = ColumnNormSpec(
            cc=cc,
            kind=kind,
            out_names=list(cd["outNames"]),
            fill=float(cd.get("fill", 0.0)),
            mean=float(cd.get("mean", 0.0)),
            std=float(cd.get("std", 0.0)),
            zscore=bool(cd.get("zscore", True)),
            table=np.asarray(cd["table"], dtype=np.float64)
            if cd.get("table") is not None
            else None,
        )
        specs.append(spec)
    nt = NormType.parse(d.get("normType", "ZSCALE"))
    return NormPlan(specs=specs, norm_type=nt, cutoff=float(d.get("cutoff", 4.0)))


def normalize_dataset(
    mc: ModelConfig,
    columns: List[ColumnConfig],
    data: ColumnarData,
    device: DeviceLike = None,
) -> Tuple[np.ndarray, List[str]]:
    """Normalized matrix + output column names for a (purified) dataset."""
    plan = build_norm_plan(mc, columns)
    return apply_norm_plan(plan, data, device=device), plan.out_names

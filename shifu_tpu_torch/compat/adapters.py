"""Bridges between reference model specs and the port's scorer
(counterpart of `shifu_tpu/compat/adapters.py`).

``load_ref_model`` sniffs any reference-format model file (Encog EG text
``.nn``, BinaryNNSerializer gzip ``.nn``, BinaryDTSerializer ``.gbt``/``.rf``,
zip spec) and wraps it so ModelRunner can score it next to native models —
the reference's prod scorers and ours become interchangeable
(ModelSpecLoaderUtils.java:389 loadModel dispatch parity). A gzip `.wdl`
is the reference's WDL container; the native `.wdl` starts with `STWD`
and is never sniffed as one. The adapter's device (`None` is the card)
runs the EG network's norm plan and the reference WDL's MLP; the rest is
numpy on the host.

Export helpers emit our trained models in the reference's own formats so the
reference's IndependentNNModel / IndependentTreeModel / Encog loaders can
score them.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from shifu_tpu_torch.compat import egb, encog, sniff_model_format, treespec
from shifu_tpu_torch.utils.log import get_logger
from shifu_tpu_torch.utils.platform import DeviceLike

log = get_logger(__name__)


class RefModelAdapter:
    """Duck-typed stand-in for a native model spec inside ModelRunner."""

    def __init__(self, kind: str, model, path: str = "",
                 norm_plan=None, device: DeviceLike = None):
        self.kind = kind  # 'eg-nn' | 'egb-nn' | 'ref-tree' | 'ref-wdl'
        self.model = model
        self.path = path
        self.norm_plan = norm_plan  # NormPlan for eg-nn (external stats)
        self.device = device
        self.algorithm = (
            model.algorithm if kind in ("ref-tree", "ref-wdl") else "NN"
        )

    @property
    def input_columns(self) -> List[str]:
        """The raw columns the model reads (the serving record schema):
        the EG network's norm-plan columns, the other kinds' own column
        stats or names."""
        if self.kind == "eg-nn":
            if self.norm_plan is None:
                return []
            return list(dict.fromkeys(s.cc.column_name
                                      for s in self.norm_plan.specs))
        if self.kind == "ref-tree":
            m = self.model
            return [m.column_names[c] for c in m.column_mapping
                    if c in m.column_names]
        if self.kind == "egb-nn":
            return [cs.column_name for cs in self.model.column_stats
                    if cs.column_num in self.model.column_mapping]
        m = self.model  # ref-wdl
        used = set(m.dense_column_ids) | set(m.embed_column_ids) | set(
            m.wide_column_ids)
        return [cs.column_name for cs in m.column_stats
                if cs.column_num in used]

    # -- scoring -------------------------------------------------------------
    def _tree_matrix(self, data) -> np.ndarray:
        """Columnar, vectorized convertDataMapToDoubleArray
        (IndependentTreeModel.java:571)."""
        m: treespec.RefTreeModel = self.model
        out = np.zeros((data.n_rows, len(m.column_mapping)), dtype=np.float64)
        for col_num, idx in m.column_mapping.items():
            name = m.column_names.get(col_num)
            if name is None or name not in data.names:
                if col_num in m.categorical_values:
                    out[:, idx] = len(m.categorical_values[col_num])
                else:
                    out[:, idx] = m.numerical_mean.get(col_num, 0.0) or 0.0
                continue
            if col_num in m.categorical_values:
                table = m.category_index(col_num)
                size = len(m.categorical_values[col_num])
                vals = data.column(name)
                idxs = np.array(
                    [table.get(str(v), size) for v in vals], dtype=np.float64
                )
                miss = data.missing_mask(name)
                idxs[miss] = size
                out[:, idx] = idxs
            else:
                mean = m.numerical_mean.get(col_num, 0.0) or 0.0
                vals = data.numeric(name).astype(np.float64)
                vals = np.where(np.isnan(vals), mean, vals)
                out[:, idx] = vals
        return out

    def score_raw(self, data) -> np.ndarray:
        """ColumnarData of raw records -> scores in [0, 1]."""
        if self.kind == "ref-wdl":
            return np.clip(self.model.compute_raw(data, device=self.device),
                           0.0, 1.0)
        if self.kind == "ref-tree":
            m: treespec.RefTreeModel = self.model
            raw = m.compute(self._tree_matrix(data))
            if m.algorithm.upper() == "GBT" and m.loss == "log":
                return 1.0 / (1.0 + np.exp(-raw))
            return np.clip(raw, 0.0, 1.0)
        if self.kind == "egb-nn":
            rows = _columnar_to_rows(data)
            return np.clip(self.model.compute_raw(rows), 0.0, 1.0)
        # eg-nn: normalize via external plan (project ColumnConfig stats)
        if self.norm_plan is None:
            raise ValueError(
                f"{self.path}: Encog EG model needs ColumnConfig stats to "
                "normalize raw input — score via `shifu eval` in a model dir"
            )
        from shifu_tpu_torch.norm.normalizer import apply_norm_plan

        feats = apply_norm_plan(self.norm_plan, data, device=self.device)
        return np.clip(np.ravel(self.model.compute(feats)), 0.0, 1.0)

    def score_normalized(self, feats: np.ndarray) -> np.ndarray:
        if self.kind in ("ref-tree", "ref-wdl"):
            raise ValueError(
                "reference tree/WDL models score raw records (they need "
                "bin codes / categorical values, not a normalized matrix)"
            )
        return np.clip(np.ravel(self.model.compute(feats)), 0.0, 1.0)


def _columnar_to_rows(data) -> List[dict]:
    names = list(data.names)
    cols = {n: data.column(n) for n in names}
    miss = {n: data.missing_mask(n) for n in names}
    return [
        {n: (None if miss[n][i] else cols[n][i]) for n in names}
        for i in range(data.n_rows)
    ]


def load_ref_model(path: str, column_configs=None, model_config=None,
                   device: DeviceLike = None) -> Optional[RefModelAdapter]:
    """Load a reference-format model file; None if it is a native spec.
    `device` is the adapter's (`None` is the card, resolved when it
    scores)."""
    with open(path, "rb") as fh:
        blob = fh.read()
    fmt = sniff_model_format(blob)
    if fmt == "native":
        return None
    if fmt == "eg-text":
        net = encog.read_eg(blob)
        plan = None
        if column_configs is not None and model_config is not None:
            from shifu_tpu_torch.norm.normalizer import build_norm_plan

            plan = build_norm_plan(model_config, column_configs)
        return RefModelAdapter("eg-nn", net, path, norm_plan=plan,
                               device=device)
    if fmt == "zip":
        return RefModelAdapter("ref-tree", treespec.read_zip_model(blob), path,
                               device=device)
    # gzip java stream: tree vs nn vs wdl container — extension first
    suffix = path.rsplit(".", 1)[-1].lower()
    if suffix in ("gbt", "rf"):
        return RefModelAdapter("ref-tree", treespec.read_tree_model(blob),
                               path, device=device)
    if suffix == "wdl":
        from shifu_tpu_torch.compat import wdl as wdl_compat

        return RefModelAdapter("ref-wdl", wdl_compat.read_wdl_model(blob),
                               path, device=device)
    try:
        return RefModelAdapter("egb-nn", egb.read_nn_model(blob), path,
                               device=device)
    except Exception:  # not an NN container after all
        return RefModelAdapter("ref-tree", treespec.read_tree_model(blob),
                               path, device=device)


# ---------------------------------------------------------------------------
# export: the port's specs -> reference formats
# ---------------------------------------------------------------------------


def nn_spec_to_eg_bytes(spec) -> bytes:
    """Our NNModelSpec -> Encog EG text loadable by
    EncogDirectoryPersistence (ModelSpecLoaderUtils.java:409)."""
    weights = [np.asarray(p["W"], np.float64) for p in spec.params]
    biases = [np.asarray(p["b"], np.float64) for p in spec.params]
    hidden_acts = list(spec.activations)
    net = encog.from_layers(weights, biases, hidden_acts, spec.out_activation)
    return encog.write_eg(net)


def _stats_from_column_configs(column_configs, cutoff: float,
                               names=()) -> List[egb.RefNNColumnStats]:
    """The final-selected columns' stats; when none is final-selected (a
    set trained without varsel, whose norm plan takes every candidate),
    those of the model's own columns `names` (getIndexNameMapping's
    fallback, BinaryWDLSerializer.java:128). The JAX package's copy
    exports no column then (ROADMAP C.13)."""
    from shifu_tpu_torch.norm.normalizer import woe_mean_std

    selected = any(cc.final_select for cc in column_configs)
    out = []
    for cc in column_configs:
        if not (cc.final_select if selected else cc.column_name in names):
            continue
        stats = cc.column_stats
        binning = cc.column_binning
        woes = cc.bin_count_woe or []
        try:
            wm, ws = woe_mean_std(cc, weighted=False)
            wwm, wws = woe_mean_std(cc, weighted=True)
        except Exception:  # stats absent/degenerate: export zero WOE moments
            wm = ws = wwm = wws = 0.0
        out.append(
            egb.RefNNColumnStats(
                column_num=cc.column_num,
                column_name=cc.column_name,
                column_type=cc.column_type.value if cc.column_type else "N",
                cutoff=cutoff,
                mean=stats.mean or 0.0,
                stddev=stats.std_dev or 1.0,
                woe_mean=wm, woe_stddev=ws,
                woe_wgt_mean=wwm, woe_wgt_stddev=wws,
                bin_boundaries=[float(b) for b in (cc.bin_boundary or [])],
                bin_categories=list(cc.bin_category or []),
                bin_pos_rates=[float(v) for v in (cc.bin_pos_rate or [])],
                bin_count_woes=[float(v) for v in woes],
                bin_weight_woes=[float(v) for v in (cc.bin_weighted_woe or [])],
            )
        )
    return out


def nn_spec_to_egb_bytes(spec, column_configs, cutoff: float = 4.0) -> bytes:
    """Our NNModelSpec + project ColumnConfig -> BinaryNNSerializer .nn
    container readable by IndependentNNModel.loadFromStream."""
    weights = [np.asarray(p["W"], np.float64) for p in spec.params]
    biases = [np.asarray(p["b"], np.float64) for p in spec.params]
    net = encog.from_layers(weights, biases, list(spec.activations),
                            spec.out_activation)
    stats = _stats_from_column_configs(
        column_configs, cutoff, {cd["name"] for cd in spec.norm_specs})
    mapping = {cs.column_num: j for j, cs in enumerate(stats)}
    model = egb.RefNNModel(spec.norm_type, stats, mapping, [net])
    return egb.write_nn_model(model)


def tree_spec_to_ref_bytes(spec) -> bytes:
    """Our TreeModelSpec -> reference binary .gbt/.rf."""
    return treespec.write_tree_model(treespec.from_dense_spec(spec))


def tree_spec_to_zip_bytes(spec) -> bytes:
    """Our TreeModelSpec -> reference zip spec (shifu convert format)."""
    return treespec.write_zip_model(treespec.from_dense_spec(spec))

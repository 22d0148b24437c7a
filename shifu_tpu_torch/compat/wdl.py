"""Reference WDL binary model format — read AND write (counterpart of
`shifu_tpu/compat/wdl.py`).

Wire format (wdl/BinaryWDLSerializer.java:66 save-with-columns variant, the
one WDLOutput ships to models/model*.wdl; gzip java DataOutput stream):

    int    WDL_FORMAT_VERSION (=1, CommonConstants.java:145)
    float, float, double, UTF      reserved fields
    int+utf8                       norm type (dtrain StringUtils.writeString)
    int nStats; NNColumnStats[n]   (nn/NNColumnStats.write — same records as
                                    the EGB .nn container, compat/egb.py)
    WideAndDeep.write              (WideAndDeep.java:558):
        int serializationType      (2 = MODEL_SPEC, AbstractLayer.java:95)
        bool -> DenseInputLayer    { int out }
        int nHidden; DenseLayer[n] { float l2reg, int in, int out,
                                     bool -> float[in][out] weights,
                                     bool -> float[out] bias }
        bool -> finalLayer         DenseLayer
        bool -> EmbedLayer         { int n; EmbedFieldLayer[n]:
                                     int columnId, int in, int out,
                                     bool -> float[in][out] }
        bool -> WideLayer          { int n; WideFieldLayer[n]:
                                     int columnId, float l2reg, int in,
                                     bool -> float[in];
                                     bool -> WideDenseLayer { float l2reg,
                                     int in, bool -> float[in] };
                                     bool -> BiasLayer { float } }
        int nActi; UTF[n]
        MODEL_SPEC tail: int mapSize + (int,int)[mapSize] idBinCateSizeMap,
        int numericalSize, intList denseColumnIds, intList embedColumnIds,
        intList embedOutputs, intList wideColumnIds, intList hiddenNodes,
        float l2reg

Scoring parity: IndependentWDLModel.loadFromStream:198 + WideAndDeep
forward:163 — logits = wide(FieldLayers + WideDense + bias) + final(deep);
missing category index = |binCategories| (getMissingTypeCategory). The
deep tower's MLP runs in torch on `device` (`None` is the card); the
inputs, the wide tower and the sigmoid are numpy on the host.
"""

from __future__ import annotations

import gzip
import io
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from shifu_tpu_torch.compat.egb import RefNNColumnStats
from shifu_tpu_torch.compat.javaio import JavaDataInput, JavaDataOutput
from shifu_tpu_torch.utils.platform import DeviceLike, resolve_device

WDL_FORMAT_VERSION = 1
MODEL_SPEC = 2


@dataclass
class RefDenseLayer:
    l2reg: float
    weights: np.ndarray  # [in, out]
    bias: np.ndarray  # [out]


@dataclass
class RefWDLModel:
    """Parsed reference WDL model, scoreable on raw records."""

    norm_type: str
    column_stats: List[RefNNColumnStats]
    hidden_layers: List[RefDenseLayer]
    final_layer: RefDenseLayer
    embed_tables: List[Tuple[int, np.ndarray]]  # (columnId, [vocab, E])
    wide_fields: List[Tuple[int, np.ndarray]]  # (columnId, [vocab])
    wide_dense: Optional[np.ndarray]  # [nDense] or None
    bias: float
    acti_funcs: List[str]
    dense_column_ids: List[int]
    embed_column_ids: List[int]
    wide_column_ids: List[int]
    hidden_nodes: List[int]
    embed_outputs: List[int]
    id_bin_cate_size: Dict[int, int]
    numerical_size: int = 0
    l2reg: float = 0.0
    algorithm: str = "WDL"

    def _stats_by_num(self) -> Dict[int, RefNNColumnStats]:
        return {cs.column_num: cs for cs in self.column_stats}

    # -- raw-record scoring --------------------------------------------------
    def compute_raw(self, data, device: DeviceLike = None) -> np.ndarray:
        """ColumnarData -> sigmoid(logits) [n]. Vectorized twin of
        IndependentWDLModel.compute(dataMap)."""
        stats = self._stats_by_num()
        n = data.n_rows

        def col_values(cid):
            cs = stats.get(cid)
            if cs is None or cs.column_name not in data.names:
                return None, cs
            return cs.column_name, cs

        # dense inputs: z-score with per-column cutoff; missing -> 0
        # (Normalizer zScoreNormalize parity, same as the EGB NN adapter)
        dense = np.zeros((n, len(self.dense_column_ids)), np.float32)
        for j, cid in enumerate(self.dense_column_ids):
            name, cs = col_values(cid)
            if name is None:
                continue
            vals = data.numeric(name)
            std = cs.stddev if cs.stddev else 1.0
            z = (vals - cs.mean) / std
            z = np.clip(z, -cs.cutoff, cs.cutoff)
            dense[:, j] = np.where(np.isnan(vals), 0.0, z).astype(np.float32)

        def cat_codes(cid_list):
            codes = np.zeros((n, len(cid_list)), np.int32)
            for j, cid in enumerate(cid_list):
                name, cs = col_values(cid)
                cats = cs.bin_categories if cs else []
                missing_idx = len(cats)
                if name is None:
                    codes[:, j] = missing_idx
                    continue
                table: Dict[str, int] = {}
                for k, cat in enumerate(cats):
                    # merged categories flatten on the "@^" delimiter
                    # (Constants.CATEGORICAL_GROUP_VAL_DELIMITER)
                    for part in str(cat).split("@^"):
                        table[part] = k
                    table[str(cat)] = k
                vals = data.column(name)
                miss = data.missing_mask(name)
                idx = np.fromiter(
                    (table.get(str(v), missing_idx) for v in vals),
                    dtype=np.int32, count=n,
                )
                idx[miss] = missing_idx
                codes[:, j] = idx
            return codes

        embed_codes = cat_codes(self.embed_column_ids)
        wide_codes = cat_codes(self.wide_column_ids)

        # deep tower: [dense, embeds] -> hidden -> final
        embed_by_id = dict(self.embed_tables)
        pieces = [dense]
        for j, cid in enumerate(self.embed_column_ids):
            tb = embed_by_id[cid]
            idx = np.clip(embed_codes[:, j], 0, tb.shape[0] - 1)
            pieces.append(tb[idx])
        h = np.concatenate(pieces, axis=1)
        import torch

        from shifu_tpu_torch.models.nn import activation_fn

        dev = resolve_device(device)

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)

        with torch.no_grad():
            hj = t(h)
            for i, layer in enumerate(self.hidden_layers):
                act = activation_fn(
                    _map_act(self.acti_funcs[i] if i < len(self.acti_funcs)
                             else "relu"))
                hj = act(hj @ t(layer.weights) + t(layer.bias))
            deep = (hj @ t(self.final_layer.weights)
                    + t(self.final_layer.bias))[:, 0].cpu().numpy()

        wide = np.zeros(n, np.float32)
        wide_by_id = dict(self.wide_fields)
        for j, cid in enumerate(self.wide_column_ids):
            w = wide_by_id[cid]
            idx = np.clip(wide_codes[:, j], 0, w.shape[0] - 1)
            wide += w[idx]
        if self.wide_dense is not None and self.wide_dense.size == dense.shape[1]:
            wide += dense @ self.wide_dense
        logits = np.asarray(deep) + wide + self.bias
        return (1.0 / (1.0 + np.exp(-logits))).astype(np.float64)


def _map_act(name: str) -> str:
    n = (name or "relu").lower()
    return {"tanh": "tanh", "sigmoid": "sigmoid", "relu": "relu",
            "leakyrelu": "leakyrelu", "swish": "swish", "log": "log",
            "gaussian": "gaussian", "linear": "linear"}.get(n, "relu")


# ---------------------------------------------------------------------------
# read
# ---------------------------------------------------------------------------


def _read_float_matrix(di: JavaDataInput, rows: int, cols: int
                       ) -> Optional[np.ndarray]:
    if not di.read_boolean():
        return None
    flat = np.frombuffer(di._read(4 * rows * cols), dtype=">f4")
    return flat.reshape(rows, cols).astype(np.float32)


def _read_float_vec(di: JavaDataInput, size: int) -> Optional[np.ndarray]:
    if not di.read_boolean():
        return None
    return np.frombuffer(di._read(4 * size), dtype=">f4").astype(np.float32)


def _read_dense_layer(di: JavaDataInput) -> RefDenseLayer:
    l2reg = di.read_float()
    in_n = di.read_int()
    out_n = di.read_int()
    w = _read_float_matrix(di, in_n, out_n)
    b = _read_float_vec(di, out_n)
    return RefDenseLayer(
        l2reg=l2reg,
        weights=w if w is not None else np.zeros((in_n, out_n), np.float32),
        bias=b if b is not None else np.zeros(out_n, np.float32),
    )


def _read_int_list(di: JavaDataInput) -> List[int]:
    return [di.read_int() for _ in range(di.read_int())]


def read_wdl_model(blob: bytes) -> RefWDLModel:
    if blob[:2] == b"\x1f\x8b":
        blob = gzip.decompress(blob)
    di = JavaDataInput(io.BytesIO(blob))
    version = di.read_int()
    if version != WDL_FORMAT_VERSION:
        raise ValueError(f"unsupported WDL format version {version}")
    di.read_float(); di.read_float(); di.read_double(); di.read_utf()
    norm_type = di.read_string() or "ZSCALE"

    n_stats = di.read_int()
    stats = [RefNNColumnStats.read(di) for _ in range(n_stats)]

    ser_type = di.read_int()
    # DenseInputLayer
    numerical_size = 0
    if di.read_boolean():
        numerical_size = di.read_int()
    hidden = [_read_dense_layer(di) for _ in range(di.read_int())]
    final = _read_dense_layer(di) if di.read_boolean() else RefDenseLayer(
        0.0, np.zeros((1, 1), np.float32), np.zeros(1, np.float32))
    embed_tables: List[Tuple[int, np.ndarray]] = []
    if di.read_boolean():
        for _ in range(di.read_int()):
            cid = di.read_int()
            in_n = di.read_int()
            out_n = di.read_int()
            w = _read_float_matrix(di, in_n, out_n)
            embed_tables.append(
                (cid, w if w is not None
                 else np.zeros((in_n, out_n), np.float32)))
    wide_fields: List[Tuple[int, np.ndarray]] = []
    wide_dense = None
    bias = 0.0
    if di.read_boolean():
        for _ in range(di.read_int()):
            cid = di.read_int()
            di.read_float()  # l2reg
            in_n = di.read_int()
            w = _read_float_vec(di, in_n)
            wide_fields.append(
                (cid, w if w is not None else np.zeros(in_n, np.float32)))
        if di.read_boolean():  # WideDenseLayer
            di.read_float()  # l2reg
            in_n = di.read_int()
            wide_dense = _read_float_vec(di, in_n)
        if di.read_boolean():  # BiasLayer
            bias = di.read_float()
    acti = [di.read_utf() for _ in range(di.read_int())]

    id_map: Dict[int, int] = {}
    dense_ids: List[int] = []
    embed_ids: List[int] = []
    embed_outs: List[int] = []
    wide_ids: List[int] = []
    hidden_nodes: List[int] = []
    l2reg = 0.0
    if ser_type == MODEL_SPEC:
        for _ in range(di.read_int()):
            k = di.read_int()
            id_map[k] = di.read_int()
        numerical_size = di.read_int()
        dense_ids = _read_int_list(di)
        embed_ids = _read_int_list(di)
        embed_outs = _read_int_list(di)
        wide_ids = _read_int_list(di)
        hidden_nodes = _read_int_list(di)
        l2reg = di.read_float()
    else:  # fall back: derive column id lists from the layer objects
        embed_ids = [cid for cid, _ in embed_tables]
        wide_ids = [cid for cid, _ in wide_fields]

    return RefWDLModel(
        norm_type=norm_type,
        column_stats=stats,
        hidden_layers=hidden,
        final_layer=final,
        embed_tables=embed_tables,
        wide_fields=wide_fields,
        wide_dense=wide_dense,
        bias=bias,
        acti_funcs=acti,
        dense_column_ids=dense_ids,
        embed_column_ids=embed_ids,
        wide_column_ids=wide_ids,
        hidden_nodes=hidden_nodes,
        embed_outputs=embed_outs,
        id_bin_cate_size=id_map,
        numerical_size=numerical_size,
        l2reg=l2reg,
    )


# ---------------------------------------------------------------------------
# write
# ---------------------------------------------------------------------------


def _write_float_matrix(do: JavaDataOutput, a: np.ndarray) -> None:
    do.write_boolean(True)
    do.write_raw(np.asarray(a, ">f4").tobytes())


def _write_float_vec(do: JavaDataOutput, a: np.ndarray) -> None:
    do.write_boolean(True)
    do.write_raw(np.asarray(a, ">f4").tobytes())


def _write_dense_layer(do: JavaDataOutput, layer: RefDenseLayer) -> None:
    do.write_float(layer.l2reg)
    do.write_int(layer.weights.shape[0])
    do.write_int(layer.weights.shape[1])
    _write_float_matrix(do, layer.weights)
    _write_float_vec(do, layer.bias)


def _write_int_list(do: JavaDataOutput, vals: List[int]) -> None:
    do.write_int(len(vals))
    for v in vals:
        do.write_int(int(v))


def write_wdl_model(model: RefWDLModel, compress: bool = True) -> bytes:
    buf = io.BytesIO()
    do = JavaDataOutput(buf)
    do.write_int(WDL_FORMAT_VERSION)
    do.write_float(0.0); do.write_float(0.0)
    do.write_double(0.0); do.write_utf("Reserved field")
    do.write_string(model.norm_type)
    do.write_int(len(model.column_stats))
    for cs in model.column_stats:
        cs.write(do)
    do.write_int(MODEL_SPEC)
    do.write_boolean(True)  # DenseInputLayer
    do.write_int(model.numerical_size or len(model.dense_column_ids))
    do.write_int(len(model.hidden_layers))
    for layer in model.hidden_layers:
        _write_dense_layer(do, layer)
    do.write_boolean(True)
    _write_dense_layer(do, model.final_layer)
    do.write_boolean(True)  # EmbedLayer
    do.write_int(len(model.embed_tables))
    for cid, w in model.embed_tables:
        do.write_int(cid)
        do.write_int(w.shape[0])
        do.write_int(w.shape[1])
        _write_float_matrix(do, w)
    do.write_boolean(True)  # WideLayer
    do.write_int(len(model.wide_fields))
    for cid, w in model.wide_fields:
        do.write_int(cid)
        do.write_float(0.0)
        do.write_int(w.shape[0])
        _write_float_vec(do, w)
    if model.wide_dense is not None:
        do.write_boolean(True)
        do.write_float(0.0)
        do.write_int(model.wide_dense.shape[0])
        _write_float_vec(do, model.wide_dense)
    else:
        do.write_boolean(False)
    do.write_boolean(True)  # BiasLayer
    do.write_float(model.bias)
    do.write_int(len(model.acti_funcs))
    for a in model.acti_funcs:
        do.write_utf(a)
    # MODEL_SPEC tail
    do.write_int(len(model.id_bin_cate_size))
    for k, v in model.id_bin_cate_size.items():
        do.write_int(k)
        do.write_int(v)
    do.write_int(model.numerical_size or len(model.dense_column_ids))
    _write_int_list(do, model.dense_column_ids)
    _write_int_list(do, model.embed_column_ids)
    _write_int_list(do, model.embed_outputs
                    or [model.embed_tables[0][1].shape[1]]
                    * len(model.embed_tables) if model.embed_tables else [])
    _write_int_list(do, model.wide_column_ids)
    _write_int_list(do, model.hidden_nodes
                    or [l.weights.shape[1] for l in model.hidden_layers])
    do.write_float(model.l2reg)
    raw = buf.getvalue()
    return gzip.compress(raw) if compress else raw


# ---------------------------------------------------------------------------
# bridge: the port's WDLModelSpec <-> RefWDLModel
# ---------------------------------------------------------------------------


def wdl_spec_to_ref(spec, column_configs, cutoff: float = 4.0) -> RefWDLModel:
    """Our WDLModelSpec + project ColumnConfigs -> reference wire model.
    Column ids come from the ColumnConfig columnNum of each model column.
    Stats cover the MODEL's columns (getIndexNameMapping falls back to good
    candidates when nothing is final-selected, BinaryWDLSerializer.java:128)."""
    from shifu_tpu_torch.norm.normalizer import woe_mean_std

    by_name = {cc.column_name: cc for cc in column_configs}

    def cid(name: str) -> int:
        cc = by_name.get(name)
        return cc.column_num if cc is not None else -1

    dense_ids = [cid(n) for n in spec.dense_columns]
    embed_ids = [cid(n) for n in spec.cat_columns]
    used = set(spec.dense_columns) | set(spec.cat_columns)
    stats = []
    for cc in column_configs:
        if cc.column_name not in used:
            continue
        st = cc.column_stats
        try:
            wm, ws = woe_mean_std(cc, weighted=False)
            wwm, wws = woe_mean_std(cc, weighted=True)
        except Exception:  # stats absent/degenerate: export zero WOE moments
            wm = ws = wwm = wws = 0.0
        stats.append(RefNNColumnStats(
            column_num=cc.column_num,
            column_name=cc.column_name,
            column_type=cc.column_type.value if cc.column_type else "N",
            cutoff=cutoff,
            mean=st.mean or 0.0,
            stddev=st.std_dev or 1.0,
            woe_mean=wm, woe_stddev=ws,
            woe_wgt_mean=wwm, woe_wgt_stddev=wws,
            bin_boundaries=[float(b) for b in (cc.bin_boundary or [])],
            bin_categories=list(cc.bin_category or []),
            bin_pos_rates=[float(v) for v in (cc.bin_pos_rate or [])],
            bin_count_woes=[float(v) for v in (cc.bin_count_woe or [])],
            bin_weight_woes=[float(v) for v in (cc.bin_weighted_woe or [])],
        ))
    p = spec.params
    hidden = [
        RefDenseLayer(0.0, np.asarray(l["W"], np.float32),
                      np.asarray(l["b"], np.float32))
        for l in p.dense_layers[:-1]
    ]
    final = RefDenseLayer(0.0, np.asarray(p.dense_layers[-1]["W"], np.float32),
                          np.asarray(p.dense_layers[-1]["b"], np.float32))
    return RefWDLModel(
        norm_type=spec.norm_type,
        column_stats=stats,
        hidden_layers=hidden,
        final_layer=final,
        embed_tables=[(embed_ids[f], np.asarray(t, np.float32))
                      for f, t in enumerate(p.embed)],
        wide_fields=[(embed_ids[f], np.asarray(w, np.float32))
                     for f, w in enumerate(p.wide)],
        wide_dense=np.asarray(p.wide_dense, np.float32),
        bias=float(np.asarray(p.bias).ravel()[0]),
        acti_funcs=list(spec.activations),
        dense_column_ids=dense_ids,
        embed_column_ids=embed_ids,
        wide_column_ids=embed_ids,
        hidden_nodes=list(spec.hidden),
        embed_outputs=[spec.embed_dim] * len(embed_ids),
        id_bin_cate_size={embed_ids[f]: int(v)
                          for f, v in enumerate(spec.vocab_sizes)},
        numerical_size=len(dense_ids),
    )


def ref_to_wdl_params(model: RefWDLModel):
    """RefWDLModel -> our WDLParams (for re-training / native scoring)."""
    from shifu_tpu_torch.models.wdl import WDLParams

    embed_by_id = dict(model.embed_tables)
    wide_by_id = dict(model.wide_fields)
    embed = [embed_by_id[cid] for cid in model.embed_column_ids]
    wide = [wide_by_id[cid] for cid in model.wide_column_ids]
    layers = [
        {"W": l.weights, "b": l.bias} for l in model.hidden_layers
    ] + [{"W": model.final_layer.weights, "b": model.final_layer.bias}]
    return WDLParams(
        embed=embed,
        wide=wide,
        wide_dense=(model.wide_dense if model.wide_dense is not None
                    else np.zeros(len(model.dense_column_ids), np.float32)),
        dense_layers=layers,
        bias=np.asarray([model.bias], np.float32),
    )

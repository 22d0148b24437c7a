"""Reference binary NN model-spec compatibility (BinaryNNSerializer format;
counterpart of `shifu_tpu/compat/egb.py`, numpy on the host).

Byte-compatible reader/writer for the gzip stream written by
core/dtrain/nn/BinaryNNSerializer.java:46 and loaded by
nn/IndependentNNModel.loadFromStream (IndependentNNModel.java:540):

    int NN_FORMAT_VERSION(=1); string normType; int nStats;
    NNColumnStats[nStats] (nn/NNColumnStats.java write());
    int nMap; (int columnNum, int index)[nMap];
    int nNetworks; PersistBasicFloatNetwork[n]
    (core/dtrain/dataset/PersistBasicFloatNetwork.saveNetwork:280).

Scoring normalizes RAW values internally per normType exactly like
IndependentNNModel.convertDataMapToDoubleArray (:262), then forwards the
Encog flat network (vectorized here, see compat/encog.py).
"""

from __future__ import annotations

import gzip
import io
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from shifu_tpu_torch.compat.encog import EncogNetwork
from shifu_tpu_torch.compat.javaio import JavaDataInput, JavaDataOutput

NN_FORMAT_VERSION = 1  # CommonConstants.NN_FORMAT_VERSION
COLUMN_TYPE_BYTES = {"A": 0, "N": 1, "C": 2, "H": 3}  # ColumnType.java:19
COLUMN_TYPE_NAMES = {v: k for k, v in COLUMN_TYPE_BYTES.items()}
DEFAULT_CUTOFF = 4.0  # Normalizer.STD_DEV_CUTOFF


@dataclass
class RefNNColumnStats:
    """Mirror of nn/NNColumnStats.java (write/readFields)."""

    column_num: int
    column_name: str
    column_type: str  # N | C | H | A
    cutoff: float = DEFAULT_CUTOFF
    mean: float = 0.0
    stddev: float = 1.0
    woe_mean: float = 0.0
    woe_stddev: float = 1.0
    woe_wgt_mean: float = 0.0
    woe_wgt_stddev: float = 1.0
    bin_boundaries: List[float] = field(default_factory=list)
    bin_categories: List[str] = field(default_factory=list)
    bin_pos_rates: List[float] = field(default_factory=list)
    bin_count_woes: List[float] = field(default_factory=list)
    bin_weight_woes: List[float] = field(default_factory=list)

    def write(self, do: JavaDataOutput) -> None:
        do.write_int(self.column_num)
        do.write_string(self.column_name)
        do.write_byte(COLUMN_TYPE_BYTES[self.column_type])
        for v in (self.cutoff, self.mean, self.stddev, self.woe_mean,
                  self.woe_stddev, self.woe_wgt_mean, self.woe_wgt_stddev):
            do.write_double(float(v))
        do.write_double_array(self.bin_boundaries)
        do.write_int(len(self.bin_categories))
        for cat in self.bin_categories:
            do.write_string(cat)
        do.write_double_array(self.bin_pos_rates)
        do.write_double_array(self.bin_count_woes)
        do.write_double_array(self.bin_weight_woes)

    @classmethod
    def read(cls, di: JavaDataInput) -> "RefNNColumnStats":
        cs = cls(column_num=di.read_int(), column_name=di.read_string(),
                 column_type=COLUMN_TYPE_NAMES[di.read_byte()])
        (cs.cutoff, cs.mean, cs.stddev, cs.woe_mean, cs.woe_stddev,
         cs.woe_wgt_mean, cs.woe_wgt_stddev) = (di.read_double() for _ in range(7))
        cs.bin_boundaries = di.read_double_array()
        cs.bin_categories = [di.read_string() for _ in range(di.read_int())]
        cs.bin_pos_rates = di.read_double_array()
        cs.bin_count_woes = di.read_double_array()
        cs.bin_weight_woes = di.read_double_array()
        return cs


def read_float_network(di: JavaDataInput) -> EncogNetwork:
    """PersistBasicFloatNetwork.readNetwork (:199) stream image."""
    props = {di.read_string(): di.read_string() for _ in range(di.read_int())}
    di.read_int()  # beginTraining
    di.read_double()  # connectionLimit
    di.read_int_array()  # contextTargetOffset
    di.read_int_array()  # contextTargetSize
    di.read_int()  # endTraining
    di.read_boolean()  # hasContext
    di.read_int()  # inputCount
    layer_counts = di.read_int_array()
    layer_feed = di.read_int_array()
    di.read_int_array()  # layerContextCount
    di.read_int_array()  # layerIndex
    di.read_double_array()  # layerOutput snapshot
    di.read_int()  # outputCount
    di.read_int_array()  # weightIndex
    weights = np.array(di.read_double_array(), dtype=np.float64)
    bias_act = di.read_double_array()
    n_act = di.read_int()
    acts, act_params = [], []
    for _ in range(n_act):
        acts.append(di.read_string())
        act_params.append(di.read_double_array())
    feature_set = [di.read_int() for _ in range(di.read_int())]
    return EncogNetwork(
        layer_counts=layer_counts, layer_feed_counts=layer_feed, weights=weights,
        activations=acts, activation_params=act_params, bias_activation=bias_act,
        properties=props, feature_set=feature_set,
    )


def write_float_network(do: JavaDataOutput, net: EncogNetwork) -> None:
    """PersistBasicFloatNetwork.saveNetwork (:280) stream image."""
    do.write_int(len(net.properties))
    for k, v in net.properties.items():
        do.write_string(k)
        do.write_string(v)
    n = len(net.layer_counts)
    do.write_int(0)  # beginTraining
    do.write_double(0.0)  # connectionLimit
    do.write_int_array([0] * n)  # contextTargetOffset
    do.write_int_array([0] * n)  # contextTargetSize
    do.write_int(n - 1)  # endTraining
    do.write_boolean(False)  # hasContext
    do.write_int(net.input_count)
    do.write_int_array(net.layer_counts)
    do.write_int_array(net.layer_feed_counts)
    do.write_int_array([0] * n)  # layerContextCount
    do.write_int_array(net.layer_index)
    do.write_double_array(net.default_layer_output())
    do.write_int(net.output_count)
    do.write_int_array(net.weight_index)
    do.write_double_array(list(net.weights))
    do.write_double_array(net.bias_activation)
    do.write_int(len(net.activations))
    for name, params in zip(net.activations, net.activation_params):
        do.write_string(name)
        do.write_double_array(params)
    do.write_int(len(net.feature_set))
    for f in net.feature_set:
        do.write_int(f)


@dataclass
class RefNNModel:
    """In-memory image of the reference IndependentNNModel."""

    norm_type: str
    column_stats: List[RefNNColumnStats]
    column_mapping: Dict[int, int]  # columnNum -> input index
    networks: List[EncogNetwork]
    version: int = NN_FORMAT_VERSION

    def _stats_by_num(self) -> Dict[int, RefNNColumnStats]:
        return {cs.column_num: cs for cs in self.column_stats}

    # -- normalization (parity IndependentNNModel.java:262-540) -------------
    def _zscore(self, v: float, mean: float, std: float, cutoff: float) -> float:
        if std < 1e-12:
            std = 1e-12
        z = (v - mean) / std
        return float(np.clip(z, -cutoff, cutoff))

    def _numeric_bin(self, bounds: List[float], v: Optional[float]) -> int:
        if v is None or np.isnan(v):
            return -1
        idx = 0
        for i, b in enumerate(bounds):
            if v >= b:
                idx = i
            else:
                break
        return idx

    def _norm_one(self, cs: RefNNColumnStats, obj) -> float:
        nt = self.norm_type.upper()
        is_weighted = nt.startswith("WEIGHT_")
        base = nt[len("WEIGHT_"):] if is_weighted else nt

        def parse_num():
            try:
                v = float(obj)
                return None if np.isnan(v) else v
            except (TypeError, ValueError):
                return None

        if cs.column_type == "C":
            cat_idx = {c: i for i, c in enumerate(cs.bin_categories)}
            key = "" if obj is None else str(obj)
            j = cat_idx.get(key, len(cs.bin_categories) - 1 if "" in cat_idx else -1)
            if j < 0:
                j = len(cs.bin_pos_rates) - 1  # missing bin is last
            if base in ("WOE", "HYBRID"):
                woes = cs.bin_weight_woes if is_weighted else cs.bin_count_woes
                return woes[j]
            if base in ("WOE_ZSCORE", "WOE_ZSCALE"):
                woes = cs.bin_weight_woes if is_weighted else cs.bin_count_woes
                mean = cs.woe_wgt_mean if is_weighted else cs.woe_mean
                std = cs.woe_wgt_stddev if is_weighted else cs.woe_stddev
                return self._zscore(woes[j], mean, std, cs.cutoff)
            pos_rate = cs.bin_pos_rates[j]
            if base in ("OLD_ZSCALE", "OLD_ZSCORE"):
                return pos_rate
            return self._zscore(pos_rate, cs.mean, cs.stddev, cs.cutoff)
        # numeric / hybrid
        if base in ("WOE", "WOE_ZSCORE", "WOE_ZSCALE"):
            v = parse_num()
            j = self._numeric_bin(cs.bin_boundaries, v)
            woes = cs.bin_weight_woes if is_weighted else cs.bin_count_woes
            woe = woes[j] if j >= 0 else woes[-1]
            if base == "WOE":
                return woe
            mean = cs.woe_wgt_mean if is_weighted else cs.woe_mean
            std = cs.woe_wgt_stddev if is_weighted else cs.woe_stddev
            return self._zscore(woe, mean, std, cs.cutoff)
        v = parse_num()
        if v is None:
            v = cs.mean
        return self._zscore(v, cs.mean, cs.stddev, cs.cutoff)

    def normalize_rows(self, rows: List[Dict[str, object]]) -> np.ndarray:
        """Raw (columnName -> value) maps -> normalized [n, inputs]."""
        stats = self._stats_by_num()
        data = np.zeros((len(rows), len(self.column_mapping)), dtype=np.float64)
        for col_num, idx in self.column_mapping.items():
            cs = stats.get(col_num)
            if cs is None:
                continue
            for i, row in enumerate(rows):
                data[i, idx] = self._norm_one(cs, row.get(cs.column_name))
        return data

    def compute(self, data: np.ndarray) -> np.ndarray:
        """Normalized [n, inputs] -> averaged network output [n]
        (parity IndependentNNModel.compute:211)."""
        outs = [net.compute(data) for net in self.networks]
        stacked = np.stack([o if o.ndim == 1 else o[:, 0] for o in outs], axis=0)
        return stacked.mean(axis=0)

    def compute_raw(self, rows: List[Dict[str, object]]) -> np.ndarray:
        return self.compute(self.normalize_rows(rows))


def read_nn_model(data: bytes) -> RefNNModel:
    """Parse BinaryNNSerializer .nn bytes (gzip-sniffing)."""
    if data[:2] == b"\x1f\x8b":
        data = gzip.decompress(data)
    di = JavaDataInput(io.BytesIO(data))
    version = di.read_int()
    norm_type = di.read_string()
    stats = [RefNNColumnStats.read(di) for _ in range(di.read_int())]
    mapping = {di.read_int(): di.read_int() for _ in range(di.read_int())}
    networks = [read_float_network(di) for _ in range(di.read_int())]
    return RefNNModel(norm_type, stats, mapping, networks, version)


def write_nn_model(model: RefNNModel, compress: bool = True) -> bytes:
    """Serialize to the BinaryNNSerializer stream (gzip by default)."""
    raw = io.BytesIO()
    do = JavaDataOutput(raw)
    do.write_int(NN_FORMAT_VERSION)
    do.write_string(model.norm_type)
    do.write_int(len(model.column_stats))
    for cs in model.column_stats:
        cs.write(do)
    do.write_int(len(model.column_mapping))
    for col, idx in model.column_mapping.items():
        do.write_int(col)
        do.write_int(idx)
    do.write_int(len(model.networks))
    for net in model.networks:
        write_float_network(do, net)
    payload = raw.getvalue()
    return gzip.compress(payload) if compress else payload


def woe_mean_stddev(woes: List[float], pos: List[int], neg: List[int]):
    """Parity Normalizer.calculateWoeMeanAndStdDev (Normalizer.java:758):
    count-weighted mean/std over bins."""
    counts = np.array([p + n for p, n in zip(pos, neg)], dtype=np.float64)
    woes_a = np.array(woes, dtype=np.float64)
    total = counts.sum()
    if total <= 1:
        return 0.0, 1.0
    s = float((woes_a * counts).sum())
    sq = float((woes_a * woes_a * counts).sum())
    mean = s / total
    std = float(np.sqrt(abs((sq - s * s / total) / (total - 1))))
    return mean, std

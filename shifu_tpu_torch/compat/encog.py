"""Encog BasicNetwork compatibility: EG text format + flat-network forward
(counterpart of `shifu_tpu/compat/encog.py`; numpy on the host).

The reference persists NN models as Encog EG text files (header line
``encog,BasicNetwork,java,3.0.0,...``; golden specs in the reference's
test resources, model/model0.nn and example/*/ModelStore/*/models/*.nn)
and loads them through
EncogDirectoryPersistence (util/ModelSpecLoaderUtils.java:409).  This module
reads/writes that format and evaluates the flat network with one numpy
matmul per layer instead of Encog's per-neuron loop
(FlatNetwork.computeLayer), so a whole batch scores at once.

Flat-network layout (Encog convention, mirrored by
core/dtrain/dataset/FloatFlatNetwork.java): layers are stored OUTPUT-FIRST;
``layerCounts[t]`` includes the bias neuron, ``layerFeedCounts[t]`` excludes
it; the weight rows feeding layer ``t-1`` start at ``weightIndex[t-1]`` and
each row is [w_from_each_input..., w_bias].
"""

from __future__ import annotations

import io
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

# ---------------------------------------------------------------------------
# activation bank (names as serialized by Encog / shifu's own activations,
# math mirrored from org.encog ActivationSigmoid/TANH/Linear and
# core/dtrain/nn/Activation{ReLU,LeakyReLU,Swish,PTANH}.java)
# ---------------------------------------------------------------------------


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def apply_activation(name: str, x: np.ndarray, params: Optional[List[float]] = None):
    n = name.lower().replace("activation", "")
    if n == "sigmoid":
        return _sigmoid(x)
    if n in ("tanh", "htan"):
        return np.tanh(x)
    if n == "linear":
        return x
    if n == "relu":
        thresh = params[0] if params else 0.0
        low = params[1] if params and len(params) > 1 else 0.0
        return np.where(x <= thresh, low, x)
    if n == "leakyrelu":
        thresh = params[0] if params else 0.0
        alpha = params[1] if params and len(params) > 1 else 0.01
        return np.where(x <= thresh, x * alpha, x)
    if n == "swish":
        return x * _sigmoid(x)
    if n == "ptanh":
        return np.where(x > 0, np.tanh(x), 0.25 * np.tanh(x))
    if n == "log":
        return np.where(x >= 0, np.log(1 + x), -np.log(1 - x))
    if n == "elliott":
        s = params[0] if params else 1.0
        return ((x * s) / 2) / (1 + np.abs(x * s)) + 0.5
    if n == "elliottsymmetric":
        s = params[0] if params else 1.0
        return (x * s) / (1 + np.abs(x * s))
    raise ValueError(f"unsupported Encog activation: {name}")


# our trainer's activation names -> Encog class names
TO_ENCOG_NAME = {
    "sigmoid": "ActivationSigmoid",
    "tanh": "ActivationTANH",
    "linear": "ActivationLinear",
    "relu": "ActivationReLU",
    "leakyrelu": "ActivationLeakyReLU",
    "swish": "ActivationSwish",
    "ptanh": "ActivationPTANH",
    "log": "ActivationLOG",
}
FROM_ENCOG_NAME = {v.lower(): k for k, v in TO_ENCOG_NAME.items()}


@dataclass
class EncogNetwork:
    """Flat Encog BasicNetwork (output-first layer order)."""

    layer_counts: List[int]  # incl. bias neuron
    layer_feed_counts: List[int]  # excl. bias neuron
    weights: np.ndarray  # flat f64, output-first transitions
    activations: List[str]  # Encog class names, one per layer
    activation_params: List[List[float]] = field(default_factory=list)
    bias_activation: List[float] = field(default_factory=list)
    properties: Dict[str, str] = field(default_factory=dict)
    feature_set: List[int] = field(default_factory=list)  # BasicFloatNetwork subset

    def __post_init__(self):
        n = len(self.layer_counts)
        if not self.bias_activation:
            self.bias_activation = [0.0] + [1.0] * (n - 1)
        if not self.activation_params:
            self.activation_params = [[] for _ in self.activations]

    # -- derived Encog arrays ------------------------------------------------
    @property
    def input_count(self) -> int:
        return self.layer_feed_counts[-1]

    @property
    def output_count(self) -> int:
        return self.layer_feed_counts[0]

    @property
    def layer_index(self) -> List[int]:
        idx, acc = [], 0
        for c in self.layer_counts:
            idx.append(acc)
            acc += c
        return idx

    @property
    def weight_index(self) -> List[int]:
        idx, acc = [], 0
        for t in range(len(self.layer_counts) - 1):
            idx.append(acc)
            acc += self.layer_feed_counts[t] * self.layer_counts[t + 1]
        idx.append(acc)
        return idx

    def default_layer_output(self) -> List[float]:
        out: List[float] = []
        for t, c in enumerate(self.layer_counts):
            vals = [0.0] * c
            if c > self.layer_feed_counts[t]:  # bias neuron sits last
                vals[-1] = self.bias_activation[t]
            out.extend(vals)
        return out

    # -- compute -------------------------------------------------------------
    def compute(self, x: np.ndarray) -> np.ndarray:
        """Forward a [B, inputCount] batch -> [B, outputCount] (float64)."""
        x = np.asarray(x, dtype=np.float64)
        squeeze = x.ndim == 1
        if squeeze:
            x = x[None, :]
        widx = self.weight_index
        n_layers = len(self.layer_counts)
        for t in range(n_layers - 1, 0, -1):
            if self.layer_counts[t] > self.layer_feed_counts[t]:
                bias_col = np.full((x.shape[0], 1), self.bias_activation[t])
                aug = np.concatenate([x, bias_col], axis=1)
            else:
                aug = x
            out_feed = self.layer_feed_counts[t - 1]
            w = self.weights[widx[t - 1] : widx[t - 1] + out_feed * self.layer_counts[t]]
            w = w.reshape(out_feed, self.layer_counts[t])
            x = apply_activation(
                self.activations[t - 1], aug @ w.T, self.activation_params[t - 1]
            )
        return x[:, 0] if squeeze and x.shape[1] == 1 else (x[0] if squeeze else x)


# ---------------------------------------------------------------------------
# EG text format
# ---------------------------------------------------------------------------


def _parse_num_list(val: str, cast=float) -> list:
    return [cast(v) for v in val.split(",") if v != ""]


def read_eg(data: bytes) -> EncogNetwork:
    """Parse an Encog EG text file (BasicNetwork)."""
    text = data.decode("utf-8", errors="replace")
    lines = text.splitlines()
    if not lines or not lines[0].startswith("encog,"):
        raise ValueError("not an Encog EG file")
    section = ""
    props: Dict[str, str] = {}
    net: Dict[str, str] = {}
    acts: List[str] = []
    act_params: List[List[float]] = []
    for line in lines[1:]:
        line = line.strip()
        if not line:
            continue
        if line.startswith("["):
            section = line.strip("[]")
            continue
        if section == "BASIC:PARAMS":
            k, _, v = line.partition("=")
            props[k] = v
        elif section == "BASIC:NETWORK":
            k, _, v = line.partition("=")
            net[k] = v
        elif section == "BASIC:ACTIVATION":
            parts = line.split(",")
            name = parts[0].strip().strip('"')
            acts.append(name)
            act_params.append([float(p) for p in parts[1:] if p.strip()])
    layer_counts = _parse_num_list(net["layerCounts"], int)
    layer_feed = _parse_num_list(net["layerFeedCounts"], int)
    weights = np.array(_parse_num_list(net["weights"]), dtype=np.float64)
    bias_act = _parse_num_list(net.get("biasActivation", ""))
    return EncogNetwork(
        layer_counts=layer_counts,
        layer_feed_counts=layer_feed,
        weights=weights,
        activations=acts,
        activation_params=act_params,
        bias_activation=bias_act or None or [],
        properties=props,
    )


def _fmt(v: float) -> str:
    return repr(float(v))


def write_eg(net: EncogNetwork) -> bytes:
    """Serialize to Encog EG text loadable by EncogDirectoryPersistence."""
    out = io.StringIO()
    ts = int(time.time() * 1000)
    out.write(f"encog,BasicNetwork,java,3.0.0,1,{ts}\n")
    out.write("[BASIC]\n[BASIC:PARAMS]\n")
    for k, v in net.properties.items():
        out.write(f"{k}={v}\n")
    out.write("[BASIC:NETWORK]\n")
    n = len(net.layer_counts)
    zeros = ",".join(["0"] * n)
    out.write("beginTraining=0\n")
    out.write("connectionLimit=0\n")
    out.write(f"contextTargetOffset={zeros}\n")
    out.write(f"contextTargetSize={zeros}\n")
    out.write(f"endTraining={n - 1}\n")
    out.write("hasContext=f\n")
    out.write(f"inputCount={net.input_count}\n")
    out.write("layerCounts=" + ",".join(map(str, net.layer_counts)) + "\n")
    out.write("layerFeedCounts=" + ",".join(map(str, net.layer_feed_counts)) + "\n")
    out.write(f"layerContextCount={zeros}\n")
    out.write("layerIndex=" + ",".join(map(str, net.layer_index)) + "\n")
    out.write("output=" + ",".join(_fmt(v) for v in net.default_layer_output()) + "\n")
    out.write(f"outputCount={net.output_count}\n")
    out.write("weightIndex=" + ",".join(map(str, net.weight_index)) + "\n")
    out.write("weights=" + ",".join(_fmt(w) for w in net.weights) + "\n")
    out.write("biasActivation=" + ",".join(_fmt(b) for b in net.bias_activation) + "\n")
    out.write("[BASIC:ACTIVATION]\n")
    for name, params in zip(net.activations, net.activation_params):
        line = f'"{name}"'
        if params:
            line += "," + ",".join(_fmt(p) for p in params)
        out.write(line + "\n")
    return out.getvalue().encode("utf-8")


# ---------------------------------------------------------------------------
# conversion to/from our NNModelSpec layer list
# ---------------------------------------------------------------------------


def from_layers(
    weights: List[np.ndarray],
    biases: List[np.ndarray],
    hidden_activations: List[str],
    out_activation: str = "sigmoid",
) -> EncogNetwork:
    """Build an EncogNetwork from input-first [in,out] weight matrices."""
    n_trans = len(weights)
    feed = [weights[0].shape[0]] + [w.shape[1] for w in weights]  # input-first
    feed_rev = feed[::-1]  # output-first
    layer_counts = [feed_rev[0]] + [c + 1 for c in feed_rev[1:]]
    acts_in_first = list(hidden_activations[:n_trans - 1]) + [out_activation]
    enc_acts = [TO_ENCOG_NAME[a.lower()] for a in acts_in_first[::-1]] + ["ActivationLinear"]
    flat: List[float] = []
    for t in range(n_trans - 1, -1, -1):  # output-first transitions
        w, b = np.asarray(weights[t], np.float64), np.asarray(biases[t], np.float64)
        for j in range(w.shape[1]):
            flat.extend(w[:, j])
            flat.append(b[j])
    return EncogNetwork(
        layer_counts=layer_counts,
        layer_feed_counts=feed_rev,
        weights=np.array(flat, dtype=np.float64),
        activations=enc_acts,
    )


def to_layers(net: EncogNetwork):
    """Decompose into input-first ([in,out] weight, [out] bias) pairs +
    activation names; only valid when every non-output layer has a bias."""
    widx = net.weight_index
    weights, biases, acts = [], [], []
    n = len(net.layer_counts)
    for t in range(n - 1, 0, -1):  # input side -> output side
        out_feed = net.layer_feed_counts[t - 1]
        in_count = net.layer_counts[t]
        w = net.weights[widx[t - 1] : widx[t - 1] + out_feed * in_count]
        w = w.reshape(out_feed, in_count)
        has_bias = in_count > net.layer_feed_counts[t]
        if has_bias:
            weights.append(w[:, :-1].T.copy())
            biases.append((w[:, -1] * net.bias_activation[t]).copy())
        else:
            weights.append(w.T.copy())
            biases.append(np.zeros(out_feed))
        acts.append(FROM_ENCOG_NAME.get(net.activations[t - 1].lower(), "linear"))
    return weights, biases, acts

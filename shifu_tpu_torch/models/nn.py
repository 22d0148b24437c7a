"""MLP model: forward pass, weight init, and the .nn model spec
(counterpart of `shifu_tpu/models/nn.py`).

Replaces the reference's Encog network stack (BasicFloatNetwork +
FloatFlatNetwork flat-weight forward, DTrainUtils.generateNetwork) and its
serializers (nn/BinaryNNSerializer.java:44). The model math is torch over
a [{W, b}] list; the on-disk spec is the JAX package's self-describing
binary (magic `STNN`, `<I` header length, the JSON header, raw `<f4`
weights), so each package loads the other's file. Parity target:
nn/IndependentNNModel.java:58.

Activations (nn/Activation*.java + wdl/activation/*): sigmoid, tanh, relu,
leakyrelu, swish, ptanh (LeCun scaled tanh), linear, log, gaussian, each
written as the JAX package writes it (sigmoid as 1/(1+exp(-x)), not
`torch.sigmoid`), so the two differ only by libm.
"""

from __future__ import annotations

import json
import os
import struct
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from shifu_tpu_torch.utils.platform import DeviceLike, resolve_device

MAGIC = b"STNN"
FORMAT_VERSION = 1


def activation_fn(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    name = (name or "sigmoid").lower()
    if name in ("sigmoid", "logistic"):
        return lambda x: 1.0 / (1.0 + torch.exp(-x))
    if name == "tanh":
        return torch.tanh
    if name == "relu":
        # torch.maximum splits the gradient at 0 as jnp.maximum does
        return lambda x: torch.maximum(x, torch.zeros_like(x))
    if name in ("leakyrelu", "leaky_relu"):
        return lambda x: torch.where(x > 0, x, 0.01 * x)
    if name == "swish":
        return lambda x: x / (1.0 + torch.exp(-x))
    if name == "ptanh":  # LeCun scaled tanh (ActivationPTANH)
        return lambda x: 1.7159 * torch.tanh(x * 2.0 / 3.0)
    if name == "linear":
        return lambda x: x
    if name == "log":
        return lambda x: torch.sign(x) * torch.log1p(torch.abs(x))
    if name == "gaussian":
        return lambda x: torch.exp(-(x * x))
    raise ValueError(f"unknown activation: {name}")


def hidden_activation(activations: Sequence[str], i: int) -> str:
    """Layer i's activation name: the list cycles, tanh when empty."""
    return activations[i % len(activations)] if activations else "tanh"


def init_params(
    layer_sizes: Sequence[int],
    seed: int = 0,
    init: str = "xavier",
) -> List[Dict[str, np.ndarray]]:
    """[{W: [in, out], b: [out]}] — Xavier/He/Lecun/Gaussian randomizers
    (core/dtrain/random/*), the JAX package's numpy draws byte for byte."""
    rng = np.random.default_rng(seed)
    params = []
    for fan_in, fan_out in zip(layer_sizes[:-1], layer_sizes[1:]):
        if init == "xavier":
            limit = np.sqrt(6.0 / (fan_in + fan_out))
            w = rng.uniform(-limit, limit, size=(fan_in, fan_out))
        elif init == "he":
            w = rng.normal(0.0, np.sqrt(2.0 / fan_in), size=(fan_in, fan_out))
        elif init == "lecun":
            w = rng.normal(0.0, np.sqrt(1.0 / fan_in), size=(fan_in, fan_out))
        else:  # gaussian
            w = rng.normal(0.0, 1.0, size=(fan_in, fan_out))
        params.append(
            {"W": w.astype(np.float32), "b": np.zeros(fan_out, dtype=np.float32)}
        )
    return params


def forward(params, x: torch.Tensor, activations: Sequence[str],
            out_activation: str = "sigmoid") -> torch.Tensor:
    """x: [..., n_in] -> [..., n_out] over [{W, b}] tensors. Hidden
    activations per layer; the output layer's `out_activation` (reference
    networks end in sigmoid, DTrainUtils.generateNetwork)."""
    h = x
    for i in range(len(params) - 1):
        h = activation_fn(hidden_activation(activations, i))(
            h @ params[i]["W"] + params[i]["b"])
    out = h @ params[-1]["W"] + params[-1]["b"]
    return activation_fn(out_activation)(out)


def flatten_params(params) -> Tuple[np.ndarray, List[Tuple[int, int]]]:
    """[{W, b}] -> flat vector + layer shapes: per layer W [in, out]
    row-major, then b (Weight.java operates flat; the updater state and
    the model file are indexed by this layout)."""
    chunks, shapes = [], []
    for layer in params:
        shapes.append(tuple(layer["W"].shape))
        chunks.append(np.asarray(layer["W"]).ravel())
        chunks.append(np.asarray(layer["b"]).ravel())
    return np.concatenate(chunks), shapes


def unflatten_params(flat: np.ndarray, shapes: List[Tuple[int, int]]):
    params, off = [], 0
    for (fi, fo) in shapes:
        w = flat[off: off + fi * fo].reshape(fi, fo)
        off += fi * fo
        b = flat[off: off + fo]
        off += fo
        params.append({"W": np.asarray(w), "b": np.asarray(b)})
    return params


class MLP(torch.nn.Module):
    """The network as a module: one `W [in, out]` and `b [out]` parameter
    pair a layer, the flat layout's own orientation."""

    def __init__(self, params, activations: Sequence[str],
                 out_activation: str = "sigmoid",
                 device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        self.activations = list(activations)
        self.out_activation = out_activation
        self.weights = torch.nn.ParameterList(
            torch.nn.Parameter(torch.as_tensor(
                np.asarray(p["W"], np.float32), device=dev))
            for p in params)
        self.biases = torch.nn.ParameterList(
            torch.nn.Parameter(torch.as_tensor(
                np.asarray(p["b"], np.float32), device=dev))
            for p in params)

    def layers(self) -> List[Dict[str, torch.Tensor]]:
        return [{"W": w, "b": b} for w, b in zip(self.weights, self.biases)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return forward(self.layers(), x, self.activations,
                       self.out_activation)


def mlp_from_params(params, device: DeviceLike = None,
                    activations: Sequence[str] = ("tanh",),
                    out_activation: str = "sigmoid") -> MLP:
    """The JAX package's [{W, b}] numpy list -> the port's module."""
    return MLP(params, activations, out_activation, device=device)


def params_from_mlp(mlp: MLP) -> List[Dict[str, np.ndarray]]:
    """The port's module -> a [{W, b}] numpy list (f32, on the host)."""
    return [{"W": w.detach().cpu().numpy(), "b": b.detach().cpu().numpy()}
            for w, b in zip(mlp.weights, mlp.biases)]


# ---------------------------------------------------------------------------
# Model spec (.nn)
# ---------------------------------------------------------------------------


@dataclass
class NNModelSpec:
    """Self-contained scoring spec: columns + norm info + weights (the
    reference's BinaryNNSerializer embeds per-column stats the same way)."""

    layer_sizes: List[int]
    activations: List[str]
    out_activation: str = "sigmoid"
    input_columns: List[str] = field(default_factory=list)
    norm_type: str = "ZSCALE"
    algorithm: str = "NN"
    loss: str = "squared"
    # per-input-column normalization tables, the NormPlan's JSON, so an
    # independent scorer can normalize RAW records
    norm_specs: List[Dict[str, Any]] = field(default_factory=list)
    norm_cutoff: float = 4.0
    params: Optional[List[Dict[str, np.ndarray]]] = None
    train_error: Optional[float] = None
    valid_error: Optional[float] = None
    # multi-class: the ordered tag list; output k scores class_tags[k].
    # Empty = binary regression model.
    class_tags: List[str] = field(default_factory=list)

    @property
    def out_dim(self) -> int:
        return int(self.layer_sizes[-1]) if self.layer_sizes else 1

    def header(self) -> dict:
        return {
            "formatVersion": FORMAT_VERSION,
            "algorithm": self.algorithm,
            "layerSizes": self.layer_sizes,
            "activations": self.activations,
            "outActivation": self.out_activation,
            "inputColumns": self.input_columns,
            "normType": self.norm_type,
            "loss": self.loss,
            "normSpecs": self.norm_specs,
            "normCutoff": self.norm_cutoff,
            "trainError": self.train_error,
            "validError": self.valid_error,
            "classTags": self.class_tags,
        }

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        flat, shapes = flatten_params(self.params)
        head = self.header()
        head["layerShapes"] = [list(s) for s in shapes]
        head_bytes = json.dumps(head).encode("utf-8")
        with open(path, "wb") as fh:
            fh.write(MAGIC)
            fh.write(struct.pack("<I", len(head_bytes)))
            fh.write(head_bytes)
            fh.write(flat.astype("<f4").tobytes())

    @classmethod
    def load(cls, path: str) -> "NNModelSpec":
        with open(path, "rb") as fh:
            data = fh.read()
        if data[:4] != MAGIC:
            raise ValueError(f"{path}: not a shifu-tpu .nn model")
        (hlen,) = struct.unpack("<I", data[4:8])
        head = json.loads(data[8: 8 + hlen].decode("utf-8"))
        flat = np.frombuffer(data[8 + hlen:], dtype="<f4")
        shapes = [tuple(s) for s in head["layerShapes"]]
        spec = cls(
            layer_sizes=head["layerSizes"],
            activations=head["activations"],
            out_activation=head.get("outActivation", "sigmoid"),
            input_columns=head.get("inputColumns", []),
            norm_type=head.get("normType", "ZSCALE"),
            algorithm=head.get("algorithm", "NN"),
            loss=head.get("loss", "squared"),
            norm_specs=head.get("normSpecs", []),
            norm_cutoff=float(head.get("normCutoff", 4.0)),
            train_error=head.get("trainError"),
            valid_error=head.get("validError"),
            class_tags=head.get("classTags", []),
        )
        spec.params = unflatten_params(flat.copy(), shapes)
        return spec


class IndependentNNModel:
    """Scorer over NORMALIZED input vectors, backed by an `MLP` on an
    explicit device (`device=None` = cuda). Parity anchor:
    nn/IndependentNNModel.java:58."""

    def __init__(self, spec: NNModelSpec, device: DeviceLike = None):
        self.spec = spec
        self.device = resolve_device(device)
        self.mlp = mlp_from_params(spec.params, self.device,
                                   spec.activations, spec.out_activation)

    @classmethod
    def load(cls, path: str, device: DeviceLike = None
             ) -> "IndependentNNModel":
        return cls(NNModelSpec.load(path), device=device)

    def compute(self, x: np.ndarray) -> np.ndarray:
        """x: [n, n_in] normalized features -> [n] score (first output)."""
        out = self.compute_all(x)
        return out[:, 0] if out.ndim == 2 else out

    def compute_all(self, x: np.ndarray) -> np.ndarray:
        """All output neurons: [n, n_out] (multi-class NATIVE models emit
        one score per class)."""
        h = torch.as_tensor(np.asarray(x, dtype=np.float32),
                            device=self.device)
        with torch.no_grad():
            return self.mlp(h).cpu().numpy()

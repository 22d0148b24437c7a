"""Tree-ensemble model: dense array layout, traversal, the `.gbt`/`.rf` file.

Counterpart of `shifu_tpu/models/tree.py`. One tree is a complete binary
tree in level order:

    feature[node]        int32   split feature (-1 = leaf)
    left_mask[node, S]   bool    bin -> goes-left (numeric thresholds and
                                 categorical subsets alike)
    leaf_value[node]     float32 prediction at the node (valid where leaf)

Node i's children are 2i+1 / 2i+2. The file format (`STDT` magic, a JSON
head, then per-tree little-endian arrays) is byte-identical to the JAX
package's, so either package loads what the other saved.
"""

from __future__ import annotations

import io
import json
import os
import struct
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from shifu_tpu_torch.utils.platform import DeviceLike, resolve_device

MAGIC = b"STDT"
FORMAT_VERSION = 1


@dataclass
class DenseTree:
    """Complete-binary layout (children implicit at 2i+1/2i+2) for
    level-wise trees; leaf-wise trees carry explicit child pointers in
    `left`/`right` (-1 = none)."""

    feature: np.ndarray  # [n_nodes] int32, -1 = leaf
    left_mask: np.ndarray  # [n_nodes, max_slots] bool
    leaf_value: np.ndarray  # [n_nodes] float32
    weight: float = 1.0  # tree weight (GBT learning rate folded in here)
    left: Optional[np.ndarray] = None  # [n_nodes] int32, leaf-wise only
    right: Optional[np.ndarray] = None

    @property
    def n_nodes(self) -> int:
        return int(self.feature.shape[0])

    @property
    def is_dense_layout(self) -> bool:
        return self.left is None

    @property
    def depth(self) -> int:
        if self.is_dense_layout:
            return int(np.log2(self.n_nodes + 1)) - 1
        depth = np.zeros(self.n_nodes, dtype=np.int32)
        for i in range(self.n_nodes):
            for c in (self.left[i], self.right[i]):
                if c >= 0:
                    depth[c] = depth[i] + 1
        return int(depth.max()) if self.n_nodes else 0


@dataclass
class TreeModelSpec:
    algorithm: str  # GBT | RF
    trees: List[DenseTree]
    input_columns: List[str]
    slots: List[int]  # bin-slot count per feature
    boundaries: List[Optional[List[float]]] = field(default_factory=list)
    categories: List[Optional[List[str]]] = field(default_factory=list)
    loss: str = "squared"
    learning_rate: float = 0.05
    init_pred: float = 0.0  # GBT F_0
    convert_to_prob: str = "SIGMOID"  # GBT score conversion
    train_error: Optional[float] = None
    valid_error: Optional[float] = None
    norm_type: str = "CODES"
    norm_specs: List[Dict[str, Any]] = field(default_factory=list)
    # >= 3: NATIVE RF multi-class (leaf values are class indices)
    n_classes: int = 0

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        head = {
            "formatVersion": FORMAT_VERSION,
            "algorithm": self.algorithm,
            "inputColumns": self.input_columns,
            "slots": self.slots,
            "boundaries": self.boundaries,
            "categories": self.categories,
            "loss": self.loss,
            "learningRate": self.learning_rate,
            "initPred": self.init_pred,
            "convertToProb": self.convert_to_prob,
            "trainError": self.train_error,
            "validError": self.valid_error,
            "nClasses": self.n_classes,
            "trees": [
                {"nNodes": t.n_nodes, "maxSlots": int(t.left_mask.shape[1]),
                 "weight": t.weight, "leafWise": not t.is_dense_layout}
                for t in self.trees
            ],
        }
        head_bytes = json.dumps(head).encode("utf-8")
        buf = io.BytesIO()
        buf.write(MAGIC)
        buf.write(struct.pack("<I", len(head_bytes)))
        buf.write(head_bytes)
        for t in self.trees:
            buf.write(t.feature.astype("<i4").tobytes())
            buf.write(np.packbits(t.left_mask, axis=None).tobytes())
            buf.write(t.leaf_value.astype("<f4").tobytes())
            if not t.is_dense_layout:
                buf.write(t.left.astype("<i4").tobytes())
                buf.write(t.right.astype("<i4").tobytes())
        with open(path, "wb") as fh:
            fh.write(buf.getvalue())

    @classmethod
    def load(cls, path: str) -> "TreeModelSpec":
        with open(path, "rb") as fh:
            data = fh.read()
        if data[:4] != MAGIC:
            raise ValueError(f"{path}: not a shifu tree model")
        (hlen,) = struct.unpack("<I", data[4:8])
        head = json.loads(data[8:8 + hlen].decode("utf-8"))
        off = 8 + hlen
        trees = []
        for tmeta in head["trees"]:
            n, s = tmeta["nNodes"], tmeta["maxSlots"]
            feature = np.frombuffer(data, dtype="<i4", count=n,
                                    offset=off).copy()
            off += 4 * n
            nbits = n * s
            nbytes = (nbits + 7) // 8
            bits = np.unpackbits(
                np.frombuffer(data, dtype=np.uint8, count=nbytes, offset=off),
                count=nbits)
            left_mask = bits.reshape(n, s).astype(bool)
            off += nbytes
            leaf_value = np.frombuffer(data, dtype="<f4", count=n,
                                       offset=off).copy()
            off += 4 * n
            left = right = None
            if tmeta.get("leafWise"):
                left = np.frombuffer(data, dtype="<i4", count=n,
                                     offset=off).copy()
                off += 4 * n
                right = np.frombuffer(data, dtype="<i4", count=n,
                                      offset=off).copy()
                off += 4 * n
            trees.append(DenseTree(feature=feature, left_mask=left_mask,
                                   leaf_value=leaf_value,
                                   weight=tmeta.get("weight", 1.0),
                                   left=left, right=right))
        return cls(
            algorithm=head["algorithm"],
            trees=trees,
            input_columns=head.get("inputColumns", []),
            slots=head.get("slots", []),
            boundaries=head.get("boundaries", []),
            categories=head.get("categories", []),
            loss=head.get("loss", "squared"),
            learning_rate=float(head.get("learningRate", 0.05)),
            init_pred=float(head.get("initPred", 0.0)),
            convert_to_prob=head.get("convertToProb", "SIGMOID"),
            train_error=head.get("trainError"),
            valid_error=head.get("validError"),
            n_classes=int(head.get("nClasses", 0)),
        )

    def independent(self, device: DeviceLike = None
                    ) -> "IndependentTreeModel":
        return IndependentTreeModel(self, device=device)


def leaf_nodes(trees: List[DenseTree], codes: torch.Tensor
               ) -> torch.Tensor:
    """codes [n, F] int tensor -> the node each row ends at in each tree
    [n, n_trees] long on the codes' device: children at 2i+1/2i+2 in a
    dense tree, by the explicit `left`/`right` pointers in a leaf-wise
    one."""
    dev = codes.device
    n = codes.shape[0]
    codes = codes.long()
    outs = []
    for t in trees:
        feature = torch.as_tensor(t.feature, device=dev).long()
        left_mask = torch.as_tensor(t.left_mask, device=dev)
        dense = t.is_dense_layout
        lch = None if dense else torch.as_tensor(t.left, device=dev).long()
        rch = None if dense else torch.as_tensor(t.right, device=dev).long()
        node = torch.zeros(n, dtype=torch.long, device=dev)
        for _ in range(t.depth):
            f = feature[node]
            is_leaf = f < 0
            code = torch.gather(codes, 1, f.clamp_min(0)[:, None])[:, 0]
            goes_left = left_mask[node,
                                  code.clamp(0, left_mask.shape[1] - 1)]
            if dense:
                child = torch.where(goes_left, 2 * node + 1, 2 * node + 2)
            else:
                child = torch.where(goes_left, lch[node], rch[node])
            node = torch.where(is_leaf, node, child)
        outs.append(node)
    if not outs:
        return torch.zeros((n, 0), dtype=torch.long, device=dev)
    return torch.stack(outs, dim=1)


def tree_leaves(trees: List[DenseTree], codes: torch.Tensor
                ) -> torch.Tensor:
    """codes [n, F] int tensor -> each tree's leaf value (unweighted)
    [n, n_trees] f32 on the codes' device."""
    nodes = leaf_nodes(trees, codes)
    if not trees:
        return nodes.to(torch.float32)
    return torch.stack([
        torch.as_tensor(t.leaf_value, device=codes.device)[nodes[:, k]]
        for k, t in enumerate(trees)], dim=1)


def _weights(trees: List[DenseTree], dev, dtype) -> torch.Tensor:
    """The trees' weights as the f32 constants XLA makes of them."""
    return torch.as_tensor(np.asarray([t.weight for t in trees], np.float32),
                           device=dev).to(dtype)


def traverse_trees(trees: List[DenseTree], codes: torch.Tensor
                   ) -> torch.Tensor:
    """codes [n, F] int tensor -> per-tree weighted leaf predictions
    [n, n_trees] f32 on the codes' device."""
    leaves = tree_leaves(trees, codes)
    return leaves * _weights(trees, leaves.device, leaves.dtype)


def weighted_tree_sum(trees: List[DenseTree], leaves: torch.Tensor
                      ) -> torch.Tensor:
    """sum_k leaf_k * weight_k per row, in tree order, each step one
    rounding to f32 of the exact product plus the sum so far: XLA's CPU
    code for `sum(leaf * weight)`, which fuses each product into the
    reduce as an FMA (a reduce in tree order for forests of up to 17
    trees). Done in f64 and rounded once a step, so every device gives
    the same bits."""
    w = _weights(trees, leaves.device, torch.float64)
    out = torch.zeros(leaves.shape[0], dtype=torch.float32,
                      device=leaves.device)
    for k in range(leaves.shape[1]):
        out = (leaves[:, k].double() * w[k] + out.double()).float()
    return out


class IndependentTreeModel:
    """Scorer (parity: dt/IndependentTreeModel.java:51 compute :352) over
    bin codes, or over raw columns binned on the host by the embedded
    boundaries/categories (`codes_from_raw`)."""

    def __init__(self, spec: TreeModelSpec, device: DeviceLike = None):
        self.spec = spec
        self.device = resolve_device(device)

    @classmethod
    def load(cls, path: str, device: DeviceLike = None
             ) -> "IndependentTreeModel":
        return cls(TreeModelSpec.load(path), device=device)

    def codes_from_raw(self, data) -> np.ndarray:
        """ColumnarData -> [n, F] int32 codes by the embedded binning."""
        from shifu_tpu_torch.stats.binning import (
            categorical_bin_index,
            hybrid_bin_index,
            numeric_bin_index,
        )

        spec = self.spec
        cols = []
        for j, name in enumerate(spec.input_columns):
            cats = spec.categories[j] if j < len(spec.categories) else None
            bounds = spec.boundaries[j] if j < len(spec.boundaries) else None
            if cats and bounds:  # hybrid column: numeric bins then cats
                cols.append(hybrid_bin_index(data.column(name), bounds, cats,
                                             data.missing_mask(name)))
            elif cats:
                cols.append(categorical_bin_index(data.column(name), cats,
                                                  data.missing_mask(name)))
            else:
                cols.append(numeric_bin_index(data.numeric(name),
                                              bounds or [float("-inf")]))
        return np.stack(cols, axis=1).astype(np.int32)

    def compute(self, codes) -> np.ndarray:
        """codes [n, F] -> score [n] in [0, 1] (regression/binary) or
        per-class vote fractions [n, K] (NATIVE RF multi-class)."""
        spec = self.spec
        c = torch.as_tensor(np.asarray(codes, dtype=np.int32)
                            if not isinstance(codes, torch.Tensor) else codes,
                            device=self.device)
        leaves = tree_leaves(spec.trees, c)
        if spec.n_classes >= 3:
            per_tree = leaves * _weights(spec.trees, leaves.device,
                                         leaves.dtype)
            cls = per_tree.long().clamp(0, spec.n_classes - 1)
            votes = torch.nn.functional.one_hot(
                cls, spec.n_classes).to(torch.float32).sum(dim=1)
            out = votes / max(len(spec.trees), 1)
        elif spec.algorithm == "GBT":
            raw = spec.init_pred + weighted_tree_sum(spec.trees, leaves)
            if spec.loss == "log" or spec.convert_to_prob == "SIGMOID":
                out = 1.0 / (1.0 + torch.exp(-raw))
            else:
                out = raw.clamp(0.0, 1.0)
        else:  # RF: mean vote
            # XLA's mean: the sum times the f32 reciprocal of the count
            inv = np.float32(1.0 / max(len(spec.trees), 1))
            out = (weighted_tree_sum(spec.trees, leaves)
                   * float(inv)).clamp(0.0, 1.0)
        return out.cpu().numpy()


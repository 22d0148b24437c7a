"""Carry a trained forest between the JAX package and the port.

Trees are the weights of this slice. Both packages describe a forest with
the same dataclass field names (`TreeModelSpec`, `DenseTree`), so the
state crosses as plain numpy arrays and python values:

    spec_from(src)        any TreeModelSpec-like object (the JAX
                          package's, read from a file or just trained) or
                          the dict of `spec_fields` -> the port's spec
    forest_from(feature, left_mask, leaf_value, weight, **fields)
                          per-tree numpy lists -> the port's spec
    spec_fields(spec)     the port's spec -> {field: value, "trees":
                          [{DenseTree field: array}]}, which the other
                          package rebuilds with
                          TreeModelSpec(**{**d, "trees": [DenseTree(**t)
                          for t in d["trees"]]})

Nothing here imports the JAX package; the caller holds both.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from shifu_tpu_torch.models.tree import DenseTree, TreeModelSpec

_TREE_FIELDS = [f.name for f in dataclasses.fields(DenseTree)]
_SPEC_FIELDS = [f.name for f in dataclasses.fields(TreeModelSpec)
                if f.name != "trees"]


def _get(src: Any, name: str, default=None):
    if isinstance(src, dict):
        return src.get(name, default)
    return getattr(src, name, default)


def tree_from(src: Any) -> DenseTree:
    """One tree from any object or dict with DenseTree's field names."""
    def arr(name, dtype):
        v = _get(src, name)
        return None if v is None else np.array(v, dtype=dtype)

    return DenseTree(feature=arr("feature", np.int32),
                     left_mask=arr("left_mask", bool),
                     leaf_value=arr("leaf_value", np.float32),
                     weight=float(_get(src, "weight", 1.0)),
                     left=arr("left", np.int32), right=arr("right", np.int32))


def spec_from(src: Any) -> TreeModelSpec:
    """The port's TreeModelSpec from a TreeModelSpec-like object or a
    `spec_fields` dict."""
    fields = {name: _get(src, name) for name in _SPEC_FIELDS
              if _get(src, name) is not None}
    return TreeModelSpec(trees=[tree_from(t) for t in _get(src, "trees")],
                         **fields)


def forest_from(feature: Sequence[np.ndarray],
                left_mask: Sequence[np.ndarray],
                leaf_value: Sequence[np.ndarray],
                weight: Optional[Sequence[float]] = None,
                **fields) -> TreeModelSpec:
    """The port's spec from per-tree numpy lists (dense level-order
    trees); `fields` are TreeModelSpec's other fields (algorithm,
    input_columns, slots, ...)."""
    weight = list(weight) if weight is not None else [1.0] * len(feature)
    trees = [tree_from({"feature": f, "left_mask": m, "leaf_value": v,
                        "weight": w})
             for f, m, v, w in zip(feature, left_mask, leaf_value, weight)]
    return TreeModelSpec(trees=trees, **fields)


def spec_fields(spec: TreeModelSpec) -> Dict[str, Any]:
    """Plain fields of the port's spec, trees as dicts of numpy arrays."""
    out: Dict[str, Any] = {name: getattr(spec, name) for name in _SPEC_FIELDS}
    trees: List[Dict[str, Any]] = []
    for t in spec.trees:
        trees.append({name: (np.array(getattr(t, name))
                             if isinstance(getattr(t, name), np.ndarray)
                             else getattr(t, name))
                      for name in _TREE_FIELDS})
    out["trees"] = trees
    return out

"""Hyper-parameter grid/random search (the port's copy of
`shifu_tpu/train/grid_search.py`).

Parity: core/dtrain/gs/GridSearch.java:44 — a train param whose value is a
list becomes a grid dimension; for natively-list-valued keys
(ActivationFunc, NumHiddenNodes, FixedLayers, NumEmbedColumnIds) a grid
dimension is a list OF lists (GridSearch.java:171-185). Flattening is
cartesian over sorted keys; when the flattened count exceeds
`shifu.gridsearch.threshold` (default 30) a seeded random subset is used
(checkParamsThreshold, GridSearch.java:222-232). A grid config file
(train.gridConfigFile) holds one `k:v;k:v` composite per line.
"""

from __future__ import annotations

import itertools
import random
from typing import Any, Dict, List, Optional

from shifu_tpu_torch.utils import environment

LIST_NATURED_KEYS = {
    "ActivationFunc",
    "NumHiddenNodes",
    "FixedLayers",
    "NumEmbedColumnIds",
}


def _is_hyper(key: str, value: Any) -> bool:
    if key in LIST_NATURED_KEYS:
        return (
            isinstance(value, list)
            and len(value) > 0
            and isinstance(value[0], list)
        )
    return isinstance(value, list)


def _parse_value(raw: str) -> Any:
    raw = raw.strip()
    if raw.startswith("[") and raw.endswith("]"):
        inner = raw[1:-1].strip()
        return [_parse_value(v) for v in inner.split(",")] if inner else []
    for cast in (int, float):
        try:
            return cast(raw)
        except ValueError:
            continue
    return raw


def parse_grid_file(path: str) -> List[Dict[str, Any]]:
    """One composite per line: `LearningRate:0.1;NumHiddenNodes:[30,20]`."""
    out = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            composite: Dict[str, Any] = {}
            for ele in line.split(";"):
                if ":" not in ele:
                    continue
                k, v = ele.split(":", 1)
                composite[k.strip()] = _parse_value(v)
            if composite:
                out.append(composite)
    return out


def flatten_params(
    params: Dict[str, Any],
    grid_config_file: Optional[str] = None,
    seed: int = 0,
) -> List[Dict[str, Any]]:
    """All trainer param composites. Length 1 means no grid search."""
    if grid_config_file:
        composites = parse_grid_file(grid_config_file)
        if composites:
            return composites

    keys = sorted(params.keys())
    hyper = [(k, params[k]) for k in keys if _is_hyper(k, params[k])]
    if not hyper:
        return [dict(params)]
    normal = {k: v for k, v in params.items() if not _is_hyper(k, v)}

    composites = []
    for combo in itertools.product(*(v for _, v in hyper)):
        m = dict(normal)
        for (k, _), v in zip(hyper, combo):
            m[k] = v
        composites.append(m)

    threshold = environment.get_int("shifu.gridsearch.threshold", 30)
    if len(composites) > threshold:
        rng = random.Random(seed)
        composites = rng.sample(composites, threshold)
    return composites

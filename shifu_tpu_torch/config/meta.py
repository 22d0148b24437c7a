"""Meta-driven ModelConfig validation — config schema as data.

The port's own copy of `shifu_tpu/config/meta.py`, the same code and the same bytes on
disk; the port imports nothing of the JAX package.

Parity: container/meta/MetaFactory.java:44 + resources/store/
ModelConfigMeta.json — every section's fields are checked against a
bundled meta description (types, numeric ranges, string lengths, select
options) BEFORE any per-step probe logic runs, so schema errors surface
with the field's wire name and the allowed values, exactly like
MetaFactory's "... is not in [a/b/c]" causes.

The meta file ships with the package (model_config_meta.json) and speaks
the same camelCase wire names as ModelConfig.json, so validation walks the
ENCODED config — whatever loaded from disk is what gets checked.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List

_META_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "model_config_meta.json")
_META_CACHE: List[dict] = []


def load_meta() -> List[dict]:
    global _META_CACHE
    if not _META_CACHE:
        with open(_META_PATH) as fh:
            _META_CACHE = json.load(fh)
    return _META_CACHE


def _check_item(group: str, item: dict, value: Any, errors: List[str]) -> None:
    name = f"{group}.{item['name']}"
    if value is None:
        return  # absent fields keep their defaults; required-ness is the
        # per-step probe's business (ModelInspector), not the schema's
    t = item.get("type", "text")
    if t == "boolean":
        if not isinstance(value, bool):
            errors.append(f"{name}: expected boolean, got {value!r}")
        return
    if t in ("integer", "float", "number"):
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            errors.append(f"{name}: expected {t}, got {value!r}")
            return
        if t == "integer" and not float(value).is_integer():
            errors.append(f"{name}: expected integer, got {value!r}")
            return
        lo, hi = item.get("minValue"), item.get("maxValue")
        if lo is not None and value < lo:
            errors.append(f"{name}: {value} is below minimum {lo}")
        if hi is not None and value > hi:
            errors.append(f"{name}: {value} is above maximum {hi}")
        return
    if t == "list":
        if not isinstance(value, (list, tuple)):
            errors.append(f"{name}: expected a list, got {value!r}")
        return
    if t == "map":
        if not isinstance(value, dict):
            errors.append(f"{name}: expected a map, got {value!r}")
        return
    # text
    text = str(value)
    lo, hi = item.get("minLength"), item.get("maxLength")
    if lo is not None and len(text) < lo:
        errors.append(f"{name}: length {len(text)} is below minimum {lo}")
    if hi is not None and len(text) > hi:
        errors.append(f"{name}: length {len(text)} is above maximum {hi}")
    options = item.get("options")
    if options is not None and text:
        if text.lower() not in {str(o).lower() for o in options}:
            errors.append(
                f"{name}: {text!r} is not in [{'/'.join(map(str, options))}]"
            )


def validate_model_config(mc) -> List[str]:
    """All schema violations in the config (empty list = clean)."""
    from shifu_tpu_torch.config.jsonbase import encode_dataclass

    wire: Dict[str, Any] = encode_dataclass(mc)
    errors: List[str] = []
    for group in load_meta():
        gname = group["group"]
        section = wire.get(gname)
        if section is None:
            continue
        elements = section if group.get("perElement") else [section]
        for idx, el in enumerate(elements):
            if not isinstance(el, dict):
                continue
            prefix = f"{gname}[{idx}]" if group.get("perElement") else gname
            for item in group["metaList"]:
                _check_item(prefix, item, el.get(item["name"]), errors)
    return errors

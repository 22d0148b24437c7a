"""Operational configuration: the `shifuconfig` analog.

The port's own copy of `shifu_tpu/utils/environment.py`, the same code and the same bytes on
disk; the port imports nothing of the JAX package.

Three tiers, mirroring the reference (util/Environment.java:86-87 and
ShifuCLI.cleanArgs:430):
  1. `$SHIFU_TPU_HOME/conf/shifuconfig` then `/etc/shifuconfig` (key=value file)
  2. process environment variables prefixed SHIFU_
  3. `-Dk=v` CLI overrides (highest priority)
"""

from __future__ import annotations

import os
from typing import Dict, Optional

_props: Dict[str, str] = {}
_loaded = False


def _load_file(path: str) -> None:
    if not os.path.isfile(path):
        return
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            if "=" in line:
                k, v = line.split("=", 1)
                _props[k.strip()] = v.strip()


def _ensure_loaded() -> None:
    global _loaded
    if _loaded:
        return
    home = os.environ.get("SHIFU_TPU_HOME")
    if home:
        _load_file(os.path.join(home, "conf", "shifuconfig"))
    _load_file("/etc/shifuconfig")
    # tier 2: SHIFU_* env vars override config files (tier 3, -D, overrides both
    # via set_property)
    for k, v in os.environ.items():
        if k.startswith("SHIFU_") and k != "SHIFU_TPU_HOME":
            _props[k[len("SHIFU_"):].lower().replace("_", ".")] = v
    _loaded = True


def set_property(key: str, value: str) -> None:
    _ensure_loaded()
    _props[key] = str(value)


def get_property(key: str, default: Optional[str] = None) -> Optional[str]:
    _ensure_loaded()
    return _props.get(key, default)


def get_int(key: str, default: int) -> int:
    v = get_property(key)
    try:
        return int(v) if v is not None else default
    except ValueError:
        return default


def get_float(key: str, default: float) -> float:
    v = get_property(key)
    try:
        return float(v) if v is not None else default
    except ValueError:
        return default


def get_bool(key: str, default: bool) -> bool:
    """Empty string = unset (falls back to `default`), matching
    get_int/get_float — `set_property(k, "")` is the repo's only way to
    clear an override, and it must not silently pin False."""
    v = get_property(key)
    if v is None or not v.strip():
        return default
    return v.strip().lower() in ("1", "true", "yes", "on")


def all_properties() -> Dict[str, str]:
    _ensure_loaded()
    return dict(_props)

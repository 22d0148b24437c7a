"""Tiny camelCase-JSON dataclass bridge.

The port's own copy of `shifu_tpu/config/jsonbase.py`, the same code and the same bytes on
disk; the port imports nothing of the JAX package.

The reference serializes configs with Jackson using camelCase field names
(container/obj/*.java). We keep Python snake_case attributes and map them to
camelCase on the wire, tolerating unknown keys (forward/backward compat, like
Jackson's FAIL_ON_UNKNOWN_PROPERTIES=false used by the reference's JSONUtils).
"""

from __future__ import annotations

import dataclasses
import enum
import json
import math
import typing
from typing import Any, Optional, Type, TypeVar, get_args, get_origin

T = TypeVar("T")


def snake_to_camel(name: str) -> str:
    parts = name.split("_")
    return parts[0] + "".join(p.title() for p in parts[1:])


class JsonEnum(enum.Enum):
    """Enum that serializes to its value and parses case-insensitively.

    The reference parses most enums case-insensitively (e.g. runMode "local"
    vs "LOCAL", norm type "WOE_ZSCALE" vs "woe_zscale").
    """

    @classmethod
    def parse(cls, raw: Any, default=None):
        """Parse a wire value. None/empty -> default; an unrecognized value
        raises (fail fast, like Jackson's unknown-enum-constant error in the
        reference) rather than silently degrading to None."""
        if raw is None or (isinstance(raw, str) and not raw.strip()):
            return default
        if isinstance(raw, cls):
            return raw
        text = str(raw).strip()
        for member in cls:
            if str(member.value).lower() == text.lower() or member.name.lower() == text.lower():
                return member
        # Aliases hook: subclasses may define _ALIASES {lower-name: member-name}
        aliases = getattr(cls, "_ALIASES", None)
        if aliases:
            target = dict(aliases).get(text.lower())
            if target is not None:
                return cls[target]
        raise ValueError(
            f"invalid {cls.__name__} value {raw!r}; expected one of "
            f"{[m.value for m in cls]}"
        )

    def to_json(self):
        return self.value


def _encode(value: Any) -> Any:
    if isinstance(value, JsonEnum):
        return value.to_json()
    if isinstance(value, enum.Enum):
        return value.value
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return encode_dataclass(value)
    if isinstance(value, dict):
        return {k: _encode(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_encode(v) for v in value]
    if isinstance(value, float):
        # Jackson writes Infinity/-Infinity/NaN tokens; json.dump does the same
        # with allow_nan=True, so floats pass through.
        return value
    return value


def encode_dataclass(obj: Any) -> dict:
    out = {}
    for f in dataclasses.fields(obj):
        if f.metadata.get("skip_json"):
            continue
        wire = f.metadata.get("json", snake_to_camel(f.name))
        out[wire] = _encode(getattr(obj, f.name))
    return out


def _decode(ftype: Any, raw: Any) -> Any:
    if raw is None:
        return None
    origin = get_origin(ftype)
    if origin is typing.Union:  # Optional[X]
        args = [a for a in get_args(ftype) if a is not type(None)]
        if len(args) == 1:
            return _decode(args[0], raw)
        return raw
    if origin in (list, tuple):
        (inner,) = get_args(ftype) or (Any,)
        return [_decode(inner, v) for v in raw]
    if origin is dict:
        return dict(raw)
    if isinstance(ftype, type):
        if issubclass(ftype, JsonEnum):
            return ftype.parse(raw)
        if dataclasses.is_dataclass(ftype):
            return decode_dataclass(ftype, raw)
        if ftype is float:
            if isinstance(raw, str):
                low = raw.strip().lower()
                if low in ("infinity", "+infinity", "inf"):
                    return math.inf
                if low in ("-infinity", "-inf"):
                    return -math.inf
                if low == "nan":
                    return math.nan
            return float(raw)
        if ftype is int and not isinstance(raw, bool):
            return int(raw)
        if ftype is bool:
            if isinstance(raw, bool):
                return raw
            # Jackson-style coercion: "true"/"false"/0/1 are valid booleans
            if isinstance(raw, str):
                return raw.strip().lower() in ("true", "1", "yes", "on")
            if isinstance(raw, (int, float)):
                return bool(raw)
            return raw
        if ftype is str:
            return str(raw)
    return raw


def decode_dataclass(cls: Type[T], data: Optional[dict]) -> T:
    if data is None:
        data = {}
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        wire = f.metadata.get("json", snake_to_camel(f.name))
        if wire in data:
            kwargs[f.name] = _decode(hints[f.name], data[wire])
        # else: dataclass default applies
    return cls(**kwargs)


def dump_json(obj: Any, path: str) -> None:
    with open(path, "w") as fh:
        json.dump(_encode(obj), fh, indent=2, default=str)
        fh.write("\n")


def dumps_json(obj: Any) -> str:
    return json.dumps(_encode(obj), indent=2, default=str)

"""Columnar binary scoring wire format (counterpart of
`shifu_tpu/serve/wire.py`; the same bytes both ways).

`POST /score` takes this format beside JSON, chosen by Content-Type
(`application/x-shifu-columnar`). A binary batch decodes into typed numpy
column views over the request body (`np.frombuffer`, no Python object a
value), and typed columns skip the featurizer's parse (`data/reader.py`),
so both formats reach the same (values, codes) arrays.

Layout, little-endian, one header then `n_cols` column blocks::

    offset  size  field
    0       4     magic  b"SHWB"
    4       2     version (u16) = 1
    6       4     n_rows  (u32)
    10      4     n_cols  (u32)

    per column:
    +0      2     name_len (u16)
    +2      var   column name (UTF-8)
    ..      1     type code (u8)
    ..      var   payload

    type  code  payload
    f64   1     n_rows x 8 bytes
    i64   2     n_rows x 8 bytes
    f32   3     n_rows x 4 bytes
    i32   4     n_rows x 4 bytes
    str   5     (n_rows+1) u32 offsets, then offsets[-1] bytes of UTF-8;
                row i is bytes[offsets[i]:offsets[i+1]]

The encoder writes f64/i64, never f32/i32: a numeric column must decode
to the doubles the JSON path parses, and integers stay integral (`str(1)`
is "1", `str(1.0)` "1.0", which a categorical column tells apart). f32
and i32 are accepted on decode. Missing values are NaN in float columns;
integer and string columns carry none.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Sequence

import numpy as np

from shifu_tpu_torch.data.reader import ColumnarData
from shifu_tpu_torch.utils import environment

MAGIC = b"SHWB"
VERSION = 1
CONTENT_TYPE = "application/x-shifu-columnar"

TYPE_F64 = 1
TYPE_I64 = 2
TYPE_F32 = 3
TYPE_I32 = 4
TYPE_STR = 5

_DTYPES = {
    TYPE_F64: np.dtype("<f8"),
    TYPE_I64: np.dtype("<i8"),
    TYPE_F32: np.dtype("<f4"),
    TYPE_I32: np.dtype("<i4"),
}
_TYPE_OF_KIND = {"<f8": TYPE_F64, "<i8": TYPE_I64,
                 "<f4": TYPE_F32, "<i4": TYPE_I32}

_HEADER = struct.Struct("<4sHII")

DEFAULT_MAX_BODY_MB = 64.0


def max_body_bytes() -> int:
    """shifu.serve.wire.maxBodyMB: the largest binary body the server
    decodes (checked before anything is sized from the header)."""
    return int(environment.get_float("shifu.serve.wire.maxBodyMB",
                                     DEFAULT_MAX_BODY_MB)
               * 1024.0 * 1024.0)


class WireFormatError(ValueError):
    """Malformed binary batch: the server answers 400, never 500."""


def column_from_values(values: Sequence) -> np.ndarray:
    """One request column of JSON values -> the array both formats
    produce:

      all float/None  -> f64 (None = NaN)
      all int         -> i64 (past 64 bits: strings)
      anything else   -> object strings, None -> "" (bools and mixed
                         int/float land here)
    """
    kinds = set(map(type, values))
    if kinds and kinds <= {float, type(None)}:
        return np.asarray([np.nan if v is None else v for v in values],
                          dtype=np.float64)
    if kinds == {int}:
        try:
            return np.asarray(values, dtype=np.int64)
        except OverflowError:
            pass
    return np.asarray(["" if v is None else str(v) for v in values],
                      dtype=object)


def conform_columns(data: ColumnarData,
                    columns: Sequence[str]) -> ColumnarData:
    """A decoded batch in the serving schema: the client's typed arrays
    kept, absent columns made the "" missing token (what an absent JSON
    field becomes), extra columns dropped."""
    raw: Dict[str, np.ndarray] = {}
    for c in columns:
        if c in data.raw:
            raw[c] = data.raw[c]
        else:
            raw[c] = np.full(data.n_rows, "", dtype=object)
    return ColumnarData(names=list(columns), raw=raw, n_rows=data.n_rows,
                        missing_values=data.missing_values,
                        wire_format=data.wire_format)


def encode(data: ColumnarData) -> bytes:
    """A ColumnarData (typed or string columns) -> one payload: typed
    columns as raw little-endian buffers, the rest as offset-indexed
    UTF-8."""
    parts = [_HEADER.pack(MAGIC, VERSION, data.n_rows, len(data.names))]
    for name in data.names:
        col = data.raw[name]
        nb = name.encode("utf-8")
        parts.append(struct.pack("<H", len(nb)))
        parts.append(nb)
        arr = np.asarray(col)
        code = _TYPE_OF_KIND.get(arr.dtype.newbyteorder("<").str)
        if code is not None:
            parts.append(struct.pack("<B", code))
            parts.append(np.ascontiguousarray(
                arr.astype(arr.dtype.newbyteorder("<"),
                           copy=False)).tobytes())
            continue
        encoded = [("" if v is None else str(v)).encode("utf-8")
                   for v in col]
        offsets = np.zeros(len(encoded) + 1, dtype=np.uint32)
        np.cumsum([len(b) for b in encoded], out=offsets[1:])
        parts.append(struct.pack("<B", TYPE_STR))
        parts.append(offsets.tobytes())
        parts.append(b"".join(encoded))
    return b"".join(parts)


def encode_records(records: Sequence[dict],
                   columns: Optional[Sequence[str]] = None) -> bytes:
    """JSON-style records -> one payload (the client side). Columns
    default to first-seen key order."""
    if columns is None:
        columns = []
        for r in records:
            for k in r:
                if k not in columns:
                    columns.append(k)
    raw = {c: column_from_values([r.get(c) for r in records])
           for c in columns}
    return encode(ColumnarData(names=list(columns), raw=raw,
                               n_rows=len(records)))


def _need(payload: bytes, offset: int, size: int, what: str) -> None:
    if size < 0 or offset + size > len(payload):
        raise WireFormatError(
            f"truncated payload: {what} needs {size} bytes at offset "
            f"{offset}, body is {len(payload)} bytes")


def _decode_strings(payload: bytes, offset: int,
                    n_rows: int, name: str) -> tuple:
    """(object array of the rows' strings, next offset)."""
    osize = (n_rows + 1) * 4
    _need(payload, offset, osize, f"column {name!r} string offsets")
    offs = np.frombuffer(payload, dtype="<u4", count=n_rows + 1,
                         offset=offset)
    offset += osize
    if offs[0] != 0 or (np.diff(offs.astype(np.int64)) < 0).any():
        raise WireFormatError(
            f"column {name!r} string offsets are not monotone from 0")
    nbytes = int(offs[-1])
    _need(payload, offset, nbytes, f"column {name!r} string bytes")
    blob = payload[offset:offset + nbytes]
    offset += nbytes
    try:
        text = blob.decode("utf-8")
    except UnicodeDecodeError as e:
        raise WireFormatError(
            f"column {name!r} string bytes are not UTF-8: {e}") from None
    out = np.empty(n_rows, dtype=object)
    if len(text) == nbytes:  # pure ASCII: byte offsets are char offsets
        for i in range(n_rows):
            out[i] = text[offs[i]:offs[i + 1]]
    else:
        for i in range(n_rows):
            out[i] = blob[offs[i]:offs[i + 1]].decode("utf-8")
    return out, offset


def decode(payload: bytes) -> ColumnarData:
    """One payload -> a ColumnarData whose numeric columns are zero-copy
    views of the body and whose string columns are object arrays. Every
    malformed shape (short header, magic, version, type code, overruns,
    names, trailing bytes) raises WireFormatError."""
    _need(payload, 0, _HEADER.size, "header")
    magic, version, n_rows, n_cols = _HEADER.unpack_from(payload, 0)
    if magic != MAGIC:
        raise WireFormatError(f"bad magic {magic!r} (want {MAGIC!r})")
    if version != VERSION:
        raise WireFormatError(
            f"unsupported wire version {version} (speak {VERSION})")
    # a column costs at least 3 bytes: a forged count cannot make the
    # loop below walk far
    if n_cols * 3 > len(payload):
        raise WireFormatError(
            f"{n_cols} columns cannot fit a {len(payload)}-byte body")
    offset = _HEADER.size
    names: List[str] = []
    raw: Dict[str, np.ndarray] = {}
    for _ in range(n_cols):
        _need(payload, offset, 2, "column name length")
        (name_len,) = struct.unpack_from("<H", payload, offset)
        offset += 2
        _need(payload, offset, name_len, "column name")
        try:
            name = payload[offset:offset + name_len].decode("utf-8")
        except UnicodeDecodeError as e:
            raise WireFormatError(f"column name is not UTF-8: {e}") \
                from None
        offset += name_len
        if not name or name in raw:
            raise WireFormatError(
                f"empty or duplicate column name {name!r}")
        _need(payload, offset, 1, f"column {name!r} type code")
        type_code = payload[offset]
        offset += 1
        dtype = _DTYPES.get(type_code)
        if dtype is not None:
            size = n_rows * dtype.itemsize
            _need(payload, offset, size, f"column {name!r} values")
            raw[name] = np.frombuffer(payload, dtype=dtype,
                                      count=n_rows, offset=offset)
            offset += size
        elif type_code == TYPE_STR:
            raw[name], offset = _decode_strings(payload, offset,
                                                n_rows, name)
        else:
            raise WireFormatError(
                f"column {name!r} has unknown type code {type_code}")
        names.append(name)
    if offset != len(payload):
        raise WireFormatError(
            f"{len(payload) - offset} trailing bytes after the last "
            "column")
    return ColumnarData(names=names, raw=raw, n_rows=int(n_rows),
                        wire_format="binary")

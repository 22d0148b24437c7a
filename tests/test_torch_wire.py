"""The port's columnar binary wire format (`shifu_tpu_torch/serve/wire.py`)
against the JAX package's (`shifu_tpu/serve/wire.py`).

* `encode` / `encode_records` write the JAX encoder's bytes for typed,
  int, string, non-ASCII and missing columns; `decode` of the JAX
  payloads gives the same arrays and dtypes; f32 and i32 decode.
* The JSON path's typing rule (`column_from_values`) and its canonical
  strings are the binary path's; `conform_columns` makes absent columns
  the "" missing token.
* Every malformed payload of tests/test_wire.py (each proper prefix,
  magic, version, forged row and column counts, trailing bytes, type
  code, offsets, names) raises the port's `WireFormatError` exactly
  where the JAX decoder raises its own.
"""

import struct

import numpy as np
import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

from shifu_tpu.data import reader as jreader  # noqa: E402
from shifu_tpu.serve import registry as jregistry  # noqa: E402
from shifu_tpu.serve import wire as jwire  # noqa: E402
from shifu_tpu_torch.data import reader as preader  # noqa: E402
from shifu_tpu_torch.serve import registry as pregistry  # noqa: E402
from shifu_tpu_torch.serve import wire as pwire  # noqa: E402

RECORDS = [
    {"f": 1.5, "i": 3, "s": "café", "m": None, "n": None, "b": True},
    {"f": None, "i": -7, "s": "x", "m": 2.0, "n": "∅ rouge", "b": False},
    {"f": -0.25, "i": 2 ** 40, "s": "", "m": "tok", "n": "", "b": True},
    {"f": 1e300, "i": 0, "s": "日本", "m": 3, "c": "only here",
     "b": False},
]


def _assert_same_columns(a, b):
    assert a.names == b.names and a.n_rows == b.n_rows
    for c in a.names:
        x, y = a.raw[c], b.raw[c]
        assert x.dtype == y.dtype, c
        if x.dtype == object:
            assert list(x) == list(y), c
        else:
            np.testing.assert_array_equal(x, y, err_msg=c)


@pytest.mark.parametrize("columns", [None, ["s", "i", "f", "zz", "m"]])
def test_encode_records_bytes_equal_jax(columns):
    got = pwire.encode_records(RECORDS, columns)
    assert got == jwire.encode_records(RECORDS, columns)


def test_encode_typed_bytes_equal_jax():
    cols = {"a": np.asarray([1.5, np.nan, -2.0], np.float64),
            "b": np.asarray([1, -2, 3], np.int64),
            "c": np.asarray([0.5, 1.5, np.inf], np.float32),
            "d": np.asarray([7, 8, 9], np.int32),
            "e": np.asarray(["x", None, "é"], dtype=object)}
    jdata = jreader.ColumnarData(names=list(cols), raw=dict(cols), n_rows=3)
    pdata = preader.ColumnarData(names=list(cols), raw=dict(cols), n_rows=3)
    assert pwire.encode(pdata) == jwire.encode(jdata)


def test_decode_of_jax_payloads():
    payload = jwire.encode_records(RECORDS)
    got = pwire.decode(payload)
    want = jwire.decode(payload)
    assert got.wire_format == want.wire_format == "binary"
    _assert_same_columns(got, want)
    f = got.typed_column("f")
    assert f.dtype == np.float64 and np.isnan(f[1])
    assert got.typed_column("i").dtype == np.int64
    assert got.typed_column("m") is None  # mixed: strings, None -> ""
    assert list(got.column("m")) == ["", "2.0", "tok", "3"]
    assert list(got.column("s")) == ["café", "x", "", "日本"]
    assert list(got.column("b")) == ["True", "False", "True", "False"]
    for c in got.names:  # the canonical strings are the JAX ones
        assert list(got.column(c)) == list(want.column(c)), c


def test_f32_i32_accepted_on_decode():
    cols = {"a": np.asarray([1.5, 2.5], np.float32),
            "b": np.asarray([3, 4], np.int32)}
    payload = pwire.encode(preader.ColumnarData(names=["a", "b"],
                                                raw=cols, n_rows=2))
    out = pwire.decode(payload)
    assert out.typed_column("a").dtype == np.float32
    assert out.typed_column("b").dtype == np.int32
    np.testing.assert_array_equal(out.numeric("a"), [1.5, 2.5])
    _assert_same_columns(out, jwire.decode(payload))


def test_column_typing_rule_equal_jax():
    for values in ([True, False], [1, 2.0], [10 ** 30, 1], [1, 2],
                   [1.0, None], [None, None], ["a", None], [], [2 ** 63]):
        got = pwire.column_from_values(values)
        want = jwire.column_from_values(values)
        assert got.dtype == want.dtype, values
        if got.dtype == object:
            assert list(got) == list(want)
        else:
            np.testing.assert_array_equal(got, want)


def test_json_path_matches_wire_path():
    records = [{"a": 1.5, "b": 3, "c": "zé"},
               {"a": None, "b": -2, "c": None}]
    cols = ["a", "b", "c"]
    via_wire = pwire.decode(pwire.encode_records(records, cols))
    via_json = pregistry.records_to_columnar(records, cols)
    jjson = jregistry.records_to_columnar(records, cols)
    for c in cols:
        assert list(via_wire.column(c)) == list(via_json.column(c))
        assert list(via_json.column(c)) == list(jjson.column(c))
        np.testing.assert_array_equal(via_wire.numeric(c),
                                      via_json.numeric(c))
        np.testing.assert_array_equal(via_json.numeric(c), jjson.numeric(c))
        np.testing.assert_array_equal(via_wire.missing_mask(c),
                                      via_json.missing_mask(c))


def test_conform_synthesizes_absent_columns():
    data = pwire.decode(pwire.encode_records([{"a": 1.0}, {"a": 2.0}]))
    out = pwire.conform_columns(data, ["a", "zzz"])
    assert out.names == ["a", "zzz"]
    assert out.wire_format == "binary"
    assert list(out.column("zzz")) == ["", ""]
    assert out.typed_column("a") is not None
    jout = jwire.conform_columns(jwire.decode(pwire.encode_records(
        [{"a": 1.0}, {"a": 2.0}])), ["a", "zzz"])
    _assert_same_columns(out, jout)


# ---- malformed payloads: the port raises where the JAX decoder raises


def _payload():
    return jwire.encode_records([{"num": 1.5, "cat": "rouge"},
                                 {"num": None, "cat": "vért"}])


def _outcome(decode, payload):
    """'ok' or the decoder's error text."""
    try:
        decode(payload)
    except (jwire.WireFormatError, pwire.WireFormatError) as e:
        return f"error: {e}"
    return "ok"


def _malformed():
    payload = _payload()
    head = struct.pack("<4sHII", jwire.MAGIC, jwire.VERSION, 2, 1)
    col = (struct.pack("<H", 1) + b"c" + struct.pack("<B", jwire.TYPE_STR)
           + np.asarray([0, 5, 3], np.uint32).tobytes() + b"abc")
    head1 = struct.pack("<4sHII", jwire.MAGIC, jwire.VERSION, 1, 2)
    one = (struct.pack("<H", 1) + b"a" + struct.pack("<B", jwire.TYPE_I32)
           + np.asarray([7], np.int32).tobytes())
    empty = (struct.pack("<H", 0) + struct.pack("<B", jwire.TYPE_I32)
             + np.asarray([7], np.int32).tobytes())
    off = 14 + 2 + 3  # the first column's type code
    cases = {
        "magic": b"NOPE" + payload[4:],
        "version": payload[:4] + struct.pack("<H", 99) + payload[6:],
        "rows": payload[:6] + struct.pack("<I", 10 ** 6) + payload[10:],
        "cols": payload[:10] + struct.pack("<I", 2 ** 31) + payload[14:],
        "trailing": payload + b"\x00",
        "type": payload[:off] + b"\xee" + payload[off + 1:],
        "offsets": head + col,
        "duplicate": head1 + one + one,
        "empty_name": head1 + empty + one,
        "bad_utf8": (struct.pack("<4sHII", jwire.MAGIC, jwire.VERSION, 1, 1)
                     + struct.pack("<H", 1) + b"s"
                     + struct.pack("<B", jwire.TYPE_STR)
                     + np.asarray([0, 2], np.uint32).tobytes() + b"\xff\xfe"),
        "empty_body": b"",
    }
    cases.update({f"prefix_{cut}": payload[:cut]
                  for cut in range(len(payload))})
    return cases


@pytest.mark.parametrize("case", ["magic", "version", "rows", "cols",
                                  "trailing", "type", "offsets",
                                  "duplicate", "empty_name", "bad_utf8",
                                  "empty_body", "truncations"])
def test_malformed_raises_where_jax_raises(case):
    cases = _malformed()
    names = ([k for k in cases if k.startswith("prefix_")]
             if case == "truncations" else [case])
    for name in names:
        got = _outcome(pwire.decode, cases[name])
        want = _outcome(jwire.decode, cases[name])
        assert want.startswith("error"), name
        assert got == want, name


def test_port_error_is_a_value_error():
    with pytest.raises(ValueError):
        pwire.decode(b"SHWB")
    assert issubclass(pwire.WireFormatError, ValueError)
    assert pwire.CONTENT_TYPE == jwire.CONTENT_TYPE
    assert pwire.max_body_bytes() == jwire.max_body_bytes()

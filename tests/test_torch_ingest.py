"""The port's ingest (`shifu_tpu_torch/data/`) vs the JAX package's and
pandas, on the CPU.

The reader is held against the JAX `read_columnar` and
`iter_columnar_chunks` on a corpus of part files (quotes, short and long
rows, blank and whitespace lines, \\r\\n, a BOM, a stray header, gzip,
marker files); the numeric grammar and the strip against pandas on a token
list and on hypothesis strings; missing masks, filters, tags and weights
against the JAX functions on the corpus. All exact.
"""

import gzip
import os

import numpy as np
import pytest

pd = pytest.importorskip("pandas")
pytest.importorskip("torch")
pytest.importorskip("jax")
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from shifu_tpu.data import purify as jpurify  # noqa: E402
from shifu_tpu.data import reader as jreader  # noqa: E402
from shifu_tpu.data import stream as jstream  # noqa: E402
from shifu_tpu_torch.data import purify as ppurify  # noqa: E402
from shifu_tpu_torch.data import reader as preader  # noqa: E402
from shifu_tpu_torch.data import stream as pstream  # noqa: E402
from shifu_tpu_torch.data import tokens  # noqa: E402
from shifu_tpu_torch.utils.errors import ShifuError  # noqa: E402

NAMES = ["id", "tgt", "num", "cat", "w"]
PART0 = [
    "﻿1|M|1.5|red|2",
    '2|B|" 2.5 "|"blue|green"|1.5',
    '3|M|3|"say ""hi"""|x',
    "",
    "   ",
    "\t \t",
    "4|B",
    "5|M|5|x|1|extra",
    "id|tgt|num|cat|w",
    "id|B|6|y|3",
    '7|M|ab"c|d"e|-1',
    "8|B|1e3|\t|",
    "9|M||?|0",
    '10|"B"|inf|null|in\x00f',
    "11|M|1_000|é|",
    "12|X| 7 |  red |1e400",
]
PART1 = [
    "13|B|0x10|red|2",
    "14|M|-0|blue|1",
    '15|B|"multi\nline"|green|1',
    "16|M|１２３|red|1",
    "",
    "17|B|0.30000000000000004|~|1",
    "18|M| 1.5e-3 |*|2",
    "19|B|nan|#|2",
    "20|M|12345678901234567890|violet|1",
]


def _write(path, lines, newline, gz=False):
    text = newline.join(lines) + newline
    if gz:
        with gzip.open(path, "wt", encoding="utf-8", newline="") as fh:
            fh.write(text)
    else:
        with open(path, "w", encoding="utf-8", newline="") as fh:
            fh.write(text)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    _write(d / "part-00000", PART0, "\n")
    _write(d / "part-00001.gz", PART1, "\r\n", gz=True)
    (d / "_SUCCESS").write_text("")
    (d / ".part-00000.crc").write_text("junk|junk\n")
    return str(d)


def _same_columns(j, p, names):
    assert j.n_rows == p.n_rows
    assert list(p.names) == list(names)
    for name in names:
        a = np.asarray(j.column(name), dtype=object)
        b = p.column(name)
        assert b.dtype == object and a.tolist() == b.tolist(), name


@pytest.mark.parametrize("max_rows", [None, 1, 5, 12, 100])
def test_read_columnar_matches_jax(corpus, max_rows):
    j = jreader.read_columnar(corpus, NAMES, max_rows=max_rows)
    p = preader.read_columnar(corpus, NAMES, max_rows=max_rows)
    _same_columns(j, p, NAMES)
    if max_rows is None:
        assert p.n_rows == 19  # blank lines, a long row and a header out


@pytest.mark.parametrize("chunk_rows,max_rows,columns", [
    (4, None, None),
    (3, 7, ["num", "cat"]),
    (5, None, ["tgt", "cat", "w"]),
    (100, 9, ["id"]),
])
def test_chunks_match_jax(corpus, chunk_rows, max_rows, columns):
    kw = dict(chunk_rows=chunk_rows, max_rows=max_rows, columns=columns)
    js = list(jstream.iter_columnar_chunks(corpus, NAMES, **kw))
    ps = list(pstream.iter_columnar_chunks(corpus, NAMES, **kw))
    out = [n for n in NAMES if columns is None or n in columns]
    assert [c.n_rows for c in ps] and all(
        c.n_rows <= chunk_rows for c in ps)
    for name in out:
        a = np.concatenate([np.asarray(c.column(name), dtype=object)
                            for c in js])
        b = np.concatenate([c.column(name) for c in ps])
        assert a.tolist() == b.tolist(), name


def test_first_row_wider_takes_the_leading_fields_as_index(tmp_path):
    """pandas makes a first row wider than the names an implicit index;
    the chunked reader with a column subset refuses it, as pandas does."""
    f = tmp_path / "d.txt"
    _write(f, ["a|1|2|3", "b|4|5", "c|6", "d|7|8|9|10", "e|9|9|9"], "\n")
    names = ["x", "y", "z"]
    j = jreader.read_columnar(str(f), names)
    p = preader.read_columnar(str(f), names)
    _same_columns(j, p, names)
    with pytest.raises(ShifuError):
        list(pstream.iter_columnar_chunks(str(f), names, columns=["y"]))


def test_header_and_paths(tmp_path, corpus):
    h = tmp_path / "header.txt"
    h.write_text("ns::a|b|a| c \n")
    assert preader.read_header(str(h)) == jreader.read_header(str(h))
    assert [os.path.basename(p) for p in pstream.expand_paths(corpus)] == [
        os.path.basename(p) for p in jreader._expand_paths(corpus)]
    assert pstream.dataset_size_bytes(corpus) == jstream.dataset_size_bytes(
        corpus)
    # remote sources and parquet are ported (A.13.2; tests in
    # test_torch_source.py): a protocol without a connector names itself,
    # as in the JAX package, and a broken parquet file raises in both
    with pytest.raises(ShifuError, match="'nosuchproto://'"):
        preader.read_columnar("nosuchproto://nn/data", NAMES)
    from shifu_tpu.utils.errors import ShifuError as JShifuError

    with pytest.raises(JShifuError, match="'nosuchproto://'"):
        jreader.read_columnar("nosuchproto://nn/data", NAMES)
    (tmp_path / "t.parquet").write_bytes(b"PAR1")
    with pytest.raises(Exception, match="[Pp]arquet"):
        list(pstream.iter_columnar_chunks(str(tmp_path / "t.parquet"), NAMES))
    with pytest.raises(Exception, match="[Pp]arquet"):
        list(jstream.iter_columnar_chunks(str(tmp_path / "t.parquet"), NAMES))


# ---- the column-wise split of plain blocks ---------------------------------

PLAIN = ["﻿1|M|1.5|red|2", "", "  ", "2|B| 2.5 |blue|", "3|M|x\x00y|é|1",
         "id|tgt|num|cat|w", "\t", "4|B|-0|c|7"]


@pytest.mark.parametrize("block", [16, 64, 1 << 25])
@pytest.mark.parametrize("tail", [
    [], ["5|M|5|x"], ["6|B|6|y|1|extra", "7|M|7|z|1"], ['8|"B"|8|q|1'],
    ["9|M|9|r|1"] * 3 + ["10|B|10"]],
    ids=["plain", "short_row", "long_row", "quote", "late_short_row"])
def test_plain_blocks_match_jax(tmp_path, monkeypatch, block, tail):
    """Blocks of plain lines are split column-wise (at any block size,
    through `readline` to a line's end); from the first block that is
    not plain the csv reader takes over, mid-file too."""
    monkeypatch.setattr(preader, "_BLOCK_BYTES", block)
    f = tmp_path / "d.txt"
    body = "\n".join(PLAIN + ["%d|M|%d.25|k%d|1" % (i, i, i % 3)
                              for i in range(30)] + tail)
    f.write_text(body, encoding="utf-8")  # no final newline
    _same_columns(jreader.read_columnar(str(f), NAMES),
                  preader.read_columnar(str(f), NAMES), NAMES)
    kw = dict(chunk_rows=7, max_rows=33, columns=["num", "cat"])
    try:
        js = list(jstream.iter_columnar_chunks(str(f), NAMES, **kw))
    except pd.errors.ParserError:
        # pandas refuses a chunk whose rows are all short under usecols;
        # the port reads it (its rows padded, as in any other chunk)
        assert tail == ["5|M|5|x"]
        js = list(jstream.iter_columnar_chunks(str(f), NAMES,
                                               **dict(kw, chunk_rows=8)))
    ps = list(pstream.iter_columnar_chunks(str(f), NAMES, **kw))
    for name in kw["columns"]:
        assert np.concatenate([np.asarray(c.column(name), dtype=object)
                               for c in js]).tolist() == np.concatenate(
            [c.column(name) for c in ps]).tolist()


@settings(max_examples=150, deadline=None, derandomize=True)
@given(st.lists(st.text(alphabet="ab1 |\t\".\x00", max_size=9),
                min_size=1, max_size=12),
       st.sampled_from([8, 1 << 25]))
def test_reader_matches_jax_on_random_lines(tmp_path_factory, lines, block):
    """Random lines of fields, blanks, quotes and NULs (a lone carriage
    return is not modelled: `\\r\\n` line ends are, in the corpus)."""
    f = tmp_path_factory.mktemp("rand") / "d.txt"
    f.write_text("\n".join(lines) + "\n", encoding="utf-8")
    try:
        want = jreader.read_columnar(str(f), ["a", "b", "c"])
    except Exception:  # pandas refuses it (an open quote at the end)
        return
    old = preader._BLOCK_BYTES
    preader._BLOCK_BYTES = block
    try:
        got = preader.read_columnar(str(f), ["a", "b", "c"])
    finally:
        preader._BLOCK_BYTES = old
    _same_columns(want, got, ["a", "b", "c"])


# ---- the numeric grammar and the strip ------------------------------------

TOKENS = [
    "1", " 1", "1 ", " 1 ", "1.5", " 1.5 ", "\t1.0\t", "1\n", "0x10", "1e5",
    "1E5", "1e", "e5", ".5", "5.", ".", "-", "+", "-1", "+1", "--1", "inf",
    "-inf", "+inf", "Infinity", "-INFINITY", "iNf", "inf ", " inf", "nan",
    "NaN", "-nan", "1_234", "１２３", "٣", "\xa01", "1,5", "1d5", "",
    "  ", "00012", "1.2.3", "12abc", "9999999999999999999", "1e400",
    "-1e400", "0e400", "-0e400", "1e-400", "5e-324", "2e-324", "1e-617",
    "0.30000000000000004", "1.7976931348623159e308",
    "123456789012345678901234567890", "0000000000000000012345",
    "1e +5", "1e- 5", "1e\t5", "1e+-5", "1e99999999999", "-0", "-0.0",
    "1\x00", "1.0\x00", "inf\x00", "1e\x005", "True", "None", "null",
    "1 2", "0b1", "1j", "+.5e1", "-.e5", "1e00000000000000000001",
    " " * 70 + "12.5", "1" * 80, "inf\x001_000", "81946.3\x00NaN",
    "-2.8855e+19\x000339_7n6E6", "c3_12", "?",
]
INTS = ["1", " 2 ", "-0", "+7", "00012", "9999999999999999999", "-3",
        "18446744073709551615", "-9223372036854775808", "12345678901234567"]


def _pandas_numeric(values):
    return pd.to_numeric(pd.Series(np.array(values, dtype=object)),
                         errors="coerce").to_numpy(np.float64)


def _same_floats(a, b):
    return bool(np.all(((a == b) | (np.isnan(a) & np.isnan(b)))
                       & (np.signbit(a) == np.signbit(b))))


@pytest.mark.parametrize("values", [
    TOKENS, INTS, INTS[:4] + INTS[5:6], INTS + ["1.5"],
    ["18446744073709551616", "1"], ["-1", "18446744073709551615"],
    ["-1", "-0", "9223372036854775807"], []],
    ids=["tokens", "ints_int64_and_uint64", "ints", "ints_and_float",
         "int_past_uint64", "uint64_conflict", "int64", "empty"])
def test_to_numeric_equals_pandas(values):
    assert _same_floats(tokens.to_numeric(values), _pandas_numeric(values))


def test_vectorized_parse_equals_scalar():
    vals, ok, _mi = tokens._floatify_block(
        np.array(TOKENS[:-2], dtype=object), max(map(len, TOKENS[:-2])))
    scalar = np.array([tokens._floatify_scalar(s)[0] for s in TOKENS[:-2]])
    assert _same_floats(vals, scalar)
    assert ok.tolist() == [tokens._floatify_scalar(s)[1]
                           for s in TOKENS[:-2]]


_ALPHABET = list("0123456789") * 3 + list(".eE+-") * 2 + [
    " ", "\t", "\n", "\x00", "_", "\xa0", "１", "i", "n", "f", "I", "N", "a",
    "y", "t"]


@settings(max_examples=300, deadline=None, derandomize=True)
@given(st.lists(st.text(alphabet=_ALPHABET, max_size=14), min_size=1,
                max_size=12))
def test_to_numeric_equals_pandas_on_random_strings(values):
    assert _same_floats(tokens.to_numeric(values), _pandas_numeric(values))


@settings(max_examples=200, deadline=None, derandomize=True)
@given(st.lists(st.floats(allow_nan=False) | st.integers(-10**20, 10**20),
                min_size=1, max_size=10),
       st.sampled_from(["%r", "%.5f", "%.17g", "%.3e", "%.25f", "%s"]))
def test_to_numeric_equals_pandas_on_printed_numbers(nums, fmt):
    values = [fmt % v if not isinstance(v, int) or fmt in ("%r", "%s")
              else str(v) for v in nums]
    assert _same_floats(tokens.to_numeric(values), _pandas_numeric(values))


def test_strip_equals_pandas_over_whitespace():
    """Every code point str.isspace() accepts, plus look-alikes that are
    not whitespace, around a token, through object and arrow Series."""
    cps = [c for c in range(0x3100) if chr(c).isspace()]
    cps += [0x200B, 0xFEFF, 0x180E, 0x1C, 0x1D, 0x1E, 0x1F, 0x85, 0xA0]
    values = [chr(c) + "x " + chr(c) for c in cps] + [chr(c) for c in cps]
    mine = tokens.strip_tokens(values).tolist()
    for dtype in (object, "string[pyarrow]", "str"):
        ref = pd.Series(values, dtype=dtype).str.strip().tolist()
        assert mine == ref, dtype


# ---- column semantics on the corpus ---------------------------------------

@pytest.fixture(scope="module")
def both(corpus):
    return (jreader.read_columnar(corpus, NAMES),
            preader.read_columnar(corpus, NAMES))


@pytest.mark.parametrize("name", NAMES)
def test_numeric_and_missing_mask_match_jax(both, name):
    j, p = both
    assert _same_floats(p.numeric(name), j.numeric(name))
    np.testing.assert_array_equal(p.missing_mask(name), j.missing_mask(name))


@pytest.mark.parametrize("expr", [
    "num > 2", "cat == 'red'", "num >= 1 and tgt != 'X'",
    "cat in ['red', 'blue'] or w > 1", "not (num < 5); id != '3'",
    "num * 2 > 5 && cat ne 'x'",
])
def test_filters_match_jax(both, expr):
    j, p = both
    np.testing.assert_array_equal(
        ppurify.combined_mask(expr, p.raw, p.n_rows),
        jpurify.combined_mask(expr, j.raw, j.n_rows))


def test_tags_and_weights_match_jax(both):
    j, p = both
    tgt_j, tgt_p = j.column("tgt"), p.column("tgt")
    for pos, neg in ((["M"], ["B"]), (["M"], []), (["M", "B"], [])):
        np.testing.assert_array_equal(preader.make_tags(tgt_p, pos, neg),
                                      jreader.make_tags(tgt_j, pos, neg))
    np.testing.assert_array_equal(
        preader.make_class_tags(tgt_p, ["B", "M", "X"]),
        jreader.make_class_tags(tgt_j, ["B", "M", "X"]))
    np.testing.assert_array_equal(preader.make_weights(p, "w"),
                                  jreader.make_weights(j, "w"))
    np.testing.assert_array_equal(preader.make_weights(p, None),
                                  jreader.make_weights(j, None))


def test_select_and_sample_rows_match_jax(both):
    j, p = both
    mask = np.arange(p.n_rows) % 3 == 0
    _same_columns(j.select_rows(mask), p.select_rows(mask), NAMES)
    _same_columns(j.sample_rows(0.5, seed=3), p.sample_rows(0.5, seed=3),
                  NAMES)


# ---- flat_numeric_matrix: the documented semantics (ROADMAP C.1) ----------

def _data(cols, missing=("", "?")):
    n = len(next(iter(cols.values())))
    return preader.ColumnarData(
        names=list(cols),
        raw={k: np.asarray(v, dtype=object) for k, v in cols.items()},
        n_rows=n, missing_values=set(missing))


def test_flat_numeric_grammar_extras_are_nan():
    for tok in ("1_234", "１２３"):
        got = preader.flat_numeric_matrix(_data({"a": [tok, "2.0"]}), ["a"])
        assert np.isnan(got[0, 0]) and got[1, 0] == 2.0
        assert got.flags.writeable


def test_flat_numeric_missing_token_still_masks():
    got = preader.flat_numeric_matrix(
        _data({"a": ["999", "1.0"]}, missing=("", "999")), ["a"])
    assert np.isnan(got[0, 0]) and got[1, 0] == 1.0


def test_flat_numeric_inf_is_nan_and_columns_line_up():
    got = preader.flat_numeric_matrix(
        _data({"a": ["1.5", "  2e3 ", "+4", ".5"],
               "b": ["-1", "inf", "3", "?"]}), ["a", "b"])
    np.testing.assert_array_equal(got[:, 0], [1.5, 2000.0, 4.0, 0.5])
    assert got[0, 1] == -1.0 and got[2, 1] == 3.0
    assert np.isnan(got[1, 1]) and np.isnan(got[3, 1])


# ---- typed columns (the serving wire formats) ------------------------------

TYPED = {
    "f64": np.asarray([1.5, np.nan, -0.0, 1e300, np.inf, 999.0,
                       0.30000000000000004, 3.0, 12.0], np.float64),
    "i64": np.asarray([3, -7, 0, 2 ** 40, 999, 1, -1, 12, 3], np.int64),
    "f32": np.asarray([1.5, np.nan, 2.25, -1.0, 999.0, 0.1, 7.0, 3.0,
                       1e30], np.float32),
    "i32": np.asarray([7, 8, 9, -1, 999, 0, 3, 3, 12], np.int32),
}
MISSING_SETS = {"default": preader.DEFAULT_MISSING,
                "numeric_token": ("", "?", "999")}


def _bin_configs(pkg):
    """A numeric, a categorical and a hybrid ColumnConfig of `pkg`."""
    config = pytest.importorskip(f"{pkg}.config.column_config")
    out = []
    for kind, bounds, cats in (("N", [float("-inf"), 0.0, 2.0, 10.0], None),
                               ("C", None, ["3", "12", "1.5", "-7"]),
                               ("H", [float("-inf"), 1.0], ["3", "999"])):
        cc = config.ColumnConfig(column_name="x")
        cc.column_type = config.ColumnType[kind]
        cc.column_binning.bin_boundary = bounds
        cc.column_binning.bin_category = cats
        out.append(cc)
    return out


@pytest.mark.parametrize("missing", list(MISSING_SETS))
@pytest.mark.parametrize("dtype", list(TYPED))
def test_typed_columns_match_jax(dtype, missing):
    """A typed column reads as its canonical strings in every consumer,
    and numeric / missing_mask take the JAX typed shortcuts while no
    missing token parses as a number (else the string path)."""
    from shifu_tpu.norm import normalizer as jnorm
    from shifu_tpu_torch.norm import normalizer as pnorm

    arr = TYPED[dtype]
    miss = MISSING_SETS[missing]
    j = jreader.ColumnarData(names=["x"], raw={"x": arr}, n_rows=len(arr),
                             missing_values=miss)
    p = preader.ColumnarData(names=["x"], raw={"x": arr}, n_rows=len(arr),
                             missing_values=miss)
    assert p.typed_column("x") is arr
    assert p._typed_fast_ok() == j._typed_fast_ok() == (missing == "default")
    assert list(p.column("x")) == list(j.column("x"))
    assert list(p.stripped("x")) == [s.strip() for s in j.column("x")]
    assert _same_floats(p.numeric("x"), j.numeric("x"))
    np.testing.assert_array_equal(p.missing_mask("x"), j.missing_mask("x"))
    # the JAX flat_numeric_matrix's own string path faults on the
    # numeric-token set (ROADMAP C.1): its documented semantics are
    # numeric()'s
    assert _same_floats(preader.flat_numeric_matrix(p, ["x"])[:, 0],
                        j.numeric("x"))
    for pcc, jcc in zip(_bin_configs("shifu_tpu_torch"),
                        _bin_configs("shifu_tpu")):
        np.testing.assert_array_equal(pnorm._bin_codes_for(pcc, p),
                                      jnorm._bin_codes_for(jcc, j))
    mask = np.arange(len(arr)) % 2 == 0
    assert list(p.select_rows(mask).column("x")) == \
        list(j.select_rows(mask).column("x"))


def test_typed_and_string_columns_flatten_together():
    """flat_numeric_matrix over typed and string columns at once keeps
    each column in its place; the string ones take the port's grammar."""
    raw = {"t": np.asarray([1.5, np.nan, 4.0]),
           "s": np.asarray(["0.1234567890123456789", "?", " 2 "], object),
           "i": np.asarray([1, 2, 3], np.int64)}
    p = preader.ColumnarData(names=list(raw), raw=raw, n_rows=3)
    got = preader.flat_numeric_matrix(p, ["s", "t", "i"])
    assert got[0, 0] == 0.1234567890123456  # not float()'s ...568
    assert np.isnan(got[1, 0]) and got[2, 0] == 2.0
    assert _same_floats(got[:, 1], raw["t"])
    np.testing.assert_array_equal(got[:, 2], [1.0, 2.0, 3.0])

"""Columnar dataset reader (counterpart of `shifu_tpu/data/reader.py`),
without pandas.

Data is read column-wise into numpy object arrays of strings once; every
stage then works on whole columns. A data path may be a delimited file, a
gzip file, or a directory of part files (part-*, ignoring dot-files).

The JAX package parses with `pd.read_csv(sep=delimiter, header=None,
names=names, dtype=str, keep_default_na=False, engine="c",
skip_blank_lines=True, on_bad_lines="skip")`. This reader gives the same
rows and fields with the stdlib `csv` module:
  * `"` quotes with doubled `""` inside; a quote inside an unquoted field
    is literal; `\\n`, `\\r\\n` and `\\r` end a row; a UTF-8 BOM is dropped;
  * blank lines and lines of only spaces and tabs are skipped;
  * a row with fewer fields than names is padded with "" (not NaN, under
    keep_default_na=False); a row with more is dropped, but where pandas
    does not look (`iter_row_batches`) cut to the names instead;
  * blocks without quotes or carriage returns whose lines all have the
    names' count of fields are split column-wise on the bytes
    (`iter_column_batches`); the rest goes through the csv reader;
  * when a file's first row has more fields than names, pandas takes the
    leading extra fields as the index: that row's width is then the
    file's, and each row keeps its last len(names) fields;
  * a field ends at its first NUL (pandas keeps a C string);
  * `max_rows` counts kept rows, across part files.
Numbers and trimming follow `data/tokens.py`.
"""

from __future__ import annotations

import csv
import gc
import gzip
import io
import os
import sys
from contextlib import contextmanager
from dataclasses import dataclass, field
from itertools import islice
from operator import itemgetter
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from shifu_tpu_torch.config.model_config import DEFAULT_MISSING_VALUES
from shifu_tpu_torch.data.tokens import (in_tokens, numeric_mask,
                                         parse_numeric, strip_tokens)
from shifu_tpu_torch.fs.listing import check_local, expand_paths
from shifu_tpu_torch.utils.errors import ErrorCode, ShifuError

# Default tokens treated as missing (ModelSourceDataConf.missingOrInvalidValues).
DEFAULT_MISSING = tuple(DEFAULT_MISSING_VALUES)


def strip_namespace(name: str) -> str:
    """Reference supports namespaced columns "ns::col" (column/NSColumn.java);
    simple names compare on the last segment."""
    return name.rsplit("::", 1)[-1].strip()


def read_header(header_path: str, delimiter: str = "|") -> List[str]:
    check_local(header_path)
    if not os.path.isfile(header_path):
        raise ShifuError(ErrorCode.HEADER_NOT_FOUND, header_path)
    opener = gzip.open if header_path.endswith(".gz") else open
    with opener(header_path, "rt") as fh:
        line = fh.readline().rstrip("\n\r")
    names = [strip_namespace(c) for c in line.split(delimiter)]
    return _dedupe_names(names)


def _dedupe_names(names: List[str]) -> List[str]:
    if len(names) == len(set(names)):
        return names
    # de-duplicate with positional suffixes, as the reference warns+renames
    seen: Dict[str, int] = {}
    out = []
    for n in names:
        if n in seen:
            seen[n] += 1
            out.append(f"{n}_{seen[n]}")
        else:
            seen[n] = 0
            out.append(n)
    return out


def _open_bytes(path: str):
    return gzip.open(path, "rb") if path.endswith(".gz") else open(path, "rb")


_BATCH_ROWS = 1 << 16


class _QuoteLog:
    """The lines of a text file, noting whether one since the last look
    held a quote: a record of one blank field is a blank line to skip
    only when no quote made it (pandas keeps `""` and `" "`)."""

    def __init__(self, fh):
        self.fh = fh
        self.quoted = False

    def __iter__(self):
        return self

    def __next__(self) -> str:
        line = next(self.fh)
        if '"' in line:
            self.quoted = True
        return line


def iter_record_batches(path: str, delimiter: str = "|", start: int = 0
                        ) -> Iterator[List[List[str]]]:
    """The rows of one file from byte `start` on (a line's start, past any
    BOM) as lists of fields, blank lines skipped, in batches of up to
    `_BATCH_ROWS` rows."""
    csv.field_size_limit(sys.maxsize)
    with _open_bytes(path) as raw:
        raw.seek(start)
        lines = _QuoteLog(io.TextIOWrapper(raw, encoding="utf-8",
                                           newline=""))
        reader = csv.reader(lines, delimiter=delimiter, quotechar='"',
                            doublequote=True, strict=False)
        while True:
            batch, n = [], 0
            with gc_paused():
                for rec in islice(reader, _BATCH_ROWS):
                    n += 1
                    quoted, lines.quoted = lines.quoted, False
                    if rec and (len(rec) > 1 or quoted
                                or rec[0].strip(" \t")):
                        batch.append(rec)
            if not n:
                return
            yield batch


@contextmanager
def gc_paused():
    """No cyclic garbage collection while millions of small lists are
    made (the rows): none of them is cyclic, and each collection would
    walk them all."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


def buffer_lines(n_names: int) -> int:
    """Rows of one internal read of pandas' C reader (`low_memory`): the
    largest power of two under 2^20 / columns."""
    heuristic = 2**20 // max(n_names, 1)
    lines = 1
    while lines * 2 < heuristic:
        lines *= 2
    return lines


def iter_row_batches(path: str, n_names: int, delimiter: str = "|",
                     keep: Optional[Sequence[int]] = None,
                     chunk_rows: Optional[int] = None, start: int = 0,
                     width: Optional[int] = None, accepted: int = 0
                     ) -> Iterator[List[Sequence[str]]]:
    """Batches of the rows of pandas' frame, from byte `start` on (after
    `accepted` rows of a file `width` fields wide, when it is known):
      * the file's width is the names' count, or its first row's when
        that row is wider: pandas then takes the leading extra fields as
        the index, and each row keeps its last len(names) fields;
      * a shorter row is padded with "";
      * a wider row is dropped, but kept and cut to the width where
        pandas does not check it: under `keep` (pandas `usecols`, which
        refuses a wider first row) and for the first row of each of the
        reader's internal reads (`buffer_lines` rows, within chunks of
        `chunk_rows` rows when reading in chunks).
    `keep` selects fields by position among the names."""
    per_read = buffer_lines(n_names)
    pick = None
    if keep is not None:
        pick = (itemgetter(*keep) if len(keep) > 1
                else (lambda r, k=keep[0]: (r[k],)))
    for recs in iter_record_batches(path, delimiter, start):
        if not recs:
            continue
        if width is None:
            width = max(n_names, len(recs[0]))
            if keep is not None and width > n_names:
                raise ShifuError(
                    ErrorCode.DATA_NOT_FOUND,
                    f"{path}: the first row has {width} fields for "
                    f"{n_names} names")
        lens = set(map(len, recs))
        if lens != {width}:
            rows = []
            for rec in recs:
                n = len(rec)
                if n > width:
                    at = accepted % chunk_rows if chunk_rows else accepted
                    if keep is None and at % per_read:
                        continue
                    rec = rec[:width]
                elif n < width:
                    rec.extend([""] * (width - n))
                rows.append(rec)
                accepted += 1
            recs = rows
        else:
            accepted += len(recs)
        if width > n_names:
            recs = [rec[width - n_names:] for rec in recs]
        yield recs if pick is None else list(map(pick, recs))


_BLOCK_BYTES = 1 << 25
_BOM = b"\xef\xbb\xbf"


def _split_block(block: bytes, n_names: int, sep: int,
                 keep: Sequence[int]) -> Optional[List[np.ndarray]]:
    """The kept columns of a block of whole lines, as object arrays of
    strings, when the block is plain: no quote and no carriage return,
    and every line either blank (empty, or spaces and tabs only) or of
    exactly `n_names` fields. Then the csv rules reduce to a split, done
    column-wise on the bytes, so each column's strings are made together
    (and lie together in memory). None when the block is not plain."""
    buf = np.frombuffer(block, dtype=np.uint8)
    if (buf == 34).any() or (buf == 13).any():
        return None
    ends = np.flatnonzero(buf == 10).astype(np.int32)
    begins = np.empty_like(ends)
    begins[0] = 0
    begins[1:] = ends[:-1] + 1
    seps = np.flatnonzero(buf == sep).astype(np.int32)
    n_seps = np.searchsorted(seps, ends) - np.searchsorted(seps, begins)
    blank = n_seps == 0
    for i in np.flatnonzero(blank):  # lines without a separator: rare
        blank[i] = not block[begins[i]:ends[i]].strip(b" \t")
    if (n_seps[~blank] != n_names - 1).any():
        return None
    lines = np.flatnonzero(~blank)
    # field j of a line spans [lo[:, j], hi[:, j]); hi is its terminator
    inner = seps.reshape(len(lines), n_names - 1)
    lo = np.concatenate([begins[lines][:, None], inner + 1], axis=1)
    hi = np.concatenate([inner, ends[lines][:, None]], axis=1)
    out = []
    for j in keep:
        n = hi[:, j] - lo[:, j] + 1  # the token and its terminator
        last = np.cumsum(n, dtype=np.int32) - 1
        src = np.repeat(lo[:, j] - (last - n + 1), n)
        src += np.arange(len(src), dtype=np.int32)
        text = buf[src]
        text[last] = 10
        col = np.empty(len(n), dtype=object)
        col[:] = text.tobytes().decode("utf-8").split("\n")[:-1]
        out.append(col)
    return _cut_at_nul(out) if (buf == 0).any() else out


def _cut_at_nul(cols: List[np.ndarray]) -> List[np.ndarray]:
    """pandas keeps a field up to its first NUL (a C string)."""
    for col in cols:
        col[:] = [v.split("\x00", 1)[0] for v in col]
    return cols


def _has_nul(path: str, start: int) -> bool:
    with _open_bytes(path) as fh:
        fh.seek(start)
        while True:
            block = fh.read(_BLOCK_BYTES)
            if not block:
                return False
            if b"\x00" in block:
                return True


def iter_column_batches(path: str, n_names: int, delimiter: str = "|",
                        keep: Optional[Sequence[int]] = None,
                        chunk_rows: Optional[int] = None
                        ) -> Iterator[List[np.ndarray]]:
    """The rows `iter_row_batches` gives, as batches of one object array
    of strings per kept column. Blocks of plain lines (`_split_block`) are
    split column-wise; from the first block that is not, the rest of the
    file goes through the csv reader."""
    if len(delimiter) != 1 or delimiter in "\n\r\"":
        raise ShifuError(ErrorCode.ILLEGAL_ARGUMENT,
                         f"delimiter {delimiter!r}: one character, not a "
                         "quote or a line end")
    cols = list(range(n_names)) if keep is None else list(keep)
    sep = ord(delimiter) if ord(delimiter) < 128 else -1
    accepted = 0
    with _open_bytes(path) as fh:
        at = 3 if fh.read(3) == _BOM else 0  # a UTF-8 BOM opens no field
        fh.seek(at)
        while sep >= 0:
            block = fh.read(_BLOCK_BYTES)
            if not block:
                return
            if not block.endswith(b"\n"):
                block += fh.readline()
                if not block.endswith(b"\n"):
                    block += b"\n"
            with gc_paused():
                got = _split_block(block, n_names, sep, cols)
            if got is None:
                break
            at += len(block)
            accepted += len(got[0])
            if len(got[0]):
                yield got
    nul = _has_nul(path, at)
    for rows in iter_row_batches(path, n_names, delimiter, keep, chunk_rows,
                                 start=at,
                                 width=n_names if accepted else None,
                                 accepted=accepted):
        with gc_paused():
            got = columns_of(rows, len(cols))
        yield _cut_at_nul(got) if nul else got


def columns_of(rows: List[Sequence[str]], n_cols: int) -> List[np.ndarray]:
    """Row lists -> one object array of strings per column."""
    out = []
    for col in (zip(*rows) if rows else [()] * n_cols):
        arr = np.empty(len(col), dtype=object)
        arr[:] = col
        out.append(arr)
    return out


def drop_stray_header_rows(raw: Dict[str, np.ndarray],
                           names: List[str]) -> Optional[np.ndarray]:
    """Stray header lines inside data (part files re-concatenated): only
    rows where EVERY field equals its column name are headers — a
    legitimate row whose first field happens to equal the first column's
    name must survive. Returns the keep mask, or None when every row
    stays. Shared by the whole-file and chunked readers."""
    if not names or not len(raw[names[0]]):
        return None
    header_row = raw[names[0]] == names[0]
    for c in names[1:]:
        if not header_row.any():
            break
        header_row &= raw[c] == c
    if not header_row.any():
        return None
    return ~header_row


def _strings_of_typed(arr: np.ndarray) -> np.ndarray:
    """The canonical strings of a typed numeric column: what the JSON
    path carries for the same values (`str()` of the Python scalar; NaN
    is "", JSON null's missing token), so every string consumer sees a
    typed column as its string twin."""
    out = np.empty(len(arr), dtype=object)
    if arr.dtype.kind == "f":
        out[:] = ["" if v != v else str(v) for v in arr.tolist()]
    else:
        out[:] = [str(v) for v in arr.tolist()]
    return out


def _parses_as_number(token: str) -> bool:
    """Python's `float()` accepts the stripped token (the JAX package's
    guard of its typed shortcuts)."""
    try:
        float(str(token).strip())
        return True
    except (TypeError, ValueError):
        return False


@dataclass
class ColumnarData:
    """All columns as parallel numpy arrays of raw strings (or, from the
    serving wire formats, typed f64/i64/f32/i32 arrays), plus the numeric
    views and missing masks cached per column. A typed column reads as its
    canonical strings (`column`) everywhere a string is consumed."""

    names: List[str]
    raw: Dict[str, np.ndarray]
    n_rows: int
    missing_values: Sequence[str] = DEFAULT_MISSING
    _numeric_cache: Dict[str, np.ndarray] = field(default_factory=dict, repr=False)
    _missing_cache: Dict[str, np.ndarray] = field(default_factory=dict, repr=False)
    _strip_cache: Dict[str, np.ndarray] = field(default_factory=dict, repr=False)
    # per-row results of stats stages, keyed by the stage (stats/binning.py)
    _index_cache: Dict[tuple, np.ndarray] = field(default_factory=dict, repr=False)
    _string_cache: Dict[str, np.ndarray] = field(default_factory=dict, repr=False)
    # which wire format carried the batch ("json" or "binary", serve/wire.py)
    wire_format: str = field(default="json", repr=False)

    @classmethod
    def from_columns(cls, cols: List[np.ndarray], names: List[str],
                     missing_values: Sequence[str] = DEFAULT_MISSING
                     ) -> "ColumnarData":
        """Columns of raw strings, stray header rows dropped."""
        raw = dict(zip(names, cols))
        keep = drop_stray_header_rows(raw, names)
        if keep is not None:
            raw = {k: v[keep] for k, v in raw.items()}
        n = len(raw[names[0]]) if names else 0
        return cls(names=list(names), raw=raw, n_rows=n,
                   missing_values=missing_values)

    def typed_column(self, name: str) -> Optional[np.ndarray]:
        """The column's typed numeric array (a wire batch), else None."""
        arr = self.raw.get(name)
        if isinstance(arr, np.ndarray) and arr.dtype.kind in "fiu":
            return arr
        return None

    def _typed_fast_ok(self) -> bool:
        """The typed shortcuts (`astype` for the parse, `isnan` for the
        missing mask) equal the string path only while no missing token
        itself parses as a number ("" aside: no canonical string of a
        typed value is empty)."""
        return not any(_parses_as_number(m)
                       for m in self.missing_values if m != "")

    def column(self, name: str) -> np.ndarray:
        typed = self.typed_column(name)
        if typed is None:
            return self.raw[name]
        cached = self._string_cache.get(name)
        if cached is None:
            cached = _strings_of_typed(typed)
            self._string_cache[name] = cached
        return cached

    def stripped(self, name: str) -> np.ndarray:
        """`.str.strip()` of the column, cached."""
        cached = self._strip_cache.get(name)
        if cached is None:
            cached = strip_tokens(self.column(name))
            self._strip_cache[name] = cached
        return cached

    def numeric(self, name: str) -> np.ndarray:
        """float64 view of a column; missing/invalid tokens and non-numeric
        values become NaN. A typed column needs no parse (the JAX
        package's typed path: its doubles cast, non-finite -> NaN)."""
        cached = self._numeric_cache.get(name)
        if cached is not None:
            return cached
        typed = self.typed_column(name)
        if typed is not None and self._typed_fast_ok():
            vals = typed.astype(np.float64)
            vals[~np.isfinite(vals)] = np.nan
            self._numeric_cache[name] = vals
            return vals
        vals = parse_numeric(self.column(name))
        tokens = [m for m in self.missing_values if m != ""]
        if numeric_mask(tokens).any():
            # strip before the missing-set check, exactly like missing_mask —
            # " 999 " must count as missing in BOTH views. A token that
            # does not parse needs no mask: no padding of it parses either
            vals[in_tokens(self.stripped(name), tokens)] = np.nan
        self._numeric_cache[name] = vals
        return vals

    def missing_mask(self, name: str) -> np.ndarray:
        """True where the stripped token is in the configured missing set."""
        cached = self._missing_cache.get(name)
        if cached is not None:
            return cached
        typed = self.typed_column(name)
        if typed is not None and self._typed_fast_ok():
            # NaN's canonical string is ""; every other typed value's
            # parses, so it is in no missing set the guard lets through
            if typed.dtype.kind != "f":
                cached = np.zeros(len(typed), dtype=bool)
            elif "" in self.missing_values:
                cached = np.isnan(typed)
            if cached is not None:
                self._missing_cache[name] = cached
                return cached
        cached = in_tokens(self.stripped(name), self.missing_values)
        self._missing_cache[name] = cached
        return cached

    def select_rows(self, mask: np.ndarray) -> "ColumnarData":
        """Row subset (boolean mask) or reorder (integer index array). The
        stripped tokens, missing masks and bin indices are per row and
        carry over; the numeric views do not (pandas' integer rule looks at the whole
        array, `data/tokens.py`)."""
        raw = {k: v[mask] for k, v in self.raw.items()}
        n = len(next(iter(raw.values()))) if raw else 0
        return ColumnarData(
            names=self.names,
            raw=raw,
            n_rows=n,
            missing_values=self.missing_values,
            _missing_cache={k: v[mask] for k, v in self._missing_cache.items()},
            _strip_cache={k: v[mask] for k, v in self._strip_cache.items()},
            _index_cache={k: v[mask] for k, v in self._index_cache.items()},
        )

    def sample_rows(self, rate: float, seed: int = 0) -> "ColumnarData":
        if rate >= 1.0:
            return self
        rng = np.random.default_rng(seed)
        mask = rng.random(self.n_rows) < rate
        return self.select_rows(mask)


def read_columnar(
    data_path: str,
    names: List[str],
    delimiter: str = "|",
    missing_values: Sequence[str] = DEFAULT_MISSING,
    max_rows: Optional[int] = None,
) -> ColumnarData:
    """Read a file/dir of delimited rows into string columns."""
    parts: List[List[np.ndarray]] = []
    n = 0
    for path in expand_paths(data_path):
        for batch in iter_column_batches(path, len(names), delimiter):
            parts.append(batch)
            n += len(batch[0])
            if max_rows is not None and n >= max_rows:
                break
        if max_rows is not None and n >= max_rows:
            break
    cols = [np.concatenate([p[j] for p in parts])[:max_rows] if parts
            else np.empty(0, dtype=object) for j in range(len(names))]
    return ColumnarData.from_columns(cols, names, missing_values)


def flat_numeric_matrix(data: ColumnarData,
                        names: Sequence[str]) -> np.ndarray:
    """[n, C] float64 with NaN for missing/invalid over many columns in
    ONE flattened parse: `to_numeric` of the concatenated tokens, then
    every stripped missing token (the parse already made those that are
    not numbers NaN) and every non-finite value -> NaN. The JAX package's version writes into a
    read-only pandas buffer (ROADMAP C.1); this one owns its array.

    Typed columns (the serving wire formats) take `numeric()`'s typed
    path, as in the JAX package, and only the string columns are parsed.
    String tokens always go through the one grammar of `data/tokens.py`:
    the JAX package's `float()` shortcut for them reads past 17 digits
    another double (ROADMAP C.6)."""
    n = data.n_rows
    out = np.empty((n, len(names)), dtype=np.float64)
    typed = ([data.typed_column(c) is not None for c in names]
             if data._typed_fast_ok() else [False] * len(names))
    rest = [c for c, t in zip(names, typed) if not t]
    if rest:
        flat = np.concatenate([np.asarray(data.column(c), dtype=object)
                               for c in rest])
        vals = parse_numeric(flat)
        tokens = [m for m in data.missing_values if m != ""]
        if numeric_mask(tokens).any():
            vals[in_tokens(strip_tokens(flat), tokens)] = np.nan
        out[:, np.flatnonzero(~np.asarray(typed, dtype=bool))] = \
            vals.reshape(len(rest), n).T
    for j, c in enumerate(names):
        if typed[j]:
            out[:, j] = data.numeric(c)
    return out


def make_tags(
    target_col: np.ndarray, pos_tags: Sequence[str], neg_tags: Sequence[str]
) -> np.ndarray:
    """Map raw target values to {1 pos, 0 neg, -1 invalid} (reference filters
    invalid-tag rows out of stats/train)."""
    ser = strip_tokens(target_col)
    out = np.full(len(target_col), -1, dtype=np.int32)
    is_pos = in_tokens(ser, pos_tags)
    out[is_pos] = 1
    if neg_tags:
        out[in_tokens(ser, neg_tags)] = 0
    else:
        out[~is_pos] = 0
    return out


def make_class_tags(target_col: np.ndarray, tags: Sequence[str]) -> np.ndarray:
    """Multi-class: map raw target values to their index in the flattened tag
    list (posTags + negTags, one of which is empty in classification mode —
    ModelConfig.getFlattenTags / getSetTags). -1 = invalid, filtered out."""
    ser = strip_tokens(target_col)
    out = np.full(len(target_col), -1, dtype=np.int32)
    for i, tag in enumerate(tags):
        out[ser == str(tag).strip()] = i
    return out


def make_tags_for(mc, target_col: np.ndarray,
                  pos: Optional[Sequence[str]] = None,
                  neg: Optional[Sequence[str]] = None) -> np.ndarray:
    """Dispatch on the ModelConfig's classification mode: regression (binary
    pos+neg) -> {1,0,-1}; multi-class classification -> class index 0..K-1."""
    pos = mc.data_set.pos_tags if pos is None else pos
    neg = mc.data_set.neg_tags if neg is None else neg
    all_tags = list(pos or []) + list(neg or [])
    # classification mode (XOR) uses class indices even for K == 2 — the
    # binary make_tags else-branch would map BOTH listed classes to 1 and
    # junk values to 0
    if bool(pos) != bool(neg) and len(all_tags) >= 2:
        return make_class_tags(target_col, all_tags)
    return make_tags(target_col, pos or [], neg or [])


def make_weights(
    data: ColumnarData, weight_column: Optional[str]
) -> np.ndarray:
    if not weight_column or weight_column not in data.raw:
        return np.ones(data.n_rows, dtype=np.float64)
    w = data.numeric(weight_column)
    w = np.where(np.isfinite(w) & (w >= 0), w, 1.0)
    return w

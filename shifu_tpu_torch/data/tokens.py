"""The token grammar every ingest stage of the port shares, without pandas.

The JAX package reads numbers with `pd.to_numeric(..., errors="coerce")`
and trims tokens with `Series.str.strip()`. The port keeps one copy of
each so the reader, binning and the autotype sketch cannot disagree:

* `strip_tokens` is `str.strip()`, which equals the `.str.strip()` of
  both the object and the arrow-backed string Series pandas builds
  (every code point checked).
* `to_numeric` is `pd.to_numeric(pd.Series(values), errors="coerce")` as
  float64, bit for bit. pandas parses a string with its own C routine
  (`precise_xstrtod`), not with Python's `float()`:
    - ASCII whitespace (space, \\t, \\n, \\v, \\f, \\r) around the number,
      an optional sign, at most 17 significant digits accumulated as
      `number * 10 + digit` in doubles (leading zeros count; later
      integer digits raise the exponent, later decimals are dropped),
      then one scaling by a power of ten from a table of `1eK` doubles.
      So "0.30000000000000004" reads as 0.3.
    - The exponent is read like C `strtol`: whitespace and a sign may
      follow the `e` ("1e +5" is 1e5, "1e- 5" fails). Past 1e308 the
      result is +-inf (0.0 for a zero mantissa); below 1e-616 it is 0.
    - Only ASCII: "1_234", "\\u00a01" and full-width digits fail.
    - "inf", "+inf", "-inf", "infinity", "+infinity", "-infinity" in any
      case, with nothing around them, are +-inf; "nan" fails (NaN).
    - The string ends at its first NUL, but a token that looks like an
      integer must also pass Python's `int()`, which a NUL fails.
    - When EVERY token of the array is an integer, pandas returns
      integers, so the values are `float(int(s))` (correctly rounded,
      and "-0" is +0.0), unless they leave the int64/uint64 range; one
      token that is not makes it the parse above.
  `parse_numeric` adds the JAX package's next step, non-finite -> NaN.

Tokens of up to 64 characters are parsed column-wise in numpy over their
code-point matrix, longer ones by the scalar version of the same grammar
(`_xstrtod`, which the tests hold the vectorized one against).
"""

from __future__ import annotations

import math
from typing import Iterable, Sequence, Tuple

import numpy as np

MAX_DIGITS = 17
_E10 = np.array([float(f"1e{k}") for k in range(309)])
_WS = " \t\n\v\f\r"
_INFS = {"inf": math.inf, "+inf": math.inf, "-inf": -math.inf,
         "infinity": math.inf, "+infinity": math.inf,
         "-infinity": -math.inf}
_VECTOR_MAX_LEN = 64
_BLOCK_ROWS = 1 << 16

# code-point class tables over 0..128 (128 = any code point past ASCII)
_IS_WS = np.zeros(129, dtype=bool)
_IS_WS[[ord(c) for c in _WS]] = True
_IS_DIG = np.zeros(129, dtype=bool)
_IS_DIG[48:58] = True
_DIG_VAL = np.zeros(129, dtype=np.float64)
_DIG_VAL[48:58] = np.arange(10)
_LOWER = np.arange(129, dtype=np.uint8)
_LOWER[65:91] += 32


def strip_tokens(values) -> np.ndarray:
    """`str.strip()` of every string (other objects pass through)."""
    arr = np.empty(len(values), dtype=object)
    try:
        arr[:] = list(map(str.strip, values))
    except TypeError:
        arr[:] = [v.strip() if isinstance(v, str) else v for v in values]
    return arr


def in_tokens(values, tokens: Iterable[str]) -> np.ndarray:
    """`Series.isin(tokens)`: True where the value is one of the tokens."""
    tok = set(tokens)
    return np.fromiter(map(tok.__contains__, values), dtype=bool,
                       count=len(values))


def _xstrtod(s: str) -> Tuple[float, bool, bool]:
    """pandas' precise_xstrtod over one C string: (value, parsed to the
    end, looks like an integer)."""
    n = len(s)
    p = 0
    while p < n and s[p] in _WS:
        p += 1
    neg = p < n and s[p] == "-"
    if p < n and s[p] in "+-":
        p += 1
    number, expo, nd, ndec, maybe_int = 0.0, 0, 0, 0, True
    while p < n and "0" <= s[p] <= "9":
        if nd < MAX_DIGITS:
            number = number * 10.0 + (ord(s[p]) - 48)
            nd += 1
        else:
            expo += 1
        p += 1
    if p < n and s[p] == ".":
        maybe_int = False
        p += 1
        while nd < MAX_DIGITS and p < n and "0" <= s[p] <= "9":
            number = number * 10.0 + (ord(s[p]) - 48)
            p += 1
            nd += 1
            ndec += 1
        while p < n and "0" <= s[p] <= "9":
            p += 1
        expo -= ndec
    if nd == 0:
        return 0.0, False, maybe_int
    if neg:
        number = -number
    if p < n and s[p] in "eE":
        maybe_int = False
        q = p + 1
        while q < n and s[q] in _WS:
            q += 1
        sign = -1 if q < n and s[q] == "-" else 1
        if q < n and s[q] in "+-":
            q += 1
        start, ev = q, 0
        while q < n and "0" <= s[q] <= "9":
            ev = min(ev * 10 + ord(s[q]) - 48, 10**7)
            q += 1
        if q > start:
            expo += sign * ev
            p = q
    number = _scale(number, expo)
    while p < n and s[p] in _WS:
        p += 1
    return number, p == n, maybe_int


def _scale(number: float, expo: int) -> float:
    if expo > 308:
        return math.copysign(math.inf, number) if number != 0 else 0.0
    if expo > 0:
        return number * float(_E10[expo])
    if expo < -616:
        return 0.0
    if expo < -308:
        return number / float(_E10[-308 - expo]) / float(_E10[308])
    return number / float(_E10[-expo])


def _floatify_scalar(s: str) -> Tuple[float, bool, bool]:
    data = s.split("\x00", 1)[0]
    v, ok, maybe_int = _xstrtod(data)
    if not ok:
        inf = _INFS.get(data.lower()) if data.isascii() else None
        if inf is None:
            return math.nan, False, False
        return inf, True, False
    return v, True, maybe_int


def _floatify_block(strs: Sequence[str], width: int):
    """The vectorized `_floatify_scalar` over strings of at most `width`
    characters: (values, ok, maybe_int)."""
    m = len(strs)
    u = np.asarray(strs).astype(f"<U{max(width, 1)}")
    cp = np.zeros((m, width + 1), dtype=np.uint32)
    cp[:, :width] = u.view(np.uint32).reshape(m, max(width, 1))[:, :width]
    cut = np.argmax(cp == 0, axis=1)  # C strlen: the first NUL
    c8 = np.minimum(cp, 128).astype(np.uint8)
    c8[np.arange(width + 1)[None, :] >= cut[:, None]] = 0
    return _floatify_rows(c8, cut, width)


def _floatify_rows(c8: np.ndarray, cut: np.ndarray, width: int):
    """The grammar step by step over a code-point class matrix [m, width
    + 1] (0 past each string's end)."""
    m = len(cut)
    r = np.arange(m)
    p = np.zeros(m, dtype=np.intp)

    def skip_ws(pos, active=None):
        while True:
            a = _IS_WS[c8[r, pos]]
            if active is not None:
                a &= active
            if not a.any():
                return pos
            pos = pos + a

    p = skip_ws(p)
    c = c8[r, p]
    neg = c == 45
    p = p + ((c == 45) | (c == 43))
    number = np.zeros(m)
    nd = np.zeros(m, dtype=np.int64)
    expo = np.zeros(m, dtype=np.int64)
    while True:
        c = c8[r, p]
        d = _IS_DIG[c]
        if not d.any():
            break
        take = d & (nd < MAX_DIGITS)
        number = np.where(take, number * 10.0 + _DIG_VAL[c], number)
        nd += take
        expo += d & ~take
        p = p + d
    dot = c8[r, p] == 46
    maybe_int = ~dot
    p = p + dot
    ndec = np.zeros(m, dtype=np.int64)
    while True:
        c = c8[r, p]
        d = dot & _IS_DIG[c]
        if not d.any():
            break
        take = d & (nd < MAX_DIGITS)
        number = np.where(take, number * 10.0 + _DIG_VAL[c], number)
        nd += take
        ndec += take
        p = p + d
    expo -= ndec
    number = np.where(neg, -number, number)
    c = c8[r, p]
    ise = (nd > 0) & ((c == 101) | (c == 69))
    maybe_int &= ~ise
    q = skip_ws(p + ise, ise)
    c = c8[r, q]
    sign = np.where(c == 45, -1, 1)
    q = q + (ise & ((c == 45) | (c == 43)))
    start = q.copy()
    ev = np.zeros(m, dtype=np.int64)
    while True:
        c = c8[r, q]
        d = ise & _IS_DIG[c]
        if not d.any():
            break
        ev = np.where(d, np.minimum(ev * 10 + _DIG_VAL[c].astype(np.int64),
                                    10**7), ev)
        q = q + d
    has = q > start
    expo += np.where(has, sign * ev, 0)
    p = np.where(has, q, p)
    with np.errstate(over="ignore"):
        val = np.where(expo > 0, number * _E10[np.clip(expo, 0, 308)],
                       number / _E10[np.clip(-expo, 0, 308)])
        small = (expo < -308) & (expo >= -616)
        if small.any():
            val[small] = (number[small] / _E10[-308 - expo[small]]
                          / _E10[308])
    val[expo < -616] = 0.0
    big = expo > 308
    val[big] = np.where(number[big] != 0,
                        np.copysign(np.inf, number[big]), 0.0)
    p = skip_ws(p)
    ok = (nd > 0) & (p == cut)
    # the infinity spellings pandas accepts when the number parse fails
    low = _LOWER[c8]
    for word, inf in _INFS.items():
        L = len(word)
        if L > width:
            continue
        hit = ~ok & (cut == L)
        if hit.any():
            hit &= (low[:, :L] == np.frombuffer(word.encode(),
                                                np.uint8)).all(1)
            val[hit] = inf
            ok |= hit
            maybe_int &= ~hit
    val[~ok] = np.nan
    return val, ok, maybe_int & ok


def _floatify_all(values: np.ndarray):
    """`_floatify_scalar` over an object array of strings: (values, ok,
    maybe_int)."""
    n = len(values)
    val = np.full(n, np.nan)
    ok = np.zeros(n, dtype=bool)
    maybe_int = np.zeros(n, dtype=bool)
    lens = np.fromiter(map(len, values), dtype=np.int64, count=n)
    short = np.nonzero(lens <= _VECTOR_MAX_LEN)[0]
    for a in range(0, len(short), _BLOCK_ROWS):
        idx = short[a:a + _BLOCK_ROWS]
        v, o, mi = _floatify_block(values[idx], int(lens[idx].max()))
        val[idx], ok[idx], maybe_int[idx] = v, o, mi
    for i in np.nonzero(lens > _VECTOR_MAX_LEN)[0]:
        val[i], ok[i], maybe_int[i] = _floatify_scalar(values[i])
    # an integer-looking token must also pass Python's int(): a NUL
    # (which ended the C string early) fails it
    if "\x00" in "".join(values):
        for i in np.nonzero(maybe_int)[0]:
            if "\x00" in values[i]:
                val[i], ok[i], maybe_int[i] = np.nan, False, False
    return val, ok, maybe_int


def _as_strings(values) -> np.ndarray:
    values = np.asarray(values, dtype=object).reshape(-1)
    try:
        "".join(values)
        return values
    except TypeError:
        return np.array([v if isinstance(v, str) else str(v)
                         for v in values], dtype=object)


def to_numeric(values) -> np.ndarray:
    """`pd.to_numeric(pd.Series(values), errors="coerce")` as float64.
    `values` are strings (another object reads as its `str()`)."""
    values = _as_strings(values)
    val, ok, maybe_int = _floatify_all(values)
    if len(values) and maybe_int.all():
        # every token an integer: pandas keeps integers, exact, unless
        # one is past the uint64 range, or one is negative while another
        # is past int64: then it keeps the float parse
        exact = np.abs(val) < 2.0**53
        ints = {i: int(values[i]) for i in np.nonzero(~exact)[0]}
        if all(-2**63 <= v <= 2**64 - 1 for v in ints.values()) and not (
                any(v > 2**63 - 1 for v in ints.values())
                and (val < 0).any()):
            out = val + 0.0
            for i, v in ints.items():
                out[i] = float(v)
            return out
    return val


def numeric_mask(values) -> np.ndarray:
    """`pd.to_numeric(values, errors="coerce").notna()`: which tokens
    parse (+-inf included)."""
    return _floatify_all(_as_strings(values))[1]


def parse_numeric(values) -> np.ndarray:
    """The JAX package's numeric view of a token array: `to_numeric`,
    then every non-finite value (+-inf) becomes NaN."""
    vals = to_numeric(values)
    vals[~np.isfinite(vals)] = np.nan
    return vals

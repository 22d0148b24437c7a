"""Per-column sketches of `shifu init`'s autotype pass
(counterpart of `DistinctSketch` and `AutoTypeSketch` in
`shifu_tpu/stats/sketch.py`; the streamed-stats sketches are ROADMAP A.13).

The distinct count is written into ColumnConfig.json, and past 4,096
distinct values it is a HyperLogLog estimate over a 64-bit hash of each
value. For the same bytes as the JAX package, the hash is pandas' own
(`pd.util.hash_pandas_object(series, index=False)` of strings), done here
in numpy:
  1. SipHash-2-4 of the UTF-8 bytes under pandas' default key
     "0123456789123456", vectorized over a zero-padded byte matrix, one
     8-byte block a step;
  2. then the 64-bit mix of pandas' `_hash_ndarray`
     (x ^= x >> 30; x *= 0xBF58476D1CE4E5B9; x ^= x >> 27;
      x *= 0x94D049BB133111EB; x ^= x >> 31).
Folding chunks is exact (register max, set union, integer-valued f64
sums), so one sketch set over all chunks equals a fold of any split.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from shifu_tpu_torch.data.tokens import (in_tokens, numeric_mask,
                                         strip_tokens)

HASH_KEY = b"0123456789123456"  # pandas.core.util.hashing._default_hash_key
_K0, _K1 = (int(x) for x in np.frombuffer(HASH_KEY, dtype="<u8"))
EXACT_LIMIT = 4096  # distinct values counted exactly, past it the HLL
_BLOCK_BYTES = 1 << 26  # byte-matrix budget of one vectorized step


def _rotl(x: np.ndarray, b: int) -> np.ndarray:
    return (x << np.uint64(b)) | (x >> np.uint64(64 - b))


def _sip_rounds(v, n: int) -> None:
    v0, v1, v2, v3 = v
    for _ in range(n):
        v0 += v1
        v1 = _rotl(v1, 13)
        v1 ^= v0
        v0 = _rotl(v0, 32)
        v2 += v3
        v3 = _rotl(v3, 16)
        v3 ^= v2
        v0 += v3
        v3 = _rotl(v3, 21)
        v3 ^= v0
        v2 += v1
        v1 = _rotl(v1, 17)
        v1 ^= v2
        v2 = _rotl(v2, 32)
    v[:] = [v0, v1, v2, v3]


def siphash24(blocks: np.ndarray) -> np.ndarray:
    """SipHash-2-4 of rows of little-endian 64-bit message words [m, k];
    the last word of each row already carries the tail bytes and the
    length byte."""
    m = blocks.shape[0]
    v = [np.full(m, np.uint64(c), dtype=np.uint64) for c in (
        _K0 ^ 0x736F6D6570736575, _K1 ^ 0x646F72616E646F6D,
        _K0 ^ 0x6C7967656E657261, _K1 ^ 0x7465646279746573)]
    for j in range(blocks.shape[1]):
        mj = blocks[:, j]
        v[3] ^= mj
        _sip_rounds(v, 2)
        v[0] ^= mj
    v[2] ^= np.uint64(0xFF)
    _sip_rounds(v, 4)
    return v[0] ^ v[1] ^ v[2] ^ v[3]


def mix64(vals: np.ndarray) -> np.ndarray:
    """pandas' `_hash_ndarray` redistribution of 64-bit hashes."""
    vals = vals.copy()
    vals ^= vals >> np.uint64(30)
    vals *= np.uint64(0xBF58476D1CE4E5B9)
    vals ^= vals >> np.uint64(27)
    vals *= np.uint64(0x94D049BB133111EB)
    vals ^= vals >> np.uint64(31)
    return vals


def c_string_representatives(values: Sequence[str]) -> Sequence[str]:
    """pandas hashes the categories of a factorize whose string table keys
    on C strings: a value with a NUL shares the category (and so the hash)
    of the first value in the array with the same text before its NUL."""
    if "\x00" not in "".join(values):
        return values
    first: dict = {}
    return [first.setdefault(v.split("\x00", 1)[0], v) for v in values]


def hash_strings(values: Sequence[str]) -> np.ndarray:
    """`pd.util.hash_pandas_object(pd.Series(values), index=False)` of a
    sequence of strings, as uint64."""
    return _hash_mixed(c_string_representatives(values))


def _hash_mixed(values: Sequence[str]) -> np.ndarray:
    """SipHash-2-4 then `mix64` of each string's UTF-8 bytes."""
    m = len(values)
    out = np.empty(m, dtype=np.uint64)
    if m == 0:
        return out
    joined = "".join(values)
    if joined.isascii():  # one byte a character: encode once
        lens = np.fromiter(map(len, values), dtype=np.int64, count=m)
        buf = np.frombuffer(joined.encode("ascii") + b"\0", dtype=np.uint8)
    else:
        enc = [v.encode("utf-8") for v in values]
        lens = np.fromiter(map(len, enc), dtype=np.int64, count=m)
        buf = np.frombuffer(b"".join(enc) + b"\0", dtype=np.uint8)
    starts = np.zeros(m, dtype=np.int64)
    np.cumsum(lens[:-1], out=starts[1:])
    nblk = lens // 8 + 1
    for k in np.unique(nblk):
        rows_all = np.nonzero(nblk == k)[0]
        step = max(1, _BLOCK_BYTES // (8 * int(k)))
        offs = np.arange(8 * int(k))
        for a in range(0, len(rows_all), step):
            rows = rows_all[a:a + step]
            idx = starts[rows][:, None] + offs[None, :]
            valid = offs[None, :] < lens[rows][:, None]
            byts = np.where(valid, buf[np.where(valid, idx, len(buf) - 1)],
                            0).astype(np.uint8)
            blocks = np.ascontiguousarray(byts).view("<u8").reshape(
                len(rows), int(k)).copy()
            blocks[:, -1] |= (lens[rows].astype(np.uint64)
                              & np.uint64(0xFF)) << np.uint64(56)
            out[rows] = siphash24(blocks)
    return mix64(out)


class DistinctSketch:
    """Distinct-count sketch: exact hash set up to `EXACT_LIMIT`, then a
    vectorized HyperLogLog (p=12, 4096 one-byte registers, ~1.6% error) —
    the reference's HLL++ autotype sketch
    (core/autotype/AutoTypeDistinctCountMapper.java:45) done in numpy."""

    P = 12

    def __init__(self):
        self.exact: Optional[set] = set()
        m = 1 << self.P
        self.registers = np.zeros(m, dtype=np.uint8)

    def update_hashes(self, h: np.ndarray) -> None:
        """h: uint64 hashes of the values."""
        m = 1 << self.P
        idx = (h & np.uint64(m - 1)).astype(np.int64)
        w = h >> np.uint64(self.P)
        # rho = leading-zero count of w in (64-P) bits, + 1; frexp's
        # exponent IS the bit length of w < 2^52 (exact in float64)
        bits = np.zeros(w.shape, dtype=np.int64)
        nz = w > 0
        bits[nz] = np.frexp(w[nz].astype(np.float64))[1]
        rho = (64 - self.P) - bits + 1
        np.maximum.at(self.registers, idx, rho.astype(np.uint8))
        if self.exact is not None:
            self.exact.update(h.tolist())
            if len(self.exact) > EXACT_LIMIT:
                self.exact = None  # fall back to the registers

    def update_values(self, values: Sequence[str]) -> None:
        """Fold string values in; each distinct value is hashed once (the
        registers and the exact set ignore repeats)."""
        if not len(values):
            return
        values = c_string_representatives(values)
        self.update_hashes(_hash_mixed(list(dict.fromkeys(values))))

    def estimate(self) -> int:
        if self.exact is not None:
            return len(self.exact)
        m = float(1 << self.P)
        alpha = 0.7213 / (1.0 + 1.079 / m)
        s = np.power(2.0, -self.registers.astype(np.float64)).sum()
        e = alpha * m * m / s
        zeros = int((self.registers == 0).sum())
        if e <= 2.5 * m and zeros:
            e = m * np.log(m / zeros)  # linear-counting small-range fix
        return int(round(e))


class AutoTypeSketch:
    """Autotype accumulator: distinct count + numeric-parse ratio +
    missing count over the stripped tokens of a column."""

    def __init__(self, missing_values):
        self.distinct = DistinctSketch()
        self.missing_values = list(missing_values)
        self.total = 0.0
        self.missing = 0.0
        self.numeric_ok = 0.0

    def update(self, values) -> None:
        """values: the raw string tokens of one chunk of the column."""
        ser = strip_tokens(values)
        miss = in_tokens(ser, self.missing_values)
        non_missing = ser[~miss]
        self.missing += float(miss.sum())
        self.total += float(len(non_missing))
        self.numeric_ok += float(numeric_mask(non_missing).sum())
        self.distinct.update_values(non_missing)

    def distinct_count(self) -> int:
        return self.distinct.estimate()

    def numeric_ratio(self) -> float:
        return self.numeric_ok / self.total if self.total > 0 else 0.0

"""Per-column sketches (counterpart of `shifu_tpu/stats/sketch.py`):
`shifu init`'s autotype sketches (`DistinctSketch`, `AutoTypeSketch`)
and the streamed stats' (`StreamingHistogram`, `NumericSketch`,
`CategoricalSketch`), host numpy as in the JAX package and the same
bits: the streamed bins come from them.

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

from collections import Counter
from typing import Dict, List, Optional, Sequence

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

    def merge(self, other: "DistinctSketch") -> None:
        """Union another shard's sketch: registers max elementwise, the
        exact sets union while both are exact."""
        np.maximum(self.registers, other.registers, out=self.registers)
        if self.exact is not None and other.exact is not None:
            self.exact |= other.exact
            if len(self.exact) > EXACT_LIMIT:
                self.exact = None
        else:
            self.exact = None

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

    def merge(self, other: "AutoTypeSketch") -> None:
        self.distinct.merge(other.distinct)
        self.total += other.total
        self.missing += other.missing
        self.numeric_ok += other.numeric_ok


# ---------------------------------------------------------------------------
# streamed stats
# ---------------------------------------------------------------------------

HIST_SCALE = 100  # centroids per requested bin, EqualPopulationBinning.java:45


class StreamingHistogram:
    """SPDT centroid histogram (the reference's EqualPopulationBinning
    sketch, core/binning/EqualPopulationBinning.java:34): values
    ascending, positive weights, nearest pairs merged past the cap."""

    def __init__(self, max_centroids: int = 1024):
        self.cap = max(max_centroids, 8)
        self.v = np.empty(0, dtype=np.float64)
        self.w = np.empty(0, dtype=np.float64)

    def update(self, values: np.ndarray,
               weights: Optional[np.ndarray] = None) -> None:
        """Fold a chunk in; values finite (callers drop NaN)."""
        if values.size == 0:
            return
        uv, inv = np.unique(values, return_inverse=True)
        if weights is None:
            uw = np.bincount(inv, minlength=uv.size).astype(np.float64)
        else:
            uw = np.bincount(inv, weights=weights, minlength=uv.size)
        v = np.concatenate([self.v, uv])
        w = np.concatenate([self.w, uw])
        order = np.argsort(v, kind="stable")
        v, w = v[order], w[order]
        if v.size > 1:  # collapse exact duplicates at the seam
            same = np.concatenate([[False], v[1:] == v[:-1]])
            if same.any():
                group = np.cumsum(~same) - 1
                nw = np.zeros(int(group[-1]) + 1)
                np.add.at(nw, group, w)
                v, w = v[~same], nw
        self.v, self.w = self._compress(v, w)

    def _compress(self, v: np.ndarray, w: np.ndarray):
        """Merge the nearest non-conflicting pairs, round by round, until
        under the cap."""
        while v.size > self.cap:
            need = v.size - self.cap
            gaps = v[1:] - v[:-1]
            used = np.zeros(v.size, dtype=bool)
            merge_left: List[int] = []
            for i in np.argsort(gaps, kind="stable"):
                if used[i] or used[i + 1]:
                    continue
                used[i] = used[i + 1] = True
                merge_left.append(i)
                if len(merge_left) >= need:
                    break
            ml = np.asarray(sorted(merge_left), dtype=np.int64)
            keep = np.ones(v.size, dtype=bool)
            keep[ml + 1] = False
            wsum = w.copy()
            wsum[ml] = w[ml] + w[ml + 1]
            vmerged = v.copy()
            vmerged[ml] = (v[ml] * w[ml] + v[ml + 1] * w[ml + 1]) \
                / np.maximum(wsum[ml], 1e-300)
            v, w = vmerged[keep], wsum[keep]
        return v, w

    def merge(self, other: "StreamingHistogram") -> None:
        self.update(other.v, other.w)

    @property
    def total_weight(self) -> float:
        return float(self.w.sum())

    def quantile(self, q: float) -> Optional[float]:
        if self.v.size == 0:
            return None
        cum = np.cumsum(self.w)
        total = cum[-1]
        if total <= 0:
            return None
        idx = min(int(np.searchsorted(cum, q * total, side="left")),
                  self.v.size - 1)
        return float(self.v[idx])

    def boundaries(self, max_bins: int) -> List[float]:
        """Equal-mass bin boundaries from -inf, strictly increasing (the
        contract of `weighted_quantile_boundaries`)."""
        neg_inf = float("-inf")
        if self.v.size == 0:
            return [neg_inf]
        cum = np.cumsum(self.w)
        total = cum[-1]
        if total <= 0:
            return [neg_inf]
        out = [neg_inf]
        for k in range(1, max_bins):
            idx = min(int(np.searchsorted(cum, total * k / max_bins,
                                          side="left")), self.v.size - 1)
            b = float(self.v[idx])
            if b > out[-1]:
                out.append(b)
        return out


class NumericSketch:
    """Moments, missing count and SPDT histograms (the binning subset's
    and, for the median, every value's)."""

    def __init__(self, max_bins: int = 10):
        self.hist = StreamingHistogram(max_centroids=HIST_SCALE * max_bins)
        self.hist_all = StreamingHistogram(
            max_centroids=HIST_SCALE * max_bins)
        self.count = 0.0
        self.missing = 0.0
        self.sum = 0.0
        self.sumsq = 0.0
        self.min = np.inf
        self.max = -np.inf

    def update(self, values: np.ndarray, bin_mask: np.ndarray,
               bin_weights: Optional[np.ndarray] = None) -> None:
        """values float64 (NaN = missing) of valid-tag rows; bin_mask
        selects the binning subset (pos/neg/total by binningMethod)."""
        finite = np.isfinite(values)
        self.missing += float((~finite).sum())
        fv = values[finite]
        if fv.size:
            self.count += float(fv.size)
            self.sum += float(fv.sum())
            self.sumsq += float((fv * fv).sum())
            self.min = min(self.min, float(fv.min()))
            self.max = max(self.max, float(fv.max()))
            self.hist_all.update(fv)
        sel = finite & bin_mask
        sv = values[sel]
        if sv.size:
            self.hist.update(sv, None if bin_weights is None
                             else bin_weights[sel])

    @property
    def median(self) -> Optional[float]:
        return self.hist_all.quantile(0.5)

    def merge(self, other: "NumericSketch") -> None:
        """Fold another shard's sketch in (exact moments; histograms
        exact until compressed, else within the SPDT bound)."""
        self.count += other.count
        self.missing += other.missing
        self.sum += other.sum
        self.sumsq += other.sumsq
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        self.hist.merge(other.hist)
        self.hist_all.merge(other.hist_all)


class CategoricalSketch:
    """Capped value -> count map with space-saving error tracking
    (Metwally et al.); the reference caps categories at 10k
    (shifuconfig:107-108)."""

    def __init__(self, working_cap: int = 100_000):
        self.counts: Dict[str, float] = {}
        self.working_cap = working_cap
        self.missing = 0.0
        self.total = 0.0
        self.numeric_parse_ok = 0.0
        self.saturated = False
        # per-key admission floors, the largest observed count evicted
        # (the overcount ceiling of later admissions) and the evicted mass
        self.error_bound = 0.0
        self.evicted_mass = 0.0
        self._floor: Dict[str, float] = {}

    def _evict(self) -> None:
        if len(self.counts) <= self.working_cap:
            return
        self.saturated = True
        kept = sorted(self.counts.items(), key=lambda kv: -kv[1])
        for k, cnt in kept[self.working_cap:]:
            observed = cnt - self._floor.pop(k, 0.0)
            self.error_bound = max(self.error_bound, observed)
            self.evicted_mass += observed
        self.counts = dict(kept[: self.working_cap])

    def update(self, raw: np.ndarray, missing_mask: np.ndarray) -> None:
        vals = strip_tokens(raw[~missing_mask])
        self.missing += float(missing_mask.sum())
        self.total += float(vals.size)
        self.numeric_parse_ok += float(numeric_mask(vals).sum())
        # `value_counts()` order: count descending, ties by first sight
        for key, cnt in sorted(Counter(vals.tolist()).items(),
                               key=lambda kv: -kv[1]):
            key = str(key)
            if key in self.counts:
                self.counts[key] += float(cnt)
            else:
                # an evicted value re-enters carrying the error floor
                floor = self.error_bound if self.saturated else 0.0
                self.counts[key] = float(cnt) + floor
                if floor:
                    self._floor[key] = floor
        self._evict()

    def merge(self, other: "CategoricalSketch") -> None:
        """Fold another shard's counter in, shard 0's keys first."""
        for key, cnt in other.counts.items():
            if key in self.counts:
                self.counts[key] += cnt
                self._floor[key] = (self._floor.get(key, 0.0)
                                    + other._floor.get(key, 0.0))
                if not self._floor[key]:
                    self._floor.pop(key, None)
            else:
                self.counts[key] = cnt
                if key in other._floor:
                    self._floor[key] = other._floor[key]
        self.missing += other.missing
        self.total += other.total
        self.numeric_parse_ok += other.numeric_parse_ok
        self.saturated = self.saturated or other.saturated
        self.error_bound = max(self.error_bound, other.error_bound)
        self.evicted_mass += other.evicted_mass
        self._evict()

    def top_categories(self, max_categories: int) -> List[str]:
        """Descending count, ties in first-seen order (the contract of
        `binning.categorical_bins`)."""
        if self.saturated:
            from shifu_tpu_torch.utils.log import get_logger

            get_logger(__name__).warning(
                "categorical sketch saturated at %d values; counts carry up "
                "to +%.0f per-key overcount and %.0f total evicted mass",
                self.working_cap, self.error_bound, self.evicted_mass)
        cats = [k for k, _ in sorted(self.counts.items(),
                                     key=lambda kv: -kv[1])]
        if max_categories and len(cats) > max_categories:
            cats = cats[:max_categories]
        return cats

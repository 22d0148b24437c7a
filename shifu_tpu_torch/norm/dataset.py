"""NormalizedData and CleanedData: the sharded on-disk layouts that
training reads (counterpart of `shifu_tpu/norm/dataset.py`: the in-RAM
writers, the streamed norm's `ShardWriter` and `ShuffleShardWriter`, and
the multi-host `HostPartWriter`). The files are the same bytes in both
packages, so each reads what the other wrote.

Under PathFinder.normalized_data_dir():
    meta.json            columns, nRows, shardRows, normType,
                         extra {"sourceOf", ["classTags", "classPriors"]}
    features-SSSSS.npy   [rows_s, n_cols] float32
and under cleaned_data_dir() (tree-model input, bin codes not z-scores):
    meta.json            normType "CODES", extra {"slots": [...]}
    codes-SSSSS.npy      [rows_s, n_feat] int16 (int32 past 2^15 slots)
beside, in both:
    tags-SSSSS.npy       [rows_s] int8   (1 pos / 0 neg, or class index)
    weights-SSSSS.npy    [rows_s] float32
"""

from __future__ import annotations

import glob
import json
import os
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np


@dataclass
class NormMeta:
    columns: List[str]
    n_rows: int
    shard_rows: List[int]
    norm_type: str = "ZSCALE"
    extra: Optional[dict] = None

    def to_json(self) -> dict:
        return {
            "columns": self.columns,
            "nRows": self.n_rows,
            "shardRows": self.shard_rows,
            "normType": self.norm_type,
            "extra": self.extra or {},
        }

    @classmethod
    def from_json(cls, d: dict) -> "NormMeta":
        return cls(
            columns=list(d["columns"]),
            n_rows=int(d["nRows"]),
            shard_rows=[int(x) for x in d["shardRows"]],
            norm_type=d.get("normType", "ZSCALE"),
            extra=d.get("extra") or {},
        )


def _write_meta(out_dir: str, columns: List[str], shard_rows: List[int],
                norm_type: str, extra: Optional[dict]) -> NormMeta:
    meta = NormMeta(columns=columns, n_rows=int(sum(shard_rows)),
                    shard_rows=shard_rows, norm_type=norm_type, extra=extra)
    with open(os.path.join(out_dir, "meta.json"), "w") as fh:
        json.dump(meta.to_json(), fh, indent=2)
    return meta


class ShardWriter:
    """Shard-at-a-time writer of the streamed norm: one shard an ingest
    chunk, so peak memory is one chunk whatever the dataset size."""

    def __init__(self, out_dir: str, primary_prefix: str, primary_dtype,
                 columns: List[str], norm_type: str,
                 extra: Optional[dict] = None):
        os.makedirs(out_dir, exist_ok=True)
        self.out_dir = out_dir
        self.primary_prefix = primary_prefix
        self.primary_dtype = primary_dtype
        self.columns = columns
        self.norm_type = norm_type
        self.extra = extra
        self.shard_rows: List[int] = []

    def add(self, primary: np.ndarray, tags: np.ndarray,
            weights: np.ndarray) -> None:
        s = len(self.shard_rows)
        np.save(os.path.join(self.out_dir,
                             f"{self.primary_prefix}-{s:05d}.npy"),
                primary.astype(self.primary_dtype, copy=False))
        np.save(os.path.join(self.out_dir, f"tags-{s:05d}.npy"),
                tags.astype(np.int8, copy=False))
        np.save(os.path.join(self.out_dir, f"weights-{s:05d}.npy"),
                weights.astype(np.float32, copy=False))
        self.shard_rows.append(primary.shape[0])

    def restore(self, shard_rows: List[int]) -> None:
        """Resume: trust the first len(shard_rows) shards on disk (the
        stream checkpoint recorded them); the next add() overwrites any
        shard the killed run wrote past its last snapshot."""
        self.shard_rows = [int(r) for r in shard_rows]

    def close(self) -> NormMeta:
        if not self.shard_rows:  # every chunk filtered empty
            self.add(np.zeros((0, len(self.columns)),
                              dtype=self.primary_dtype),
                     np.zeros(0, dtype=np.int8),
                     np.zeros(0, dtype=np.float32))
        return _write_meta(self.out_dir, self.columns, self.shard_rows,
                           self.norm_type, self.extra)


class HostPartWriter:
    """The per-host stage of the multi-host streamed norm: each host
    writes its own chunks as part files keyed by global chunk index,
        .part-<prefix>-CCCCCCCC.npy  (and .part-tags- / .part-weights-)
    in the final directory, and after the host barrier the merge host
    renames the fleet's union into the one-process shard layout. The
    rename is a relabel ci -> rank(ci) over the sorted union, and
    `np.save` of an equal array writes equal bytes, so the shards and
    meta.json are byte-identical to the one-process run's."""

    def __init__(self, out_dir: str, primary_prefix: str, primary_dtype,
                 columns: List[str], norm_type: str,
                 extra: Optional[dict] = None):
        os.makedirs(out_dir, exist_ok=True)
        self.out_dir = out_dir
        self.primary_prefix = primary_prefix
        self.primary_dtype = primary_dtype
        self.columns = columns
        self.norm_type = norm_type
        self.extra = extra
        self.part_rows: Dict[int, int] = {}

    def _part(self, prefix: str, ci: int) -> str:
        return os.path.join(self.out_dir, f".part-{prefix}-{ci:08d}.npy")

    def add(self, ci: int, primary: np.ndarray, tags: np.ndarray,
            weights: np.ndarray) -> None:
        np.save(self._part(self.primary_prefix, ci),
                primary.astype(self.primary_dtype, copy=False))
        np.save(self._part("tags", ci), tags.astype(np.int8, copy=False))
        np.save(self._part("weights", ci),
                weights.astype(np.float32, copy=False))
        self.part_rows[int(ci)] = int(primary.shape[0])

    def restore(self, part_rows: Dict) -> None:
        """Resume: the stream checkpoint recorded these parts as
        complete; a chunk killed mid-save lies past the cursor and is
        written again."""
        self.part_rows = {int(k): int(v) for k, v in part_rows.items()}

    def merge(self, union_rows: Dict[int, int]) -> NormMeta:
        """Merge host only, after the barrier: rename the fleet's union of
        parts ({global ci: rows}) into the shard layout, then write
        meta.json."""
        shard_rows: List[int] = []
        for sid, ci in enumerate(sorted(union_rows)):
            for prefix in (self.primary_prefix, "tags", "weights"):
                os.replace(
                    self._part(prefix, ci),
                    os.path.join(self.out_dir, f"{prefix}-{sid:05d}.npy"))
            shard_rows.append(int(union_rows[ci]))
        if not shard_rows:  # as ShardWriter.close: one empty shard
            np.save(os.path.join(self.out_dir,
                                 f"{self.primary_prefix}-00000.npy"),
                    np.zeros((0, len(self.columns)),
                             dtype=self.primary_dtype))
            np.save(os.path.join(self.out_dir, "tags-00000.npy"),
                    np.zeros(0, dtype=np.int8))
            np.save(os.path.join(self.out_dir, "weights-00000.npy"),
                    np.zeros(0, dtype=np.float32))
            shard_rows.append(0)
        # every host has published its part list by now, so a .part-*
        # file outside the union is debris of an earlier run
        for leftover in sorted(glob.glob(os.path.join(self.out_dir,
                                                      ".part-*.npy"))):
            try:
                os.unlink(leftover)
            except OSError:  # already gone
                pass
        return _write_meta(self.out_dir, self.columns, shard_rows,
                           self.norm_type, self.extra)


class ShuffleShardWriter:
    """External-shuffle shard writer, the streaming analog of the MR
    shuffle (core/shuffle/MapReduceShuffle.java:47). Pass 1 (add): each
    chunk's rows scatter to k bucket files under a draw keyed by [seed,
    5_555, chunk]. Pass 2 (close): each bucket is permuted by [seed,
    7_777, bucket] and written as a shard. Random buckets and in-bucket
    permutations make a uniform global permutation with one bucket in
    memory. Two writers with the same (seed, k) fed in lockstep draw the
    same assignments, so the feature and code artifacts stay
    row-aligned."""

    _CLOSE_BLOCK_ROWS = 65536

    def __init__(self, out_dir: str, primary_prefix: str, primary_dtype,
                 columns: List[str], norm_type: str, n_buckets: int,
                 seed: int = 0, extra: Optional[dict] = None):
        os.makedirs(out_dir, exist_ok=True)
        self.out_dir = out_dir
        self.primary_prefix = primary_prefix
        self.primary_dtype = np.dtype(primary_dtype)
        self.columns = columns
        self.norm_type = norm_type
        self.extra = extra
        self.seed = seed
        self.k = max(1, n_buckets)
        self._chunk_idx = 0
        self._bucket_rows = [0] * self.k
        for s in range(self.k):
            for suffix in (".primary.bin", ".tags.bin", ".weights.bin"):
                open(self._bucket_base(s) + suffix, "wb").close()

    def _bucket_base(self, s: int) -> str:
        return os.path.join(self.out_dir, f".bucket-{s:05d}")

    def add(self, primary: np.ndarray, tags: np.ndarray,
            weights: np.ndarray) -> None:
        n = primary.shape[0]
        # 5_555 keeps the bucket draw apart from the [seed, chunk]
        # sampling draw (7_777 keys the close-time permutations)
        assign = np.random.default_rng(
            [self.seed, 5_555, self._chunk_idx]).integers(self.k, size=n)
        self._chunk_idx += 1
        order = np.argsort(assign, kind="stable")
        counts = np.bincount(assign, minlength=self.k)
        bounds = np.concatenate([[0], np.cumsum(counts)])
        parts = (np.ascontiguousarray(
                     primary.astype(self.primary_dtype, copy=False)[order]),
                 np.ascontiguousarray(tags.astype(np.int8, copy=False)[order]),
                 np.ascontiguousarray(
                     weights.astype(np.float32, copy=False)[order]))
        for s in np.nonzero(counts)[0]:
            a, b = bounds[s], bounds[s + 1]
            base = self._bucket_base(s)
            for suffix, arr in zip((".primary.bin", ".tags.bin",
                                    ".weights.bin"), parts):
                with open(base + suffix, "ab") as fh:
                    fh.write(arr[a:b].tobytes())
            self._bucket_rows[s] += int(b - a)

    def _permute_to_npy(self, src: str, dtype, shape, perm,
                        dst: str) -> None:
        if shape[0] == 0:
            np.save(dst, np.zeros(shape, dtype=dtype))
            return
        src_mm = np.memmap(src, dtype=dtype, mode="r", shape=shape)
        out = np.lib.format.open_memmap(dst, mode="w+", dtype=dtype,
                                        shape=shape)
        for a in range(0, shape[0], self._CLOSE_BLOCK_ROWS):
            b = min(a + self._CLOSE_BLOCK_ROWS, shape[0])
            out[a:b] = src_mm[perm[a:b]]
        out.flush()
        del out, src_mm

    def close(self) -> NormMeta:
        n_cols = len(self.columns)
        for s in range(self.k):
            base = self._bucket_base(s)
            rows = self._bucket_rows[s]
            perm = np.random.default_rng([self.seed, 7_777, s]).permutation(
                rows)
            for suffix, dtype, shape, prefix in (
                    (".primary.bin", self.primary_dtype, (rows, n_cols),
                     self.primary_prefix),
                    (".tags.bin", np.int8, (rows,), "tags"),
                    (".weights.bin", np.float32, (rows,), "weights")):
                self._permute_to_npy(
                    base + suffix, dtype, shape, perm,
                    os.path.join(self.out_dir, f"{prefix}-{s:05d}.npy"))
                os.remove(base + suffix)
        return _write_meta(self.out_dir, self.columns,
                           list(self._bucket_rows), self.norm_type,
                           self.extra)


def _shard_slices(n_rows: int, n_shards: int) -> List[Tuple[int, int]]:
    base, rem = divmod(n_rows, n_shards)
    out, start = [], 0
    for s in range(n_shards):
        size = base + (1 if s < rem else 0)
        out.append((start, start + size))
        start += size
    return out


def _write_sharded(out_dir: str, primary_prefix: str, primary: np.ndarray,
                   primary_dtype, tags: np.ndarray, weights: np.ndarray,
                   columns: List[str], norm_type: str, n_shards: int,
                   extra: Optional[dict]) -> NormMeta:
    os.makedirs(out_dir, exist_ok=True)
    n = primary.shape[0]
    n_shards = max(1, min(n_shards, max(n, 1)))
    shard_rows = []
    for s, (a, b) in enumerate(_shard_slices(n, n_shards)):
        np.save(os.path.join(out_dir, f"{primary_prefix}-{s:05d}.npy"),
                primary[a:b].astype(primary_dtype, copy=False))
        np.save(os.path.join(out_dir, f"tags-{s:05d}.npy"),
                tags[a:b].astype(np.int8, copy=False))
        np.save(os.path.join(out_dir, f"weights-{s:05d}.npy"),
                weights[a:b].astype(np.float32, copy=False))
        shard_rows.append(b - a)
    return _write_meta(out_dir, columns, shard_rows, norm_type, extra)


def write_normalized(out_dir: str, features: np.ndarray, tags: np.ndarray,
                     weights: np.ndarray, columns: List[str],
                     norm_type: str = "ZSCALE", n_shards: int = 1,
                     extra: Optional[dict] = None) -> NormMeta:
    return _write_sharded(out_dir, "features", features, np.float32, tags,
                          weights, columns, norm_type, n_shards, extra)


def write_codes(out_dir: str, codes: np.ndarray, tags: np.ndarray,
                weights: np.ndarray, columns: List[str], slots: List[int],
                n_shards: int = 1) -> NormMeta:
    """Tree-model input: int16 bin codes per feature + per-column slot
    counts. int16 covers the reference's 10k category cap; wider slots
    use int32."""
    code_dtype = np.int16 if (not slots or max(slots) < 2**15) else np.int32
    return _write_sharded(out_dir, "codes", codes, code_dtype, tags, weights,
                          columns, "CODES", n_shards, {"slots": slots})


def read_meta(data_dir: str) -> NormMeta:
    with open(os.path.join(data_dir, "meta.json")) as fh:
        return NormMeta.from_json(json.load(fh))


def _load_stack(data_dir: str, prefix: str, n_shards: int) -> np.ndarray:
    parts = [
        np.load(os.path.join(data_dir, f"{prefix}-{s:05d}.npy"), mmap_mode="r")
        for s in range(n_shards)
    ]
    return (np.concatenate(parts, axis=0) if len(parts) > 1
            else np.asarray(parts[0]))


def load_normalized(data_dir: str
                    ) -> Tuple[NormMeta, np.ndarray, np.ndarray, np.ndarray]:
    """(meta, features[n, C] f32, tags[n] i8, weights[n] f32)."""
    meta = read_meta(data_dir)
    k = len(meta.shard_rows)
    return (meta, _load_stack(data_dir, "features", k),
            _load_stack(data_dir, "tags", k),
            _load_stack(data_dir, "weights", k))


def load_codes(data_dir: str
               ) -> Tuple[NormMeta, np.ndarray, np.ndarray, np.ndarray]:
    """(meta, codes[n, C] i16, tags[n] i8, weights[n] f32)."""
    meta = read_meta(data_dir)
    k = len(meta.shard_rows)
    return (meta, _load_stack(data_dir, "codes", k),
            _load_stack(data_dir, "tags", k),
            _load_stack(data_dir, "weights", k))


def iter_shards(data_dir: str, prefix: str = "features") -> Iterator[np.ndarray]:
    meta = read_meta(data_dir)
    for s in range(len(meta.shard_rows)):
        yield np.load(os.path.join(data_dir, f"{prefix}-{s:05d}.npy"),
                      mmap_mode="r")

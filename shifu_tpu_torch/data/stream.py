"""Chunked ingestion and the in-RAM/streamed route decision (counterpart
of `shifu_tpu/data/stream.py`).

The operational knobs are the JAX package's:
    shifu.ingest.chunkRows        rows per chunk (default 65536)
    shifu.ingest.memoryBudgetMB   datasets whose files exceed this budget
                                  take the streamed route (default 512)
    shifu.ingest.forceStreaming   true/1: always the streamed route

The port reads CSV/gzip chunks with its own reader (`data/reader.py`),
local or remote (`fs/source.py`); the streamed routes pull them through
`data/pipeline.prefetch_iter`, in order. Parquet files (reference:
ModelNormalizeConf.isParquet, udf/NormalizeParquetUDF.java) are read as
pyarrow record batches, pyarrow imported only on a `.parquet` path (the
CSV ingest never imports it, nor pandas); each batch's tokens are the
strings the JAX package's `to_pandas()`, `fillna("")`, `astype(str)`
makes of it (`_parquet_tokens`).
"""

from __future__ import annotations

from itertools import chain
from typing import Callable, Iterator, List, Optional, Sequence

import numpy as np

from shifu_tpu_torch.data.reader import (DEFAULT_MISSING, ColumnarData,
                                         iter_column_batches)
from shifu_tpu_torch.fs.listing import dataset_size_bytes, expand_paths
from shifu_tpu_torch.utils import environment
from shifu_tpu_torch.utils.errors import ErrorCode, ShifuError

DEFAULT_CHUNK_ROWS = 65536
DEFAULT_MEMORY_BUDGET_MB = 512

PARQUET_SUFFIXES = (".parquet", ".parq")


def chunk_rows_setting() -> int:
    return environment.get_int("shifu.ingest.chunkRows", DEFAULT_CHUNK_ROWS)


def memory_budget_bytes() -> int:
    mb = environment.get_int("shifu.ingest.memoryBudgetMB",
                             DEFAULT_MEMORY_BUDGET_MB)
    return int(mb) * 1024 * 1024


def should_stream(data_path: str) -> bool:
    """Stream when the raw files exceed the configured memory budget (the
    in-RAM object representation costs several times the file size)."""
    if environment.get_property("shifu.ingest.forceStreaming", "") in (
        "true", "1",
    ):
        return True
    return dataset_size_bytes(data_path) > memory_budget_bytes()


def _import_pyarrow_parquet(path: str):
    try:
        import pyarrow.parquet as pq
    except ImportError:
        raise ShifuError(ErrorCode.DATA_NOT_FOUND,
                         f"{path}: parquet input needs pyarrow, which is "
                         "not installed")
    return pq


def _float_token(v: float, shortest32: bool) -> str:
    if shortest32:
        return str(np.float32(v))
    return repr(float(v))


def _parquet_tokens(arr) -> np.ndarray:
    """One record batch column -> its object array of strings, as the JAX
    package's pandas route makes them: nulls (and float NaN) are "";
    an integer column with a null in the batch becomes float64 ("1.0");
    a float32 column keeps its shortest float32 digits ("0.1") unless
    the batch holds a null or NaN (then the float64 repr of the value,
    "0.10000000149011612"); floats otherwise print as Python's repr, and
    bools as "True" / "False"."""
    import pyarrow as pa

    t = arr.type
    vals = arr.to_pylist()
    out = np.empty(len(vals), dtype=object)
    if pa.types.is_null(t):
        out[:] = ""
        return out
    if pa.types.is_integer(t):
        if arr.null_count:
            out[:] = ["" if v is None else repr(float(v)) for v in vals]
        else:
            out[:] = [str(v) for v in vals]
        return out
    if pa.types.is_floating(t):
        holes = arr.null_count or any(v != v for v in vals)
        short = pa.types.is_float32(t) and not holes
        out[:] = ["" if v is None or v != v else _float_token(v, short)
                  for v in vals]
        return out
    out[:] = ["" if v is None else str(v) for v in vals]
    return out


def _iter_parquet_chunks(path: str, names: List[str], chunk_rows: int,
                         missing_values: Sequence[str]
                         ) -> Iterator[ColumnarData]:
    """The record batches of one parquet file (at most chunk_rows rows
    each) as ColumnarData over `names`: a name the file lacks reads as
    all "" (missing), stray header rows dropped."""
    from shifu_tpu_torch.fs.source import open_source

    pq = _import_pyarrow_parquet(path)
    with open_source(path, "rb") as fh:
        pf = pq.ParquetFile(fh)
        have = set(pf.schema_arrow.names)
        cols = [c for c in names if c in have]
        for batch in pf.iter_batches(batch_size=chunk_rows,
                                     columns=cols or None):
            n = batch.num_rows
            arrays = []
            for c in names:
                if c in have:
                    arrays.append(_parquet_tokens(batch.column(c)))
                else:
                    blank = np.empty(n, dtype=object)
                    blank[:] = ""
                    arrays.append(blank)
            yield ColumnarData.from_columns(arrays, list(names),
                                            missing_values)


def iter_columnar_chunks(
    data_path: str,
    names: List[str],
    delimiter: str = "|",
    missing_values: Sequence[str] = DEFAULT_MISSING,
    chunk_rows: Optional[int] = None,
    max_rows: Optional[int] = None,
    columns: Optional[Sequence[str]] = None,
) -> Iterator[ColumnarData]:
    """Yield ColumnarData chunks of at most chunk_rows across all part
    files. `columns`, when given, keeps only that subset of the header
    (original header order); stray header rows are judged on the kept
    columns, and dropped before the max_rows cap counts them."""
    chunk_rows = chunk_rows or chunk_rows_setting()
    out_names = list(names)
    keep = None
    if columns is not None:
        wanted = set(columns)
        keep = [i for i, n in enumerate(names) if n in wanted]
        out_names = [names[i] for i in keep]
    remaining = max_rows
    for path in expand_paths(data_path):
        if path.endswith(PARQUET_SUFFIXES):
            for chunk in _iter_parquet_chunks(path, out_names, chunk_rows,
                                              missing_values):
                if remaining is not None:
                    if remaining <= 0:
                        return
                    if chunk.n_rows > remaining:
                        chunk = chunk.select_rows(slice(0, remaining))
                    remaining -= chunk.n_rows
                if chunk.n_rows:
                    yield chunk
            continue
        pending: List[List[np.ndarray]] = []
        n_pending = 0
        batches = iter_column_batches(path, len(names), delimiter, keep,
                                      chunk_rows)
        for batch in chain(batches, [None]):
            if batch is not None:
                pending.append(batch)
                n_pending += len(batch[0])
                if n_pending < chunk_rows:
                    continue
            if not pending:
                break
            cols = [np.concatenate([b[j] for b in pending])
                    for j in range(len(out_names))]
            n = len(cols[0])
            done = n if batch is None else n - n % chunk_rows
            pending = [[c[done:] for c in cols]] if done < n else []
            n_pending = n - done
            for a in range(0, done, chunk_rows):
                chunk = ColumnarData.from_columns(
                    [c[a:a + chunk_rows] for c in cols], out_names,
                    missing_values)
                if remaining is not None:
                    if remaining <= 0:
                        return
                    if chunk.n_rows > remaining:
                        chunk = chunk.select_rows(slice(0, remaining))
                    remaining -= chunk.n_rows
                if chunk.n_rows:
                    yield chunk


def chunk_source(
    data_path: str,
    names: List[str],
    delimiter: str = "|",
    missing_values: Sequence[str] = DEFAULT_MISSING,
    chunk_rows: Optional[int] = None,
    max_rows: Optional[int] = None,
    columns: Optional[Sequence[str]] = None,
) -> Callable[[], Iterator[ColumnarData]]:
    """A re-iterable chunk factory — multi-pass algorithms (two-pass stats)
    call it once per pass."""

    def factory() -> Iterator[ColumnarData]:
        return iter_columnar_chunks(
            data_path, names, delimiter, missing_values, chunk_rows,
            max_rows, columns,
        )

    return factory

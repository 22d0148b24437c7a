"""Chunked ingestion and the in-RAM/streamed route decision (counterpart
of `shifu_tpu/data/stream.py`).

The operational knobs are the JAX package's:
    shifu.ingest.chunkRows        rows per chunk (default 65536)
    shifu.ingest.memoryBudgetMB   datasets whose files exceed this budget
                                  take the streamed route (default 512)
    shifu.ingest.forceStreaming   true/1: always the streamed route

The port reads CSV/gzip chunks with its own reader (`data/reader.py`);
the streamed routes pull them through `data/pipeline.prefetch_iter`, in
order. Parquet (it needs pyarrow) and remote sources wait for ROADMAP
A.13: each raises naming it.
"""

from __future__ import annotations

from itertools import chain
from typing import Iterator, List, Optional, Sequence

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
            raise ShifuError(ErrorCode.DATA_NOT_FOUND,
                             f"{path}: parquet input is not ported yet "
                             "(ROADMAP A.13)")
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

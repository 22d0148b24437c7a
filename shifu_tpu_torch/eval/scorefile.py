"""The eval score file reader (replaces the JAX package's
`pd.read_csv(path, sep="|")` in `processor/evaluate.py`).

The score file is `tag|weight|mean|max|min|median|model0..` plus echoed meta
columns and `reasons`, one header line, `|`-separated. The rows go through
the port's reader (`data/reader.py`, pandas' row rules) and every number
through its numeric grammar (`data/tokens.py`, `pd.to_numeric` bit for
bit), so each column reads to the numbers `pd.read_csv` gives:
  * `tag` as int64; `weight` and the asked-for score columns as float64;
  * meta and `reasons` columns are skipped, never parsed;
  * rows with `tag < 0` are dropped (the perf and confusion steps' filter).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from shifu_tpu_torch.data.reader import iter_column_batches
from shifu_tpu_torch.data.tokens import to_numeric

SEP = "|"
# exact score-column names only: a scoreMetaColumns echo that happens to
# start with "model" must not be read as a score
SCORE_COLUMN = re.compile(r"^model\d+(_\d+)?$")


@dataclass
class ScoreTable:
    tag: np.ndarray  # [n] int64
    weight: np.ndarray  # [n] float64
    columns: Dict[str, np.ndarray]  # name -> [n] float64


def read_score_header(path: str) -> List[str]:
    with open(path, encoding="utf-8") as fh:
        return fh.readline().rstrip("\r\n").split(SEP)


def _raw_batches(path: str, columns: Sequence[str],
                 chunk_rows: Optional[int]):
    """(names, batches of string columns) of `tag`, `weight` and
    `columns` (names of the header)."""
    header = read_score_header(path)
    wanted = ["tag", "weight"] + [c for c in columns
                                  if c not in ("tag", "weight")]
    keep = [header.index(c) for c in wanted]

    def batches():
        first = True
        for batch in iter_column_batches(path, len(header), SEP, keep,
                                         chunk_rows):
            if first:  # the header line is the file's first row
                batch = [col[1:] for col in batch]
                first = False
            yield batch

    return wanted, batches()


def _table(wanted: List[str], cols: List[np.ndarray]) -> ScoreTable:
    vals = [to_numeric(c) for c in cols]
    tag = vals[0].astype(np.int64)
    ok = tag >= 0
    return ScoreTable(tag=tag[ok], weight=vals[1][ok],
                      columns={c: v[ok] for c, v in zip(wanted[2:],
                                                        vals[2:])})


def read_score_file(path: str, columns: Sequence[str]) -> ScoreTable:
    """`tag`, `weight` and `columns` (names of the header) of the rows with
    tag >= 0."""
    wanted, batches = _raw_batches(path, columns, None)
    parts = list(batches)
    return _table(wanted, [np.concatenate([p[j] for p in parts])
                           for j in range(len(wanted))])


def iter_score_tables(path: str, columns: Sequence[str],
                      chunk_rows: int) -> Iterator[ScoreTable]:
    """`read_score_file` a batch of at most about `chunk_rows` file rows
    at a time: the streamed sweep and confusion of a score file past the
    memory budget."""
    wanted, batches = _raw_batches(path, columns, chunk_rows)
    for batch in batches:
        yield _table(wanted, batch)

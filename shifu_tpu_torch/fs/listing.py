"""Deterministic directory listings and the data files of a data path.

`os.listdir`/`glob.glob` return entries in readdir order, which differs
per filesystem and per run; any listing whose order can reach bytes of an
artifact goes through these sorted helpers.

`expand_paths` and `dataset_size_bytes` are the local half of the JAX
package's `data/reader.py` `_expand_paths` and `data/stream.py`
`dataset_size_bytes`; scheme-ful sources (hdfs://, s3://, ...) are
ROADMAP A.13 and raise here.
"""

from __future__ import annotations

import glob as _glob
import os
from typing import List

from shifu_tpu_torch.utils.errors import ErrorCode, ShifuError


def sorted_glob(pattern: str, recursive: bool = False) -> List[str]:
    """glob.glob in deterministic (lexicographic) order."""
    return sorted(_glob.glob(pattern, recursive=recursive))


def check_local(path: str) -> None:
    """Remote sources are not ported: raise naming the ROADMAP item."""
    if "://" in path:
        raise ShifuError(ErrorCode.DATA_NOT_FOUND,
                         f"{path}: remote sources are not ported yet "
                         "(ROADMAP A.13)")


def is_data_file(path: str) -> bool:
    """Skip Hadoop markers (_SUCCESS, _temporary), dot-files, empty files."""
    base = os.path.basename(path)
    if base.startswith(".") or base.startswith("_"):
        return False
    return os.path.isfile(path) and os.path.getsize(path) > 0


def expand_paths(data_path: str) -> List[str]:
    """The data files of a data path: the file itself, the part files of
    a directory, or the files a glob matches, in sorted order."""
    check_local(data_path)
    if os.path.isdir(data_path):
        parts = [p for p in sorted_glob(os.path.join(data_path, "*"))
                 if is_data_file(p)]
        if not parts:
            raise ShifuError(ErrorCode.DATA_NOT_FOUND,
                             f"empty directory {data_path}")
        return parts
    if os.path.isfile(data_path):
        return [data_path]
    parts = [p for p in sorted_glob(data_path) if is_data_file(p)]
    if parts:
        return parts
    raise ShifuError(ErrorCode.DATA_NOT_FOUND, data_path)


def dataset_size_bytes(data_path: str) -> int:
    return sum(os.path.getsize(p) for p in expand_paths(data_path))

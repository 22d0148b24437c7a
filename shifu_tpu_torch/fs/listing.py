"""Deterministic directory listings.

`os.listdir`/`glob.glob` return entries in readdir order, which differs
per filesystem and per run; any listing whose order can reach bytes of an
artifact goes through these sorted helpers.
"""

from __future__ import annotations

import glob as _glob
from typing import List


def sorted_glob(pattern: str, recursive: bool = False) -> List[str]:
    """glob.glob in deterministic (lexicographic) order."""
    return sorted(_glob.glob(pattern, recursive=recursive))


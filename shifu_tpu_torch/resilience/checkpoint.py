"""Atomic artifact writes (counterpart of `shifu_tpu/resilience/checkpoint.py`,
its `atomic_write`, `atomic_write_json` and `atomic_save_npy` only).

A kill mid-write must leave either the previous complete file or the new
complete file, never a half-written one: write to a temp file in the same
directory, fsync, then `os.replace` (atomic on POSIX within a
filesystem). The fault-injection seam and the mid-stream stream
checkpoints of the JAX module wait for the port's resilience slice
(ROADMAP A.13).
"""

from __future__ import annotations

import io
import json
import os
import tempfile
from typing import Callable, Union

import numpy as np


def atomic_write(path: str,
                 data: Union[bytes, Callable[[io.BufferedWriter], None]],
                 ) -> str:
    """Write `data` (bytes, or a writer callable) to `path` atomically."""
    path = os.path.abspath(path)
    d = os.path.dirname(path)
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix="." + os.path.basename(path),
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as fh:
            if callable(data):
                data(fh)
            else:
                fh.write(data)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:  # already replaced or never created
            pass
        raise
    return path


def atomic_write_json(path: str, obj, indent: int = 2,
                      sort_keys: bool = True) -> str:
    return atomic_write(
        path, json.dumps(obj, indent=indent, sort_keys=sort_keys,
                         default=str).encode("utf-8"))


def atomic_save_npy(path: str, array: np.ndarray) -> str:
    """Atomic `np.save`: the trainers' checkpoint write."""
    buf = io.BytesIO()
    np.save(buf, np.asarray(array))
    return atomic_write(path, buf.getvalue())

"""Remote-source abstraction — the SourceType seam (counterpart of
`shifu_tpu/fs/source.py`).

The reference keys every path on SourceType {LOCAL, HDFS}
(container/obj/RawSourceData.java, util/HDFSUtils.java:35 cached
FileSystems, fs/ShifuFileUtils scanners). Here the seam is the URI
scheme: plain paths stay on the local filesystem (no indirection), while
`scheme://` paths route through fsspec — so `hdfs://`, `s3://`, `gs://`
sources work wherever the matching connector is installed, and fail with
a ShifuError naming the missing package or protocol where it is not.
`memory://` ships with fsspec and backs the tests. fsspec is imported
only on a `scheme://` path.

The port's reader opens a remote file through `open_source` and reads
its bytes as it reads a local file's (data/reader.py).
"""

from __future__ import annotations

from typing import List

from shifu_tpu_torch.utils.errors import ErrorCode, ShifuError


def is_remote(path: str) -> bool:
    """True for scheme-ful URIs (file:// counts — it routes through fsspec
    but reads local bytes)."""
    return "://" in path


def _fs_for(path: str):
    try:
        import fsspec
    except ImportError:
        raise ShifuError(
            ErrorCode.DATA_NOT_FOUND,
            f"{path}: remote sources need fsspec, which is not installed",
        )
    protocol = path.split("://", 1)[0]
    try:
        return fsspec.filesystem(protocol), protocol
    except (ImportError, ValueError) as e:
        raise ShifuError(
            ErrorCode.DATA_NOT_FOUND,
            f"{path}: no filesystem connector for '{protocol}://' "
            f"({e}); install the matching fsspec backend",
        )


def expand_remote(path: str) -> List[str]:
    """Part-file expansion for a remote data path (dir / glob / file),
    mirroring the local _expand_paths contract: skip dot/underscore marker
    files, error on empty."""
    fs, protocol = _fs_for(path)
    bare = path.split("://", 1)[1]

    def is_data(info) -> bool:
        name = info["name"].rsplit("/", 1)[-1]
        if name.startswith(".") or name.startswith("_"):
            return False
        return info.get("type") == "file" and info.get("size", 1) > 0

    if fs.isdir(bare):
        infos = fs.ls(bare, detail=True)
        parts = sorted(i["name"] for i in infos if is_data(i))
        if not parts:
            raise ShifuError(ErrorCode.DATA_NOT_FOUND,
                             f"empty remote directory {path}")
        return [f"{protocol}://{p}" for p in parts]
    if fs.exists(bare) and fs.isfile(bare):
        return [path]
    hits = sorted(fs.glob(bare))
    files = []
    for h in hits:
        name = h.rsplit("/", 1)[-1]
        if name.startswith(".") or name.startswith("_"):
            continue
        if fs.isfile(h):
            files.append(f"{protocol}://{h}")
    if files:
        return sorted(files)
    raise ShifuError(ErrorCode.DATA_NOT_FOUND, path)


def open_source(path: str, mode: str = "rb"):
    """Open a local path or fsspec URL uniformly."""
    if is_remote(path):
        _fs_for(path)  # a missing package or protocol names itself
        import fsspec

        return fsspec.open(path, mode).open()
    return open(path, mode)


def size_of(path: str) -> int:
    if is_remote(path):
        fs, _ = _fs_for(path)
        return int(fs.size(path.split("://", 1)[1]) or 0)
    import os

    return os.path.getsize(path)

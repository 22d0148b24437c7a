"""Remote sources and parquet input in the port (`shifu_tpu_torch/fs/
source.py`, the remote CSV reader, the parquet chunks of
`data/stream.py`) vs the JAX package, on the CPU.

fsspec's `memory://` and `file://` stand in for hdfs/s3/gs. The parquet
tokens are held against the JAX chunks (pandas `to_pandas()`,
`fillna("")`, `astype(str)`) for int, int with nulls, float32/float64
with and without nulls and NaN, bool, string, null-only and missing
columns, one record batch and several. A missing fsspec or pyarrow
(the card's machine has neither) is a ShifuError naming the package.
"""

import gzip
import os
import sys

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
fsspec = pytest.importorskip("fsspec")
pa = pytest.importorskip("pyarrow")
pq = pytest.importorskip("pyarrow.parquet")

from shifu_tpu.data import reader as jreader  # noqa: E402
from shifu_tpu.data import stream as jstream  # noqa: E402
from shifu_tpu.fs import source as jsource  # noqa: E402
from shifu_tpu_torch.data import reader as preader  # noqa: E402
from shifu_tpu_torch.data import stream as pstream  # noqa: E402
from shifu_tpu_torch.fs import listing as plisting  # noqa: E402
from shifu_tpu_torch.fs import source as psource  # noqa: E402
from shifu_tpu_torch.utils.errors import ShifuError  # noqa: E402

NAMES = ["id", "num", "cat", "flag"]
ROWS = ["1|0.5|a|Y", "2|1e3|b c|N", "3||a|", "4|-7|?|Y", "5|x|b|N",
        "id|num|cat|flag", "6|2.25|a|Y"]


def _same(jchunks, pchunks, names):
    assert len(jchunks) == len(pchunks)
    for j, p in zip(jchunks, pchunks):
        assert j.n_rows == p.n_rows
        for c in names:
            assert [str(v) for v in j.column(c)] == list(p.column(c)), c
            np.testing.assert_array_equal(j.missing_mask(c),
                                          p.missing_mask(c))


@pytest.fixture()
def memfs():
    fs = fsspec.filesystem("memory")
    root = f"/src{os.getpid()}"
    fs.mkdir(root)
    yield fs, root
    fs.rm(root, recursive=True)


def _put(fs, path, lines, gz=False):
    blob = ("\n".join(lines) + "\n").encode()
    with fs.open(path, "wb") as fh:
        fh.write(gzip.compress(blob) if gz else blob)


def test_memory_source_reads_like_jax(memfs):
    fs, root = memfs
    _put(fs, f"{root}/data/part-0", ROWS[:4])
    _put(fs, f"{root}/data/part-1.gz", ROWS[4:], gz=True)
    _put(fs, f"{root}/data/_SUCCESS", [""])
    _put(fs, f"{root}/header.txt", ["|".join(NAMES)])
    url = f"memory://{root}/data"
    assert psource.is_remote(url) and not psource.is_remote("/a/b")
    assert plisting.expand_paths(url) == jsource.expand_remote(url)
    assert [p.rsplit("/", 1)[1] for p in plisting.expand_paths(url)] == [
        "part-0", "part-1.gz"]
    assert plisting.expand_paths(f"memory://{root}/data/part-*") == \
        jsource.expand_remote(f"memory://{root}/data/part-*")
    assert pstream.dataset_size_bytes(url) == jstream.dataset_size_bytes(url)
    hdr = f"memory://{root}/header.txt"
    assert preader.read_header(hdr) == jreader.read_header(hdr) == NAMES
    for kw in (dict(chunk_rows=3), dict(chunk_rows=100, max_rows=5),
               dict(chunk_rows=2, columns=["num", "flag"])):
        names = kw.get("columns", NAMES)
        _same(list(jstream.iter_columnar_chunks(url, NAMES, **kw)),
              list(pstream.iter_columnar_chunks(url, NAMES, **kw)), names)
    j = jreader.read_columnar(url, NAMES)
    p = preader.read_columnar(url, NAMES)
    _same([j], [p], NAMES)
    with pytest.raises(ShifuError, match="empty remote directory"):
        fs.mkdir(f"{root}/empty")
        _put(fs, f"{root}/empty/_SUCCESS", [""])
        plisting.expand_paths(f"memory://{root}/empty")
    with pytest.raises(ShifuError):
        preader.read_header(f"memory://{root}/nope.txt")


def test_file_url_reads_like_a_local_path(tmp_path):
    path = tmp_path / "d.txt"
    path.write_text("\n".join(ROWS) + "\n")
    local = list(pstream.iter_columnar_chunks(str(path), NAMES,
                                              chunk_rows=4))
    url = f"file://{path}"
    remote = list(pstream.iter_columnar_chunks(url, NAMES, chunk_rows=4))
    _same(local, remote, NAMES)
    _same(list(jstream.iter_columnar_chunks(url, NAMES, chunk_rows=4)),
          remote, NAMES)
    assert psource.size_of(url) == os.path.getsize(path)
    with psource.open_source(url) as fh:
        assert fh.read() == path.read_bytes()


def _parquet_table():
    return pa.table({
        "i": pa.array([1, 2, 3, 40, 5, 6], pa.int64()),
        "in": pa.array([1, None, 3, 4, None, 6], pa.int64()),
        "i32": pa.array([1, 2, None, 4, 5, 6], pa.int32()),
        "f": pa.array([0.1, 1.0, 1e16, 2.5e-7, -3.0, 1 / 3], pa.float64()),
        "fn": pa.array([0.1, None, 3.0, float("nan"), 5.5, 6.0],
                       pa.float64()),
        "f32": pa.array([0.1, 1.0, 3.25, 7.0, 1e-3, 2.2], pa.float32()),
        "f32n": pa.array([0.1, None, 3.25, 7.0, 0.2, 0.3], pa.float32()),
        "b": pa.array([True, False, True, False, True, True]),
        "bn": pa.array([True, None, False, True, False, None]),
        "s": pa.array(["a", "b c", None, "", "é", "x|y"]),
        "z": pa.array([None] * 6, pa.null()),
    })


PQ_NAMES = ["i", "in", "i32", "f", "fn", "f32", "f32n", "b", "bn", "s",
            "z", "missing"]


@pytest.mark.parametrize("chunk_rows", [2, 3, 4, 100])
def test_parquet_tokens_match_jax(tmp_path, chunk_rows):
    path = str(tmp_path / "t.parquet")
    pq.write_table(_parquet_table(), path, row_group_size=4)
    kw = dict(chunk_rows=chunk_rows)
    _same(list(jstream.iter_columnar_chunks(path, PQ_NAMES, **kw)),
          list(pstream.iter_columnar_chunks(path, PQ_NAMES, **kw)),
          PQ_NAMES)
    sub = ["f32n", "missing", "in"]
    _same(list(jstream.iter_columnar_chunks(path, PQ_NAMES, columns=sub,
                                            max_rows=5, **kw)),
          list(pstream.iter_columnar_chunks(path, PQ_NAMES, columns=sub,
                                            max_rows=5, **kw)),
          [c for c in PQ_NAMES if c in sub])


def test_parquet_over_memory_and_in_a_directory(tmp_path, memfs):
    fs, root = memfs
    local = tmp_path / "pq"
    local.mkdir()
    pq.write_table(_parquet_table(), str(local / "a.parquet"))
    pq.write_table(_parquet_table().slice(2), str(local / "b.parq"))
    with fs.open(f"{root}/a.parquet", "wb") as fh:
        fh.write((local / "a.parquet").read_bytes())
    # a directory of parquet parts; a remote parquet file (the JAX package
    # hands pyarrow the URL, which knows no memory://: the JAX side reads
    # the same bytes locally)
    for path, jpath in ((str(local), str(local)),
                        (f"memory://{root}/a.parquet",
                         str(local / "a.parquet"))):
        _same(list(jstream.iter_columnar_chunks(jpath, PQ_NAMES,
                                                chunk_rows=3)),
              list(pstream.iter_columnar_chunks(path, PQ_NAMES,
                                                chunk_rows=3)),
              PQ_NAMES)
    # a stray header row in the data is dropped as in the CSV route
    t = pa.table({"a": ["a", "1", "2"], "b": ["b", "3", "4"]})
    pq.write_table(t, str(tmp_path / "h.parquet"))
    got = list(pstream.iter_columnar_chunks(str(tmp_path / "h.parquet"),
                                            ["a", "b"]))
    assert [list(c.column("a")) for c in got] == [["1", "2"]]


def test_missing_packages_name_themselves(tmp_path, monkeypatch):
    path = str(tmp_path / "t.parquet")
    pq.write_table(_parquet_table(), path)
    monkeypatch.setitem(sys.modules, "pyarrow.parquet", None)
    with pytest.raises(ShifuError, match="needs pyarrow"):
        list(pstream.iter_columnar_chunks(path, PQ_NAMES))
    monkeypatch.setitem(sys.modules, "fsspec", None)
    for call in (lambda: plisting.expand_paths("memory://x/y"),
                 lambda: preader.read_header("s3://bucket/h.txt"),
                 lambda: psource.size_of("gs://b/x"),
                 lambda: psource.open_source("memory://x/y")):
        with pytest.raises(ShifuError, match="need fsspec"):
            call()


def test_unknown_protocol_names_itself():
    for call in (psource.expand_remote, psource.size_of,
                 psource.open_source):
        with pytest.raises(ShifuError, match="'nosuchproto://'"):
            call("nosuchproto://h/x")
    with pytest.raises(Exception, match="nosuchproto"):
        jsource.expand_remote("nosuchproto://h/x")


def test_csv_ingest_imports_neither_pandas_nor_pyarrow(tmp_path):
    """The CSV route (local and remote) never imports pandas or pyarrow;
    only a parquet path imports pyarrow."""
    import subprocess

    path = tmp_path / "d.txt"
    path.write_text("\n".join(ROWS) + "\n")
    code = (
        "import sys\n"
        "from shifu_tpu_torch.data import stream\n"
        f"list(stream.iter_columnar_chunks({str(path)!r}, {NAMES!r}))\n"
        f"list(stream.iter_columnar_chunks('file://' + {str(path)!r}, "
        f"{NAMES!r}))\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('pandas', 'pyarrow', 'jax'))\n"
        "assert not bad, bad\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr

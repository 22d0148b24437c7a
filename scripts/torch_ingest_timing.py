"""Host seconds of the port's ingest on phase 7's raw file, with and
without the reader's fast path.

The file is `chip_smoke.py`'s `write_raw_set` (500,000 rows x 33 columns
of the bench `rf` width by default). Timed in one process:
  * `read_columnar` with the column-wise split of plain blocks
    (`data/reader.py` `_split_block`) and without it (every row through
    the stdlib csv reader), in turns (split, csv, csv, split), each run's
    columns held equal to the first's;
  * `to_numeric` over the 22 numeric columns (target, weight, 20
    features), twice.
Prints one JSON line: the seconds of every run and their medians.

    python3 scripts/torch_ingest_timing.py [--rows N] [--seed S]
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import shutil
import statistics
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from shifu_tpu_torch.data import reader, tokens  # noqa: E402


def _cpu() -> str:
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor()


def _no_split(*_a, **_k):
    return None


def _turns(run, fast, slow, same):
    """Seconds of run(fast), run(slow), run(slow), run(fast); `same`
    holds each output against the first fast run's."""
    secs = {"fast": [], "slow": []}
    first = None
    for name, variant in (("fast", fast), ("slow", slow), ("slow", slow),
                          ("fast", fast)):
        t = time.perf_counter()
        out = run(variant)
        secs[name].append(time.perf_counter() - t)
        if first is None:
            first = out
        else:
            same(first, out)
    return secs, first


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=chip_smoke.RAW["n"])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    root = tempfile.mkdtemp(prefix="ingest-timing-")
    try:
        size = chip_smoke.write_raw_set(root, args.seed, n=args.rows)
        path = os.path.join(root, "data", "data.txt")
        names = reader.read_header(os.path.join(root, "data", "header.txt"))

        split = reader._split_block

        def read(variant):
            reader._split_block = variant
            try:
                return reader.read_columnar(path, names)
            finally:
                reader._split_block = split

        def same_cols(a, b):
            for c in names:
                if not (a.column(c) == b.column(c)).all():
                    raise SystemExit(f"the readers differ in column {c}")

        read_s, data = _turns(read, split, _no_split, same_cols)

        cols = [c for c in names if c in ("label", "wt")
                or c.startswith("num_")]
        parse_s = []
        for _ in range(2):
            t = time.perf_counter()
            for c in cols:
                tokens.to_numeric(data.column(c))
            parse_s.append(time.perf_counter() - t)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    med = statistics.median
    print(json.dumps(dict(
        cpu=_cpu(), cpus=os.cpu_count(), rows=args.rows, file_bytes=size,
        read_columnar=dict(split_s=read_s["fast"], csv_s=read_s["slow"],
                           split_median_s=med(read_s["fast"]),
                           csv_median_s=med(read_s["slow"])),
        to_numeric=dict(columns=len(cols), seconds=parse_s))))
    return 0


if __name__ == "__main__":
    sys.exit(main())

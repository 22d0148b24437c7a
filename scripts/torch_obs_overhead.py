"""The obs layer's cost on the card: `train_trees` of the bench `gbt` and
`rf` forests with the profile seams on and off (`-Dshifu.profile.mode`)
in alternating pairs (on, off, then off, on, ...), a single seam's host
cost a dispatch against the plain call, and the host time each seam
spends recording. Prints one JSON line; needs a CUDA device.

    python3 scripts/torch_obs_overhead.py [--pairs 6] [--rows 500000]
        [--parent DIR]

`--parent DIR` also times the same forests against the package of
another checkout (a tree without the layer, unpacked into DIR): three
worker processes on the card, the parent's package, this one's, and
this one's with the layer off, asked in turn (the order rotating from
pair to pair) to train one forest and report its wall time; their
medians and quartiles go under `versus_parent`.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _train(torch, tt, args_, cfg, mode):
    from shifu_tpu_torch import obs
    from shifu_tpu_torch.utils import environment

    environment.set_property("shifu.profile.mode", mode)
    obs.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tt.train_trees(*args_, cfg, device="cuda")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    programs = obs.profiler().snapshot()["programs"]
    environment.set_property("shifu.profile.mode", "")
    return secs, sum(p["dispatches"] for p in programs.values())


def _per_call_us(torch, fn, n):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e6


def _forests(cs, tt, rows):
    """{name: (train_trees's positional arguments, config)}: the bench
    `gbt` and `rf` forests at `rows` rows."""
    import numpy as np

    cs.GBT["n"] = cs.RF["n"] = rows
    out = {}
    for name, (codes, y, slots, is_cat), cfg in (
            ("gbt", cs.gbt_data(0), tt.TreeTrainConfig(
                algorithm="GBT", tree_num=cs.GBT["trees"],
                max_depth=cs.GBT["depth"], learning_rate=0.1,
                valid_set_rate=0.1, seed=3)),
            ("rf", cs.rf_data(0), tt.TreeTrainConfig(
                algorithm="RF", tree_num=cs.RF["trees"],
                max_depth=cs.RF["depth"],
                feature_subset_strategy="TWOTHIRDS", valid_set_rate=0.1,
                seed=3))):
        out[name] = ((codes, y, np.ones(len(y), np.float32), slots, is_cat,
                      [f"f{i}" for i in range(len(slots))]), cfg)
    return out


def worker(root: str, rows: int, mode: str) -> int:
    """Train the forest named on each line of stdin with the package of
    checkout `root` (`mode` the profile mode, where it has one); answer
    each with its wall seconds (`ready` first, once the kernels are built
    and each forest ran once)."""
    import torch

    answer, sys.stdout = sys.stdout, sys.stderr  # stdout is the protocol
    sys.path.insert(0, REPO)
    import chip_smoke as cs  # the data: this checkout's, for both workers

    sys.path.insert(0, os.path.abspath(root))
    from shifu_tpu_torch.ops import build
    from shifu_tpu_torch.train import tree_trainer as tt

    assert tt.__file__.startswith(os.path.abspath(root)), tt.__file__
    if mode:
        from shifu_tpu_torch.utils import environment

        environment.set_property("shifu.profile.mode", mode)
    build.load("hist_level")
    forests = _forests(cs, tt, rows)

    def train(name):
        args_, cfg = forests[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tt.train_trees(*args_, cfg, device="cuda")
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for name in forests:
        train(name)  # warm: kernels, allocator
    print("ready", file=answer, flush=True)
    for line in sys.stdin:
        print(repr(train(line.strip())), file=answer, flush=True)
    return 0


def _quartiles(xs):
    q1, q2, q3 = statistics.quantiles(xs, n=4)
    return dict(runs_s=xs, median_s=q2, q1_s=q1, q3_s=q3)


def versus_parent(parent: str, rows: int, pairs: int) -> dict:
    """Rounds of the same forests trained by a worker on the parent
    checkout, one on this one and one on this one with the layer off,
    the order rotating from round to round."""
    roots = {"parent": (os.path.abspath(parent), ""), "change": (REPO, ""),
             "change_off": (REPO, "off")}
    procs = {k: subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", root,
         "--worker-mode", mode, "--rows", str(rows)],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        for k, (root, mode) in roots.items()}
    try:
        for k, p in procs.items():
            line = p.stdout.readline().strip()
            if line != "ready":
                raise RuntimeError(f"{k} worker did not start: {line!r}")
        times = {f: {k: [] for k in roots} for f in ("gbt", "rf")}
        names = list(roots)
        for i in range(pairs):
            order = names[i % 3:] + names[:i % 3]
            for forest in times:
                for k in order:
                    procs[k].stdin.write(forest + "\n")
                    procs[k].stdin.flush()
                    times[forest][k].append(float(procs[k].stdout.readline()))
    finally:
        for p in procs.values():
            p.stdin.close()
            p.wait(60)
    return {f: {k: _quartiles(v) for k, v in by.items()}
            for f, by in times.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=6)
    ap.add_argument("--rows", type=int, default=500_000)
    ap.add_argument("--parent", default=None)
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--worker-mode", default="", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_obs_overhead: no CUDA device", file=sys.stderr)
        return 2
    if args.worker:
        return worker(args.worker, args.rows, args.worker_mode)
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from shifu_tpu_torch.obs import profile
    from shifu_tpu_torch.ops import build
    from shifu_tpu_torch.train import tree_trainer as tt

    build.load("hist_level")
    out = dict(card=cs.card_line(), rows=args.rows)
    for name, (args_, cfg) in _forests(cs, tt, args.rows).items():
        _train(torch, tt, args_, cfg, "")  # warm: kernels, allocator
        on, off = [], []
        dispatches = 0
        for i in range(args.pairs):
            order = ("", "off") if i % 2 == 0 else ("off", "")
            for mode in order:
                secs, d = _train(torch, tt, args_, cfg, mode)
                (off if mode else on).append(secs)
                dispatches = max(dispatches, d)
        out[name] = dict(on_s=on, off_s=off,
                         on_median_s=statistics.median(on),
                         off_median_s=statistics.median(off),
                         dispatches_a_run=dispatches)
    x = torch.ones(1024, device="cuda")
    n = 20_000
    plain = _per_call_us(torch, lambda: torch.add(x, 1.0), n)
    seam = _per_call_us(torch, lambda: profile.dispatch(
        "t.add", torch.add, x, 1.0, sync=False), n)
    costed = _per_call_us(torch, lambda: profile.dispatch(
        "t.add", torch.add, x, 1.0, sync=False, cost=(1024.0, 8192.0)), n)
    out["dispatch_us"] = dict(plain=plain, seam=seam, seam_with_cost=costed)
    if args.parent:
        out["versus_parent"] = versus_parent(args.parent, args.rows,
                                             args.pairs)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

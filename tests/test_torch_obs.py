"""The port's obs layer (`shifu_tpu_torch/obs/`) against the JAX
package's `shifu_tpu/obs/`.

* The registry: the same sequence of operations, drawn from a numpy seed,
  gives an equal `snapshot()` and byte-equal `to_prometheus()` text in
  both packages; `parse_prometheus`, the JSON round trip, `StageTimers`,
  the spans and the `begin_run` depth semantics.
* The run manifest: its keys equal the JAX manifest's for the same step,
  with `runtime` in the place of the JAX `jax` section.
* Step parity: `init -> stats -> norm -> train (GBT, RF) -> eval -run`
  on `tests/helpers.make_model_set` in both packages (the JAX steps under
  `jax_inline_ingest()`, its `data_mesh` patched to None as the port's
  CPU train has no mesh): the integer counters of every step's manifest
  are equal in names and values, and so are the `host.*` / `shard.*` /
  `pipeline.chunks` counters of two hosts' streamed init (threads with
  explicit `host_plan=`).

The helpers at the top (`obs_scope`, `counts`, `host_counts`,
`port_hist_counters`) are the other port tests' way to read the port's
registry.
"""

import contextlib
import glob
import json
import os
import shutil
from typing import Dict, Optional

import numpy as np
import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

from shifu_tpu import obs as jobs  # noqa: E402
from shifu_tpu.obs import metrics as jmetrics  # noqa: E402
from shifu_tpu.obs import tracing as jtracing  # noqa: E402
from shifu_tpu_torch import obs  # noqa: E402
from shifu_tpu_torch.obs import metrics as pmetrics  # noqa: E402
from shifu_tpu_torch.obs import tracing as ptracing  # noqa: E402
from shifu_tpu_torch.obs.metrics import _parse_key  # noqa: E402
from shifu_tpu_torch.utils import timing  # noqa: E402


# ---- helpers shared with the other port tests ------------------------------

@contextlib.contextmanager
def obs_scope():
    """One port obs scope around several steps: the steps inside are
    nested runs, so they keep (and add to) this scope's registry."""
    obs.begin_run()
    try:
        yield obs.registry()
    finally:
        obs.end_run()


def counts(name: str, label: Optional[str],
           snap: Optional[dict] = None) -> Dict[str, float]:
    """{value of `label` (or "" when None or absent): summed count} of
    counter `name` in the port registry, or in a registry snapshot."""
    snap = obs.registry().snapshot() if snap is None else snap
    out: Dict[str, float] = {}
    for key, v in snap["counters"].items():
        n, labels = _parse_key(key)
        if n == name:
            k = labels.get(label, "") if label else ""
            out[k] = out.get(k, 0.0) + v
    return out


def host_counts(name: str, stage: str,
                snap: Optional[dict] = None) -> Dict[str, int]:
    """{host: count} of a `host.*` counter at one stage."""
    snap = obs.registry().snapshot() if snap is None else snap
    out: Dict[str, int] = {}
    for key, v in snap["counters"].items():
        n, labels = _parse_key(key)
        if n == name and labels.get("stage") == stage:
            out[labels["host"]] = int(v)
    return out


def port_hist_counters() -> Dict[str, int]:
    """The port's `tree.hist.*` counters, by suffix."""
    reg = obs.registry()
    return {k: int(reg.counter(f"tree.hist.{k}").value)
            for k in ("built", "derived", "fallback_rebuilds")}


# ---- the registry ------------------------------------------------------------

def _ops(reg, seed: int) -> None:
    """A seeded sequence of every kind of registry operation, labels with
    characters Prometheus must escape included."""
    rng = np.random.default_rng(seed)
    labels = [{}, {"eval": "Eval1"}, {"stage": 'a"b\\c'}, {"x": "1", "y": "2"}]
    buckets = (0.001, 0.01, 0.1, 1.0)
    for i in range(60):
        kind = int(rng.integers(0, 6))
        lab = labels[int(rng.integers(0, len(labels)))]
        name = f"m{int(rng.integers(0, 4))}.k"
        v = float(np.round(rng.random() * 3, 6))
        if kind == 0:
            reg.counter(name, **lab).inc(v)
        elif kind == 1:
            reg.gauge(name, **lab).set(v)
        elif kind == 2:
            reg.histogram(name + ".h", buckets=buckets, **lab).observe(
                v, exemplar=f"t{i}" if i % 7 == 0 else None)
        elif kind == 3:
            reg.timer(name + ".t", **lab).add(v, int(rng.integers(1, 4)))
        elif kind == 4:
            reg.series(name + ".s", **lab).append(i, v)
        else:
            reg.histogram(name + ".b", buckets=buckets, **lab).add_binned(
                [1, 0, 2, 0, 1], v, 4, 0.0005, 2.0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_snapshot_and_prometheus_equal_jax(seed):
    p, j = pmetrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    _ops(p, seed)
    _ops(j, seed)
    assert p.snapshot() == j.snapshot()
    assert p.to_prometheus().encode() == j.to_prometheus().encode()
    assert p.to_json() == j.to_json()
    assert p.flatten() == j.flatten()


@pytest.mark.parametrize("seed", [3, 4])
def test_parse_prometheus_and_json_round_trip(seed):
    p = pmetrics.MetricsRegistry()
    _ops(p, seed)
    text = p.to_prometheus()
    assert pmetrics.parse_prometheus(text) == p.flatten()
    assert pmetrics.parse_prometheus(text) == jmetrics.parse_prometheus(text)
    back = pmetrics.MetricsRegistry.from_json(p.to_json())
    assert back.snapshot() == p.snapshot()
    for q in (0.5, 0.99):
        for key, h in p.snapshot()["histograms"].items():
            assert pmetrics.Histogram.from_dict(h).quantile(q) == \
                jmetrics.Histogram.from_dict(h).quantile(q)


def test_stage_timers_match_jax():
    pr, jr = pmetrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    for reg in (pr, jr):
        st = reg.stage_timers("norm.stage")
        st.add("parse", 1.25, calls=3)
        st.add("device", 0.5)
        st.add("parse", 0.25)
    ps, js = pr.stage_timers("norm.stage"), jr.stage_timers("norm.stage")
    for reg_st in (ps, js):
        reg_st.seconds("parse")
    assert pr.snapshot() == jr.snapshot()
    bare = timing.StageTimers()
    with bare.timer("x"):
        pass
    assert bare.calls("x") == 1
    assert timing.StageTimers is pmetrics.StageTimers
    p2, j2 = pmetrics.StageTimers(), jmetrics.StageTimers()
    for t in (p2, j2):
        t.add("parse", 1.21, 12)
        t.add("device", 0.43, 12)
    assert p2.summary() == j2.summary() == \
        "parse 1.21s/12 | device 0.43s/12"
    assert p2.as_dict() == j2.as_dict()


def test_spans_nest_and_serialize_as_jax():
    def record(tr):
        with tr.span("step.stats", seq=1):
            with tr.span("stats.pass1", shards=2) as sp:
                sp["rows"] = 40
            with tr.span("stats.pass2", obj=object):
                pass
        return tr.to_chrome_trace()

    p, j = record(ptracing.Tracer()), record(jtracing.Tracer())
    strip = ("ts", "dur", "pid", "tid")
    assert [{k: v for k, v in e.items() if k not in strip}
            for e in p["traceEvents"]] == \
        [{k: v for k, v in e.items() if k not in strip}
         for e in j["traceEvents"]]
    inner = [e for e in p["traceEvents"] if e["name"] == "stats.pass1"][0]
    assert inner["args"] == {"shards": 2, "rows": 40,
                             "parent": "step.stats"}
    ring = ptracing.Tracer(max_events=2)
    with obs_scope():
        for i in range(3):
            with ring.span(f"s{i}"):
                pass
        assert counts("trace.dropped", None) == {"": 1}
    assert ring.dropped == 1
    assert [e["name"] for e in ring.events] == ["s1", "s2"]


def test_begin_run_depth_semantics():
    obs.reset()
    obs.registry().counter("before").inc()
    assert obs.begin_run() == 0  # the outermost run resets the scope
    reg = obs.registry()
    assert reg.is_empty()
    reg.counter("outer").inc()
    assert obs.begin_run() == 1  # a nested run keeps it
    assert obs.registry() is reg
    obs.registry().counter("inner").inc()
    obs.end_run()
    assert obs.registry() is reg
    assert set(reg.snapshot()["counters"]) == {"outer", "inner"}
    obs.end_run()
    obs.end_run()  # an extra end never goes below zero
    assert obs.begin_run() == 0
    assert obs.registry() is not reg
    obs.end_run()


# ---- the run manifest --------------------------------------------------------

def _manifests(root: str) -> Dict[str, dict]:
    out = {}
    for path in glob.glob(os.path.join(root, ".shifu", "runs", "*.json")):
        name = os.path.basename(path)
        if name.endswith(".trace.json") or name.endswith(".traces.json"):
            continue
        with open(path) as fh:
            m = json.load(fh)
        out[f"{m['step']}-{m['seq']}"] = m
    return out


# top-level manifest keys that differ by design: the port writes its
# torch/CUDA identity under `runtime` where the JAX manifest has `jax`
RUNTIME_KEYS = {"runtime", "jax"}
# profile fields that only an XLA program fills: the port keeps the keys
# (the same `shifu.profile/1` rows) and leaves them 0 / "analytic" or
# "unavailable"
XLA_ONLY_PROFILE_FIELDS = ("costSource", "compileSeconds",
                           "programsCompiled", "peakHbmBytes", "argBytes")
# counters that only the JAX package records: jaxprobe's XLA compile and
# trace counts, which have no counterpart in the port
JAXPROBE_COUNTERS = ("jax.compiles", "jax.traces")
# counters of the JAX heartbeat leases (`resilience/lease.py`), which the
# port has not yet (ROADMAP A.14.7): a lease thread that another test of
# the same worker process left running ticks them into whatever run is
# open, so they are not the step's
LEASE_COUNTERS = ("peer.lease.acquired", "peer.lease.renewals",
                  "peer.lease.swept", "peer.lease.expired")


def _set_eval_data(root: str) -> None:
    from shifu_tpu.config.model_config import ModelConfig as JModelConfig

    path = os.path.join(root, "ModelConfig.json")
    mc = JModelConfig.load(path)
    ev = mc.evals[0]
    ev.data_set.data_path = mc.data_set.data_path
    ev.data_set.header_path = mc.data_set.header_path
    mc.train.params.update(TreeNum=3, MaxDepth=3)
    mc.save(path)


def _lifecycle(root: str, package: str) -> Dict[str, dict]:
    """init -> stats -> norm -> train -> eval -run on `root`, in one
    package; the manifests by `<step>-<seq>`."""
    if package == "jax":
        from unittest import mock

        from shifu_tpu.processor.evaluate import EvalProcessor
        from shifu_tpu.processor.init import InitProcessor
        from shifu_tpu.processor.norm import NormProcessor
        from shifu_tpu.processor.stats import StatsProcessor
        from shifu_tpu.processor.train import TrainProcessor
        from tests.test_torch_config import jax_inline_ingest

        with jax_inline_ingest(), \
                mock.patch("shifu_tpu.parallel.mesh.data_mesh",
                           lambda *a, **k: None):
            for proc in (InitProcessor, StatsProcessor, NormProcessor,
                         TrainProcessor):
                assert proc(root).run() == 0
            assert EvalProcessor(root, run_name="").run() == 0
    else:
        from shifu_tpu_torch.processor.evaluate import EvalProcessor
        from shifu_tpu_torch.processor.init import InitProcessor
        from shifu_tpu_torch.processor.norm import NormProcessor
        from shifu_tpu_torch.processor.stats import StatsProcessor
        from shifu_tpu_torch.processor.train import TrainProcessor

        for proc in (InitProcessor, StatsProcessor, NormProcessor,
                     TrainProcessor):
            assert proc(root, device="cpu").run() == 0
        assert EvalProcessor(root, run_name="", device="cpu").run() == 0
    return _manifests(root)


@pytest.fixture(scope="module", params=["GBT", "RF"])
def lifecycles(request, tmp_path_factory):
    from tests.helpers import make_model_set

    base = tmp_path_factory.mktemp(f"obs_{request.param}")
    src = str(base / "src")
    make_model_set(src, n_rows=400, algorithm=request.param)
    _set_eval_data(src)
    out = {}
    # the profilers' annotations are process-global and survive a run's
    # reset on purpose; other tests of the worker process leave theirs
    with _no_annotations():
        for package in ("jax", "port"):
            root = str(base / package)
            shutil.copytree(src, root)
            out[package] = _lifecycle(root, package)
    return request.param, out


@contextlib.contextmanager
def _no_annotations():
    from shifu_tpu.obs import profile as jprofile
    from shifu_tpu_torch.obs import profile as pprofile

    saved = [(m._annotations_store, dict(m._annotations_store))
             for m in (jprofile, pprofile)]
    for store, _ in saved:
        store.clear()
    try:
        yield
    finally:
        for store, kept in saved:
            store.clear()
            store.update(kept)


def _integer_counters(m: dict) -> Dict[str, float]:
    out = {}
    for k, v in m["metrics"]["counters"].items():
        if _parse_key(k)[0] in JAXPROBE_COUNTERS + LEASE_COUNTERS:
            continue
        assert float(v).is_integer(), (k, v)
        out[k] = v
    return out


def test_step_counters_equal_jax(lifecycles):
    alg, runs = lifecycles
    steps = ["init-1", "stats-1", "norm-1", "train-1", "eval-1"]
    assert sorted(runs["jax"]) == sorted(runs["port"]) == sorted(steps)
    for step in steps:
        j, p = runs["jax"][step], runs["port"][step]
        assert _integer_counters(p) == _integer_counters(j), (alg, step)
        assert p["status"] == j["status"] == "ok"
        # the gauges and series are the same names (their values are
        # measured: AUC, errors; not held here)
        assert sorted(p["metrics"]["gauges"]) == \
            sorted(j["metrics"]["gauges"])
        assert sorted(p["metrics"]["series"]) == \
            sorted(j["metrics"]["series"])
    train = _integer_counters(runs["port"]["train-1"])
    assert train["tree.hist.built"] > 0 and train["tree.hist.derived"] > 0


def test_manifest_keys_equal_jax(lifecycles):
    _alg, runs = lifecycles
    for step, p in runs["port"].items():
        j = runs["jax"][step]
        assert set(p) - RUNTIME_KEYS == set(j) - RUNTIME_KEYS, step
        assert "runtime" in p and "jax" not in p
        assert set(p["runtime"]) == {"torch", "cuda", "deviceCount",
                                     "deviceName"}
        assert set(p["profile"]) == set(j["profile"]), step
        assert set(p["profile"]["totals"]) == set(j["profile"]["totals"])
        for row in p["profile"]["programs"].values():
            some_j = next(iter(j["profile"]["programs"].values()), None)
            if some_j is not None:
                assert set(row) == set(some_j), step
            assert row["costSource"] in ("analytic", "unavailable")
            assert row["programsCompiled"] == 0
    programs = runs["port"]["train-1"]["profile"]["programs"]
    for seam in ("tree.pallas_fused", "tree.split_scan"):
        assert programs[seam]["costSource"] == "analytic"
        assert programs[seam]["dispatches"] > 0
        assert programs[seam]["bytesAccessed"] > 0
    assert "tree.whole_tree" not in programs  # no whole-tree program
    for seam in ("tree.errors", "tree.row_update", "tree.hist_derive"):
        assert programs[seam]["dispatches"] > 0
        assert programs[seam]["synced"] is False


def test_failed_step_writes_a_failed_manifest(tmp_path):
    from shifu_tpu_torch.processor.stats import StatsProcessor

    root = str(tmp_path)
    with open(os.path.join(root, "ModelConfig.json"), "w") as fh:
        fh.write("{}")
    with pytest.raises(Exception):
        StatsProcessor(root, device="cpu").run()
    (m,) = _manifests(root).values()
    assert m["status"] == "failed" and m["exitStatus"] == 1
    assert m["error"]
    assert m["metrics"]["timers"]['step.elapsed{step="stats"}']["calls"] == 1


def test_two_hosts_counters_equal_jax(tmp_path):
    from shifu_tpu.data.pipeline import HostPlan as JHostPlan
    from shifu_tpu.processor.init import InitProcessor as JInit
    from shifu_tpu.utils import environment as jenv
    from shifu_tpu_torch.data.pipeline import HostPlan
    from shifu_tpu_torch.processor.init import InitProcessor
    from tests.test_torch_config import jax_inline_ingest
    from tests.test_torch_hosts import (STREAM, make_host_set, props,
                                        run_hosts)
    from shifu_tpu_torch.utils import environment as penv

    src = make_host_set(str(tmp_path / "src"))
    jroot, proot = str(tmp_path / "jax"), str(tmp_path / "port")
    shutil.copytree(src, jroot)
    shutil.copytree(src, proot)
    with props((jenv, penv), **STREAM), jax_inline_ingest():
        jobs.begin_run()
        try:
            run_hosts(lambda h: JInit(
                jroot, host_plan=JHostPlan(n_hosts=2, host_index=h)).run())
            jsnap = jobs.registry().snapshot()
        finally:
            jobs.end_run()
        with obs_scope() as reg:
            run_hosts(lambda h: InitProcessor(
                proot, device="cpu", host_plan=HostPlan(2, h)).run())
            psnap = reg.snapshot()

    def pick(snap):
        return {k: v for k, v in snap["counters"].items()
                if _parse_key(k)[0] in ("host.chunks", "host.rows",
                                         "shard.chunks", "shard.rows",
                                         "pipeline.chunks",
                                         "host.parts_published",
                                         "host.parts_merged")}

    assert pick(psnap) == pick(jsnap)
    assert host_counts("host.chunks", "init.autotype", psnap) == \
        {"0": 6, "1": 6}

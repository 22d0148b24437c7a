"""The port's program profiler (`shifu_tpu_torch/obs/profile.py`), cost
model and the analytic cost of the kernel entries, against the JAX
package where the two share behaviour.

* Dispatch counting, `scaled`, annotations surviving `reset`, mode
  `off` as a pass-through, and the sync contract: a `sync=True` seam
  synchronizes the card of its result, a `sync=False` seam never does.
* The `device` fault seam: a dispatch retried under a fault plan counts
  the same `fault.*` / `retry.*` counters as the JAX dispatch does for
  the same spec.
* `format_profile`, `diff_profiles`, `render_diff`,
  `diff_metric_snapshots` and `format_runs` print the JAX package's text
  for the same manifest dicts; the `profile` / `runs --diff` CLIs exit as
  the JAX CLI does.
* The cost model: the H100 row, detection on the CPU (nominal) and the
  `shifu.profile.peakTflops` / `peakGBs` overrides, and `derive` equal to
  the JAX function.
* The analytic cost of the histogram, fused and scan entries equals the
  bound counts of ops/hist_bounds.py, and a seam records it as
  `costSource: "analytic"`.
"""

import json
import os

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from shifu_tpu.obs import costmodel as jcostmodel  # noqa: E402
from shifu_tpu.obs import ledger as jledger  # noqa: E402
from shifu_tpu.obs import profile as jprofile  # noqa: E402
from shifu_tpu.utils import environment as jenv  # noqa: E402
from shifu_tpu_torch import obs  # noqa: E402
from shifu_tpu_torch.obs import costmodel, ledger, profile  # noqa: E402
from shifu_tpu_torch.ops import hist_bounds  # noqa: E402
from shifu_tpu_torch.resilience import faults  # noqa: E402
from shifu_tpu_torch.resilience.faults import FaultPlan  # noqa: E402
from shifu_tpu_torch.utils import environment as penv  # noqa: E402
from tests.test_torch_obs import counts, obs_scope  # noqa: E402


def _programs():
    return obs.profiler().snapshot()["programs"]


# ---- dispatch ------------------------------------------------------------------

def test_dispatch_counts_scale_and_cost():
    x = torch.arange(6, dtype=torch.float32)
    with obs_scope():
        for _ in range(3):
            out = profile.dispatch("t.plain", torch.mul, x, 2.0, sync=False)
        assert torch.equal(out, x * 2.0)
        with profile.scaled(4):
            profile.dispatch("t.cost", torch.add, x, 1.0,
                             cost=(100.0, 40.0))
        profile.dispatch("t.cost", torch.add, x, 1.0,
                         cost=lambda a, b: (float(a.numel()), 24.0))
        prog = profile.wrap("t.wrapped", torch.neg, sync=True)
        assert torch.equal(prog(x), -x)
        assert prog.__name__ == torch.neg.__name__  # attribute pass-through
        p = _programs()
    assert p["t.plain"]["dispatches"] == 3
    assert p["t.plain"]["costSource"] == "unavailable"
    assert p["t.plain"]["synced"] is False
    assert p["t.cost"]["dispatches"] == 2
    assert p["t.cost"]["scaledDispatches"] == 5.0
    assert p["t.cost"]["flops"] == 4 * 100.0 + 6.0
    assert p["t.cost"]["bytesAccessed"] == 4 * 40.0 + 24.0
    assert p["t.cost"]["costSource"] == "analytic"
    assert p["t.cost"]["arithmeticIntensity"] == round(406.0 / 184.0, 4)
    assert p["t.wrapped"]["synced"] is True
    for row in p.values():  # nothing is lowered or compiled per shape
        assert row["compileSeconds"] == 0.0
        assert row["programsCompiled"] == 0
        assert row["peakHbmBytes"] == 0.0


def test_annotations_survive_reset_and_mode_off_is_pass_through():
    profile.annotate("t.kernel", block=128)
    obs.reset()
    assert obs.profiler().snapshot()["annotations"]["t.kernel"] == \
        {"block": 128}
    penv.set_property("shifu.profile.mode", "off")
    try:
        with obs_scope():
            assert profile.dispatch("t.off", lambda v: v + 1, 1) == 2
            assert "t.off" not in _programs()
    finally:
        penv.set_property("shifu.profile.mode", "")


class _FakeCudaTensor:
    is_cuda = True
    device = "cuda:0"


@pytest.mark.parametrize("sync", [True, False])
def test_only_sync_seams_synchronize(monkeypatch, sync):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: calls.append(device))
    monkeypatch.setattr(profile, "_first_tensor",
                        lambda out: _FakeCudaTensor())
    with obs_scope():
        profile.dispatch("t.sync", lambda: None, sync=sync)
        synced = _programs()["t.sync"]["synced"]
    assert calls == (["cuda:0"] if sync else [])
    assert synced is sync


def test_sync_finds_the_tensor_of_a_carry():
    class Carry:
        def __init__(self):
            self.flat = torch.zeros(2)

    t = profile._first_tensor((1, {"a": Carry()}))
    assert isinstance(t, torch.Tensor) and not t.is_cuda


def test_device_seam_retried_like_jax():
    """`device@device=1`: the first dispatch of the step fails, the
    retry recovers; the counters are the JAX package's for the spec."""
    from shifu_tpu import obs as jobs
    from shifu_tpu.resilience import faults as jfaults

    spec = "device@device=1"
    with obs_scope():
        with faults.activate(FaultPlan.parse(spec)):
            out = profile.dispatch("t.dev", lambda v: v * 3, 2)
        got = {name: counts(name, "seam") for name in
               ("fault.injected", "fault.survived", "retry.attempts",
                "retry.recovered")}
        disp = _programs()["t.dev"]["dispatches"]
    assert out == 6 and disp == 1  # the failed attempt never dispatched
    jobs.begin_run()
    try:
        with jfaults.activate(jfaults.FaultPlan.parse(spec)):
            assert jprofile.dispatch("t.dev", lambda v: v * 3, 2,
                                     sync=False) == 6
        snap = jobs.registry().snapshot()["counters"]
    finally:
        jobs.end_run()
    want = {name: {k.split('seam="')[1].split('"')[0]: v
                   for k, v in snap.items() if k.startswith(name + "{")}
            for name in got}
    assert got == want
    assert got["fault.injected"] == {"device": 1}
    assert got["fault.survived"] == {"device": 1}


# ---- rendering and diffing ---------------------------------------------------------

def _manifest(step, seq, flops, seconds=1.0, dispatches=4, counters=None,
              source="analytic"):
    return {
        "schema": "shifu.run/1", "step": step, "seq": seq, "status": "ok",
        "startedAtUnix": 1000.0 + seq, "startedAt": "2026-10-17T10:00:0"
                                                    f"{seq}+00:00",
        "elapsedSeconds": 1.5 * seq,
        "metrics": {"counters": counters or {"stats.rows": 10 * seq},
                    "gauges": {"eval.auc": 0.75}, "series": {"s": []}},
        "traces": {"count": seq, "slowestMs": 12.5},
        "profile": {
            "schema": "shifu.profile/1",
            "chip": {"name": "NVIDIA H100 SXM", "peakTflops": 989.0,
                     "peakHbmGBs": 3350.0, "source": "table"},
            "programs": {
                "tree.hist": {
                    "dispatches": dispatches, "flops": flops,
                    "bytesAccessed": flops / 10.0, "peakHbmBytes": 0.0,
                    "compileSeconds": 0.0, "deviceSeconds": seconds,
                    "dispatchSeconds": seconds / 2, "synced": False,
                    "costSource": source, "achievedTflops": None,
                    "mfu": None, "arithmeticIntensity": 10.0,
                    "roofline": "memory-bound"},
                "tree.split_scan": {
                    "dispatches": 2, "flops": 1234.5,
                    "bytesAccessed": 999.0, "deviceSeconds": 0.25,
                    "synced": True, "costSource": source,
                    "achievedTflops": 0.1234, "mfu": 0.0001,
                    "arithmeticIntensity": 1.2357,
                    "roofline": "memory-bound"},
            },
            "totals": {"flops": flops, "dispatches": dispatches + 2,
                       "bytesAccessed": flops / 10.0,
                       "deviceSeconds": seconds, "compileSeconds": 0.0},
        },
    }


@pytest.mark.parametrize("flops_b", [1e9, 2e9, 5e3])
def test_rendering_and_diffs_print_the_jax_text(flops_b):
    a = _manifest("train", 1, 1e9)
    b = _manifest("train", 2, flops_b, dispatches=6,
                  counters={"stats.rows": 25, "pipeline.chunks": 3})
    assert profile.format_profile(b) == jprofile.format_profile(b)
    assert profile.diff_profiles(a, b) == jprofile.diff_profiles(a, b)
    rows, breaches = profile.diff_profiles(a, b)
    assert profile.render_diff("t", rows, breaches) == \
        jprofile.render_diff("t", rows, breaches)
    assert profile.diff_metric_snapshots(a, b) == \
        jprofile.diff_metric_snapshots(a, b)
    for show in (False, True):
        assert ledger.format_runs([b, a], show_traces=show) == \
            jledger.format_runs([b, a], show_traces=show)


def _write(root, m):
    runs = os.path.join(root, ".shifu", "runs")
    os.makedirs(runs, exist_ok=True)
    with open(os.path.join(runs, f"{m['step']}-{m['seq']}.json"), "w") as fh:
        json.dump(m, fh)


def test_profile_and_runs_cli_match_jax(tmp_path, monkeypatch, capsys):
    from shifu_tpu import cli as jcli
    from shifu_tpu_torch import cli

    root = str(tmp_path)
    _write(root, _manifest("train", 1, 1e9))
    _write(root, _manifest("train", 2, 2e9))  # 2x per dispatch
    monkeypatch.chdir(root)
    for argv, rc in ((["profile", "--diff", "train-1", "train-2"], 1),
                     (["profile", "--diff", "train-1", "train-2",
                       "--flops-pct", "150", "--bytes-pct", "150"], 0),
                     (["profile", "--diff", "train-1", "nope-9"], 2),
                     (["profile", "train"], 0),
                     (["profile", "--json"], 0),
                     (["runs"], 0),
                     (["runs", "--traces", "--last", "1"], 0),
                     (["runs", "--diff", "train-1", "train-2"], 0),
                     (["runs", "--json", "--step", "train"], 0)):
        assert cli.main(list(argv)) == rc, argv
        port_out = capsys.readouterr().out
        assert jcli.main(list(argv)) == rc, argv
        assert port_out == capsys.readouterr().out, argv


# ---- the cost model ----------------------------------------------------------------

def test_costmodel_h100_row_detection_and_overrides():
    h100 = costmodel.lookup("NVIDIA H100 80GB HBM3")
    assert h100 and (h100.peak_tflops, h100.peak_hbm_gbs) == (989.0, 3350.0)
    assert h100.source == "table"
    assert costmodel.lookup("TPU v5 lite") is None  # no TPU row
    assert costmodel.lookup("weird accelerator") is None
    peaks = costmodel.detect()  # no card here
    assert peaks.source == "nominal"
    assert (peaks.peak_tflops, peaks.peak_hbm_gbs) == (0.25, 25.0)
    penv.set_property("shifu.profile.peakTflops", "123.5")
    penv.set_property("shifu.profile.peakGBs", "456.0")
    try:
        over = costmodel.detect()
        assert (over.source, over.peak_tflops, over.peak_hbm_gbs) == \
            ("override", 123.5, 456.0)
    finally:
        penv.set_property("shifu.profile.peakTflops", "")
        penv.set_property("shifu.profile.peakGBs", "")
    assert costmodel.peaks_dict(h100)["machineBalance"] == \
        round(989e12 / 3350e9, 4)


@pytest.mark.parametrize("flops, n_bytes, secs", [
    (5e11, 1e10, 1.0), (100.0, 1000.0, None), (2e12, 1e9, 0.004),
    (None, 1e6, 1.0)])
def test_derive_and_verdict_equal_jax(flops, n_bytes, secs):
    p = costmodel.lookup("NVIDIA H100 80GB HBM3")
    j = jcostmodel.ChipPeaks(*p)
    assert costmodel.derive(flops, n_bytes, secs, p) == \
        jcostmodel.derive(flops, n_bytes, secs, j)
    if flops is not None:
        assert costmodel.roofline_verdict(flops, n_bytes, p) == \
            jcostmodel.roofline_verdict(flops, n_bytes, j)
    jenv.set_property("shifu.profile.peakTflops", "")


# ---- the analytic cost of the kernel entries --------------------------------------

def _level_inputs(n=300, K=0, seed=0):
    from shifu_tpu_torch.train import tree_trainer as tt

    rng = np.random.default_rng(seed)
    slots = [9, 17, 5]
    lay = tt.make_layout(slots, [False, True, False])
    codes = torch.as_tensor(np.stack(
        [rng.integers(0, s - 1, size=n) for s in slots], 1).astype(np.int32))
    y = torch.as_tensor((rng.integers(0, max(K, 2), size=n)).astype(
        np.float32))
    w = torch.ones(n)
    node = torch.as_tensor(rng.integers(0, 2, size=n).astype(np.int32))
    act = torch.ones(n, dtype=torch.bool)
    return lay, codes, y, w, node, act


@pytest.mark.parametrize("K, lowp", [(0, False), (0, True), (3, False)])
def test_entry_costs_equal_the_bound_counts(K, lowp):
    from shifu_tpu_torch.ops import hist_kernel as hk
    from shifu_tpu_torch.train import tree_trainer as tt

    lay, codes, y, w, node, act = _level_inputs(K=K)
    n, F, L = codes.shape[0], codes.shape[1], 2
    kw = dict(L=L, lay=lay, low_precision=lowp, n_classes=K)
    pb = 2 if lowp else 4
    if K >= 3:
        want_h = hist_bounds.class_level_counts(n, n, F, 4, K, L, lay.T,
                                                False)
        want_f = hist_bounds.class_level_counts(n, n, F, 4, K, L, lay.T,
                                                True)
    else:
        want_h = hist_bounds.level_counts(n, n, F, 4, pb, L, lay.T,
                                          lay.s_max, False)
        want_f = hist_bounds.level_counts(n, n, F, 4, pb, L, lay.T,
                                          lay.s_max, True)
    assert hist_bounds.hist_cost(codes, y, w, node, act, **kw) == want_h
    fok = torch.ones(lay.T, dtype=torch.bool)
    skw = dict(impurity="entropy" if K else "variance", min_inst=1,
               min_gain=0.0)
    assert hist_bounds.fused_cost(codes, y, w, node, act, fok, **kw,
                                  **skw) == want_f
    c8 = hk.codes8_of(codes, lay)
    assert hist_bounds.hist_cost(codes, y, w, node, act, codes8=c8,
                                 **kw)[1] < want_h[1]  # 1-byte codes
    with obs_scope():
        hist = tt._hist(hk.hist_level, codes, y, w, node, act, **kw)
        tt._scan(hist, fok, lay=lay, n_classes=K, **skw)
        p = _programs()
    assert p["tree.hist"]["costSource"] == "analytic"
    assert (p["tree.hist"]["flops"], p["tree.hist"]["bytesAccessed"]) == \
        want_h
    assert (p["tree.split_scan"]["flops"],
            p["tree.split_scan"]["bytesAccessed"]) == \
        hist_bounds.scan_counts(hist.shape[0], L, lay, K)
    assert p["tree.hist"]["synced"] is False


def test_bound_ms_picks_the_larger_time():
    ms, by = hist_bounds.bound_ms(0.0, hist_bounds.HBM_BYTES_PER_S / 1e3)
    assert (ms, by) == (1.0, "bytes")
    ms, by = hist_bounds.bound_ms(hist_bounds.F32_OPS_PER_S / 1e3, 1.0)
    assert (ms, by) == (1.0, "operations")

"""The port's `shifu stats` vs the JAX package's, on the CPU.

Tolerances:
  * `bin_aggregate`: counts exact; every field exact on integral values
    with unit weights; otherwise rtol 1e-4 (the JAX package's own
    single-vs-sharded tolerance, tests/test_stats.py) — the JAX sums are
    f32 in row order, the port's f64 rounded once.
  * `ColumnConfig.json` byte-identical on an integral-valued model set
    (integer values and weights: every sum exact on both sides), with
    -psi; on `make_model_set`'s floats every field equal but `mean` and
    `stdDev`, which are within rtol 1e-4.
  * -correlation: the same names, values within atol 1e-5 (the JAX
    matrix is f32 sums, the port's f64 sums rounded to f32, both printed
    at 6 decimals); -rebin byte-identical.
  * The slice: port init -> port stats -> JAX norm -> port train writes
    the same RF model file as JAX init -> JAX stats -> JAX norm -> port
    train; the all-port chain init -> stats -> norm -> varsel -> norm ->
    train writes the same RF model file as the JAX chain.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

pd = pytest.importorskip("pandas")
pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from shifu_tpu.config.model_config import ModelConfig as JModelConfig  # noqa: E402
from shifu_tpu.ops import binagg as jbinagg  # noqa: E402
from shifu_tpu.processor.norm import NormProcessor as JNormProcessor  # noqa: E402
from shifu_tpu.processor.stats import StatsProcessor as JStatsProcessor  # noqa: E402
from shifu_tpu.processor.train import TrainProcessor as JTrainProcessor  # noqa: E402
from shifu_tpu.processor.varsel import VarSelProcessor as JVarSelProcessor  # noqa: E402
from shifu_tpu.utils import environment as jenv  # noqa: E402
from shifu_tpu_torch.data.pipeline import HostPlan as pp_HostPlan  # noqa: E402
from shifu_tpu_torch.ops import binagg as pbinagg  # noqa: E402
from shifu_tpu_torch.processor.init import InitProcessor  # noqa: E402
from shifu_tpu_torch.processor.norm import NormProcessor  # noqa: E402
from shifu_tpu_torch.processor.stats import StatsProcessor  # noqa: E402
from shifu_tpu_torch.processor.train import TrainProcessor  # noqa: E402
from shifu_tpu_torch.processor.varsel import VarSelProcessor  # noqa: E402
from shifu_tpu_torch.stats import binning as pbinning  # noqa: E402
from shifu_tpu_torch.stats.correlation import load_correlation_csv  # noqa: E402
from shifu_tpu_torch.utils import environment as penv  # noqa: E402
from shifu_tpu_torch.utils.platform import DeviceUnavailable  # noqa: E402
from tests.helpers import make_model_set, write_dataset  # noqa: E402
from tests.test_torch_config import jax_inline_ingest  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


# ---- bin_aggregate --------------------------------------------------------

def _agg_inputs(seed, integral):
    rng = np.random.default_rng(seed)
    n, slots = 3000, [5, 12, 3, 40, 7, 2]
    codes = np.stack([rng.integers(0, s, size=n) for s in slots],
                     1).astype(np.int32)
    offsets = np.concatenate([[0], np.cumsum(slots[:-1])]).astype(np.int32)
    tags = rng.choice([-1, 0, 1, 2], size=n, p=[0.1, 0.5, 0.35, 0.05]
                      ).astype(np.int32)
    if integral:
        w = np.ones(n, np.float32)
        v = rng.integers(-50, 50, size=(n, 4)).astype(np.float32)
    else:
        w = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
        v = (rng.normal(size=(n, 4)) * [1, 10, 1e3, 1e-2]).astype(np.float32)
    v[rng.random(v.shape) < 0.05] = np.nan
    return codes, offsets, int(sum(slots)), tags, w, v


@pytest.mark.parametrize("integral", [True, False])
def test_bin_aggregate_matches_jax(integral):
    import jax.numpy as jnp

    codes, offsets, total, tags, w, v = _agg_inputs(4, integral)
    want = jbinagg.bin_aggregate(jnp.asarray(codes), jnp.asarray(offsets),
                                 total, jnp.asarray(tags), jnp.asarray(w),
                                 jnp.asarray(v))
    got = pbinagg.bin_aggregate(*(torch.from_numpy(a) for a in (
        codes, offsets)), total, *(torch.from_numpy(a) for a in (
            tags, w, v)))
    for name in pbinagg.BinAggregates._fields:
        a = np.asarray(getattr(want, name), dtype=np.float64)
        b = getattr(got, name).numpy().astype(np.float64)
        if name in ("pos", "neg", "vcount", "vmissing", "vmin", "vmax") \
                or integral:
            np.testing.assert_array_equal(b, a, err_msg=name)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-4, err_msg=name)
    assert got.pos.dtype == torch.int64 and got.wpos.dtype == torch.float32


def test_categorical_bins_tie_order_is_value_counts():
    """Descending count; ties in order of first appearance (value_counts
    sorts its counts with a stable sort), past 16 categories too."""
    rng = np.random.default_rng(0)
    pool = np.array([f" c{k} " for k in range(40)], dtype=object)
    raw = pool[rng.integers(0, 40, size=300)]
    miss = np.zeros(len(raw), dtype=bool)
    want = [str(c) for c in pd.Series(raw[~miss]).str.strip()
            .value_counts().index]
    assert pbinning.categorical_bins(raw, miss, 0) == want
    assert pbinning.categorical_bins(raw, miss, 7) == want[:7]


# ---- model sets -----------------------------------------------------------

def make_integral_set(root, n_rows=900, seed=9):
    """Integer values and weights, missing tokens, two categoricals and a
    12-value unit column (meta) for -psi."""
    rng = np.random.default_rng(seed)
    names = ["label"] + [f"n{j}" for j in range(5)] + ["c0", "c1", "wt",
                                                      "unit"]
    y = rng.random(n_rows) < 0.35
    rows = []
    for i in range(n_rows):
        r = ["P" if y[i] else "N"]
        for j in range(5):
            r.append("?" if rng.random() < 0.03 else
                     str(int(rng.integers(-20, 20) + 5 * y[i] * (j % 2))))
        r.append(["red", "green", "blue", "gray"][
            int(rng.integers(0, 4 - y[i]))])
        r.append("" if rng.random() < 0.05 else f"k{rng.integers(0, 6)}")
        r.append(str(int(rng.integers(1, 4))))
        r.append(f"2024-{i % 12 + 1:02d}")
        rows.append(r)
    make_model_set(root, n_rows=50)
    data_path, header_path = write_dataset(os.path.join(root, "ints"),
                                           names, rows)
    with open(os.path.join(root, "meta.names"), "w") as fh:
        fh.write("unit\n")
    path = os.path.join(root, "ModelConfig.json")
    mc = JModelConfig.load(path)
    mc.data_set.data_path = data_path
    mc.data_set.header_path = header_path
    mc.data_set.target_column_name = "label"
    mc.data_set.pos_tags = ["P"]
    mc.data_set.neg_tags = ["N"]
    mc.data_set.weight_column_name = "wt"
    mc.data_set.meta_column_name_file = "meta.names"
    mc.stats.psi_column_name = "unit"
    mc.save(path)
    return root


def _stats_both(src, base, **flags):
    """Port init on `src`, then copies under `base`/{jax,port} with the
    JAX and the port's stats step. Returns the two roots."""
    assert InitProcessor(src, device="cpu").run() == 0
    roots = []
    for side in ("jax", "port"):
        roots.append(os.path.join(base, side))
        shutil.copytree(src, roots[-1])
    with jax_inline_ingest():
        assert JStatsProcessor(roots[0], **flags).run() == 0
    assert StatsProcessor(roots[1], device="cpu", **flags).run() == 0
    return roots


@pytest.fixture(scope="module")
def stats_sets(tmp_path_factory):
    base = tmp_path_factory.mktemp("stats_sets")
    ints = make_integral_set(str(base / "ints" / "src"))
    floats = make_model_set(str(base / "floats" / "src"), n_rows=600)
    return {
        "ints": _stats_both(ints, str(base / "ints"), correlation=True,
                            psi=True),
        "floats": _stats_both(floats, str(base / "floats"),
                              correlation=True),
    }


def _bytes(root, rel):
    with open(os.path.join(root, rel), "rb") as fh:
        return fh.read()


def test_stats_byte_identical_on_integral_data(stats_sets):
    jroot, proot = stats_sets["ints"]
    assert _bytes(jroot, "ColumnConfig.json") == _bytes(proot,
                                                        "ColumnConfig.json")
    ccs = json.loads(_bytes(proot, "ColumnConfig.json"))
    stats = {c["columnName"]: c["columnStats"] for c in ccs}
    assert stats["n0"]["psi"] is not None and len(
        stats["n0"]["unitStats"]) == 12
    assert stats["c0"]["ks"] > 0


def _close(a, b, path=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif path.endswith((".mean", ".stdDev")) and isinstance(a, float):
        assert b == pytest.approx(a, rel=1e-4), path
    else:
        assert a == b, path


def test_stats_on_floats_within_rtol(stats_sets):
    jroot, proot = stats_sets["floats"]
    a = json.loads(_bytes(jroot, "ColumnConfig.json"))
    b = json.loads(_bytes(proot, "ColumnConfig.json"))
    _close(a, b)


@pytest.mark.parametrize("kind", ["ints", "floats"])
def test_correlation_matches_jax(stats_sets, kind):
    rel = os.path.join("tmp", "stats", "correlation.csv")
    jroot, proot = stats_sets[kind]
    want, wnames = load_correlation_csv(os.path.join(jroot, rel))
    got, gnames = load_correlation_csv(os.path.join(proot, rel))
    assert gnames == wnames and len(gnames) > 3
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_rebin_byte_identical(stats_sets, tmp_path):
    jsrc, _ = stats_sets["floats"]
    roots = [str(tmp_path / side) for side in ("jax", "port")]
    for r in roots:
        shutil.copytree(jsrc, r)
    key = "shifu.rebin.maxNumBin"
    try:
        jenv.set_property(key, "4")
        penv.set_property(key, "4")
        assert JStatsProcessor(roots[0], rebin=True).run() == 0
        assert StatsProcessor(roots[1], rebin=True, device="cpu").run() == 0
    finally:
        jenv._props.pop(key, None)
        penv._props.pop(key, None)
    got = _bytes(roots[1], "ColumnConfig.json")
    assert _bytes(roots[0], "ColumnConfig.json") == got
    assert got != _bytes(jsrc, "ColumnConfig.json")


# ---- the slice: init -> stats -> (JAX norm) -> train ----------------------

def test_slice_gives_the_same_rf_model(tmp_path):
    from shifu_tpu.processor.init import InitProcessor as JInitProcessor

    src = make_model_set(str(tmp_path / "src"), n_rows=500, algorithm="RF")
    path = os.path.join(src, "ModelConfig.json")
    mc = JModelConfig.load(path)
    mc.train.params.update(TreeNum=4, MaxDepth=5)
    mc.save(path)
    jroot, proot = str(tmp_path / "jax"), str(tmp_path / "port")
    shutil.copytree(src, jroot)
    shutil.copytree(src, proot)
    with jax_inline_ingest():
        assert JInitProcessor(jroot).run() == 0
        assert JStatsProcessor(jroot).run() == 0
    assert InitProcessor(proot, device="cpu").run() == 0
    assert StatsProcessor(proot, device="cpu").run() == 0
    with jax_inline_ingest():
        for root in (jroot, proot):
            assert JNormProcessor(root).run() == 0
    for root in (jroot, proot):
        assert TrainProcessor(root, device="cpu").run() == 0
    model = os.path.join("models", "model0.rf")
    assert _bytes(jroot, model) == _bytes(proot, model)


def test_all_port_chain_gives_the_jax_chains_rf_model(tmp_path):
    """init -> stats -> norm -> varsel -> norm -> train, each package's
    own steps: the varsel keeps 8 of 12 candidates by KS, and the second
    norm writes their codes only (ROADMAP A.9's milestone, without eval)."""
    from shifu_tpu.processor.init import InitProcessor as JInitProcessor

    src = make_model_set(str(tmp_path / "src"), n_rows=500, algorithm="RF")
    path = os.path.join(src, "ModelConfig.json")
    mc = JModelConfig.load(path)
    mc.train.params.update(TreeNum=4, MaxDepth=5)
    mc.var_select.filter_num = 8
    mc.save(path)
    jroot, proot = str(tmp_path / "jax"), str(tmp_path / "port")
    shutil.copytree(src, jroot)
    shutil.copytree(src, proot)
    with jax_inline_ingest():
        for step in (JInitProcessor, JStatsProcessor, JNormProcessor,
                     JVarSelProcessor, JNormProcessor, JTrainProcessor):
            assert step(jroot).run() == 0
    for step in (InitProcessor, StatsProcessor, NormProcessor,
                 VarSelProcessor, NormProcessor, TrainProcessor):
        assert step(proot, device="cpu").run() == 0
    # the same codes; the JAX package writes a shard a device (8 here)
    from shifu_tpu_torch.norm.dataset import load_codes

    (jm, *jarrays), (pm, *parrays) = (
        load_codes(os.path.join(r, "tmp", "norm", "CleanedData"))
        for r in (jroot, proot))
    assert len(pm.columns) == 8 and len(jm.shard_rows) == 8
    jm.shard_rows = pm.shard_rows
    assert jm.to_json() == pm.to_json()
    for a, b in zip(jarrays, parrays):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    model = os.path.join("models", "model0.rf")
    assert _bytes(jroot, model) == _bytes(proot, model)


# ---- entry points ---------------------------------------------------------

def test_stats_routes_that_wait_raise(stats_sets, tmp_path, monkeypatch):
    """A dataset past the budget takes the streamed route (sketch-based
    bins: the counts still sum to the rows); more than one host on the
    in-RAM route, or with -correlation, raises the JAX package's
    ValueError."""
    jroot, src = stats_sets["ints"]
    proot = str(tmp_path / "streamed")
    shutil.copytree(src, proot)
    penv.set_property("shifu.ingest.memoryBudgetMB", "0")
    try:
        proc = StatsProcessor(proot, device="cpu")
        assert proc.run() == 0
    finally:
        penv._props.pop("shifu.ingest.memoryBudgetMB", None)
    assert {"pass1", "pass2"} <= set(proc.timings)
    n0 = next(c for c in json.loads(_bytes(proot, "ColumnConfig.json"))
              if c["columnName"] == "n0")
    assert sum(n0["columnBinning"]["binCountPos"]) + sum(
        n0["columnBinning"]["binCountNeg"]) == n0["columnStats"][
            "totalCount"] > 0
    from shifu_tpu.data.pipeline import HostPlan as JHostPlan

    penv.set_property("shifu.lifecycle.hosts", "2")
    try:
        with pytest.raises(ValueError) as pe:
            StatsProcessor(proot, device="cpu").run()
    finally:
        penv._props.pop("shifu.lifecycle.hosts", None)
    jcopy = str(tmp_path / "jax-hosts")
    shutil.copytree(jroot, jcopy)
    with pytest.raises(ValueError) as je:
        JStatsProcessor(jcopy, host_plan=JHostPlan(2, 0)).run()
    assert str(pe.value) == str(je.value)
    assert "requires the streaming stats path" in str(pe.value)
    penv.set_property("shifu.ingest.memoryBudgetMB", "0")
    try:
        with pytest.raises(ValueError, match="not multi-host capable"):
            StatsProcessor(proot, correlation=True, device="cpu",
                           host_plan=pp_HostPlan(2, 0)).run()
    finally:
        penv._props.pop("shifu.ingest.memoryBudgetMB", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailable):
        StatsProcessor(proot)


def _cli(root, *args):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-m", "shifu_tpu_torch", *args],
                          cwd=root, env=env, capture_output=True, text=True,
                          timeout=300)


def test_cli_init_stats_and_norm(tmp_path):
    root = make_model_set(str(tmp_path / "cli"), n_rows=200)
    for args in (("init", "--device", "cpu"),
                 ("stats", "-correlation", "--device", "cpu")):
        proc = _cli(root, *args)
        assert proc.returncode == 0, proc.stderr
    assert os.path.isfile(os.path.join(root, "tmp", "stats",
                                       "correlation.csv"))
    for args in (("norm", "--device", "cpu"), ("varsel", "--device", "cpu")):
        proc = _cli(root, *args)
        assert proc.returncode == 0, proc.stderr
    assert os.path.isfile(os.path.join(root, "tmp", "norm", "CleanedData",
                                       "meta.json"))
    assert os.path.isfile(os.path.join(root, "tmp", "varsel",
                                       "ColumnConfig.json.prevarsel"))
    proc = _cli(root, "export", "-t", "columnstats")
    assert proc.returncode == 0, proc.stderr
    assert os.path.isfile(os.path.join(root, "export", "columnstats.csv"))
    # retrain needs a trained parent: no models yet is a ShifuError
    proc = _cli(root, "retrain", "--device", "cpu")
    assert proc.returncode == 1 and "shifu train" in proc.stderr
    if not torch.cuda.is_available():
        for cmd in ("init", "stats", "norm", "varsel", "eval", "retrain"):
            proc = _cli(root, cmd)
            assert proc.returncode == 1 and "CUDA" in proc.stderr

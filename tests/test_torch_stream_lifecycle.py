"""The port's streamed lifecycle (stats, norm, eval, and the whole slice
init -> stats -> norm -> train -> eval) against the JAX package's streamed
routes on the CPU.

Every step runs streamed on both sides (`shifu.ingest.forceStreaming`,
`shifu.train.forceStreaming`, `shifu.ingest.chunkRows` = 250: 6 chunks
of 1,500 rows), the JAX side with one lifecycle shard
(`shifu.lifecycle.shards=1`: its sketch merges across shards could move
a bin edge) and under `jax_inline_ingest()`. Contracts:
  * stats: ColumnConfig.json byte-identical on integral data (with -psi);
    on floats bins, counts, KS and IV equal and `mean`/`stdDev` within
    rtol 1e-6 (the JAX sums fold f32 windows, the port's f64);
    correlation within atol 1e-5, as in RAM;
  * norm: NormalizedData and CleanedData byte-identical (and with
    -shuffle, a permutation of the unshuffled rows);
  * eval: scores within 0.001, AUC within 1e-6, for the streamed score
    route and the streamed sweep / multi-class confusion;
  * a stats, norm or eval run stopped after some chunks by an exception,
    then `--resume`d, writes the bytes of an unbroken run;
  * the slice: the RF model file byte-identical, the eval AUC within
    1e-6; NN and WDL valid errors within the trainers' rel 1e-4.
"""

import contextlib
import json
import os
import shutil

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from shifu_tpu.config.model_config import ModelConfig as JModelConfig  # noqa: E402
from shifu_tpu.processor.evaluate import EvalProcessor as JEvalProcessor  # noqa: E402
from shifu_tpu.processor.init import InitProcessor as JInitProcessor  # noqa: E402
from shifu_tpu.processor.norm import NormProcessor as JNormProcessor  # noqa: E402
from shifu_tpu.processor.stats import StatsProcessor as JStatsProcessor  # noqa: E402
from shifu_tpu.processor.train import TrainProcessor as JTrainProcessor  # noqa: E402
from shifu_tpu.utils import environment as jenv  # noqa: E402
from shifu_tpu_torch import cli  # noqa: E402
from shifu_tpu_torch.processor import norm as pnorm_proc  # noqa: E402
from shifu_tpu_torch.processor.evaluate import EvalProcessor  # noqa: E402
from shifu_tpu_torch.processor.init import InitProcessor  # noqa: E402
from shifu_tpu_torch.processor.norm import NormProcessor  # noqa: E402
from shifu_tpu_torch.processor.stats import StatsProcessor  # noqa: E402
from shifu_tpu_torch.processor.train import TrainProcessor  # noqa: E402
from shifu_tpu_torch.stats.correlation import load_correlation_csv  # noqa: E402
from shifu_tpu_torch.utils import environment as penv  # noqa: E402
from tests.helpers import (make_binary_dataset, make_model_set,  # noqa: E402
                           write_dataset)
from tests.test_torch_config import jax_inline_ingest  # noqa: E402
from tests.test_torch_eval import (AUC_TOL, EVAL, SCORE_TOL,  # noqa: E402
                                   point_eval_at, score_rows)
from tests.test_torch_stats import make_integral_set  # noqa: E402

ROWS = 1500
CHUNK = 250
STREAM = {"shifu.ingest.forceStreaming": "true",
          "shifu.train.forceStreaming": "true",
          "shifu.ingest.chunkRows": str(CHUNK),
          "shifu.lifecycle.shards": "1"}
NORM = os.path.join("tmp", "norm")


@contextlib.contextmanager
def streamed(**extra):
    """The streaming knobs in both packages' properties, then cleared."""
    props = {**STREAM, **extra}
    for env in (jenv, penv):
        for k, v in props.items():
            env.set_property(k, v)
    try:
        yield
    finally:
        for env in (jenv, penv):
            for k in props:
                env._props.pop(k, None)


def _bytes(root, rel):
    with open(os.path.join(root, rel), "rb") as fh:
        return fh.read()


def _tree_bytes(d):
    return {f: _bytes(d, f) for f in sorted(os.listdir(d))}


def _copies(src, base, *names):
    out = []
    for name in names:
        out.append(os.path.join(base, name))
        shutil.copytree(src, out[-1])
    return out


def _init(src):
    with jax_inline_ingest():
        assert JInitProcessor(src).run() == 0
    return src


@pytest.fixture(scope="module")
def stats_sets(tmp_path_factory):
    """Each set initialized, then streamed stats on a JAX and a port copy:
    {kind: (jax root, port root)}."""
    base = str(tmp_path_factory.mktemp("stream_stats"))
    ints = _init(make_integral_set(os.path.join(base, "ints", "src"),
                                   n_rows=ROWS))
    floats = _init(make_model_set(os.path.join(base, "floats", "src"),
                                  n_rows=ROWS, algorithm="RF"))
    out = {}
    for kind, src, flags in (("ints", ints, dict(correlation=True,
                                                 psi=True)),
                             ("floats", floats, dict(correlation=True))):
        jroot, proot = _copies(src, os.path.join(base, kind), "jax", "port")
        with streamed(), jax_inline_ingest():
            assert JStatsProcessor(jroot, **flags).run() == 0
        with streamed():
            proc = StatsProcessor(proot, device="cpu", **flags)
            assert proc.run() == 0
        assert {"pass1", "bins", "pass2", "write_back"} <= set(proc.timings)
        out[kind] = (jroot, proot)
    return out


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
        assert b == pytest.approx(a, rel=1e-6), path
    else:
        assert a == b, path


def test_streamed_stats_match_jax(stats_sets):
    jroot, proot = stats_sets["ints"]
    assert _bytes(jroot, "ColumnConfig.json") == _bytes(proot,
                                                        "ColumnConfig.json")
    stats = {c["columnName"]: c["columnStats"]
             for c in json.loads(_bytes(proot, "ColumnConfig.json"))}
    assert len(stats["n0"]["unitStats"]) == 12 and stats["c0"]["ks"] > 0
    jroot, proot = stats_sets["floats"]
    _close(json.loads(_bytes(jroot, "ColumnConfig.json")),
           json.loads(_bytes(proot, "ColumnConfig.json")))


@pytest.mark.parametrize("kind", ["ints", "floats"])
def test_streamed_correlation_matches_jax(stats_sets, kind):
    rel = os.path.join("tmp", "stats", "correlation.csv")
    jroot, proot = stats_sets[kind]
    want, wnames = load_correlation_csv(os.path.join(jroot, rel))
    got, gnames = load_correlation_csv(os.path.join(proot, rel))
    assert gnames == wnames and len(gnames) > 3
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _fail_on_call(monkeypatch, owner, name, n):
    """`owner.name` raises on its n-th call (a preemption mid-stream)."""
    real = getattr(owner, name)
    calls = {"n": 0}

    def flaky(*a, **kw):
        calls["n"] += 1
        if calls["n"] == n:
            raise RuntimeError("preempted")
        return real(*a, **kw)

    monkeypatch.setattr(owner, name, flaky)


def test_streamed_stats_resume_bit_identical(stats_sets, tmp_path,
                                             monkeypatch):
    """Stopped in pass 2 (chunk 3 of 6), resumed: the same bytes."""
    from shifu_tpu_torch.stats import engine

    jroot, proot = stats_sets["ints"]
    (root,) = _copies(proot, str(tmp_path), "resume")
    _fail_on_call(monkeypatch, engine, "_prepare_rows", 6 + 3)
    with streamed(**{"shifu.ckpt.everyChunks": "2",
                     "shifu.ingest.prefetchChunks": "0"}):
        with pytest.raises(RuntimeError, match="preempted"):
            StatsProcessor(root, device="cpu", psi=True).run()
        monkeypatch.undo()
        assert os.path.isdir(os.path.join(root, ".shifu", "runs", "ckpt"))
        cwd = os.getcwd()
        os.chdir(root)
        try:
            assert cli.main(["stats", "-psi", "-correlation", "--resume",
                             "--device", "cpu"]) == 0
        finally:
            os.chdir(cwd)
    assert _bytes(root, "ColumnConfig.json") == _bytes(proot,
                                                       "ColumnConfig.json")
    assert os.listdir(os.path.join(root, ".shifu", "runs", "ckpt")) == []


@pytest.fixture(scope="module")
def norm_src(stats_sets):
    return stats_sets["floats"][1]


@pytest.mark.parametrize("shuffle", [False, True])
def test_streamed_norm_matches_jax(norm_src, tmp_path, monkeypatch,
                                   shuffle):
    import jax

    jroot, proot = _copies(norm_src, str(tmp_path), "jax", "port")
    # one bucket a device, as the JAX package counts its 8 CPU devices
    monkeypatch.setattr(pnorm_proc, "default_shards",
                        lambda device: len(jax.devices()))
    with streamed(), jax_inline_ingest():
        assert JNormProcessor(jroot, shuffle=shuffle).run() == 0
    with streamed():
        proc = NormProcessor(proot, shuffle=shuffle, device="cpu")
        assert proc.run() == 0
    for sub in ("NormalizedData", "CleanedData"):
        want = _tree_bytes(os.path.join(jroot, NORM, sub))
        got = _tree_bytes(os.path.join(proot, NORM, sub))
        assert sorted(got) == sorted(want) and len(want) >= 4
        for name in want:
            assert got[name] == want[name], (sub, name)
    if shuffle:  # the rows of the unshuffled norm, permuted
        from shifu_tpu_torch.norm.dataset import load_normalized

        (plain,) = _copies(norm_src, str(tmp_path), "plain")
        with streamed():
            assert NormProcessor(plain, device="cpu").run() == 0
        a = load_normalized(os.path.join(plain, NORM, "NormalizedData"))[1]
        b = load_normalized(os.path.join(proot, NORM, "NormalizedData"))[1]
        assert a.shape == b.shape and not np.array_equal(a, b)
        np.testing.assert_array_equal(np.unique(a, axis=0),
                                      np.unique(b, axis=0))


def test_streamed_norm_resume_byte_identical(norm_src, tmp_path,
                                             monkeypatch):
    from shifu_tpu_torch.norm import dataset as pds

    whole, root = _copies(norm_src, str(tmp_path), "whole", "resume")
    with streamed(**{"shifu.ckpt.everyChunks": "2"}):
        assert NormProcessor(whole, device="cpu").run() == 0
        _fail_on_call(monkeypatch, pds.ShardWriter, "add", 9)
        with pytest.raises(RuntimeError, match="preempted"):
            NormProcessor(root, device="cpu").run()
        monkeypatch.undo()
        penv.set_property("shifu.resume", "true")
        try:
            assert NormProcessor(root, device="cpu").run() == 0
        finally:
            penv._props.pop("shifu.resume", None)
    for sub in ("NormalizedData", "CleanedData"):
        assert _tree_bytes(os.path.join(root, NORM, sub)) == _tree_bytes(
            os.path.join(whole, NORM, sub))


def _held_out(base):
    names, rows, _ = make_binary_dataset(n_rows=ROWS, seed=19)
    return write_dataset(os.path.join(base, "heldout"), names, rows)


@pytest.fixture(scope="module")
def rf_set(stats_sets, tmp_path_factory):
    """The floats set normed and RF-trained streamed by the port, its eval
    set on held-out rows."""
    base = str(tmp_path_factory.mktemp("stream_rf"))
    (root,) = _copies(stats_sets["floats"][1], base, "rf")
    path = os.path.join(root, "ModelConfig.json")
    mc = JModelConfig.load(path)
    mc.train.params.update(TreeNum=3, MaxDepth=4)
    mc.save(path)
    point_eval_at(root, *_held_out(base))
    with streamed():
        for step in (NormProcessor, TrainProcessor):
            assert step(root, device="cpu").run() == 0
    return root


def _auc(root):
    with open(os.path.join(root, EVAL, "EvalPerformance.json")) as fh:
        return json.load(fh)["areaUnderRoc"]


def _assert_scores_close(jroot, proot):
    jh, jrows = score_rows(jroot)
    ph, prows = score_rows(proot)
    assert jh == ph and len(jrows) == len(prows) > CHUNK
    j = np.asarray([r[2:] for r in jrows], float)
    p = np.asarray([r[2:] for r in prows], float)
    assert [r[:2] for r in jrows] == [r[:2] for r in prows]
    np.testing.assert_allclose(p, j, atol=SCORE_TOL + 1e-9)


@pytest.mark.parametrize("sweep", [False, True])
def test_streamed_eval_matches_jax(rf_set, tmp_path, sweep):
    """The streamed score route, then the in-RAM perf (sweep False) or,
    with the budget at 0 MB, the streamed sweep over the score file."""
    jroot, proot = _copies(rf_set, str(tmp_path), "jax", "port")
    extra = {"shifu.ingest.memoryBudgetMB": "0"} if sweep else {}
    with streamed(**extra), jax_inline_ingest():
        assert JEvalProcessor(jroot, run_name="").run() == 0
    with streamed(**extra):
        proc = EvalProcessor(proot, run_name="", device="cpu")
        assert proc.run() == 0
    assert proc.metrics["Eval1"]["records"] == ROWS
    _assert_scores_close(jroot, proot)
    assert _auc(proot) == pytest.approx(_auc(jroot), abs=AUC_TOL)


def test_streamed_eval_resume_byte_identical(rf_set, tmp_path, monkeypatch):
    from shifu_tpu_torch.eval.scorer import ModelRunner

    whole, root = _copies(rf_set, str(tmp_path), "whole", "resume")
    with streamed(**{"shifu.ckpt.everyChunks": "2"}):
        assert EvalProcessor(whole, score_name="", device="cpu").run() == 0
        _fail_on_call(monkeypatch, ModelRunner, "score_raw", 4)
        with pytest.raises(RuntimeError, match="preempted"):
            EvalProcessor(root, score_name="", device="cpu").run()
        monkeypatch.undo()
        cwd = os.getcwd()
        os.chdir(root)
        try:
            assert cli.main(["eval", "-score", "--resume", "--device",
                             "cpu"]) == 0
        finally:
            os.chdir(cwd)
    rel = os.path.join(EVAL, "EvalScore.csv")
    assert _bytes(root, rel) == _bytes(whole, rel)


def test_streamed_multiclass_confusion_matches_jax(tmp_path):
    """NATIVE RF through the streamed score route and the streamed K x K
    confusion (score file past a 0 MB budget)."""
    from tests.test_torch_config import prepare_model_set

    src = prepare_model_set(str(tmp_path / "src"), "native", rows=600,
                            alg="RF", TreeNum=3, MaxDepth=4)
    with jax_inline_ingest():
        assert JTrainProcessor(src).run() == 0
    jroot, proot = _copies(src, str(tmp_path), "jax", "port")
    extra = {"shifu.ingest.memoryBudgetMB": "0"}
    with streamed(**extra), jax_inline_ingest():
        assert JEvalProcessor(jroot, run_name="").run() == 0
    with streamed(**extra):
        assert EvalProcessor(proot, run_name="", device="cpu").run() == 0
    _assert_scores_close(jroot, proot)
    for f in ("EvalPerformance.json", "EvalConfusionMatrix.csv"):
        assert _bytes(jroot, os.path.join(EVAL, f)) == _bytes(
            proot, os.path.join(EVAL, f)), f


def _alg_set(src, base, name, alg, **params):
    (root,) = _copies(src, base, name)
    path = os.path.join(root, "ModelConfig.json")
    mc = JModelConfig.load(path)
    mc.train.algorithm = type(mc.train.algorithm).parse(alg)
    mc.train.params.update(params)
    mc.train.num_train_epochs = 6
    mc.save(path)
    return root


def _assert_rf_files_equal(want: bytes, got: bytes) -> None:
    """The same bytes but the two error numbers of the JSON header, which
    agree within 1e-8: the JAX streamed trainer adds each shard's f32
    error sums (XLA's CPU reduction order) in f64, the port sums every
    row's errors as its in-memory trainer does."""
    import struct

    def split(data):
        (n,) = struct.unpack("<I", data[4:8])
        return data[:4], json.loads(data[8:8 + n]), data[8 + n:]

    (wm, wh, wt), (gm, gh, gt) = split(want), split(got)
    assert wm == gm and wt == gt  # magic, then every tree's arrays
    for k in ("trainError", "validError"):
        assert gh.pop(k) == pytest.approx(wh.pop(k), abs=1e-8), k
    assert gh == wh


def test_whole_slice_streamed_matches_jax(tmp_path, monkeypatch):
    """init -> stats -> norm -> train (RF, NN, WDL) -> eval -run, every
    step streamed, through each package's own steps (the JAX trainers on
    one device, as the port's: its 8-device mesh sums the valid errors in
    another order)."""
    from shifu_tpu.parallel import mesh as jmesh

    base = str(tmp_path)
    src = make_model_set(os.path.join(base, "src"), n_rows=ROWS,
                         algorithm="RF")
    point_eval_at(src, *_held_out(base))
    jroot, proot = _copies(src, base, "jax", "port")
    with streamed(), jax_inline_ingest():
        for step in (JInitProcessor, JStatsProcessor, JNormProcessor):
            assert step(jroot).run() == 0
    with streamed():
        for step in (InitProcessor, StatsProcessor, NormProcessor):
            assert step(proot, device="cpu").run() == 0
    results = {}
    for alg, params in (("RF", dict(TreeNum=3, MaxDepth=4)),
                        ("NN", dict(NumHiddenNodes=[6],
                                    ActivationFunc=["tanh"])),
                        ("WDL", dict(NumHiddenNodes=[6, 4],
                                     ActivationFunc=["relu", "tanh"],
                                     EmbedOutputs=3, LearningRate=0.05))):
        j = _alg_set(jroot, base, f"jax-{alg}", alg, **params)
        p = _alg_set(proot, base, f"port-{alg}", alg, **params)
        with streamed(), jax_inline_ingest(), monkeypatch.context() as m:
            m.setattr(jmesh, "data_mesh", lambda *a, **k: None)
            assert JTrainProcessor(j).run() == 0
        with streamed(), jax_inline_ingest():
            assert JEvalProcessor(j, run_name="").run() == 0
        with streamed():
            assert TrainProcessor(p, device="cpu").run() == 0
            assert EvalProcessor(p, run_name="", device="cpu").run() == 0
        results[alg] = (j, p)
    j, p = results["RF"]
    model = os.path.join("models", "model0.rf")
    _assert_rf_files_equal(_bytes(j, model), _bytes(p, model))
    assert _auc(p) == pytest.approx(_auc(j), abs=AUC_TOL)
    for alg in ("NN", "WDL"):
        j, p = results[alg]
        ve = [float(_bytes(r, os.path.join("tmp", "train",
                                           "val_error_0.txt")))
              for r in (j, p)]
        assert ve[1] == pytest.approx(ve[0], rel=1e-4, abs=1e-5), alg
        assert _auc(p) == pytest.approx(_auc(j), abs=1e-3), alg

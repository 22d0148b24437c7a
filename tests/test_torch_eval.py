"""The port's `shifu posttrain` and `shifu eval` vs the JAX package's, on
the CPU, on binary model sets.

One model set is prepared by the JAX init -> stats -> norm steps and
trained by the JAX trainer as NN (bagging 2), RF and GBT; both packages'
`PostTrainProcessor` then `EvalProcessor -run` run on copies of each, the
eval set on held-out rows with a weight column, meta columns and reason
codes. Gates:
  * score files: the same header and row count, the `tag` and `weight`
    columns byte-identical, each score within 0.001 (torch's exp/tanh and
    XLA's differ by ulps, and a score x 1000 on a rounding edge prints
    0.001 apart); the reasons column equal;
  * AUC and weighted AUC within 1e-6;
  * given the JAX score file, the port's `-perf` writes
    EvalPerformance.json, the confusion CSV and the gain chart
    byte-identical to the JAX run's;
  * posttrain: ColumnConfig.json byte-identical for trees, binAvgScore
    within 0.01 for NN (everything else equal); feature importances
    within rtol 1e-4;
  * `-new`, `-list`, `-delete` leave ModelConfig.json byte-identical,
    `-norm` writes NormalizedData byte-identical;
  * the CLI: `posttrain` and `eval` with `--device cpu` exit 0 (the
    streamed score route too, writing the same score file), without a
    card and without `--device` 1.
"""

import json
import os
import shutil

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from shifu_tpu.config.model_config import Algorithm as JAlgorithm  # noqa: E402
from shifu_tpu.config.model_config import ModelConfig as JModelConfig  # noqa: E402
from shifu_tpu.processor.evaluate import EvalProcessor as JEvalProcessor  # noqa: E402
from shifu_tpu.processor.posttrain import PostTrainProcessor as JPostTrainProcessor  # noqa: E402
from shifu_tpu.processor.train import TrainProcessor as JTrainProcessor  # noqa: E402
from shifu_tpu_torch import cli  # noqa: E402
from shifu_tpu_torch.processor.evaluate import EvalProcessor  # noqa: E402
from shifu_tpu_torch.processor.posttrain import PostTrainProcessor  # noqa: E402
from shifu_tpu_torch.utils import environment  # noqa: E402
from tests.helpers import make_binary_dataset, write_dataset  # noqa: E402
from tests.test_torch_config import (jax_inline_ingest,  # noqa: E402
                                     prepare_model_set)

SCORE_TOL = 0.001
AUC_TOL = 1e-6
BIN_AVG_TOL = 0.01
FI_RTOL = 1e-4
EVAL = os.path.join("evals", "Eval1")
PERF_FILES = ("EvalPerformance.json", "EvalConfusionMatrix.csv",
              "gainchart.html")

SETS = {
    "nn": dict(alg="NN"),
    "rf": dict(alg="RF", TreeNum=3, MaxDepth=4),
    "gbt": dict(alg="GBT", TreeNum=4, MaxDepth=3, LearningRate=0.3),
}


def point_eval_at(root, data, header, weight="", reasons=False):
    """Eval1 of `root` reads `data`; optionally a weight column, and the
    reason codes of a map of two columns."""
    path = os.path.join(root, "ModelConfig.json")
    mc = JModelConfig.load(path)
    ev = mc.evals[0]
    ev.data_set.data_path, ev.data_set.header_path = data, header
    ev.data_set.weight_column_name = weight
    if reasons:
        with open(os.path.join(root, "codes.txt"), "w") as fh:
            fh.write("num_0,R0\nnum_3,R3\ncat_0,RC\n")
        ev.custom_paths = {"reasonCodePath": "codes.txt"}
    mc.save(path)


def select(root, names):
    """Mark `names` finalSelect in ColumnConfig.json: the reason codes
    read the final-selected columns that posttrain scored."""
    path = os.path.join(root, "ColumnConfig.json")
    with open(path) as fh:
        ccs = json.load(fh)
    for cc in ccs:
        if cc["columnName"] in names:
            cc["finalSelect"] = True
    with open(path, "w") as fh:
        json.dump(ccs, fh, indent=2)


def run_both(src, base, name, posttrain=True):
    """Copies of `src`: JAX posttrain + eval -run, port posttrain + eval
    -run on the CPU; (jax root, port root, port eval processor)."""
    jroot, proot = str(base / f"{name}-jax"), str(base / f"{name}-port")
    shutil.copytree(src, jroot)
    shutil.copytree(src, proot)
    with jax_inline_ingest():
        if posttrain:
            assert JPostTrainProcessor(jroot).run() == 0
        assert JEvalProcessor(jroot, run_name="").run() == 0
    if posttrain:
        assert PostTrainProcessor(proot, device="cpu").run() == 0
    proc = EvalProcessor(proot, run_name="", device="cpu")
    assert proc.run() == 0
    return jroot, proot, proc


def read_bytes(root, rel):
    with open(os.path.join(root, rel), "rb") as fh:
        return fh.read()


def score_rows(root):
    with open(os.path.join(root, EVAL, "EvalScore.csv")) as fh:
        lines = fh.read().splitlines()
    return lines[0].split("|"), [ln.split("|") for ln in lines[1:]]


def assert_scores_close(jroot, proot):
    (jh, jrows), (ph, prows) = score_rows(jroot), score_rows(proot)
    assert jh == ph and len(jrows) == len(prows) > 0
    assert [r[:2] for r in jrows] == [r[:2] for r in prows]  # tag, weight
    scored = [i for i, c in enumerate(jh) if i >= 2 and (
        c in ("mean", "max", "min", "median") or c.startswith("model"))]
    a = np.array([[float(r[i]) for i in scored] for r in jrows])
    b = np.array([[float(r[i]) for i in scored] for r in prows])
    # a 0.001 step plus the printing's own half-unit slack
    np.testing.assert_allclose(b, a, rtol=0, atol=SCORE_TOL + 1e-9)
    rest = [i for i in range(2, len(jh)) if i not in scored]
    assert [[r[i] for i in rest] for r in jrows] == \
        [[r[i] for i in rest] for r in prows]
    return jh


def assert_posttrain_close(jroot, proot, exact):
    if exact:
        assert read_bytes(jroot, "ColumnConfig.json") == \
            read_bytes(proot, "ColumnConfig.json")
    else:
        ja, pa = (json.loads(read_bytes(r, "ColumnConfig.json"))
                  for r in (jroot, proot))
        assert len(ja) == len(pa)
        n_scored = 0
        for x, y in zip(ja, pa):
            xs = x["columnBinning"].pop("binAvgScore")
            ys = y["columnBinning"].pop("binAvgScore")
            assert x == y
            if xs is not None:
                n_scored += 1
                np.testing.assert_allclose(ys, xs, rtol=0,
                                           atol=BIN_AVG_TOL + 1e-9)
            else:
                assert ys is None
        assert n_scored > 0
    fi = os.path.join("tmp", "posttrain", "feature_importance.csv")
    j, p = (dict(ln.split(",") for ln in
                 read_bytes(r, fi).decode().splitlines()[1:])
            for r in (jroot, proot))
    assert j.keys() == p.keys() and len(j) > 0
    for k in j:
        np.testing.assert_allclose(float(p[k]), float(j[k]), rtol=FI_RTOL,
                                   atol=1e-12, err_msg=k)


@pytest.fixture(scope="module")
def base_set(tmp_path_factory):
    base = tmp_path_factory.mktemp("eval_base")
    src = prepare_model_set(str(base / "src"), "binary", rows=400, alg="NN")
    names, rows, _ = make_binary_dataset(n_rows=300, seed=99)
    rows += [["?"] + r[1:] for r in rows[:5]]  # invalid tags: tag -1
    data, header = write_dataset(str(base / "evaldata"), names, rows)
    point_eval_at(src, data, header, weight="num_2", reasons=True)
    return src


@pytest.fixture(scope="module")
def evaluated(base_set, tmp_path_factory):
    """name -> (jax root, port root, port eval processor)."""
    base = tmp_path_factory.mktemp("evaluated")
    out = {}
    for name, spec in SETS.items():
        spec = dict(spec)
        src = str(base / f"{name}-src")
        shutil.copytree(base_set, src)
        path = os.path.join(src, "ModelConfig.json")
        mc = JModelConfig.load(path)
        mc.train.algorithm = JAlgorithm.parse(spec.pop("alg"))
        if name == "nn":
            mc.train.bagging_num = 2
            mc.train.num_train_epochs = 15
        else:
            mc.train.params = spec
        mc.save(path)
        with jax_inline_ingest():
            assert JTrainProcessor(src).run() == 0
        select(src, ("num_0", "num_3", "cat_0"))
        out[name] = run_both(src, base, name)
    return out


@pytest.mark.parametrize("name", list(SETS))
def test_score_file_matches_jax(evaluated, name):
    jroot, proot, proc = evaluated[name]
    header = assert_scores_close(jroot, proot)
    n_models = 2 if name == "nn" else 1
    assert header == (["tag", "weight", "mean", "max", "min", "median"]
                      + [f"model{i}" for i in range(n_models)]
                      + ["reasons"])
    _, rows = score_rows(proot)
    assert sum(r[0] == "-1" for r in rows) == 5
    assert len({r[1] for r in rows}) > 10  # weights other than 1
    assert {r[-1] for r in rows} & {"R0^R3^RC", "R3^R0^RC", "RC^R0^R3"}
    m = proc.metrics["Eval1"]
    assert m["records"] == len(rows) and m["models"] == n_models
    assert {"read", "forward", "aggregate", "write", "perf"} <= set(
        proc.timings)


@pytest.mark.parametrize("name", list(SETS))
def test_auc_matches_jax(evaluated, name):
    jroot, proot, proc = evaluated[name]
    j, p = (json.loads(read_bytes(r, os.path.join(EVAL,
                                                  "EvalPerformance.json")))
            for r in (jroot, proot))
    for key in ("areaUnderRoc", "weightedAreaUnderRoc"):
        assert abs(p[key] - j[key]) <= AUC_TOL, key
    assert 0.5 < p["areaUnderRoc"] <= 1.0
    assert proc.metrics["Eval1"]["auc"] == p["areaUnderRoc"]


@pytest.mark.parametrize("name", list(SETS))
def test_perf_from_the_jax_score_file_byte_identical(evaluated, name,
                                                     tmp_path):
    jroot, _, _ = evaluated[name]
    root = str(tmp_path / "perf")
    shutil.copytree(jroot, root)
    for f in PERF_FILES:
        os.remove(os.path.join(root, EVAL, f))
    assert EvalProcessor(root, perf_name="", device="cpu").run() == 0
    for f in PERF_FILES:
        rel = os.path.join(EVAL, f)
        assert read_bytes(root, rel) == read_bytes(jroot, rel), f


@pytest.mark.parametrize("name", list(SETS))
def test_posttrain_matches_jax(evaluated, name):
    jroot, proot, _ = evaluated[name]
    assert_posttrain_close(jroot, proot, exact=name != "nn")


def test_reason_codes_match_jax(evaluated):
    from shifu_tpu.config import load_column_config_list as jload
    from shifu_tpu.data import reader as jreader
    from shifu_tpu.eval.reasoner import Reasoner as JReasoner
    from shifu_tpu.eval.reasoner import load_reason_code_map as jload_map
    from shifu_tpu_torch.config import load_column_config_list as pload
    from shifu_tpu_torch.data import reader as preader
    from shifu_tpu_torch.eval.reasoner import Reasoner, load_reason_code_map

    jroot, proot, _ = evaluated["rf"]
    mc = JModelConfig.load(os.path.join(proot, "ModelConfig.json"))
    ds = mc.evals[0].data_set
    codes = os.path.join(proot, "codes.txt")
    assert load_reason_code_map(codes) == jload_map(codes)
    jr = JReasoner(jload(os.path.join(jroot, "ColumnConfig.json")),
                   jload_map(codes), num_top_variables=3)
    pr = Reasoner(pload(os.path.join(proot, "ColumnConfig.json")),
                  load_reason_code_map(codes), num_top_variables=3)
    assert [c.column_name for c in pr.columns] == [
        c.column_name for c in jr.columns] and pr.columns
    names = preader.read_header(ds.header_path)
    want = jr.reason_codes(jreader.read_columnar(ds.data_path, names))
    got = pr.reason_codes(preader.read_columnar(ds.data_path, names))
    assert got == want and any(len(r) == 3 for r in got)
    with pytest.raises(Exception, match="A.13"):
        load_reason_code_map("hdfs://host/codes.txt")


def test_eval_set_management_and_norm(evaluated, tmp_path):
    jroot, proot, _ = evaluated["nn"]
    roots = {}
    for pkg, src in (("jax", jroot), ("port", proot)):
        roots[pkg] = str(tmp_path / pkg)
        shutil.copytree(src, roots[pkg])
    j, p = roots["jax"], roots["port"]
    steps = [dict(new_name="EvalX"), dict(list_sets=True),
             dict(norm_name="Eval1"), dict(delete_name="EvalX")]
    for kw in steps:
        with jax_inline_ingest():
            assert JEvalProcessor(j, **kw).run() == 0
        assert EvalProcessor(p, device="cpu", **kw).run() == 0
        assert read_bytes(j, "ModelConfig.json") == \
            read_bytes(p, "ModelConfig.json"), kw
        if "new_name" in kw:
            assert b"EvalX" in read_bytes(p, "ModelConfig.json")
    assert b"EvalX" not in read_bytes(p, "ModelConfig.json")
    norm = os.path.join(EVAL, "NormalizedData")
    names = sorted(os.listdir(os.path.join(j, norm)))
    assert names == sorted(os.listdir(os.path.join(p, norm)))
    assert "features-00000.npy" in names
    for f in names:
        assert read_bytes(j, os.path.join(norm, f)) == \
            read_bytes(p, os.path.join(norm, f)), f


def test_cli_posttrain_and_eval(evaluated, tmp_path, monkeypatch, capsys):
    _jroot, proot, _ = evaluated["gbt"]
    root = str(tmp_path / "cli")
    shutil.copytree(proot, root)
    shutil.rmtree(os.path.join(root, "evals"))
    monkeypatch.chdir(root)
    assert cli.main(["posttrain", "--device", "cpu"]) == 0
    assert cli.main(["eval", "-run", "--device", "cpu"]) == 0
    for f in ("EvalScore.csv",) + PERF_FILES:
        assert os.path.isfile(os.path.join(root, EVAL, f)), f
    assert read_bytes(root, os.path.join(EVAL, "EvalScore.csv")) == \
        read_bytes(proot, os.path.join(EVAL, "EvalScore.csv"))
    # the streamed score route writes the in-RAM route's score file
    try:
        assert cli.main(["eval", "-score", "--device", "cpu",
                         "-Dshifu.ingest.forceStreaming=true"]) == 0
    finally:
        environment.set_property("shifu.ingest.forceStreaming", "")
    assert read_bytes(root, os.path.join(EVAL, "EvalScore.csv")) == \
        read_bytes(proot, os.path.join(EVAL, "EvalScore.csv"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["posttrain"]) == 1
    assert cli.main(["eval"]) == 1
    assert "CUDA" in capsys.readouterr().err

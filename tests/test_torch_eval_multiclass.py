"""The port's `shifu posttrain` + `shifu eval` vs the JAX package's on
multi-class model sets, and the whole lifecycle in each package.

* A NATIVE RF set (3 classes, gini) and a ONEVSALL GBT set, made as
  `tests/test_torch_train_step.py` makes them (JAX init -> stats -> norm,
  then the JAX trainer), evaluated on held-out rows by both packages on
  copies: score files as in `tests/test_torch_eval.py` (tag and weight
  byte-identical, scores within 0.001), the confusion matrix file and
  EvalPerformance.json (matrix, accuracy, priors) byte-identical, and so
  is `-perf` from the JAX score file. Posttrain on ONEVSALL: ColumnConfig.json
  byte-identical, feature importances within rtol 1e-4; on NATIVE RF, whose
  votes are a column a class, both packages' posttrain refuse the
  per-class score matrix alike (the JAX `np.add.at` takes one score a
  row), so that set is evaluated without it.
* The lifecycle init -> stats -> norm -> varsel -> norm -> train ->
  posttrain -> eval, all in the port against all in the JAX package: the
  AUC within 1e-6 (the RF forests are bit-equal, so it is equal).
"""

import json
import os
import shutil

import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

from shifu_tpu.config.model_config import ModelConfig as JModelConfig  # noqa: E402
from shifu_tpu.processor.evaluate import EvalProcessor as JEvalProcessor  # noqa: E402
from shifu_tpu.processor.posttrain import PostTrainProcessor as JPostTrainProcessor  # noqa: E402
from shifu_tpu.processor.train import TrainProcessor as JTrainProcessor  # noqa: E402
from shifu_tpu_torch.processor.evaluate import EvalProcessor  # noqa: E402
from tests.helpers import (make_binary_dataset,  # noqa: E402
                           make_model_set, make_multiclass_dataset,
                           write_dataset)
from tests.test_torch_config import (jax_inline_ingest,  # noqa: E402
                                     prepare_model_set)
from tests.test_torch_eval import (AUC_TOL, EVAL, PERF_FILES,  # noqa: E402
                                   assert_posttrain_close,
                                   assert_scores_close, point_eval_at,
                                   read_bytes, run_both)

SETS = {
    "native_rf": dict(kind="native", rows=700, alg="RF", TreeNum=5,
                      MaxDepth=5, Impurity="gini"),
    "onevsall_gbt": dict(kind="onevsall", rows=600, alg="GBT", TreeNum=3,
                         MaxDepth=3, LearningRate=0.2),
}


@pytest.fixture(scope="module")
def evaluated(tmp_path_factory):
    base = tmp_path_factory.mktemp("multi")
    names, rows, _ = make_multiclass_dataset(n_rows=300, seed=12)
    rows += [["none"] + r[1:] for r in rows[:4]]  # not a class: tag -1
    data, header = write_dataset(str(base / "evaldata"), names, rows)
    out = {}
    for name, spec in SETS.items():
        spec = dict(spec)
        kind, n = spec.pop("kind"), spec.pop("rows")
        src = prepare_model_set(str(base / f"{name}-src"), kind, rows=n,
                                **spec)
        point_eval_at(src, data, header, weight="num_1")
        with jax_inline_ingest():
            assert JTrainProcessor(src).run() == 0
        out[name] = run_both(src, base, name,
                             posttrain=name != "native_rf")
    return out


@pytest.mark.parametrize("name", list(SETS))
def test_multiclass_eval_matches_jax(evaluated, name):
    jroot, proot, proc = evaluated[name]
    header = assert_scores_close(jroot, proot)
    if name == "native_rf":  # one model, a column a class
        assert header[6:] == ["model0_0", "model0_1", "model0_2"]
    else:  # a binary model a class
        assert header[6:] == ["model0", "model1", "model2"]
    for f in ("EvalConfusionMatrix.csv", "EvalPerformance.json"):
        rel = os.path.join(EVAL, f)
        assert read_bytes(jroot, rel) == read_bytes(proot, rel), f
    perf = json.loads(read_bytes(proot, os.path.join(
        EVAL, "EvalPerformance.json")))
    assert perf["classes"] == ["low", "mid", "high"]
    assert 0.5 < perf["accuracy"] <= 1.0
    assert proc.metrics["Eval1"]["accuracy"] == perf["accuracy"]


@pytest.mark.parametrize("name", list(SETS))
def test_multiclass_confmat_from_the_jax_score_file(evaluated, name,
                                                    tmp_path):
    jroot, _, _ = evaluated[name]
    root = str(tmp_path / "cm")
    shutil.copytree(jroot, root)
    for f in ("EvalConfusionMatrix.csv", "EvalPerformance.json"):
        os.remove(os.path.join(root, EVAL, f))
    assert EvalProcessor(root, confmat_name="Eval1",
                         device="cpu").run() == 0
    for f in ("EvalConfusionMatrix.csv", "EvalPerformance.json"):
        rel = os.path.join(EVAL, f)
        assert read_bytes(root, rel) == read_bytes(jroot, rel), f
    assert not os.path.exists(os.path.join(root, EVAL, PERF_FILES[2]))


def test_multiclass_posttrain_matches_jax(evaluated):
    jroot, proot, _ = evaluated["onevsall_gbt"]
    assert_posttrain_close(jroot, proot, exact=True)


def test_native_posttrain_refused_alike(evaluated, tmp_path):
    from shifu_tpu_torch.processor.posttrain import PostTrainProcessor

    jroot, proot, _ = evaluated["native_rf"]
    for pkg, src, proc in (("jax", jroot, JPostTrainProcessor),
                           ("port", proot, PostTrainProcessor)):
        root = str(tmp_path / pkg)
        shutil.copytree(src, root)
        kw = {"device": "cpu"} if pkg == "port" else {}
        with pytest.raises(ValueError, match="broadcast"):
            proc(root, **kw).run()


def test_whole_lifecycle_auc_matches_jax(tmp_path):
    """Each package's own steps from raw text to the eval: the same AUC."""
    from shifu_tpu.processor.init import InitProcessor as JInit
    from shifu_tpu.processor.norm import NormProcessor as JNorm
    from shifu_tpu.processor.stats import StatsProcessor as JStats
    from shifu_tpu.processor.varsel import VarSelProcessor as JVarSel
    from shifu_tpu_torch.processor.init import InitProcessor
    from shifu_tpu_torch.processor.norm import NormProcessor
    from shifu_tpu_torch.processor.posttrain import PostTrainProcessor
    from shifu_tpu_torch.processor.stats import StatsProcessor
    from shifu_tpu_torch.processor.train import TrainProcessor
    from shifu_tpu_torch.processor.varsel import VarSelProcessor

    src = make_model_set(str(tmp_path / "src"), n_rows=500, algorithm="RF")
    names, rows, _ = make_binary_dataset(n_rows=400, seed=21)
    data, header = write_dataset(str(tmp_path / "evaldata"), names, rows)
    point_eval_at(src, data, header)
    path = os.path.join(src, "ModelConfig.json")
    mc = JModelConfig.load(path)
    mc.train.params.update(TreeNum=4, MaxDepth=5)
    mc.var_select.filter_num = 8
    mc.save(path)
    jroot, proot = str(tmp_path / "jax"), str(tmp_path / "port")
    shutil.copytree(src, jroot)
    shutil.copytree(src, proot)
    with jax_inline_ingest():
        for step in (JInit, JStats, JNorm, JVarSel, JNorm, JTrainProcessor,
                     JPostTrainProcessor):
            assert step(jroot).run() == 0
        assert JEvalProcessor(jroot, run_name="").run() == 0
    for step in (InitProcessor, StatsProcessor, NormProcessor,
                 VarSelProcessor, NormProcessor, TrainProcessor,
                 PostTrainProcessor):
        assert step(proot, device="cpu").run() == 0
    assert EvalProcessor(proot, run_name="", device="cpu").run() == 0
    j, p = (json.loads(read_bytes(r, os.path.join(EVAL,
                                                  "EvalPerformance.json")))
            for r in (jroot, proot))
    for key in ("areaUnderRoc", "weightedAreaUnderRoc"):
        assert abs(p[key] - j[key]) <= AUC_TOL, key
    assert p["areaUnderRoc"] > 0.7
    assert read_bytes(jroot, os.path.join(EVAL, "EvalScore.csv")) == \
        read_bytes(proot, os.path.join(EVAL, "EvalScore.csv"))

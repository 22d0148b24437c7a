"""The port's `shifu train`, `eval` and `posttrain` for WDL vs the JAX
package's.

A WDL model set from `tests/helpers` (600 binary rows, 10 numeric and 2
categorical columns) goes through the JAX init -> stats -> norm steps
once per module; then the JAX `TrainProcessor` and the port's
`TrainProcessor(device="cpu")` train on copies of the same directory for
single, bagging 3, a LearningRate grid, k-fold 3 and continuous. The JAX
step trains on its 8-device virtual mesh (rows padded with zero
significance), the port on one device, so sums run in another order.
Tolerance: the NN slice's (tests/test_torch_train_nn_step.py:9-13): the
model files' headers equal but for the two errors, errors rel 1e-4 / abs
1e-5 (val-error and progress files too, at the same epochs), weights
rtol 2e-3 / atol 2e-4. `eval -run` of one set gives the JAX AUC within
1e-6. The JAX posttrain raises on a WDL set (ROADMAP C.11); the port's
binAvgScore equals the JAX models' own scores binned the same way.
"""

import json
import os
import re
import shutil

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from shifu_tpu.models import wdl as jwdl  # noqa: E402
from shifu_tpu.processor.train import TrainProcessor as JTrainProcessor  # noqa: E402
from shifu_tpu_torch import cli  # noqa: E402
from shifu_tpu_torch.models import wdl as pwdl  # noqa: E402
from shifu_tpu_torch.processor.train import TrainProcessor  # noqa: E402
from shifu_tpu_torch.utils import environment  # noqa: E402
from tests.test_torch_config import (jax_inline_ingest,  # noqa: E402
                                     prepare_model_set)

ERR = dict(rel=1e-4, abs=1e-5)
W_TOL = dict(rtol=2e-3, atol=2e-4)
PARAMS = {"NumHiddenNodes": [8], "ActivationFunc": ["relu"],
          "EmbedOutputs": 3, "LearningRate": 0.01, "Optimizer": "ADAM",
          "L2Reg": 0.0}

# edits of ModelConfig.json's train section
CASES = {
    "single": dict(numTrainEpochs=12),
    "bagging_3": dict(numTrainEpochs=10, baggingNum=3,
                      baggingSampleRate=0.8),
    "grid": dict(numTrainEpochs=8,
                 params=dict(PARAMS, LearningRate=[0.003, 0.03])),
    "k_fold": dict(numTrainEpochs=8, numKFold=3),
}


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    base = tmp_path_factory.mktemp("wdl_sets")
    return prepare_model_set(str(base / "binary"), "binary", rows=600,
                             alg="WDL", **PARAMS)


def _edit(root, train):
    path = os.path.join(root, "ModelConfig.json")
    with open(path) as fh:
        blob = json.load(fh)
    params = train.pop("params", None)
    blob["train"].update(train)
    if params is not None:
        blob["train"]["params"] = params
    with open(path, "w") as fh:
        json.dump(blob, fh, indent=2)


def _pair(prepared, tmp_path, train):
    roots = [str(tmp_path / side) for side in ("jax", "port")]
    for r in roots:
        shutil.copytree(prepared, r)
        _edit(r, dict(train))
    return roots


def _run(roots):
    with jax_inline_ingest():
        assert JTrainProcessor(roots[0]).run() == 0
    assert TrainProcessor(roots[1], device="cpu").run() == 0


def _numbers(path):
    with open(path) as fh:
        return [[float(x) for x in re.findall(
            r"[-+]?\d+(?:\.\d+)?(?:e[-+]?\d+)?", ln)] for ln in fh]


def _compare(roots):
    """Every model file, val-error and progress file of the two runs."""
    models = [sorted(os.listdir(os.path.join(r, "models"))) for r in roots]
    assert models[0] == models[1] and models[0]
    for name in models[0]:
        a = jwdl.WDLModelSpec.load(os.path.join(roots[0], "models", name))
        b = pwdl.WDLModelSpec.load(os.path.join(roots[1], "models", name))
        ha, hb = _header(a), b.header()
        for key in ("trainError", "validError"):
            assert hb.pop(key) == pytest.approx(ha.pop(key), **ERR)
        assert hb == ha
        np.testing.assert_allclose(pwdl.flatten_wdl(b.params),
                                   jwdl.flatten_wdl(a.params), **W_TOL)
    train = [sorted(f for f in os.listdir(os.path.join(r, "tmp", "train"))
                    if f.endswith((".txt", ".log"))) for r in roots]
    assert train[0] == train[1]
    for name in train[0]:
        got, want = (_numbers(os.path.join(r, "tmp", "train", name))
                     for r in (roots[1], roots[0]))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g[:2] == w[:2] if name.endswith(".log") else True
            assert g == pytest.approx(w, **ERR)
    return models[0]


def _header(spec) -> dict:
    """The JAX spec's header, as its `save` writes it."""
    return pwdl.WDLModelSpec(
        **{k: getattr(spec, k) for k in (
            "hidden", "activations", "embed_dim", "dense_columns",
            "cat_columns", "vocab_sizes", "norm_specs", "norm_cutoff",
            "categories", "norm_type", "train_error", "valid_error")},
        params=pwdl.params_from_jax(spec.params)).header()


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches_jax(prepared, tmp_path, case):
    roots = _pair(prepared, tmp_path, CASES[case])
    _run(roots)
    names = _compare(roots)
    n_models = {"bagging_3": 3, "k_fold": 3}.get(case, 1)
    assert names == [f"model{i}.wdl" for i in range(n_models)]
    spec = pwdl.WDLModelSpec.load(os.path.join(roots[1], "models",
                                               names[0]))
    assert spec.cat_columns == ["cat_0", "cat_1"]
    assert len(spec.dense_columns) == 10
    if case == "grid":  # the best trial's rate trains the final model
        with open(os.path.join(roots[1], "ModelConfig.json")) as fh:
            assert isinstance(json.load(fh)["train"]["params"][
                "LearningRate"], list)


def test_continuous_resume_matches_jax(prepared, tmp_path):
    roots = _pair(prepared, tmp_path, CASES["single"])
    _run(roots)
    for r in roots:
        _edit(r, dict(isContinuous=True, numTrainEpochs=4))
    # both resume from the JAX run's first model
    shutil.copy(os.path.join(roots[0], "models", "model0.wdl"),
                os.path.join(roots[1], "models", "model0.wdl"))
    _run(roots)
    _compare(roots)


def _eval_ready(root):
    """Point Eval1 at the training file (as tests/test_wdl.py does)."""
    path = os.path.join(root, "ModelConfig.json")
    with open(path) as fh:
        blob = json.load(fh)
    ds = blob["evals"][0]["dataSet"]
    ds["dataPath"] = blob["dataSet"]["dataPath"]
    ds["headerPath"] = blob["dataSet"]["headerPath"]
    with open(path, "w") as fh:
        json.dump(blob, fh, indent=2)


def test_eval_and_posttrain_score_wdl(prepared, tmp_path):
    """`eval -run` on the JAX-trained bagging set: the port's AUC within
    1e-6 of the JAX package's, the score files within 1e-5 relative.
    posttrain: the JAX step raises on a WDL set; the port's binAvgScore
    is the JAX models' scores of the training rows binned by code."""
    from shifu_tpu.processor.evaluate import EvalProcessor as JEval
    from shifu_tpu.processor.posttrain import PostTrainProcessor as JPost
    from shifu_tpu_torch.norm.dataset import load_codes, load_normalized
    from shifu_tpu_torch.processor.evaluate import EvalProcessor
    from shifu_tpu_torch.processor.posttrain import PostTrainProcessor

    roots = _pair(prepared, tmp_path, CASES["bagging_3"])
    with jax_inline_ingest():
        assert JTrainProcessor(roots[0]).run() == 0
    shutil.copytree(os.path.join(roots[0], "models"),
                    os.path.join(roots[1], "models"))
    for r in roots:
        _eval_ready(r)
    with jax_inline_ingest():
        assert JEval(roots[0], run_name="").run() == 0
    assert EvalProcessor(roots[1], run_name="", device="cpu").run() == 0
    perf = []
    for r in roots:
        with open(os.path.join(r, "evals", "Eval1",
                               "EvalPerformance.json")) as fh:
            perf.append(json.load(fh)["areaUnderRoc"])
    assert abs(perf[1] - perf[0]) <= 1e-6 and perf[1] > 0.7
    scores = [np.loadtxt(os.path.join(r, "evals", "Eval1", "EvalScore.csv"),
                         delimiter="|", skiprows=1, usecols=range(2, 9))
              for r in roots]
    np.testing.assert_allclose(scores[1], scores[0], rtol=1e-5, atol=1e-3)

    with pytest.raises(NotImplementedError, match="dense, codes"):
        JPost(roots[0]).run()
    assert PostTrainProcessor(roots[1], device="cpu").run() == 0
    norm = os.path.join(roots[1], "tmp", "norm")
    nmeta, feats, _, _ = load_normalized(os.path.join(norm,
                                                      "NormalizedData"))
    cmeta, codes, _, _ = load_codes(os.path.join(norm, "CleanedData"))
    cols = []
    for i in range(3):
        spec = jwdl.WDLModelSpec.load(
            os.path.join(roots[0], "models", f"model{i}.wdl"))
        cols.append(spec.independent().compute_parts(
            feats[:, [nmeta.columns.index(c) for c in spec.dense_columns]],
            codes[:, [cmeta.columns.index(c) for c in spec.cat_columns]])
            * 1000.0)
    mean = np.stack(cols, axis=1).mean(axis=1)
    with open(os.path.join(roots[1], "ColumnConfig.json")) as fh:
        ccs = {c["columnName"]: c for c in json.load(fh)}
    for j, name in enumerate(cmeta.columns):
        got = ccs[name]["columnBinning"]["binAvgScore"]
        sums = np.bincount(codes[:, j], weights=mean, minlength=len(got))
        cnt = np.bincount(codes[:, j], minlength=len(got))
        want = np.where(cnt > 0, sums / np.maximum(cnt, 1), 0.0)
        np.testing.assert_allclose(got, want, atol=0.011)


def test_cli_routes_that_wait(prepared, tmp_path, monkeypatch):
    """`python -m shifu_tpu_torch train --device cpu` writes the files,
    the streamed route (forceStreaming, trainOnDisk) too; the
    co-resident route raises naming A.14."""
    root = str(tmp_path / "port")
    shutil.copytree(prepared, root)
    _edit(root, dict(numTrainEpochs=3))
    monkeypatch.chdir(root)
    assert cli.main(["train", "--device", "cpu"]) == 0
    for name in ("progress_0.log", "val_error_0.txt"):
        assert os.path.isfile(os.path.join(root, "tmp", "train", name))
    model = os.path.join(root, "models", "model0.wdl")
    assert os.path.isfile(model)
    os.remove(model)
    try:
        assert cli.main(["train", "--device", "cpu",
                         "-Dshifu.train.forceStreaming=true"]) == 0
    finally:
        environment.set_property("shifu.train.forceStreaming", "")
    assert os.path.isfile(model)
    os.remove(model)
    _edit(root, dict(trainOnDisk=True))
    assert cli.main(["train", "--device", "cpu"]) == 0
    assert os.path.isfile(model)
    _edit(root, dict(trainOnDisk=False))
    proc = TrainProcessor(root, device="cpu")
    proc.coresident_cfg = object()
    with pytest.raises(NotImplementedError, match="A.14"):
        proc.run()

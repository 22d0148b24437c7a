"""The port's `shifu train` step for NN/LR/SVM vs the JAX package's.

Model sets from `tests/helpers` (600 binary rows; 600 three-class rows
for ONEVSALL and NATIVE) go through the JAX init -> stats -> norm steps
once per module; then the JAX `TrainProcessor` and the port's
`TrainProcessor(device="cpu")` train on copies of the same directory.
The JAX step trains on an 8-device virtual mesh (rows padded with zero
significance), the port on one device, so sums run in another order.
Tolerance: the JAX package's bagged-vs-serial one
(tests/test_train_nn.py:247-253): the model files' headers equal but for
the two errors, errors rel 1e-4 / abs 1e-5 (val-error and progress files
too, at the same epochs), weights rtol 2e-3 / atol 2e-4. The port's file
scores in the JAX `IndependentNNModel` within 1e-5 of the port's scorer.
"""

import json
import os
import re
import shutil

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from shifu_tpu.models import nn as jnn  # noqa: E402
from shifu_tpu.processor.train import TrainProcessor as JTrainProcessor  # noqa: E402
from shifu_tpu_torch import cli  # noqa: E402
from shifu_tpu_torch.models import nn as pnn  # noqa: E402
from shifu_tpu_torch.processor.train import TrainProcessor  # noqa: E402
from shifu_tpu_torch.utils import environment  # noqa: E402
from tests.test_torch_config import prepare_model_set  # noqa: E402

ERR = dict(rel=1e-4, abs=1e-5)
W_TOL = dict(rtol=2e-3, atol=2e-4)

# edits of ModelConfig.json's train section, and the model set each uses
CASES = {
    "single": ("binary", dict(numTrainEpochs=15)),
    "bagging_5": ("binary", dict(numTrainEpochs=12, baggingNum=5,
                                 baggingSampleRate=0.8)),
    "lr": ("binary", dict(numTrainEpochs=15, algorithm="LR")),
    "svm": ("binary", dict(numTrainEpochs=10, algorithm="SVM",
                           params={"Const": 2.0, "Propagation": "R"})),
    "k_fold": ("binary", dict(numTrainEpochs=10, numKFold=3)),
    "grid": ("binary", dict(numTrainEpochs=10, params={
        "NumHiddenNodes": [8], "ActivationFunc": ["tanh"],
        "Propagation": "R", "LearningRate": [0.05, 0.2]})),
    "onevsall": ("multi", dict(numTrainEpochs=12)),
    "onevsall_grid": ("multi", dict(numTrainEpochs=8, params={
        "NumHiddenNodes": [6], "ActivationFunc": ["tanh"],
        "Propagation": "R", "LearningRate": [0.05, 0.2]})),
    "native": ("multi", dict(numTrainEpochs=12,
                             multiClassifyMethod="NATIVE")),
}


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    base = tmp_path_factory.mktemp("nn_sets")
    return {
        "binary": prepare_model_set(str(base / "binary"), "binary", rows=600,
                                    alg="NN"),
        "multi": prepare_model_set(str(base / "multi"), "onevsall",
                                   rows=600, alg="NN", NumHiddenNodes=[12]),
    }


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


def _pair(prepared, tmp_path, case):
    kind, train = CASES[case]
    roots = [str(tmp_path / side) for side in ("jax", "port")]
    for r in roots:
        shutil.copytree(prepared[kind], r)
        _edit(r, dict(train))
    return roots


def _run(roots):
    assert JTrainProcessor(roots[0]).run() == 0
    assert TrainProcessor(roots[1], device="cpu").run() == 0


def _numbers(path):
    with open(path) as fh:
        return [[float(x) for x in re.findall(r"[-+]?\d+(?:\.\d+)?(?:e[-+]?\d+)?",
                                              ln)]
                for ln in fh]


def _compare(roots):
    """Every model file, val-error and progress file of the two runs."""
    models = [sorted(os.listdir(os.path.join(r, "models"))) for r in roots]
    assert models[0] == models[1] and models[0]
    for name in models[0]:
        a = jnn.NNModelSpec.load(os.path.join(roots[0], "models", name))
        b = pnn.NNModelSpec.load(os.path.join(roots[1], "models", name))
        ha, hb = a.header(), b.header()
        for key in ("trainError", "validError"):
            assert hb.pop(key) == pytest.approx(ha.pop(key), **ERR)
        assert hb == ha
        for la, lb in zip(a.params, b.params):
            np.testing.assert_allclose(lb["W"], la["W"], **W_TOL)
            np.testing.assert_allclose(lb["b"], la["b"], **W_TOL)
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


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches_jax(prepared, tmp_path, case):
    roots = _pair(prepared, tmp_path, case)
    _run(roots)
    names = _compare(roots)
    suffix = "lr" if case == "lr" else "nn"
    n_models = {"bagging_5": 5, "k_fold": 3, "onevsall": 3,
                "onevsall_grid": 3}.get(case, 1)
    assert names == [f"model{i}.{suffix}" for i in range(n_models)]
    vals = [f for f in os.listdir(os.path.join(roots[1], "tmp", "train"))
            if f.startswith("val_error_")]
    assert len(vals) == (0 if case == "k_fold" else n_models)
    spec = pnn.NNModelSpec.load(os.path.join(roots[1], "models", names[0]))
    if case == "grid":  # the best trial's params train the final model
        assert spec.layer_sizes[1:] == [8, 1]
    if case == "native":
        assert spec.layer_sizes[-1] == 3 and len(spec.class_tags) == 3
    if case.startswith("onevsall"):
        assert spec.layer_sizes[-1] == 1 and len(spec.class_tags) == 3


def test_continuous_resume_matches_jax(prepared, tmp_path):
    roots = _pair(prepared, tmp_path, "single")
    _run(roots)
    for r in roots:
        _edit(r, dict(isContinuous=True, numTrainEpochs=6))
    # both resume from the JAX run's first model
    shutil.copy(os.path.join(roots[0], "models", "model0.nn"),
                os.path.join(roots[1], "models", "model0.nn"))
    _run(roots)
    _compare(roots)


def test_port_model_scores_in_jax_scorer(prepared, tmp_path):
    root = str(tmp_path / "port")
    shutil.copytree(prepared["binary"], root)
    _edit(root, dict(numTrainEpochs=5))
    cwd = os.getcwd()
    try:
        os.chdir(root)
        assert cli.main(["train", "--device", "cpu"]) == 0
    finally:
        os.chdir(cwd)
    path = os.path.join(root, "models", "model0.nn")
    for name in ("progress_0.log", "val_error_0.txt"):
        assert os.path.isfile(os.path.join(root, "tmp", "train", name))
    from shifu_tpu_torch.norm.dataset import load_normalized

    _meta, x, _t, _w = load_normalized(
        os.path.join(root, "tmp", "norm", "NormalizedData"))
    got = pnn.IndependentNNModel.load(path, device="cpu").compute(x)
    want = jnn.IndependentNNModel.load(path).compute(x)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_cli_exit_codes(prepared, tmp_path, monkeypatch, capsys):
    root = str(tmp_path / "port")
    shutil.copytree(prepared["binary"], root)
    monkeypatch.chdir(root)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["train"]) == 1  # no card, no --device
    assert not os.path.exists(os.path.join(root, "models"))
    try:  # the streamed route runs: a model file and its progress log
        assert cli.main(["train", "--device", "cpu",
                         "-Dshifu.train.forceStreaming=true"]) == 0
    finally:
        environment.set_property("shifu.train.forceStreaming", "")
    assert os.path.isfile(os.path.join(root, "models", "model0.nn"))
    assert os.path.isfile(os.path.join(root, "tmp", "train",
                                       "progress_0.log"))
    assert cli.main(["eval"]) == 1  # no card, no --device
    assert "CUDA" in capsys.readouterr().err
    # export touches no device: it runs without a card
    assert cli.main(["export", "-t", "columnstats"]) == 0
    assert os.path.isfile(os.path.join(root, "export", "columnstats.csv"))
    assert cli.main(["retrain"]) == 2
    assert "ROADMAP A.14" in capsys.readouterr().err

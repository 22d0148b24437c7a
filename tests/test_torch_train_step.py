"""The port's `shifu train` step for trees vs the JAX package's.

Small model sets (400-700 rows, TreeNum <= 5, MaxDepth <= 5) go through
the JAX init -> stats -> norm steps once per module; then the JAX
`TrainProcessor` and the port's `TrainProcessor(device="cpu")` train on
copies of the same directory. Tolerances: RF forests bit-equal (integer
count planes are exact), and the NATIVE RF gini model file byte-identical;
GBT scores within atol 0.03 (the port's GBT planes travel bf16, the JAX
package's XLA lowering f32: the JAX package's own kernel-on/off
tolerance); progress and val-error numbers equal for NATIVE RF
(misclassification rates of bit-equal forests), within 1e-6 for binary RF
(mean squared errors summed in another order), within 0.03 for GBT.
"""

import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from shifu_tpu.models import tree as jtree  # noqa: E402
from shifu_tpu.processor.train import TrainProcessor as JTrainProcessor  # noqa: E402
from shifu_tpu_torch.models import tree as ptree  # noqa: E402
from shifu_tpu_torch.norm.dataset import load_codes  # noqa: E402
from shifu_tpu_torch.ops import hist_kernel as hk  # noqa: E402
from shifu_tpu_torch.processor import train_common  # noqa: E402
from shifu_tpu_torch.processor.train import TrainProcessor  # noqa: E402
from tests.test_torch_config import prepare_model_set  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SETS = {
    "binary_rf": dict(kind="binary", rows=500, alg="RF", TreeNum=4,
                      MaxDepth=5),
    "binary_gbt": dict(kind="binary", rows=500, alg="GBT", TreeNum=5,
                       MaxDepth=3, LearningRate=0.2),
    "native_rf": dict(kind="native", rows=700, alg="RF", TreeNum=5,
                      MaxDepth=5, Impurity="gini"),
    "onevsall_gbt": dict(kind="onevsall", rows=600, alg="GBT", TreeNum=3,
                         MaxDepth=3, LearningRate=0.2),
}


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    base = tmp_path_factory.mktemp("train_sets")
    out = {}
    for name, spec in SETS.items():
        spec = dict(spec)
        kind, rows = spec.pop("kind"), spec.pop("rows")
        out[name] = prepare_model_set(str(base / name), kind, rows=rows,
                                      **spec)
    return out


def _copy(src, dst):
    shutil.copytree(src, dst)
    return str(dst)


def _suffix(name):
    return "rf" if name.endswith("rf") else "gbt"


def _numbers(path):
    with open(path) as fh:
        return [[float(x) for x in re.findall(r"[-+]?\d+\.\d+(?:e[-+]?\d+)?",
                                              ln)]
                for ln in fh]


def _codes(root):
    _meta, codes, _t, _w = load_codes(
        os.path.join(root, "tmp", "norm", "CleanedData"))
    return np.asarray(codes, np.int32)


@pytest.fixture(scope="module")
def trained(prepared, tmp_path_factory):
    """name -> (jax root, port root), both trained."""
    base = tmp_path_factory.mktemp("trained")
    out = {}
    for name, src in prepared.items():
        jroot = _copy(src, base / f"{name}-jax")
        proot = _copy(src, base / f"{name}-port")
        assert JTrainProcessor(jroot).run() == 0
        hk.reset_counters()
        assert TrainProcessor(proot, device="cpu").run() == 0
        out[name] = (jroot, proot, dict(hk.reference_calls))
    return out


@pytest.mark.parametrize("name", list(SETS))
def test_train_step_matches_jax(trained, name):
    jroot, proot, calls = trained[name]
    n_models = 3 if name == "onevsall_gbt" else 1
    suffix = _suffix(name)
    for i in range(n_models):
        jpath = os.path.join(jroot, "models", f"model{i}.{suffix}")
        ppath = os.path.join(proot, "models", f"model{i}.{suffix}")
        jspec = jtree.TreeModelSpec.load(jpath)
        pspec = ptree.TreeModelSpec.load(ppath)
        assert len(pspec.trees) == len(jspec.trees) == SETS[name]["TreeNum"]
        assert pspec.n_classes == jspec.n_classes
        if suffix == "rf":
            for a, b in zip(jspec.trees, pspec.trees):
                np.testing.assert_array_equal(a.feature, b.feature)
                np.testing.assert_array_equal(a.left_mask, b.left_mask)
                np.testing.assert_array_equal(a.leaf_value, b.leaf_value)
        else:
            codes = _codes(proot)
            np.testing.assert_allclose(
                ptree.IndependentTreeModel(pspec, device="cpu").compute(
                    codes),
                jspec.independent().compute(codes), atol=0.03)
        if name == "native_rf":
            assert pspec.n_classes == 3
            with open(jpath, "rb") as a, open(ppath, "rb") as b:
                assert a.read() == b.read()
        tol = {"native_rf": 0.0, "binary_rf": 1e-6}.get(name, 0.03)
        for rel in (f"tmp/train/progress_{i}.log",
                    f"tmp/train/val_error_{i}.txt"):
            ja = _numbers(os.path.join(jroot, rel))
            pa = _numbers(os.path.join(proot, rel))
            assert len(ja) == len(pa) > 0, rel
            for x, y in zip(ja, pa):
                np.testing.assert_allclose(y, x, atol=tol, rtol=0, err_msg=rel)
    assert not os.path.exists(os.path.join(
        proot, "models", f"model{n_models}.{suffix}"))
    if name == "native_rf":
        assert calls["fused_level_mc"] > 0 and calls["fused_level"] == 0


def test_native_rf_votes_on_the_port(trained):
    _jroot, proot, _ = trained["native_rf"]
    spec = ptree.TreeModelSpec.load(os.path.join(proot, "models",
                                                 "model0.rf"))
    votes = ptree.IndependentTreeModel(spec, device="cpu").compute(
        _codes(proot))
    assert votes.shape[1] == 3
    np.testing.assert_allclose(votes.sum(1), 1.0, rtol=1e-6)


def _interrupt_after(monkeypatch, module, k_stop):
    """Make the trainer's per-tree progress hook raise at tree k_stop,
    after the checkpoints of the earlier trees are on disk."""
    def boom(trainer_id, k, tr, va):
        if k == k_stop:
            raise KeyboardInterrupt("killed")

    monkeypatch.setattr(module, "record_epoch", boom)


def test_port_checkpoint_resumes_to_the_same_forest(prepared, trained,
                                                    tmp_path, monkeypatch):
    from shifu_tpu_torch.config.model_config import ModelConfig

    root = _copy(prepared["native_rf"], tmp_path / "ck")
    mc_path = os.path.join(root, "ModelConfig.json")
    mc = ModelConfig.load(mc_path)
    mc.train.params["CheckpointInterval"] = 1
    mc.save(mc_path)
    with monkeypatch.context() as m:
        _interrupt_after(m, train_common, 3)
        with pytest.raises(KeyboardInterrupt):
            TrainProcessor(root, device="cpu").run()
    ck = os.path.join(root, "tmp", "train", "checkpoint_0", "trees.ckpt")
    assert len(ptree.TreeModelSpec.load(ck).trees) == 2
    assert TrainProcessor(root, device="cpu").run() == 0
    assert not os.path.exists(ck)
    _j, proot, _ = trained["native_rf"]
    with open(os.path.join(proot, "models", "model0.rf"), "rb") as a, \
            open(os.path.join(root, "models", "model0.rf"), "rb") as b:
        assert a.read() == b.read()


def test_jax_checkpoint_is_not_grafted(prepared, trained, tmp_path,
                                       monkeypatch, caplog):
    import json

    from shifu_tpu.config.model_config import ModelConfig as JModelConfig
    from shifu_tpu.processor import train_common as jtrain_common

    jroot = _copy(prepared["native_rf"], tmp_path / "jax")
    mc_path = os.path.join(jroot, "ModelConfig.json")
    mc = JModelConfig.load(mc_path)
    mc.train.params["CheckpointInterval"] = 1
    mc.save(mc_path)
    with monkeypatch.context() as m:
        _interrupt_after(m, jtrain_common, 3)
        with pytest.raises(KeyboardInterrupt):
            JTrainProcessor(jroot).run()
    ck_dir = os.path.join(jroot, "tmp", "train", "checkpoint_0")
    root = _copy(prepared["native_rf"], tmp_path / "port")
    shutil.copy(mc_path, os.path.join(root, "ModelConfig.json"))
    shutil.copytree(ck_dir, os.path.join(root, "tmp", "train",
                                         "checkpoint_0"))
    with open(os.path.join(ck_dir, "trees.ckpt.json")) as fh:
        jfp = json.load(fh)["fingerprint"]
    caplog.set_level("WARNING")
    assert TrainProcessor(root, device="cpu").run() == 0
    assert "different hyperparameters" in caplog.text
    # the same keys; only the lowering differs
    from shifu_tpu_torch.processor.train_tree import lowering_fingerprint

    assert jfp["pallasLowering"] != lowering_fingerprint(torch.device("cpu"))
    _j, proot, _ = trained["native_rf"]
    with open(os.path.join(proot, "models", "model0.rf"), "rb") as a, \
            open(os.path.join(root, "models", "model0.rf"), "rb") as b:
        assert a.read() == b.read()


def test_fingerprint_has_every_jax_key(prepared, tmp_path, monkeypatch):
    import json

    root = _copy(prepared["binary_rf"], tmp_path / "fp")
    from shifu_tpu_torch.config.model_config import ModelConfig

    mc_path = os.path.join(root, "ModelConfig.json")
    mc = ModelConfig.load(mc_path)
    mc.train.params["CheckpointInterval"] = 1
    mc.save(mc_path)
    with monkeypatch.context() as m:
        _interrupt_after(m, train_common, 2)
        with pytest.raises(KeyboardInterrupt):
            TrainProcessor(root, device="cpu").run()
    with open(os.path.join(root, "tmp", "train", "checkpoint_0",
                           "trees.ckpt.json")) as fh:
        fp = json.load(fh)["fingerprint"]
    assert sorted(fp) == sorted([
        "algorithm", "loss", "maxDepth", "maxLeaves", "impurity",
        "learningRate", "dropoutRate", "minInstancesPerNode", "minInfoGain",
        "featureSubsetStrategy", "baggingSampleRate",
        "baggingWithReplacement", "validSetRate", "seed", "nClasses",
        "histSubtraction", "maxStatsMemoryMB", "pallasLowering", "oneVsAll",
        "dataSignature"])
    assert fp["pallasLowering"] == "torch-plain" and fp["seed"] == 13


def test_native_gbt_is_refused(prepared, tmp_path):
    from shifu_tpu_torch.config.model_config import Algorithm, ModelConfig
    from shifu_tpu_torch.utils.errors import ShifuError

    root = _copy(prepared["native_rf"], tmp_path / "gbt")
    mc_path = os.path.join(root, "ModelConfig.json")
    mc = ModelConfig.load(mc_path)
    mc.train.algorithm = Algorithm.GBT
    mc.save(mc_path)
    with pytest.raises(ShifuError, match="RF-only"):
        TrainProcessor(root, device="cpu").run()


def test_processor_needs_the_card_unless_asked(prepared, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TrainProcessor(prepared["native_rf"])


def test_cli_train_and_unported_steps(prepared, tmp_path):
    root = _copy(prepared["native_rf"], tmp_path / "cli")
    env = dict(os.environ, PYTHONPATH=REPO)
    run = lambda *a: subprocess.run(  # noqa: E731
        [sys.executable, "-m", "shifu_tpu_torch", *a], cwd=root, env=env,
        capture_output=True, text=True, timeout=300)
    proc = run("train", "--device", "cpu", "-Dshifu.test.cli=1")
    assert proc.returncode == 0, proc.stderr
    assert os.path.isfile(os.path.join(root, "models", "model0.rf"))
    proc = run("eval", "--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    assert os.path.isfile(os.path.join(root, "evals", "Eval1",
                                       "EvalConfusionMatrix.csv"))
    if not torch.cuda.is_available():
        proc = run("eval")
        assert proc.returncode == 1 and "CUDA" in proc.stderr
    proc = run("export")
    assert proc.returncode == 0, proc.stderr
    assert os.path.isfile(os.path.join(root, "export", "model0.pmml"))
    proc = run("retrain")
    assert proc.returncode == 2
    assert "not ported yet: ROADMAP A.14" in proc.stderr
    proc = run("train", "--device", "cpu", "-dry")
    assert proc.returncode == 0

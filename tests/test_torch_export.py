"""The port's `shifu export` and its PMML writer vs the JAX package's, on
the CPU.

One model set goes through the JAX init -> stats -correlation -> norm
steps; the JAX trainer then trains it as NN (bagging 2), LR, GBT, RF and
a leaf-wise GBT (MaxLeaves). Each package's `ExportProcessor` runs on its
own copy of each trained set, so both read the same JAX model files.
Gates: every exported file byte-identical (per-model PMML, one-bagging
PMML, columnstats.csv, woemapping.json, correlation.csv). The port's
leaf-wise forest, written by the port, gives the same PMML in both
packages, every node reached through the explicit child pointers.
"""

import os
import shutil
import xml.etree.ElementTree as ET

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from shifu_tpu.config.model_config import Algorithm as JAlgorithm  # noqa: E402
from shifu_tpu.config.model_config import ModelConfig as JModelConfig  # noqa: E402
from shifu_tpu.export import pmml as jpmml  # noqa: E402
from shifu_tpu.models import tree as jtree  # noqa: E402
from shifu_tpu.processor.export import ExportProcessor as JExportProcessor  # noqa: E402
from shifu_tpu.processor.stats import StatsProcessor as JStatsProcessor  # noqa: E402
from shifu_tpu.processor.train import TrainProcessor as JTrainProcessor  # noqa: E402
from shifu_tpu_torch import cli  # noqa: E402
from shifu_tpu_torch.export import pmml as ppmml  # noqa: E402
from shifu_tpu_torch.models import tree as ptree  # noqa: E402
from shifu_tpu_torch.processor.export import ExportProcessor  # noqa: E402
from shifu_tpu_torch.train import tree_trainer as ptt  # noqa: E402
from tests.test_torch_config import (jax_inline_ingest,  # noqa: E402
                                     prepare_model_set)

SETS = {
    "nn": dict(alg="NN"),
    "lr": dict(alg="LR"),
    "gbt": dict(alg="GBT", TreeNum=3, MaxDepth=3, LearningRate=0.3),
    "rf": dict(alg="RF", TreeNum=3, MaxDepth=4),
    "gbt_leafwise": dict(alg="GBT", TreeNum=3, MaxDepth=5, MaxLeaves=7,
                         LearningRate=0.3),
}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """name -> a model set the JAX trainer trained."""
    base = tmp_path_factory.mktemp("export_sets")
    src = prepare_model_set(str(base / "src"), "binary", rows=400, alg="NN")
    with jax_inline_ingest():
        assert JStatsProcessor(src, correlation=True).run() == 0
    out = {}
    for name, spec in SETS.items():
        spec = dict(spec)
        root = str(base / name)
        shutil.copytree(src, root)
        path = os.path.join(root, "ModelConfig.json")
        mc = JModelConfig.load(path)
        mc.train.algorithm = JAlgorithm.parse(spec.pop("alg"))
        if name == "nn":
            mc.train.bagging_num = 2
            mc.train.num_train_epochs = 10
        elif name == "lr":
            mc.train.num_train_epochs = 10
        else:
            mc.train.params.update(spec)
        mc.save(path)
        with jax_inline_ingest(), pytest.MonkeyPatch.context() as mp:
            if "MaxLeaves" in spec:
                # the JAX leaf-wise grower fails on a mesh (ROADMAP C.9):
                # its step runs on one device here
                mp.setattr("shifu_tpu.parallel.mesh.data_mesh",
                           lambda *a, **k: None)
            assert JTrainProcessor(root).run() == 0
        out[name] = root
    return out


def _export_both(src, tmp_path, kind):
    """Copies of `src` exported by each package; (jax root, port root)."""
    jroot, proot = str(tmp_path / "jax"), str(tmp_path / "port")
    shutil.copytree(src, jroot)
    shutil.copytree(src, proot)
    assert JExportProcessor(jroot, kind=kind).run() == 0
    assert ExportProcessor(proot, kind=kind).run() == 0
    return jroot, proot


def _export_files(root):
    d = os.path.join(root, "export")
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d))}


@pytest.mark.parametrize("name", list(SETS))
def test_pmml_byte_identical(trained, tmp_path, name):
    jroot, proot = _export_both(trained[name], tmp_path, "pmml")
    j, p = _export_files(jroot), _export_files(proot)
    n_models = len(os.listdir(os.path.join(trained[name], "models")))
    assert len(j) == n_models >= 1
    assert j == p
    if name == "gbt_leafwise":  # explicit pointers: a lopsided tree
        spec = ptree.TreeModelSpec.load(
            os.path.join(trained[name], "models", "model0.gbt"))
        assert all(t.left is not None for t in spec.trees)
        doc = ET.fromstring(p["model0.pmml"])
        ns = {"p": jpmml.PMML_NS}
        nodes = doc.findall(".//p:TreeModel//p:Node", ns)
        assert len(nodes) == sum(t.n_nodes for t in spec.trees)


@pytest.mark.parametrize("name", ["nn", "rf"])
def test_onebagging_pmml_byte_identical(trained, tmp_path, name):
    jroot, proot = _export_both(trained[name], tmp_path, "onebagging")
    j, p = _export_files(jroot), _export_files(proot)
    assert list(j) == ["model_onebagging.pmml"]
    assert j == p


@pytest.mark.parametrize("kind,out", [("columnstats", "columnstats.csv"),
                                      ("woemapping", "woemapping.json"),
                                      ("corr", "correlation.csv")])
def test_column_exports_byte_identical(trained, tmp_path, kind, out):
    jroot, proot = _export_both(trained["rf"], tmp_path, kind)
    j, p = _export_files(jroot), _export_files(proot)
    assert list(j) == [out]
    assert len(j[out]) > 0
    assert j == p


def test_port_leafwise_forest_pmml_in_both_packages(tmp_path):
    """A leaf-wise forest the port trains, saved by the port and loaded
    by each package, gives one PMML document in both writers."""
    rng = np.random.default_rng(3)
    n, slots = 1500, [9, 9, 5]
    codes = np.stack([rng.integers(0, s - 1, size=n) for s in slots],
                     1).astype(np.int32)
    y = ((codes[:, 0] > 4) ^ (rng.random(n) < 0.1)).astype(np.float32)
    bounds = [[float("-inf")] + [float(b) for b in range(1, s - 1)]
              for s in slots[:2]] + [None]
    cats = [None, None, ["a", "b", "c", "d"]]
    res = ptt.train_trees(
        codes, y, np.ones(n, np.float32), slots, [False, False, True],
        ["x0", "x1", "c"],
        ptt.TreeTrainConfig(algorithm="GBT", tree_num=2, max_depth=4,
                            max_leaves=6, learning_rate=0.3, seed=1),
        boundaries=bounds, categories=cats, device="cpu")
    path = str(tmp_path / "m.gbt")
    res.spec.save(path)
    a = ppmml.tree_to_pmml(ptree.TreeModelSpec.load(path), model_name="m")
    b = jpmml.tree_to_pmml(jtree.TreeModelSpec.load(path), model_name="m")
    assert a == b
    assert a.count("<Node ") == sum(t.n_nodes for t in res.spec.trees)


def test_export_cli(trained, tmp_path, monkeypatch, capsys):
    """`export` runs without a card (it touches no device); an unknown
    type exits 1."""
    root = str(tmp_path / "set")
    shutil.copytree(trained["gbt"], root)
    monkeypatch.chdir(root)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["export"]) == 0
    assert os.path.isfile(os.path.join(root, "export", "model0.pmml"))
    assert cli.main(["export", "-t", "woe"]) == 0
    assert os.path.isfile(os.path.join(root, "export", "woemapping.json"))
    assert cli.main(["export", "-t", "nonsense"]) == 1
    assert "unknown export type" in capsys.readouterr().err

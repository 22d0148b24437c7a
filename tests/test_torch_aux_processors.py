"""The port's small lifecycle steps vs the JAX package's, on the CPU:
`new`, `analysis`, `save` / `switch` / `show`, `test`, `encode`, `combo`,
`version`, and the CLI's subcommand set.

Gates: `new` writes the same tree of files, byte for byte (the creation
time frozen in both); `analysis` the same report; `save` / `switch` /
`show` the same backups, configs and log lines; `test` the same log
lines. `encode`'s woe path and its tree path on a level-wise forest write
EncodedData byte-identical to the JAX package's; on a leaf-wise forest
the port's leaf ids follow the explicit child pointers and the JAX
package's do not (ROADMAP C.8). `combo` runs the three-algorithm
workflow (NN and RF members, an LR assembler) in both packages on the
synthetic model set: the same spec and member configs, the NN member's
scores within 0.005, the RF member's equal (its forest is bit-equal), the
AUC within 0.02. (The members train at their default parameters, GBT's
100 trees of depth 6 past what the 0.03 GBT gate holds on 300 rows: the
card runs NN,GBT,LR in chip_smoke.py.) Every JAX subcommand is a port
subcommand or in `NOT_PORTED`, and each of the latter exits 2 naming its
ROADMAP item (C.7).
"""

import datetime
import json
import logging
import os
import shutil

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from shifu_tpu import cli as jcli  # noqa: E402
from shifu_tpu.config import model_config as jmodel_config  # noqa: E402
from shifu_tpu.config.model_config import Algorithm as JAlgorithm  # noqa: E402
from shifu_tpu.config.model_config import ModelConfig as JModelConfig  # noqa: E402
from shifu_tpu.models import tree as jtree  # noqa: E402
from shifu_tpu.processor import create as jcreate  # noqa: E402
from shifu_tpu.processor.analysis import AnalysisProcessor as JAnalysis  # noqa: E402
from shifu_tpu.processor.combo import ComboProcessor as JCombo  # noqa: E402
from shifu_tpu.processor.encode import EncodeProcessor as JEncode  # noqa: E402
from shifu_tpu.processor.manage import ManageProcessor as JManage  # noqa: E402
from shifu_tpu.processor.testdata import TestDataProcessor as JTestData  # noqa: E402
from shifu_tpu.processor.train import TrainProcessor as JTrainProcessor  # noqa: E402
from shifu_tpu.utils.errors import ShifuError as JShifuError  # noqa: E402
from shifu_tpu_torch import cli  # noqa: E402
from shifu_tpu_torch.config import model_config as pmodel_config  # noqa: E402
from shifu_tpu_torch.processor import create as pcreate  # noqa: E402
from shifu_tpu_torch.processor.analysis import AnalysisProcessor  # noqa: E402
from shifu_tpu_torch.processor.combo import ComboProcessor  # noqa: E402
from shifu_tpu_torch.processor.encode import EncodeProcessor  # noqa: E402
from shifu_tpu_torch.processor.manage import ManageProcessor  # noqa: E402
from shifu_tpu_torch.processor.testdata import \
    TestDataProcessor as PTestData  # noqa: E402
from shifu_tpu_torch.utils.errors import ShifuError  # noqa: E402
from tests.helpers import make_model_set  # noqa: E402
from tests.test_torch_config import (jax_inline_ingest,  # noqa: E402
                                     prepare_model_set)

ENCODED = os.path.join("tmp", "encode", "EncodedData")


class _FrozenDatetime(datetime.datetime):
    @classmethod
    def now(cls, tz=None):
        return cls(2026, 1, 2, 3, 4, 5)


def _frozen_clock(mp):
    """`new` stamps its creation time into ModelConfig.json: freeze it in
    both packages."""
    for mod in (jmodel_config, pmodel_config):
        mp.setattr(mod.datetime, "datetime", _FrozenDatetime)


def _tree_bytes(root, skip=(".shifu/runs",)):
    """relative path -> bytes of every file under `root`."""
    out = {}
    for d, _dirs, files in os.walk(root):
        for f in files:
            rel = os.path.relpath(os.path.join(d, f), root)
            if not rel.startswith(skip):
                with open(os.path.join(d, f), "rb") as fh:
                    out[rel] = fh.read()
    return out


def _messages(caplog, prefix):
    return [r.getMessage() for r in caplog.records
            if r.name.startswith(prefix)
            and not r.getMessage().startswith("Step ")]


@pytest.mark.parametrize("alg", ["NN", "LR", "GBT", "RF"])
def test_new_writes_the_same_files(tmp_path, monkeypatch, alg):
    _frozen_clock(monkeypatch)
    monkeypatch.setenv("USER", "tester")
    jroot, proot = tmp_path / "jax", tmp_path / "port"
    assert jcreate.run_new("Demo", alg, root=str(jroot)) == 0
    assert pcreate.run_new("Demo", alg, root=str(proot)) == 0
    j, p = _tree_bytes(str(jroot)), _tree_bytes(str(proot))
    assert sorted(j) == sorted(p) == [
        "Demo/ModelConfig.json", "Demo/columns/categorical.column.names",
        "Demo/columns/forceremove.column.names",
        "Demo/columns/forceselect.column.names",
        "Demo/columns/meta.column.names"]
    assert j == p
    # a second `new` and an unknown algorithm exit 1 in both
    for run_new, root in ((jcreate.run_new, jroot), (pcreate.run_new, proot)):
        assert run_new("Demo", alg, root=str(root)) == 1
        assert run_new("Other", "NOPE", root=str(root)) == 1


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    """A stats'ed model set and copies of it the JAX trainer trained as
    RF (level-wise) and as a leaf-wise GBT."""
    base = tmp_path_factory.mktemp("aux_sets")
    src = prepare_model_set(str(base / "src"), "binary", rows=400, alg="NN")
    out = {"stats": src}
    for name, alg, params in (
            ("rf", "RF", dict(TreeNum=3, MaxDepth=4)),
            ("leafwise", "GBT", dict(TreeNum=3, MaxDepth=6, MaxLeaves=9,
                                     LearningRate=0.3))):
        root = str(base / name)
        shutil.copytree(src, root)
        path = os.path.join(root, "ModelConfig.json")
        mc = JModelConfig.load(path)
        mc.train.algorithm = JAlgorithm.parse(alg)
        mc.train.params.update(params)
        mc.save(path)
        with jax_inline_ingest(), pytest.MonkeyPatch.context() as mp:
            # the JAX leaf-wise grower fails on a mesh (ROADMAP C.9)
            mp.setattr("shifu_tpu.parallel.mesh.data_mesh",
                       lambda *a, **k: None)
            assert JTrainProcessor(root).run() == 0
        out[name] = root
    return out


def _copies(src, tmp_path):
    jroot, proot = str(tmp_path / "jax"), str(tmp_path / "port")
    shutil.copytree(src, jroot)
    shutil.copytree(src, proot)
    return jroot, proot


def test_analysis_same_report(sets, tmp_path, capsys):
    jroot, proot = _copies(sets["rf"], tmp_path)
    assert JAnalysis(jroot).run() == 0
    j_out = capsys.readouterr().out
    assert AnalysisProcessor(proot).run() == 0
    p_out = capsys.readouterr().out
    rel = os.path.join("tmp", "analysis", "report.txt")
    report = open(os.path.join(jroot, rel), "rb").read()
    assert report == open(os.path.join(proot, rel), "rb").read()
    assert j_out == p_out and "Top variables by KS" in p_out
    assert "model0.rf" in p_out


def test_save_switch_show_behave_the_same(sets, tmp_path, caplog):
    jroot, proot = _copies(sets["rf"], tmp_path)
    caplog.set_level(logging.INFO)
    for Manage, Err, root in ((JManage, JShifuError, jroot),
                              (ManageProcessor, ShifuError, proot)):
        assert Manage("save", "v1", root=root).run() == 0
        with pytest.raises(Err, match="already exists"):
            Manage("save", "v1", root=root).run()
        # change the configs and models, then switch back to v1
        mc_path = os.path.join(root, "ModelConfig.json")
        mc = JModelConfig.load(mc_path)
        mc.basic.name = "Changed"
        mc.save(mc_path)
        os.remove(os.path.join(root, "models", "model0.rf"))
        assert Manage("save", "v2", root=root).run() == 0
        assert Manage("switch", "v1", root=root).run() == 0
        with pytest.raises(Err, match="not found"):
            Manage("switch", "v9", root=root).run()
        assert Manage("show", root=root).run() == 0
    j, p = _tree_bytes(jroot), _tree_bytes(proot)
    assert j == p
    assert "models/model0.rf" in p and ".shifu/backup/v2/ModelConfig.json" in p
    assert _messages(caplog, "shifu_tpu.processor.manage") == \
        _messages(caplog, "shifu_tpu_torch.processor.manage")
    assert "version: v2" in _messages(caplog,
                                      "shifu_tpu_torch.processor.manage")


def test_testdata_same_report(sets, tmp_path, caplog):
    jroot, proot = _copies(sets["stats"], tmp_path)
    caplog.set_level(logging.INFO)
    with jax_inline_ingest():
        assert JTestData(jroot, n=50).run() == 0
    assert PTestData(proot, n=50).run() == 0
    j = _messages(caplog, "shifu_tpu.processor.testdata")
    p = _messages(caplog, "shifu_tpu_torch.processor.testdata")
    assert j == p and "read 50 records" in p[0]


def _encode_both(src, tmp_path):
    jroot, proot = _copies(src, tmp_path)
    with jax_inline_ingest():
        assert JEncode(jroot).run() == 0
    assert EncodeProcessor(proot, device="cpu").run() == 0
    return (open(os.path.join(jroot, ENCODED), "rb").read(),
            open(os.path.join(proot, ENCODED), "rb").read())


@pytest.mark.parametrize("name", ["stats", "rf"])
def test_encode_byte_identical(sets, tmp_path, name):
    """No tree model: the woe path; a level-wise RF: the tree path."""
    j, p = _encode_both(sets[name], tmp_path)
    head = p.split(b"\n", 1)[0]
    assert head.startswith(b"tag|") and (head.count(b"tree_") == 3) == (
        name == "rf")
    assert j == p


def _pointer_leaves(spec, codes):
    """The leaf each row reaches in each tree, by a plain walk of the
    explicit child pointers."""
    out = np.zeros((codes.shape[0], len(spec.trees)), np.int64)
    for k, t in enumerate(spec.trees):
        for i, row in enumerate(codes):
            node = 0
            while t.feature[node] >= 0:
                code = min(max(int(row[t.feature[node]]), 0),
                           t.left_mask.shape[1] - 1)
                node = (t.left[node] if t.left_mask[node, code]
                        else t.right[node])
            out[i, k] = node
    return out


def test_encode_leafwise_follows_pointers(sets, tmp_path):
    """C.8: on a leaf-wise forest the port's leaf ids are the nodes the
    explicit pointers reach; the JAX package steps to 2i+1/2i+2 and
    writes other ids."""
    j, p = _encode_both(sets["leafwise"], tmp_path)
    spec = jtree.TreeModelSpec.load(
        os.path.join(sets["leafwise"], "models", "model0.gbt"))
    assert all(t.left is not None for t in spec.trees)
    from shifu_tpu.data.reader import read_columnar, read_header

    mc = JModelConfig.load(os.path.join(sets["leafwise"],
                                        "ModelConfig.json"))
    ds = mc.data_set
    names = read_header(ds.header_path, ds.header_delimiter)
    with jax_inline_ingest():
        data = read_columnar(ds.data_path, names,
                             missing_values=tuple(ds.missing_or_invalid_values))
    codes = spec.independent().codes_from_raw(data)
    want = _pointer_leaves(spec, codes)
    rows = [ln.split("|") for ln in p.decode().splitlines()[1:]]
    got = np.array([[int(v) for v in r[1:]] for r in rows])
    np.testing.assert_array_equal(got, want)
    assert j.split(b"\n", 1)[0] == p.split(b"\n", 1)[0]
    assert j != p  # the JAX ids are wrong on this forest


def _combo_run(Combo, root, **kw):
    assert Combo(root, new_algs="NN,RF,LR", **kw).run() == 0
    assert Combo(root, do_init=True, do_run=True, do_eval=True,
                 **kw).run() == 0


def test_combo_matches_jax(tmp_path):
    jroot, proot = str(tmp_path / "jax"), str(tmp_path / "port")
    for root in (jroot, proot):
        make_model_set(root, n_rows=300, algorithm="NN")
        path = os.path.join(root, "ModelConfig.json")
        mc = JModelConfig.load(path)
        mc.train.num_train_epochs = 20
        mc.save(path)
    with jax_inline_ingest():
        _combo_run(JCombo, jroot)
    _combo_run(ComboProcessor, proot, device="cpu")
    rel = ("ComboTrain.json", "sub_0_NN/ModelConfig.json",
           "sub_1_RF/ModelConfig.json", "assembler_LR/ModelConfig.json",
           "assembler_LR/data/header.txt")
    for r in rel:
        a = open(os.path.join(jroot, r), "rb").read()
        b = open(os.path.join(proot, r), "rb").read()
        if r.endswith("ModelConfig.json"):  # the creation time differs
            a, b = (json.loads(x) for x in (a, b))
            for x in (a, b):
                x["basic"].pop("description", None)
        assert a == b, r
    # member scores on the training rows (x1000 score units): NN within
    # 0.005, RF equal
    j, p = (np.loadtxt(os.path.join(r, "assembler_LR", "data", "data.txt"),
                       delimiter="|") for r in (jroot, proot))
    assert j.shape == p.shape and j.shape[1] == 3
    np.testing.assert_array_equal(j[:, 0], p[:, 0])  # tags
    np.testing.assert_allclose(p[:, 1], j[:, 1], atol=5.0)
    np.testing.assert_array_equal(p[:, 2], j[:, 2])
    ja, pa = (json.load(open(os.path.join(r, "evals", "Combo",
                                          "EvalPerformance.json")))
              for r in (jroot, proot))
    assert abs(ja["areaUnderRoc"] - pa["areaUnderRoc"]) <= 0.02


def _subcommands(parser):
    import argparse

    for action in parser._actions:
        if isinstance(action, argparse._SubParsersAction):
            return set(action.choices)
    raise AssertionError("no subcommands")


def _subcommand_flags(parser, name):
    import argparse

    for action in parser._actions:
        if isinstance(action, argparse._SubParsersAction):
            return {(tuple(a.option_strings), a.dest, a.nargs)
                    for a in action.choices[name]._actions}
    raise AssertionError("no subcommands")


def test_cli_subcommands_cover_jax_cli(capsys):
    """C.7: the port's subcommands (aliases included) are the JAX CLI's;
    each one still waiting exits 2 naming its ROADMAP item."""
    jax_cmds = _subcommands(jcli.build_parser())
    port_cmds = _subcommands(cli.build_parser())
    assert port_cmds == jax_cmds
    # trace, top, runs and profile are ported with the obs layer
    assert set(cli.NOT_PORTED) == {"retrain", "promote", "check"}
    for name, item in cli.NOT_PORTED.items():
        assert item.startswith("A.14")
        assert cli.main([name]) == 2
        assert f"ROADMAP {item}" in capsys.readouterr().err
    # `convert` is ported (A.12 and A.14's compat part), with the JAX
    # CLI's flags; without an input it is a ShifuError, not exit 2
    assert "convert" not in cli.NOT_PORTED
    assert (_subcommand_flags(cli.build_parser(), "convert")
            == _subcommand_flags(jcli.build_parser(), "convert"))
    assert cli.main(["convert"]) == 1
    assert "needs an input model path" in capsys.readouterr().err
    assert cli.main(["version"]) == 0
    assert capsys.readouterr().out.strip() == "0.1.0"


def test_cli_new_test_analysis(sets, tmp_path, monkeypatch, capsys):
    """The host-only steps run through the CLI without a card; `encode`
    and `combo` take --device and exit 1 without a card and without
    it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    assert cli.main(["new", "Demo", "-t", "GBT"]) == 0
    mc = json.load(open(tmp_path / "Demo" / "ModelConfig.json"))
    assert mc["train"]["algorithm"] == "GBT"
    root = str(tmp_path / "set")
    shutil.copytree(sets["rf"], root)
    monkeypatch.chdir(root)
    assert cli.main(["test", "-n", "20"]) == 0
    assert cli.main(["analysis"]) == 0
    assert "Top variables by KS" in capsys.readouterr().out
    assert cli.main(["save", "v1"]) == 0
    assert cli.main(["show"]) == 0
    assert cli.main(["switch", "v1"]) == 0
    assert cli.main(["encode"]) == 1
    assert "CUDA" in capsys.readouterr().err
    assert cli.main(["encode", "--device", "cpu"]) == 0
    assert os.path.isfile(os.path.join(root, ENCODED))
    assert cli.main(["combo", "-new", "NN,LR"]) == 1

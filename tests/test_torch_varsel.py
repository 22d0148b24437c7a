"""The port's `shifu varsel` vs the JAX package's, on the CPU.

No tolerances: the selectors see the same ColumnConfig.json (the JAX init
+ stats -correlation output) and must flag and select the same columns;
`VarSelProcessor` must write the same ColumnConfig.json bytes and the same
`.prevarsel` backup. The correlation CSV is read by each package's own
reader (pandas in the JAX package); the auto-filter is held against the
JAX function on one matrix, not on the two readers. The SE/ST wrapper
trains an NN in each package, so its scores carry the trainer's
tolerance: the knockout scan rtol 1e-4 on the same params, se.csv the
same names in the same order with scores within rel 1e-3, and the same
columns selected.
"""

import json
import os
import shutil

import numpy as np
import pytest

pytest.importorskip("pandas")
pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from shifu_tpu.config import load_column_config_list as jload_cc  # noqa: E402
from shifu_tpu.config.column_config import ColumnFlag as JColumnFlag  # noqa: E402
from shifu_tpu.models.tree import TreeModelSpec as JTreeModelSpec  # noqa: E402
from shifu_tpu.processor.init import InitProcessor as JInitProcessor  # noqa: E402
from shifu_tpu.processor.stats import StatsProcessor as JStatsProcessor  # noqa: E402
from shifu_tpu.processor.varsel import VarSelProcessor as JVarSelProcessor  # noqa: E402
from shifu_tpu.varsel import importance as jimp  # noqa: E402
from shifu_tpu.varsel import selector as jsel  # noqa: E402
from shifu_tpu_torch import cli  # noqa: E402
from shifu_tpu_torch.config import load_column_config_list  # noqa: E402
from shifu_tpu_torch.config.column_config import ColumnFlag  # noqa: E402
from shifu_tpu_torch.eval import scorer as pscorer  # noqa: E402
from shifu_tpu_torch.models.tree import TreeModelSpec  # noqa: E402
from shifu_tpu_torch.processor.norm import NormProcessor  # noqa: E402
from shifu_tpu_torch.processor.train import TrainProcessor  # noqa: E402
from shifu_tpu_torch.processor.varsel import VarSelProcessor  # noqa: E402
from shifu_tpu_torch.utils.platform import DeviceUnavailable  # noqa: E402
from shifu_tpu_torch.varsel import importance as pimp  # noqa: E402
from shifu_tpu_torch.varsel import selector as psel  # noqa: E402
from tests.helpers import make_model_set  # noqa: E402
from tests.test_torch_config import jax_inline_ingest  # noqa: E402


@pytest.fixture(scope="module")
def varsel_set(tmp_path_factory):
    """make_model_set through the JAX init + stats -correlation, then the
    port's norm + RF train (the model the FI filter reads)."""
    root = str(tmp_path_factory.mktemp("varsel") / "ms")
    make_model_set(root, n_rows=500, algorithm="RF")
    path = os.path.join(root, "ModelConfig.json")
    with open(path) as fh:
        blob = json.load(fh)
    blob["train"]["params"].update(TreeNum=4, MaxDepth=4)
    with open(path, "w") as fh:
        json.dump(blob, fh, indent=2)
    with jax_inline_ingest():
        assert JInitProcessor(root).run() == 0
        assert JStatsProcessor(root, correlation=True).run() == 0
    assert NormProcessor(root, device="cpu").run() == 0
    assert TrainProcessor(root, device="cpu").run() == 0
    return root


def _both_columns(root, edit=None):
    path = os.path.join(root, "ColumnConfig.json")
    jcols, pcols = jload_cc(path), load_column_config_list(path)
    if edit is not None:
        edit(jcols, JColumnFlag)
        edit(pcols, ColumnFlag)
    return jcols, pcols


def _flags(cols):
    return [(c.column_name, getattr(c.column_flag, "value", None),
             c.final_select) for c in cols]


def _force(cols, flag):
    """num_3 force-selected, num_5 force-removed."""
    for c in cols:
        if c.column_name == "num_3":
            c.column_flag = flag.FORCE_SELECT
        elif c.column_name == "num_5":
            c.column_flag = flag.FORCE_REMOVE


@pytest.mark.parametrize("filter_by", ["KS", "IV", "MIX", "PARETO", "", "ks"])
@pytest.mark.parametrize("filter_num,force,enable", [
    (5, False, True), (4, True, True), (1, True, True), (40, False, True),
    (5, True, False)])
def test_select_by_filter_matches_jax(varsel_set, filter_by, filter_num,
                                      force, enable):
    jcols, pcols = _both_columns(varsel_set, _force if force else None)
    want = jsel.select_by_filter(jcols, filter_by, filter_num, enable)
    got = psel.select_by_filter(pcols, filter_by, filter_num, enable)
    assert got == want and _flags(pcols) == _flags(jcols)
    if force:
        assert "num_3" in got and "num_5" not in got


def test_pareto_front_order_matches_jax():
    rng = np.random.default_rng(8)
    for n in (1, 5, 40):
        pts = [tuple(p) for p in np.round(rng.random((n, 2)), 1).tolist()]
        pts += pts[: n // 3]  # ties and duplicates
        assert psel.pareto_front_order(pts) == jsel.pareto_front_order(pts)
    assert psel.pareto_front_order([]) == []


@pytest.mark.parametrize("kw", [
    dict(),
    dict(missing_rate_threshold=0.01),
    dict(min_ks=20.0),
    dict(min_iv=0.05),
    dict(correlation_threshold=0.12),
    dict(correlation_threshold=0.12, min_ks=15.0, missing_rate_threshold=0.02),
])
def test_auto_filter_matches_jax(varsel_set, kw):
    from shifu_tpu_torch.stats.correlation import load_correlation_csv

    corr, names = load_correlation_csv(os.path.join(
        varsel_set, "tmp", "stats", "correlation.csv"))
    jcols, pcols = _both_columns(varsel_set, _force)
    want = jsel.auto_filter(jcols, correlation=corr, correlation_names=names,
                            **kw)
    got = psel.auto_filter(pcols, correlation=corr, correlation_names=names,
                           **kw)
    assert got.removed == want.removed and _flags(pcols) == _flags(jcols)
    assert "num_3" not in got.removed  # force-selected columns stay
    if kw:
        assert got.removed


def test_tree_feature_importance_matches_jax(varsel_set):
    paths = pscorer.find_model_paths(os.path.join(varsel_set, "models"))
    assert [os.path.basename(p) for p in paths] == ["model0.rf"]
    got = pimp.tree_feature_importance(TreeModelSpec.load(paths[0]))
    want = jimp.tree_feature_importance(JTreeModelSpec.load(paths[0]))
    assert got == want and abs(sum(got.values()) - 1.0) < 1e-12


def test_find_model_paths_matches_jax(tmp_path):
    from shifu_tpu.eval.scorer import MODEL_SUFFIXES, find_model_paths

    for name in ("model10.rf", "model2.rf", "model2.gbt", "model1.nn",
                 "modelx.lr", "other.rf", "model3.txt"):
        (tmp_path / name).write_bytes(b"")
    assert pscorer.MODEL_SUFFIXES == MODEL_SUFFIXES
    assert pscorer.find_model_paths(str(tmp_path)) == find_model_paths(
        str(tmp_path))


# ---- the step: VarSelProcessor --------------------------------------------

VARSEL = {
    "ks": dict(filterBy="KS", filterNum=6, forceEnable=False),
    "iv_auto": dict(filterBy="IV", filterNum=5, forceEnable=True,
                    correlationThreshold=0.12),
    "mix": dict(filterBy="MIX", filterNum=7, forceEnable=True,
                minKsThreshold=15.0),
    "pareto_force": dict(filterBy="PARETO", filterNum=4, forceEnable=True,
                         forceSelectColumnNameFile="force.select",
                         forceRemoveColumnNameFile="force.remove"),
    "fi": dict(filterBy="FI", filterNum=5, forceEnable=True,
               missingRateThreshold=0.02),
    "no_filter": dict(filterBy="KS", filterNum=6, filterEnable=False,
                      forceSelectColumnNameFile="force.select"),
}


def _pair(varsel_set, tmp_path, conf):
    roots = [str(tmp_path / side) for side in ("jax", "port")]
    for r in roots:
        shutil.copytree(varsel_set, r)
        with open(os.path.join(r, "force.select"), "w") as fh:
            fh.write("num_7\ncat_1\n")
        with open(os.path.join(r, "force.remove"), "w") as fh:
            fh.write("num_0\n\n")
        path = os.path.join(r, "ModelConfig.json")
        with open(path) as fh:
            blob = json.load(fh)
        blob["varSelect"].update(conf)
        with open(path, "w") as fh:
            json.dump(blob, fh, indent=2)
    return roots


def _read(root, *rel):
    with open(os.path.join(root, *rel), "rb") as fh:
        return fh.read()


@pytest.mark.parametrize("case", list(VARSEL))
def test_varsel_step_byte_identical(varsel_set, tmp_path, case):
    roots = _pair(varsel_set, tmp_path, VARSEL[case])
    with jax_inline_ingest():
        assert JVarSelProcessor(roots[0]).run() == 0
    assert VarSelProcessor(roots[1], device="cpu").run() == 0
    got = _read(roots[1], "ColumnConfig.json")
    assert got == _read(roots[0], "ColumnConfig.json")
    bak = ("tmp", "varsel", "ColumnConfig.json.prevarsel")
    assert _read(roots[1], *bak) == _read(roots[0], *bak) == _read(
        varsel_set, "ColumnConfig.json")
    cols = load_column_config_list(os.path.join(roots[1], "ColumnConfig.json"))
    n_sel = sum(c.final_select for c in cols)
    if VARSEL[case].get("filterEnable", True):  # fewer past the auto-filter
        assert 0 < n_sel <= VARSEL[case]["filterNum"]
    else:
        assert n_sel == 2  # the two force-selected columns only


def test_list_reset_recover(varsel_set, tmp_path):
    roots = _pair(varsel_set, tmp_path, VARSEL["iv_auto"])
    for r, proc in ((roots[0], JVarSelProcessor),
                    (roots[1], lambda root, **kw: VarSelProcessor(
                        root, device="cpu", **kw))):
        with jax_inline_ingest():
            assert proc(r).run() == 0
            selected = _read(r, "ColumnConfig.json")
            assert proc(r, list_vars=True).run() == 0
            assert _read(r, "ColumnConfig.json") == selected
            assert proc(r, reset=True).run() == 0
    reset = _read(roots[1], "ColumnConfig.json")
    assert reset == _read(roots[0], "ColumnConfig.json")
    assert not any(c.final_select for c in load_column_config_list(
        os.path.join(roots[1], "ColumnConfig.json")))
    assert VarSelProcessor(roots[1], recover=True, device="cpu").run() == 0
    assert _read(roots[1], "ColumnConfig.json") == _read(
        varsel_set, "ColumnConfig.json")
    shutil.rmtree(os.path.join(roots[1], "tmp", "varsel"))
    with pytest.raises(Exception, match="no varsel backup"):
        VarSelProcessor(roots[1], recover=True, device="cpu").run()


@pytest.mark.parametrize("filter_by,item", [("VOTED", "A.14")])
def test_wrappers_that_wait_exit_2(varsel_set, tmp_path, monkeypatch, capsys,
                                   filter_by, item):
    root = _pair(varsel_set, tmp_path, dict(filterBy=filter_by))[1]
    before = _read(root, "ColumnConfig.json")
    monkeypatch.chdir(root)
    assert cli.main(["varsel", "--device", "cpu"]) == 2
    assert f"ROADMAP {item}" in capsys.readouterr().err
    assert _read(root, "ColumnConfig.json") == before
    assert not os.path.exists(os.path.join(root, "tmp", "varsel"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailable):
        VarSelProcessor(root)


# ---- the SE/ST sensitivity wrapper -----------------------------------------


@pytest.mark.parametrize("se_type", ["SE", "ST"])
def test_sensitivity_scores_match_jax(varsel_set, se_type):
    """The knockout scan on the same params and matrix: rtol 1e-4 (f32
    means summed in another order)."""
    from shifu_tpu.models.nn import init_params
    from shifu_tpu_torch.norm.dataset import load_normalized

    _meta, feats, tags, _w = load_normalized(
        os.path.join(varsel_set, "tmp", "norm", "NormalizedData"))
    feats = np.asarray(feats, np.float32)
    tags = np.asarray(tags, np.float32)
    params = init_params([feats.shape[1], 6, 1], seed=4)
    acts = ["tanh"]
    want = jsel.sensitivity_scores(params, acts, feats, tags, se_type)
    got = psel.sensitivity_scores(params, acts, feats, tags, se_type,
                                  device="cpu")
    assert got.shape == want.shape == (feats.shape[1],)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-9)
    if se_type == "SE":
        assert (got >= 0).all() and got.max() > 0


def _se_rows(root):
    with open(os.path.join(root, "tmp", "varsel", "se.csv")) as fh:
        rows = [ln.strip().split(",") for ln in fh]
    assert rows[0] == ["column", "score"]
    return [(name, float(score)) for name, score in rows[1:]]


@pytest.mark.parametrize("filter_by", ["SE", "ST"])
def test_varsel_sensitivity_step_matches_jax(varsel_set, tmp_path, filter_by):
    """The wrapper model trains in each package (tolerance of
    tests/test_torch_nn_trainer.py), so the scores differ in the last
    digits: the port selects the JAX varsel's columns and writes se.csv
    with its names in its order, scores within rel 1e-3."""
    conf = dict(filterBy=filter_by, filterNum=6, forceEnable=True,
                forceSelectColumnNameFile="force.select")
    roots = _pair(varsel_set, tmp_path, conf)
    with jax_inline_ingest():
        assert JVarSelProcessor(roots[0]).run() == 0
    cwd = os.getcwd()
    try:
        os.chdir(roots[1])
        assert cli.main(["varsel", "--device", "cpu"]) == 0
    finally:
        os.chdir(cwd)
    got, want = _se_rows(roots[1]), _se_rows(roots[0])
    assert [n for n, _ in got] == [n for n, _ in want]
    assert [s for _, s in got] == pytest.approx([s for _, s in want],
                                                rel=1e-3, abs=1e-7)
    cols = [load_column_config_list(os.path.join(r, "ColumnConfig.json"))
            for r in roots]
    assert _flags(cols[1]) == _flags(cols[0])
    n_sel = sum(c.final_select for c in cols[1])
    assert 2 < n_sel <= 6 and {"num_7", "cat_1"} <= {
        c.column_name for c in cols[1] if c.final_select}

"""The port's raw-record scorer vs the JAX package's.

* `IndependentTreeModel.codes_from_raw` equal to the JAX codes on numeric,
  categorical and hybrid columns with missing and invalid tokens.
* `ModelRunner.score_raw` on one model set holding two bagged `.nn`, a
  `.gbt` and a `.rf` (trained once by the JAX steps): NN scores within
  rtol 1e-5 (torch's exp/tanh against XLA's), trees within rtol 1e-6, the
  names and widths equal, the median of the even model count numpy's
  (the mean of the two middle values).
* The per-batch caches invalidate by weakref identity, as
  `tests/test_eval.py` pins for the JAX runner.
* `.wdl` models raise naming ROADMAP A.12, reference-format files A.14.
* The score-file reader against `pd.read_csv(path, sep="|")` on a JAX
  score file (meta and reason columns, invalid tags), bit for bit.
"""

import gc
import json
import os
import shutil

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from shifu_tpu.config.model_config import Algorithm as JAlgorithm  # noqa: E402
from shifu_tpu.config.model_config import ModelConfig as JModelConfig  # noqa: E402
from shifu_tpu.data import reader as jreader  # noqa: E402
from shifu_tpu.eval import scorer as jscorer  # noqa: E402
from shifu_tpu.models import tree as jtree  # noqa: E402
from shifu_tpu_torch.data import reader as preader  # noqa: E402
from shifu_tpu_torch.eval import scorer as pscorer  # noqa: E402
from shifu_tpu_torch.eval.scorefile import read_score_file  # noqa: E402
from shifu_tpu_torch.models import tree as ptree  # noqa: E402
from tests.helpers import make_binary_dataset, write_dataset  # noqa: E402
from tests.test_torch_config import (jax_inline_ingest,  # noqa: E402
                                     prepare_model_set)

NN_RTOL = 1e-5
TREE_RTOL = 1e-6


def _columnar(pkg_reader, names, cols):
    return pkg_reader.ColumnarData(
        names=names, raw={n: np.asarray(c, dtype=object)
                          for n, c in zip(names, cols)},
        n_rows=len(cols[0]))


def test_codes_from_raw_equal_to_jax():
    rng = np.random.default_rng(5)
    n = 400
    num = [f"{v:.4f}" for v in rng.normal(size=n)]
    cat = list(rng.choice(["red", " blue", "green ", "teal", "?", ""],
                          size=n))
    hyb = list(rng.choice(["1.5", "-3", "7.25", "x", "y", "?", "abc", "inf",
                           " 2 ", "1e3"], size=n))
    for i in rng.choice(n, size=30, replace=False):
        num[i] = rng.choice(["", "?", "null", "nan", "zz", "inf"])
    names = ["num", "cat", "hyb", "plain"]
    cols = [num, cat, hyb, num]
    kw = dict(algorithm="RF", trees=[], input_columns=names,
              slots=[6, 4, 8, 2],
              boundaries=[[-np.inf, -0.5, 0.0, 0.5, 1.5], None,
                          [-np.inf, 0.0, 2.0], []],
              categories=[None, ["red", "blue", "green"], ["x", "y"], None])
    want = jtree.IndependentTreeModel(jtree.TreeModelSpec(**kw)) \
        .codes_from_raw(_columnar(jreader, names, cols))
    got = ptree.IndependentTreeModel(ptree.TreeModelSpec(**kw),
                                     device="cpu") \
        .codes_from_raw(_columnar(preader, names, cols))
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    # every bin kind was reached: missing slots, category slots, hybrid
    assert (got[:, 0] == 5).any() and (got[:, 1] == 3).any()
    assert (got[:, 2] >= 3).any() and (got[:, 2] == 5).any()
    assert (got[:, 3] == 0).any()


def _train_copy(src, dst, alg, **params):
    """Train `alg` with the JAX step on a copy of `src`; the model path."""
    from shifu_tpu.processor.train import TrainProcessor

    shutil.copytree(src, dst)
    path = os.path.join(dst, "ModelConfig.json")
    mc = JModelConfig.load(path)
    mc.train.algorithm = JAlgorithm.parse(alg)
    mc.train.params = dict(params)
    mc.save(path)
    with jax_inline_ingest():
        assert TrainProcessor(dst).run() == 0
    suffix = {"GBT": "gbt", "RF": "rf"}[alg]
    return os.path.join(dst, "models", f"model0.{suffix}")


def _eval_data(root):
    """A held-out eval file (another seed), a few rows with an invalid
    target, plus a meta-column list and a reason-code map."""
    names, rows, _ = make_binary_dataset(n_rows=300, seed=99)
    rows += [["?"] + r[1:] for r in rows[:7]]
    data, header = write_dataset(os.path.join(root, "evaldata"), names, rows)
    with open(os.path.join(root, "meta.txt"), "w") as fh:
        fh.write("cat_0\nnum_9\n")
    with open(os.path.join(root, "codes.txt"), "w") as fh:
        fh.write("num_0,R0\nnum_3,R3\n")
    return data, header


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    """One model set: model0.nn, model1.nn (bagging 2), model2.gbt,
    model3.rf; an eval set on held-out rows."""
    base = tmp_path_factory.mktemp("mixed")
    src = prepare_model_set(str(base / "src"), "binary", rows=400, alg="NN")
    path = os.path.join(src, "ModelConfig.json")
    mc = JModelConfig.load(path)
    mc.train.bagging_num = 2
    mc.train.num_train_epochs = 15
    mc.save(path)
    gbt = _train_copy(src, str(base / "gbt"), "GBT", TreeNum=4, MaxDepth=3,
                      LearningRate=0.3)
    rf = _train_copy(src, str(base / "rf"), "RF", TreeNum=3, MaxDepth=4)
    from shifu_tpu.processor.train import TrainProcessor

    with jax_inline_ingest():
        assert TrainProcessor(src).run() == 0
    shutil.copy(gbt, os.path.join(src, "models", "model2.gbt"))
    shutil.copy(rf, os.path.join(src, "models", "model3.rf"))
    data, header = _eval_data(src)
    mc = JModelConfig.load(path)
    ev = mc.evals[0]
    ev.data_set.data_path, ev.data_set.header_path = data, header
    ev.data_set.weight_column_name = "num_2"  # exercises the :g weights
    ev.score_meta_column_name_file = "meta.txt"
    mc.save(path)
    return src


def _read(pkg_reader, root):
    mc = JModelConfig.load(os.path.join(root, "ModelConfig.json"))
    ds = mc.evals[0].data_set
    names = pkg_reader.read_header(ds.header_path)
    return pkg_reader.read_columnar(ds.data_path, names)


def test_score_raw_matches_jax(mixed):
    paths = pscorer.find_model_paths(os.path.join(mixed, "models"))
    assert [os.path.basename(p) for p in paths] == [
        "model0.nn", "model1.nn", "model2.gbt", "model3.rf"]
    assert paths == jscorer.find_model_paths(os.path.join(mixed, "models"))
    want = jscorer.ModelRunner(paths).score_raw(_read(jreader, mixed))
    runner = pscorer.ModelRunner(paths, device="cpu")
    got = runner.score_raw(_read(preader, mixed))
    assert got.model_names == want.model_names
    assert got.model_widths == want.model_widths == [1, 1, 1, 1]
    assert got.model_scores.dtype == want.model_scores.dtype == np.float32
    np.testing.assert_allclose(got.model_scores[:, :2],
                               want.model_scores[:, :2], rtol=NN_RTOL)
    np.testing.assert_allclose(got.model_scores[:, 2:],
                               want.model_scores[:, 2:], rtol=TREE_RTOL)
    for k in ("mean", "max", "min", "median"):
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype == np.float32, k
        np.testing.assert_allclose(a, b, rtol=NN_RTOL, err_msg=k)
    # an even count: numpy's median averages the two middle values,
    # where torch.median would take the lower one
    mid = np.sort(got.model_scores, axis=1)[:, 1:3]
    np.testing.assert_array_equal(got.median, mid.mean(axis=1))
    lower = torch.median(torch.from_numpy(got.model_scores), dim=1).values
    assert (lower.numpy() != got.median).any()
    assert {"normalize", "codes", "forward", "aggregate"} <= set(
        runner.timings)


def _batch(cols, vals):
    return preader.ColumnarData(
        names=cols,
        raw={c: np.array([f"{v:.3f}" for v in vals], object) for c in cols},
        n_rows=len(vals))


def test_batch_cache_survives_address_reuse(tmp_path):
    """The per-batch caches invalidate by object identity held weakly,
    never by id() (a freed batch's address is reused by the next)."""
    from shifu_tpu_torch.models.nn import NNModelSpec, init_params

    cols = [f"c{i}" for i in range(3)]
    sizes = [3, 4, 1]
    specs = [{"name": c, "kind": "value", "outNames": [c],
              "mean": 0.0, "std": 1.0, "fill": 0.0, "zscore": True}
             for c in cols]
    path = str(tmp_path / "model0.nn")
    NNModelSpec(layer_sizes=sizes, activations=["tanh"],
                input_columns=cols, norm_specs=specs,
                params=init_params(sizes, seed=0)).save(path)
    runner = pscorer.ModelRunner([path], device="cpu")
    fresh = runner.score_raw(_batch(cols, [2.0, -2.0])).mean.copy()
    d1 = _batch(cols, [0.5, 0.25])
    runner.score_raw(d1)
    assert runner._cached_data_ref() is d1
    del d1
    gc.collect()
    assert runner._cached_data_ref() is None  # dead -> must invalidate
    again = runner.score_raw(_batch(cols, [2.0, -2.0])).mean
    np.testing.assert_array_equal(again, fresh)


def test_unported_model_kinds_raise(mixed, tmp_path):
    nn = os.path.join(mixed, "models", "model0.nn")
    wdl = str(tmp_path / "model0.wdl")
    shutil.copy(nn, wdl)
    with pytest.raises(NotImplementedError, match="A.12"):
        pscorer.load_model(wdl)
    with pytest.raises(NotImplementedError, match="A.12"):
        pscorer.ModelRunner([nn, wdl], device="cpu")
    for i, head in enumerate((b"encog,BasicNetwork,java,3.0.0\n",
                              b"\x1f\x8b\x08\x00rest", b"PK\x03\x04rest")):
        for suffix in ("nn", "rf"):
            path = str(tmp_path / f"model{i}.{suffix}")
            with open(path, "wb") as fh:
                fh.write(head + b"\x00" * 16)
            with pytest.raises(NotImplementedError, match="A.14"):
                pscorer.load_model(path)
    with pytest.raises(ValueError, match="no models"):
        pscorer.ModelRunner([], device="cpu")


def test_score_file_reader_matches_read_csv(mixed, tmp_path):
    import pandas as pd
    from shifu_tpu.processor.evaluate import EvalProcessor

    root = str(tmp_path / "jax")
    shutil.copytree(mixed, root)
    path = os.path.join(root, "ModelConfig.json")
    mc = JModelConfig.load(path)
    # reasons need binAvgScore: give two columns a table by hand
    mc.evals[0].custom_paths = {"reasonCodePath": "codes.txt"}
    mc.save(path)
    cc_path = os.path.join(root, "ColumnConfig.json")
    with open(cc_path) as fh:
        ccs = json.load(fh)
    for cc in ccs:
        if cc["columnName"] in ("num_0", "num_3"):
            cc["finalSelect"] = True
            n_bins = len(cc["columnBinning"]["binBoundary"]) + 1
            cc["columnBinning"]["binAvgScore"] = [
                float(100 * i + len(cc["columnName"])) for i in range(n_bins)]
    with open(cc_path, "w") as fh:
        json.dump(ccs, fh, indent=2)
    with jax_inline_ingest():
        assert EvalProcessor(root, score_name="").run() == 0
    score = os.path.join(root, "evals", "Eval1", "EvalScore.csv")
    df = pd.read_csv(score, sep="|")
    assert {"cat_0", "num_9", "reasons"} <= set(df.columns)
    assert (df["tag"] < 0).sum() == 7
    df = df[df["tag"] >= 0]
    cols = [c for c in df.columns if c not in ("tag", "weight", "cat_0",
                                               "num_9", "reasons")]
    assert cols == ["mean", "max", "min", "median", "model0", "model1",
                    "model2", "model3"]
    table = read_score_file(score, cols)
    assert table.tag.dtype == df["tag"].to_numpy().dtype == np.int64
    np.testing.assert_array_equal(table.tag, df["tag"].to_numpy())
    for name, got in [("weight", table.weight)] + [
            (c, table.columns[c]) for c in cols]:
        want = df[name].to_numpy(dtype=np.float64)
        assert got.dtype == np.float64
        assert got.view(np.int64).tolist() == want.view(np.int64).tolist(), \
            name
    assert len(set(table.weight.tolist())) > 10  # weights other than 1

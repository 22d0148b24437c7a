"""The port's serving registry (`shifu_tpu_torch/serve/registry.py`) vs the
JAX package's registry and scorer, and vs the port's own `ModelRunner`.

One NN model set per norm kind is trained by the JAX steps (`make_model_set`,
300 rows, bagging 3, 25 epochs): HYBRID (value columns + a woe table), ZSCALE_ONEHOT
(value columns + one-hot on the device) and ZSCALE (value columns +
posrate tables). Both packages load the same `models/`.

* Parity: on records holding floats, ints, None, absent fields, unseen and
  non-ASCII categories and missing tokens, the port's five outputs are
  within 2e-3 score units of the JAX `ModelRunner` (the JAX package's own
  fused-vs-runner gate, tests/test_serve.py), and of the JAX
  `ModelRegistry` wherever that runs: with a string value column holding
  a token `float()` rejects it fails on the read-only buffer of ROADMAP
  C.1, which the port does not have.
* The port's `ModelRunner`: within the same tolerance at any row count;
  at a row count that is a bucket's, the model scores (so max, min,
  median) bit for bit (a GEMM's bits depend on its row count, on the CPU
  as on the card); at any count, max/min/median equal numpy's over the
  registry's own model scores, as the runner aggregates.
* The median of an even model count is the midpoint (`torch.median`
  would take the lower value), of an odd count the middle value.
* A NATIVE set serves K columns a model, in the JAX column order.
* JSON and binary bodies score bit for bit alike; absent fields score as
  missing tokens; a 19-digit token (ROADMAP C.6) scores as in the
  offline runner.
* Row buckets, one staging copy each way a batch, staging reuse with
  zeroed pad rows, the tree fallback, the sha, what waits.
"""

import json
import os
import shutil

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from shifu_tpu.eval import scorer as jscorer  # noqa: E402
from shifu_tpu.serve import registry as jregistry  # noqa: E402
from shifu_tpu_torch.eval import scorer as pscorer  # noqa: E402
from shifu_tpu_torch.models.nn import NNModelSpec, init_params  # noqa: E402
from shifu_tpu_torch.serve import registry as pregistry  # noqa: E402
from shifu_tpu_torch.serve import wire as pwire  # noqa: E402
from tests.helpers import make_model_set  # noqa: E402
from tests.test_torch_config import jax_inline_ingest  # noqa: E402

ATOL = 2e-3  # score units (0..1000): tests/test_serve.py's fused gate
KINDS = ["HYBRID", "ZSCALE_ONEHOT", "ZSCALE"]
OUTPUTS = ("model_scores", "mean", "max", "min", "median")

_SETS = {}


def jax_model_set(kind, factory):
    """An NN model set trained by the JAX steps with norm type `kind`,
    made once a module."""
    if kind not in _SETS:
        from shifu_tpu.processor.init import InitProcessor
        from shifu_tpu.processor.norm import NormProcessor
        from shifu_tpu.processor.stats import StatsProcessor
        from shifu_tpu.processor.train import TrainProcessor

        root = str(factory.mktemp(f"serve_{kind.lower()}"))
        make_model_set(root, n_rows=300)
        path = os.path.join(root, "ModelConfig.json")
        mc = json.load(open(path))
        mc["normalize"]["normType"] = kind
        mc["train"]["numTrainEpochs"] = 25
        mc["train"]["baggingNum"] = 3
        json.dump(mc, open(path, "w"), indent=2)
        with jax_inline_ingest():
            for proc in (InitProcessor, StatsProcessor, NormProcessor,
                         TrainProcessor):
                assert proc(root).run() == 0
        _SETS[kind] = root
    return _SETS[kind]


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    return lambda kind: jax_model_set(kind, tmp_path_factory)


def _models(root):
    return os.path.join(root, "models")


def parity_records(cols, n=12, seed=3, tokens=True):
    """Floats, ints, None, an absent field, unseen and non-ASCII
    categories; with `tokens`, string missing tokens ("?", "") and a
    string number in the value columns too."""
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n):
        r = {}
        for j, c in enumerate(cols):
            if c.startswith("cat"):
                r[c] = ["red", "green", "blüe-∅", "never-seen", "?",
                        "blue", "violet"][(i + j) % 7]
            else:
                r[c] = float(np.round(rng.normal(), 5))
        recs.append(r)
    num = [c for c in cols if not c.startswith("cat")]
    recs[0][num[0]] = None
    del recs[1][num[1]]
    del recs[1]["cat_0"]
    for r in recs:  # an all-int value column (the i64 path)
        r[num[2]] = int(rng.integers(-3, 4))
    if tokens:  # "1e400" is past f64: +inf, then the fill
        for i, c, tok in ((3, num[0], "?"), (4, num[0], ""),
                          (5, num[0], "1.25"), (6, num[3], "1e400")):
            if i < n:
                recs[i][c] = tok
    return recs


def jax_runner_result(models_dir, cols, recs):
    runner = jscorer.ModelRunner(jscorer.find_model_paths(models_dir))
    return runner.score_raw(jregistry.records_to_columnar(recs, cols))


def assert_close(got, want, atol=ATOL):
    for k in OUTPUTS:
        a, b = np.asarray(getattr(got, k)), np.asarray(getattr(want, k))
        assert a.shape == b.shape, k
        np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=k)


def assert_bits(got, want, keys=OUTPUTS):
    for k in keys:
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k),
                                      err_msg=k)


@pytest.mark.parametrize("kind", KINDS)
def test_parity_with_jax(sets, kind):
    root = sets(kind)
    reg = pregistry.ModelRegistry(_models(root), device="cpu")
    assert reg.fused
    jreg = jregistry.ModelRegistry(_models(root))
    assert reg.input_columns == jreg.input_columns
    cols = reg.input_columns
    ran_jax_registry = 0
    for tokens in (False, True):
        recs = parity_records(cols, tokens=tokens)
        got = reg.score_records(recs)
        want = jax_runner_result(_models(root), cols, recs)
        assert_close(got, want)
        assert got.model_names == want.model_names == jreg.model_names
        assert got.model_widths == want.model_widths == jreg.model_widths
        try:
            jgot = jreg.score_records(recs)
        except ValueError as e:  # ROADMAP C.1 in the reference
            assert "read-only" in str(e)
            continue
        ran_jax_registry += 1
        assert_close(got, jgot)
    assert ran_jax_registry >= 1  # the typed records reach it


@pytest.mark.parametrize("kind", KINDS)
def test_against_port_runner(sets, kind):
    root = sets(kind)
    reg = pregistry.ModelRegistry(_models(root), device="cpu")
    runner = pscorer.ModelRunner(pscorer.find_model_paths(_models(root)),
                                 device="cpu")
    cols = reg.input_columns
    for n in (11, 16):
        recs = parity_records(cols, n=n)
        got = reg.score_records(recs)
        want = runner.score_raw(pregistry.records_to_columnar(recs, cols))
        assert_close(got, want)
        m = got.model_scores
        np.testing.assert_array_equal(got.max, m.max(axis=1))
        np.testing.assert_array_equal(got.min, m.min(axis=1))
        np.testing.assert_array_equal(got.median, np.median(m, axis=1))
        if n == reg.bucket(n):  # the runner's GEMMs have the same shape
            assert_bits(got, want, ("model_scores", "max", "min",
                                    "median"))


def _bagged_set(src_root, dst, n_models, out_dim=1):
    """`n_models` models on the norm plan of the set's model0.nn, weights
    from seeds 0.. (NATIVE with `out_dim` classes)."""
    base = NNModelSpec.load(os.path.join(_models(src_root), "model0.nn"))
    os.makedirs(dst)
    sizes = list(base.layer_sizes[:-1]) + [out_dim]
    for b in range(n_models):
        NNModelSpec(
            layer_sizes=sizes, activations=base.activations,
            input_columns=base.input_columns, norm_type=base.norm_type,
            norm_specs=base.norm_specs, norm_cutoff=base.norm_cutoff,
            params=init_params(sizes, seed=b),
            class_tags=(["a", "b", "c"][:out_dim] if out_dim > 1 else []),
        ).save(os.path.join(dst, f"model{b}.nn"))
    return dst


@pytest.mark.parametrize("n_models", [2, 3, 4])
def test_median_even_takes_midpoint(sets, tmp_path, n_models):
    d = _bagged_set(sets("HYBRID"), str(tmp_path / "m"), n_models)
    reg = pregistry.ModelRegistry(d, device="cpu")
    runner = pscorer.ModelRunner(pscorer.find_model_paths(d), device="cpu")
    recs = parity_records(reg.input_columns, n=16)
    got = reg.score_records(recs)
    m = got.model_scores
    s = np.sort(m, axis=1)
    if n_models % 2:
        np.testing.assert_array_equal(got.median, s[:, n_models // 2])
    else:
        mid = (s[:, n_models // 2 - 1] + s[:, n_models // 2]) * np.float32(.5)
        np.testing.assert_array_equal(got.median, mid)
        lower = torch.median(torch.from_numpy(m), dim=1).values.numpy()
        assert (lower != got.median).any()  # the lower value is not it
    want = runner.score_raw(pregistry.records_to_columnar(
        recs, reg.input_columns))
    assert_bits(got, want, ("model_scores", "median"))


def test_native_set_serves_k_columns(sets, tmp_path):
    d = _bagged_set(sets("ZSCALE_ONEHOT"), str(tmp_path / "m"), 2, out_dim=3)
    reg = pregistry.ModelRegistry(d, device="cpu")
    cols = reg.input_columns
    recs = parity_records(cols)
    got = reg.score_records(recs)
    want = jax_runner_result(d, cols, recs)
    assert got.model_widths == want.model_widths == [3, 3]
    assert got.model_scores.shape == (len(recs), 6)
    assert_close(got, want)
    jgot = jregistry.ModelRegistry(d).score_records(
        parity_records(cols, tokens=False))
    assert_close(reg.score_records(parity_records(cols, tokens=False)),
                 jgot)


@pytest.mark.parametrize("kind", KINDS)
def test_json_and_binary_bit_identical(sets, kind):
    reg = pregistry.ModelRegistry(_models(sets(kind)), device="cpu")
    recs = parity_records(reg.input_columns)
    via_json = reg.score_records(recs)
    decoded = pwire.decode(pwire.encode_records(recs))
    assert decoded.wire_format == "binary"
    via_bin = reg.score_raw(pwire.conform_columns(decoded,
                                                  reg.input_columns))
    assert_bits(via_bin, via_json)


def test_nineteen_digit_token_scores_as_offline(sets):
    """ROADMAP C.6: the JAX serve parse reads a 19-digit token as
    another double than its offline parse; the port has one grammar."""
    from shifu_tpu.data import reader as jreader
    from shifu_tpu_torch.data import reader as preader

    tok = "0.1234567890123456789"
    jdata = jreader.ColumnarData(names=["a"], raw={
        "a": np.asarray([tok, "2.5"], dtype=object)}, n_rows=2)
    fast = jreader.flat_numeric_matrix(jdata, ["a"])[0, 0]
    offline = jdata.numeric("a")[0]
    assert fast == 0.12345678901234568 and offline == 0.1234567890123456
    assert fast != offline
    pdata = preader.ColumnarData(names=["a"], raw={
        "a": np.asarray([tok, "2.5"], dtype=object)}, n_rows=2)
    assert preader.flat_numeric_matrix(pdata, ["a"])[0, 0] == offline
    assert pdata.numeric("a")[0] == offline

    root = sets("ZSCALE")
    reg = pregistry.ModelRegistry(_models(root), device="cpu")
    runner = pscorer.ModelRunner(pscorer.find_model_paths(_models(root)),
                                 device="cpu")
    recs = parity_records(reg.input_columns, n=8)
    for r in recs:
        r["num_0"] = tok
    got = reg.score_records(recs)
    want = runner.score_raw(pregistry.records_to_columnar(
        recs, reg.input_columns))
    assert_bits(got, want, ("model_scores", "max", "min", "median"))


def test_missing_fields_score_like_missing_tokens(sets):
    reg = pregistry.ModelRegistry(_models(sets("HYBRID")), device="cpu")
    base = {c: "0.5" if c.startswith("num") else "red"
            for c in reg.input_columns}
    with_tokens = dict(base, num_0="?", cat_0="")
    without = {k: v for k, v in with_tokens.items()
               if k not in ("num_0", "cat_0")}
    assert_bits(reg.score_records([without]),
                reg.score_records([with_tokens]))


def test_row_buckets(sets):
    reg = pregistry.ModelRegistry(_models(sets("HYBRID")), device="cpu")
    assert [reg.bucket(n) for n in (1, 5, 8)] == [8, 8, 8]
    assert [reg.bucket(n) for n in (9, 16, 17, 300)] == [16, 16, 32, 512]
    assert reg.warm([1, 3, 16]) == [8, 16]
    assert reg.snapshot()["warmBuckets"] == [8, 16]
    rec = {c: "0.1" for c in reg.input_columns}
    for n in range(1, 301, 7):
        reg.score_records([rec] * n)
    buckets = reg.snapshot()["warmBuckets"]
    assert set(buckets) <= {8, 16, 32, 64, 128, 256, 512}
    assert len(buckets) == 7


def test_one_copy_each_way_and_staging_reuse(sets):
    reg = pregistry.ModelRegistry(_models(sets("HYBRID")), device="cpu")
    recs = parity_records(reg.input_columns, n=5)
    r1 = reg.score_records(recs)
    st = reg._staging[reg.bucket(5)]
    assert reg.transfers == {"h2d": 1, "d2h": 1}
    r2 = reg.score_records(recs)
    assert reg.transfers == {"h2d": 2, "d2h": 2}
    assert reg._staging[reg.bucket(5)] is st  # the same buffer
    assert st.view.dtype == np.float32 and st.view.ndim == 2
    assert_bits(r1, r2)
    # a shorter batch after a longer one: the pad rows are zeroed
    r3 = reg.score_records(recs[:2])
    assert not st.view[2:].any()
    assert_bits(r3, r1, ())
    np.testing.assert_array_equal(r3.model_scores, r1.model_scores[:2])
    snap = reg.snapshot()
    assert snap["transfers"] == {"h2d": 3, "d2h": 3}
    assert snap["stagingBytes"] == st.nbytes > 0
    assert set(snap["timings"]) == {"featurize", "device", "d2h"}


def test_tree_set_takes_the_runner(tmp_path):
    from shifu_tpu_torch.train.tree_trainer import (TreeTrainConfig,
                                                    train_trees)

    rng = np.random.default_rng(0)
    n = 400
    bounds = [-np.inf, -1.0, 0.0, 1.0]
    cats = ["aa", "bb", "cc"]
    x_num = rng.normal(size=n)
    x_cat = rng.integers(0, 3, size=n)
    codes = np.stack([np.searchsorted(bounds, x_num, side="right") - 1,
                      x_cat], axis=1).astype(np.int32)
    y = ((x_num > 0) | (x_cat == 1)).astype(np.float32)
    cfg = TreeTrainConfig(algorithm="GBT", tree_num=3, max_depth=3,
                          learning_rate=0.3, valid_set_rate=0.1, seed=3,
                          min_instances_per_node=1)
    res = train_trees(codes, y, np.ones(n, np.float32), [5, 4],
                      [False, True], ["num0", "cat0"], cfg,
                      boundaries=[[float(b) for b in bounds], None],
                      categories=[None, cats], device="cpu")
    models_dir = str(tmp_path / "models")
    os.makedirs(models_dir)
    res.spec.save(os.path.join(models_dir, "model0.gbt"))
    reg = pregistry.ModelRegistry(models_dir, device="cpu")
    assert not reg.fused
    assert reg.input_columns == ["num0", "cat0"]
    assert reg.warm([1]) == [8]
    assert reg.snapshot()["fused"] is False
    recs = [{"num0": f"{x_num[i]:.5f}", "cat0": cats[x_cat[i]]}
            for i in range(10)] + [{"num0": None, "cat0": "zz"}]
    got = reg.score_records(recs)
    want = pscorer.ModelRunner([os.path.join(models_dir, "model0.gbt")],
                               device="cpu").score_raw(
        pregistry.records_to_columnar(recs, reg.input_columns))
    assert_bits(got, want)


def test_sha_tracks_content(sets, tmp_path):
    d = str(tmp_path / "a")
    shutil.copytree(_models(sets("HYBRID")), d)
    paths = pscorer.find_model_paths(d)
    sha = pregistry.model_set_sha(paths)
    assert sha == jregistry.model_set_sha(paths)
    with open(paths[0], "ab") as fh:
        fh.write(b"\0")
    assert pregistry.model_set_sha(paths) != sha


def test_what_waits_raises(sets, tmp_path):
    """A `.wdl` set (the registry raised naming A.12 before WDL was
    ported) is served through the ModelRunner fallback: its schema holds
    the categorical columns, its scores are the port runner's bit for
    bit and the JAX runner's within ATOL. The JAX registry leaves the
    categorical columns out of its schema and fails on the same records
    (ROADMAP C.10). What waits for A.14 (`drift=`) still raises."""
    from shifu_tpu_torch.models import wdl as pwdl
    from tests.test_torch_serve import CATS, NUM, records

    d = str(tmp_path / "wdl")
    rng = np.random.default_rng(3)
    norm = [{"name": c, "kind": "value", "outNames": [c], "fill": 0.0,
             "mean": float(rng.normal()), "std": 1.5, "zscore": True,
             "boundaries": [float("-inf"), 0.0]} for c in NUM]
    cats = ["cat_0", "cat_1"]
    for b in range(2):
        p = pwdl.init_wdl_params(len(NUM), [4, 4], 3, [8], seed=b)
        flat = pwdl.flatten_wdl(p) + rng.normal(
            scale=0.3, size=pwdl.flatten_wdl(p).size).astype(np.float32)
        pwdl.WDLModelSpec(
            hidden=[8], activations=["relu"], embed_dim=3,
            dense_columns=NUM, cat_columns=cats, vocab_sizes=[4, 4],
            norm_specs=norm, categories=[CATS, CATS],
            params=pwdl.unflatten_wdl(flat.astype(np.float32), p)).save(
            os.path.join(d, f"model{b}.wdl"))
    reg = pregistry.ModelRegistry(d, device="cpu")
    assert not reg.fused
    assert reg.input_columns == NUM + cats
    assert reg.warm([1]) == [8]
    recs = records(16)
    got = reg.score_records(recs)
    cols = reg.input_columns
    want = pscorer.ModelRunner(pscorer.find_model_paths(d),
                               device="cpu").score_raw(
        pregistry.records_to_columnar(recs, cols))
    assert_bits(got, want)
    assert_close(got, jax_runner_result(d, cols, recs))
    jreg = jregistry.ModelRegistry(d)
    assert jreg.input_columns == NUM
    with pytest.raises(KeyError, match="cat_0"):
        jreg.score_records(recs)
    with pytest.raises(NotImplementedError, match="A.14"):
        pregistry.ModelRegistry(_models(sets("HYBRID")), device="cpu",
                                drift=object())


def test_interleaved_plan_matches_runners(tmp_path):
    """A plan whose specs interleave one-hot, value and table columns:
    the device pieces go back in spec order (a column permutation) and a
    table column after a one-hot one is gathered by position."""
    from tests.test_torch_serve import records, write_model_set

    root = write_model_set(str(tmp_path / "set"))
    models = _models(root)
    for path in pscorer.find_model_paths(models):
        spec = NNModelSpec.load(path)
        by = {d["name"]: d for d in spec.norm_specs}
        order = ["cat_1", "num_0", "num_1", "cat_0", "num_2", "num_3"]
        spec.norm_specs = [by[c] for c in order]
        spec.save(path)
    reg = pregistry.ModelRegistry(models, device="cpu")
    consts = pregistry._PlanConsts(reg._plans[0], torch.device("cpu"))
    assert consts.order is not None
    assert not isinstance(consts.tab_positions, slice)
    cols = reg.input_columns
    assert cols == order
    recs = records(16)
    got = reg.score_records(recs)
    want = pscorer.ModelRunner(pscorer.find_model_paths(models),
                               device="cpu").score_raw(
        pregistry.records_to_columnar(recs, cols))
    assert_bits(got, want, ("model_scores", "max", "min", "median"))
    assert_close(got, jax_runner_result(models, cols, recs))
    assert_close(got, jregistry.ModelRegistry(models).score_records(recs))

"""The port's `shifu norm` vs the JAX package's, on the CPU.

Both normalizers read ONE `ColumnConfig.json` (the JAX init + stats
output, copied): the two stats steps agree byte for byte only on integral
data, so a shared config is what makes the normalized matrix comparable.

Tolerances: none. For every NormType the port's plan JSON is the JAX
plan's, its normalized matrix is bit-equal to the JAX `apply_norm_plan`
(jit kernels on the CPU; XLA computes the clamp bounds mean ∓ cutoff·std
as an f32 product then an f32 sum, not a fused multiply-add, and the
port's `value_params` does the same on the host), and its bin codes are
exact. `NormProcessor` writes byte-identical meta.json and .npy shards
for NormalizedData and CleanedData.
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
from shifu_tpu.config.column_config import ColumnType as JColumnType  # noqa: E402
from shifu_tpu.config.column_config import (  # noqa: E402
    save_column_config_list as jsave_cc,
)
from shifu_tpu.config.model_config import ModelConfig as JModelConfig  # noqa: E402
from shifu_tpu.data.reader import read_columnar as jread_columnar  # noqa: E402
from shifu_tpu.data.reader import read_header as jread_header  # noqa: E402
from shifu_tpu.norm import normalizer as jnorm  # noqa: E402
from shifu_tpu.processor.init import InitProcessor as JInitProcessor  # noqa: E402
from shifu_tpu.processor.norm import NormProcessor as JNormProcessor  # noqa: E402
from shifu_tpu.processor.stats import StatsProcessor as JStatsProcessor  # noqa: E402
from shifu_tpu_torch.config import load_column_config_list  # noqa: E402
from shifu_tpu_torch.config.model_config import ModelConfig, NormType  # noqa: E402
from shifu_tpu_torch.data.reader import read_columnar, read_header  # noqa: E402
from shifu_tpu_torch.norm import dataset as pds  # noqa: E402
from shifu_tpu_torch.norm import normalizer as pnorm  # noqa: E402
from shifu_tpu_torch.processor import norm as pnorm_proc  # noqa: E402
from shifu_tpu_torch.processor.norm import NormProcessor  # noqa: E402
from shifu_tpu_torch.utils import environment as penv  # noqa: E402
from shifu_tpu_torch.utils.platform import DeviceUnavailable  # noqa: E402
from tests.helpers import (make_binary_dataset, make_model_set,  # noqa: E402
                           make_multiclass_model_set, write_dataset)
from tests.test_torch_config import jax_inline_ingest  # noqa: E402

NORM_TYPES = [nt.value for nt in NormType]
HUGE = ("1e300", "-1e300", "3.5e38", "-3.5e38")  # finite f64, inf in f32


def _mixed_model_set(root, n=500, seed=5):
    """make_binary_dataset's numeric and categorical columns plus `mixed`,
    a numeric column with special string codes (made H after init)."""
    from shifu_tpu.config.model_config import Algorithm, new_model_config

    names, rows, y = make_binary_dataset(n_rows=n, seed=seed)
    rng = np.random.default_rng(seed)
    special = rng.random(n) < 0.2
    x = rng.normal(loc=y * 1.5, size=n)
    for i, r in enumerate(rows):
        r.append(("SP_POS" if y[i] else "SP_NEG") if special[i]
                 else f"{x[i]:.4f}")
    names = names + ["mixed"]
    data_path, header_path = write_dataset(os.path.join(root, "data"),
                                           names, rows)
    # the same rows with huge finite values in num_1 (binning on `data`
    # is unchanged; the norm reads the huge copy)
    huge_rows = [list(r) for r in rows]
    for i in range(0, n, 37):
        huge_rows[i][2] = HUGE[(i // 37) % len(HUGE)]
    write_dataset(os.path.join(root, "huge"), names, huge_rows)
    mc = new_model_config("NormParity", Algorithm.parse("NN"))
    ds = mc.data_set
    ds.data_path, ds.header_path = data_path, header_path
    ds.target_column_name, ds.pos_tags, ds.neg_tags = "diagnosis", ["M"], ["B"]
    mc.save(os.path.join(root, "ModelConfig.json"))
    return root


@pytest.fixture(scope="module")
def mixed_set(tmp_path_factory):
    """JAX init -> (mixed made H) -> JAX stats, then both packages' view
    of the same ColumnConfig.json and of the raw and huge data."""
    root = _mixed_model_set(str(tmp_path_factory.mktemp("mixed")))
    cc_path = os.path.join(root, "ColumnConfig.json")
    with jax_inline_ingest():
        assert JInitProcessor(root).run() == 0
        ccs = jload_cc(cc_path)
        for c in ccs:
            if c.column_name == "mixed":
                c.column_type = JColumnType.H
        jsave_cc(cc_path, ccs)
        assert JStatsProcessor(root).run() == 0
    kinds = {c.column_name: getattr(c.column_type, "value", None)
             for c in jload_cc(cc_path)}
    assert kinds["mixed"] == "H" and kinds["cat_0"] == "C" \
        and kinds["num_0"] == "N"
    header = os.path.join(root, "data", "header.txt")
    out = {"root": root}
    for key in ("data", "huge"):
        path = os.path.join(root, key, "data.txt")
        out["j" + key] = jread_columnar(path, jread_header(header))
        out["p" + key] = read_columnar(path, read_header(header))
    return out


def _plans(mixed_set, norm_type, cutoff=None):
    path = os.path.join(mixed_set["root"], "ModelConfig.json")
    jmc, pmc = JModelConfig.load(path), ModelConfig.load(path)
    jmc.normalize.norm_type = jmc.normalize.norm_type.parse(norm_type)
    pmc.normalize.norm_type = NormType.parse(norm_type)
    if cutoff is not None:
        jmc.normalize.std_dev_cut_off = pmc.normalize.std_dev_cut_off = cutoff
    cc_path = os.path.join(mixed_set["root"], "ColumnConfig.json")
    return (jnorm.build_norm_plan(jmc, jload_cc(cc_path)),
            pnorm.build_norm_plan(pmc, load_column_config_list(cc_path)))


def _dump(plan_json):
    return json.dumps(plan_json, indent=2).encode()


@pytest.mark.parametrize("norm_type", NORM_TYPES)
def test_plan_matrix_and_codes_match_jax(mixed_set, norm_type):
    jplan, pplan = _plans(mixed_set, norm_type)
    assert _dump(pnorm.plan_to_json(pplan)) == _dump(jnorm.plan_to_json(jplan))
    for key in ("data", "huge"):
        jcache, pcache = {}, {}
        want = jnorm.apply_norm_plan(jplan, mixed_set["j" + key],
                                     code_cache=jcache)
        got = pnorm.apply_norm_plan(pplan, mixed_set["p" + key],
                                    device="cpu", code_cache=pcache)
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        jcols = jnorm.norm_columns(jload_cc(os.path.join(
            mixed_set["root"], "ColumnConfig.json")))
        pcols = [s.cc for s in pplan.specs]
        np.testing.assert_array_equal(
            pnorm.bin_code_matrix(pcols, mixed_set["p" + key], pcache),
            jnorm.bin_code_matrix(jcols, mixed_set["j" + key], jcache))


@pytest.mark.parametrize("cutoff", [0.0, 1.3, 2.7])
def test_other_cutoffs_match_jax(mixed_set, cutoff):
    jplan, pplan = _plans(mixed_set, "ZSCALE", cutoff)
    assert _dump(pnorm.plan_to_json(pplan)) == _dump(jnorm.plan_to_json(jplan))
    np.testing.assert_array_equal(
        pnorm.apply_norm_plan(pplan, mixed_set["pdata"], device="cpu"),
        jnorm.apply_norm_plan(jplan, mixed_set["jdata"]))


def test_huge_finite_value_is_clamped_not_filled(mixed_set):
    _jplan, pplan = _plans(mixed_set, "ZSCALE")
    names = pplan.out_names
    j = names.index("num_1")
    spec = pplan.specs[j]
    assert spec.kind == "value"
    out = pnorm.apply_norm_plan(pplan, mixed_set["phuge"], device="cpu")
    raw = mixed_set["phuge"].column("num_1")
    lim = np.float32(pplan.cutoff)  # (mean ± cutoff·std - mean) / std
    rows = {tok: np.flatnonzero(raw == tok) for tok in HUGE}
    for tok in ("1e300", "3.5e38"):
        assert rows[tok].size and np.allclose(out[rows[tok], j], lim,
                                              rtol=1e-5)
    for tok in ("-1e300", "-3.5e38"):
        assert rows[tok].size and np.allclose(out[rows[tok], j], -lim,
                                              rtol=1e-5)
    missing = np.flatnonzero(raw == "")
    assert missing.size and np.all(out[missing, j] == 0.0)  # mean-filled


def test_value_norm_bounds_match_xla():
    """Values at and beside both clamp bounds, however they round: the
    port's host-made bounds clamp where XLA's do."""
    import jax

    rng = np.random.default_rng(3)
    C = 512
    mean = (rng.normal(size=C) * 10).astype(np.float32)
    std = (rng.random(C) * 5 + 0.1).astype(np.float32)
    std[:8] = np.float32(1e-6)  # degenerate columns
    cut = np.float32(3.3)
    rows = []
    for b in (mean - cut * std, mean + cut * std,
              (mean.astype(np.float64) - 3.3 * std).astype(np.float32),
              (mean.astype(np.float64) + 3.3 * std).astype(np.float32)):
        rows += [b, np.nextafter(b, np.float32(-np.inf)),
                 np.nextafter(b, np.float32(np.inf))]
    v = np.stack(rows + [np.full(C, np.inf, np.float32),
                         np.full(C, -np.inf, np.float32)]).astype(np.float32)
    zs = (rng.random(C) < 0.8).astype(np.float32)
    want = np.asarray(jax.jit(jnorm.value_norm_traced)(v, mean, std, zs, cut))
    params = [torch.from_numpy(np.ascontiguousarray(a))
              for a in pnorm.value_params(mean, std, zs, float(cut))]
    got = pnorm.value_norm(torch.from_numpy(v), *params).numpy()
    np.testing.assert_array_equal(got, want)


def test_table_norm_matches_jax():
    import jax

    rng = np.random.default_rng(4)
    tables = rng.normal(size=(7, 13)).astype(np.float32)
    codes = rng.integers(-2, 16, size=(300, 7)).astype(np.int32)
    want = np.asarray(jax.jit(jnorm.table_norm_traced)(codes, tables))
    got = pnorm.table_norm(torch.from_numpy(codes),
                           torch.from_numpy(tables)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("norm_type", ["ZSCALE", "WOE", "ZSCALE_ONEHOT",
                                       "DISCRETE_ZSCALE"])
def test_plan_from_json_round_trips(mixed_set, norm_type):
    jplan, pplan = _plans(mixed_set, norm_type)
    blob = pnorm.plan_to_json(pplan)
    back = pnorm.plan_from_json(json.loads(json.dumps(blob)))
    assert pnorm.plan_to_json(back) == blob
    jback = jnorm.plan_from_json(json.loads(json.dumps(blob)))
    np.testing.assert_array_equal(
        pnorm.apply_norm_plan(back, mixed_set["pdata"], device="cpu"),
        jnorm.apply_norm_plan(jback, mixed_set["jdata"]))
    np.testing.assert_array_equal(
        pnorm.apply_norm_plan(back, mixed_set["pdata"], device="cpu"),
        pnorm.apply_norm_plan(pplan, mixed_set["pdata"], device="cpu"))


def test_normalize_dataset_and_empty_plan(mixed_set, monkeypatch):
    path = os.path.join(mixed_set["root"], "ModelConfig.json")
    cc_path = os.path.join(mixed_set["root"], "ColumnConfig.json")
    feats, names = pnorm.normalize_dataset(
        ModelConfig.load(path), load_column_config_list(cc_path),
        mixed_set["pdata"], device="cpu")
    jfeats, jnames = jnorm.normalize_dataset(
        JModelConfig.load(path), jload_cc(cc_path), mixed_set["jdata"])
    assert names == jnames
    np.testing.assert_array_equal(feats, jfeats)
    empty = pnorm.NormPlan(specs=[], norm_type=NormType.ZSCALE, cutoff=4.0)
    with pytest.raises(ValueError, match="no columns"):
        pnorm.apply_norm_plan(empty, mixed_set["pdata"], device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailable):  # the card by default
        pnorm.apply_norm_plan(_plans(mixed_set, "ZSCALE")[1],
                              mixed_set["pdata"])


# ---- the step: NormProcessor ----------------------------------------------

def _tree_bytes(d):
    return {os.path.relpath(os.path.join(dp, f), d):
            open(os.path.join(dp, f), "rb").read()
            for dp, _dirs, files in os.walk(d) for f in files}


@pytest.fixture(scope="module")
def stats_roots(tmp_path_factory):
    """Binary and NATIVE multi-class model sets after the JAX init + stats."""
    base = tmp_path_factory.mktemp("normsets")
    out = {}
    for kind in ("binary", "native"):
        root = str(base / kind)
        if kind == "binary":
            make_model_set(root, n_rows=500, algorithm="RF")
        else:
            make_multiclass_model_set(root, n_rows=600, algorithm="RF")
        with jax_inline_ingest():
            assert JInitProcessor(root).run() == 0
            assert JStatsProcessor(root).run() == 0
        out[kind] = root
    return out


CASES = {
    "binary": ("binary", {}, False),
    "native": ("native", {}, False),
    "shuffle": ("binary", {}, True),
    "sampled": ("binary", {"sampleRate": 0.6}, False),
    "sampled_neg": ("binary", {"sampleRate": 0.5, "sampleNegOnly": True},
                    False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_norm_step_byte_identical(stats_roots, tmp_path, monkeypatch, case):
    import jax

    kind, norm_conf, shuffle = CASES[case]
    roots = [str(tmp_path / side) for side in ("jax", "port")]
    for r in roots:
        shutil.copytree(stats_roots[kind], r)
        path = os.path.join(r, "ModelConfig.json")
        with open(path) as fh:
            blob = json.load(fh)
        blob["normalize"].update(norm_conf)
        with open(path, "w") as fh:
            json.dump(blob, fh, indent=2)
    # one shard a device, as the JAX package writes on its 8 CPU devices
    monkeypatch.setattr(pnorm_proc, "default_shards",
                        lambda device: len(jax.devices()))
    with jax_inline_ingest():
        assert JNormProcessor(roots[0], shuffle=shuffle).run() == 0
    proc = NormProcessor(roots[1], shuffle=shuffle, device="cpu")
    assert proc.run() == 0
    assert set(proc.timings) >= {"read", "normalize", "write", "bincode"}
    for sub in ("NormalizedData", "CleanedData"):
        want = _tree_bytes(os.path.join(roots[0], "tmp", "norm", sub))
        got = _tree_bytes(os.path.join(roots[1], "tmp", "norm", sub))
        assert sorted(got) == sorted(want) and len(want) >= 4
        for name in want:
            assert got[name] == want[name], (sub, name)
    meta, feats, tags, w = pds.load_normalized(
        os.path.join(roots[1], "tmp", "norm", "NormalizedData"))
    assert feats.shape == (meta.n_rows, len(meta.columns))
    assert np.concatenate(list(pds.iter_shards(os.path.join(
        roots[1], "tmp", "norm", "NormalizedData")))).shape == feats.shape
    if kind == "native":
        assert meta.extra["classTags"] == ["low", "mid", "high"]
        assert abs(sum(meta.extra["classPriors"]) - 1.0) < 1e-12
    if "sampleRate" in norm_conf:
        n_all = len(open(os.path.join(roots[1], "data",
                                      "data.txt")).read().splitlines())
        assert 0 < meta.n_rows < n_all


def test_norm_routes_that_wait_raise(stats_roots, tmp_path, monkeypatch):
    """More than one host on the in-RAM route, or with -shuffle, raises
    the JAX package's ValueError; a dataset past the budget takes the
    streamed route (one chunk here: the in-RAM route's bytes) and
    `shifu.resume` without a snapshot runs fresh."""
    from shifu_tpu.data.pipeline import HostPlan as JHostPlan
    from shifu_tpu_torch.data.pipeline import HostPlan

    root = str(tmp_path / "port")
    shutil.copytree(stats_roots["binary"], root)
    jroot = str(tmp_path / "jax")
    shutil.copytree(stats_roots["binary"], jroot)
    penv.set_property("shifu.lifecycle.hosts", "2")
    try:
        with pytest.raises(ValueError) as pe:
            NormProcessor(root, device="cpu").run()
    finally:
        penv._props.pop("shifu.lifecycle.hosts", None)
    with pytest.raises(ValueError) as je:
        JNormProcessor(jroot, host_plan=JHostPlan(2, 0)).run()
    assert str(pe.value) == str(je.value)
    assert "requires the streaming norm path" in str(pe.value)
    penv.set_property("shifu.ingest.memoryBudgetMB", "0")
    try:
        with pytest.raises(ValueError) as pe:
            NormProcessor(root, shuffle=True, device="cpu",
                          host_plan=HostPlan(2, 1)).run()
    finally:
        penv._props.pop("shifu.ingest.memoryBudgetMB", None)
    assert "-shuffle is not multi-host capable" in str(pe.value)
    assert NormProcessor(root, device="cpu").run() == 0
    want = {sub: _tree_bytes(os.path.join(root, "tmp", "norm", sub))
            for sub in ("NormalizedData", "CleanedData")}
    for key, value in (("shifu.ingest.memoryBudgetMB", "0"),
                       ("shifu.resume", "true")):
        penv.set_property(key, value)
        try:
            proc = NormProcessor(root, device="cpu")
            assert proc.run() == 0
        finally:
            penv._props.pop(key, None)
        assert ("stream" in proc.timings) == (key != "shifu.resume")
        for sub, files in want.items():
            assert _tree_bytes(os.path.join(root, "tmp", "norm",
                                            sub)) == files, (key, sub)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailable):
        NormProcessor(root)

"""The port's reference model formats (`shifu_tpu_torch/compat/`) vs the
JAX package's `shifu_tpu/compat/`, on the CPU.

One model set (tests/helpers, 400 binary rows) goes through the JAX init
-> stats -> norm steps; the port trains an NN, a GBT, an RF and a WDL on
copies of it. Then:
* the java.io primitives round-trip, and modified UTF-8 encodes as the
  JAX encoder does (tests/test_compat.py:40, :63);
* every writer's payload equals the JAX writer's: the decompressed gzip
  streams, the zip members and the EG text but for its timestamp line
  (the archives stamp the time, so their bytes are not pinned);
* every reader parses the JAX-written file to an equal structure;
* `RefModelAdapter.score_raw` of each kind (eg-nn, egb-nn, ref-tree,
  ref-wdl) within 1e-5 relative of the JAX adapter's on raw records;
* the reference's golden files, where they are mounted (`REF` of
  tests/test_compat.py), as the JAX package's golden tests read them;
  they skip otherwise, as those do.
"""

import glob
import gzip
import io
import json
import os
import shutil
import zipfile

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from shifu_tpu.compat import adapters as jad  # noqa: E402
from shifu_tpu.compat import egb as jegb  # noqa: E402
from shifu_tpu.compat import encog as jencog  # noqa: E402
from shifu_tpu.compat import javaio as jjava  # noqa: E402
from shifu_tpu.compat import treespec as jtreespec  # noqa: E402
from shifu_tpu.compat import wdl as jcwdl  # noqa: E402
from shifu_tpu_torch.compat import adapters as pad  # noqa: E402
from shifu_tpu_torch.compat import egb as pegb  # noqa: E402
from shifu_tpu_torch.compat import encog as pencog  # noqa: E402
from shifu_tpu_torch.compat import javaio as pjava  # noqa: E402
from shifu_tpu_torch.compat import sniff_model_format  # noqa: E402
from shifu_tpu_torch.compat import treespec as ptreespec  # noqa: E402
from shifu_tpu_torch.compat import wdl as pcwdl  # noqa: E402
from tests.test_compat import REF  # noqa: E402
from tests.test_torch_config import prepare_model_set  # noqa: E402

CANCER_MS1 = f"{REF}/example/cancer-judgement/ModelStore/ModelSet1"
READABLE = f"{REF}/example/readablespec"
needs_ref = pytest.mark.skipif(not os.path.isdir(REF),
                               reason="reference not mounted")
RTOL = 1e-5

# the port's train step on copies of one prepared set, one algorithm each
TRAIN = {
    "nn": ("NN", dict(numTrainEpochs=5, baggingNum=2),
           {"NumHiddenNodes": [6], "ActivationFunc": ["tanh"],
            "Propagation": "R", "LearningRate": 0.1}),
    "gbt": ("GBT", dict(), {"TreeNum": 3, "MaxDepth": 3,
                            "LearningRate": 0.3, "Loss": "log"}),
    "rf": ("RF", dict(), {"TreeNum": 3, "MaxDepth": 4}),
    "wdl": ("WDL", dict(numTrainEpochs=5),
            {"NumHiddenNodes": [6], "ActivationFunc": ["relu"],
             "EmbedOutputs": 3, "LearningRate": 0.02}),
}


def trained_sets(base):
    """{kind: model-set root} for the TRAIN kinds, trained by the port."""
    from shifu_tpu_torch.processor.train import TrainProcessor

    src = prepare_model_set(os.path.join(base, "src"), "binary", rows=400,
                            alg="NN")
    out = {}
    for kind, (alg, train, params) in TRAIN.items():
        root = os.path.join(base, kind)
        shutil.copytree(src, root)
        path = os.path.join(root, "ModelConfig.json")
        with open(path) as fh:
            blob = json.load(fh)
        blob["train"].update(train, algorithm=alg, params=params)
        with open(path, "w") as fh:
            json.dump(blob, fh, indent=2)
        assert TrainProcessor(root, device="cpu").run() == 0
        out[kind] = root
    return out


def model_path(root, kind, i=0):
    return os.path.join(root, "models", f"model{i}.{kind}")


def configs(pkg, root):
    """(column configs, model config) of `root` loaded by `pkg`."""
    import importlib

    cfg = importlib.import_module(f"{pkg}.config")
    mc = importlib.import_module(f"{pkg}.config.model_config")
    return (cfg.load_column_config_list(os.path.join(root,
                                                     "ColumnConfig.json")),
            mc.ModelConfig.load(os.path.join(root, "ModelConfig.json")))


def raw_data(pkg, root):
    import importlib

    reader = importlib.import_module(f"{pkg}.data.reader")
    with open(os.path.join(root, "ModelConfig.json")) as fh:
        ds = json.load(fh)["dataSet"]
    names = reader.read_header(os.path.join(root, ds["headerPath"]))
    return reader.read_columnar(os.path.join(root, ds["dataPath"]), names)


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    return trained_sets(str(tmp_path_factory.mktemp("compat")))


def _specs(root, kind):
    """(port spec, JAX spec) of model0 of `root`."""
    from shifu_tpu.eval.scorer import load_model as jload
    from shifu_tpu_torch.eval.scorer import load_model as pload

    path = model_path(root, kind)
    return pload(path), jload(path)


# ---------------------------------------------------------------------------
# java.io primitives
# ---------------------------------------------------------------------------


def _write_all(mod):
    buf = io.BytesIO()
    do = mod.JavaDataOutput(buf)
    do.write_int(-123456)
    do.write_long(-(1 << 40))
    do.write_short(-7)
    do.write_byte(-3)
    do.write_float(1.5)
    do.write_double(3.14159)
    do.write_utf("héllo wörld \x00 \U0001f600")
    do.write_string("shifu")
    do.write_string(None)
    do.write_boolean(True)
    do.write_int_array([1, 2, 3])
    do.write_double_array([0.5, -0.5])
    do.write_int_array(None)
    return buf.getvalue()


def test_javaio_roundtrip_and_bytes():
    blob = _write_all(pjava)
    assert blob == _write_all(jjava)
    di = pjava.JavaDataInput(io.BytesIO(blob))
    assert di.read_int() == -123456
    assert di.read_long() == -(1 << 40)
    assert di.read_short() == -7
    assert di.read_byte() == -3
    assert di.read_float() == 1.5
    assert di.read_double() == pytest.approx(3.14159)
    assert di.read_utf() == "héllo wörld \x00 \U0001f600"
    assert di.read_string() == "shifu"
    assert di.read_string() == ""
    assert di.read_boolean() is True
    assert di.read_int_array() == [1, 2, 3]
    assert di.read_double_array() == [0.5, -0.5]
    assert di.read_int_array() == []
    with pytest.raises(EOFError):
        di.read_int()


def test_modified_utf8_special_cases():
    assert pjava.encode_modified_utf8("\x00") == b"\xc0\x80"
    for s in ["", "ascii", "\x00mixed\x00", "日本語", "emoji \U0001f600 pair"]:
        enc = pjava.encode_modified_utf8(s)
        assert enc == jjava.encode_modified_utf8(s)
        assert pjava.decode_modified_utf8(enc) == s
    with pytest.raises(ValueError):
        pjava.decode_modified_utf8(b"\xff")


# ---------------------------------------------------------------------------
# writers and readers against the JAX package's
# ---------------------------------------------------------------------------


def _eg_body(blob: bytes):
    """EG text without its first line (which stamps the time)."""
    head, _, body = blob.partition(b"\n")
    return head.rsplit(b",", 1)[0], body


def _same(a, b, path="model"):
    """Structural equality of two reader outputs (dataclasses, dicts,
    lists, numpy arrays, scalars)."""
    if hasattr(a, "__dataclass_fields__"):
        assert type(a).__name__ == type(b).__name__, path
        for k in a.__dataclass_fields__:
            _same(getattr(a, k), getattr(b, k), f"{path}.{k}")
    elif isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            _same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b or (a != a and b != b), path


def test_eg_text_writer_and_reader(sets):
    pspec, jspec = _specs(sets["nn"], "nn")
    pblob = pad.nn_spec_to_eg_bytes(pspec)
    jblob = jad.nn_spec_to_eg_bytes(jspec)
    assert _eg_body(pblob) == _eg_body(jblob)
    assert sniff_model_format(pblob) == "eg-text"
    _same(pencog.read_eg(jblob), jencog.read_eg(jblob))
    net = pencog.read_eg(jblob)
    w, b, acts = pencog.to_layers(net)
    back = pencog.from_layers(w, b, acts[:-1], acts[-1])
    x = np.random.default_rng(1).normal(size=(8, net.input_count))
    np.testing.assert_allclose(back.compute(x), net.compute(x), rtol=1e-12)
    np.testing.assert_array_equal(net.compute(x),
                                  jencog.read_eg(jblob).compute(x))


def selected(ccs, spec):
    """`ccs` with the model's columns final-selected, as after varsel."""
    names = {cd["name"] for cd in spec.norm_specs}
    for cc in ccs:
        cc.final_select = cc.column_name in names
    return ccs


def test_egb_container_writer_and_reader(sets):
    pspec, jspec = _specs(sets["nn"], "nn")
    pccs = selected(configs("shifu_tpu_torch", sets["nn"])[0], pspec)
    jccs = selected(configs("shifu_tpu", sets["nn"])[0], jspec)
    pblob = pad.nn_spec_to_egb_bytes(pspec, pccs, cutoff=4.0)
    jblob = jad.nn_spec_to_egb_bytes(jspec, jccs, cutoff=4.0)
    assert gzip.decompress(pblob) == gzip.decompress(jblob)
    assert sniff_model_format(pblob) == "ref-binary"
    _same(pegb.read_nn_model(jblob), jegb.read_nn_model(jblob))
    woes = [0.5, -0.25, 1.0]
    assert pegb.woe_mean_stddev(woes, [3, 1, 2], [1, 5, 0]) == \
        jegb.woe_mean_stddev(woes, [3, 1, 2], [1, 5, 0])


@pytest.mark.parametrize("kind", ["gbt", "rf"])
def test_tree_binary_and_zip_writers_and_readers(sets, kind):
    pspec, jspec = _specs(sets[kind], kind)
    pref, jref = ptreespec.from_dense_spec(pspec), jtreespec.from_dense_spec(
        jspec)
    pblob, jblob = (ptreespec.write_tree_model(pref),
                    jtreespec.write_tree_model(jref))
    assert gzip.decompress(pblob) == gzip.decompress(jblob)
    _same(ptreespec.read_tree_model(jblob), jtreespec.read_tree_model(jblob))
    pz, jz = (zipfile.ZipFile(io.BytesIO(b)) for b in (
        ptreespec.write_zip_model(pref), jtreespec.write_zip_model(jref)))
    assert pz.namelist() == jz.namelist() == ["model.ini", "trees"]
    for name in pz.namelist():
        assert pz.read(name) == jz.read(name)
    zblob = jtreespec.write_zip_model(jref)
    _same(ptreespec.read_zip_model(zblob), jtreespec.read_zip_model(zblob))
    x = np.random.default_rng(2).normal(size=(32, pref.input_node))
    np.testing.assert_array_equal(pref.compute(x), jref.compute(x))


def test_wdl_container_writer_and_reader(sets):
    pspec, jspec = _specs(sets["wdl"], "wdl")
    (pccs, _), (jccs, _) = configs("shifu_tpu_torch", sets["wdl"]), configs(
        "shifu_tpu", sets["wdl"])
    pref = pcwdl.wdl_spec_to_ref(pspec, pccs)
    jref = jcwdl.wdl_spec_to_ref(jspec, jccs)
    pblob, jblob = pcwdl.write_wdl_model(pref), jcwdl.write_wdl_model(jref)
    assert gzip.decompress(pblob) == gzip.decompress(jblob)
    _same(pcwdl.read_wdl_model(jblob), jcwdl.read_wdl_model(jblob))
    # the imported weights are the native spec's
    back = pcwdl.ref_to_wdl_params(pcwdl.read_wdl_model(pblob))
    from shifu_tpu_torch.models.wdl import flatten_wdl

    assert flatten_wdl(back).tobytes() == flatten_wdl(pspec.params).tobytes()


def test_egb_export_without_varsel(sets, tmp_path):
    """ROADMAP C.13: on a set trained without varsel (no column
    final-selected; the norm plan took every candidate) the JAX export
    writes a container with no column stats, which cannot score. The
    port's takes the model's own columns: the container the JAX package
    writes once those columns are final-selected."""
    pspec, jspec = _specs(sets["nn"], "nn")
    pccs, _ = configs("shifu_tpu_torch", sets["nn"])
    jccs, _ = configs("shifu_tpu", sets["nn"])
    assert not any(cc.final_select for cc in pccs)
    jblob = jad.nn_spec_to_egb_bytes(jspec, jccs)
    assert jegb.read_nn_model(jblob).column_stats == []
    path = _write(tmp_path, "model0.nn", jblob)
    with pytest.raises(ValueError):
        jad.load_ref_model(path).score_raw(raw_data("shifu_tpu", sets["nn"]))
    want = jad.nn_spec_to_egb_bytes(jspec, selected(jccs, jspec))
    got = pad.nn_spec_to_egb_bytes(pspec, pccs)
    assert gzip.decompress(got) == gzip.decompress(want)


# ---------------------------------------------------------------------------
# scoring raw records through the adapters
# ---------------------------------------------------------------------------


def _write(tmp_path, name, blob):
    path = str(tmp_path / name)
    with open(path, "wb") as fh:
        fh.write(blob)
    return path


@pytest.mark.parametrize("kind", ["eg-nn", "egb-nn", "ref-tree", "ref-wdl"])
def test_adapter_score_raw_matches_jax(sets, tmp_path, kind):
    src = {"eg-nn": "nn", "egb-nn": "nn", "ref-tree": "gbt",
           "ref-wdl": "wdl"}[kind]
    root = sets[src]
    pspec, jspec = _specs(root, src)
    jccs, jmc = configs("shifu_tpu", root)
    pccs, pmc = configs("shifu_tpu_torch", root)
    if kind == "eg-nn":
        name, blob = "model0.nn", jad.nn_spec_to_eg_bytes(jspec)
    elif kind == "egb-nn":
        name, blob = "model0.nn", jad.nn_spec_to_egb_bytes(
            jspec, selected(configs("shifu_tpu", root)[0], jspec))
    elif kind == "ref-tree":
        name, blob = "model0.gbt", jad.tree_spec_to_ref_bytes(jspec)
    else:
        name, blob = "model0.wdl", jcwdl.write_wdl_model(
            jcwdl.wdl_spec_to_ref(jspec, jccs))
    path = _write(tmp_path, name, blob)
    padapt = pad.load_ref_model(path, pccs, pmc, device="cpu")
    jadapt = jad.load_ref_model(path, jccs, jmc)
    assert padapt.kind == jadapt.kind == kind
    assert padapt.algorithm == jadapt.algorithm
    got = padapt.score_raw(raw_data("shifu_tpu_torch", root))
    want = jadapt.score_raw(raw_data("shifu_tpu", root))
    assert got.shape == want.shape == (400,)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-7)
    if kind in ("eg-nn", "egb-nn"):
        x = np.random.default_rng(3).normal(
            size=(16, len(pspec.input_columns)))
        np.testing.assert_allclose(padapt.score_normalized(x),
                                   jadapt.score_normalized(x), rtol=1e-12)
    else:
        with pytest.raises(ValueError, match="raw records"):
            padapt.score_normalized(np.zeros((2, 3)))
    # the native `.wdl` is never sniffed as the reference container
    if kind == "ref-wdl":
        assert pad.load_ref_model(model_path(root, "wdl")) is None


@pytest.mark.parametrize("kind", ["eg-nn", "egb-nn", "ref-tree", "ref-wdl"])
def test_server_serves_reference_formats(sets, tmp_path, kind):
    """A model set holding a reference-format file is served: the server
    loads the set's configs (the EG network's norm plan), its registry
    takes the ModelRunner fallback with the model's raw columns as its
    schema, and the scores are the JAX runner's (given the same configs)
    within RTOL; the JAX registry's schema is empty (ROADMAP C.10).
    Without the configs an EG network cannot score."""
    from shifu_tpu.eval import scorer as jscorer
    from shifu_tpu.serve import registry as jregistry
    from shifu_tpu_torch.serve import registry as pregistry
    from shifu_tpu_torch.serve.server import ScoringServer

    src = {"eg-nn": "nn", "egb-nn": "nn", "ref-tree": "gbt",
           "ref-wdl": "wdl"}[kind]
    root = sets[src]
    _, jspec = _specs(root, src)
    jccs, jmc = configs("shifu_tpu", root)
    blob = {"eg-nn": lambda: jad.nn_spec_to_eg_bytes(jspec),
            "egb-nn": lambda: jad.nn_spec_to_egb_bytes(
                jspec, selected(jccs, jspec)),
            "ref-tree": lambda: jad.tree_spec_to_ref_bytes(jspec),
            "ref-wdl": lambda: jcwdl.write_wdl_model(
                jcwdl.wdl_spec_to_ref(jspec, jccs))}[kind]()
    set_dir = tmp_path / "set"
    models = set_dir / "models"
    models.mkdir(parents=True)
    for name in ("ColumnConfig.json", "ModelConfig.json"):
        shutil.copy(os.path.join(root, name), set_dir / name)
    _write(models, f"model0.{src}", blob)

    data = raw_data("shifu_tpu_torch", root)
    srv = ScoringServer(root=str(set_dir), port=0, replicas=1,
                        device="cpu").start()
    try:
        reg = srv.registry.replicas[0].registry
        assert not reg.fused and reg.specs[0].kind == kind
        cols = srv.registry.input_columns
        assert cols and set(cols) <= set(data.names)
        recs = [{c: (None if data.missing_mask(c)[i] else
                     str(data.column(c)[i])) for c in cols}
                for i in range(40)]
        got = srv.registry.score_records(recs)
    finally:
        srv.shutdown(10)
    want = jscorer.ModelRunner(
        jscorer.find_model_paths(str(models)), column_configs=jccs,
        model_config=jmc).score_raw(jregistry.records_to_columnar(recs, cols))
    for k in ("model_scores", "mean", "max", "min", "median"):
        np.testing.assert_allclose(getattr(got, k), getattr(want, k),
                                   rtol=RTOL, atol=1e-4, err_msg=k)
    # the JAX registry's schema leaves a reference model's columns out
    # (ROADMAP C.10)
    assert jregistry.ModelRegistry(str(models), column_configs=jccs,
                                   model_config=jmc).input_columns == []
    if kind == "eg-nn":
        bare = pregistry.ModelRegistry(str(models), device="cpu")
        assert bare.input_columns == []
        with pytest.raises(ValueError, match="ColumnConfig stats"):
            bare.score_raw(data)


# ---------------------------------------------------------------------------
# the reference's golden files (skipped when not mounted)
# ---------------------------------------------------------------------------


@needs_ref
def test_golden_eg_nn_parses_like_jax():
    for path in sorted(glob.glob(f"{CANCER_MS1}/models/model*.nn")):
        blob = open(path, "rb").read()
        assert sniff_model_format(blob) == "eg-text"
        net, jnet = pencog.read_eg(blob), jencog.read_eg(blob)
        _same(net, jnet)
        x = np.random.default_rng(0).normal(size=(16, net.input_count))
        np.testing.assert_array_equal(net.compute(x), jnet.compute(x))


@needs_ref
@pytest.mark.parametrize("name", ["model0.gbt", "model1.gbt"])
def test_golden_gbt_binary_parses_like_jax(name):
    blob = open(f"{READABLE}/{name}", "rb").read()
    m, jm = ptreespec.read_tree_model(blob), jtreespec.read_tree_model(blob)
    _same(m, jm)
    assert gzip.decompress(ptreespec.write_tree_model(m)) == gzip.decompress(
        jtreespec.write_tree_model(jm))


@needs_ref
def test_golden_gbt_zip_parses_like_jax():
    blob = open(f"{READABLE}/model0.zip", "rb").read()
    m, jm = ptreespec.read_zip_model(blob), jtreespec.read_zip_model(blob)
    _same(m, jm)
    x = np.random.default_rng(3).normal(loc=0.3, scale=0.2,
                                        size=(64, m.input_node))
    np.testing.assert_array_equal(m.compute(x), jm.compute(x))

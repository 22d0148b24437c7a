"""The port's meshed NN, WDL and streamed trainers, the `shifu train`
steps on a mesh and the sharded lifecycle folds, against the JAX
package's meshed runs, on the CPU.

The JAX side runs on its 8 virtual CPU devices (`data_mesh()`); the port
on `data_mesh(virtual=8, device="cpu")`. The steps run with the port's
mesh factory (`parallel.mesh.train_mesh`) patched to that 8-shard mesh,
the JAX steps on their 8 devices, as they choose. Inputs are numpy draws
from a seed.

Tolerances: NN weights within rtol 2e-3 / atol 2e-4 of the JAX meshed
weights and of the port's one-device weights, valid errors within 1e-4
(JAX tests/test_train_nn.py:125-138, test_dcn_mesh.py:33-50); WDL
within rtol 3e-3 / atol 3e-4 (JAX tests/test_wdl.py:71-81); streamed
runs take the same iterations, valid errors within 1e-4 and the first
embedding table within 1e-4 (JAX test_streaming_train.py:166-185,
test_wdl.py:282-315); the RF step's model file the JAX step's bytes but
for the two error numbers of its header, within 1e-6 (each package sums
its shards' error sums in its own order);
streamed stats and norm byte-identical across 1 and 8 shards and to the
JAX package's 8-shard run (JAX test_sharded_lifecycle.py:441).
"""

import os
import shutil

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from shifu_tpu.parallel import mesh as jmesh  # noqa: E402
from shifu_tpu.train import nn_trainer as J  # noqa: E402
from shifu_tpu.train import wdl_trainer as JW  # noqa: E402
from shifu_tpu_torch.models import nn as pnn  # noqa: E402
from shifu_tpu_torch.models import wdl as pwdl  # noqa: E402
from shifu_tpu_torch.norm.dataset import (write_codes,  # noqa: E402
                                          write_normalized)
from shifu_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from shifu_tpu_torch.train import nn_trainer as P  # noqa: E402
from shifu_tpu_torch.train import streaming as pstream  # noqa: E402
from shifu_tpu_torch.train import streaming_wdl as pswdl  # noqa: E402
from shifu_tpu_torch.train import wdl_trainer as PW  # noqa: E402
from tests import test_torch_train_nn_step as nn_step  # noqa: E402
from tests import test_torch_train_step as tree_step  # noqa: E402
from tests import test_torch_train_wdl_step as wdl_step  # noqa: E402
from tests.test_torch_config import prepare_model_set  # noqa: E402

NN_TOL = dict(rtol=2e-3, atol=2e-4)
WDL_TOL = dict(rtol=3e-3, atol=3e-4)


def _cpu(S=8, **kw):
    return pmesh.data_mesh(virtual=S, device="cpu", **kw)


def _xor_like(n=264, d=6, seed=3):
    """JAX tests/test_train_nn.py's `make_xor_like`."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    t = ((x[:, 0] * x[:, 1]) > 0).astype(np.float32)
    return x, t, np.ones(n, np.float32)


def _flat_nn(params):
    return np.concatenate([np.concatenate([p["W"].ravel(), p["b"].ravel()])
                           for p in params])


def _nn_pair(**kw):
    base = dict(hidden_nodes=[8], num_epochs=10, propagation="B",
                valid_set_rate=0.25, seed=5)
    base.update(kw)
    return J.NNTrainConfig(**base), P.NNTrainConfig(**base)


# ---------------------------------------------------------------------------
# NN and WDL in memory
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["flat", "dcn", "rprop", "minibatch"])
def test_meshed_nn_matches_jax_and_one_device(case):
    x, t, w = _xor_like()
    kw, jm, pm = {}, jmesh.data_mesh(), _cpu()
    if case == "dcn":  # JAX tests/test_dcn_mesh.py:33-50
        rng = np.random.default_rng(0)
        x = rng.normal(size=(512, 10)).astype(np.float32)
        t = (x[:, 0] - x[:, 1] > 0).astype(np.float32)
        w = np.ones(512, np.float32)
        kw = dict(activations=["tanh"], propagation="R", num_epochs=15,
                  valid_set_rate=0.2, seed=2)
        jm, pm = jmesh.data_mesh(8, dcn_slices=2), _cpu(dcn_slices=2)
    elif case == "rprop":
        kw = dict(propagation="R", num_epochs=20)
    elif case == "minibatch":
        kw = dict(propagation="R", mini_batchs=3)
    jc, pc = _nn_pair(**kw)
    want = J.train_nn(x, t, w, jc, mesh=jm)
    got = P.train_nn(x, t, w, pc, mesh=pm)
    assert got.iterations == want.iterations
    assert got.valid_error == pytest.approx(want.valid_error, abs=1e-4)
    np.testing.assert_allclose(_flat_nn(got.params), _flat_nn(want.params),
                               **NN_TOL)
    if case != "minibatch":  # the padding moves the mini-batch slices
        one = P.train_nn(x, t, w, pc, device="cpu")
        np.testing.assert_allclose(_flat_nn(got.params),
                                   _flat_nn(one.params), **NN_TOL)
        assert got.valid_error == pytest.approx(one.valid_error, abs=1e-4)


def test_one_shard_mesh_is_the_one_device_run():
    x, t, w = _xor_like()
    _jc, pc = _nn_pair(propagation="R")
    a = P.train_nn(x, t, w, pc, device="cpu")
    b = P.train_nn(x, t, w, pc, mesh=_cpu(1))
    np.testing.assert_array_equal(_flat_nn(a.params), _flat_nn(b.params))
    assert a.valid_error == b.valid_error


def test_meshed_nn_bagged_every_member():
    x, t, w = _xor_like(n=300)
    jc, pc = _nn_pair(propagation="R", num_epochs=8,
                      bagging_sample_rate=0.8)
    want = J.train_nn_bagged(x, t, w, jc, 3, mesh=jmesh.data_mesh())
    got = P.train_nn_bagged(x, t, w, pc, 3, mesh=_cpu())
    one = P.train_nn_bagged(x, t, w, pc, 3, device="cpu")
    for g, wnt, o in zip(got, want, one):
        assert g.iterations == wnt.iterations == o.iterations
        assert g.valid_error == pytest.approx(wnt.valid_error, abs=1e-4)
        for ref in (wnt, o):
            np.testing.assert_allclose(_flat_nn(g.params),
                                       _flat_nn(ref.params), **NN_TOL)


def _wdl_data(n=260, seed=0):
    """JAX tests/test_wdl.py's `_make_data`."""
    rng = np.random.default_rng(seed)
    dense = rng.normal(size=(n, 4)).astype(np.float32)
    codes = np.stack([rng.integers(0, 5, n), rng.integers(0, 3, n)],
                     axis=1).astype(np.int32)
    logits = dense[:, 0] * 1.5 + (codes[:, 0] >= 3) * 2.0 - 1.5
    t = (logits + rng.normal(scale=0.4, size=n) > 0).astype(np.float32)
    return dense, codes, t, np.ones(n, np.float32), [5, 3]


def test_meshed_wdl_matches_jax_and_one_device():
    dense, codes, t, w, vocab = _wdl_data()
    base = dict(hidden=[8], embed_dim=2, optimizer="ADAM",
                learning_rate=0.05, num_epochs=15, valid_set_rate=0.25,
                seed=3)
    want = JW.train_wdl(dense, codes, t, w, vocab, JW.WDLTrainConfig(**base),
                        mesh=jmesh.data_mesh())
    pc = PW.WDLTrainConfig(**base)
    got = PW.train_wdl(dense, codes, t, w, vocab, pc, mesh=_cpu())
    one = PW.train_wdl(dense, codes, t, w, vocab, pc, device="cpu")
    from shifu_tpu.models.wdl import flatten_wdl as jflat

    np.testing.assert_allclose(pwdl.flatten_wdl(got.params),
                               jflat(want.params), **WDL_TOL)
    np.testing.assert_allclose(pwdl.flatten_wdl(got.params),
                               pwdl.flatten_wdl(one.params), **WDL_TOL)
    assert got.valid_error == pytest.approx(want.valid_error, abs=1e-4)
    # bagged members keep their member axis on every shard
    bag = PW.train_wdl_bagged(dense, codes, t, w, vocab, pc, 2, mesh=_cpu())
    bag1 = PW.train_wdl_bagged(dense, codes, t, w, vocab, pc, 2,
                               device="cpu")
    for a, b in zip(bag, bag1):
        assert a.iterations == b.iterations
        np.testing.assert_allclose(pwdl.flatten_wdl(a.params),
                                   pwdl.flatten_wdl(b.params), **WDL_TOL)


@pytest.mark.parametrize("kw", [dict(model_axis=2),
                                dict(model_axis=2, dcn_slices=2)])
def test_wdl_model_axis_matches_jax_and_data_mesh(kw):
    """WDL's `model` axis (A.13.1): on 8 virtual devices, 4 row shards of
    2 model devices (and in 2 dcn slices), each embedding table's embed
    columns split over a shard's model group. Against the JAX
    model-axis run at the meshed tolerances, and against the port's
    data-only mesh of the same 4 row shards within 1e-6."""
    dense, codes, t, w, vocab = _wdl_data()
    base = dict(hidden=[8], embed_dim=4, optimizer="ADAM",
                learning_rate=0.05, num_epochs=15, valid_set_rate=0.25,
                seed=3)
    want = JW.train_wdl(dense, codes, t, w, vocab, JW.WDLTrainConfig(**base),
                        mesh=jmesh.data_mesh(8, **kw))
    pc = PW.WDLTrainConfig(**base)
    mesh = _cpu(**kw)
    assert mesh.size == 4 and mesh.model_size == 2
    got = PW.train_wdl(dense, codes, t, w, vocab, pc, mesh=mesh)
    data_only = _cpu(4, dcn_slices=kw.get("dcn_slices"))
    rows = PW.train_wdl(dense, codes, t, w, vocab, pc, mesh=data_only)
    from shifu_tpu.models.wdl import flatten_wdl as jflat

    np.testing.assert_allclose(pwdl.flatten_wdl(got.params),
                               jflat(want.params), **WDL_TOL)
    np.testing.assert_allclose(pwdl.flatten_wdl(got.params),
                               pwdl.flatten_wdl(rows.params),
                               rtol=0, atol=1e-6)
    assert got.valid_error == pytest.approx(want.valid_error, abs=1e-4)
    assert got.iterations == rows.iterations
    bag = PW.train_wdl_bagged(dense, codes, t, w, vocab, pc, 2, mesh=mesh)
    bag_rows = PW.train_wdl_bagged(dense, codes, t, w, vocab, pc, 2,
                                   mesh=data_only)
    for a, b in zip(bag, bag_rows):
        np.testing.assert_allclose(pwdl.flatten_wdl(a.params),
                                   pwdl.flatten_wdl(b.params),
                                   rtol=0, atol=1e-6)


def test_wdl_embed_split_gathers_the_whole_lookup():
    """`_gather_split` over 3 column blocks (an uneven split of E = 5):
    the one-device gather's values and gradient, bit for bit."""
    rng = np.random.default_rng(0)
    tables = [torch.tensor(rng.normal(size=(2, v, 5)), dtype=torch.float32,
                           requires_grad=True) for v in (4, 3)]
    idx = torch.tensor(rng.integers(0, 3, size=(9, 2)))
    whole = pwdl._gather_fields(tables, idx)
    (g1,) = torch.autograd.grad((whole ** 2).sum(), tables[0])
    split = pwdl._gather_split(tables, idx, [torch.device("cpu")] * 3)
    (g2,) = torch.autograd.grad((split ** 2).sum(), tables[0])
    assert torch.equal(whole, split) and torch.equal(g1, g2)


# ---------------------------------------------------------------------------
# streamed NN and WDL
# ---------------------------------------------------------------------------


def test_meshed_streamed_nn(tmp_path):
    """JAX tests/test_streaming_train.py:166-185."""
    rng = np.random.default_rng(3)
    n, d = 2000, 12
    x = rng.normal(size=(n, d)).astype(np.float32)
    t = ((x[:, 0] + 0.5 * x[:, 1]) > 0).astype(np.float32)
    w = np.ones(n, np.float32)
    data_dir = str(tmp_path / "NormalizedData")
    write_normalized(data_dir, x, t, w, [f"x{i}" for i in range(d)],
                     n_shards=4)
    base = dict(hidden_nodes=[10], activations=["tanh"], propagation="R",
                num_epochs=20, valid_set_rate=0.15, seed=7)
    from shifu_tpu.train.streaming import train_nn_streamed

    want = train_nn_streamed(data_dir, J.NNTrainConfig(**base),
                             mesh=jmesh.data_mesh())
    pc = P.NNTrainConfig(**base)
    got = pstream.train_nn_streamed(data_dir, pc, mesh=_cpu())
    one = pstream.train_nn_streamed(data_dir, pc, device="cpu")
    for ref in (want, one):
        assert got.iterations == ref.iterations
        assert got.valid_error == pytest.approx(ref.valid_error, abs=1e-4)
        np.testing.assert_allclose(_flat_nn(got.params),
                                   _flat_nn(ref.params), **NN_TOL)


def test_meshed_streamed_wdl(tmp_path):
    """JAX tests/test_wdl.py:282-315."""
    from shifu_tpu.train.streaming_wdl import train_wdl_streamed

    rng = np.random.default_rng(5)
    n, nd, nc, vocab = 1200, 4, 2, 6
    dense = rng.normal(size=(n, nd)).astype(np.float32)
    codes = rng.integers(0, vocab, size=(n, nc)).astype(np.int16)
    t = ((dense[:, 0] + (codes[:, 0] >= 3)) > 0.5).astype(np.int8)
    w = np.ones(n, np.float32)
    norm_dir = str(tmp_path / "NormalizedData")
    codes_dir = str(tmp_path / "CleanedData")
    cols = [f"d{i}" for i in range(nd)] + [f"c{i}" for i in range(nc)]
    write_normalized(norm_dir, np.concatenate(
        [dense, codes.astype(np.float32)], 1), t, w, cols, n_shards=3)
    write_codes(codes_dir, np.concatenate(
        [np.zeros((n, nd), np.int16), codes], 1), t, w, cols,
        [1] * nd + [vocab] * nc, n_shards=3)
    base = dict(hidden=[8], activations=["relu"], embed_dim=4,
                num_epochs=10, valid_set_rate=0.2, seed=3)
    args = (norm_dir, codes_dir, list(range(nd)), [nd, nd + 1],
            [vocab] * nc)
    want = train_wdl_streamed(*args, JW.WDLTrainConfig(**base),
                              mesh=jmesh.data_mesh())
    got = pswdl.train_wdl_streamed(*args, PW.WDLTrainConfig(**base),
                                   mesh=_cpu())
    one = pswdl.train_wdl_streamed(*args, PW.WDLTrainConfig(**base),
                                   device="cpu")
    for ref in (want, one):
        assert got.iterations == ref.iterations
        assert got.valid_error == pytest.approx(ref.valid_error, abs=1e-4)
        np.testing.assert_allclose(got.params.embed[0], ref.params.embed[0],
                                   atol=1e-4)


# ---------------------------------------------------------------------------
# `shifu train` on the mesh
# ---------------------------------------------------------------------------


@pytest.fixture
def meshed_steps(monkeypatch):
    """The port's steps choose an 8-shard CPU mesh, as the JAX steps
    choose their 8 devices."""
    monkeypatch.setattr(pmesh, "train_mesh",
                        lambda device: _cpu() if device.type == "cpu"
                        else None)


@pytest.fixture(scope="module")
def step_sets(tmp_path_factory):
    base = tmp_path_factory.mktemp("mesh_steps")
    return {
        "rf": prepare_model_set(str(base / "rf"), "binary", rows=500,
                                alg="RF", TreeNum=3, MaxDepth=5),
        "gbt": prepare_model_set(str(base / "gbt"), "binary", rows=500,
                                 alg="GBT", TreeNum=4, MaxDepth=3,
                                 LearningRate=0.2),
        "nn": prepare_model_set(str(base / "nn"), "binary", rows=600,
                                alg="NN"),
        "wdl": prepare_model_set(str(base / "wdl"), "binary", rows=600,
                                 alg="WDL", **wdl_step.PARAMS),
    }


def _roots(src, tmp_path):
    roots = [str(tmp_path / side) for side in ("jax", "port")]
    for r in roots:
        shutil.copytree(src, r)
    return roots


def _assert_rf_files_equal(want: str, got: str) -> None:
    """The same bytes but the two error numbers of the JSON header, which
    agree within 1e-6 (the binary RF errors' bound of
    tests/test_torch_train_step.py: f32 mean squared errors summed in
    another order)."""
    import json
    import struct

    def split(path):
        with open(path, "rb") as fh:
            data = fh.read()
        (n,) = struct.unpack("<I", data[4:8])
        return data[:4], json.loads(data[8:8 + n]), data[8 + n:]

    (wm, wh, wt), (gm, gh, gt) = split(want), split(got)
    assert wm == gm and wt == gt  # magic, then every tree's arrays
    for k in ("trainError", "validError"):
        assert gh.pop(k) == pytest.approx(wh.pop(k), abs=1e-6), k
    assert gh == wh


@pytest.mark.parametrize("alg", ["rf", "gbt"])
def test_meshed_tree_step(step_sets, tmp_path, meshed_steps, alg):
    from shifu_tpu.models import tree as jtree
    from shifu_tpu.processor.train import TrainProcessor as JTrain
    from shifu_tpu_torch.models import tree as ptree
    from shifu_tpu_torch.processor.train import TrainProcessor

    jroot, proot = _roots(step_sets[alg], tmp_path)
    assert JTrain(jroot).run() == 0
    assert TrainProcessor(proot, device="cpu").run() == 0
    rel = os.path.join("models", f"model0.{alg}")
    jspec = jtree.TreeModelSpec.load(os.path.join(jroot, rel))
    pspec = ptree.TreeModelSpec.load(os.path.join(proot, rel))
    if alg == "rf":  # the file's bytes but the errors' last digits
        _assert_rf_files_equal(os.path.join(jroot, rel),
                               os.path.join(proot, rel))
    else:
        codes = tree_step._codes(proot)
        np.testing.assert_allclose(
            ptree.IndependentTreeModel(pspec, device="cpu").compute(codes),
            jspec.independent().compute(codes), atol=0.03)
    tol = 1e-6 if alg == "rf" else 0.03
    for f in ("tmp/train/progress_0.log", "tmp/train/val_error_0.txt"):
        ja = tree_step._numbers(os.path.join(jroot, f))
        pa = tree_step._numbers(os.path.join(proot, f))
        assert len(ja) == len(pa) > 0
        for x, y in zip(ja, pa):
            np.testing.assert_allclose(y, x, atol=tol, rtol=0)


@pytest.mark.parametrize("case", ["single", "bagging_5"])
def test_meshed_nn_step(step_sets, tmp_path, meshed_steps, case):
    _kind, train = nn_step.CASES[case]
    roots = _roots(step_sets["nn"], tmp_path)
    for r in roots:
        nn_step._edit(r, dict(train))
    nn_step._run(roots)
    nn_step._compare(roots)
    spec = pnn.NNModelSpec.load(os.path.join(roots[1], "models",
                                             "model0.nn"))
    assert spec.params


def test_meshed_wdl_step(step_sets, tmp_path, meshed_steps):
    roots = _roots(step_sets["wdl"], tmp_path)
    for r in roots:
        wdl_step._edit(r, dict(wdl_step.CASES["single"]))
    wdl_step._run(roots)
    assert wdl_step._compare(roots) == ["model0.wdl"]


# ---------------------------------------------------------------------------
# the lifecycle folds (JAX tests/test_sharded_lifecycle.py:441)
# ---------------------------------------------------------------------------


def test_streamed_stats_and_norm_across_shard_counts(tmp_path, monkeypatch):
    from shifu_tpu.processor.norm import NormProcessor as JNorm
    from shifu_tpu.processor.stats import StatsProcessor as JStats
    from shifu_tpu_torch.processor import norm as pnorm_proc
    from shifu_tpu_torch.processor.norm import NormProcessor
    from shifu_tpu_torch.processor.stats import StatsProcessor
    from tests.test_torch_config import jax_inline_ingest
    from tests.test_torch_stats import make_integral_set
    from tests.test_torch_stream_lifecycle import (_bytes, _copies,
                                                   _init, _tree_bytes,
                                                   streamed)

    src = _init(make_integral_set(str(tmp_path / "src"), n_rows=1200))
    jroot, p8, p1 = _copies(src, str(tmp_path), "jax", "port8", "port1")
    # one output shard a device, as the JAX package counts its 8 devices
    monkeypatch.setattr(pnorm_proc, "default_shards", lambda device: 8)
    shards8 = {"shifu.lifecycle.shards": "8"}
    with streamed(**shards8), jax_inline_ingest():
        assert JStats(jroot).run() == 0
        assert JNorm(jroot).run() == 0
    for root, S in ((p8, "8"), (p1, "1")):
        with streamed(**{"shifu.lifecycle.shards": S}):
            assert StatsProcessor(root, device="cpu").run() == 0
            assert NormProcessor(root, device="cpu").run() == 0
    want = _bytes(jroot, "ColumnConfig.json")
    assert _bytes(p8, "ColumnConfig.json") == want
    assert _bytes(p1, "ColumnConfig.json") == want
    for sub in ("NormalizedData", "CleanedData"):
        rel = os.path.join("tmp", "norm", sub)
        ref = _tree_bytes(os.path.join(jroot, rel))
        assert len(ref) >= 4
        assert _tree_bytes(os.path.join(p8, rel)) == ref, sub
        assert _tree_bytes(os.path.join(p1, rel)) == ref, sub


def test_device_accumulator_shards_merge_exactly():
    from shifu_tpu_torch.data import pipeline as pp

    rng = np.random.default_rng(4)
    chunks = []
    for _ in range(7):
        n = int(rng.integers(20, 60))
        chunks.append((rng.integers(0, 6, size=(n, 3)).astype(np.int32),
                       np.asarray([0, 6, 12], np.int32), 18,
                       rng.integers(0, 2, size=n).astype(np.int32),
                       rng.integers(1, 4, size=n).astype(np.float32),
                       rng.integers(-9, 9, size=(n, 3)).astype(np.float32)))
    outs = {}
    for S in (1, 3, 8):
        acc = pp.DeviceAccumulator(torch.device("cpu"), S)
        for ci, ch in enumerate(chunks):
            acc.fold(*ch, shard=ci % S)
        outs[S] = (acc.fetch(), acc.snapshot())
        resumed = pp.DeviceAccumulator(torch.device("cpu"), S)
        resumed.restore(outs[S][1])
        for a, b in zip(resumed.fetch(), outs[S][0]):
            np.testing.assert_array_equal(a, b)
    for S in (3, 8):
        for a, b in zip(outs[S][0], outs[1][0]):
            np.testing.assert_array_equal(a, b)


def test_streamed_stats_at_four_shards_on_floats(tmp_path):
    """A float set's streamed stats at 4 lifecycle shards and at 1: the
    port's counts and extrema equal at both and to the JAX package's,
    its bins the JAX package's at each shard count."""
    import json

    from shifu_tpu.processor.stats import StatsProcessor as JStats
    from shifu_tpu_torch.processor.stats import StatsProcessor
    from tests.helpers import make_model_set
    from tests.test_torch_config import jax_inline_ingest
    from tests.test_torch_stream_lifecycle import (_bytes, _copies, _init,
                                                   streamed)

    src = _init(make_model_set(str(tmp_path / "src"), n_rows=1500,
                               algorithm="RF"))
    cols = {}
    for S in ("4", "1"):
        jroot, proot = _copies(src, str(tmp_path), f"jax{S}", f"port{S}")
        with streamed(**{"shifu.lifecycle.shards": S}), jax_inline_ingest():
            assert JStats(jroot).run() == 0
        with streamed(**{"shifu.lifecycle.shards": S}):
            assert StatsProcessor(proot, device="cpu").run() == 0
        cols[S] = [json.loads(_bytes(r, "ColumnConfig.json"))
                   for r in (jroot, proot)]
    exact = ("totalCount", "missingCount", "min", "max")
    for (j1, p1, p4, j4) in zip(cols["1"][0], cols["1"][1], cols["4"][1],
                                cols["4"][0]):
        for k in exact:
            assert p4["columnStats"][k] == p1["columnStats"][k] \
                == j1["columnStats"][k] == j4["columnStats"][k], (
                    p1["columnName"], k)
        for jc, pc in ((j1, p1), (j4, p4)):
            assert (pc["columnBinning"]["binBoundary"]
                    == jc["columnBinning"]["binBoundary"])

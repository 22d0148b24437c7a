"""Numerical contracts of the port's co-resident trainer
(`shifu_tpu_torch/coresident/trainer.py` + `pipeline.py`), the cases of
the JAX package's `tests/test_coresident_parity.py` on the port, and the
port against the JAX `train_nn_coresident` / `train_wdl_coresident`.

Inside the port (bit-identity pins stay bit-identity):
  * `stages=1, microbatches=1` is BIT-identical to the streamed trainers
    (NN and WDL): the same shard program, the same fold order;
  * microbatch accumulation is pinned sequential: NN K=1/M=3 and K=2/M=2
    equal K=1/M=1 bit for bit (Rprop, as the JAX package pins it);
  * WDL K=3 equals K=1 bit for bit (pure partitioning); K=2/M=2 within
    1e-6;
  * stage-boundary activations are f32; bf16 appears only inside the
    stage matmuls when `mixed_precision` is set.
Against the JAX package, on the same numpy-seeded shards, dropout 0: the
tolerances of tests/test_torch_streaming_train.py (equal epochs, errors
rel 1e-4 / abs 1e-5, weights rtol 2e-3 / atol 2e-4), at K=1 and K=2.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from shifu_tpu_torch.coresident import (CoresidentConfig,  # noqa: E402
                                        train_nn_coresident,
                                        train_wdl_coresident)
from shifu_tpu_torch.coresident.tenant import LocalGrant  # noqa: E402
from shifu_tpu_torch.norm.dataset import (write_codes,  # noqa: E402
                                          write_normalized)
from shifu_tpu_torch.train.nn_trainer import NNTrainConfig  # noqa: E402
from shifu_tpu_torch.train.wdl_trainer import WDLTrainConfig  # noqa: E402

ERR = dict(rel=1e-4, abs=1e-5)
W_TOL = dict(rtol=2e-3, atol=2e-4)


def _write_shards(tmp_path, n=600, d=6, n_shards=2, seed=3, classes=2):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    t = ((1.2 * x[:, 0] - x[:, 1]) > 0).astype(np.int8)
    if classes > 2:
        t = (t + (x[:, 2] > 0.5)).astype(np.int8)
    w = np.ones(n, dtype=np.float32)
    out = str(tmp_path / "NormalizedData")
    write_normalized(out, x, t, w, [f"c{i}" for i in range(d)],
                     n_shards=n_shards)
    return out


def _base(**kw):
    base = dict(hidden_nodes=[6, 5], activations=["tanh"],
                propagation="R", num_epochs=8, valid_set_rate=0.2,
                seed=11)
    base.update(kw)
    return base


def _cfg(**kw):
    return NNTrainConfig(**_base(**kw))


def _flat(params):
    from shifu_tpu_torch.models.nn import flatten_params

    return np.asarray(flatten_params(params)[0])


def _run(data_dir, cfg, stages, microbatches, family_dir, **kw):
    ccfg = CoresidentConfig(stages=stages, microbatches=microbatches,
                            family_dir=str(family_dir),
                            replicas=kw.pop("replicas", 0))
    return train_nn_coresident(data_dir, cfg, ccfg, grant=LocalGrant(),
                               device="cpu", **kw)


def test_nn_stages1_bit_identical_to_streamed(tmp_path):
    from shifu_tpu_torch.train.streaming import train_nn_streamed

    data_dir = _write_shards(tmp_path)
    cfg = _cfg()
    streamed = train_nn_streamed(data_dir, cfg, device="cpu")
    co = _run(data_dir, cfg, 1, 1, tmp_path / "fam")
    assert co.iterations == streamed.iterations
    assert co.train_error == streamed.train_error
    assert co.valid_error == streamed.valid_error
    np.testing.assert_array_equal(_flat(co.params), _flat(streamed.params))


def test_nn_microbatch_accumulation_order_is_pinned(tmp_path):
    """M only reshapes the pipeline fill; the sequential fold makes the
    result bit-identical to whole-shard dispatch."""
    data_dir = _write_shards(tmp_path)
    cfg = _cfg()
    base = _run(data_dir, cfg, 1, 1, tmp_path / "a")
    m3 = _run(data_dir, cfg, 1, 3, tmp_path / "b")
    np.testing.assert_array_equal(_flat(base.params), _flat(m3.params))


def test_nn_two_stage_pipeline_bit_identical(tmp_path):
    data_dir = _write_shards(tmp_path)
    cfg = _cfg()
    base = _run(data_dir, cfg, 1, 1, tmp_path / "a")
    piped = _run(data_dir, cfg, 2, 2, tmp_path / "b")
    np.testing.assert_array_equal(_flat(base.params), _flat(piped.params))


@pytest.mark.parametrize("case", ["adam", "svm", "native3", "ova"])
def test_nn_pipeline_m1_bit_identical_per_head(tmp_path, case):
    """K=2/M=1 runs the monolithic program's ops, split: bit-identical
    to K=1 under any updater and through every head (the hinge loss,
    the K-class one-hot, the ONEVSALL tag transform)."""
    kw = {"adam": dict(propagation="ADAM", learning_rate=0.01),
          "svm": dict(hidden_nodes=[6], loss="hinge", reg_level="L2",
                      regularized_constant=1.0),
          "native3": dict(n_classes=3),
          "ova": dict()}[case]
    data_dir = _write_shards(
        tmp_path, classes=3 if case in ("native3", "ova") else 2)
    cfg = _cfg(**kw)
    tc = 1 if case == "ova" else None
    base = _run(data_dir, cfg, 1, 1, tmp_path / "a", target_class=tc)
    piped = _run(data_dir, cfg, 2, 1, tmp_path / "b", target_class=tc)
    assert piped.iterations == base.iterations
    assert piped.train_error == base.train_error
    np.testing.assert_array_equal(_flat(base.params), _flat(piped.params))


def test_nn_replicas_meet_in_fleet_reduce(tmp_path):
    """R=2 pipeline replicas split the shards round-robin and sum the
    stage gradients through parallel/mesh.fleet_reduce (one reduce a
    stage and one for the metrics, every epoch)."""
    from shifu_tpu_torch import obs

    data_dir = _write_shards(tmp_path, n_shards=4)
    cfg = _cfg(num_epochs=4)
    base = _run(data_dir, cfg, 1, 1, tmp_path / "a")
    obs.reset()
    rep = _run(data_dir, cfg, 2, 1, tmp_path / "b", replicas=2)
    reduces = obs.registry().counter("serve.fleet.reduces").value
    assert reduces == cfg.num_epochs * 3
    assert rep.iterations == base.iterations
    np.testing.assert_allclose(_flat(rep.params), _flat(base.params),
                               rtol=1e-5, atol=1e-6)


def _wdl_fixture(tmp_path, n=600, nd=4, nc=2, vocab=6, seed=5):
    rng = np.random.default_rng(seed)
    dense = rng.normal(size=(n, nd)).astype(np.float32)
    codes = rng.integers(0, vocab, size=(n, nc)).astype(np.int16)
    t = ((dense[:, 0] + (codes[:, 0] >= 3)) > 0.5).astype(np.int8)
    w = np.ones(n, np.float32)
    norm_dir = str(tmp_path / "NormalizedData")
    codes_dir = str(tmp_path / "CleanedData")
    cols = [f"d{i}" for i in range(nd)] + [f"c{i}" for i in range(nc)]
    write_normalized(norm_dir, np.concatenate(
        [dense, codes.astype(np.float32)], 1), t, w, cols, n_shards=2)
    write_codes(codes_dir, np.concatenate(
        [np.zeros((n, nd), np.int16), codes], 1), t, w, cols,
        [1] * nd + [vocab] * nc, n_shards=2)
    return (norm_dir, codes_dir, list(range(nd)), [nd, nd + 1],
            [vocab] * nc)


def _wdl_base(**kw):
    base = dict(hidden=[8, 5], activations=["relu"], embed_dim=4,
                num_epochs=6, valid_set_rate=0.2, seed=3)
    base.update(kw)
    return base


def _wdl_run(fix, cfg, k, m, fam):
    ccfg = CoresidentConfig(stages=k, microbatches=m, family_dir=str(fam))
    return train_wdl_coresident(*fix, cfg, ccfg, grant=LocalGrant(),
                                device="cpu")


def test_wdl_stages1_bit_identical_to_streamed(tmp_path):
    from shifu_tpu_torch.models.wdl import flatten_wdl
    from shifu_tpu_torch.train.streaming_wdl import train_wdl_streamed

    fix = _wdl_fixture(tmp_path)
    cfg = WDLTrainConfig(**_wdl_base(hidden=[8]))
    streamed = train_wdl_streamed(*fix, cfg, device="cpu")
    co = _wdl_run(fix, cfg, 1, 1, tmp_path / "fam")
    assert co.iterations == streamed.iterations
    assert co.valid_error == streamed.valid_error
    np.testing.assert_array_equal(flatten_wdl(co.params),
                                  flatten_wdl(streamed.params))


def test_wdl_pipeline_tracks_single_stage(tmp_path):
    """WDL K=3 reproduces K=1 bit-exactly (pure partitioning); K=2/M=2
    additionally re-times the wide-logit add — pinned to float noise,
    never drift."""
    from shifu_tpu_torch.models.wdl import flatten_wdl

    fix = _wdl_fixture(tmp_path)
    cfg = WDLTrainConfig(**_wdl_base())
    base = _wdl_run(fix, cfg, 1, 1, tmp_path / "a")
    k3 = _wdl_run(fix, cfg, 3, 1, tmp_path / "b")
    np.testing.assert_array_equal(flatten_wdl(base.params),
                                  flatten_wdl(k3.params))
    k2m2 = _wdl_run(fix, cfg, 2, 2, tmp_path / "c")
    np.testing.assert_allclose(flatten_wdl(base.params),
                               flatten_wdl(k2m2.params), atol=1e-6)


class _DtypeLog(torch.overrides.TorchFunctionMode):
    """The operand dtypes of every matmul run under it."""

    def __init__(self):
        super().__init__()
        self.matmul = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in (torch.matmul, torch.Tensor.matmul,
                    torch.Tensor.__matmul__):
            self.matmul.append(tuple(a.dtype for a in args[:2]))
        return func(*args, **(kwargs or {}))


def test_stage_boundary_dtype_is_f32_bf16_only_inside(tmp_path):
    """The activation handed stage to stage (and the cotangent handed
    back) is f32 whether or not mixed precision is set; setting it puts
    bf16 INSIDE the stage matmuls only."""
    from shifu_tpu_torch.coresident.pipeline import make_nn_stage_programs
    from shifu_tpu_torch.coresident.plan import nn_plan
    from shifu_tpu_torch.models.nn import flatten_params, init_params

    flat, shapes = flatten_params(init_params([6, 8, 1], seed=0))
    plan = nn_plan(shapes, 2)
    h = torch.zeros((4, 6), dtype=torch.float32)
    s0, s1 = plan.stages
    flat0 = torch.as_tensor(flat[s0.lo:s0.hi])[None]
    flat1 = torch.as_tensor(flat[s1.lo:s1.hi])[None]
    t = torch.ones(4)
    for mixed in (False, True):
        progs = make_nn_stage_programs(_cfg(mixed_precision=mixed), plan)
        log = _DtypeLog()
        with log:
            out = progs["fwd"][0](flat0, h)
        assert out.dtype == torch.float32  # the boundary contract
        assert all((a == torch.bfloat16) == mixed for pair in log.matmul
                   for a in pair), log.matmul
        assert log.matmul
        _g, cot, *_m = progs["head"](flat1, out, t, t, t * 0)
        assert cot.dtype == torch.float32
        g0, cot_in = progs["bwd"][0](flat0, h, cot)
        assert g0.dtype == torch.float32 and cot_in is None


# ---------------------------------------------------------------------------
# the port against the JAX co-resident trainers
# ---------------------------------------------------------------------------


def _same_result(got, want, jflat, pflat):
    assert got.iterations == want.iterations
    assert got.valid_error == pytest.approx(want.valid_error, **ERR)
    assert got.train_error == pytest.approx(want.train_error, **ERR)
    np.testing.assert_allclose(pflat(got.params),
                               np.asarray(jflat(want.params)), **W_TOL)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("case", ["rprop", "adam_mb2"])
def test_nn_coresident_matches_jax(tmp_path, k, case):
    from shifu_tpu.coresident import CoresidentConfig as JConfig
    from shifu_tpu.coresident import train_nn_coresident as jtrain
    from shifu_tpu.coresident.tenant import LocalGrant as JGrant
    from shifu_tpu.models.nn import flatten_params as jflat
    from shifu_tpu.train.nn_trainer import NNTrainConfig as JCfg

    kw = (dict() if case == "rprop" else
          dict(propagation="ADAM", learning_rate=0.01))
    m = 2 if case == "adam_mb2" else 1
    data_dir = _write_shards(tmp_path)
    want = jtrain(data_dir, JCfg(**_base(**kw)),
                  JConfig(stages=k, microbatches=m,
                          family_dir=str(tmp_path / "j")), grant=JGrant())
    got = _run(data_dir, _cfg(**kw), k, m, tmp_path / "p")
    _same_result(got, want, lambda p: jflat(p)[0], _flat)


@pytest.mark.parametrize("k", [1, 2])
def test_wdl_coresident_matches_jax(tmp_path, k):
    from shifu_tpu.coresident import CoresidentConfig as JConfig
    from shifu_tpu.coresident import train_wdl_coresident as jtrain
    from shifu_tpu.coresident.tenant import LocalGrant as JGrant
    from shifu_tpu.models.wdl import flatten_wdl as jflat
    from shifu_tpu.train.wdl_trainer import WDLTrainConfig as JCfg
    from shifu_tpu_torch.models.wdl import flatten_wdl

    fix = _wdl_fixture(tmp_path)
    want = jtrain(*fix, JCfg(**_wdl_base(learning_rate=0.05)),
                  JConfig(stages=k, microbatches=1,
                          family_dir=str(tmp_path / "j")), grant=JGrant())
    got = _wdl_run(fix, WDLTrainConfig(**_wdl_base(learning_rate=0.05)), k,
                   1, tmp_path / "p")
    _same_result(got, want, jflat, flatten_wdl)


def test_fleet_reduce_matches_jax():
    """The port's fleet_reduce (summed in replica order on the lead
    device, the trailing columns maxed) equals the JAX collective's."""
    from shifu_tpu.parallel import mesh as jmesh

    from shifu_tpu_torch import obs
    from shifu_tpu_torch.parallel import mesh as pmesh

    rng = np.random.default_rng(0)
    parts = rng.normal(size=(4, 7)).astype(np.float32)
    obs.reset()
    for max_cols in (0, 2):
        got = pmesh.fleet_reduce(pmesh.fleet_mesh(4, "cpu"), parts,
                                 max_cols=max_cols)
        want = jmesh.fleet_reduce(jmesh.fleet_mesh(4), parts,
                                  max_cols=max_cols)
        assert got.dtype == np.float64
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        if max_cols:
            np.testing.assert_array_equal(got[-2:], parts[:, -2:].max(0))
    assert obs.registry().counter("serve.fleet.reduces").value == 2

"""The port's WDL model and trainer vs the JAX package's, on the CPU.

Inputs are numpy draws from a seed; each JAX function runs beside its
port. Tolerances: the forward within rtol 1e-5 of JAX; the descent
gradient within 1e-5 x max |g| of `jax.grad`; the init draws, the flat
layout and the `.wdl` file bit- and byte-equal. The trainers (JAX
`train_wdl(mesh=None)` and `train_wdl_bagged(mesh=None)`, one device
each) keep the same iterations, errors within rel 1e-4 / abs 1e-5,
weights within rtol 2e-3 / atol 2e-4 (the NN slice's tolerances,
tests/test_torch_train_nn_step.py:9-13).
"""

import os

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from shifu_tpu.models import wdl as jwdl  # noqa: E402
from shifu_tpu.train import wdl_trainer as jtr  # noqa: E402
from shifu_tpu_torch.models import wdl as pwdl  # noqa: E402
from shifu_tpu_torch.train import wdl_trainer as ptr  # noqa: E402

ERR = dict(rel=1e-4, abs=1e-5)
W_TOL = dict(rtol=2e-3, atol=2e-4)
VOCAB = [5, 3, 7]


def _data(n=400, dn=4, seed=0):
    """Signal in dense column 0 and field 0; field 2 has codes past its
    vocab and below 0 (clipped, never raised on)."""
    rng = np.random.default_rng(seed)
    dense = rng.normal(size=(n, dn)).astype(np.float32)
    codes = np.stack([rng.integers(0, 5, n), rng.integers(0, 3, n),
                      rng.integers(-2, 10, n)], axis=1).astype(np.int32)
    logits = dense[:, 0] * 1.5 + (codes[:, 0] >= 3) * 2.0 - 1.5
    t = (logits + rng.normal(scale=0.4, size=n) > 0).astype(np.float32)
    w = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    return dense, codes, t, w


def _random_params(seed=3, hidden=(8, 4)):
    """Init params with the zero-started arrays drawn too, so every array
    reaches the forward."""
    p = pwdl.init_wdl_params(4, VOCAB, 3, list(hidden), seed=seed)
    rng = np.random.default_rng(seed + 1)
    flat = pwdl.flatten_wdl(p)
    flat = flat + rng.normal(scale=0.3, size=flat.shape).astype(np.float32)
    return pwdl.unflatten_wdl(flat.astype(np.float32), p)


def _jparams(p):
    return jwdl.unflatten_wdl(pwdl.flatten_wdl(p), jwdl.init_wdl_params(
        4, VOCAB, 3, [layer["W"].shape[1] for layer in p.dense_layers[:-1]]))


def test_init_draws_and_flat_layout_bit_equal():
    p = pwdl.init_wdl_params(6, [11, 4], 5, [16, 8], seed=42)
    j = jwdl.init_wdl_params(6, [11, 4], 5, [16, 8], seed=42)
    assert pwdl.flatten_wdl(p).tobytes() == jwdl.flatten_wdl(j).tobytes()
    assert pwdl.wdl_shapes(p) == jwdl.wdl_shapes(j)
    back = pwdl.unflatten_wdl(pwdl.flatten_wdl(p), p)
    assert pwdl.flatten_wdl(back).tobytes() == pwdl.flatten_wdl(p).tobytes()
    assert pwdl.flatten_wdl(pwdl.params_from_jax(j)).tobytes() == \
        jwdl.flatten_wdl(j).tobytes()


@pytest.mark.parametrize("acts,logits_only", [
    (["relu", "tanh"], False), ([], False), (["sigmoid"], True),
    (["leakyrelu", "swish"], False)])
def test_forward_matches_jax(acts, logits_only):
    import jax.numpy as jnp

    dense, codes, _, _ = _data(n=64)
    p = _random_params()
    want = np.asarray(jwdl.wdl_forward(
        _jparams(p), jnp.asarray(dense), jnp.asarray(codes), acts,
        logits_only=logits_only))
    tp = pwdl.params_to(p, "cpu")
    got = pwdl.wdl_forward(tp, torch.as_tensor(dense),
                           torch.as_tensor(codes), acts,
                           logits_only=logits_only).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    net = pwdl.WDLNet(p, acts, device="cpu")
    mod = net(torch.as_tensor(dense), torch.as_tensor(codes),
              logits_only=logits_only).detach().numpy()
    np.testing.assert_array_equal(mod, got)
    # the member axis: two members, the second the first's weights
    flat = np.stack([pwdl.flatten_wdl(p), pwdl.flatten_wdl(p) * 0.5])
    mp = pwdl.unflatten_members(torch.as_tensor(flat), pwdl.wdl_shapes(p),
                                len(VOCAB))
    both = pwdl.wdl_forward(mp, torch.as_tensor(dense),
                            torch.as_tensor(codes), acts,
                            logits_only=logits_only).numpy()
    np.testing.assert_allclose(both[0], got, rtol=1e-5, atol=1e-6)


def test_descent_gradient_matches_jax_grad():
    import jax
    import jax.numpy as jnp

    dense, codes, t, w = _data(n=300)
    p = _random_params()
    shapes = pwdl.wdl_shapes(p)
    flat = pwdl.flatten_wdl(p)
    acts = ["relu", "tanh"]

    def jloss(f):
        pj = jwdl.unflatten_wdl_from_shapes(f, shapes, len(VOCAB))
        prob = jwdl.wdl_forward(pj, jnp.asarray(dense), jnp.asarray(codes),
                                acts)
        pc = jnp.clip(prob, 1e-7, 1 - 1e-7)
        ll = -(t * jnp.log(pc) + (1 - t) * jnp.log(1 - pc))
        return jnp.sum(w * ll)

    want = -np.asarray(jax.grad(jloss)(jnp.asarray(flat)))
    cfg = ptr.WDLTrainConfig(hidden=[8, 4], activations=acts, embed_dim=3)
    loop = ptr._Loop(cfg, shapes, len(VOCAB), torch.as_tensor(dense),
                     torch.as_tensor(codes, dtype=torch.int64),
                     torch.as_tensor(t), torch.as_tensor(w)[None],
                     torch.as_tensor(w)[None], torch.ones(1))
    got, _p = loop.descent(torch.as_tensor(flat)[None])
    scale = float(np.abs(want).max())
    assert float(np.abs(got.numpy()[0] - want).max()) <= 1e-5 * scale


@pytest.mark.parametrize("members", [0, 3])
def test_gather_backward_bit_stable_on_cpu(members):
    """The embedding gather's backward on the CPU gives the same bits in
    three runs, with and without a member axis, at 600 rows of 10 fields
    into tables of 100 rows: enough rows for the CPU's parallel scatter,
    whose float atomics (advanced indexing's `index_put_`) add in another
    order from run to run; `embedding`'s backward adds in row order."""
    rng = np.random.default_rng(7)
    n, vocab, e = 600, [100] * 10, 8
    lead = (members,) if members else ()
    tables = [torch.as_tensor(rng.normal(size=lead + (v, e))
                              .astype(np.float32)) for v in vocab]
    idx = torch.as_tensor(rng.integers(0, 100, size=(n, len(vocab))))
    up = torch.as_tensor(rng.normal(size=lead + (n, len(vocab), e))
                         .astype(np.float32))
    grads = []
    for _ in range(3):
        ts = [t.clone().requires_grad_(True) for t in tables]
        out = pwdl._gather_fields(ts, idx)
        grads.append(torch.autograd.grad((out * up).sum(), ts))
    for run in grads[1:]:
        for a, b in zip(grads[0], run):
            assert torch.equal(a, b)


def test_spec_file_byte_identical_both_ways(tmp_path):
    p = _random_params()
    kw = dict(hidden=[8, 4], activations=["relu", "tanh"], embed_dim=3,
              dense_columns=[f"n{i}" for i in range(4)],
              cat_columns=["c0", "c1", "c2"], vocab_sizes=VOCAB,
              norm_specs=[{"name": "n0", "kind": "value"}], norm_cutoff=3.5,
              categories=[["a", "b", "c", "d"], ["x", "y"],
                          list("pqrstu")],
              norm_type="ZSCORE", train_error=0.125, valid_error=0.25)
    pwdl.WDLModelSpec(params=p, **kw).save(str(tmp_path / "p.wdl"))
    jwdl.WDLModelSpec(params=_jparams(p), **kw).save(str(tmp_path / "j.wdl"))
    blob = (tmp_path / "p.wdl").read_bytes()
    assert blob == (tmp_path / "j.wdl").read_bytes()
    # each package loads the other's file and writes it back unchanged
    pwdl.WDLModelSpec.load(str(tmp_path / "j.wdl")).save(
        str(tmp_path / "p2.wdl"))
    jwdl.WDLModelSpec.load(str(tmp_path / "p.wdl")).save(
        str(tmp_path / "j2.wdl"))
    assert (tmp_path / "p2.wdl").read_bytes() == blob
    assert (tmp_path / "j2.wdl").read_bytes() == blob


def _cfg_pair(**kw):
    base = dict(hidden=[8], activations=["relu"], embed_dim=3,
                learning_rate=0.02, num_epochs=20, valid_set_rate=0.25,
                seed=5)
    base.update(kw)
    return jtr.WDLTrainConfig(**base), ptr.WDLTrainConfig(**base)


def _same_result(a, b):
    assert b.iterations == a.iterations
    assert b.train_error == pytest.approx(a.train_error, **ERR)
    assert b.valid_error == pytest.approx(a.valid_error, **ERR)
    np.testing.assert_allclose(pwdl.flatten_wdl(b.params),
                               jwdl.flatten_wdl(a.params), **W_TOL)


@pytest.mark.parametrize("opt", ["ADAM", "GD", "R"])
def test_train_wdl_matches_jax(opt):
    dense, codes, t, w = _data()
    jc, pc = _cfg_pair(optimizer=opt,
                       learning_rate=0.001 if opt == "GD" else 0.02,
                       l2_reg=0.01 if opt == "ADAM" else 0.0)
    want = jtr.train_wdl(dense, codes, t, w, VOCAB, jc, mesh=None)
    got = ptr.train_wdl(dense, codes, t, w, VOCAB, pc, device="cpu")
    _same_result(want, got)


def test_train_wdl_window_halt_and_progress(tmp_path):
    dense, codes, t, w = _data(n=300)
    seen = {"jax": [], "port": []}
    jc, pc = _cfg_pair(learning_rate=0.1, num_epochs=150,
                       early_stop_window=4, valid_set_rate=0.3,
                       checkpoint_every=7)
    jc.progress_cb = lambda *a: seen["jax"].append(a)
    pc.progress_cb = lambda *a: seen["port"].append(a)
    pc.checkpoint_path = str(tmp_path / "weights.npy")
    want = jtr.train_wdl(dense, codes, t, w, VOCAB, jc, mesh=None)
    got = ptr.train_wdl(dense, codes, t, w, VOCAB, pc, device="cpu")
    assert want.iterations < 150
    _same_result(want, got)
    assert [s[0] for s in seen["port"]] == [s[0] for s in seen["jax"]]
    for a, b in zip(seen["jax"], seen["port"]):
        assert b[1:] == pytest.approx(a[1:], **ERR)
    assert np.load(tmp_path / "weights.npy").shape == (
        pwdl.flatten_wdl(got.params).size,)


@pytest.mark.parametrize("case", ["plain", "member_lrs", "member_sigs",
                                  "window"])
def test_train_wdl_bagged_matches_jax(case, tmp_path):
    dense, codes, t, w = _data(n=360)
    m = 3
    kw, extra = {}, {}
    if case == "plain":
        kw = dict(bagging_sample_rate=0.8, checkpoint_every=6)
    elif case == "member_lrs":
        extra = dict(member_lrs=[0.005, 0.02, 0.08])
    elif case == "member_sigs":
        fold = np.arange(len(t)) % m
        extra = dict(member_sigs=(
            np.stack([np.where(fold == i, 0.0, w) for i in range(m)]),
            np.stack([np.where(fold == i, w, 0.0) for i in range(m)])))
        kw = dict(valid_set_rate=0.0)
    else:
        kw = dict(learning_rate=0.1, num_epochs=120, early_stop_window=3,
                  checkpoint_every=5)
    jc, pc = _cfg_pair(**kw)
    seen = {"jax": [], "port": []}
    jc.progress_cb = lambda *a: seen["jax"].append(a)
    pc.progress_cb = lambda *a: seen["port"].append(a)
    paths = [str(tmp_path / f"w{i}.npy") for i in range(m)]
    want = jtr.train_wdl_bagged(dense, codes, t, w, VOCAB, jc, m, mesh=None,
                                **extra)
    got = ptr.train_wdl_bagged(dense, codes, t, w, VOCAB, pc, m,
                               checkpoint_paths=paths, device="cpu",
                               **extra)
    for a, b in zip(want, got):
        _same_result(a, b)
    if case == "window":
        assert len({r.iterations for r in got}) > 1  # members halt apart
    assert [s[0] for s in seen["port"]] == [s[0] for s in seen["jax"]]
    for a, b in zip(seen["jax"], seen["port"]):
        assert b[1:] == pytest.approx(a[1:], **ERR)
    if pc.checkpoint_every:
        assert all(os.path.isfile(p) for p in paths)


def test_continuous_init_flat_is_used():
    dense, codes, t, w = _data(n=200)
    jc, pc = _cfg_pair(num_epochs=3)
    start = pwdl.flatten_wdl(_random_params(hidden=(8,)))
    want = jtr.train_wdl(dense, codes, t, w, VOCAB, jc, mesh=None,
                         init_flat=start)
    got = ptr.train_wdl(dense, codes, t, w, VOCAB, pc, init_flat=start,
                        device="cpu")
    _same_result(want, got)


def test_independent_model_scores_raw_like_jax(tmp_path):
    """A spec with a norm plan and categories scores raw records through
    the port's `IndependentWDLModel` as through the JAX one."""
    from shifu_tpu.data.reader import ColumnarData as JColumnarData
    from shifu_tpu_torch.data.reader import ColumnarData

    rng = np.random.default_rng(9)
    n = 50
    raw = {"n0": np.array([f"{v:.4f}" for v in rng.normal(size=n)],
                          dtype=object),
           "c0": np.array([["a", "b", "zz", ""][i % 4] for i in range(n)],
                          dtype=object)}
    p = pwdl.init_wdl_params(1, [3], 2, [4], seed=2)
    flat = pwdl.flatten_wdl(p) + rng.normal(
        scale=0.3, size=pwdl.flatten_wdl(p).size).astype(np.float32)
    p = pwdl.unflatten_wdl(flat.astype(np.float32), p)
    spec_kw = dict(
        hidden=[4], activations=["tanh"], embed_dim=2,
        dense_columns=["n0"], cat_columns=["c0"], vocab_sizes=[3],
        norm_specs=[{"name": "n0", "kind": "value", "outNames": ["n0"],
                     "mean": 0.1, "std": 0.9, "fill": 0.0, "zscore": True,
                     "boundaries": [float("-inf")]}],
        categories=[["a", "b"]])
    path = str(tmp_path / "model0.wdl")
    pwdl.WDLModelSpec(params=p, **spec_kw).save(path)
    got = pwdl.IndependentWDLModel.load(path, device="cpu").compute_raw(
        ColumnarData(names=["n0", "c0"], raw=dict(raw), n_rows=n))
    want = jwdl.IndependentWDLModel.load(path).compute_raw(
        JColumnarData(names=["n0", "c0"], raw=dict(raw), n_rows=n))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

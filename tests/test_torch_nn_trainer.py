"""The port's NN/LR/SVM trainer (`shifu_tpu_torch.train.nn_trainer`) vs
the JAX package's, on the CPU.

Data: the JAX tests' `make_xor_like` shape (n = 800, d = 8), hidden [8],
at most 15 epochs (sign-based rules step a whole update on a one-ulp sign
flip, so weight parity is held over short runs). Dropout 0 (the port's
dropout draws from a torch.Generator, not jax.random). Tolerance: the
JAX package's own bagged-vs-serial one (tests/test_train_nn.py:247-253):
equal iterations, errors rel 1e-4 / abs 1e-5, weights rtol 2e-3 /
atol 2e-4. bf16 mixed precision: errors rel 2^-6, weights atol 2^-6
(a few bf16 ulps of O(1) values) over 5 epochs of plain backprop.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from shifu_tpu.models.nn import flatten_params as jflatten  # noqa: E402
from shifu_tpu.train import nn_trainer as J  # noqa: E402
from shifu_tpu_torch.train import nn_trainer as P  # noqa: E402
from shifu_tpu_torch.utils.platform import DeviceUnavailable  # noqa: E402

ERR = dict(rel=1e-4, abs=1e-5)
W_TOL = dict(rtol=2e-3, atol=2e-4)
BF16_TOL = 2.0 ** -6


def make_xor_like(n=800, d=8, seed=3, classes=2):
    """tests/test_train_nn.py make_xor_like; classes > 2 cuts the logit
    into class indices."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    logits = 1.5 * x[:, 0] - 2.0 * x[:, 1] + 0.8 * x[:, 2] * x[:, 3]
    noisy = logits + rng.normal(scale=0.3, size=n)
    if classes > 2:
        t = np.digitize(noisy, np.quantile(noisy, [1 / 3, 2 / 3])).astype(
            np.float32)
    else:
        t = (noisy > 0).astype(np.float32)
    return x, t, np.ones(n, dtype=np.float32)


def _cfgs(**kw):
    base = dict(hidden_nodes=[8], activations=["tanh"], propagation="R",
                num_epochs=15, valid_set_rate=0.2)
    base.update(kw)
    return J.NNTrainConfig(**base), P.NNTrainConfig(**base)


def _same_params(a, b, tol=W_TOL):
    assert len(a) == len(b)
    for la, lb in zip(a, b):
        np.testing.assert_allclose(la["W"], lb["W"], **tol)
        np.testing.assert_allclose(la["b"], lb["b"], **tol)


def _same_result(got, want):
    assert got.iterations == want.iterations
    assert got.valid_error == pytest.approx(want.valid_error, **ERR)
    assert got.train_error == pytest.approx(want.train_error, **ERR)
    _same_params(got.params, want.params)


CASES = {
    "rprop": dict(),
    "quickprop": dict(propagation="Q"),
    "backprop": dict(propagation="B", learning_rate=0.01),
    "adam": dict(propagation="ADAM", learning_rate=0.01),
    "lr": dict(hidden_nodes=[], activations=[], loss="log"),
    "svm": dict(hidden_nodes=[], activations=[], loss="hinge",
                reg_level="L2", regularized_constant=1.0),
    "native_k3": dict(n_classes=3, hidden_nodes=[6]),
    "mini_batch_3": dict(mini_batchs=3),
    "l1_decay": dict(reg_level="L1", regularized_constant=5.0,
                     learning_decay=0.05, propagation="B",
                     learning_rate=0.01),
    "early_stop": dict(early_stop_window=2, num_epochs=60),
    "converge": dict(convergence_threshold=0.1, num_epochs=60),
    "no_valid": dict(valid_set_rate=0.0, bagging_sample_rate=0.7),
}


@pytest.mark.parametrize("case", list(CASES))
def test_train_nn_matches_jax(case):
    kw = CASES[case]
    x, t, w = make_xor_like(classes=kw.get("n_classes", 2))
    jcfg, pcfg = _cfgs(**kw)
    want = J.train_nn(x, t, w, jcfg)
    got = P.train_nn(x, t, w, pcfg, device="cpu")
    _same_result(got, want)
    if case in ("early_stop", "converge"):  # halted before the limit
        assert 1 < got.iterations < 60
    if case == "native_k3":
        assert got.params[-1]["W"].shape == (6, 3)


def test_first_epoch_descent_gradient_matches_jax():
    """g = -dE/dw, summed over records, compared directly."""
    x, t, w = make_xor_like()
    jcfg, pcfg = _cfgs(hidden_nodes=[8, 5], activations=["tanh", "relu"])
    params = J.init_params([8, 8, 5, 1], seed=3)
    flat, shapes = jflatten(params)
    sig, valid = J.split_and_sample(len(t), jcfg)
    g_j, _, _ = J._loss_and_errors(jcfg, shapes)(
        flat, x, t, sig * w, valid.astype(np.float32) * w, None)
    g_p = P.descent_gradient(pcfg, shapes, torch.as_tensor(flat)[None],
                             torch.as_tensor(x), torch.as_tensor(t),
                             torch.as_tensor(sig * w)[None])
    g_j = np.asarray(g_j)
    assert np.abs(g_p[0].numpy() - g_j).max() <= 1e-5 * np.abs(g_j).max()


def test_split_and_sample_draws_equal():
    for kw in (dict(), dict(bagging_with_replacement=True,
                            bagging_sample_rate=0.8),
               dict(bagging_sample_rate=0.6, valid_set_rate=0.3, seed=9)):
        jcfg, pcfg = _cfgs(**kw)
        for a, b in zip(P.split_and_sample(500, pcfg),
                        J.split_and_sample(500, jcfg)):
            assert a.tobytes() == b.tobytes()


def test_bagged_matches_jax_and_serial():
    """M = 4 members, bagging with replacement: each member equals the
    JAX package's bagged member and the port's own M = 1 run."""
    x, t, w = make_xor_like()
    jcfg, pcfg = _cfgs(bagging_sample_rate=0.8, bagging_with_replacement=True)
    want = J.train_nn_bagged(x, t, w, jcfg, 4)
    got = P.train_nn_bagged(x, t, w, pcfg, 4, device="cpu")
    for i in range(4):
        _same_result(got[i], want[i])
        serial = P.train_nn(
            x, t, w, P.NNTrainConfig(**{**pcfg.__dict__, "seed": i * 1000 + 7}),
            device="cpu")
        _same_result(serial, got[i])
    assert got[0].valid_error != got[1].valid_error


def test_bagged_member_tags_lrs_sigs_match_jax():
    x, t3, w = make_xor_like(classes=3)
    n = len(t3)
    tags = np.stack([(t3 == k).astype(np.float32) for k in range(3)])
    jcfg, pcfg = _cfgs(early_stop_window=3, num_epochs=20)
    # ONEVSALL members, grid learning rates, and early stop per member
    want = J.train_nn_bagged(x, t3, w, jcfg, 3, member_tags=tags,
                             member_lrs=[0.05, 0.1, 0.2])
    got = P.train_nn_bagged(x, t3, w, pcfg, 3, member_tags=tags,
                            member_lrs=[0.05, 0.1, 0.2], device="cpu")
    for a, b in zip(got, want):
        _same_result(a, b)
    # k-fold: member_sigs; final weights, final holdout error
    fold = np.arange(n) % 3
    sig_t = np.stack([np.where(fold == i, 0.0, w) for i in range(3)]
                     ).astype(np.float32)
    sig_v = np.stack([np.where(fold == i, w, 0.0) for i in range(3)]
                     ).astype(np.float32)
    jcfg, pcfg = _cfgs(valid_set_rate=0.0, propagation="Q")
    tb = (t3 > 0).astype(np.float32)
    want = J.train_nn_bagged(x, tb, w, jcfg, 3, member_sigs=(sig_t, sig_v))
    got = P.train_nn_bagged(x, tb, w, pcfg, 3, member_sigs=(sig_t, sig_v),
                            device="cpu")
    for a, b in zip(got, want):
        _same_result(a, b)


def test_segmented_run_equals_unsegmented(tmp_path):
    """checkpoint_every 5: the same result as one segment, bit for bit;
    progress at the same epochs as the JAX package's, errors within the
    tolerance; the checkpoint holds the final segment's weights."""
    x, t, w = make_xor_like()
    plain = P.train_nn(x, t, w, _cfgs(early_stop_window=2, num_epochs=30)[1],
                       device="cpu")
    lines = {"jax": [], "port": []}
    jcfg, pcfg = _cfgs(early_stop_window=2, num_epochs=30, checkpoint_every=5,
                       checkpoint_path=str(tmp_path / "w.npy"))
    jcfg.progress_cb = lambda *a: lines["jax"].append(a)
    pcfg.progress_cb = lambda *a: lines["port"].append(a)
    J.train_nn(x, t, w, jcfg)
    seg = P.train_nn(x, t, w, pcfg, device="cpu")
    assert seg.iterations == plain.iterations < 30
    assert seg.valid_error == plain.valid_error
    for a, b in zip(seg.params, plain.params):
        assert np.array_equal(a["W"], b["W"]) and np.array_equal(a["b"], b["b"])
    assert [ln[0] for ln in lines["port"]] == [ln[0] for ln in lines["jax"]]
    for a, b in zip(lines["port"], lines["jax"]):
        assert a[1:] == pytest.approx(b[1:], **ERR)
    assert np.load(tmp_path / "w.npy").shape == (8 * 8 + 8 + 8 + 1,)

    # bagged: ((member, epoch), tr, va), a halted member reported once
    for side in lines.values():
        side.clear()
    jcfg.checkpoint_path = pcfg.checkpoint_path = None
    J.train_nn_bagged(x, t, w, jcfg, 3)
    got = P.train_nn_bagged(x, t, w, pcfg, 3, device="cpu")
    assert [ln[0] for ln in lines["port"]] == [ln[0] for ln in lines["jax"]]
    for a, b in zip(lines["port"], lines["jax"]):
        assert a[1:] == pytest.approx(b[1:], **ERR)
    pcfg.progress_cb = None
    pcfg.checkpoint_every = 0
    for a, b in zip(got, P.train_nn_bagged(x, t, w, pcfg, 3, device="cpu")):
        assert a.iterations == b.iterations and a.valid_error == b.valid_error


def test_bf16_mixed_precision_matches_jax():
    x, t, w = make_xor_like()
    jcfg, pcfg = _cfgs(mixed_precision=True, propagation="B", num_epochs=5)
    want = J.train_nn(x, t, w, jcfg)
    got = P.train_nn(x, t, w, pcfg, device="cpu")
    assert got.iterations == want.iterations
    assert got.valid_error == pytest.approx(want.valid_error, rel=BF16_TOL)
    _same_params(got.params, want.params, dict(rtol=0.0, atol=BF16_TOL))


def test_continuous_init_and_dropout():
    x, t, w = make_xor_like()
    _, pcfg = _cfgs(num_epochs=4)
    first = P.train_nn(x, t, w, pcfg, device="cpu")
    flat, _ = jflatten(first.params)
    jcfg, pcfg = _cfgs(num_epochs=4)
    want = J.train_nn(x, t, w, jcfg, init_flat=flat)
    _same_result(P.train_nn(x, t, w, pcfg, init_flat=flat, device="cpu"),
                 want)
    # dropout: its own generator, the same draws on every run
    _, pcfg = _cfgs(dropout_rate=0.3, num_epochs=6)
    a = P.train_nn(x, t, w, pcfg, device="cpu")
    b = P.train_nn(x, t, w, pcfg, device="cpu")
    assert a.valid_error == b.valid_error and np.isfinite(a.valid_error)
    assert not np.array_equal(a.params[0]["W"], P.train_nn(
        x, t, w, _cfgs(num_epochs=6)[1], device="cpu").params[0]["W"])


def test_config_from_model_config_matches_jax():
    from shifu_tpu.config.model_config import ModelConfig as JMC
    from shifu_tpu.config.model_config import new_model_config
    from shifu_tpu.config.model_config import Algorithm as JAlg
    from shifu_tpu_torch.config.model_config import ModelConfig as PMC

    import json
    import tempfile

    for alg, params in (("NN", {"NumHiddenNodes": [7, 3],
                                "ActivationFunc": ["relu", "tanh"],
                                "Propagation": "ADAM", "MiniBatchs": 2,
                                "L1orL2": "l2", "RegularizedConstant": 0.1}),
                        ("LR", {"LearningRate": 0.3}),
                        ("SVM", {"Const": 4.0})):
        mc = new_model_config("M", JAlg.parse(alg))
        mc.train.params = params
        mc.train.bagging_with_replacement = True
        with tempfile.TemporaryDirectory() as d:
            path = f"{d}/ModelConfig.json"
            mc.save(path)
            jm, pm = JMC.load(path), PMC.load(path)
        for tid in (0, 3):
            a = dict(J.NNTrainConfig.from_model_config(
                jm, trainer_id=tid).__dict__)
            b = P.NNTrainConfig.from_model_config(pm, trainer_id=tid)
            assert a.pop("is_continuous") is False  # read by no JAX code
            assert json.dumps(a, default=str) == json.dumps(
                b.__dict__, default=str)
    mc.train.params = {"Kernel": "rbf"}
    with tempfile.TemporaryDirectory() as d:
        mc.save(f"{d}/ModelConfig.json")
        pm = PMC.load(f"{d}/ModelConfig.json")
    with pytest.raises(ValueError, match="linear"):
        P.NNTrainConfig.from_model_config(pm)


def test_train_nn_needs_a_card_unless_asked(monkeypatch):
    x, t, w = make_xor_like(n=50)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailable):
        P.train_nn(x, t, w, _cfgs(num_epochs=1)[1])
    with pytest.raises(DeviceUnavailable):
        P.train_nn_bagged(x, t, w, _cfgs(num_epochs=1)[1], 2)


@pytest.mark.parametrize("params", [
    {"LearningRate": [0.1, 0.2], "NumHiddenNodes": [[10], [20]],
     "Propagation": "R"},
    {"LearningRate": 0.1, "NumHiddenNodes": [10]},
    {"A": list(range(10)), "B": list(range(10))},
])
def test_grid_search_copy_matches_jax(params, tmp_path):
    from shifu_tpu.train import grid_search as jgs
    from shifu_tpu_torch.train import grid_search as pgs

    assert pgs.flatten_params(params) == jgs.flatten_params(params)
    grid = tmp_path / "grid.conf"
    grid.write_text("LearningRate:0.1;NumHiddenNodes:[30,20]\n\n"
                    "Propagation:Q;LearningRate:2\n")
    assert (pgs.flatten_params(params, str(grid))
            == jgs.flatten_params(params, str(grid)))

"""The port's MLP model (`shifu_tpu_torch.models.nn`) vs the JAX package's.

Tolerances: activations rtol 1e-6 (the same formulas; only libm
differs); `init_params` and the flat layout bit-equal (the same numpy
draws); `forward` / `IndependentNNModel.compute_all` rtol 1e-5 (f32
matmuls summed in another order); the `.nn` file byte-identical for the
same params, and each package loads the other's file.
"""

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")
torch = pytest.importorskip("torch")

from shifu_tpu.models import nn as jnn  # noqa: E402
from shifu_tpu_torch.models import nn as pnn  # noqa: E402

ACTS = ["sigmoid", "tanh", "relu", "leakyrelu", "swish", "ptanh", "linear",
        "log", "gaussian"]


@pytest.mark.parametrize("name", ACTS)
def test_activation_matches_jax(name):
    x = np.random.default_rng(1).normal(scale=3.0, size=4096).astype(
        np.float32)
    x[:4] = [0.0, -0.0, 40.0, -40.0]
    want = np.asarray(jnn.activation_fn(name)(jnp.asarray(x)))
    got = pnn.activation_fn(name)(torch.as_tensor(x)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_activation_aliases_and_unknown():
    x = torch.linspace(-2, 2, 9)
    assert torch.equal(pnn.activation_fn("logistic")(x),
                       pnn.activation_fn("sigmoid")(x))
    assert torch.equal(pnn.activation_fn("leaky_relu")(x),
                       pnn.activation_fn("LeakyRelu")(x))
    with pytest.raises(ValueError, match="unknown activation"):
        pnn.activation_fn("softsign")


@pytest.mark.parametrize("init", ["xavier", "he", "lecun", "gaussian"])
def test_init_params_bytes_equal(init):
    sizes = [13, 7, 5, 1]
    want = jnn.init_params(sizes, seed=11, init=init)
    got = pnn.init_params(sizes, seed=11, init=init)
    for a, b in zip(got, want):
        assert a["W"].tobytes() == b["W"].tobytes()
        assert a["b"].tobytes() == b["b"].tobytes()
        assert a["W"].dtype == np.float32


def test_flat_layout_matches_jax():
    params = jnn.init_params([6, 4, 3], seed=2)
    flat_j, shapes_j = jnn.flatten_params(params)
    flat_p, shapes_p = pnn.flatten_params(params)
    assert flat_p.tobytes() == flat_j.tobytes()
    assert shapes_p == [tuple(s) for s in shapes_j] == [(6, 4), (4, 3)]
    # per layer W [in, out] row-major, then b
    w0 = params[0]["W"]
    assert np.array_equal(flat_p[:24], w0.ravel())
    assert np.array_equal(flat_p[24:28], params[0]["b"])
    back = pnn.unflatten_params(flat_p, shapes_p)
    for a, b in zip(back, params):
        assert np.array_equal(a["W"], b["W"]) and np.array_equal(a["b"], b["b"])


@pytest.mark.parametrize("sizes,acts,out_act", [
    ([10, 8, 1], ["tanh"], "sigmoid"),
    ([10, 8, 6, 3], ["relu", "swish"], "sigmoid"),
    ([10, 1], [], "linear"),
    ([10, 5, 5, 5, 2], ["ptanh", "log", "gaussian"], "sigmoid"),
])
def test_forward_and_compute_all_match_jax(sizes, acts, out_act):
    rng = np.random.default_rng(4)
    params = jnn.init_params(sizes, seed=5)
    for p in params:
        p["b"] = rng.normal(scale=0.1, size=p["b"].shape).astype(np.float32)
    x = rng.normal(size=(300, sizes[0])).astype(np.float32)
    want = np.asarray(jnn.forward(params, jnp.asarray(x), acts, out_act))
    mlp = pnn.mlp_from_params(params, "cpu", acts, out_act)
    got = mlp(torch.as_tensor(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # the other direction of the weight carrier
    for a, b in zip(pnn.params_from_mlp(mlp), params):
        assert np.array_equal(a["W"], b["W"]) and np.array_equal(a["b"], b["b"])
    spec_kw = dict(layer_sizes=sizes, activations=acts, out_activation=out_act,
                   params=params)
    jm = jnn.IndependentNNModel(jnn.NNModelSpec(**spec_kw))
    pm = pnn.IndependentNNModel(pnn.NNModelSpec(**spec_kw), device="cpu")
    np.testing.assert_allclose(pm.compute_all(x), jm.compute_all(x),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pm.compute(x), jm.compute(x), rtol=1e-5,
                               atol=1e-6)


def _spec_kw():
    params = jnn.init_params([4, 3, 2], seed=9)
    return dict(
        layer_sizes=[4, 3, 2], activations=["tanh"], input_columns=list("abcd"),
        norm_type="ZSCALE", algorithm="NN", loss="squared",
        norm_specs=[{"name": "a", "kind": "value", "mean": 0.25,
                     "std": 1.5, "fill": 0.0}],
        norm_cutoff=4.0, params=params, train_error=0.12345678901234567,
        valid_error=0.1, class_tags=["x", "y"])


def test_model_file_bytes_and_cross_load(tmp_path):
    jpath, ppath = str(tmp_path / "j.nn"), str(tmp_path / "p.nn")
    jnn.NNModelSpec(**_spec_kw()).save(jpath)
    pnn.NNModelSpec(**_spec_kw()).save(ppath)
    with open(jpath, "rb") as a, open(ppath, "rb") as b:
        assert a.read() == b.read()
    x = np.random.default_rng(0).normal(size=(20, 4)).astype(np.float32)
    # each package loads the other's file and scores it the same
    from_j = pnn.NNModelSpec.load(jpath)
    from_p = jnn.NNModelSpec.load(ppath)
    assert from_j.header() == from_p.header()
    np.testing.assert_allclose(
        pnn.IndependentNNModel(from_j, device="cpu").compute_all(x),
        jnn.IndependentNNModel(from_p).compute_all(x), rtol=1e-5, atol=1e-6)
    assert pnn.IndependentNNModel.load(jpath, device="cpu").spec.out_dim == 2
    (tmp_path / "bad.nn").write_bytes(b"XXXX")
    with pytest.raises(ValueError, match="not a shifu-tpu .nn model"):
        pnn.NNModelSpec.load(str(tmp_path / "bad.nn"))


def test_independent_model_needs_a_card_unless_asked(monkeypatch):
    from shifu_tpu_torch.utils.platform import DeviceUnavailable

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailable):
        pnn.IndependentNNModel(pnn.NNModelSpec(**_spec_kw()))

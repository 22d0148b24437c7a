"""The port's weight-update rules (`shifu_tpu_torch.train.updaters`) vs
the JAX package's `make_updater`.

Three chained applies from the same (w, g, state), every rule x reg
NONE/L1/L2: rtol 1e-6 (ADAM's pow, the square roots and Quickprop's
division may differ by libm; the sign-based rules are exact). The member
axis: M = 3 members with their own lr, it and nts equal their own
M = 1 calls bit for bit.
"""

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")
torch = pytest.importorskip("torch")

from shifu_tpu.train.updaters import make_updater as jmake  # noqa: E402
from shifu_tpu_torch.train.updaters import make_updater as pmake  # noqa: E402

RULES = ["B", "Q", "M", "R", "ADAM", "ADAGRAD", "RMSPROP", "MOMENTUM",
         "NESTEROV"]
EXACT = {"B", "M", "R"}
N = 257


def _gradients(seed, k=3):
    rng = np.random.default_rng(seed)
    gs = [rng.normal(scale=2.0, size=N).astype(np.float32) for _ in range(k)]
    for g in gs:
        g[:8] = 0.0  # zero gradients
    gs[1][8:40] = -gs[0][8:40]  # sign reversals for RPROP / Quickprop
    return gs


@pytest.mark.parametrize("reg_level,reg", [("NONE", 0.0), ("L1", 3.0),
                                           ("L2", 3.0)])
@pytest.mark.parametrize("prop", RULES)
def test_three_applies_match_jax(prop, reg_level, reg):
    kw = dict(momentum=0.7, reg=reg, reg_level=reg_level)
    jinit, japply = jmake(prop, **kw)
    pinit, papply = pmake(prop, **kw)
    w0 = np.random.default_rng(1).normal(size=N).astype(np.float32)
    jw, js = jnp.asarray(w0), jinit(N)
    pw, ps = torch.as_tensor(w0)[None], pinit(1, N, torch.device("cpu"))
    assert sorted(ps) == sorted(js)
    for it, g in enumerate(_gradients(2), start=1):
        lr, nts = 0.05 * it, 123.0 + it
        jw, js = japply(js, jw, jnp.asarray(g), jnp.float32(lr),
                        jnp.int32(it), jnp.float32(nts))
        pw, ps = papply(ps, pw, torch.as_tensor(g)[None],
                        torch.tensor([lr], dtype=torch.float32),
                        torch.tensor([it], dtype=torch.int32),
                        torch.tensor([nts], dtype=torch.float32))
        rtol = 0.0 if prop in EXACT and reg_level != "L1" else 1e-6
        np.testing.assert_allclose(pw[0].numpy(), np.asarray(jw), rtol=rtol,
                                   atol=1e-7 if rtol else 0.0)
        for k in js:
            np.testing.assert_allclose(ps[k][0].numpy(), np.asarray(js[k]),
                                       rtol=rtol, atol=1e-7 if rtol else 0.0)


@pytest.mark.parametrize("prop", RULES)
def test_member_axis_equals_single_members(prop):
    """Each of M = 3 members (own lr, it, nts) equals its M = 1 call."""
    init, apply = pmake(prop, momentum=0.5, reg=2.0, reg_level="L2")
    rng = np.random.default_rng(7)
    w = torch.as_tensor(rng.normal(size=(3, N)).astype(np.float32))
    lr = torch.tensor([0.1, 0.02, 0.5])
    it = torch.tensor([1, 4, 9], dtype=torch.int32)
    nts = torch.tensor([10.0, 500.0, 77.0])
    state = init(3, N, torch.device("cpu"))
    singles = [(w[i: i + 1], init(1, N, torch.device("cpu")))
               for i in range(3)]
    for g in _gradients(8):
        gm = torch.as_tensor(np.stack([g, -g, 0.5 * g]))
        w, state = apply(state, w, gm, lr, it, nts)
        for i in range(3):
            wi, si = apply(singles[i][1], singles[i][0], gm[i: i + 1],
                           lr[i: i + 1], it[i: i + 1], nts[i: i + 1])
            singles[i] = (wi, si)
            assert torch.equal(w[i], wi[0])
            for k in state:
                assert torch.equal(state[k][i], si[k][0])
        it = it + 1


def test_unknown_rule_raises():
    with pytest.raises(ValueError, match="unknown propagation"):
        pmake("LBFGS")

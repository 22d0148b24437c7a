"""The port's eval metrics, gain chart and multi-class functions vs the JAX
package's, bit for bit.

All three are numpy on the host in both packages, so every case must give
the same arrays, the same dicts (floats compared by ==) and the same HTML
string: seeded scores with ties, weights, an empty input, an all-one-class
input, and multi-class score matrices in NATIVE's model-major blocks and
ONEVSALL's one column a class.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

from shifu_tpu.eval import gainchart as jgain  # noqa: E402
from shifu_tpu.eval import metrics as jm  # noqa: E402
from shifu_tpu.eval import multiclass as jmc  # noqa: E402
from shifu_tpu_torch.eval import gainchart as pgain  # noqa: E402
from shifu_tpu_torch.eval import metrics as pm  # noqa: E402
from shifu_tpu_torch.eval import multiclass as pmc  # noqa: E402


def _case(kind, seed=0, n=2000):
    """(scores, tags, weights) of one case; scores on the score file's
    0.001 grid, so ties are common."""
    rng = np.random.default_rng(seed)
    if kind == "empty":
        return np.zeros(0), np.zeros(0), np.zeros(0)
    tags = (rng.random(n) < 0.35).astype(np.float64)
    if kind == "one_class":
        tags[:] = 1.0
    scores = np.round(np.clip(rng.normal(400 + 250 * tags, 180), 0, 1000)
                      / 5) * 5.0  # ties: a 5-point grid
    weights = (None if kind == "unweighted"
               else rng.integers(1, 512, size=n) / 256.0)
    return scores, tags, weights


CASES = ["weighted", "unweighted", "empty", "one_class"]


def _sweep_fields(cs):
    return {k: getattr(cs, k) for k in cs.__dataclass_fields__}


def _assert_same_sweep(a, b):
    fa, fb = _sweep_fields(a), _sweep_fields(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        if isinstance(fa[k], np.ndarray):
            assert fa[k].dtype == fb[k].dtype, k
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
        else:
            assert fa[k] == fb[k] and type(fa[k]) is type(fb[k]), k


@pytest.mark.parametrize("kind", CASES)
def test_confusion_sweep_and_perf_bit_equal(kind):
    s, t, w = _case(kind)
    a, b = jm.confusion_sweep(s, t, w), pm.confusion_sweep(s, t, w)
    _assert_same_sweep(a, b)
    for buckets in (10, 7):
        pa = jm.evaluate_performance_from_sweep(a, buckets).to_json()
        pb = pm.evaluate_performance_from_sweep(b, buckets).to_json()
        assert pa == pb
        assert repr(pa) == repr(pb)  # json.dump prints floats by repr
    assert jm.auc_from_sweep(a) == pm.auc_from_sweep(b)
    assert (jm.auc_from_sweep(a, weighted=True)
            == pm.auc_from_sweep(b, weighted=True))
    for step in (0, 3):
        assert (jm.confusion_matrix_rows(a, step)
                == pm.confusion_matrix_rows(b, step))
    assert (jm.evaluate_performance(s, t, w).to_json()
            == pm.evaluate_performance(s, t, w).to_json())


@pytest.mark.parametrize("kind", CASES)
def test_sweep_from_histogram_bit_equal(kind):
    s, t, w = _case(kind, seed=1)
    w = np.ones_like(s) if w is None else w
    uniq, inv = np.unique(s, return_inverse=True)
    tallies = [np.bincount(inv, weights=v, minlength=len(uniq))
               for v in (t, 1.0 - t, t * w, (1.0 - t) * w)]
    a = jm.sweep_from_histogram(uniq, *tallies)
    b = pm.sweep_from_histogram(uniq, *tallies)
    _assert_same_sweep(a, b)
    assert (jm.evaluate_performance_from_sweep(a).to_json()
            == pm.evaluate_performance_from_sweep(b).to_json())


@pytest.mark.parametrize("kind", CASES)
def test_gain_chart_same_string(kind):
    s, t, w = _case(kind, seed=2)
    ja = jm.evaluate_performance(s, t, w)
    pb = pm.evaluate_performance(s, t, w)
    assert (jgain.render_gain_chart("Eval1", "Model", ja)
            == pgain.render_gain_chart("Eval1", "Model", pb))


def _multi_scores(seed, n, m, k):
    rng = np.random.default_rng(seed)
    tags = rng.integers(0, k, size=n)
    scores = rng.random((n, m * k)) * 1000.0
    for i in range(m):  # each model favours the true class a little
        scores[np.arange(n), i * k + tags] += 300.0
    return np.round(scores), tags


@pytest.mark.parametrize("k,m", [(3, 1), (3, 2), (4, 3)])
def test_native_prediction_model_major(k, m):
    scores, tags = _multi_scores(3, 500, m, k)
    a, b = jmc.predict_native(scores, k), pmc.predict_native(scores, k)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        pmc.predict_native(scores[:, 1:], k)
    ma = jmc.confusion_matrix_multi(tags, a, k)
    mb = pmc.confusion_matrix_multi(tags, b, k)
    np.testing.assert_array_equal(ma, mb)
    assert jmc.multiclass_accuracy(ma) == pmc.multiclass_accuracy(mb)
    names = [f"c{i}" for i in range(k)]
    assert (jmc.confusion_matrix_text(ma, names)
            == pmc.confusion_matrix_text(mb, names))


@pytest.mark.parametrize("k", [1, 2, 3, 5])
def test_one_vs_all_threshold_semantics(k):
    rng = np.random.default_rng(4)
    scores = np.round(rng.random((800, k)) * 1000.0)
    priors = rng.random(k)
    priors /= priors.sum()
    a = jmc.predict_one_vs_all(scores, priors, scale=1000.0)
    b = pmc.predict_one_vs_all(scores, priors, scale=1000.0)
    np.testing.assert_array_equal(a, b)
    if k >= 3:  # rows with no class past its threshold take the top prior
        none = ~(scores > (1.0 - priors) * 1000.0).any(axis=1)
        assert none.any() and (b[none] == np.argmax(priors)).all()
    tags = rng.integers(-1, k + 1, size=800)  # out-of-range tags dropped
    np.testing.assert_array_equal(jmc.confusion_matrix_multi(tags, a, k),
                                  pmc.confusion_matrix_multi(tags, b, k))
    assert (jmc.class_priors(tags, k) == pmc.class_priors(tags, k)).all()


def test_empty_multiclass_matrix():
    m = pmc.confusion_matrix_multi(np.zeros(0), np.zeros(0), 3)
    assert m.shape == (3, 3) and pmc.multiclass_accuracy(m) == 0.0
    assert (jmc.confusion_matrix_text(m, ["a", "b", "c"])
            == pmc.confusion_matrix_text(m, ["a", "b", "c"]))

"""The port's autotype sketches (`shifu_tpu_torch/stats/sketch.py`) vs
pandas' hash and the JAX package's sketches, on the CPU. All exact: the
hash bit for bit, the distinct estimates and the autotype counts equal.
"""

import numpy as np
import pytest

pd = pytest.importorskip("pandas")
pytest.importorskip("torch")
pytest.importorskip("jax")

from shifu_tpu.stats import sketch as jsketch  # noqa: E402
from shifu_tpu_torch.stats import sketch as psketch  # noqa: E402

MISSING = ("", "*", "#", "?", "null", "~")


def _pandas_hash(values, dtype):
    return pd.util.hash_pandas_object(pd.Series(values, dtype=dtype),
                                      index=False).to_numpy(np.uint64)


def _strings(seed, n, alphabet="ab01.é日\x00 -", max_len=40):
    rng = np.random.default_rng(seed)
    chars = np.array(list(alphabet))
    return ["".join(rng.choice(chars, size=rng.integers(0, max_len + 1)))
            for _ in range(n)]


@pytest.mark.parametrize("dtype", [object, "string[pyarrow]", "str"])
def test_hash_equals_pandas(dtype):
    values = ["", "a", "abcdefg", "abcdefgh", "abcdefghi", "a" * 16, "é",
              "日本語テキスト", "𝄞", "\x00", "a\x00b", "a", " green ",
              "1.23456", "x" * 100, "　"] + _strings(0, 2000)
    np.testing.assert_array_equal(psketch.hash_strings(values),
                                  _pandas_hash(values, dtype))


def test_hash_of_printed_numbers_equals_pandas():
    x = np.random.default_rng(1).normal(size=20000)
    values = ["%.5f" % v for v in x] + ["%.17g" % v for v in x[:500]]
    np.testing.assert_array_equal(psketch.hash_strings(values),
                                  _pandas_hash(values, "str"))


@pytest.mark.parametrize("n_distinct", [100, 4096, 4097, 50_000])
def test_distinct_estimate_equals_jax(n_distinct):
    rng = np.random.default_rng(n_distinct)
    pool = np.array([f"v{i}_{rng.integers(1 << 30)}"
                     for i in range(n_distinct)], dtype=object)
    values = np.concatenate([pool, pool[rng.integers(0, n_distinct,
                                                     size=n_distinct)]])
    rng.shuffle(values)
    j, p = jsketch.DistinctSketch(), psketch.DistinctSketch()
    for part in np.array_split(values, 5):  # chunked, as init folds it
        j.update_series(pd.Series(part, dtype="string[pyarrow]"))
        p.update_values(part)
    assert p.estimate() == j.estimate()
    assert (p.exact is None) == (n_distinct > 4096)
    np.testing.assert_array_equal(p.registers, j.registers)


def test_distinct_fold_is_free_of_chunking():
    """init folds a column chunk by chunk: any chunking, one crossing the
    exact limit mid-chunk included, gives the one-chunk sketch."""
    values = np.array(_strings(2, 9000, max_len=8), dtype=object)
    whole = psketch.DistinctSketch()
    whole.update_values(values)
    for size in (4000, 777):
        parts = psketch.DistinctSketch()
        for a in range(0, len(values), size):
            parts.update_values(values[a:a + size])
        assert parts.estimate() == whole.estimate()
        assert parts.exact is None and whole.exact is None
        np.testing.assert_array_equal(parts.registers, whole.registers)


@pytest.mark.parametrize("kind", ["numeric", "categorical", "mixed"])
def test_autotype_sketch_equals_jax(kind):
    rng = np.random.default_rng(3)
    n = 6000
    if kind == "numeric":
        values = np.array([f"{v:.5f}" for v in rng.normal(size=n)],
                          dtype=object)
    elif kind == "categorical":
        values = np.array([f"c{k}" for k in rng.integers(0, 40, size=n)],
                          dtype=object)
    else:
        pool = np.array(["1", " 2 ", "x", "inf", "1e400", "nan", "\xa03",
                         "1_0", "０", " ? ", "null", "", "-0", "7.5", "abc",
                         "\x1c4\x1c"], dtype=object)
        values = pool[rng.integers(0, len(pool), size=n)]
    j, p = jsketch.AutoTypeSketch(MISSING), psketch.AutoTypeSketch(MISSING)
    for part in np.array_split(values, 3):
        j.update(pd.Series(part, dtype="string[pyarrow]"))
        p.update(part)
    assert (p.total, p.missing, p.numeric_ok) == (j.total, j.missing,
                                                  j.numeric_ok)
    assert p.distinct_count() == j.distinct_count()
    assert p.numeric_ratio() == j.numeric_ratio()

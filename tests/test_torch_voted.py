"""The port's voted variable selection (varsel VOTED / V) vs the JAX
package's, on the CPU.

The GA is chaotic: `_next_generation` sorts by validation error, and a
near-tie ordered differently in f32 changes every later generation. So
the pieces are held apart:
  * the batched candidate evaluator against the vmapped JAX program on
    the same inputs: per-candidate errors within 1e-4 absolute;
  * the seeds, masks and `_next_generation` bit-equal (numpy draws);
  * `voted_selection` bit-equal when both evaluators are given the same
    errors (the JAX run's, replayed);
  * the whole `shifu varsel` step with VOTED and with V on a model set
    whose informative columns separate well: the JAX voted.csv and the
    JAX final selection.
"""

import json
import os
import shutil

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from shifu_tpu.processor.varsel import VarSelProcessor as JVarSel  # noqa: E402
from shifu_tpu.varsel import voted as jv  # noqa: E402
from shifu_tpu_torch import cli  # noqa: E402
from shifu_tpu_torch.config import load_column_config_list  # noqa: E402
from shifu_tpu_torch.processor.varsel import VarSelProcessor  # noqa: E402
from shifu_tpu_torch.varsel import voted as pv  # noqa: E402
from tests.test_torch_config import jax_inline_ingest  # noqa: E402
from tests.test_torch_varsel import varsel_set  # noqa: E402,F401


def _problem(n=300, d=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    t = ((x[:, 0] + 0.8 * x[:, 3] - 0.5 * x[:, 5]
          + rng.normal(scale=0.3, size=n)) > 0).astype(np.float32)
    w = rng.uniform(0.5, 1.5, n).astype(np.float32)
    return x, t, w


@pytest.mark.parametrize("hidden,acts", [([5], ["tanh"]),
                                         ([4, 3], ["relu", "sigmoid"]),
                                         ([], [])])
def test_eval_program_matches_jax(hidden, acts):
    """P=6 candidates, d=8, 10 epochs: the errors within 1e-4."""
    x, t, w = _problem()
    n, d = x.shape
    P, epochs, lr = 6, 10, 0.05
    rng = np.random.default_rng(4)
    prog, n_total = jv._get_eval_program(d, tuple(hidden), tuple(acts),
                                         epochs, lr)
    assert n_total == pv.n_weights(d, hidden)
    flats = rng.normal(0, 0.1, size=(P, n_total)).astype(np.float32)
    seeds = [sorted(rng.choice(d, size=4, replace=False).tolist())
             for _ in range(P)]
    masks = jv._masks_from_seeds(seeds, d)
    valid = rng.random(n) < 0.25
    sig_tr = np.where(valid, 0.0, w).astype(np.float32)
    sig_va = np.where(valid, w, 0.0).astype(np.float32)
    want = np.asarray(prog(flats, masks, x, t, sig_tr, sig_va))
    port = pv._get_eval_program(tuple(hidden), tuple(acts), epochs, lr)
    tt = [torch.as_tensor(a) for a in (flats, masks, x, t, sig_tr, sig_va)]
    got = port(*tt).numpy()
    assert got.shape == (P,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # the mask cuts a feature out: its first-layer weights never move the
    # error (a candidate with feature 0 masked scores the same whatever
    # its feature-0 weights are)
    if hidden:
        bumped = flats.copy()
        for i, s in enumerate(seeds):
            if 0 not in s:
                bumped[i, :hidden[0]] += 5.0
        tt[0] = torch.as_tensor(bumped)
        moved = port(*tt).numpy()
        off = [i for i, s in enumerate(seeds) if 0 not in s]
        np.testing.assert_array_equal(moved[off], got[off])


def test_seeds_masks_and_next_generation_bit_equal():
    d = 12
    for seed in range(5):
        cfg = pv.VotedConfig(expect_var_count=5, population_size=10,
                             cross_percent=60, mutation_percent=20,
                             seed=seed)
        jcfg = jv.VotedConfig(expect_var_count=5, population_size=10,
                              cross_percent=60, mutation_percent=20,
                              seed=seed)
        src = np.random.default_rng(100 + seed)
        seeds = [sorted(src.choice(d, size=5, replace=False).tolist())
                 for _ in range(10)]
        errors = src.random(10).astype(np.float32)
        r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
        got = pv._next_generation(seeds, errors, cfg, r1, d)
        want = jv._next_generation(seeds, errors, jcfg, r2, d)
        assert got == want
        np.testing.assert_array_equal(pv._masks_from_seeds(got, d),
                                      jv._masks_from_seeds(want, d))
        assert r1.random() == r2.random()


def test_voted_selection_bit_equal_given_jax_errors(monkeypatch):
    """The JAX run's per-generation errors, replayed into the port's GA:
    the same seeds, best seed and votes, bit for bit."""
    x, t, w = _problem(n=200, d=10, seed=2)
    kw = dict(expect_var_count=4, population_size=8, generations=4,
              hidden_nodes=[3], epochs=5, learning_rate=0.05, seed=11)
    recorded, seen_masks = [], []
    real = jv._get_eval_program

    def recording(*a, **k):
        prog, n_total = real(*a, **k)

        def run(flats, masks, *rest):
            seen_masks.append(np.asarray(masks))
            out = np.asarray(prog(flats, masks, *rest))
            recorded.append(out)
            return out
        return run, n_total

    monkeypatch.setattr(jv, "_get_eval_program", recording)
    want_best, want_votes = jv.voted_selection(x, t, w, jv.VotedConfig(**kw))
    replay = iter(recorded)
    port_masks = []

    def replaying(*a, **k):
        def run(flats, masks, *rest):
            port_masks.append(masks.numpy())
            return torch.as_tensor(np.array(next(replay)))
        return run

    monkeypatch.setattr(pv, "_get_eval_program", replaying)
    hist = []
    got_best, got_votes = pv.voted_selection(
        x, t, w, pv.VotedConfig(**kw), device="cpu", history=hist)
    assert got_best == want_best
    np.testing.assert_array_equal(got_votes, want_votes)
    assert len(port_masks) == len(seen_masks) == 4
    for a, b in zip(port_masks, seen_masks):
        np.testing.assert_array_equal(a, b)
    for (seeds, errs), masks, want in zip(hist, seen_masks, recorded):
        np.testing.assert_array_equal(errs, want)
        np.testing.assert_array_equal(pv._masks_from_seeds(seeds, 10),
                                      masks)


def test_voted_config_from_model_config(varsel_set):  # noqa: F811
    from shifu_tpu.config import ModelConfig as JMC
    from shifu_tpu_torch.config import ModelConfig as PMC

    path = os.path.join(varsel_set, "ModelConfig.json")
    got = pv.VotedConfig.from_model_config(PMC.load(path), seed=3)
    want = jv.VotedConfig.from_model_config(JMC.load(path), seed=3)
    assert vars(got) == vars(want)


# ---- the step ---------------------------------------------------------------

VOTED_PARAMS = {"population_live_size": 8, "population_multiply_cnt": 3,
                "expect_variable_cnt": 4}


def _voted_pair(src, tmp_path, filter_by):
    roots = [str(tmp_path / side) for side in ("jax", "port")]
    for r in roots:
        shutil.copytree(src, r)
        path = os.path.join(r, "ModelConfig.json")
        with open(path) as fh:
            blob = json.load(fh)
        blob["varSelect"].update(filterBy=filter_by, filterNum=6,
                                 wrapperNum=4, forceEnable=False,
                                 params=dict(VOTED_PARAMS))
        blob["train"]["numTrainEpochs"] = 20
        blob["train"]["params"].update(NumHiddenNodes=[4],
                                       ActivationFunc=["tanh"],
                                       LearningRate=0.1)
        with open(path, "w") as fh:
            json.dump(blob, fh, indent=2)
    return roots


def _read(root, *rel):
    with open(os.path.join(root, *rel)) as fh:
        return fh.read()


@pytest.mark.parametrize("filter_by", ["VOTED", "voted"])
def test_varsel_voted_step_matches_jax(varsel_set, tmp_path,  # noqa: F811
                                       filter_by):
    """`shifu varsel` with VOTED (any case): the JAX voted.csv and the
    JAX ColumnConfig.json, byte for byte."""
    roots = _voted_pair(varsel_set, tmp_path, filter_by)
    with jax_inline_ingest():
        assert JVarSel(roots[0]).run() == 0
    cwd = os.getcwd()
    try:
        os.chdir(roots[1])
        assert cli.main(["varsel", "--device", "cpu"]) == 0
    finally:
        os.chdir(cwd)
    csv = ("tmp", "varsel", "voted.csv")
    assert _read(roots[1], *csv) == _read(roots[0], *csv)
    assert _read(roots[1], "ColumnConfig.json") == _read(
        roots[0], "ColumnConfig.json")
    cols = load_column_config_list(os.path.join(roots[1],
                                                "ColumnConfig.json"))
    assert 0 < sum(c.final_select for c in cols) <= 4


def test_filter_by_v_is_refused_as_in_jax(varsel_set, tmp_path):  # noqa: F811
    """`filterBy: "V"`: both processors route V to the GA as they do
    VOTED, but both config probes refuse V before the step runs (the
    valid filters end at VOTED), so each exits 1 with the same cause and
    changes nothing."""
    roots = _voted_pair(varsel_set, tmp_path, "V")
    before = _read(roots[1], "ColumnConfig.json")
    from shifu_tpu.utils.errors import ShifuError as JShifuError
    from shifu_tpu_torch.utils.errors import ShifuError

    with jax_inline_ingest(), pytest.raises(JShifuError, match="'V'"):
        JVarSel(roots[0]).run()
    with pytest.raises(ShifuError, match="'V'"):
        VarSelProcessor(roots[1], device="cpu").run()
    cwd = os.getcwd()
    try:
        os.chdir(roots[1])
        assert cli.main(["varsel", "--device", "cpu"]) == 1
    finally:
        os.chdir(cwd)
    for r in roots:
        assert _read(r, "ColumnConfig.json") == before
        assert not os.path.exists(os.path.join(r, "tmp", "varsel",
                                               "voted.csv"))
    from shifu_tpu.config import ModelConfig as JMC
    from shifu_tpu.config.inspector import probe as jprobe
    from shifu_tpu_torch.config import ModelConfig as PMC
    from shifu_tpu_torch.config.inspector import probe as pprobe

    path = os.path.join(roots[1], "ModelConfig.json")
    got = pprobe(PMC.load(path), "varsel", base_dir=roots[1])
    want = jprobe(JMC.load(path), "varsel", base_dir=roots[1])
    assert (got.status, got.causes) == (want.status, want.causes)
    assert not got.status and "'V'" in got.causes[0]


def test_voted_step_without_norm_raises(varsel_set, tmp_path):  # noqa: F811
    root = _voted_pair(varsel_set, tmp_path, "VOTED")[1]
    shutil.rmtree(os.path.join(root, "tmp", "norm", "NormalizedData"))
    from shifu_tpu_torch.utils.errors import ShifuError

    with pytest.raises(ShifuError, match="run `shifu norm` first"):
        VarSelProcessor(root, device="cpu").run()

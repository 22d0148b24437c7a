"""The port's stage partitioning (`shifu_tpu_torch/coresident/plan.py`)
vs the JAX package's `tests/test_coresident_plan.py` and its
`shifu_tpu/coresident/plan.py`.

Each JAX case has its counterpart here under the same name, on the
port's module. On top, the port's `StagePlan` (stages, shapes, boundary
widths, resident bytes) equals the JAX one field for field over NN and
WDL layouts at K = 1..4, `default_stages` equals the JAX function over a
grid of budgets, and the WDL layout the port's `wdl_shapes` gives is the
JAX `wdl_shapes`'s.

The invariant everything else leans on: a stage IS a contiguous
`[lo, hi)` slice of the flat parameter vector, the slices tile the
vector exactly, and the elementwise updaters therefore make per-stage
updates concatenate bit-identically to full-vector updates.
"""

import dataclasses
import math

import numpy as np
import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

from shifu_tpu_torch.coresident.plan import (  # noqa: E402
    default_stages,
    nn_plan,
    wdl_plan,
)


def _nn_shapes(sizes):
    return [(sizes[i], sizes[i + 1]) for i in range(len(sizes) - 1)]


def _wdl_shapes(nd=4, nc=2, vocab=6, embed=4, hidden=(8, 5)):
    # models/wdl.wdl_arrays order: embed tables, wide tables, wide_dense,
    # (W, b) per dense layer, bias
    shapes = [(vocab, embed)] * nc + [(vocab, 1)] * nc + [(nd, 1)]
    widths = [nd + nc * embed] + list(hidden) + [1]
    for i in range(len(widths) - 1):
        shapes += [(widths[i], widths[i + 1]), (widths[i + 1],)]
    shapes += [(1,)]
    return shapes, nc


class TestNNPlan:
    def test_slices_tile_the_flat_vector_exactly(self):
        shapes = _nn_shapes([12, 8, 6, 4, 1])
        total = sum(fi * fo + fo for fi, fo in shapes)
        for k in (1, 2, 3, 4):
            plan = nn_plan(shapes, k)
            assert plan.n_stages == k
            assert plan.stages[0].lo == 0
            assert plan.stages[-1].hi == total
            for a, b in zip(plan.stages, plan.stages[1:]):
                assert a.hi == b.lo  # contiguous, no gap, no overlap
            flat = np.arange(total, dtype=np.float32)
            np.testing.assert_array_equal(np.concatenate(plan.slices(flat)),
                                          flat)

    def test_loss_head_lands_in_the_last_stage(self):
        shapes = _nn_shapes([10, 7, 5, 1])
        for k in (1, 2, 3):
            assert nn_plan(shapes, k).stages[-1].layer_hi == len(shapes)

    def test_boundary_widths_are_the_cut_layers_outputs(self):
        shapes = _nn_shapes([12, 8, 6, 4, 1])
        plan = nn_plan(shapes, 2)
        # K=2 over 4 layers cuts after layer 1 -> boundary width = 6
        assert plan.boundary_widths == [
            shapes[plan.stages[0].layer_hi - 1][1]]
        assert nn_plan(shapes, 4).boundary_widths == [8, 6, 4]

    def test_more_stages_than_layers_rejected(self):
        shapes = _nn_shapes([6, 4, 1])
        with pytest.raises(ValueError, match="stages"):
            nn_plan(shapes, 3)
        with pytest.raises(ValueError, match="stages"):
            nn_plan(shapes, 0)


class TestWDLPlan:
    def test_prefix_and_bias_welded_yet_contiguous(self):
        shapes, nc = _wdl_shapes()
        total = sum(int(math.prod(s)) for s in shapes)
        for k in (1, 2, 3):
            plan = wdl_plan(shapes, nc, k)
            assert plan.stages[0].lo == 0       # embed/wide prefix
            assert plan.stages[-1].hi == total  # trailing bias
            for a, b in zip(plan.stages, plan.stages[1:]):
                assert a.hi == b.lo
            flat = np.arange(total, dtype=np.float32)
            np.testing.assert_array_equal(np.concatenate(plan.slices(flat)),
                                          flat)

    def test_boundary_carries_deep_width_plus_wide_logit(self):
        shapes, nc = _wdl_shapes(hidden=(8, 5))
        # 3 dense layers cut 2|1: boundary after the 2nd dense layer
        # (width 5) + the wide logit column riding beside it
        assert wdl_plan(shapes, nc, 2).boundary_widths == [5 + 1]


class TestDefaultStages:
    def test_unbounded_grant_means_one_stage(self):
        assert default_stages(None, 10_000, 4) == 1
        assert default_stages(0, 10_000, 4) == 1

    def test_tight_budget_grows_k_and_caps_at_max(self):
        total = 1000 * 4  # bytes
        assert default_stages(100_000, total, 8, opt_leaves=1) == 1
        # (2 + 1 leaf) x params / free
        assert default_stages(total, total, 8, opt_leaves=1) == 3
        assert default_stages(1, total, 8) == 8  # capped

    def test_resident_bytes_accounts_weights_opt_and_boundaries(self):
        plan = nn_plan(_nn_shapes([12, 8, 1]), 2)
        s0 = plan.stages[0].n_params
        # stage 0: weights + 2 opt leaves + its outgoing boundary
        assert plan.resident_bytes(0, opt_leaves=2, mb_rows=16) == (
            s0 * 4 * 3 + plan.boundary_widths[0] * 16 * 4)
        s1 = plan.stages[1].n_params
        # last stage: only the incoming boundary
        assert plan.resident_bytes(1, opt_leaves=2, mb_rows=16) == (
            s1 * 4 * 3 + plan.boundary_widths[0] * 16 * 4)


# ---------------------------------------------------------------------------
# the port's plans against the JAX package's
# ---------------------------------------------------------------------------


def _same_plan(port, jax_plan):
    assert dataclasses.asdict(port) == dataclasses.asdict(jax_plan)
    assert port.n_stages == jax_plan.n_stages
    for k in range(port.n_stages):
        assert port.param_bytes(k) == jax_plan.param_bytes(k)
        for leaves, rows in ((0, 1), (1, 64), (3, 1000)):
            assert (port.resident_bytes(k, leaves, rows)
                    == jax_plan.resident_bytes(k, leaves, rows))


@pytest.mark.parametrize("sizes", [[12, 8, 6, 4, 1], [30, 50, 1],
                                   [6, 5, 4, 3, 3]])
def test_nn_plan_equals_jax(sizes):
    from shifu_tpu.coresident import plan as jplan

    shapes = _nn_shapes(sizes)
    for k in range(1, len(shapes) + 1):
        _same_plan(nn_plan(shapes, k), jplan.nn_plan(shapes, k))


@pytest.mark.parametrize("hidden", [(8,), (8, 5), (16, 8, 4)])
def test_wdl_plan_equals_jax(hidden):
    from shifu_tpu.coresident import plan as jplan

    shapes, nc = _wdl_shapes(hidden=hidden)
    for k in range(1, len(hidden) + 2):
        _same_plan(wdl_plan(shapes, nc, k), jplan.wdl_plan(shapes, nc, k))


def test_wdl_layout_of_the_port_is_the_jax_layout():
    """The shapes the port's trainer plans over are the JAX trainer's,
    so a stage slices the same entries of the flat vector."""
    from shifu_tpu.coresident import plan as jplan
    from shifu_tpu.models import wdl as jwdl

    from shifu_tpu_torch.models import wdl as pwdl

    args = (4, [6, 3], 4, [8, 5])
    pt = pwdl.init_wdl_params(*args, seed=3)
    jt = jwdl.init_wdl_params(*args, seed=3)
    pshapes, jshapes = pwdl.wdl_shapes(pt), jwdl.wdl_shapes(jt)
    assert [int(np.prod(s)) for s in pshapes] == \
        [int(np.prod(s)) for s in jshapes]
    np.testing.assert_array_equal(pwdl.flatten_wdl(pt),
                                  np.asarray(jwdl.flatten_wdl(jt)))
    for k in (1, 2, 3):
        p = wdl_plan(pshapes, 2, k)
        j = jplan.wdl_plan(jshapes, 2, k)
        assert [(s.lo, s.hi, s.layer_lo, s.layer_hi) for s in p.stages] \
            == [(s.lo, s.hi, s.layer_lo, s.layer_hi) for s in j.stages]
        assert p.boundary_widths == j.boundary_widths


def test_default_stages_equals_jax():
    from shifu_tpu.coresident import plan as jplan

    for free in (None, 0, 1, 999, 4000, 12_000, 100_000):
        for total in (400, 4000, 40_000):
            for max_k in (1, 3, 8):
                for leaves in (0, 1, 3):
                    assert default_stages(free, total, max_k, leaves) == \
                        jplan.default_stages(free, total, max_k, leaves)

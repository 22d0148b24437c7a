"""Stage partitioning: contiguous flat-vector slices per pipeline stage
(counterpart of `shifu_tpu/coresident/plan.py`, the same pure arithmetic).

Both trainers keep their parameters as ONE flat f32 vector (the update
rules in train/updaters.py are purely elementwise, so per-stage slice
updates concatenate bit-identically to full-vector updates — that fact
is what makes the `stages=1` degenerate config provably equal to the
streamed trainers). A stage therefore is nothing more than a contiguous
`[lo, hi)` slice of the flat vector plus the layer group it covers:

  NN   layer i owns `fi*fo + fo` consecutive entries (W then b, the
       models/nn.flatten_params order); stage k = a contiguous run of
       layers. The final layer (loss head) always lands in the last
       stage.
  WDL  the models/wdl.wdl_arrays order is embed tables, wide tables,
       wide_dense, (W, b) per dense layer, bias — so the embedding/wide
       block is stage 0's prefix, the dense layers split contiguously,
       and the bias rides the last stage. Also contiguous.

Per-stage resident cost (what the ledger is asked for BEFORE any
`.to(device)`) = weights + optimizer leaves (host-counted exactly) +
activation buffers (microbatch boundary arrays, estimated; the stage
programs' own allocations join through the true-up after the first
epoch, the same two-step pricing the serving tenants use).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

F32 = 4  # bytes


@dataclass
class Stage:
    index: int
    layer_lo: int   # layer-group [layer_lo, layer_hi)
    layer_hi: int
    lo: int         # flat slice [lo, hi)
    hi: int

    @property
    def n_params(self) -> int:
        return self.hi - self.lo


@dataclass
class StagePlan:
    kind: str                     # "nn" | "wdl"
    stages: List[Stage]
    shapes: List[Tuple[int, ...]]  # per-array shapes in flat order
    n_cat: int = 0                 # WDL: categorical field count
    boundary_widths: List[int] = field(default_factory=list)  # len K-1

    @property
    def n_stages(self) -> int:
        return len(self.stages)

    def slices(self, flat):
        """Split a flat vector (numpy or torch) into per-stage pieces."""
        return [flat[s.lo:s.hi] for s in self.stages]

    def param_bytes(self, k: int) -> int:
        return self.stages[k].n_params * F32

    def resident_bytes(self, k: int, opt_leaves: int, mb_rows: int) -> int:
        """Ledger ask for stage k: weights + optimizer state (exact) +
        boundary activation buffers for one in-flight microbatch
        (estimate; trued up from the profiler after first dispatch)."""
        w = self.param_bytes(k)
        opt = self.stages[k].n_params * F32 * max(0, opt_leaves)
        acts = 0
        if self.boundary_widths:
            if k > 0:
                acts += self.boundary_widths[k - 1] * mb_rows * F32
            if k < self.n_stages - 1:
                acts += self.boundary_widths[k] * mb_rows * F32
        return w + opt + acts


def _contiguous_groups(n_units: int, k: int) -> List[Tuple[int, int]]:
    """Split `n_units` ordered units into `k` non-empty contiguous
    groups, balanced by count (deterministic)."""
    if not 1 <= k <= n_units:
        raise ValueError(
            f"stages={k} needs 1..{n_units} (one layer group per stage)")
    bounds = [round(i * n_units / k) for i in range(k + 1)]
    return [(bounds[i], bounds[i + 1]) for i in range(k)]


def nn_plan(shapes: List[Tuple[int, int]], k: int) -> StagePlan:
    """`shapes` is the (fi, fo) per layer list from flatten_params; the
    flat layout per layer is W (fi*fo) then b (fo)."""
    sizes = [fi * fo + fo for (fi, fo) in shapes]
    offs = [0]
    for s in sizes:
        offs.append(offs[-1] + s)
    groups = _contiguous_groups(len(shapes), k)
    stages = [Stage(i, lo, hi, offs[lo], offs[hi])
              for i, (lo, hi) in enumerate(groups)]
    # the activation forwarded past stage i has the width of its last
    # layer's output
    widths = [shapes[hi - 1][1] for (_lo, hi) in groups[:-1]]
    return StagePlan(kind="nn", stages=stages,
                     shapes=[tuple(s) for s in shapes],
                     boundary_widths=widths)


def wdl_plan(shapes: List[Tuple[int, ...]], n_cat: int,
             k: int) -> StagePlan:
    """`shapes` from models/wdl.wdl_shapes: n_cat embed tables, n_cat
    wide tables, wide_dense, (W, b) per dense layer, bias. Stage units
    are the DENSE layers; the embed/wide/wide_dense prefix is welded to
    stage 0 and the bias to the last stage, so every stage is still one
    contiguous flat slice."""
    sizes = [int(math.prod(s)) for s in shapes]
    offs = [0]
    for s in sizes:
        offs.append(offs[-1] + s)
    head = 2 * n_cat + 1            # embed + wide + wide_dense arrays
    n_dense = (len(shapes) - head - 1) // 2
    groups = _contiguous_groups(n_dense, k)
    stages = []
    for i, (dlo, dhi) in enumerate(groups):
        a_lo = head + 2 * dlo if i else 0           # weld the prefix
        a_hi = head + 2 * dhi + (1 if i == k - 1 else 0)  # weld bias
        stages.append(Stage(i, dlo, dhi, offs[a_lo], offs[a_hi]))
    # boundary past stage i = deep activation width after its last dense
    # layer (the wide logit rides beside it as one [mb] column)
    widths = [shapes[head + 2 * (dhi - 1)][1] + 1
              for (_dlo, dhi) in groups[:-1]]
    return StagePlan(kind="wdl", stages=stages,
                     shapes=[tuple(s) for s in shapes], n_cat=n_cat,
                     boundary_widths=widths)


def default_stages(free_bytes: Optional[int], total_param_bytes: int,
                   max_stages: int, opt_leaves: int = 1) -> int:
    """K when `-Dshifu.coresident.stages=0`: the smallest stage count
    whose per-stage resident footprint (weights + optimizer state,
    ~3x params with one opt leaf) fits the grant's free budget; 1 when
    the grant is unbounded or everything fits on one device."""
    if not free_bytes or free_bytes <= 0:
        return 1
    per_stage_factor = (2 + max(0, opt_leaves)) * total_param_bytes
    k = -(-per_stage_factor // max(1, free_bytes))  # ceil
    return max(1, min(int(k), max_stages))

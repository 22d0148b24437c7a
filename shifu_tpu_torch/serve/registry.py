"""Model registry: load a model set once, score raw records in one fused
program (counterpart of `shifu_tpu/serve/registry.py`).

The offline `ModelRunner` (eval/scorer.py) normalizes and forwards model
by model and aggregates in numpy. For an NN model set the registry
instead stages every input once and runs, as one Python function over
tensors on `device`:

  each unique norm plan's `value_norm`, `table_norm` and one-hot
  (bagged models usually share one plan) -> every model's MLP forward
  -> x scale -> mean, max, min and median over the model axis.

These are the norm engine's own functions (norm/normalizer.py) and the
MLP's own forward (models/nn.py), so offline norm, eval and serving
share one semantics. The JAX package compiles the same function with
`jax.jit` into one program per row bucket; here it runs eagerly, one
kernel per torch op (the launches a batch are measured by
`chip_smoke.py` phase 11).

Transfer discipline: the host featurize fills one preallocated
[bucket, C] f32 staging buffer per row bucket (each plan's values, then
its bin codes carried as f32 and cast back on the device); on cuda it is
pinned and crosses in ONE `copy_(non_blocking=True)` into a device
buffer of the same bucket, and the five outputs come back stacked in ONE
`.cpu()`, which synchronizes: only after it may the pinned buffer be
refilled. On the CPU the staging tensor is a view of the numpy buffer,
used only inside the call.

Batches pad to power-of-two row buckets (at least 8 rows), so a
deployment sees O(log max_batch_rows) shapes; `warm()` runs the buckets
it expects once.

Sets with a tree, WDL or reference-format spec fall back to the port's
`ModelRunner` (`fused` is False); `column_configs` and `model_config`
give an Encog EG-text `.nn` its norm plan, as in the runner. Their
record schema holds every raw column a model reads, a WDL model's
categorical columns and a reference model's columns included (the JAX
registry leaves those out, so its `score_records` fails on a WDL set:
ROADMAP C.10).

Drift (`drift=`, a `loop/drift.DriftMonitor`): the monitor's raw numeric
values, bin codes and a valid-row column ride the same staging tensor,
and the program's second variant folds them into the monitor's resident
device window after the forward pass (no extra copy either way); the
fallback folds on the host (`fold_host`). `drift_live` gates the fold:
`warm()`'s synthetic rows never fold, and a staged shadow registry
shares the monitor without double-counting the batches it re-scores.
The model zoo's seams (serve/zoo.py): `put_hook(nbytes)` fires before
each group of tensors goes to the device (each plan's constants, each
layer's W and b, the drift constants; a fallback set's weights as one
piece), so the zoo's budget ledger admits a set group by group;
`cost_hook()` fires after a batch that ran a new row bucket;
`memory_analysis()` prices the registry's residency; `release()` drops
its tensors (eviction). The JAX registry prices its compiled programs
from XLA's `memory_analysis()`; this registry runs eagerly, so there is
no compiled program to ask: `programPeakBytes` is counted from the
tensors that the torch calls of the fused function's first call at a
bucket return (`program_bytes`, `costSource: "analytic"`), by shape and
dtype; the allocator, whose peak is device-wide, is never read.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from shifu_tpu_torch.data.reader import ColumnarData, flat_numeric_matrix
from shifu_tpu_torch.eval.scorer import (
    DEFAULT_SCORE_SCALE,
    ModelRunner,
    ScoreResult,
    find_model_paths,
    load_model,
)
from shifu_tpu_torch.obs import profile, registry, reqtrace
from shifu_tpu_torch.serve import wire
from shifu_tpu_torch.utils.log import get_logger
from shifu_tpu_torch.utils.platform import DeviceLike, resolve_device

log = get_logger(__name__)

# smallest serving bucket: a single-record request pads to 8 rows
SERVE_MIN_ROW_BUCKET = 8


def bucket_rows(n: int, minimum: int = SERVE_MIN_ROW_BUCKET) -> int:
    """Smallest power of two >= n, at least `minimum`."""
    if n <= minimum:
        return minimum
    return 1 << int(n - 1).bit_length()


# the caching allocator's block: every device allocation is a multiple
ALLOC_BLOCK_BYTES = 512


def _block(nbytes: int) -> int:
    """`nbytes` rounded up to the caching allocator's block (0 stays 0)."""
    return -(-int(nbytes) // ALLOC_BLOCK_BYTES) * ALLOC_BLOCK_BYTES


class _CountAllocs(TorchFunctionMode):
    """Counts the bytes that the torch calls run under it return new:
    each result whose storage is none of its call's inputs' (a view or
    an in-place result is not new), rounded up to the allocator's block,
    as if none were freed before the count is read. A temporary inside
    one call (the reciprocal behind `1.0 / x`) is not seen. The mode is
    this thread's only: another thread's scoring does not enter it."""

    def __init__(self) -> None:
        super().__init__()
        self.nbytes = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        inputs = {t.untyped_storage().data_ptr()
                  for t in _buffers((args, kwargs))
                  if isinstance(t, torch.Tensor)}
        for t in _buffers(out):
            if isinstance(t, torch.Tensor) \
                    and t.untyped_storage().data_ptr() not in inputs:
                self.nbytes += _block(t.untyped_storage().nbytes())
        return out


def _ndarray_nbytes(obj) -> int:
    """Total bytes of the numpy arrays and tensors reachable under `obj`
    (lists, tuples, dicts and dataclass fields walked)."""
    return sum(int(a.nbytes) if isinstance(a, np.ndarray)
               else int(a.numel() * a.element_size()) for a in _buffers(obj))


def _spec_weight_bytes(spec) -> int:
    """One spec's weight bytes: its params tree, or (trees, adapters)
    every array reachable on the spec. One definition for the
    registration-time estimate and the fallback's resident charge."""
    n = _ndarray_nbytes(getattr(spec, "params", None))
    if not n and hasattr(spec, "__dict__"):
        n = _ndarray_nbytes(vars(spec))
    return n


def estimate_weights_bytes(models_dir: str, column_configs=None,
                           model_config=None) -> int:
    """Weight-byte estimate of a model set, its specs loaded on the CPU
    (no device work): what `serve/zoo.py` prices a tenant at before
    admission decides whether it can ever be resident."""
    paths = find_model_paths(models_dir)
    if not paths:
        raise ValueError(f"no models under {models_dir}")
    return sum(_spec_weight_bytes(load_model(p, column_configs,
                                             model_config, device="cpu"))
               for p in paths)


def model_set_sha(paths: Sequence[str]) -> str:
    """Content hash of the whole model set (names and bytes)."""
    h = hashlib.sha256()
    for p in sorted(paths):
        h.update(os.path.basename(p).encode())
        with open(p, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:16]


def records_to_columnar(records: Sequence[dict],
                        columns: Sequence[str]) -> ColumnarData:
    """JSON records -> the raw columnar batch, each column typed once by
    the binary format's own rule (`wire.column_from_values`): JSON
    numbers arrive typed and are never parsed again."""
    raw: Dict[str, np.ndarray] = {
        c: wire.column_from_values([r.get(c) for r in records])
        for c in columns
    }
    return ColumnarData(names=list(columns), raw=raw, n_rows=len(records))


def schema_of(specs) -> List[str]:
    """The raw source columns the model specs read, first-seen order: a
    registry's record schema. A fused (all-NN) set reads its norm plans'
    columns; the fallback adds each model's own input columns, a WDL
    model's categorical columns and a reference model's columns (the JAX
    registry leaves those out: ROADMAP C.10)."""
    from shifu_tpu_torch.models.nn import NNModelSpec

    fused = all(isinstance(sp, NNModelSpec) for sp in specs)
    seen: List[str] = []
    for spec in specs:
        names = [cd["name"] for cd in getattr(spec, "norm_specs", None)
                 or []]
        if not fused:
            names += getattr(spec, "input_columns", None) or []
            names += getattr(spec, "cat_columns", None) or []
        for name in names:
            if name not in seen:
                seen.append(name)
    return seen


def model_set_columns(models_dir: str, column_configs=None,
                      model_config=None) -> List[str]:
    """`schema_of` the models under `models_dir`, loaded on the CPU (no
    device work): what a server's drift monitor may watch before the
    registry exists."""
    return schema_of([load_model(p, column_configs, model_config,
                                 device="cpu")
                      for p in find_model_paths(models_dir)])


def pin_device(device: DeviceLike) -> torch.device:
    """`resolve_device`, with a cuda device given its index: replica
    threads never read the per-thread current device."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class _PlanFeaturizer:
    """The host half of one norm plan: raw batch -> (filled f32 values,
    int32 bin codes), as `apply_norm_plan` prepares them (the missing
    fill in float64 before the f32 cast)."""

    def __init__(self, plan) -> None:
        self.plan = plan
        self.value_specs = [s for s in plan.specs if s.kind == "value"]
        self.coded_specs = [s for s in plan.specs
                            if s.kind in ("table", "onehot")]
        self._fill64 = np.asarray([s.fill for s in self.value_specs],
                                  dtype=np.float64)

    def __call__(self, data: ColumnarData,
                 code_cache: Optional[dict] = None,
                 numeric_cache: Optional[dict] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
        from shifu_tpu_torch.norm.normalizer import _bin_codes_for

        n = data.n_rows
        if self.value_specs:
            vals64 = self._numeric_matrix(data, numeric_cache)
            with np.errstate(over="ignore"):  # the overflow to inf is meant
                vals = np.where(np.isfinite(vals64), vals64,
                                self._fill64[None, :]).astype(np.float32)
        else:
            vals = np.zeros((n, 0), dtype=np.float32)
        if self.coded_specs:
            codes = np.stack(
                [_bin_codes_for(s.cc, data, code_cache)
                 for s in self.coded_specs], axis=1).astype(np.int32)
        else:
            codes = np.zeros((n, 0), dtype=np.int32)
        return vals, codes

    def _numeric_matrix(self, data: ColumnarData,
                        cache: Optional[dict] = None) -> np.ndarray:
        """[n, Cv] float64, NaN for missing or invalid, in one flattened
        parse; `cache` shares each column's parse with the other plans of
        the request."""
        names = [s.cc.column_name for s in self.value_specs]
        if cache is not None and all(c in cache for c in names):
            return np.stack([cache[c] for c in names], axis=1)
        out = flat_numeric_matrix(data, names)
        if cache is not None:
            for k, c in enumerate(names):
                cache[c] = out[:, k]
        return out


class _PlanConsts:
    """One plan's constants on the device, made once: the value-norm
    operands, the padded tables, the one-hot widths, and the column
    order that puts the pieces back in spec order."""

    def __init__(self, plan, device: torch.device, put_hook=None) -> None:
        from shifu_tpu_torch.norm.normalizer import value_params

        value_specs = [s for s in plan.specs if s.kind == "value"]
        coded = [s for s in plan.specs if s.kind in ("table", "onehot")]
        table_specs = [s for s in coded if s.kind == "table"]
        self.nbytes = 0

        def put(a) -> torch.Tensor:
            a = np.ascontiguousarray(a)
            if put_hook is not None:  # the ledger acquires first
                put_hook(int(a.nbytes))
            t = torch.as_tensor(a, device=device)
            self.nbytes += int(t.numel() * t.element_size())
            return t

        self.value = None
        if value_specs:
            self.value = [put(a) for a in value_params(
                np.asarray([s.mean for s in value_specs], np.float32),
                np.asarray([s.std for s in value_specs], np.float32),
                np.asarray([1.0 if s.zscore else 0.0 for s in value_specs],
                           np.float32),
                plan.cutoff)]
        self.n_table = len(table_specs)
        self.n_out = plan.n_out
        self.tables = None
        self.tab_positions = None
        if table_specs:
            max_s = max(s.table.size for s in table_specs)
            tables = np.zeros((len(table_specs), max_s), dtype=np.float32)
            for k, s in enumerate(table_specs):
                tables[k, : s.table.size] = s.table
            self.tables = put(tables)
            pos = [i for i, s in enumerate(coded) if s.kind == "table"]
            self.tab_positions = (slice(0, len(pos)) if pos == list(
                range(len(pos))) else put(np.asarray(pos, np.int64)))
        # one-hot columns: (position among the codes, width, slot ids)
        self.onehots = [
            (i, s.n_out, put(np.arange(s.n_out, dtype=np.int32)))
            for i, s in enumerate(coded) if s.kind == "onehot"]
        # pieces come out grouped (values, tables, one-hots in turn);
        # `order` maps each spec-order column to its grouped position
        group = {"value": [], "table": [], "onehot": []}
        at = 0
        for s in plan.specs:
            group[s.kind].append((s, at))
            at += s.n_out
        grouped = []
        for kind in ("value", "table", "onehot"):
            for s, start in group[kind]:
                grouped.extend(range(start, start + s.n_out))
        order = np.argsort(np.asarray(grouped, np.int64), kind="stable")
        self.order = (None if (order == np.arange(len(order))).all()
                      else put(order))


def _plan_norm(c: _PlanConsts, vals: torch.Tensor,
               codes: torch.Tensor) -> torch.Tensor:
    """One plan's normalized matrix [n, plan.n_out] in spec order."""
    from shifu_tpu_torch.norm.normalizer import table_norm, value_norm

    pieces = []
    if c.value is not None:
        pieces.append(value_norm(vals, *c.value))
    if c.tables is not None:
        tab_codes = (codes[:, c.tab_positions]
                     if isinstance(c.tab_positions, slice)
                     else codes.index_select(1, c.tab_positions))
        pieces.append(table_norm(tab_codes, c.tables))
    for ci, width, slots in c.onehots:
        # codes past the width clamp to the last slot, as on the host
        code = torch.clamp(codes[:, ci:ci + 1], 0, width - 1)
        pieces.append((code == slots[None, :]).to(torch.float32))
    out = pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=1)
    return out if c.order is None else out.index_select(1, c.order)


class _Staging:
    """One row bucket's staging: the host buffer (pinned on cuda) with
    its numpy view, and, on cuda, the device buffer it is copied into."""

    def __init__(self, bucket: int, cols: int, device: torch.device) -> None:
        cuda = device.type == "cuda"
        self.host = torch.zeros((bucket, cols), dtype=torch.float32,
                                pin_memory=cuda)
        self.view = self.host.numpy()
        self.dev = (torch.empty((bucket, cols), dtype=torch.float32,
                                device=device) if cuda else None)

    @property
    def nbytes(self) -> int:
        return int(self.view.nbytes)


class ModelRegistry:
    """A loaded model set, its fused raw -> score program, its staging
    buffers. `device=None` is the card. `timings` holds the last batch's
    featurize, device and d2h seconds; `transfers` counts the staging
    copies to the device and the result copies back. `labels` (the fleet
    passes {"replica": "<i>"}, and a zoo {"tenant": ...} too) ride its
    `serve.score.rows` counter. `put_hook` and `cost_hook` are the zoo's
    seams (module docstring)."""

    def __init__(self, models_dir: str,
                 scale: float = DEFAULT_SCORE_SCALE,
                 device: DeviceLike = None,
                 drift=None, column_configs=None,
                 model_config=None, labels: Optional[dict] = None,
                 put_hook=None) -> None:
        self.labels = dict(labels or {})
        self._put_hook = put_hook
        self.cost_hook = None
        self._released = False
        self._program_bytes: Dict[int, int] = {}
        self.models_dir = models_dir
        self.paths = find_model_paths(models_dir)
        if not self.paths:
            raise ValueError(f"no models under {models_dir}")
        self.device = pin_device(device)
        self.sha = model_set_sha(self.paths)
        self.scale = float(scale)
        self.model_names = [os.path.basename(p) for p in self.paths]
        self.specs = [load_model(p, column_configs, model_config,
                                 device=self.device) for p in self.paths]
        self.fused = self._fusable()
        # online PSI drift: the fold rides the program (or the runner's
        # host fold); `drift_live` gates it (warm-up rows, staged shadow)
        self.drift = drift if (drift is not None and drift.enabled) else None
        self.drift_live = True
        self._drift_dead_window: Optional[torch.Tensor] = None
        self.weights_bytes = 0
        self.timings: Dict[str, float] = {}
        self.transfers = {"h2d": 0, "d2h": 0}
        self._lock = threading.Lock()
        self._warm_buckets: set = set()
        self._staging: Dict[int, _Staging] = {}
        self._runner: Optional[ModelRunner] = None
        if self.fused:
            self._build_fused()
        else:
            self.weights_bytes = sum(_spec_weight_bytes(s)
                                     for s in self.specs)
            if put_hook is not None:
                # the fallback's runner loads in one piece: the ledger
                # sees its whole cost, just not streamed
                put_hook(self.weights_bytes)
            self._runner = ModelRunner(self.paths, scale=scale,
                                       device=self.device,
                                       column_configs=column_configs,
                                       model_config=model_config)
            self.model_widths: List[int] = []  # known at the first score
        self.input_columns = self._input_columns()
        log.info("registry %s: %d models, %s (%d input columns) on %s",
                 self.sha, len(self.specs),
                 "fused" if self.fused else "ModelRunner fallback",
                 len(self.input_columns), self.device)

    # ---- construction ----
    def _fusable(self) -> bool:
        from shifu_tpu_torch.models.nn import NNModelSpec

        return all(isinstance(s, NNModelSpec) for s in self.specs)

    def _build_fused(self) -> None:
        from shifu_tpu_torch.models.nn import forward
        from shifu_tpu_torch.norm.normalizer import plan_from_json

        dev = self.device
        keys: List[str] = []
        self._plans = []
        self._featurizers: List[_PlanFeaturizer] = []
        plan_idx: List[int] = []
        for spec in self.specs:
            # the ModelRunner's plan signature: bagged models share one
            plan_json = {"normType": spec.norm_type,
                         "cutoff": getattr(spec, "norm_cutoff", 4.0),
                         "columns": spec.norm_specs}
            key = json.dumps(plan_json, sort_keys=True)
            if key not in keys:
                keys.append(key)
                plan = plan_from_json(plan_json)
                self._plans.append(plan)
                self._featurizers.append(_PlanFeaturizer(plan))
            plan_idx.append(keys.index(key))
        hook = self._put_hook

        def put_group(a) -> torch.Tensor:
            """One weight group to the device, the ledger's acquire
            first: residency never runs ahead of the budget."""
            a = np.ascontiguousarray(np.asarray(a, np.float32))
            if hook is not None:
                hook(int(a.nbytes))
            return torch.as_tensor(a, device=dev)

        consts = [_PlanConsts(p, dev, put_hook=hook) for p in self._plans]
        self._consts = consts
        params = [[{"W": put_group(layer["W"]), "b": put_group(layer["b"])}
                   for layer in spec.params] for spec in self.specs]
        self._params = params
        self.weights_bytes = (
            sum(c.nbytes for c in consts)
            + sum(int(t.numel() * 4) for layers in params for layer in layers
                  for t in layer.values()))
        self.model_widths = [spec.out_dim if spec.out_dim > 1 else 1
                             for spec in self.specs]
        # staging layout: each plan's values then its codes, side by side
        off = 0
        self._slices: List[Tuple[Tuple[int, int], Tuple[int, int]]] = []
        for feat in self._featurizers:
            nv, nc = len(feat.value_specs), len(feat.coded_specs)
            self._slices.append(((off, off + nv), (off + nv, off + nv + nc)))
            off += nv + nc
        drift = self.drift
        drift_consts = None
        self._drift_slices = None
        if drift is not None:
            # the monitor is fleet-shared; ITS constants live on THIS
            # replica's device (counted on the host, then moved)
            host_consts = drift.device_consts()
            nbytes = sum(int(t.numel() * t.element_size())
                         for t in host_consts.values())
            if hook is not None:
                hook(nbytes)
            drift_consts = {k: t.to(dev) for k, t in host_consts.items()}
            self.weights_bytes += nbytes
            nv, nc = len(drift.numeric_cols), len(drift.coded_cols)
            self._drift_slices = ((off, off + nv), (off + nv, off + nv + nc),
                                  off + nv + nc)  # last: the valid column
            off += nv + nc + 1
        self._staging_cols = off
        self._drift_consts = drift_consts
        slices = self._slices
        drift_slices = self._drift_slices
        specs = self.specs
        scale = self.scale

        def fused(staging: torch.Tensor,
                  drift_window: Optional[torch.Tensor] = None):
            """[bucket, C] staging -> [bucket, W + 4]: the model scores,
            then mean, max, min and median; with a drift window, also the
            window with this batch's bin counts folded in."""
            normed = []
            for c, ((v0, v1), (c0, c1)) in zip(consts, slices):
                normed.append(_plan_norm(c, staging[:, v0:v1],
                                         staging[:, c0:c1].to(torch.int32)))
            cols = []
            for mi, spec in enumerate(specs):
                out = forward(params[mi], normed[plan_idx[mi]],
                              spec.activations, spec.out_activation)
                if spec.out_dim <= 1:
                    out = out[:, :1]
                cols.append(out * scale)
            m = cols[0] if len(cols) == 1 else torch.cat(cols, dim=1)
            out = torch.cat([m, torch.stack(_aggregates(m), dim=1)], dim=1)
            if drift_window is None:
                return out
            (dv0, dv1), (dc0, dc1), vcol = drift_slices
            return out, drift.fold(drift_consts, drift_window,
                                   staging[:, dv0:dv1],
                                   staging[:, dc0:dc1].to(torch.int64),
                                   staging[:, vcol])

        self._program = fused

    def _input_columns(self) -> List[str]:
        """The raw source columns of every plan, first-seen order: the
        record schema the front end accepts."""
        return schema_of(self.specs)

    # ---- serving ----
    def bucket(self, n_rows: int) -> int:
        return bucket_rows(n_rows, minimum=SERVE_MIN_ROW_BUCKET)

    def warm(self, batch_sizes: Sequence[int]) -> List[int]:
        """Run each row bucket covering `batch_sizes` once (staging
        allocated, cuBLAS handles made) so the first request pays none
        of it; returns the buckets warmed."""
        warmed = []
        # the synthetic all-"0" rows are not traffic: they must not fold
        # into the live drift window
        drift_live, self.drift_live = self.drift_live, False
        try:
            for b in sorted({self.bucket(max(1, int(s)))
                             for s in batch_sizes}):
                rec = {c: "0" for c in self.input_columns}
                self.score_records([rec] * b)
                warmed.append(b)
        finally:
            self.drift_live = drift_live
        return warmed

    def score_records(self, records: Sequence[dict]) -> ScoreResult:
        return self.score_raw(records_to_columnar(records,
                                                  self.input_columns))

    def score_raw(self, data: ColumnarData) -> ScoreResult:
        """Raw batch -> ScoreResult: padded to its row bucket, one copy
        to the device, one back, sliced to the batch's rows. Raises after
        `release()` (an evicted tenant's registry)."""
        if self._released:
            raise ValueError(
                f"registry {self.sha} was released (evicted): re-admit "
                "the tenant before scoring")
        n = data.n_rows
        new_bucket = self.bucket(n) not in self._warm_buckets
        result = self._score_raw(data)
        if new_bucket and self.cost_hook is not None:
            # the new bucket's staging exists now: the owner (the zoo's
            # ledger) re-prices this registry's residency
            try:
                self.cost_hook()
            except Exception as he:  # accounting must not fail scoring
                log.warning("registry cost hook failed: %s", he)
        return result

    def _score_raw(self, data: ColumnarData) -> ScoreResult:
        n = data.n_rows
        if not self.fused:
            t0 = time.perf_counter()
            with self._lock:
                result = self._runner.score_raw(data)
                self.model_widths = list(result.model_widths)
                dt = time.perf_counter() - t0
                if self.drift is not None and self.drift_live:
                    # the runner's path: the host fold, same binning
                    self.drift.fold_host(data)
                # the runner's featurize and scoring, one stage
                reqtrace.note_stage("device", dt, t0=t0)
                self._note(n, self.bucket(n), {
                    "featurize": 0.0, "device": dt, "d2h": 0.0})
            return result
        bucket = self.bucket(n)
        code_cache: dict = {}
        numeric_cache: dict = {}
        with self._lock:
            t_feat = time.perf_counter()
            st = self._staging.get(bucket)
            if st is None:
                st = _Staging(bucket, self._staging_cols, self.device)
                self._staging[bucket] = st
            buf = st.view
            buf[n:] = 0.0  # pad rows may hold an earlier batch
            for feat, ((v0, v1), (c0, c1)) in zip(self._featurizers,
                                                  self._slices):
                vals, codes = feat(data, code_cache, numeric_cache)
                buf[:n, v0:v1] = vals
                buf[:n, c0:c1] = codes
            window = drift_gen = None
            if self.drift is not None:
                d_vals, d_codes = self.drift.featurize(data, code_cache,
                                                       numeric_cache)
                (dv0, dv1), (dc0, dc1), vcol = self._drift_slices
                buf[:n, dv0:dv1] = d_vals
                buf[:n, dc0:dc1] = d_codes
                buf[:n, vcol] = 1.0
                window, drift_gen = self._drift_window()
            args = () if window is None else (window,)
            cuda = self.device.type == "cuda"
            # a bucket's first call counts what the program allocates
            count = (None if bucket in self._program_bytes
                     else _CountAllocs())
            with torch.inference_mode():
                if cuda:
                    with torch.cuda.device(self.device):
                        x = st.dev.copy_(st.host, non_blocking=True)
                        t_dev = time.perf_counter()
                        # the seam synchronizes the card before its clock
                        # stops (sync=True): the device stage's end
                        with count or contextlib.nullcontext():
                            out = profile.dispatch(
                                "serve.fused_score", self._program, x,
                                *args, sync=True)
                        t_d2h = time.perf_counter()
                        if window is not None:
                            out, window = out
                        host = out.cpu()  # synchronizes: staging free again
                else:
                    x = st.host  # a view of `buf`, used only in this call
                    t_dev = time.perf_counter()
                    with count or contextlib.nullcontext():
                        out = profile.dispatch("serve.fused_score",
                                               self._program, x, *args,
                                               sync=True)
                    t_d2h = time.perf_counter()
                    if window is not None:
                        out, window = out
                    host = out
            if count is not None:
                self._program_bytes[bucket] = count.nbytes
            if drift_gen is not None:  # a live fold: adopt its window
                self.drift.note_window(window, n, gen=drift_gen,
                                       device=self.device,
                                       owner=self.labels.get("replica"))
                registry().counter("loop.drift.rows").inc(n)
            res = host.numpy()[:n]
            t_end = time.perf_counter()
            reqtrace.note_stage("featurize", t_dev - t_feat, t0=t_feat)
            reqtrace.note_stage("device", t_d2h - t_dev, t0=t_dev)
            reqtrace.note_stage("d2h", t_end - t_d2h, t0=t_d2h)
            self._note(n, bucket, {"featurize": t_dev - t_feat,
                                   "device": t_d2h - t_dev,
                                   "d2h": t_end - t_d2h})
        w = res.shape[1] - 4
        return ScoreResult(
            model_scores=res[:, :w],
            mean=res[:, w], max=res[:, w + 1], min=res[:, w + 2],
            median=res[:, w + 3],
            model_names=list(self.model_names),
            model_widths=list(self.model_widths),
        )

    def _drift_window(self):
        """(window, generation token) the fold adds into: the monitor's
        resident window of this (replica, device) when live; else one
        throwaway window of this registry's own (token None), so a staged
        shadow never double-counts the batches it re-scores."""
        if self.drift_live:
            return self.drift.window(self.device,
                                     owner=self.labels.get("replica"))
        if self._drift_dead_window is None:
            self._drift_dead_window = torch.zeros(
                self.drift.total_slots, dtype=torch.float32,
                device=self.device)
        return self._drift_dead_window, None

    def _note(self, n: int, bucket: int, timings: Dict[str, float]) -> None:
        # the caller holds the lock
        registry().counter("serve.score.rows", **self.labels).inc(n)
        self._warm_buckets.add(bucket)
        if self.fused:
            self.transfers["h2d"] += 1
            self.transfers["d2h"] += 1
        self.timings = timings

    def program_bytes(self, bucket: int) -> int:
        """Device bytes that one call of the fused function at `bucket`
        rows allocates, counted on the bucket's first call: every tensor
        its torch calls return new, each rounded up to the allocator's
        block, as if none were freed before it returns (a bound of its
        widest point that phase 19 of chip_smoke.py checks on the card). 0 for a bucket not run yet and for the fallback. The
        staging buffer and the resident drift window are not in it:
        `stagingBytes` and the weights hold them."""
        return self._program_bytes.get(int(bucket), 0)

    def memory_analysis(self) -> dict:
        """The zoo ledger's price of this registry's residency:
        `weightsBytes` (every tensor it put on the device), `programs`
        (the analytic `program_bytes` of each warm bucket),
        `stagingBytes` (each warm bucket's staging buffer on the device:
        the device copy on cuda, the buffer itself on the CPU; the
        pinned host buffer is `hostStagingBytes`, not charged) and
        `residentBytes` = weights + the widest program + staging."""
        with self._lock:
            buckets = sorted(self._warm_buckets)
            staging = list(self._staging.values())
        programs = [{"bucket": b, "peakBytes": self.program_bytes(b),
                     "costSource": "analytic"} for b in buckets
                    if self.fused]
        peak = max((p["peakBytes"] for p in programs), default=0)
        dev = sum(_block(st.nbytes) for st in staging)
        host = sum(st.nbytes for st in staging if st.dev is not None)
        return {
            "weightsBytes": int(self.weights_bytes),
            "programs": programs,
            "programPeakBytes": int(peak),
            "stagingBytes": int(dev),
            "hostStagingBytes": int(host),
            "residentBytes": int(self.weights_bytes + peak + dev),
        }

    def release(self) -> int:
        """Eviction seam (the fleet already drained): drop this
        registry's device tensors (weights, constants, staging, the dead
        drift window, its drift windows folded to the host first) so
        they free once an in-flight batch lets go; later scores raise.
        Returns the buckets dropped."""
        if self.drift is not None and self.drift_live:
            self.drift.flush()  # its device windows go to the host fold
        with self._lock:
            dropped = len(self._staging)
            self._released = True
            self._staging = {}
            self._drift_dead_window = None
            if self.fused:
                self._program = None
                self._consts = []
                self._params = []
                self._drift_consts = None
            self._runner = None
            self.specs = []
        return dropped

    def snapshot(self) -> dict:
        """Registry state: the buckets run (the shape bound), transfers,
        the last batch's host split."""
        with self._lock:
            return {
                "sha": self.sha,
                "models": list(self.model_names),
                "fused": self.fused,
                "inputColumns": len(self.input_columns),
                "warmBuckets": sorted(self._warm_buckets),
                "weightsBytes": int(self.weights_bytes),
                "stagingBytes": int(sum(s.nbytes
                                        for s in self._staging.values())),
                "device": str(self.device),
                "transfers": dict(self.transfers),
                "timings": dict(self.timings),
                "driftMonitored": (len(self.drift.cols)
                                   if self.drift is not None else 0),
            }


def _aggregates(m: torch.Tensor) -> List[torch.Tensor]:
    """mean, max, min and median over the model axis. The median of an
    even count is the midpoint of the two middle values (as `np.median`
    and `jnp.median`; `torch.median` takes the lower one), and a row
    holding NaN has a NaN median."""
    w = m.shape[1]
    if w == 1:
        col = m[:, 0]
        return [col, col, col, col]
    s = torch.sort(m, dim=1).values
    mid = w // 2
    med = (s[:, mid] if w % 2
           else (s[:, mid - 1] + s[:, mid]) * 0.5)
    med = torch.where(torch.isnan(m).any(dim=1), s[:, -1], med)
    return [m.mean(dim=1), m.amax(dim=1), m.amin(dim=1), med]


def _buffers(obj) -> list:
    """Every numpy array and tensor reachable under `obj` (lists, tuples,
    dicts, dataclass fields such as a WDL spec's params)."""
    if isinstance(obj, (np.ndarray, torch.Tensor)):
        return [obj]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return _buffers(vars(obj))
    if isinstance(obj, dict):
        return [a for v in obj.values() for a in _buffers(v)]
    if isinstance(obj, (list, tuple)):
        return [a for v in obj for a in _buffers(v)]
    return []

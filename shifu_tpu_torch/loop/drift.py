"""Online PSI drift: per-column live-vs-training bin distributions
(counterpart of `shifu_tpu/loop/drift.py`).

Baseline: the training run's own bin distributions — `binCountPos +
binCountNeg` per ColumnConfig (length = bins + trailing missing slot, the
exact layout `stats` writes). Live side: every served micro-batch is
bin-coded against the same ColumnConfig bins and folded into a per-column
count accumulator; `psi_from_counts` (stats/psi.py) then gives each
column's PSI, so offline PSI and online drift share one definition.

Where the fold runs: inside the registry's one scoring program
(serve/registry.py). The monitor contributes device constants (padded
boundary tables, slot offsets) and the fold (`fold`), which the
registry calls after the forward pass on the same staging tensor —
numeric columns bin on the device from the raw (pre-fill) values with
non-finite values in the missing slot, categorical/hybrid columns ride
the host bin codes the featurizer already computes for the norm gather
(the shared `_bin_codes_for` cache: no extra host parse). The counts land
in an f32 device window that stays resident across batches (no
per-batch device->host sync) and flushes into a host float64 fold every
`WINDOW_FLUSH_ROWS` rows or on demand — counts are exact at any stream
length.

Degrade seam: when any column's PSI crosses `-Dshifu.loop.psiDegrade`
(default 0.2 — the classic "significant shift" PSI convention), the serve
health monitor flips to `degraded` (a routing de-prioritization, not an
ejection: scoring continues) and ONE `recommend-<seq>.json` manifest
lands in the run ledger naming the drifted columns — the machine-readable
retrain recommendation `shifu promote` reads back.

Metrics: loop.drift.rows, loop.drift.flushes, gauges
loop.drift.psi{column=}, loop.drift.max_psi, counter loop.drift.degraded.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from shifu_tpu_torch.analysis.racetrack import tracked_lock
from shifu_tpu_torch.config import ColumnConfig
from shifu_tpu_torch.loop import psi_degrade_setting
from shifu_tpu_torch.stats.psi import psi_from_counts
from shifu_tpu_torch.utils.log import get_logger

log = get_logger(__name__)

# the f32-exactness bound: flush the device window to the f64 host fold
# before any slot count can reach 2^24
WINDOW_FLUSH_ROWS = 1 << 23


class _MonitoredColumn:
    __slots__ = ("name", "kind", "n_slots", "offset", "expected", "cc")

    def __init__(self, name: str, kind: str, n_slots: int, offset: int,
                 expected: np.ndarray, cc: ColumnConfig) -> None:
        self.name = name
        self.kind = kind          # "numeric" | "coded"
        self.n_slots = n_slots
        self.offset = offset
        self.expected = expected  # training bin counts, len == n_slots
        self.cc = cc


def monitorable_columns(column_configs: List[ColumnConfig]
                        ) -> List[ColumnConfig]:
    """Feature columns with both bins and a training distribution."""
    out = []
    for cc in column_configs:
        if cc.is_target() or cc.is_meta() or cc.is_weight():
            continue
        bn = cc.column_binning
        has_bins = (bn.bin_category is not None) or bool(bn.bin_boundary)
        if not has_bins or not bn.bin_count_pos or not bn.bin_count_neg:
            continue
        out.append(cc)
    return out


class DriftMonitor:
    """Per-column live bin-count fold + PSI verdicts for one model set."""

    def __init__(self, column_configs: List[ColumnConfig],
                 threshold: Optional[float] = None,
                 min_rows: Optional[int] = None) -> None:
        from shifu_tpu_torch.loop import drift_min_rows_setting

        self.threshold = (psi_degrade_setting() if threshold is None
                          else float(threshold))
        # PSI over a handful of live rows is sampling noise, not a
        # shift: verdicts report `warming` (and never degrade) until the
        # fold has seen this many rows
        self.min_rows = (drift_min_rows_setting() if min_rows is None
                         else int(min_rows))
        self.cols: List[_MonitoredColumn] = []
        offset = 0
        for cc in monitorable_columns(column_configs):
            bn = cc.column_binning
            numeric = not (cc.is_categorical() or cc.is_hybrid())
            n_slots = (len(bn.bin_boundary) + 1 if numeric
                       else (len(bn.bin_boundary or []) if cc.is_hybrid()
                             else 0) + len(bn.bin_category or []) + 1)
            expected = (np.asarray(bn.bin_count_pos, dtype=np.float64)
                        + np.asarray(bn.bin_count_neg, dtype=np.float64))
            if expected.size != n_slots:
                # stats written under different binning than the config
                # now carries — refuse to compare apples to oranges
                log.warning("drift: column %s bin counts (%d) do not match "
                            "its bins (%d slots); not monitored",
                            cc.column_name, expected.size, n_slots)
                continue
            self.cols.append(_MonitoredColumn(
                cc.column_name, "numeric" if numeric else "coded",
                n_slots, offset, expected, cc))
            offset += n_slots
        self.total_slots = offset
        self.numeric_cols = [c for c in self.cols if c.kind == "numeric"]
        self.coded_cols = [c for c in self.cols if c.kind == "coded"]
        self._lock = tracked_lock("loop.drift")
        self._host = np.zeros(self.total_slots, dtype=np.float64)
        # f32 device windows keyed by (owner, device) — owner is the
        # folding replica's label, so each window has exactly ONE worker
        # thread folding into it even when replicas share a device; the
        # host f64 fold is where the per-key windows merge. _epochs[key]
        # bumps every time a flush swaps that key's window out: a fold
        # whose BASE window was already merged must not be re-adopted
        # (its base would double-count), so note_window drops it — one
        # micro-batch's counts lost at a flush boundary is statistical
        # noise; double-counting the whole window is not.
        self._windows: Dict = {}
        self._epochs: Dict = {}
        self._window_rows = 0
        self._rows = 0
        self._degraded: List[str] = []
        # bumped by reset(): an in-flight flush whose window was swapped
        # out before a promotion reset describes the OLD version's
        # traffic and must not merge into the clean slate
        self._gen = 0

    @property
    def enabled(self) -> bool:
        return self.total_slots > 0

    # ---- featurization (host half) ----
    def featurize(self, data, code_cache: Optional[dict] = None,
                  numeric_cache: Optional[dict] = None
                  ) -> Tuple[np.ndarray, np.ndarray]:
        """(raw numeric values [n, Cn] f32 with NaN=missing, bin codes
        [n, Cc] i32 for coded columns). Both halves share the registry
        featurizer's per-call caches (`_bin_codes_for` codes, the
        `numeric_cache` parse), so a column the norm plan already
        consumed is parsed exactly once per request; columns only the
        monitor watches take ONE flattened parse."""
        from shifu_tpu_torch.norm.normalizer import _bin_codes_for

        n = data.n_rows
        if self.numeric_cols:
            names = [c.name for c in self.numeric_cols]
            if numeric_cache is not None and all(
                    nm in numeric_cache for nm in names):
                vals = np.stack([numeric_cache[nm] for nm in names],
                                axis=1).astype(np.float32)
            else:
                vals = self._numeric_matrix(data)
        else:
            vals = np.zeros((n, 0), dtype=np.float32)
        if self.coded_cols:
            codes = np.stack(
                [_bin_codes_for(c.cc, data, code_cache)
                 for c in self.coded_cols],
                axis=1).astype(np.int32)
        else:
            codes = np.zeros((n, 0), dtype=np.int32)
        return vals, codes

    def _numeric_matrix(self, data) -> np.ndarray:
        """[n, Cn] f32, NaN = missing — the featurizer's exact parse
        (data.reader.flat_numeric_matrix, the ONE implementation both
        sides bin against) over all monitored numeric columns."""
        from shifu_tpu_torch.data.reader import flat_numeric_matrix

        with np.errstate(over="ignore"):  # the overflow to inf is meant
            return flat_numeric_matrix(
                data, [c.name for c in self.numeric_cols]).astype(np.float32)

    # ---- device half (the registry's program calls `fold`) ----
    def device_consts(self, device=None) -> dict:
        """The tensors the fold reads, on `device` (None: the CPU)."""
        dev = torch.device("cpu") if device is None else torch.device(device)

        def put(a):
            return torch.as_tensor(np.ascontiguousarray(a), device=dev)

        consts: dict = {
            "num_offsets": put(np.asarray(
                [c.offset for c in self.numeric_cols], np.int64)),
            "cat_offsets": put(np.asarray(
                [c.offset for c in self.coded_cols], np.int64)),
            "cat_clips": put(np.asarray(
                [c.n_slots - 1 for c in self.coded_cols], np.int64)),
        }
        if self.numeric_cols:
            bmax = max(len(c.cc.column_binning.bin_boundary)
                       for c in self.numeric_cols)
            bounds = np.full((len(self.numeric_cols), bmax), np.inf,
                             dtype=np.float32)
            nbins = np.zeros(len(self.numeric_cols), dtype=np.int64)
            for k, c in enumerate(self.numeric_cols):
                b = np.asarray(c.cc.column_binning.bin_boundary,
                               dtype=np.float32)
                bounds[k, : b.size] = b
                nbins[k] = b.size
            consts["num_bounds"] = put(bounds)
            consts["num_nbins"] = put(nbins)
        return consts

    def fold(self, consts: dict, window: torch.Tensor, vals: torch.Tensor,
             codes: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        """Fold one padded batch into a copy of the window.

        vals  [n, Cn] f32 raw numeric, NaN = missing
        codes [n, Cc] int host bin codes (already include missing slots)
        valid [n]     f32 1.0 for real rows, 0.0 for bucket padding
        Returns window + this batch's per-slot counts. Numeric binning is
        numeric_bin_index's semantics in f32: boundaries[i] <= v <
        boundaries[i+1], non-finite -> the trailing missing slot. Slot
        ids outside the window are dropped, as the JAX fold's
        `.at[].add(mode="drop")` drops them."""
        slot_ids = []
        if self.numeric_cols:
            b = consts["num_bounds"]          # [Cn, Bmax], +inf padded
            nb = consts["num_nbins"][None, :]  # [1, Cn]
            # searchsorted per column via broadcast compare: the +inf
            # padding never counts, so sum(v >= bound) - 1 is the index
            ge = (vals[:, :, None] >= b[None, :, :]).sum(dim=2) - 1
            idx = torch.minimum(torch.clamp_min(ge, 0), nb - 1)
            idx = torch.where(torch.isfinite(vals), idx, nb)
            slot_ids.append(idx + consts["num_offsets"][None, :])
        if self.coded_cols:
            cc = torch.minimum(torch.clamp_min(codes.long(), 0),
                               consts["cat_clips"][None, :])
            slot_ids.append(cc + consts["cat_offsets"][None, :])
        grid = torch.cat(slot_ids, dim=1)                 # [n, Cm]
        ids = grid.reshape(-1)
        w = valid[:, None].expand_as(grid).reshape(-1)
        inside = (ids >= 0) & (ids < self.total_slots)
        w = torch.where(inside, w, torch.zeros_like(w))
        ids = torch.where(inside, ids, torch.zeros_like(ids))
        return window.index_add(0, ids, w)

    # ---- window lifecycle ----
    def window(self, device=None, owner: Optional[str] = None):
        """(resident device window for (owner, device), generation
        token) — created on first use per key. Pass the token back to
        note_window: a fold that straddles a promotion reset() OR a
        concurrent flush (window read -> dispatch -> adopt) would
        otherwise reinstate counts the host fold already absorbed."""
        key = (owner, str(device))
        with self._lock:
            win = self._windows.get(key)
            if win is None:
                win = torch.zeros(self.total_slots, dtype=torch.float32,
                                  device=device)
                self._windows[key] = win
            return win, (self._gen, self._epochs.get(key, 0))

    def note_window(self, new_window, rows: int,
                    gen=None, device=None,
                    owner: Optional[str] = None) -> None:
        """Adopt the post-fold window for (owner, device); flush ALL
        windows to the f64 host fold when the summed row budget is spent
        (ONE device->host copy per window per key). The copy itself
        happens OUTSIDE the lock: a health/metrics probe taking the lock
        must never queue behind a device transfer."""
        key = (owner, str(device))
        with self._lock:
            if gen is not None:
                want = (self._gen, self._epochs.get(key, 0))
                if (gen if isinstance(gen, tuple) else (gen, 0)) != want:
                    # reset() (a promotion — the fold counted the old
                    # version's traffic) or a concurrent flush (the
                    # fold's BASE window is already in the host fold —
                    # adopting base+delta would double-count the base)
                    # landed between window() and here: drop the fold
                    return
            self._windows[key] = new_window
            self._window_rows += rows
            self._rows += rows
            need_flush = self._window_rows > WINDOW_FLUSH_ROWS
        if need_flush:
            self.flush()

    def reset(self) -> None:
        """Clean slate after a promotion acted on the drift: live counts,
        the device window, and the degraded-column memory all clear, so
        drift on the NEW version's traffic re-degrades and re-recommends
        instead of being swallowed by the already-seen set. The baseline
        stays — it is the training ColumnConfig."""
        with self._lock:
            self._host = np.zeros(self.total_slots, dtype=np.float64)
            self._windows = {}
            self._window_rows = 0
            self._rows = 0
            self._degraded = []
            self._gen += 1  # invalidate any flush already past its swap

    def fold_host(self, data, code_cache: Optional[dict] = None) -> None:
        """Host-side fold for registries that do not run the fused
        program (the ModelRunner fallback). Values AND boundaries compare
        in float32 — the exact semantics of the device fold — so a
        column's live counts are identical whichever path a registry
        runs; f64 boundaries would flip rows sitting within one f32 ulp
        of a bin edge."""
        if not self.enabled:
            return
        from shifu_tpu_torch.stats.binning import numeric_bin_index

        vals, codes = self.featurize(data, code_cache)
        counts = np.zeros(self.total_slots, dtype=np.float64)
        for k, c in enumerate(self.numeric_cols):
            idx = numeric_bin_index(
                vals[:, k],
                np.asarray(c.cc.column_binning.bin_boundary, np.float32))
            np.add.at(counts, c.offset + idx, 1.0)
        for k, c in enumerate(self.coded_cols):
            idx = np.clip(codes[:, k], 0, c.n_slots - 1)
            np.add.at(counts, c.offset + idx, 1.0)
        with self._lock:
            self._host += counts
            self._rows += data.n_rows

    def flush(self) -> None:
        """Swap-fetch-merge window flush (also an evicted tenant's
        registry handing its windows back): the device window is swapped
        for a fresh one UNDER the lock, the device->host copy runs
        OUTSIDE it, and the fetched counts merge back under the lock.
        Concurrent flushes each own their swapped-out window, so counts
        are never lost or double-folded."""
        from shifu_tpu_torch.obs import registry

        with self._lock:
            windows, rows = self._windows, self._window_rows
            if not windows or rows == 0:
                return
            # swap the whole window family out; fresh zeros lazily
            # re-create on each key's next window() call. Bumping each
            # key's epoch invalidates any fold in flight against the
            # swapped-out base.
            for key in windows:
                self._epochs[key] = self._epochs.get(key, 0) + 1
            self._windows = {}
            self._window_rows = 0
            gen = self._gen
        counts = np.zeros(self.total_slots, dtype=np.float64)
        for win in windows.values():
            counts += win.cpu().numpy().astype(np.float64)
        with self._lock:
            if self._gen == gen:
                self._host += counts
            # else: reset() (a promotion) landed mid-flush — the swapped
            # windows counted the OLD version's traffic; drop them
        registry().counter("loop.drift.flushes").inc()

    def counts(self) -> np.ndarray:
        """The live fold's per-slot counts (forces a window flush)."""
        self.flush()
        with self._lock:
            return self._host.copy()

    # ---- verdicts ----
    def psi_by_column(self) -> Dict[str, float]:
        """Per-column PSI of the live fold vs the training distribution
        (forces a window flush — one device->host copy; call on a
        cadence, not per batch)."""
        counts = self.counts()
        return {
            c.name: psi_from_counts(
                c.expected, counts[c.offset: c.offset + c.n_slots])
            for c in self.cols
        }

    def verdict(self) -> dict:
        """The drift summary manifests and /healthz embed; also exports
        loop.drift.* gauges."""
        from shifu_tpu_torch.obs import registry

        psis = self.psi_by_column()
        with self._lock:
            rows = self._rows
        warming = rows < self.min_rows
        drifted = ([] if warming else
                   sorted(name for name, p in psis.items()
                          if p > self.threshold))
        reg = registry()
        for name, p in psis.items():
            reg.gauge("loop.drift.psi", column=name).set(p)
        max_psi = max(psis.values()) if psis else 0.0
        reg.gauge("loop.drift.max_psi").set(max_psi)
        reg.counter("loop.drift.rows").inc(0)  # materialize the key
        return {
            "rows": int(rows),
            "threshold": self.threshold,
            "minRows": self.min_rows,
            "maxPsi": max_psi,
            "psi": {k: round(v, 6) for k, v in sorted(psis.items())},
            "driftedColumns": drifted,
            "status": ("warming" if warming
                       else "drift" if drifted else "ok"),
        }

    def check_degrade(self, health=None, ledger_root: Optional[str] = None,
                      model_sha: str = "",
                      reporter: str = "") -> Optional[dict]:
        """Evaluate the degrade gate: on first breach flip /healthz to
        degraded and stamp ONE retrain recommendation into the ledger.
        Returns the verdict (None only when monitoring is disabled), so
        a cadenced caller pays exactly one window flush + PSI pass per
        check."""
        if not self.enabled:
            return None
        v = self.verdict()
        if v["status"] != "drift":
            return v
        from shifu_tpu_torch.obs import registry

        with self._lock:
            new_cols = [c for c in v["driftedColumns"]
                        if c not in self._degraded]
            first = not self._degraded
            self._degraded.extend(new_cols)
        if not new_cols and not first:
            return v
        registry().counter("loop.drift.degraded").inc()
        reason = (f"psi drift > {self.threshold:g} on "
                  f"{','.join(v['driftedColumns'][:5])}")
        if health is not None:
            health.note_degraded(reason)
        if ledger_root and first:
            self._write_recommendation(ledger_root, v, model_sha, reporter)
        return v

    def _write_recommendation(self, root: str, verdict: dict,
                              model_sha: str, reporter: str = "") -> None:
        import sys
        import time

        from shifu_tpu_torch import obs
        from shifu_tpu_torch.obs.ledger import RunLedger

        try:
            ledger = RunLedger(root)
            seq = ledger.next_seq("recommend")
            path = ledger.write(
                "recommend", seq,
                status="ok", exit_status=0,
                started_at=time.time(), elapsed_seconds=0.0,
                argv=list(sys.argv), registry=obs.registry(),
                extra={"recommendation": {
                    "action": "retrain",
                    "reason": "psi-drift",
                    "modelSetSha": model_sha,
                    # which serve process observed the drift (the same id
                    # as its traffic chunks' writer)
                    "reporter": reporter,
                    "drift": verdict,
                }},
            )
            log.warning("drift degrade: retrain recommendation -> %s", path)
        except OSError as e:  # a broken ledger must not break serving
            log.warning("cannot write retrain recommendation: %s", e)

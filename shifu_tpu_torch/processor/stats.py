"""`shifu stats` — compute per-column statistics and binning (counterpart
of `shifu_tpu/processor/stats.py`).

Parity: core/processor/StatsModelProcessor.java:116 (SPDTI executor path) +
optional -correlation / -psi / -rebin flags. In RAM the data is read
once, the bins and codes are built on the host, and the bin aggregation
and the correlation run on the device. A dataset past
`shifu.ingest.memoryBudgetMB` (or `shifu.ingest.forceStreaming`) takes
the streamed route: two chunked passes (`stats/engine.
compute_stats_streaming`, sketch-based bins), a third for -correlation
and -psi, with stream checkpoints and `--resume`. Under a multi-host
plan (`HostPlan`) the streamed passes split the chunks over the hosts,
which merge at the hostsync barriers; only the merge host writes
ColumnConfig.json. The in-RAM route and -correlation / -psi cannot
merge across hosts and raise the JAX package's ValueErrors. Parquet and
remote sources are ROADMAP A.13 and raise.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

from shifu_tpu_torch.data.pipeline import HostPlan
from shifu_tpu_torch.data.reader import read_columnar, read_header
from shifu_tpu_torch.data.stream import should_stream
from shifu_tpu_torch.processor.basic import BasicProcessor
from shifu_tpu_torch.utils.log import get_logger
from shifu_tpu_torch.utils.platform import DeviceLike

log = get_logger(__name__)


class StatsProcessor(BasicProcessor):
    step = "stats"

    def __init__(
        self,
        root: str = ".",
        correlation: bool = False,
        psi: bool = False,
        rebin: bool = False,
        device: DeviceLike = None,
        host_plan: Optional[HostPlan] = None,
    ):
        super().__init__(root, device=device)
        self.correlation = correlation
        self.psi = psi
        self.rebin = rebin
        # an explicit HostPlan (in-process multi-host runs, tests);
        # None reads the lifecycle knobs
        self.host_plan = host_plan
        # seconds of each stage of the last run (parse, the engine's
        # stages, correlation, psi) and the aggregate's device ms
        self.timings: Dict[str, float] = {}

    def _load_data(self):
        ds = self.model_config.data_set
        return read_columnar(
            self.resolve(ds.data_path),
            self._names(),
            delimiter=ds.data_delimiter,
            missing_values=tuple(ds.missing_or_invalid_values),
        )

    def _names(self):
        ds = self.model_config.data_set
        if ds.header_path:
            return read_header(self.resolve(ds.header_path),
                               ds.header_delimiter)
        return [c.column_name for c in self.column_configs]

    def _streaming_columns(self, names):
        """Columns the streamed passes read: the target, the weight and
        every stats candidate (and the PSI unit column); None (all) under
        filter expressions, which may name any column."""
        mc = self.model_config
        if mc.data_set.filter_expressions:
            return None
        needed = {c.column_name for c in self.column_configs
                  if not (c.is_meta() or c.is_weight())}
        needed.add(mc.data_set.target_column_name)
        if mc.data_set.weight_column_name:
            needed.add(mc.data_set.weight_column_name)
        if self.psi and (mc.stats.psi_column_name or "").strip():
            needed.add(mc.stats.psi_column_name.strip())
        return [n for n in names if n in needed]

    def _run_streaming(self, psi_col: str, hp: HostPlan) -> None:
        """The streamed route: stats passes, then one more chunked pass
        for -correlation / -psi, chunk ci on shard ci % S's accumulators,
        merged in shard order (the correlation's shift from the first
        chunk, shared by every shard)."""
        from shifu_tpu_torch.data.pipeline import ShardPlan, prefetch_iter
        from shifu_tpu_torch.data.stream import iter_columnar_chunks
        from shifu_tpu_torch.resilience.checkpoint import resume_requested
        from shifu_tpu_torch.stats.correlation import (StreamingCorrelation,
                                                       save_correlation_csv)
        from shifu_tpu_torch.stats.engine import compute_stats_streaming
        from shifu_tpu_torch.stats.psi import PsiAccumulator

        mc = self.model_config
        ds = mc.data_set
        names = self._names()
        wanted = self._streaming_columns(names)

        def factory():
            return iter_columnar_chunks(
                self.resolve(ds.data_path), names,
                delimiter=ds.data_delimiter,
                missing_values=tuple(ds.missing_or_invalid_values),
                columns=wanted)

        log.info("streaming stats in chunks on %s", self.device)
        compute_stats_streaming(mc, self.column_configs, factory,
                                self.device, checkpoint_root=self.root,
                                resume=resume_requested(),
                                timings=self.timings, host_plan=hp)
        do_psi = self.psi and bool(psi_col)
        if not (self.correlation or do_psi):
            return
        t0 = time.perf_counter()
        plan = ShardPlan(device=self.device)
        S = plan.n_shards
        corr_accs = None
        psi_accs = ([PsiAccumulator(self.column_configs, psi_col)
                     for _ in range(S)] if do_psi else None)
        for ci, chunk in prefetch_iter(enumerate(factory())):
            if self.correlation and corr_accs is None:
                shift = StreamingCorrelation.shift_of(chunk,
                                                      self.column_configs)
                corr_accs = [StreamingCorrelation(self.device, shift=shift)
                             for _ in range(S)]
            s = plan.shard_of(ci)
            if corr_accs is not None:
                corr_accs[s].update(chunk, self.column_configs)
            if psi_accs is not None:
                psi_accs[s].update(chunk)
        if corr_accs is not None:
            for other in corr_accs[1:]:
                corr_accs[0].merge(other)
            corr, cnames = corr_accs[0].finalize()
            save_correlation_csv(self.paths.correlation_path(), corr, cnames)
            log.info("correlation matrix (%d x %d) -> %s", len(cnames),
                     len(cnames), self.paths.correlation_path())
        if psi_accs is not None:
            for other in psi_accs[1:]:
                psi_accs[0].merge(other)
            psi_accs[0].finalize()
            log.info("PSI computed against unit column %s", psi_col)
        self.timings["corr_psi"] = time.perf_counter() - t0

    def run_step(self) -> None:
        self.setup()
        mc = self.model_config
        assert mc is not None
        self.timings = {}

        if self.rebin:
            # -rebin re-derives bins from the EXISTING stats (DIB path,
            # StatsModelProcessor DynamicBinning) — no data re-read
            from shifu_tpu_torch.stats.rebin import rebin_columns
            from shifu_tpu_torch.utils import environment

            target = environment.get_int("shifu.rebin.maxNumBin",
                                         mc.stats.max_num_bin)
            n = rebin_columns(self.column_configs, target)
            self.save_column_configs()
            log.info("rebin done: %d columns re-binned to <= %d bins.",
                     n, target)
            return

        ds = mc.data_set
        hp = self.host_plan if self.host_plan is not None else HostPlan()
        streaming = should_stream(self.resolve(ds.data_path))
        if hp.active and not streaming:
            raise ValueError(
                "-Dshifu.lifecycle.hosts > 1 requires the streaming stats "
                "path (dataset under the memory budget loads in one "
                "process) — drop the hosts knob or lower "
                "shifu.stream.memoryBudgetMb")
        if hp.active and (self.correlation or self.psi):
            raise ValueError(
                "-correlation/-psi are not multi-host capable: the "
                "correlation moments share one shift derived from the "
                "globally first chunk, which no single host owns — run "
                "the extra pass on one process (the stats pass itself "
                "can stay multi-host)")
        psi_col = (mc.stats.psi_column_name or "").strip()
        if self.psi and not psi_col:
            log.warning("-psi requested but stats.psiColumnName is empty; "
                        "skipped")
        if streaming:
            if self.correlation or self.psi:
                self.paths.ensure(self.paths.tmp_dir("stats"))
            self._run_streaming(psi_col, hp)
            if hp.active and not hp.is_merge_host:
                # every host computed the same merged stats; one writes
                log.info("stats computed on host %d/%d; the merge host "
                         "writes ColumnConfig.json", hp.host_index,
                         hp.n_hosts)
                return
            self.save_column_configs()
            return
        t0 = time.perf_counter()
        data = self._load_data()
        self.timings["parse"] = time.perf_counter() - t0

        from shifu_tpu_torch.stats.engine import compute_stats

        compute_stats(mc, self.column_configs, data, self.device,
                      timings=self.timings)

        if self.correlation or self.psi:
            self.paths.ensure(self.paths.tmp_dir("stats"))

        if self.correlation:
            from shifu_tpu_torch.stats.correlation import (
                column_correlation,
                save_correlation_csv,
            )

            t0 = time.perf_counter()
            corr, names = column_correlation(data, self.column_configs,
                                             self.device)
            save_correlation_csv(self.paths.correlation_path(), corr, names)
            self.timings["correlation"] = time.perf_counter() - t0
            log.info(
                "correlation matrix (%d x %d) -> %s",
                len(names), len(names), self.paths.correlation_path(),
            )
        if self.psi and psi_col:
            from shifu_tpu_torch.stats.psi import compute_psi

            t0 = time.perf_counter()
            compute_psi(data, self.column_configs, psi_col)
            self.timings["psi"] = time.perf_counter() - t0
            log.info("PSI computed against unit column %s", psi_col)

        self.save_column_configs()
        n_binned = sum(1 for c in self.column_configs if c.column_binning.length)
        log.info("stats written for %d columns.", n_binned)

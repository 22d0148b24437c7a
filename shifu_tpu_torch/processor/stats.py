"""`shifu stats` — compute per-column statistics and binning (counterpart
of `shifu_tpu/processor/stats.py`).

Parity: core/processor/StatsModelProcessor.java:116 (SPDTI executor path) +
optional -correlation / -psi / -rebin flags. The port runs the in-RAM
route: the data is read once, the bins and codes are built on the host,
and the bin aggregation and the correlation run on the device. A dataset
past `shifu.ingest.memoryBudgetMB` (the streamed route), more than one
host, parquet and remote sources are ROADMAP A.13 and raise.
"""

from __future__ import annotations

import time
from typing import Dict

from shifu_tpu_torch.data.reader import read_columnar, read_header
from shifu_tpu_torch.data.stream import check_single_host, should_stream
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
    ):
        super().__init__(root, device=device)
        self.correlation = correlation
        self.psi = psi
        self.rebin = rebin
        # seconds of each stage of the last run (parse, the engine's
        # stages, correlation, psi) and the aggregate's device ms
        self.timings: Dict[str, float] = {}

    def _load_data(self):
        mc = self.model_config
        assert mc is not None
        ds = mc.data_set
        if ds.header_path:
            names = read_header(self.resolve(ds.header_path), ds.header_delimiter)
        else:
            names = [c.column_name for c in self.column_configs]
        return read_columnar(
            self.resolve(ds.data_path),
            names,
            delimiter=ds.data_delimiter,
            missing_values=tuple(ds.missing_or_invalid_values),
        )

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

        check_single_host()
        ds = mc.data_set
        if should_stream(self.resolve(ds.data_path)):
            raise NotImplementedError(
                "streamed stats (data past -Dshifu.ingest.memoryBudgetMB, "
                "or shifu.ingest.forceStreaming) is not ported yet: "
                "ROADMAP A.13")
        t0 = time.perf_counter()
        data = self._load_data()
        self.timings["parse"] = time.perf_counter() - t0

        from shifu_tpu_torch.stats.engine import compute_stats

        compute_stats(mc, self.column_configs, data, self.device,
                      timings=self.timings)

        if self.correlation or self.psi:
            self.paths.ensure(self.paths.tmp_dir("stats"))
        psi_col = (mc.stats.psi_column_name or "").strip()
        if self.psi and not psi_col:
            log.warning("-psi requested but stats.psiColumnName is empty; skipped")

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

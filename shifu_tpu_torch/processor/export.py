"""`shifu export` — PMML / columnstats / correlation / woemapping.

Parity: core/processor/ExportModelProcessor.java:70 (PMML :158-172,
columnstats / corr / woe-mapping exports).

The port's own copy of `shifu_tpu/processor/export.py`, over the port's
model specs and PMML writer (`shifu_tpu_torch.export.pmml`): the same
files, byte for byte. It touches no device.
"""

from __future__ import annotations

import json
import os

from shifu_tpu_torch.processor.basic import BasicProcessor
from shifu_tpu_torch.utils.errors import ErrorCode, ShifuError
from shifu_tpu_torch.utils.log import get_logger

log = get_logger(__name__)


class ExportProcessor(BasicProcessor):
    step = "export"
    host_only = True

    def __init__(self, root: str = ".", kind: str = "pmml", concise: bool = False):
        super().__init__(root)
        self.kind = (kind or "pmml").lower()
        self.concise = concise

    def run_step(self) -> None:
        self.setup()
        self.paths.ensure(self.paths.export_dir())
        if self.kind == "pmml":
            self._export_pmml()
        elif self.kind in ("onebagging", "onebaggingpmml"):
            self._export_onebagging()
        elif self.kind == "columnstats":
            self._export_columnstats()
        elif self.kind in ("corr", "correlation"):
            self._export_correlation()
        elif self.kind in ("woemapping", "woe"):
            self._export_woemapping()
        else:
            raise ShifuError(ErrorCode.INVALID_MODEL_CONFIG,
                             f"unknown export type {self.kind}")

    def _export_pmml(self) -> None:
        from shifu_tpu_torch.eval.scorer import find_model_paths
        from shifu_tpu_torch.export.pmml import nn_to_pmml, tree_to_pmml
        from shifu_tpu_torch.models.nn import NNModelSpec
        from shifu_tpu_torch.models.tree import TreeModelSpec

        paths = [p for p in find_model_paths(self.paths.models_dir())
                 if p.endswith((".nn", ".lr", ".gbt", ".rf"))]
        if not paths:
            raise ShifuError(
                ErrorCode.MODEL_NOT_FOUND,
                "PMML export supports NN/LR/GBT/RF models; none under models/",
            )
        for i, p in enumerate(paths):
            if p.endswith((".gbt", ".rf")):
                spec = TreeModelSpec.load(p)
                xml = tree_to_pmml(spec,
                                   model_name=self.model_config.basic.name)
            else:
                spec = NNModelSpec.load(p)
                xml = nn_to_pmml(spec,
                                 model_name=self.model_config.basic.name)
            out = self.paths.pmml_path(i)
            with open(out, "w") as fh:
                fh.write(xml)
            log.info("PMML -> %s", out)

    def _export_onebagging(self) -> None:
        """One PMML document averaging every bagged model
        (ExportModelProcessor.java:173 one-bagging PMML)."""
        from shifu_tpu_torch.eval.scorer import find_model_paths
        from shifu_tpu_torch.export.pmml import bagged_to_pmml
        from shifu_tpu_torch.models.nn import NNModelSpec
        from shifu_tpu_torch.models.tree import TreeModelSpec

        paths = [p for p in find_model_paths(self.paths.models_dir())
                 if p.endswith((".nn", ".lr", ".gbt", ".rf"))]
        if not paths:
            raise ShifuError(
                ErrorCode.MODEL_NOT_FOUND,
                "one-bagging PMML needs NN/LR/GBT/RF models under models/",
            )
        # native specs only (reference-format files in models/ would sniff
        # into adapters the PMML writer cannot embed)
        specs = [
            TreeModelSpec.load(p) if p.endswith((".gbt", ".rf"))
            else NNModelSpec.load(p)
            for p in paths
        ]
        xml = bagged_to_pmml(specs, model_name=self.model_config.basic.name)
        out = os.path.join(self.paths.export_dir(), "model_onebagging.pmml")
        with open(out, "w") as fh:
            fh.write(xml)
        log.info("one-bagging PMML (%d models) -> %s", len(paths), out)

    def _export_columnstats(self) -> None:
        out = os.path.join(self.paths.export_dir(), "columnstats.csv")
        cols = [
            "columnNum", "columnName", "columnType", "finalSelect", "ks", "iv",
            "mean", "stdDev", "min", "max", "median", "missingPct",
            "distinctCount", "psi",
        ]
        with open(out, "w") as fh:
            fh.write(",".join(cols) + "\n")
            for c in self.column_configs:
                st = c.column_stats
                row = [
                    c.column_num, c.column_name,
                    c.column_type.value if c.column_type else "",
                    c.final_select, st.ks, st.iv, st.mean, st.std_dev,
                    st.min, st.max, st.median, st.missing_percentage,
                    st.distinct_count, st.psi,
                ]
                fh.write(",".join("" if v is None else str(v) for v in row) + "\n")
        log.info("column stats -> %s", out)

    def _export_correlation(self) -> None:
        src = self.paths.correlation_path()
        if not os.path.isfile(src):
            raise ShifuError(ErrorCode.DATA_NOT_FOUND,
                             "run `shifu stats -correlation` first")
        import shutil

        out = os.path.join(self.paths.export_dir(), "correlation.csv")
        shutil.copy(src, out)
        log.info("correlation -> %s", out)

    def _export_woemapping(self) -> None:
        out = os.path.join(self.paths.export_dir(), "woemapping.json")
        mapping = {}
        for c in self.column_configs:
            bn = c.column_binning
            if not bn.bin_count_woe:
                continue
            entry = {"woe": bn.bin_count_woe,
                     "weightedWoe": bn.bin_weighted_woe}
            if c.is_categorical():
                entry["categories"] = bn.bin_category
            else:
                entry["boundaries"] = [
                    str(b) if b in (float("-inf"), float("inf")) else b
                    for b in (bn.bin_boundary or [])
                ]
            mapping[c.column_name] = entry
        with open(out, "w") as fh:
            json.dump(mapping, fh, indent=2)
        log.info("woe mapping (%d columns) -> %s", len(mapping), out)

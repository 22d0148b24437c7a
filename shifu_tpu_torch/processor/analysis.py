"""`shifu analysis` — textual model/data analysis report.

Parity: the `analysis` CLI command (ShifuCLI command table): dataset summary,
top variables by KS/IV, model inventory with errors, eval results.

The port's own copy of `shifu_tpu/processor/analysis.py`: the same
report text. It touches no device.
"""

from __future__ import annotations

import json
import os

from shifu_tpu_torch.processor.basic import BasicProcessor
from shifu_tpu_torch.utils.log import get_logger

log = get_logger(__name__)


class AnalysisProcessor(BasicProcessor):
    step = "analysis"
    host_only = True

    def run_step(self) -> None:
        self.setup()
        mc = self.model_config
        lines = []
        lines.append(f"Model set: {mc.basic.name} (algorithm {mc.train.algorithm.value})")
        lines.append(f"Data: {mc.data_set.data_path} target={mc.data_set.target_column_name} "
                     f"posTags={mc.data_set.pos_tags} negTags={mc.data_set.neg_tags}")

        stats_cols = [c for c in self.column_configs if c.column_stats.ks is not None]
        lines.append(f"Columns: {len(self.column_configs)} total, "
                     f"{len(stats_cols)} with stats, "
                     f"{sum(1 for c in self.column_configs if c.final_select)} selected, "
                     f"{sum(1 for c in self.column_configs if c.is_categorical())} categorical")
        top = sorted(stats_cols, key=lambda c: -(c.column_stats.ks or 0))[:10]
        if top:
            lines.append("Top variables by KS:")
            for c in top:
                lines.append(f"  {c.column_name:30s} ks={c.column_stats.ks:8.3f} "
                             f"iv={c.column_stats.iv or 0:8.4f} "
                             f"missing={100 * (c.column_stats.missing_percentage or 0):.1f}%")

        from shifu_tpu_torch.eval.scorer import find_model_paths

        models = find_model_paths(self.paths.models_dir())
        if models:
            lines.append("Models:")
            for p in models:
                lines.append(f"  {os.path.basename(p)} ({os.path.getsize(p)} bytes)")
        for ec in mc.evals:
            perf_path = self.paths.eval_performance_path(ec.name)
            if os.path.isfile(perf_path):
                with open(perf_path) as fh:
                    perf = json.load(fh)
                lines.append(f"Eval {ec.name}: AUC={perf.get('areaUnderRoc', 0):.6f} "
                             f"(weighted {perf.get('weightedAreaUnderRoc', 0):.6f})")

        report = "\n".join(lines)
        print(report)
        out = os.path.join(self.paths.ensure(self.paths.tmp_dir("analysis")),
                           "report.txt")
        with open(out, "w") as fh:
            fh.write(report + "\n")
        log.info("analysis report -> %s", out)

"""BasicProcessor: shared step setup/teardown (counterpart of
`shifu_tpu/processor/basic.py`).

Contract parity with core/processor/BasicModelProcessor.java:57 — load both
configs from the working directory, validate via the inspector for the current
step, expose save helpers, and resolve data paths relative to the model-set
root. Every processor of the port runs on one device: `device=None` means
the card, and the constructor raises without one. A step that only reads
and writes files (`host_only`: new, export, save/switch/show, test,
analysis) takes no device.

`run` keeps the JAX package's return code and its start/finish log lines,
re-arms the fault plan (`-Dshifu.faults`, `resilience/faults.py`), turns
SIGTERM into `PreemptionError` for the step (restoring the previous
handler after it), and arms the sanitizer's divergence mode
(`-Dshifu.sanitize=divergence`, `analysis/sanitize.py`). It leaves out
the rest of the observability envelope (the run-ledger manifest, the
profiler capture): that is ROADMAP A.14.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional

from shifu_tpu_torch.config import (
    ColumnConfig,
    ModelConfig,
    load_column_config_list,
    save_column_config_list,
)
from shifu_tpu_torch.config.inspector import probe
from shifu_tpu_torch.fs.pathfinder import PathFinder
from shifu_tpu_torch.utils.errors import ErrorCode, ShifuError
from shifu_tpu_torch.utils.log import get_logger
from shifu_tpu_torch.utils.platform import DeviceLike, resolve_device

log = get_logger(__name__)


class BasicProcessor:
    step: str = ""
    host_only: bool = False  # the step touches no device

    def __init__(self, root: str = ".", device: DeviceLike = None):
        self.root = os.path.abspath(root)
        self.device = None if self.host_only else resolve_device(device)
        self.paths = PathFinder(self.root)
        self.model_config: Optional[ModelConfig] = None
        self.column_configs: List[ColumnConfig] = []

    # ---- lifecycle ----
    def setup(self, need_columns: bool = True) -> None:
        mc_path = self.paths.model_config_path()
        if not os.path.isfile(mc_path):
            raise ShifuError(ErrorCode.MODEL_CONFIG_NOT_FOUND, mc_path)
        self.model_config = ModelConfig.load(mc_path)
        result = probe(self.model_config, self.step, base_dir=self.root)
        if not result.status:
            raise ShifuError(
                ErrorCode.INVALID_MODEL_CONFIG, "; ".join(result.causes)
            )
        if need_columns:
            cc_path = self.paths.column_config_path()
            if not os.path.isfile(cc_path):
                raise ShifuError(ErrorCode.COLUMN_CONFIG_NOT_FOUND, cc_path)
            self.column_configs = load_column_config_list(cc_path)

    def save_column_configs(self) -> None:
        save_column_config_list(self.paths.column_config_path(), self.column_configs)

    def save_model_config(self) -> None:
        assert self.model_config is not None
        self.model_config.save(self.paths.model_config_path())

    def resolve(self, path: str) -> str:
        """Paths in configs are relative to the model-set root; scheme-ful
        URIs (hdfs://, s3://, memory://...) pass through untouched."""
        if "://" in path or os.path.isabs(path):
            return path
        return os.path.normpath(os.path.join(self.root, path))

    def run(self) -> int:
        """Run the step; 0 on success, exceptions propagate (a SIGTERM as
        PreemptionError, so the stream checkpoints stay resumable)."""
        from shifu_tpu_torch.analysis import sanitize
        from shifu_tpu_torch.resilience import faults

        # a bad -Dshifu.sanitize raises before the step starts
        san = sanitize.from_environment()
        faults.reset()  # fresh fault-plan event counters a step
        restore_sigterm = faults.install_preemption_handler()
        t0 = time.time()
        log.info("Step %s starts.", self.step)
        try:
            with sanitize.activate(san):
                self.run_step()
        finally:
            if restore_sigterm is not None:
                restore_sigterm()
            log.info("Step %s finished in %.3f s.", self.step,
                     time.time() - t0)
        return 0

    def run_step(self) -> None:  # pragma: no cover - abstract
        raise NotImplementedError

    # ---- helpers shared by steps ----
    def target_column(self) -> str:
        assert self.model_config is not None
        return self.model_config.data_set.target_column_name

    def selected_columns(self) -> List[ColumnConfig]:
        return [c for c in self.column_configs if c.final_select]

    def candidate_columns(self) -> List[ColumnConfig]:
        """Columns eligible as features (not target/meta/weight/force-remove)."""
        return [c for c in self.column_configs if c.is_feature()]

"""BasicProcessor: shared step setup/teardown (counterpart of
`shifu_tpu/processor/basic.py`).

Contract parity with core/processor/BasicModelProcessor.java:57 — load both
configs from the working directory, validate via the inspector for the current
step, expose save helpers, and resolve data paths relative to the model-set
root. Every processor of the port runs on one device: `device=None` means
the card, and the constructor raises without one. A step that only reads
and writes files (`host_only`: new, export, save/switch/show, test,
analysis) takes no device.

`run` is the JAX package's observability envelope: a fresh obs scope
(outermost run only), the `step.<name>` span, the run manifest under
`<root>/.shifu/runs/<step>-<seq>.json` on success and on failure
(obs/ledger.py), `-Dshifu.profile=xla|<dir>` as a torch profiler trace,
the fault plan (`-Dshifu.faults`), SIGTERM as `PreemptionError` for the
step, and the sanitizer (`-Dshifu.sanitize=divergence,race`).
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
        # run_step() may stash step-specific manifest sections here; run()
        # merges them into the run-ledger manifest, success or failure
        self.manifest_extra: dict = {}

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

    # ---- run wrapper: ledger manifest, metrics/tracing scope, profiling ----
    def run(self) -> int:
        """Run the step inside the observability envelope: a fresh
        metrics/tracing/profiler scope (outermost run only), a root span,
        optional deep capture (-Dshifu.profile=xla traces the step with
        torch.profiler into the ledger dir and links the Chrome trace
        from the manifest as `perfettoTrace`; -Dshifu.profile=<dir>
        writes it under <dir>/<step>), and — success OR failure — a
        sequence-numbered run manifest under
        <root>/.shifu/runs/<step>-<seq>.json carrying the registry
        snapshot, the per-seam `profile` section (obs/profile.py), the
        trace path, config hashes, exit status and the sanitizer verdict
        (obs/ledger.py). Exceptions re-raise after the manifest lands; a
        SIGTERM raises PreemptionError, so the stream checkpoints stay
        resumable."""
        import sys

        from shifu_tpu_torch import obs
        from shifu_tpu_torch.analysis import sanitize
        from shifu_tpu_torch.obs.ledger import RunLedger
        from shifu_tpu_torch.resilience import faults

        # parse the sanitizer config BEFORE begin_run: a bad
        # -Dshifu.sanitize value raises here, while the obs run depth is
        # still balanced
        san = sanitize.from_environment()
        faults.reset()  # fresh fault-plan event counters a step
        restore_sigterm = faults.install_preemption_handler()
        obs.begin_run()
        t0 = time.time()
        status, error = "ok", None
        profile_dir = None
        try:  # everything after begin_run pairs with end_run in finally
            ledger = RunLedger(self.root)
            seq = ledger.next_seq(self.step)
            log.info("Step %s starts.", self.step)
            profile_dir = self._profile_dir(ledger, seq)
            try:
                with obs.span(f"step.{self.step}", seq=seq), \
                        sanitize.activate(san):
                    if profile_dir:
                        self._run_profiled(profile_dir)
                    else:
                        self.run_step()
            except BaseException as e:
                status, error = "failed", f"{type(e).__name__}: {e}"
                raise
            finally:
                elapsed = time.time() - t0
                reg = obs.registry()
                reg.gauge("step.columns_configured").set(
                    len(self.column_configs))
                reg.timer("step.elapsed", step=self.step).add(elapsed)
                extra = {}
                if profile_dir:
                    extra["profileDir"] = profile_dir
                    trace_file = self._find_xla_trace(profile_dir)
                    if trace_file:
                        extra["perfettoTrace"] = trace_file
                if san.active:
                    extra["sanitizer"] = san.verdict()
                if self.manifest_extra:
                    extra.update(self.manifest_extra)
                try:
                    profile_snap = obs.profiler().snapshot()
                except Exception as pe:  # pragma: no cover - defensive
                    log.warning("cannot snapshot profiler: %s", pe)
                    profile_snap = None
                try:
                    path = ledger.write(
                        self.step, seq,
                        status=status,
                        exit_status=0 if status == "ok" else 1,
                        started_at=t0,
                        elapsed_seconds=elapsed,
                        argv=list(sys.argv),
                        registry=reg,
                        tracer=obs.tracer(),
                        profile=profile_snap,
                        error=error,
                        extra=extra or None,
                    )
                    log.info("run manifest -> %s", path)
                except Exception as we:  # a broken ledger must not mask
                    log.warning("cannot write run manifest: %s", we)
                log.info("Step %s finished in %.3f s.", self.step, elapsed)
        finally:
            obs.end_run()
            if restore_sigterm is not None:
                restore_sigterm()
        return 0

    def _run_profiled(self, profile_dir: str) -> None:
        """The step under torch.profiler (CPU activity, and CUDA activity
        when the step runs on a card), exported as a Chrome trace into
        `profile_dir`: the counterpart of the JAX `jax.profiler.trace`
        capture, loadable in Perfetto."""
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device is not None and self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(profile_dir, exist_ok=True)
        with profile(activities=activities) as prof:
            self.run_step()
        path = os.path.join(profile_dir, f"{self.step}.pt.trace.json")
        prof.export_chrome_trace(path)
        log.info("profiler trace -> %s", path)

    def _profile_dir(self, ledger=None, seq=None):
        from shifu_tpu_torch.utils import environment

        d = environment.get_property("shifu.profile", "")
        if not d:
            return None
        if d.strip().lower() == "xla" and ledger is not None:
            # -Dshifu.profile=xla: deep capture lands beside the run's
            # manifest, so `shifu profile` output and the trace share one
            # ledger entry
            return os.path.join(ledger.dir, f"{self.step}-{seq}-xla")
        return os.path.join(self.resolve(d), self.step)

    @staticmethod
    def _find_xla_trace(profile_dir: str):
        """Newest Chrome trace file the profiler wrote under
        `profile_dir`, if any."""
        import glob

        hits = sorted(
            glob.glob(os.path.join(profile_dir, "**", "*.trace.json.gz"),
                      recursive=True)
            + glob.glob(os.path.join(profile_dir, "**", "*.trace.json"),
                        recursive=True),
            key=os.path.getmtime,
        )
        return hits[-1] if hits else None

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

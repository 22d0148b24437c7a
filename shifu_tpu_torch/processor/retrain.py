"""`shifu retrain` — warm-start incremental training that closes the loop
(counterpart of `shifu_tpu/processor/retrain.py`).

The reference Shifu retrains by re-running the whole one-shot pipeline;
this step turns serving traffic (or any new data drop) into an
INCREMENTAL run:

  1. **Source** — the serve-side traffic log (`loop/traffic.py`, rotating
     `|`-delimited chunk files under `.shifu/runs/traffic/`) or an
     explicit `--data` path. The log is read back through the ordinary
     chunk readers, so the retrain norm pass rides the same streaming
     and checkpoint machinery as any training file.
  2. **Norm** — a norm pass over the new data into `tmp/retrain/`
     (NormalizedData + CleanedData), leaving the original training
     artifacts untouched. Resumable mid-stream (`retrain-norm-stream`
     checkpoint family; `shifu retrain --resume`).
  3. **Warm-start train** — NN/LR/WDL members initialize from the
     previous model's weights (the `isContinuous` seam); GBT appends
     `-Dshifu.loop.appendTrees` trees on the new chunks only (TreeNum is
     lifted to parent trees + append, so only the new trees train, and
     the parent's trees are kept bit for bit); RF has no warm start and
     trains fresh on the new data. The result lands in a CANDIDATE dir
     (`models.candidate/` by default) — live `models/` is only replaced
     by `shifu promote`'s gated swap. `--coresident` runs the NN/LR/WDL
     train as a background tenant of the serving ledger
     (`coresident/`), through `--serve-url` a running server's.
  4. **Provenance** — the retrain manifest records the full chain:
     parent model-set sha (+ per-model file shas), the data source and
     the exact traffic chunk files consumed, sectioned config shas
     (data / train / loop), and the candidate model-set sha. An
     incremental run is auditable from `.shifu/runs/` alone.

Chaos parity: the streamed trainer's epoch checkpoint carries a `loop`
identity section naming the warm-start parent, so `--resume` after a
mid-stream kill is bit-identical to an uninterrupted retrain — and a
checkpoint from a retrain against a DIFFERENT parent is rejected with
the diverged section named.
"""

from __future__ import annotations

import copy
import hashlib
import os
from typing import List, Optional

from shifu_tpu_torch.utils.platform import DeviceLike

from shifu_tpu_torch.config.model_config import Algorithm
from shifu_tpu_torch.fs.listing import sorted_glob
from shifu_tpu_torch.fs.pathfinder import PathFinder
from shifu_tpu_torch.processor.basic import BasicProcessor
from shifu_tpu_torch.processor.norm import NormProcessor
from shifu_tpu_torch.processor.train import TrainProcessor
from shifu_tpu_torch.utils.errors import ErrorCode, ShifuError
from shifu_tpu_torch.utils.log import get_logger

log = get_logger(__name__)

DEFAULT_CANDIDATE_DIR = "models.candidate"


def _file_sha(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        h.update(fh.read())
    return h.hexdigest()[:16]


class _RetrainPaths(PathFinder):
    """The retrain artifact layout: per-step tmp state under
    `tmp/retrain/` (so the original NormalizedData/CleanedData and train
    checkpoints survive untouched) and models written to the candidate
    dir instead of the live `models/`."""

    def __init__(self, root: str, models_dir: str) -> None:
        super().__init__(root)
        self._models = os.path.abspath(models_dir)

    def tmp_dir(self, step: Optional[str] = None) -> str:
        base = os.path.join(self.root, "tmp", "retrain")
        return os.path.join(base, step) if step else base

    def models_dir(self) -> str:
        return self._models


class _SubStep:
    """Mixin for the norm/train sub-steps: they run INSIDE the retrain
    observability envelope (run_step, not run — one manifest for the
    whole incremental run) with the retrain's prepared in-memory configs
    instead of re-loading from disk."""

    def _inject(self, paths: PathFinder, mc, ccs) -> None:
        self.paths = paths
        self._mc = mc
        self._ccs = ccs

    def setup(self, need_columns: bool = True) -> None:  # noqa: ARG002
        self.model_config = self._mc
        self.column_configs = self._ccs


class _RetrainNorm(_SubStep, NormProcessor):
    step = "retrain-norm"


class _RetrainTrain(_SubStep, TrainProcessor):
    step = "retrain-train"


class RetrainProcessor(BasicProcessor):
    step = "retrain"

    def __init__(self, root: str = ".", from_traffic: bool = False,
                 data_path: Optional[str] = None,
                 candidate_dir: Optional[str] = None,
                 append_trees: Optional[int] = None,
                 traffic_stream: str = "",
                 coresident: bool = False,
                 serve_url: Optional[str] = None,
                 device: DeviceLike = None) -> None:
        super().__init__(root, device=device)
        if from_traffic and data_path is not None:
            raise ShifuError(
                ErrorCode.ILLEGAL_ARGUMENT,
                "--from-traffic and --data are mutually exclusive — the "
                "run can stream ONE source; drop --from-traffic to "
                "retrain on the explicit path")
        self.from_traffic = from_traffic
        # model-zoo tenants log to per-set streams under
        # traffic/<set>/ (loop/traffic.py `stream`); --traffic-stream
        # selects one so per-tenant retrain never mixes another set's
        # rows
        self.traffic_stream = traffic_stream or ""
        if self.traffic_stream and data_path is not None:
            raise ShifuError(
                ErrorCode.ILLEGAL_ARGUMENT,
                "--traffic-stream retrains from the traffic log — it "
                "cannot combine with --data")
        self.data_path = data_path
        self.candidate_dir = os.path.abspath(
            candidate_dir
            if candidate_dir else os.path.join(self.root,
                                               DEFAULT_CANDIDATE_DIR))
        self.append_trees = append_trees
        # --coresident: run the warm-start NN/WDL train as a background
        # HBM-ledger tenant of the serving fleet (coresident/trainer.py)
        self.coresident = bool(coresident)
        self.serve_url = serve_url
        if serve_url and not coresident:
            raise ShifuError(
                ErrorCode.ILLEGAL_ARGUMENT,
                "--serve-url applies to --coresident retraining only "
                "(promotion has its own --serve-url on `shifu promote`)")

    # ---- source resolution ----
    def _resolve_source(self, mc):
        """(kind, names_override, traffic_chunks) — and mutates the
        in-memory ModelConfig copy's data_set to point at the stream.
        The traffic source is the FLEET UNION by default: every serve
        process's writer-scoped chunks under one ledger dir
        (shifu.loop.trafficScope narrows to one writer); the writers
        consumed land in the lineage manifest."""
        from shifu_tpu_torch.loop.traffic import (
            META_FILE,
            chunk_writer,
            log_meta,
            traffic_dir,
            traffic_scope_setting,
        )

        ds = mc.data_set
        stream = self.traffic_stream
        meta_path = os.path.join(traffic_dir(self.root, stream),
                                 META_FILE)
        use_traffic = self.from_traffic or bool(stream) or (
            self.data_path is None and os.path.isfile(meta_path))
        if self.data_path is not None:
            ds.data_path = self.data_path
            return "data", None, None
        if not use_traffic:
            # no traffic log, no --data: retrain on whatever the config
            # points at (a new data drop in place)
            return "data", None, None
        try:
            meta, chunks = log_meta(self.root, stream)
        except FileNotFoundError as e:
            raise ShifuError(ErrorCode.DATA_NOT_FOUND, str(e))
        names = list(meta["columns"])
        target = ds.target_column_name
        if target not in names:
            raise ShifuError(
                ErrorCode.DATA_NOT_FOUND,
                f"traffic log carries no `{target}` column — retraining "
                f"needs label-joined traffic (serve from the model-set "
                f"root so the log keeps the target column)")
        scope = traffic_scope_setting()
        pattern = ("traffic-*.psv" if scope == "fleet"
                   else f"traffic-{scope}-*.psv")
        ds.data_path = os.path.join(traffic_dir(self.root, stream),
                                    pattern)
        ds.data_delimiter = meta.get("delimiter", "|")
        ds.header_path = None
        # the distinct serve processes whose chunks this run consumes —
        # provenance that the union really spanned the fleet
        self._traffic_writers = sorted(
            {chunk_writer(p) or "" for p in chunks})
        return "traffic", names, [os.path.basename(p) for p in chunks]

    # ---- warm-start seeding ----
    def _seed_candidate(self, parent_paths: List[str]) -> None:
        """Copy the parent model set into the candidate dir so the
        trainers' `isContinuous` seam warm-starts from it in place.
        Idempotent: a `--resume` re-copy writes the same bytes, and a
        mid-train kill never touched the copies (specs save at the
        end)."""
        import shutil

        os.makedirs(self.candidate_dir, exist_ok=True)
        for p in parent_paths:
            shutil.copy2(p, os.path.join(self.candidate_dir,
                                         os.path.basename(p)))
        # stale candidates from a previous retrain with MORE members must
        # not survive as phantom ensemble members
        keep = {os.path.basename(p) for p in parent_paths}
        for p in sorted_glob(os.path.join(self.candidate_dir, "model*")):
            if os.path.basename(p) not in keep:
                os.unlink(p)

    def run_step(self) -> None:
        from shifu_tpu_torch.eval.scorer import find_model_paths
        from shifu_tpu_torch.loop import append_trees_setting
        from shifu_tpu_torch.resilience.checkpoint import sectioned_sha
        from shifu_tpu_torch.serve.registry import model_set_sha

        self.setup()
        mc = self.model_config
        assert mc is not None
        alg = mc.train.algorithm

        if self.coresident and alg not in (Algorithm.NN, Algorithm.LR,
                                           Algorithm.WDL):
            raise ShifuError(
                ErrorCode.ILLEGAL_ARGUMENT,
                f"--coresident applies to the streamed NN/LR/WDL "
                f"retrainers; {alg.value} retrains in one pass without "
                f"a resident epoch loop to co-schedule")

        parent_dir = self.paths.models_dir()
        parent_paths = find_model_paths(parent_dir)
        if not parent_paths:
            raise ShifuError(
                ErrorCode.DATA_NOT_FOUND,
                f"no models under {parent_dir} — run `shifu train` "
                f"before `shifu retrain`")
        parent_sha = model_set_sha(parent_paths)
        parent_files = {os.path.basename(p): _file_sha(p)
                        for p in parent_paths}

        # the sub-steps run on a COPY: source/continuous/TreeNum
        # overrides are retrain-scoped, never saved back to disk
        sub_mc = copy.deepcopy(mc)
        kind, names_override, traffic_chunks = self._resolve_source(sub_mc)
        sub_mc.train.is_continuous = True

        append = (append_trees_setting() if self.append_trees is None
                  else int(self.append_trees))
        parent_trees = None
        if alg in (Algorithm.GBT, Algorithm.RF, Algorithm.DT):
            from shifu_tpu_torch.models.tree import TreeModelSpec

            try:
                parent_trees = len(TreeModelSpec.load(parent_paths[0]).trees)
            except Exception as e:
                raise ShifuError(
                    ErrorCode.DATA_NOT_FOUND,
                    f"cannot read parent tree model {parent_paths[0]}: {e}")
            if alg == Algorithm.GBT:
                # append-only growth: the continuous path keeps the
                # parent's trees and trains ONLY the lifted remainder on
                # the new chunks
                params = dict(sub_mc.train.params or {})
                params["TreeNum"] = parent_trees + append
                sub_mc.train.params = params

        rpaths = _RetrainPaths(self.root, self.candidate_dir)
        log.info("retrain source=%s -> norm into %s, candidate %s "
                 "(parent %s: %d model(s)%s)",
                 kind, rpaths.tmp_dir(), self.candidate_dir, parent_sha,
                 len(parent_paths),
                 f", +{append} trees" if alg == Algorithm.GBT else "")

        # ---- phase 1: norm the new stream into tmp/retrain ----
        rn = _RetrainNorm(self.root, device=self.device,
                          names_override=names_override)
        rn._inject(rpaths, sub_mc, self.column_configs)
        rn.run_step()
        from shifu_tpu_torch.norm.dataset import read_meta

        norm_meta = read_meta(rpaths.normalized_data_dir())
        if not norm_meta.n_rows:
            raise ShifuError(
                ErrorCode.DATA_NOT_FOUND,
                "retrain source produced 0 labeled rows after "
                "purify/tag filtering — nothing to train on (unlabeled "
                "traffic logs cannot retrain; join labels first)")

        # ---- phase 2: warm-start train into the candidate dir ----
        self._seed_candidate(parent_paths)
        rt = _RetrainTrain(self.root, device=self.device)
        rt._inject(rpaths, sub_mc, self.column_configs)
        # the streamed trainer's checkpoint identity gains a `loop`
        # section: a snapshot from a retrain against a different parent
        # set must reject, naming the section
        rt.train_ident_extra = {"parentModelSetSha": parent_sha}
        ccfg = None
        if self.coresident:
            from shifu_tpu_torch.coresident import CoresidentConfig

            # family_dir = repo root: the per-stage checkpoint family
            # lands under .shifu/runs/ckpt beside every other resumable
            # stream so `shifu runs --resumable` lists it
            ccfg = CoresidentConfig(
                serve_url=self.serve_url, family_dir=self.root,
                meta={"step": "retrain",
                      "parentModelSetSha": parent_sha}).resolve()
            rt.coresident_cfg = ccfg
            log.info("retrain --coresident: tenant %r as a background "
                     "HBM-ledger tenant (%s)", ccfg.tenant,
                     self.serve_url or "local grant")
        rt.run_step()

        candidate_paths = find_model_paths(self.candidate_dir)
        candidate_sha = model_set_sha(candidate_paths)

        # ---- provenance: the auditable chain in the retrain manifest ----
        _sha, sections = sectioned_sha({
            "data": {"kind": kind,
                     "dataPath": sub_mc.data_set.data_path,
                     "chunks": traffic_chunks},
            "train": {"algorithm": alg.value,
                      "params": sub_mc.train.params or {},
                      "baggingNum": sub_mc.train.bagging_num},
            "loop": {"parentModelSetSha": parent_sha,
                     "appendTrees": (append if alg == Algorithm.GBT
                                     else None)},
        })
        # serve -> train lineage: the request-trace ids stamped into the
        # traffic log tie this candidate back to the exact serving
        # evidence (`shifu trace --show <id>` on the serve ledger)
        lineage = None
        if kind == "traffic":
            from shifu_tpu_torch.loop.traffic import trace_lineage

            try:
                lineage = trace_lineage(self.root,
                                        stream=self.traffic_stream)
            except (OSError, ValueError) as e:
                log.warning("retrain: cannot read trace lineage: %s", e)
        self.manifest_extra["retrain"] = {
            "source": {"kind": kind,
                       "dataPath": sub_mc.data_set.data_path,
                       "trafficChunks": traffic_chunks,
                       "trafficWriters": getattr(
                           self, "_traffic_writers", None),
                       "rows": int(norm_meta.n_rows)},
            "lineage": lineage,
            "parent": {"modelSetSha": parent_sha,
                       "modelsDir": parent_dir,
                       "models": parent_files,
                       "trees": parent_trees},
            "candidate": {"modelSetSha": candidate_sha,
                          "dir": self.candidate_dir,
                          "models": {os.path.basename(p): _file_sha(p)
                                     for p in candidate_paths}},
            "configShas": sections,
            "warmStart": {
                "algorithm": alg.value,
                "appendedTrees": (append if alg == Algorithm.GBT
                                  else None),
            },
            "coresident": ({
                "tenant": ccfg.tenant,
                "stages": ccfg.stages or None,
                "microbatches": ccfg.microbatches,
                "replicas": ccfg.replicas,
                "serveUrl": self.serve_url,
            } if ccfg is not None else None),
        }
        log.info("retrain done: candidate %s (%d model(s)) from parent %s "
                 "on %d new rows — promote with `shifu promote`",
                 candidate_sha, len(candidate_paths), parent_sha,
                 norm_meta.n_rows)

"""`shifu varsel` — variable selection (counterpart of
`shifu_tpu/processor/varsel.py`).

Parity: core/processor/VarSelectModelProcessor.java:121 — auto-filter, force
select/remove files, filter by KS/IV/MIX/PARETO (:181-187), FI for tree
models (:188), the SE/ST sensitivity wrapper (train a model then rank
columns by knockout error delta, distributedSEWrapper :633), the voted GA
wrapper (VOTED, or V: core/dvarsel/VarSelMaster.java:39),
-list/-reset/-recover.
"""

from __future__ import annotations

import os
import shutil
from typing import List, Optional

import numpy as np

from shifu_tpu_torch.config.column_config import ColumnFlag
from shifu_tpu_torch.processor.basic import BasicProcessor
from shifu_tpu_torch.utils.errors import ErrorCode, ShifuError
from shifu_tpu_torch.utils.log import get_logger
from shifu_tpu_torch.utils.platform import DeviceLike

log = get_logger(__name__)


class VarSelProcessor(BasicProcessor):
    step = "varsel"

    def __init__(
        self,
        root: str = ".",
        list_vars: bool = False,
        reset: bool = False,
        recover: bool = False,
        device: DeviceLike = None,
    ):
        super().__init__(root, device=device)
        self.list_vars = list_vars
        self.reset = reset
        self.recover = recover

    def _backup_path(self) -> str:
        return os.path.join(self.paths.varsel_dir(), "ColumnConfig.json.prevarsel")

    def run_step(self) -> None:
        self.setup()
        mc = self.model_config
        assert mc is not None

        if self.list_vars:
            for c in self.column_configs:
                if c.final_select:
                    log.info("selected: %s (ks=%.4f iv=%.4f)", c.column_name,
                             c.column_stats.ks or 0, c.column_stats.iv or 0)
            log.info("%d variables selected.",
                     sum(1 for c in self.column_configs if c.final_select))
            return
        if self.reset:
            for c in self.column_configs:
                c.final_select = False
            self.save_column_configs()
            log.info("finalSelect reset for all columns.")
            return
        if self.recover:
            bak = self._backup_path()
            if not os.path.isfile(bak):
                raise ShifuError(ErrorCode.COLUMN_CONFIG_NOT_FOUND,
                                 f"no varsel backup at {bak}")
            shutil.copy(bak, self.paths.column_config_path())
            log.info("ColumnConfig recovered from %s", bak)
            return

        vs = mc.var_select
        filter_by = (vs.filter_by or "KS").upper()

        # backup before changing anything (-recover support)
        self.paths.ensure(self.paths.varsel_dir())
        shutil.copy(self.paths.column_config_path(), self._backup_path())

        self._apply_force_files(vs)

        if vs.force_enable:
            from shifu_tpu_torch.varsel.selector import auto_filter

            corr, names = self._load_correlation()
            res = auto_filter(
                self.column_configs,
                missing_rate_threshold=vs.missing_rate_threshold,
                min_ks=vs.min_ks_threshold or 0.0,
                min_iv=vs.min_iv_threshold or 0.0,
                correlation=corr,
                correlation_names=names,
                correlation_threshold=vs.correlation_threshold,
            )
            for name, why in res.removed.items():
                log.info("auto-filter removed %s: %s", name, why)

        if filter_by in ("SE", "ST"):
            scores = self._sensitivity(filter_by)
            self._select_by_scores(scores, vs.filter_num)
        elif filter_by == "FI":
            scores = self._feature_importance()
            self._select_by_scores(scores, vs.filter_num)
        elif filter_by in ("VOTED", "V"):
            scores = self._voted(vs)
            self._select_by_scores(scores, vs.wrapper_num or vs.filter_num)
        else:
            from shifu_tpu_torch.varsel.selector import select_by_filter

            selected = select_by_filter(
                self.column_configs, filter_by, vs.filter_num, vs.filter_enable
            )
            log.info("selected %d variables by %s.", len(selected), filter_by)

        self.save_column_configs()
        n = sum(1 for c in self.column_configs if c.final_select)
        log.info("varsel done: %d variables final-selected.", n)

    # ---- helpers ----
    def _apply_force_files(self, vs) -> None:
        """force_select/force_remove column-name files
        (VarSelectModelProcessor force list loading)."""

        def load_names(path: Optional[str]) -> List[str]:
            if not path:
                return []
            p = self.resolve(path)
            if not os.path.isfile(p):
                return []
            with open(p) as fh:
                return [ln.strip() for ln in fh if ln.strip()]

        force_sel = set(load_names(vs.force_select_column_name_file))
        force_rem = set(load_names(vs.force_remove_column_name_file))
        for c in self.column_configs:
            if c.column_name in force_sel and c.is_feature():
                c.column_flag = ColumnFlag.FORCE_SELECT
            elif c.column_name in force_rem and c.is_feature():
                c.column_flag = ColumnFlag.FORCE_REMOVE
                c.final_select = False

    def _load_correlation(self):
        """The matrix `shifu stats -correlation` wrote, or (None, None)."""
        path = self.paths.correlation_path()
        if not os.path.isfile(path):
            return None, None
        from shifu_tpu_torch.stats.correlation import load_correlation_csv

        return load_correlation_csv(path)

    def _select_by_scores(self, scores_by_name: dict, filter_num: int) -> None:
        for c in self.column_configs:
            if not c.is_force_select():
                c.final_select = False
        n_force = 0
        for c in self.column_configs:
            if c.is_force_select():
                c.final_select = True
                n_force += 1
        ranked = sorted(scores_by_name.items(), key=lambda kv: -kv[1])
        by_name = {c.column_name: c for c in self.column_configs}
        budget = max(0, filter_num - n_force)
        for name, score in ranked[:budget]:
            cc = by_name.get(name)
            if cc is not None and cc.is_feature() and not cc.is_force_remove():
                cc.final_select = True

    def _sensitivity(self, se_type: str) -> dict:
        """SE/ST wrapper: a quick NN train on all candidates, then the
        knockout scan. Writes se.csv (column, score) like the reference's
        SE report."""
        from shifu_tpu_torch.norm.dataset import load_normalized
        from shifu_tpu_torch.train.nn_trainer import NNTrainConfig, train_nn
        from shifu_tpu_torch.varsel.selector import sensitivity_scores

        norm_dir = self.paths.normalized_data_dir()
        if not os.path.isdir(norm_dir):
            raise ShifuError(ErrorCode.DATA_NOT_FOUND,
                             f"{norm_dir} — run `shifu norm` first")
        meta, feats, tags, weights = load_normalized(norm_dir)
        feats = np.asarray(feats, np.float32)
        tags = np.asarray(tags, np.float32)
        cfg = NNTrainConfig.from_model_config(self.model_config)
        cfg.num_epochs = min(cfg.num_epochs, 50)  # wrapper model, not final
        res = train_nn(feats, tags, np.asarray(weights, np.float32), cfg,
                       device=self.device)
        scores = sensitivity_scores(res.params, cfg.activations, feats, tags,
                                    se_type, device=self.device)
        # meta.columns are norm-plan OUTPUT names; a one-hot style norm
        # expands a source column into several outputs. Map outputs back
        # to their source column (the mapping the norm step persisted)
        # and keep the max knockout score per source.
        src_of = (meta.extra or {}).get("sourceOf")
        if not src_of:
            log.warning(
                "normalized data predates the persisted sourceOf mapping; "
                "reconstructing from current configs — re-run `shifu norm` "
                "if configs changed since, or scores may map to no column"
            )
            from shifu_tpu_torch.norm.normalizer import build_norm_plan

            src_of = build_norm_plan(
                self.model_config, self.column_configs
            ).source_of
        out: dict = {}
        for name, s in zip(meta.columns, scores):
            src = src_of.get(name, name)
            out[src] = max(out.get(src, float("-inf")), float(s))
        with open(self.paths.se_report_path(), "w") as fh:
            fh.write("column,score\n")
            for name, s in sorted(out.items(), key=lambda kv: -kv[1]):
                fh.write(f"{name},{s:.8g}\n")
        log.info("%s sensitivity computed for %d columns -> se.csv",
                 se_type, len(out))
        return out

    def _voted(self, vs) -> dict:
        """Voted selection (dvarsel): the GA wrapper proposes candidate
        variable subsets, every generation trains/validates the WHOLE
        population as one batched function, and the best seed wins
        (core/dvarsel/VarSelMaster.java:39, wrapper/CandidateGenerator).
        Scores: best-seed members rank first (1 + vote share), the rest by
        final-population vote share — so _select_by_scores keeps the seed.
        Writes voted.csv (column, score)."""
        from shifu_tpu_torch.norm.dataset import load_normalized
        from shifu_tpu_torch.varsel.voted import VotedConfig, voted_selection

        norm_dir = self.paths.normalized_data_dir()
        if not os.path.isdir(norm_dir):
            raise ShifuError(ErrorCode.DATA_NOT_FOUND,
                             f"{norm_dir} — run `shifu norm` first")
        meta, feats, tags, weights = load_normalized(norm_dir)
        feats = np.asarray(feats, np.float32)
        tags = np.asarray(tags, np.float32)
        weights = np.asarray(weights, np.float32)
        params = vs.params or {}
        # candidates train the model's CONFIGURED network, not a fixed
        # surrogate (ValidationConductor.java trains the configured net)
        cfg = VotedConfig.from_model_config(
            self.model_config,
            expect_var_count=int(params.get(
                "expect_variable_cnt", vs.wrapper_num or 20)),
            population_size=int(params.get("population_live_size", 30)),
            generations=int(params.get("population_multiply_cnt", 5)),
            cross_percent=int(params.get("hybrid_percent", 60)),
            mutation_percent=int(params.get("mutation_percent", 20)),
        )
        best, votes = voted_selection(feats, tags, weights, cfg,
                                      device=self.device)

        # map normalized output columns back to source columns (one-hot
        # expansion etc.), as the SE path does
        src_of = (meta.extra or {}).get("sourceOf") or {}
        best_set = set(best)
        out: dict = {}
        for j, name in enumerate(meta.columns):
            src = src_of.get(name, name)
            score = (1.0 + float(votes[j])) if j in best_set else float(votes[j])
            out[src] = max(out.get(src, float("-inf")), score)
        with open(os.path.join(self.paths.varsel_dir(), "voted.csv"),
                  "w") as fh:
            fh.write("column,score\n")
            for name, s in sorted(out.items(), key=lambda kv: -kv[1]):
                fh.write(f"{name},{s:.6g}\n")
        log.info("voted selection: best seed has %d columns", len(best))
        return out

    def _feature_importance(self) -> dict:
        """FI filter: requires a trained tree model
        (VarSelectModelProcessor.java:188 selectByFeatureImportance)."""
        from shifu_tpu_torch.eval.scorer import find_model_paths
        from shifu_tpu_torch.models.tree import TreeModelSpec
        from shifu_tpu_torch.varsel.importance import tree_feature_importance

        paths = [p for p in find_model_paths(self.paths.models_dir())
                 if p.endswith((".gbt", ".rf"))]
        if not paths:
            raise ShifuError(
                ErrorCode.MODEL_NOT_FOUND,
                "FI filter needs a trained GBT/RF model; run `shifu train`",
            )
        spec = TreeModelSpec.load(paths[0])
        return tree_feature_importance(spec)

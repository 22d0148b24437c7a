"""`shifu train` (counterpart of `shifu_tpu/processor/train.py`).

Parity: core/processor/TrainModelProcessor.java:105 — per-algorithm
dispatch, bagging, k-fold, grid search, continuous training, model-file
suffixes, progress and val-error files. The port trains the tree family
(GBT, RF, DT), NN/LR/SVM and WDL in memory, over every card when
the step runs on cuda and there is more than one (`_mesh`, the trainers'
`mesh=`), else on one device; bagging members, ONEVSALL classes, k-fold folds and grid trials of one program
signature train together on a trainer's member axis. NormalizedData
past `shifu.train.memoryBudgetMB` (or `train.trainOnDisk`) trains
streamed, members one after another (`train/streaming.py`); so does
a co-resident run (`shifu retrain --coresident`, `coresident_cfg` set),
each member a background tenant of the serving ledger
(`coresident/trainer.py`).
"""

from __future__ import annotations

import os
import struct
from typing import List, Optional

import numpy as np

from shifu_tpu_torch.config.model_config import Algorithm
from shifu_tpu_torch.processor.basic import BasicProcessor
from shifu_tpu_torch.utils.errors import ErrorCode, ShifuError
from shifu_tpu_torch.utils.log import get_logger
from shifu_tpu_torch.utils.platform import DeviceLike

log = get_logger(__name__)


class TrainProcessor(BasicProcessor):
    step = "train"

    def __init__(self, root: str = ".", dry: bool = False,
                 device: DeviceLike = None):
        super().__init__(root, device=device)
        self.dry = dry

    def _mesh(self):
        """Every card when the step runs on cuda and there is more than
        one, else None (JAX `processor/train.py:603-608`)."""
        from shifu_tpu_torch.parallel import mesh as mesh_mod

        return mesh_mod.train_mesh(self.device)

    # ---- helpers ----
    def _model_suffix(self, alg: Algorithm) -> str:
        return {
            Algorithm.NN: "nn",
            Algorithm.LR: "lr",
            Algorithm.GBT: "gbt",
            Algorithm.RF: "rf",
            Algorithm.DT: "rf",
            Algorithm.WDL: "wdl",
        }.get(alg, "nn")

    def run_step(self) -> None:
        self.setup()
        mc = self.model_config
        assert mc is not None
        alg = mc.train.algorithm

        if self.dry:
            log.info("dry run: config validated, algorithm=%s", alg.value)
            return

        if alg in (Algorithm.NN, Algorithm.LR, Algorithm.SVM):
            self._train_nn_family(alg)
        elif alg in (Algorithm.GBT, Algorithm.RF, Algorithm.DT):
            self._train_tree_family(alg)
        elif alg == Algorithm.WDL:
            from shifu_tpu_torch.processor.train_wdl import train_wdl_models

            train_wdl_models(self)
        else:
            raise ShifuError(
                ErrorCode.INVALID_MODEL_CONFIG, f"algorithm {alg.value} not supported"
            )

    # ---- NN / LR / SVM ----
    def _train_nn_family(self, alg: Algorithm) -> None:
        from shifu_tpu_torch.norm.dataset import load_normalized
        from shifu_tpu_torch.norm.normalizer import (build_norm_plan,
                                                     plan_to_json)
        from shifu_tpu_torch.processor.train_common import progress_writer
        from shifu_tpu_torch.train.grid_search import flatten_params
        from shifu_tpu_torch.train.nn_trainer import NNTrainConfig, train_nn
        from shifu_tpu_torch.train.streaming import should_stream_training

        mc = self.model_config
        norm_dir = self.paths.normalized_data_dir()
        if not os.path.isdir(norm_dir):
            raise ShifuError(
                ErrorCode.DATA_NOT_FOUND, f"{norm_dir} — run `shifu norm` first"
            )
        plan = build_norm_plan(mc, self.column_configs)
        norm_json = plan_to_json(plan)
        suffix = self._model_suffix(alg)
        self.paths.ensure(self.paths.models_dir())
        self.paths.ensure(self.paths.train_dir())
        # a co-resident run (retrain --coresident) always rides the
        # shard-streamed epoch loop: the stage pipeline feeds from the
        # same ShardFeed whatever the matrix size
        if (getattr(self, "coresident_cfg", None) is not None
                or should_stream_training(
                    norm_dir, force_attr=bool(mc.train.train_on_disk))):
            self._train_nn_streamed(alg, norm_dir, norm_json, suffix)
            return

        meta, feats, tags, weights = load_normalized(norm_dir)
        feats = np.asarray(feats, dtype=np.float32)
        tags = np.asarray(tags, dtype=np.float32)
        weights = np.asarray(weights, dtype=np.float32)
        log.info("training on %d rows x %d features (%s) on %s",
                 feats.shape[0], feats.shape[1], alg.value, self.device)
        data = (feats, tags, weights)

        composites = flatten_params(
            mc.train.params or {},
            self.resolve(mc.train.grid_config_file)
            if mc.train.grid_config_file else None,
        )
        is_grid = len(composites) > 1
        num_kfold = mc.train.num_k_fold or -1
        bagging = max(1, int(mc.train.bagging_num or 1))

        if mc.is_multi_classification() and mc.train.is_one_vs_all():
            if is_grid:
                # grid under OVA: each trial trains all K per-class members
                # on the member axis; its score is the mean class holdout
                # error (TrainModelProcessor.java:684-945)
                best = self._grid_search_ova(composites, data)
                log.info("ONEVSALL grid search best params: %s", best)
                mc.train.params = best
            if num_kfold > 0:
                log.warning("num_k_fold is ignored under ONEVSALL "
                            "multi-class (one model per class)")
            self._train_one_vs_all(alg, data, meta.columns, norm_json,
                                   suffix)
            return

        if is_grid:
            best = self._grid_search(composites, data)
            log.info("grid search best params: %s", best)
            mc.train.params = best

        if num_kfold > 0:
            self._k_fold(alg, num_kfold, data, meta.columns, norm_json,
                         suffix)
            return

        if bagging > 1:
            self._train_bagged(alg, bagging, data, meta.columns, norm_json,
                               suffix)
            return

        cfg = NNTrainConfig.from_model_config(mc, trainer_id=0)
        cfg.checkpoint_every = self._checkpoint_every()
        cfg.checkpoint_path = self._checkpoint_paths(1)[0]
        cfg.progress_cb = progress_writer(self.paths.progress_path(0))
        result = train_nn(feats, tags, weights, cfg,
                          init_flat=self._continuous_inits(1, suffix)[0],
                          device=self.device,
                          mesh=self._mesh())
        self._save_model(0, alg, cfg, result, meta.columns, norm_json,
                         suffix)

    def _train_nn_streamed(self, alg, norm_dir, norm_json, suffix) -> None:
        """Larger-than-memory route: the normalized matrix never lands in
        one host array; each member streams the mmap'd shards
        (`train/streaming.py`, the reference's MemoryDiskFloatMLDataSet).
        Bagging members, ONEVSALL classes, grid trials and folds run one
        after another (the reference fans them out as Guagua jobs,
        TrainModelProcessor.java:768-945)."""
        from shifu_tpu_torch.norm.dataset import read_meta
        from shifu_tpu_torch.processor.train_common import progress_writer
        from shifu_tpu_torch.resilience.checkpoint import resume_requested
        from shifu_tpu_torch.train.grid_search import flatten_params
        from shifu_tpu_torch.train.nn_trainer import NNTrainConfig
        from shifu_tpu_torch.train.streaming import train_nn_streamed

        mc = self.model_config
        cc_base = getattr(self, "coresident_cfg", None)
        composites = flatten_params(
            mc.train.params or {},
            self.resolve(mc.train.grid_config_file)
            if mc.train.grid_config_file else None,
        )
        if cc_base is not None and (len(composites) > 1
                                    or (mc.train.num_k_fold or -1) > 0):
            raise ShifuError(
                ErrorCode.INVALID_MODEL_CONFIG,
                "--coresident trains the final member(s) only — grid "
                "search / k-fold explore on the dedicated trainer first")
        multi = mc.is_multi_classification()
        is_ova = multi and mc.train.is_one_vs_all()
        if len(composites) > 1:
            best = self._grid_search_streamed(
                norm_dir, composites, len(mc.tags()) if is_ova else 0)
            log.info("streamed grid search best params: %s", best)
            mc.train.params = best
        columns = list(read_meta(norm_dir).columns)
        num_kfold = mc.train.num_k_fold or -1
        if num_kfold > 0:
            if is_ova:
                log.warning("num_k_fold is ignored under ONEVSALL "
                            "multi-class (one model per class)")
            else:
                self._k_fold_streamed(alg, num_kfold, norm_dir, columns,
                                      norm_json, suffix)
                return
        class_tags = [str(t) for t in mc.tags()] if multi else None
        n_members = (len(class_tags) if is_ova
                     else max(1, int(mc.train.bagging_num or 1)))
        log.info("training STREAMED from %s (%d member(s)) on %s", norm_dir,
                 n_members, self.device)
        paths = self._checkpoint_paths(n_members)
        for i in range(n_members):
            cfg = NNTrainConfig.from_model_config(mc, trainer_id=i)
            cfg.checkpoint_every = self._checkpoint_every()
            cfg.checkpoint_path = paths[i]
            cfg.progress_cb = progress_writer(self.paths.progress_path(i), i)
            init_flat = (self._continuous_init(i, suffix)
                         if mc.train.is_continuous else None)
            ident_extra = getattr(self, "train_ident_extra", None)
            if cc_base is not None:
                from dataclasses import replace as dc_replace

                from shifu_tpu_torch.coresident import train_nn_coresident

                # bagging members need distinct checkpoint families and
                # ledger identities (ONEVSALL classes already split on
                # the family's -c<class> suffix)
                ccfg_i = dc_replace(
                    cc_base, tenant=(cc_base.tenant if i == 0 or is_ova
                                     else f"{cc_base.tenant}-m{i}"))
                res = train_nn_coresident(
                    norm_dir, cfg, ccfg=ccfg_i, init_flat=init_flat,
                    target_class=i if is_ova else None,
                    resume=resume_requested(), ident_extra=ident_extra,
                    device=self.device)
            else:
                res = train_nn_streamed(
                    norm_dir, cfg, init_flat=init_flat,
                    target_class=i if is_ova else None,
                    resume=resume_requested(), device=self.device,
                    mesh=self._mesh(), ident_extra=ident_extra)
            self._save_model(i, alg, cfg, res, columns, norm_json, suffix,
                             class_tags=class_tags)

    def _grid_search_streamed(self, norm_dir, composites,
                              n_classes: int = 0) -> dict:
        """Grid trials one after another, each a full streamed run; under
        ONEVSALL (n_classes > 0) a trial streams one run a class and
        scores the mean class holdout error."""
        from shifu_tpu_torch.train.streaming import train_nn_streamed

        results = []
        for gi, params in enumerate(composites):
            cfg = self._config_for(params, gi)
            if n_classes > 0:
                err = float(np.mean([
                    train_nn_streamed(norm_dir, cfg, target_class=k,
                                      device=self.device,
                                      mesh=self._mesh()).valid_error
                    for k in range(n_classes)]))
            else:
                err = train_nn_streamed(norm_dir, cfg,
                                        device=self.device,
                                        mesh=self._mesh()).valid_error
            results.append((err, gi, params))
            log.info("streamed grid trial %d/%d valid err %.6f params=%s",
                     gi + 1, len(composites), err, params)
        results.sort(key=lambda r: r[0])
        return results[0][2]

    def _k_fold_streamed(self, alg, k: int, norm_dir, columns, norm_json,
                         suffix) -> None:
        """Streamed k-fold: fold membership is the global row index % k,
        the in-memory fold geometry, carried into each shard through the
        feed's `sig_override`; folds run one after another."""
        from shifu_tpu_torch.train.nn_trainer import NNTrainConfig
        from shifu_tpu_torch.train.streaming import train_nn_streamed

        mc = self.model_config
        errors = []
        for i in range(k):
            cfg = NNTrainConfig.from_model_config(mc, trainer_id=i)
            cfg.valid_set_rate = 0.0  # the fold drives the split
            cfg.early_stop_window = 0

            def sig_override(s, rows, offset, w, _i=i, _cfg=cfg):
                fold = np.arange(offset, offset + rows) % k
                rng = np.random.default_rng(_i * 1000 + 7 + s)
                if _cfg.bagging_with_replacement:
                    bag = rng.poisson(_cfg.bagging_sample_rate, size=rows)
                else:
                    bag = rng.random(rows) < _cfg.bagging_sample_rate
                return (np.where(fold == _i, 0.0, w * bag),
                        np.where(fold == _i, w, 0.0))

            res = train_nn_streamed(norm_dir, cfg, sig_override=sig_override,
                                    device=self.device,
                                    mesh=self._mesh())
            self._save_model(i, alg, cfg, res, columns, norm_json, suffix,
                             val_error_file=False)
            errors.append(res.valid_error)
            log.info("streamed fold %d/%d holdout err %.6f", i + 1, k,
                     res.valid_error)
        log.info("streamed k-fold avg validation error: %.6f",
                 float(np.mean(errors)))

    def _save_model(self, i: int, alg, cfg, result, columns, norm_json,
                    suffix: str, class_tags=None, val_error_file=True
                    ) -> None:
        spec = self._make_spec(alg, cfg, result, columns, norm_json,
                               class_tags=class_tags)
        path = self.paths.model_path(i, suffix)
        spec.save(path)
        if val_error_file:
            with open(self.paths.val_error_path(i), "w") as fh:
                fh.write(f"{result.valid_error}\n")
        log.info("model %d -> %s (valid err %.6f)", i, path,
                 result.valid_error)

    def _train_bagged(self, alg, bagging: int, data, columns, norm_json,
                      suffix: str) -> None:
        """All bagging members on the member axis (the reference's
        5-parallel Guagua jobs, shifuconfig shifu.train.bagging.inparallel)."""
        from shifu_tpu_torch.processor.train_common import (
            member_progress_writer)
        from shifu_tpu_torch.train.nn_trainer import (NNTrainConfig,
                                                      train_nn_bagged)

        mc = self.model_config
        base_cfg = NNTrainConfig.from_model_config(mc, trainer_id=0)
        base_cfg.checkpoint_every = self._checkpoint_every()
        base_cfg.progress_cb = member_progress_writer(
            [self.paths.progress_path(i) for i in range(bagging)])
        results = train_nn_bagged(
            *data, base_cfg, bagging,
            init_flats=self._continuous_inits(bagging, suffix),
            checkpoint_paths=self._checkpoint_paths(bagging),
            device=self.device,
            mesh=self._mesh())
        for i, result in enumerate(results):
            cfg_i = NNTrainConfig.from_model_config(mc, trainer_id=i)
            self._save_model(i, alg, cfg_i, result, columns, norm_json,
                             suffix)
        log.info("bagging avg valid error: %.6f",
                 float(np.mean([r.valid_error for r in results])))

    def _checkpoint_paths(self, n: int) -> List[str]:
        return [os.path.join(self.paths.ensure(self.paths.checkpoint_dir(i)),
                             "weights.npy") for i in range(n)]

    def _config_for(self, params: dict, trainer_id: int):
        """NNTrainConfig of the model config under other train.params."""
        from shifu_tpu_torch.train.nn_trainer import NNTrainConfig

        mc = self.model_config
        orig = mc.train.params
        mc.train.params = params
        try:
            return NNTrainConfig.from_model_config(mc, trainer_id=trainer_id)
        finally:
            mc.train.params = orig

    def _grid_search_ova(self, composites, data) -> dict:
        """Grid x ONEVSALL: trials run serially, each trial's K per-class
        binary members on the member axis; the trial's score is the mean
        class holdout error."""
        from shifu_tpu_torch.train.nn_trainer import train_nn_bagged

        K = len(self.model_config.tags())
        member_tags = self._member_tags(data[1], K)
        results = []
        for gi, params in enumerate(composites):
            cfg = self._config_for(params, 0)
            trial = train_nn_bagged(
                *data, cfg, K, member_tags=member_tags,
                member_seed=lambda i, _g=gi: (_g * 100 + i) * 1000 + 7,
                device=self.device,
                mesh=self._mesh())
            err = float(np.mean([r.valid_error for r in trial]))
            results.append((err, gi, params))
            log.info("OVA grid trial %d/%d mean class err %.6f params=%s",
                     gi + 1, len(composites), err, params)
        results.sort(key=lambda r: r[0])
        return results[0][2]

    @staticmethod
    def _member_tags(tags: np.ndarray, K: int) -> np.ndarray:
        return np.stack([(tags == k).astype(np.float32) for k in range(K)])

    def _train_one_vs_all(self, alg, data, columns, norm_json,
                          suffix) -> None:
        """ONEVSALL: one binary model per class, all classes on the member
        axis (the reference fans out baggingNum=classes Guagua jobs,
        TrainModelProcessor.java:691-699; trainer i's ideal is tag==i,
        NNWorker.java:116-120)."""
        from shifu_tpu_torch.train.nn_trainer import (NNTrainConfig,
                                                      train_nn_bagged)

        mc = self.model_config
        class_tags = [str(t) for t in mc.tags()]
        K = len(class_tags)
        if (mc.train.bagging_num or 1) not in (1, K):
            log.warning("'train:baggingNum' is overridden to %d because of "
                        "ONEVSALL multiple classification.", K)
        base_cfg = NNTrainConfig.from_model_config(mc, trainer_id=0)
        base_cfg.checkpoint_every = self._checkpoint_every()
        results = train_nn_bagged(
            *data, base_cfg, K,
            init_flats=self._continuous_inits(K, suffix),
            checkpoint_paths=self._checkpoint_paths(K),
            member_tags=self._member_tags(data[1], K), device=self.device,
            mesh=self._mesh())
        for k, result in enumerate(results):
            cfg_k = NNTrainConfig.from_model_config(mc, trainer_id=k)
            self._save_model(k, alg, cfg_k, result, columns, norm_json,
                             suffix, class_tags=class_tags)

    def _checkpoint_every(self) -> int:
        """Checkpoint cadence = train.epochsPerIteration (the reference
        writes tmp models every epochsPerIteration master iterations)."""
        per = int(self.model_config.train.epochs_per_iteration or 1)
        return max(per, 10) if per <= 1 else per

    @staticmethod
    def _program_signature(cfg) -> tuple:
        """Everything but LearningRate and the seed: trials that share it
        can ride one member axis."""
        return (
            tuple(cfg.hidden_nodes), tuple(cfg.activations), cfg.loss,
            cfg.dropout_rate, cfg.mixed_precision, cfg.mini_batchs,
            cfg.early_stop_window, cfg.convergence_threshold,
            cfg.learning_decay, (cfg.propagation or "Q").upper(),
            cfg.momentum, cfg.regularized_constant, cfg.reg_level,
            cfg.adam_beta1, cfg.adam_beta2, cfg.num_epochs,
            cfg.valid_set_rate, cfg.bagging_sample_rate,
            cfg.bagging_with_replacement, cfg.weight_init, cfg.n_classes,
        )

    def _grid_search(self, composites, data) -> dict:
        """Grid trials on the member axis, grouped by program signature —
        a LearningRate sweep is ONE loop, not one run a trial (the
        reference runs each trial as a Guagua job, gs/GridSearch.java:44 +
        TrainModelProcessor.java:768-945)."""
        from shifu_tpu_torch.train.nn_trainer import train_nn_bagged

        cfgs = [self._config_for(params, gi)
                for gi, params in enumerate(composites)]
        groups: dict = {}
        for gi, cfg in enumerate(cfgs):
            groups.setdefault(self._program_signature(cfg), []).append(gi)

        results = []
        for idxs in groups.values():
            trial_results = train_nn_bagged(
                *data, cfgs[idxs[0]], len(idxs),
                member_seed=lambda i, _idxs=idxs: _idxs[i] * 1000 + 7,
                member_lrs=[cfgs[i].learning_rate for i in idxs],
                device=self.device,
                mesh=self._mesh())
            for gi, res in zip(idxs, trial_results):
                results.append((res.valid_error, gi, composites[gi]))
                log.info("grid trial %d/%d valid err %.6f params=%s",
                         gi + 1, len(composites), res.valid_error,
                         composites[gi])
        log.info("grid search: %d trials in %d group(s)",
                 len(composites), len(groups))
        results.sort(key=lambda r: r[0])
        return results[0][2]

    def _k_fold(self, alg, k: int, data, columns, norm_json,
                suffix) -> None:
        """All k folds on the member axis: fold i's member holds out fold
        i through its significance masks; the trainer's valid error IS the
        holdout error (TrainModelProcessor.java:947-969)."""
        from shifu_tpu_torch.train.nn_trainer import (NNTrainConfig,
                                                      train_nn_bagged)

        mc = self.model_config
        feats, tags, weights = data
        n = feats.shape[0]
        fold = np.arange(n) % k
        base = NNTrainConfig.from_model_config(mc, trainer_id=0)
        base.valid_set_rate = 0.0  # folds drive the split instead
        base.early_stop_window = 0  # holdout must not steer training
        sig_ts, sig_vs = [], []
        for i in range(k):
            # bagging sampling still applies inside each fold's train side
            rng = np.random.default_rng(i * 1000 + 7)
            if base.bagging_with_replacement:
                bag = rng.poisson(base.bagging_sample_rate, size=n)
            else:
                bag = rng.random(n) < base.bagging_sample_rate
            sig_ts.append(np.where(fold == i, 0.0, weights * bag))
            sig_vs.append(np.where(fold == i, weights, 0.0))
        sig_t = np.stack(sig_ts).astype(np.float32)
        sig_v = np.stack(sig_vs).astype(np.float32)
        results = train_nn_bagged(*data, base, k, member_sigs=(sig_t, sig_v),
                                  device=self.device,
                                  mesh=self._mesh())
        for i, res in enumerate(results):
            cfg_i = NNTrainConfig.from_model_config(mc, trainer_id=i)
            self._save_model(i, alg, cfg_i, res, columns, norm_json,
                             suffix, val_error_file=False)
        log.info("k-fold avg validation error: %.6f",
                 float(np.mean([r.valid_error for r in results])))

    def _continuous_inits(self, n: int, suffix: str
                          ) -> List[Optional[np.ndarray]]:
        """Under train.isContinuous, members 0..n-1 resume from their
        existing model files (checkContinuousTraining
        TrainModelProcessor.java:1149); None = a fresh start."""
        if not self.model_config.train.is_continuous:
            return [None] * n
        return [self._continuous_init(i, suffix) for i in range(n)]

    def _continuous_init(self, i: int, suffix: str) -> Optional[np.ndarray]:
        from shifu_tpu_torch.models.nn import NNModelSpec, flatten_params

        path = self.paths.model_path(i, suffix)
        if not os.path.isfile(path):
            return None
        try:
            spec = NNModelSpec.load(path)
            flat, _ = flatten_params(spec.params)
            log.info("continuous training: resuming model %d from %s", i, path)
            return flat
        except (OSError, ValueError, KeyError, struct.error) as e:
            # corrupt/mismatched spec: fresh start, logged
            log.warning("cannot resume from %s (%s); fresh start", path, e)
            return None

    def _make_spec(self, alg, cfg, result, columns, norm_json,
                   class_tags=None):
        from shifu_tpu_torch.models.nn import NNModelSpec

        in_dim = result.params[0]["W"].shape[0]
        out_dim = result.params[-1]["W"].shape[1]
        mc = self.model_config
        if class_tags is None and mc is not None and mc.is_multi_classification():
            class_tags = [str(t) for t in mc.tags()]
        return NNModelSpec(
            layer_sizes=[len(columns) if columns else in_dim]
            + list(cfg.hidden_nodes)
            + [out_dim],
            activations=list(cfg.activations),
            input_columns=list(columns),
            norm_type=norm_json.get("normType", "ZSCALE"),
            algorithm=alg.value,
            loss=cfg.loss,
            norm_specs=norm_json.get("columns", []),
            norm_cutoff=float(norm_json.get("cutoff", 4.0)),
            params=result.params,
            train_error=result.train_error,
            valid_error=result.valid_error,
            class_tags=list(class_tags or []),
        )

    # ---- trees ----
    def _train_tree_family(self, alg: Algorithm) -> None:
        from shifu_tpu_torch.processor.train_tree import train_tree_models

        train_tree_models(self, alg)

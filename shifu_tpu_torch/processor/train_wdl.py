"""`shifu train` for WDL (counterpart of `shifu_tpu/processor/train_wdl.py`):
dense numerics from NormalizedData, categorical codes from CleanedData
(parity: prepareWDLParams TrainModelProcessor.java:1474, wdl/WDLWorker
input wiring: numeric z-score + categorical sparse index).

WDL trains as NN does: bagging members, grid trials (grouped by program
signature, batched by LearningRate), k-fold folds and continuous
training, all on the WDL trainer's member axis, over every card when
there is more than one (`parallel.mesh.train_mesh`, rows only: JAX
`processor/train_wdl.py:305-315` without the `model` axis).
NormalizedData or CleanedData past -Dshifu.train.memoryBudgetMB (or
train.trainOnDisk) trains streamed, members one after another
(`train/streaming_wdl.py`), and so does a co-resident run (`shifu
retrain --coresident`: `coresident/trainer.train_wdl_coresident`).
"""

from __future__ import annotations

import os
import struct
from typing import Optional

import numpy as np

from shifu_tpu_torch.parallel import mesh as mesh_mod
from shifu_tpu_torch.utils.errors import ErrorCode, ShifuError
from shifu_tpu_torch.utils.log import get_logger

log = get_logger(__name__)


def _wdl_signature(cfg) -> tuple:
    """Trials sharing it differ only in LearningRate and the seed, and
    batch on the member axis."""
    return (
        tuple(cfg.hidden), tuple(cfg.activations), cfg.embed_dim,
        cfg.optimizer, cfg.l2_reg, cfg.num_epochs, cfg.valid_set_rate,
        cfg.bagging_sample_rate, cfg.bagging_with_replacement,
        cfg.early_stop_window,
    )


def _wdl_column_mapping(proc, nmeta, cmeta):
    """(num_idx, num_names, cat_idx, cat_names, vocab_sizes, categories):
    numeric feature columns come from the normalized matrix; categorical
    ones from the code matrix (embedding + wide indices, vocab = the
    column's code slots)."""
    from shifu_tpu_torch.norm.normalizer import norm_columns

    by_name = {c.column_name: c for c in norm_columns(proc.column_configs)}
    num_idx, num_names = [], []
    for j, name in enumerate(nmeta.columns):
        cc = by_name.get(name)
        if cc is not None and not cc.is_categorical():
            num_idx.append(j)
            num_names.append(name)
    cat_idx, cat_names, vocab_sizes, categories = [], [], [], []
    for j, name in enumerate(cmeta.columns):
        cc = by_name.get(name)
        if cc is not None and cc.is_categorical():
            cat_idx.append(j)
            cat_names.append(name)
            vocab_sizes.append(int(cmeta.extra["slots"][j]))
            categories.append(list(cc.column_binning.bin_category or []))
    return num_idx, num_names, cat_idx, cat_names, vocab_sizes, categories


def train_wdl_models(proc) -> None:
    from shifu_tpu_torch.norm.dataset import load_codes, load_normalized
    from shifu_tpu_torch.norm.normalizer import build_norm_plan, spec_to_json
    from shifu_tpu_torch.processor.train_common import (
        member_progress_writer, progress_writer)
    from shifu_tpu_torch.train.grid_search import flatten_params
    from shifu_tpu_torch.train.streaming import should_stream_training
    from shifu_tpu_torch.train.wdl_trainer import (
        WDLTrainConfig, train_wdl, train_wdl_bagged)

    mc = proc.model_config
    norm_dir = proc.paths.normalized_data_dir()
    codes_dir = proc.paths.cleaned_data_dir()
    if not (os.path.isdir(norm_dir) and os.path.isdir(codes_dir)):
        raise ShifuError(ErrorCode.DATA_NOT_FOUND,
                         "run `shifu norm` before WDL training")
    # co-resident runs always stream: the stage pipeline feeds from the
    # paired (norm, codes) shard feed whatever the matrix size
    if (getattr(proc, "coresident_cfg", None) is not None
            or should_stream_training(
                norm_dir, force_attr=bool(mc.train.train_on_disk))
            or should_stream_training(codes_dir)):
        _train_wdl_streamed(proc)
        return

    nmeta, feats, tags, weights = load_normalized(norm_dir)
    cmeta, codes, _, _ = load_codes(codes_dir)
    (num_idx, num_names, cat_idx, cat_names, vocab_sizes,
     categories) = _wdl_column_mapping(proc, nmeta, cmeta)
    dense = np.asarray(feats, np.float32)[:, num_idx]
    cat_codes = np.asarray(codes, np.int32)[:, cat_idx]
    tags = np.asarray(tags, np.float32)
    weights = np.asarray(weights, np.float32)
    log.info("WDL inputs: %d dense cols, %d embed fields (vocab %s) on %s",
             len(num_names), len(cat_names), vocab_sizes, proc.device)
    data = (dense, cat_codes, tags, weights, vocab_sizes)

    plan = build_norm_plan(mc, proc.column_configs)
    names = set(num_names)
    dense_specs = [spec_to_json(s) for s in plan.specs
                   if s.cc.column_name in names]
    proc.paths.ensure(proc.paths.models_dir())
    proc.paths.ensure(proc.paths.train_dir())

    def save_member(i, cfg, res):
        _save_wdl_member(proc, i, cfg, res, num_names, cat_names,
                         vocab_sizes, dense_specs, plan.cutoff, categories)

    composites = flatten_params(
        mc.train.params or {},
        proc.resolve(mc.train.grid_config_file)
        if mc.train.grid_config_file else None,
    )
    num_kfold = mc.train.num_k_fold or -1
    bagging = max(1, int(mc.train.bagging_num or 1))

    # ---- grid search: trials batched on the member axis per signature ----
    if len(composites) > 1:
        orig = mc.train.params
        cfgs = []
        for gi, params in enumerate(composites):
            mc.train.params = params
            try:
                cfgs.append(WDLTrainConfig.from_model_config(mc,
                                                             trainer_id=gi))
            finally:
                mc.train.params = orig
        groups: dict = {}
        for gi, cfg in enumerate(cfgs):
            groups.setdefault(_wdl_signature(cfg), []).append(gi)
        scored = []
        for idxs in groups.values():
            trial_results = train_wdl_bagged(
                *data, cfgs[idxs[0]], len(idxs),
                member_lrs=[cfgs[i].learning_rate for i in idxs],
                device=proc.device,
                mesh=mesh_mod.train_mesh(proc.device))
            for gi, res in zip(idxs, trial_results):
                scored.append((res.valid_error, gi, composites[gi]))
                log.info("wdl grid trial %d/%d valid err %.6f params=%s",
                         gi + 1, len(composites), res.valid_error,
                         composites[gi])
        scored.sort(key=lambda r: r[0])
        best = scored[0][2]
        log.info("wdl grid search best params: %s", best)
        mc.train.params = best

    # ---- k-fold: folds on the member axis, unbiased holdout ----
    if num_kfold > 0:
        fold = np.arange(dense.shape[0]) % num_kfold
        base = WDLTrainConfig.from_model_config(mc, trainer_id=0)
        base.valid_set_rate = 0.0
        base.early_stop_window = 0
        sig_t = np.stack([np.where(fold == i, 0.0, weights)
                          for i in range(num_kfold)]).astype(np.float32)
        sig_v = np.stack([np.where(fold == i, weights, 0.0)
                          for i in range(num_kfold)]).astype(np.float32)
        results = train_wdl_bagged(*data, base, num_kfold,
                                   member_sigs=(sig_t, sig_v),
                                   device=proc.device,
                                   mesh=mesh_mod.train_mesh(proc.device))
        for i, res in enumerate(results):
            save_member(i, WDLTrainConfig.from_model_config(mc, trainer_id=i),
                        res)
            log.info("wdl fold %d/%d holdout err %.6f", i + 1, num_kfold,
                     res.valid_error)
        log.info("wdl k-fold avg validation error: %.6f",
                 float(np.mean([r.valid_error for r in results])))
        return

    # ---- bagging (member axis) / single model ----
    base_cfg = WDLTrainConfig.from_model_config(mc, trainer_id=0)
    base_cfg.checkpoint_every = proc._checkpoint_every()
    init_flats = [_continuous_init(proc, i) if mc.train.is_continuous
                  else None for i in range(bagging)]
    checkpoints = proc._checkpoint_paths(bagging)
    if bagging > 1:
        base_cfg.progress_cb = member_progress_writer(
            [proc.paths.progress_path(i) for i in range(bagging)])
        results = train_wdl_bagged(*data, base_cfg, bagging,
                                   init_flats=init_flats,
                                   checkpoint_paths=checkpoints,
                                   device=proc.device,
                                   mesh=mesh_mod.train_mesh(proc.device))
        for i, res in enumerate(results):
            save_member(i, WDLTrainConfig.from_model_config(mc, trainer_id=i),
                        res)
        return

    base_cfg.checkpoint_path = checkpoints[0]
    base_cfg.progress_cb = progress_writer(proc.paths.progress_path(0))
    res = train_wdl(*data, base_cfg, init_flat=init_flats[0],
                    device=proc.device,
                    mesh=mesh_mod.train_mesh(proc.device))
    save_member(0, base_cfg, res)


def _continuous_init(proc, i: int) -> Optional[np.ndarray]:
    """Resume member i from its existing model's weights under
    train.isContinuous (checkContinuousTraining:1149 parity; a missing
    or unreadable file is a fresh start, a shape mismatch too)."""
    from shifu_tpu_torch.models.wdl import WDLModelSpec, flatten_wdl

    path = proc.paths.model_path(i, "wdl")
    if not os.path.isfile(path):
        return None
    try:
        flat = flatten_wdl(WDLModelSpec.load(path).params)
        log.info("continuous training: resuming WDL model %d from %s", i,
                 path)
        return flat
    except (OSError, ValueError, KeyError, struct.error) as e:
        log.warning("cannot resume from %s (%s); fresh start", path, e)
        return None


def _save_wdl_member(proc, i, cfg, res, num_names, cat_names, vocab_sizes,
                     dense_specs, cutoff, categories) -> None:
    """The `.wdl` model file and the val-error file of member i."""
    from shifu_tpu_torch.models.wdl import WDLModelSpec

    spec = WDLModelSpec(
        hidden=list(cfg.hidden),
        activations=list(cfg.activations),
        embed_dim=cfg.embed_dim,
        dense_columns=num_names,
        cat_columns=cat_names,
        vocab_sizes=vocab_sizes,
        norm_specs=dense_specs,
        norm_cutoff=cutoff,
        categories=categories,
        norm_type=proc.model_config.normalize.norm_type.value,
        params=res.params,
        train_error=res.train_error,
        valid_error=res.valid_error,
    )
    path = proc.paths.model_path(i, "wdl")
    spec.save(path)
    with open(proc.paths.val_error_path(i), "w") as fh:
        fh.write(f"{res.valid_error}\n")
    log.info("model %d (WDL) -> %s (valid err %.6f)", i, path,
             res.valid_error)


def _train_wdl_streamed(proc) -> None:
    """Larger-than-memory WDL: per-shard gradients over the row-aligned
    (NormalizedData, CleanedData) shard pairs (`train/streaming_wdl.py`).
    Members run one after another; grid search and k-fold need the
    in-memory trainer, as in the JAX package."""
    from shifu_tpu_torch.norm.dataset import read_meta
    from shifu_tpu_torch.norm.normalizer import build_norm_plan, spec_to_json
    from shifu_tpu_torch.processor.train_common import progress_writer
    from shifu_tpu_torch.resilience.checkpoint import resume_requested
    from shifu_tpu_torch.train.grid_search import flatten_params
    from shifu_tpu_torch.train.streaming_wdl import train_wdl_streamed
    from shifu_tpu_torch.train.wdl_trainer import WDLTrainConfig

    mc = proc.model_config
    norm_dir = proc.paths.normalized_data_dir()
    codes_dir = proc.paths.cleaned_data_dir()
    composites = flatten_params(
        mc.train.params or {},
        proc.resolve(mc.train.grid_config_file)
        if mc.train.grid_config_file else None,
    )
    if len(composites) > 1 or (mc.train.num_k_fold or -1) > 0:
        raise ShifuError(
            ErrorCode.INVALID_MODEL_CONFIG,
            "WDL grid search / k-fold need the in-memory trainer; raise "
            "-Dshifu.train.memoryBudgetMB or disable train.trainOnDisk",
        )
    (num_idx, num_names, cat_idx, cat_names, vocab_sizes,
     categories) = _wdl_column_mapping(proc, read_meta(norm_dir),
                                       read_meta(codes_dir))
    plan = build_norm_plan(mc, proc.column_configs)
    names = set(num_names)
    dense_specs = [spec_to_json(s) for s in plan.specs
                   if s.cc.column_name in names]
    proc.paths.ensure(proc.paths.models_dir())
    proc.paths.ensure(proc.paths.train_dir())
    bagging = max(1, int(mc.train.bagging_num or 1))
    log.info("WDL training STREAMED from %s + %s (%d member(s)) on %s",
             norm_dir, codes_dir, bagging, proc.device)
    checkpoints = proc._checkpoint_paths(bagging)
    for i in range(bagging):
        cfg = WDLTrainConfig.from_model_config(mc, trainer_id=i)
        cfg.checkpoint_every = proc._checkpoint_every()
        cfg.checkpoint_path = checkpoints[i]
        cfg.progress_cb = progress_writer(proc.paths.progress_path(i), i)
        init_flat = (_continuous_init(proc, i) if mc.train.is_continuous
                     else None)
        cc_base = getattr(proc, "coresident_cfg", None)
        if cc_base is not None:
            from dataclasses import replace as dc_replace

            from shifu_tpu_torch.coresident import train_wdl_coresident

            ccfg_i = dc_replace(
                cc_base, tenant=(cc_base.tenant if i == 0
                                 else f"{cc_base.tenant}-m{i}"))
            res = train_wdl_coresident(
                norm_dir, codes_dir, num_idx, cat_idx, vocab_sizes, cfg,
                ccfg=ccfg_i, init_flat=init_flat,
                resume=resume_requested(), device=proc.device)
        else:
            res = train_wdl_streamed(norm_dir, codes_dir, num_idx, cat_idx,
                                     vocab_sizes, cfg, init_flat=init_flat,
                                     resume=resume_requested(),
                                     device=proc.device,
                                     mesh=mesh_mod.train_mesh(proc.device))
        _save_wdl_member(proc, i, cfg, res, num_names, cat_names,
                         vocab_sizes, dense_specs, plan.cutoff, categories)

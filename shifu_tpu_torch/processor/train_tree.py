"""`shifu train` for GBT/RF — consumes the CleanedData bin codes
(counterpart of `shifu_tpu/processor/train_tree.py`).

Parity: TrainModelProcessor tree path (input = CleanedDataPath, not norm —
TrainModelProcessor.java:1366-1372) + DT param wiring (prepareDTParams:1312).
On cuda with more than one card the rows shard over every card
(`parallel.mesh.train_mesh`, JAX `processor/train_tree.py:125`); else
one device, the processor's. CleanedData past `shifu.train.memoryBudgetMB`, or
`train.trainOnDisk`, trains streamed shard by shard
(`train/streaming_tree.py`) with the same per-tree checkpoints.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np

from shifu_tpu_torch.norm.dataset import load_codes, read_meta
from shifu_tpu_torch.utils.errors import ErrorCode, ShifuError
from shifu_tpu_torch.utils.log import get_logger

log = get_logger(__name__)


def lowering_fingerprint(device, mesh=None) -> str:
    """The histogram lowering a run takes, for the checkpoint fingerprint:
    the CUDA kernel on the card, the plain PyTorch versions on the CPU,
    and the row shards of a mesh. They round GBT moment sums differently
    (and differ from the JAX package's lowerings), so a checkpoint from
    another lowering starts a fresh run instead of being grafted on."""
    out = "cuda" if device.type == "cuda" else "torch-plain"
    return out if mesh is None else f"{out}-mesh{mesh.size}"


def train_tree_models(proc, alg) -> None:
    """proc: TrainProcessor (already set up)."""
    from shifu_tpu_torch.models.tree import TreeModelSpec
    from shifu_tpu_torch.norm.normalizer import norm_columns
    from shifu_tpu_torch.parallel import mesh as mesh_mod
    from shifu_tpu_torch.processor.train_common import record_epoch
    from shifu_tpu_torch.resilience.checkpoint import atomic_write_json
    from shifu_tpu_torch.train.streaming import should_stream_training
    from shifu_tpu_torch.train.streaming_tree import train_trees_streamed
    from shifu_tpu_torch.train.tree_trainer import (TreeTrainConfig,
                                                    train_trees)

    mc = proc.model_config
    codes_dir = proc.paths.cleaned_data_dir()
    if not os.path.isdir(codes_dir):
        raise ShifuError(
            ErrorCode.DATA_NOT_FOUND, f"{codes_dir} — run `shifu norm` first"
        )
    stream = should_stream_training(codes_dir,
                                    force_attr=bool(mc.train.train_on_disk))
    mesh = mesh_mod.train_mesh(proc.device)
    if stream:
        # larger than memory: only the tags materialize; the code shards
        # stream once a level
        meta = read_meta(codes_dir)
        tags = np.concatenate([
            np.load(os.path.join(codes_dir, f"tags-{s:05d}.npy"))
            for s in range(len(meta.shard_rows))]).astype(np.float32)
        codes = weights = None
    else:
        meta, codes, tags, weights = load_codes(codes_dir)
        codes = np.asarray(codes, dtype=np.int32)
        tags = np.asarray(tags, dtype=np.float32)
        weights = np.asarray(weights, dtype=np.float32)
    slots = [int(s) for s in meta.extra["slots"]]

    cols = norm_columns(proc.column_configs)
    by_name = {c.column_name: c for c in cols}
    is_cat, boundaries, categories = [], [], []
    for name in meta.columns:
        cc = by_name.get(name)
        if cc is None:
            raise ShifuError(
                ErrorCode.DATA_NOT_FOUND,
                f"CleanedData column {name} is no longer selected in "
                f"ColumnConfig.json — re-run `shifu norm`",
            )
        # hybrid columns split like categoricals (their combined bin axis is
        # not totally ordered, so mean-sorted subset splits apply) but keep
        # BOTH binning tables so raw-record scoring can rebuild hybrid codes
        cat = cc.is_categorical() or cc.is_hybrid()
        is_cat.append(cat)
        boundaries.append(
            list(cc.column_binning.bin_boundary or [])
            if (not cc.is_categorical()) else None
        )
        categories.append(
            list(cc.column_binning.bin_category or []) if cat else None
        )

    suffix = proc._model_suffix(alg)
    proc.paths.ensure(proc.paths.models_dir())
    proc.paths.ensure(proc.paths.train_dir())
    bagging = max(1, int(mc.train.bagging_num or 1))

    # multi-class: ONEVSALL trains one binary forest per class (member k's
    # target is tag==k; eval thresholds per-class scores); NATIVE is
    # RF-only — per-class histogram counts, majority-vote leaves, per-tree
    # class votes at eval (TrainModelProcessor.java:341-349: "Only GBT and
    # RF and NN support OneVsAll", NATIVE "is supported in NN/RF").
    one_vs_all_tags = None
    if mc.is_multi_classification():
        if mc.train.is_one_vs_all():
            n_classes = len(mc.tags())
            if bagging not in (1, n_classes):
                log.warning("'train:baggingNum' overridden to %d for "
                            "ONEVSALL", n_classes)
            bagging = n_classes
            one_vs_all_tags = [
                (tags == k).astype(np.float32) for k in range(n_classes)
            ]
        elif alg.value not in ("RF", "DT"):
            raise ShifuError(
                ErrorCode.INVALID_MODEL_CONFIG,
                "NATIVE multi-class tree training is RF-only; use "
                "train.multiClassifyMethod=ONEVSALL for GBT "
                "(TrainModelProcessor.java:341-349)",
            )
        # RF NATIVE: tags stay class indices; TreeTrainConfig picks up
        # n_classes from the ModelConfig

    # data identity: a checkpoint built on a different binning (re-run
    # stats/norm) must not be grafted onto incompatible codes
    data_sig = hashlib.sha1(json.dumps(
        [list(meta.columns), [int(s) for s in slots], boundaries,
         categories], sort_keys=True, default=str
    ).encode()).hexdigest()

    for i in range(bagging):
        cfg = TreeTrainConfig.from_model_config(mc, trainer_id=i)
        progress_path = proc.paths.progress_path(i)

        def progress(k, tr, va, _p=progress_path, _i=i):
            record_epoch(_i, k, tr, va)
            if k % 10 == 0 or k == 1:
                with open(_p, "a") as fh:
                    fh.write(f"Trainer {_i} Tree #{k} Train Error:{tr:.8f} "
                             f"Validation Error:{va:.8f}\n")
                log.info("trainer %d tree %d train %.6f valid %.6f",
                         _i, k, tr, va)

        # ---- per-tree checkpoint + resume (DTMaster.doCheckPoint:637,
        # recovery :284-291): a killed run restarts from the last
        # checkpointed tree, bit-equal thanks to per-tree RNG streams ----
        ck_dir = proc.paths.ensure(proc.paths.checkpoint_dir(i))
        ck_path = os.path.join(ck_dir, "trees.ckpt")
        ck_state_path = ck_path + ".json"
        ck_every = max(1, int(mc.train.get_param("CheckpointInterval", 10)))
        # full hyperparameter fingerprint, the JAX package's keys: a
        # leftover checkpoint from a differently-configured run (or
        # another lowering) must NOT be silently grafted onto this one
        fingerprint = {
            "algorithm": cfg.algorithm, "loss": cfg.loss,
            "maxDepth": cfg.max_depth, "maxLeaves": cfg.max_leaves,
            "impurity": cfg.impurity, "learningRate": cfg.learning_rate,
            "dropoutRate": cfg.dropout_rate,
            "minInstancesPerNode": cfg.min_instances_per_node,
            "minInfoGain": cfg.min_info_gain,
            "featureSubsetStrategy": cfg.feature_subset_strategy,
            "baggingSampleRate": cfg.bagging_sample_rate,
            "baggingWithReplacement": cfg.bagging_with_replacement,
            "validSetRate": cfg.valid_set_rate, "seed": cfg.seed,
            "nClasses": cfg.n_classes,
            "histSubtraction": cfg.hist_subtraction,
            "maxStatsMemoryMB": cfg.max_stats_memory_mb,
            # the streamed trainer rounds GBT planes a shard at a time
            "pallasLowering": (lowering_fingerprint(proc.device, mesh)
                               + ("-streamed" if stream else "")),
            "oneVsAll": bool(mc.train.is_one_vs_all()),
            "dataSignature": data_sig,
        }
        init_trees = None
        init_val_errors = None
        if os.path.isfile(ck_path):
            try:
                ck_spec = TreeModelSpec.load(ck_path)
                state = {}
                if os.path.isfile(ck_state_path):
                    with open(ck_state_path) as fh:
                        state = json.load(fh)
                if state.get("fingerprint") != fingerprint:
                    log.warning("checkpoint %s was built with different "
                                "hyperparameters; starting fresh", ck_path)
                elif len(ck_spec.trees) < cfg.tree_num:
                    init_trees = ck_spec.trees
                    init_val_errors = state.get("validErrors")
                    log.info("resuming trainer %d from checkpoint: %d trees",
                             i, len(init_trees))
            except Exception as e:  # corrupt checkpoint: fresh start
                log.warning("cannot resume from %s (%s)", ck_path, e)

        # ---- isContinuous: GBT keeps adding trees up to TreeNum
        # (TrainModelProcessor.java:1166-1184); RF starts from scratch ----
        if init_trees is None and mc.train.is_continuous:
            model_path = proc.paths.model_path(i, suffix)
            if cfg.algorithm != "GBT":
                log.warning("RF doesn't support continuous training")
            elif os.path.isfile(model_path):
                try:
                    old = TreeModelSpec.load(model_path)
                    if old.loss != cfg.loss:
                        log.warning("Loss changed, continuous training "
                                    "disabled; starting from scratch")
                    elif len(old.trees) >= cfg.tree_num:
                        log.info("model %d already has %d >= TreeNum trees; "
                                 "skipping", i, len(old.trees))
                        continue
                    else:
                        init_trees = old.trees
                        log.info("continuous training: model %d grows from "
                                 "%d trees", i, len(init_trees))
                except Exception as e:  # corrupt model: fresh start, logged
                    log.warning("cannot continue from %s (%s)", model_path, e)

        def checkpoint(k, trees_now, val_errs, _ck=ck_path,
                       _state=ck_state_path, _every=ck_every,
                       _fp=fingerprint, _cfg=cfg):
            if k % _every == 0:
                TreeModelSpec(
                    algorithm=_cfg.algorithm, trees=list(trees_now),
                    input_columns=list(meta.columns),
                    slots=[int(s) for s in slots],
                    boundaries=boundaries, categories=categories,
                    loss=_cfg.loss, learning_rate=_cfg.learning_rate,
                ).save(_ck)
                # atomic: a kill between the spec write and this state
                # write already falls back to fresh-start (fingerprint
                # check), but a TORN state file must never crash resume
                atomic_write_json(_state, {"fingerprint": _fp,
                                           "validErrors": list(val_errs)})

        tags_i = one_vs_all_tags[i] if one_vs_all_tags is not None else tags
        resume_kw = dict(boundaries=boundaries, categories=categories,
                         progress_cb=progress, init_trees=init_trees,
                         init_valid_errors=init_val_errors,
                         checkpoint_cb=checkpoint, device=proc.device,
                         mesh=mesh)
        if stream:
            result = train_trees_streamed(
                codes_dir, slots, is_cat, meta.columns, cfg,
                tags_override=(tags_i if one_vs_all_tags is not None
                               else None), **resume_kw)
        else:
            result = train_trees(codes, tags_i, weights, slots, is_cat,
                                 meta.columns, cfg, **resume_kw)
        path = proc.paths.model_path(i, suffix)
        result.spec.save(path)
        for leftover in (ck_path, ck_state_path):
            if os.path.isfile(leftover):
                os.remove(leftover)  # completed: checkpoint no longer needed
        with open(proc.paths.val_error_path(i), "w") as fh:
            fh.write(f"{result.valid_error}\n")
        log.info("model %d (%s, %d trees) -> %s (valid err %.6f)",
                 i, cfg.algorithm, len(result.spec.trees), path,
                 result.valid_error)

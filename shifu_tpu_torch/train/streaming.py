"""Larger-than-memory NN/LR/SVM training (counterpart of
`shifu_tpu/train/streaming.py`), on one device or a mesh.

`should_stream_training` decides whether a data directory trains in
memory or streams shard by shard. `train_nn_streamed` is a full-batch
epoch over the NormalizedData shards: each shard's gradient (autograd of
the in-memory trainer's `_Net`, per shard) and its error sums add in
shard order, then ONE update through `updaters.py` — the NNMaster worker
sum with disk shards standing in for workers. `MiniBatchs` > 1 is
ignored with a warning, as in the JAX package. Every
`checkpoint_every` epochs a `StreamCheckpoint` holds the whole training
state (weights, optimizer state, learning rate, best-weights
bookkeeping), so a resumed run is bit-identical to an unbroken one; the
`epoch` fault seam fires before each epoch (`preempt@epoch=N`).

Per-shard sampling draws the JAX package's: shard s takes
`split_and_sample(rows_s, seed * 100_003 + s)`; k-fold passes
`sig_override`. Dropout draws from a `torch.Generator` seeded from the
seed and is not the JAX package's `jax.random` mask.
"""

from __future__ import annotations

import math
import os
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from shifu_tpu_torch.data.pipeline import prefetch_iter
from shifu_tpu_torch.models.nn import (flatten_params, init_params,
                                       unflatten_params)
from shifu_tpu_torch.norm.dataset import NormMeta, read_meta
from shifu_tpu_torch.obs import profile
from shifu_tpu_torch.parallel.mesh import (mesh_device, psum, replicate,
                                           shard_padded)
from shifu_tpu_torch.resilience import checkpoint as ckpt_mod
from shifu_tpu_torch.resilience import faults
from shifu_tpu_torch.train.nn_trainer import (NNTrainConfig, TrainResult,
                                              _layer_sizes, _Net,
                                              split_and_sample)
from shifu_tpu_torch.train.updaters import make_updater
from shifu_tpu_torch.utils import environment
from shifu_tpu_torch.utils.log import get_logger
from shifu_tpu_torch.utils.platform import DeviceLike

log = get_logger(__name__)

DEFAULT_TRAIN_BUDGET_MB = 1024


def train_memory_budget_bytes() -> int:
    """shifu.train.memoryBudgetMB — datasets whose normalized matrix exceeds
    it stream from shards instead of concatenating into one host array
    (the reference's trainOnDisk / MemoryDiskFloatMLDataSet envelope,
    shifuconfig:46-50)."""
    mb = environment.get_int("shifu.train.memoryBudgetMB",
                             DEFAULT_TRAIN_BUDGET_MB)
    return int(mb) * 1024 * 1024


def should_stream_training(data_dir: str, force_attr: bool = False) -> bool:
    if environment.get_property("shifu.train.forceStreaming", "") in (
        "true", "1",
    ):
        return True
    if force_attr:
        return True
    try:
        meta = read_meta(data_dir)
    except Exception:  # no shard meta yet: nothing on disk to stream
        return False
    n_cols = len(meta.columns)
    return meta.n_rows * n_cols * 4 > train_memory_budget_bytes()


def shard_path(data_dir: str, prefix: str, s: int) -> str:
    return os.path.join(data_dir, f"{prefix}-{s:05d}.npy")


def load_shard(data_dir: str, prefix: str, s: int, dtype,
               cols: Optional[List[int]] = None) -> np.ndarray:
    """Shard s of `prefix` in RAM (a column subset when given)."""
    a = np.load(shard_path(data_dir, prefix, s), mmap_mode="r")
    return np.array(a if cols is None else a[:, cols], dtype=dtype)


def shard_sigs(meta: NormMeta, data_dir: str, cfg, sig_override=None
               ) -> Tuple[List[Tuple[np.ndarray, np.ndarray]], float]:
    """Per-shard (train significance, valid significance), drawn once
    (AbstractNNWorker samples at load time), and the train size."""
    sigs = []
    offset = 0
    for s, rows in enumerate(meta.shard_rows):
        w = np.asarray(np.load(shard_path(data_dir, "weights", s),
                               mmap_mode="r"))
        if sig_override is not None:
            sig_t, sig_v = sig_override(s, rows, offset, w)
        else:
            cfg_s = type(cfg)(**{**cfg.__dict__,
                                 "seed": cfg.seed * 100_003 + s})
            sig, valid = split_and_sample(rows, cfg_s)
            sig_t, sig_v = sig * w, valid.astype(np.float32) * w
        sigs.append((np.asarray(sig_t, np.float32),
                     np.asarray(sig_v, np.float32)))
        offset += rows
    nts = float(max(sum(float((st > 0).sum()) for st, _ in sigs), 1.0))
    return sigs, nts


class ShardFeed:
    """The NormalizedData shards of one data dir, an epoch at a time:
    (x, t, sig_t, sig_v) on the device a shard, shard s + 1 read on the
    prefetch thread while shard s computes."""

    def __init__(self, data_dir: str, cfg: NNTrainConfig, device,
                 sig_override=None):
        self.data_dir = data_dir
        self.meta = read_meta(data_dir)
        self.n_shards = len(self.meta.shard_rows)
        self.device = device
        self._sig, self.n_train_size = shard_sigs(self.meta, data_dir, cfg,
                                                  sig_override)

    def _load_host(self, s: int):
        return (load_shard(self.data_dir, "features", s, np.float32),
                load_shard(self.data_dir, "tags", s, np.float32),
                *self._sig[s])

    def __iter__(self):
        for arrs in prefetch_iter(range(self.n_shards),
                                  transform=self._load_host):
            yield tuple(torch.from_numpy(a).to(self.device) for a in arrs)


def _stream_train_sha(cfg: NNTrainConfig, meta: NormMeta,
                      target_class: Optional[int],
                      ident_extra: Optional[dict] = None):
    """(sha, sections) of a streamed run: the hyperparameters in `train`,
    the shard layout in `data`, and `ident_extra` (a retrain's warm-start
    parent) in `loop`, so a snapshot of another parent rejects naming
    that section."""
    sections = {
        "train": {k: v for k, v in cfg.__dict__.items()
                  if not callable(v) and k != "progress_cb"},
        "data": {"shardRows": list(meta.shard_rows),
                 "columns": list(meta.columns),
                 "targetClass": target_class},
    }
    if ident_extra:
        sections["loop"] = dict(ident_extra)
    return ckpt_mod.sectioned_sha(sections)


class StreamedLoop:
    """The epoch loop both streamed trainers share: sum the shard
    gradients and error sums, keep the pre-update weights when the valid
    error improves, one update, the checkpoint. `shard_grad(flats,
    pieces, add) -> (g [1, n_flat], tr_sum, va_sum, tr_w, va_w)` of one
    file shard: `pieces` its rows, one piece on one device, or on a mesh
    padded with zero significance and split into one piece a mesh shard
    (JAX `ShardFeed(mesh=)`), each with its device's copy of the weights
    in `flats`; `add` adds the pieces' partials on the lead device in
    piece order."""

    def __init__(self, cfg, feed, shard_grad: Callable, apply_update,
                 init_state, flat0: np.ndarray, dev: torch.device,
                 ck: Optional[ckpt_mod.StreamCheckpoint], resume: bool,
                 decay: float = 0.0, convergence: float = 0.0, mesh=None):
        self.cfg, self.feed, self.dev = cfg, feed, dev
        self.mesh = mesh
        self.shard_grad, self.apply_update = shard_grad, apply_update
        self.decay, self.convergence = decay, convergence
        self.flat = torch.as_tensor(flat0, device=dev)[None]
        self.opt = init_state(1, flat0.size, dev)
        self.lr = float(cfg.learning_rate)
        self.best_val = math.inf
        self.best_flat = self.flat.clone()
        self.bad = 0
        self.tr_e = self.va_e = 0.0
        self.it_done = 0
        self.nts = torch.tensor([feed.n_train_size], dtype=torch.float32,
                                device=dev)
        self.ck = ck
        if ck is not None and resume:
            loaded = ck.load()
            if loaded is not None:
                self._restore(*loaded[1:3])
                faults.survived("preempt")
                log.info("resuming streamed train at epoch %d",
                         self.it_done)

    def _restore(self, arrays: dict, meta: dict) -> None:
        def dev(a):
            return torch.as_tensor(np.asarray(a), device=self.dev)

        self.flat = dev(arrays["flat"])
        self.best_flat = dev(arrays["bestFlat"])
        self.opt = {k[len("opt_"):]: dev(v) for k, v in arrays.items()
                    if k.startswith("opt_")}
        self.it_done = int(meta["epoch"])
        self.lr = float(meta["lr"])
        self.best_val = float(meta["bestVal"])
        self.bad = int(meta["bad"])
        self.tr_e, self.va_e = float(meta["trE"]), float(meta["vaE"])

    def _save(self) -> None:
        arrays = {"flat": self.flat.cpu().numpy(),
                  "bestFlat": self.best_flat.cpu().numpy()}
        arrays.update({f"opt_{k}": v.cpu().numpy()
                       for k, v in self.opt.items()})
        self.ck.save(self.it_done, arrays=arrays, meta={
            "epoch": self.it_done, "lr": self.lr, "bestVal": self.best_val,
            "bad": self.bad, "trE": self.tr_e, "vaE": self.va_e})
        ckpt_mod.atomic_save_npy(self.cfg.checkpoint_path,
                                 self.flat[0].cpu().numpy())

    def _add(self, parts: List[torch.Tensor]) -> torch.Tensor:
        return parts[0] if self.mesh is None else psum(parts, self.mesh)

    def epoch(self) -> None:
        sums = g_sum = None
        for shard in self.feed:
            if self.mesh is None:
                flats, pieces = [self.flat], [shard]
            else:
                flats = replicate(self.flat, self.mesh)
                pieces = list(zip(*(shard_padded(a, self.mesh)
                                    for a in shard)))
            g, *s = self.shard_grad(flats, pieces, self._add)
            if g_sum is None:
                g_sum, sums = g, s
            else:
                g_sum = g_sum + g
                sums = [a + b for a, b in zip(sums, s)]
        tr_sum, va_sum, tr_w, va_w = sums
        self.tr_e = float(tr_sum / torch.clamp_min(tr_w, 1.0))
        self.va_e = float(va_sum / torch.clamp_min(va_w, 1.0))
        if self.va_e < self.best_val:  # measured on the pre-update weights
            self.best_val = self.va_e
            self.best_flat = self.flat
            self.bad = 0
        else:
            self.bad += 1
        lr = torch.tensor([self.lr], dtype=torch.float32, device=self.dev)
        it = torch.tensor([self.it_done + 1], dtype=torch.int32,
                          device=self.dev)
        self.flat, self.opt = self.apply_update(self.opt, self.flat, g_sum,
                                                lr, it, self.nts)
        self.lr *= 1.0 - self.decay
        self.it_done += 1

    def run(self) -> None:
        cfg = self.cfg
        every = cfg.checkpoint_every
        while self.it_done < cfg.num_epochs:
            # SIGTERM-analog seam: -Dshifu.faults=preempt@epoch=N stops
            # the run between epochs, after the last snapshot landed
            faults.fault_point("epoch")
            self.epoch()
            if every and self.it_done % every == 0:
                if cfg.progress_cb:
                    cfg.progress_cb(self.it_done, self.tr_e, self.va_e)
                if self.ck is not None:
                    self._save()
            if cfg.early_stop_window and self.bad >= cfg.early_stop_window:
                log.info("streamed early stop at epoch %d", self.it_done)
                break
            if self.convergence and \
                    (self.tr_e + self.va_e) / 2.0 <= self.convergence:
                break
        if self.ck is not None:
            self.ck.clear()  # completed: nothing left to resume

    def chosen(self) -> Tuple[np.ndarray, float]:
        """(weights, valid error): the best pre-update weights when a
        valid set exists, else the final ones."""
        use_best = self.cfg.valid_set_rate > 0 and math.isfinite(
            self.best_val)
        flat = self.best_flat if use_best else self.flat
        return (flat[0].cpu().numpy(),
                self.best_val if use_best else self.va_e)


def _nn_shard_grad(cfg: NNTrainConfig, shapes, target_class, dev):
    net = _Net(cfg, shapes)
    gen = None
    if cfg.dropout_rate > 0.0:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(cfg.seed))
    keep = 1.0 - cfg.dropout_rate

    def shard_grad(flats, pieces, add):
        rows = sum(p[0].shape[0] for p in pieces)
        masks = None
        if gen is not None:  # one draw a file shard, a piece its rows
            masks = [torch.rand((1, rows, h), generator=gen,
                                device=dev) < keep
                     for h in cfg.hidden_nodes]
        gs, sums, a = [], [], 0
        for flat, (x, t, sig_t, sig_v) in zip(flats, pieces):
            n = x.shape[0]
            if target_class is not None:  # ONEVSALL member: tag == class
                t = (t == float(target_class)).to(torch.float32)
            ms = (None if masks is None
                  else [m[:, a:a + n].to(x.device) for m in masks])
            g, p = net.descent(flat, x, t, sig_t[None], ms)
            if ms is not None:  # errors without dropout
                with torch.no_grad():
                    p = net.forward(flat, x)
            sq = net.sq_error(p, t)[0]
            gs.append(g)
            sums.append(((sig_t * sq).sum(), (sig_v * sq).sum(),
                         sig_t.sum(), sig_v.sum()))
            a += n
        tr, va, tr_w, va_w = (add(list(col)) for col in zip(*sums))
        # the JAX shard program's weighted means times their weights
        tr = tr / torch.clamp_min(tr_w, 1.0) * tr_w
        va = va / torch.clamp_min(va_w, 1.0) * va_w
        return add(gs), tr, va, tr_w, va_w

    return shard_grad


def train_nn_streamed(
    data_dir: str,
    cfg: NNTrainConfig,
    init_flat: Optional[np.ndarray] = None,
    target_class: Optional[int] = None,
    sig_override=None,
    resume: bool = False,
    device: DeviceLike = None,
    mesh=None,
    ident_extra: Optional[dict] = None,
) -> TrainResult:
    """Full-batch training streamed from the NormalizedData shards of
    `data_dir` on one device (`device=None` = cuda), or with each shard's
    rows split over the row shards of `mesh`. `target_class`
    trains the ONEVSALL member of that class; `sig_override(s, rows,
    offset, weights) -> (sig_t, sig_v)` replaces the per-shard draw
    (k-fold: membership by the global row index); `resume` continues
    from the member's stream checkpoint; `ident_extra` joins the
    checkpoint identity as its `loop` section."""
    mesh, dev = mesh_device(mesh, device)
    if cfg.mini_batchs > 1:
        log.warning("MiniBatchs=%d is ignored on the streamed path — each "
                    "epoch is one full-batch pass over the shards",
                    cfg.mini_batchs)
    feed = ShardFeed(data_dir, cfg, dev, sig_override=sig_override)
    flat0, shapes = flatten_params(init_params(
        _layer_sizes(len(feed.meta.columns), cfg), seed=cfg.seed,
        init=cfg.weight_init))
    if init_flat is not None and init_flat.size == flat0.size:
        flat0 = init_flat.astype(np.float32)
    init_state, apply_update = make_updater(
        cfg.propagation, momentum=cfg.momentum,
        reg=cfg.regularized_constant, reg_level=cfg.reg_level,
        adam_beta1=cfg.adam_beta1, adam_beta2=cfg.adam_beta2)
    ck = None
    if cfg.checkpoint_path and cfg.checkpoint_every:
        sha, sections = _stream_train_sha(cfg, feed.meta, target_class,
                                          ident_extra)
        ck = ckpt_mod.StreamCheckpoint(
            cfg.checkpoint_path + ".state" + ckpt_mod.CKPT_SUFFIX, sha,
            every=0, sections=sections)
    loop = StreamedLoop(cfg, feed,
                        profile.wrap("nn.shard_grad", _nn_shard_grad(
                            cfg, shapes, target_class, dev)),
                        apply_update, init_state, flat0, dev, ck, resume,
                        decay=cfg.learning_decay,
                        convergence=cfg.convergence_threshold, mesh=mesh)
    loop.run()
    chosen, valid = loop.chosen()
    log.info("streamed train done: %d epochs over %d shards, train %.6f "
             "valid %.6f", loop.it_done, feed.n_shards, loop.tr_e, valid)
    return TrainResult(params=unflatten_params(chosen, shapes),
                       train_error=loop.tr_e, valid_error=valid,
                       iterations=loop.it_done)

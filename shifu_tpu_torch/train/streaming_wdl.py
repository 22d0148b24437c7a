"""Larger-than-memory WDL: the dense and code shards stream each epoch
(counterpart of `shifu_tpu/train/streaming_wdl.py`), on one device or a
mesh.

The epoch gradient is the sum of per-shard gradients over row-aligned
(NormalizedData dense slice, CleanedData categorical slice) pairs —
`shifu norm` writes both in one pass — then one update, the streamed NN
trainer's loop (`train/streaming.StreamedLoop`). Full-batch semantics
are `train_wdl`'s; host memory holds one shard pair (and the prefetched
ones), the device one. The loss is the significance-weighted log loss
with the probability clipped to [1e-7, 1 - 1e-7], as in memory.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from shifu_tpu_torch.data.pipeline import prefetch_iter
from shifu_tpu_torch.models.wdl import (flatten_wdl, init_wdl_params,
                                        unflatten_members, wdl_forward,
                                        wdl_shapes)
from shifu_tpu_torch.norm.dataset import read_meta
from shifu_tpu_torch.parallel.mesh import mesh_device
from shifu_tpu_torch.resilience import checkpoint as ckpt_mod
from shifu_tpu_torch.train.streaming import (StreamedLoop, load_shard,
                                             shard_sigs)
from shifu_tpu_torch.train.updaters import make_updater
from shifu_tpu_torch.train.wdl_trainer import (LOG_EPS, WDLTrainConfig,
                                               WDLTrainResult, _host_params)
from shifu_tpu_torch.utils.log import get_logger
from shifu_tpu_torch.utils.platform import DeviceLike

log = get_logger(__name__)


class WDLShardFeed:
    """Row-aligned (dense, codes, tags, sig_t, sig_v) shard tuples on the
    device, read on the prefetch thread; the per-shard draws are the NN
    feed's."""

    def __init__(self, norm_dir: str, codes_dir: str, num_idx: List[int],
                 cat_idx: List[int], cfg: WDLTrainConfig, device):
        self.norm_dir, self.codes_dir = norm_dir, codes_dir
        self.num_idx, self.cat_idx = list(num_idx), list(cat_idx)
        self.meta = read_meta(norm_dir)
        if read_meta(codes_dir).shard_rows != self.meta.shard_rows:
            raise ValueError(
                "NormalizedData and CleanedData shards are not row-aligned "
                "— re-run `shifu norm`")
        self.n_shards = len(self.meta.shard_rows)
        self.device = device
        self._sig, self.n_train_size = shard_sigs(self.meta, norm_dir, cfg)

    def _load_host(self, s: int):
        return (load_shard(self.norm_dir, "features", s, np.float32,
                           self.num_idx),
                load_shard(self.codes_dir, "codes", s, np.int64,
                           self.cat_idx),
                load_shard(self.norm_dir, "tags", s, np.float32),
                *self._sig[s])

    def __iter__(self):
        for arrs in prefetch_iter(range(self.n_shards),
                                  transform=self._load_host):
            yield tuple(torch.from_numpy(a).to(self.device) for a in arrs)


def _wdl_shard_grad(cfg: WDLTrainConfig, shapes, n_cat: int):
    def piece_grad(flat, dense, codes, t, sig_t, sig_v):
        w = flat.detach().requires_grad_(True)
        with torch.enable_grad():
            p = wdl_forward(unflatten_members(w, shapes, n_cat), dense,
                            codes, cfg.activations)
            pc = torch.clamp(p, LOG_EPS, 1 - LOG_EPS)
            ll = -(t * torch.log(pc) + (1 - t) * torch.log(1 - pc))
            (grad,) = torch.autograd.grad(torch.sum(sig_t * ll), w)
        sq = (t - p.detach()[0]) ** 2
        return (-grad, (sig_t * sq).sum(), (sig_v * sq).sum(), sig_t.sum(),
                sig_v.sum())

    def shard_grad(flats, pieces, add):
        parts = [piece_grad(f, *p) for f, p in zip(flats, pieces)]
        return tuple(add(list(col)) for col in zip(*parts))

    return shard_grad


def _wdl_stream_sha(cfg: WDLTrainConfig, meta, num_idx: List[int],
                    cat_idx: List[int], vocab_sizes: List[int]) -> str:
    """Identity of a streamed WDL run: hyperparameters, shard layout,
    column split."""
    return ckpt_mod.config_sha({
        **{k: v for k, v in cfg.__dict__.items()
           if not callable(v) and k != "progress_cb"},
        "shardRows": list(meta.shard_rows),
        "numIdx": list(num_idx), "catIdx": list(cat_idx),
        "vocab": list(vocab_sizes)})


def train_wdl_streamed(
    norm_dir: str,
    codes_dir: str,
    num_idx: List[int],
    cat_idx: List[int],
    vocab_sizes: List[int],
    cfg: WDLTrainConfig,
    init_flat: Optional[np.ndarray] = None,
    resume: bool = False,
    device: DeviceLike = None,
    mesh=None,
) -> WDLTrainResult:
    """WDL trained from the shards of `norm_dir` (dense columns
    `num_idx`) and `codes_dir` (categorical columns `cat_idx`) on one
    device (`device=None` = cuda), or with each shard's rows split over
    the row shards of `mesh` (JAX `train_wdl_streamed(mesh=)`, rows
    only)."""
    mesh, dev = mesh_device(mesh, device)
    feed = WDLShardFeed(norm_dir, codes_dir, num_idx, cat_idx, cfg, dev)
    template = init_wdl_params(len(num_idx), vocab_sizes, cfg.embed_dim,
                               cfg.hidden, seed=cfg.seed)
    flat0 = flatten_wdl(template)
    if init_flat is not None and init_flat.size == flat0.size:
        flat0 = init_flat.astype(np.float32)
    init_state, apply_update = make_updater(
        cfg.optimizer if cfg.optimizer != "GD" else "B", momentum=0.0,
        reg=cfg.l2_reg, reg_level="L2" if cfg.l2_reg else "NONE")
    ck = None
    if cfg.checkpoint_path and cfg.checkpoint_every:
        ck = ckpt_mod.StreamCheckpoint(
            cfg.checkpoint_path + ".state" + ckpt_mod.CKPT_SUFFIX,
            _wdl_stream_sha(cfg, feed.meta, num_idx, cat_idx, vocab_sizes),
            every=0)
    loop = StreamedLoop(cfg, feed,
                        _wdl_shard_grad(cfg, wdl_shapes(template),
                                        len(template.embed)),
                        apply_update, init_state, flat0, dev, ck, resume,
                        mesh=mesh)
    loop.run()
    chosen, valid = loop.chosen()
    log.info("streamed WDL done: %d epochs over %d shards, train %.6f "
             "valid %.6f", loop.it_done, feed.n_shards, loop.tr_e, valid)
    return WDLTrainResult(params=_host_params(chosen, template),
                          train_error=loop.tr_e, valid_error=valid,
                          iterations=loop.it_done)

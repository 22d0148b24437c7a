"""WDL trainer on one device (counterpart of
`shifu_tpu/train/wdl_trainer.py`).

The NN trainer's harness over the flattened wide & deep parameter vector:
bagging members, grid trials and k-fold folds are rows of one
[M, n_flat] weight tensor and train together in one epoch loop; a single
model is the loop with M = 1. The carry is the NN trainer's `_Members`
(flat, opt, it, lr, best_val, best_flat, bad, halt, tr, va, all on the
device); the host reads it only at a segment's end (the checkpoint
cadence, or every HALT_CHECK_EVERY epochs when a member can halt).

Parity: wdl/WDLMaster.java:65 (the master merges gradients and steps)
and wdl/WDLWorker.java (per-record forward and backward) become one
autograd pass over the whole matrix; the optimizer set
(wdl/optimization/*) is `train/updaters.py`, GD as back propagation
without momentum. The loss is the significance-weighted log loss with
the probability clipped to [1e-7, 1 - 1e-7]; g = -dE/dw summed over
records; the train and valid errors are the significance-weighted MSE
of the pre-update probability; `best_flat` keeps the pre-update weights
when the valid error improves; the window halt freezes a member.

`mesh=` shards the rows over a `parallel.mesh.Mesh` (the NN loop's
shards; each shard's gathers keep the fixed-order backward of one
device). The JAX package's `model` axis (embedding tables sharded over
devices) waits for ROADMAP A.13.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from shifu_tpu_torch.models.wdl import (
    WDLParams,
    flatten_wdl,
    init_wdl_params,
    unflatten_members,
    unflatten_wdl,
    wdl_forward,
    wdl_shapes,
)
from shifu_tpu_torch.obs import profile
from shifu_tpu_torch.parallel.mesh import mesh_device, shard_padded
from shifu_tpu_torch.resilience.checkpoint import atomic_save_npy
from shifu_tpu_torch.train import nn_trainer
from shifu_tpu_torch.train.nn_trainer import (
    _as_device,
    _device_split_and_sample,
    _Members,
    run_segments,
)
from shifu_tpu_torch.train.updaters import make_updater
from shifu_tpu_torch.utils.log import get_logger
from shifu_tpu_torch.utils.platform import DeviceLike

log = get_logger(__name__)

LOG_EPS = 1e-7  # the probability's clip inside the log loss


@dataclass
class WDLTrainConfig:
    hidden: List[int] = field(default_factory=lambda: [100, 50])
    activations: List[str] = field(default_factory=lambda: ["relu", "relu"])
    embed_dim: int = 8
    learning_rate: float = 0.005
    optimizer: str = "ADAM"
    l2_reg: float = 0.0
    num_epochs: int = 100
    valid_set_rate: float = 0.2
    bagging_sample_rate: float = 1.0
    bagging_with_replacement: bool = False
    early_stop_window: int = 0
    seed: int = 0
    checkpoint_every: int = 0
    checkpoint_path: Optional[str] = None
    progress_cb: Optional[Callable] = None

    @classmethod
    def from_model_config(cls, mc, trainer_id: int = 0) -> "WDLTrainConfig":
        t = mc.train

        def g(key, default):
            v = t.get_param(key, default)
            return default if v is None else v

        return cls(
            hidden=[int(x) for x in g("NumHiddenNodes", [100, 50])],
            activations=[str(a) for a in g("ActivationFunc", ["relu", "relu"])],
            embed_dim=int(g("EmbedOutputs", 8)),
            learning_rate=float(g("LearningRate", 0.005)),
            optimizer=str(g("Optimizer", "ADAM")).upper(),
            l2_reg=float(g("L2Reg", 0.0) or g("RegularizedConstant", 0.0)),
            num_epochs=int(t.num_train_epochs or 100),
            valid_set_rate=float(t.valid_set_rate or 0.0),
            bagging_sample_rate=float(t.bagging_sample_rate or 1.0),
            bagging_with_replacement=bool(t.bagging_with_replacement),
            early_stop_window=int(g("EarlyStopWindowSize", 0)),
            seed=trainer_id * 1000 + 23,
        )


@dataclass
class WDLTrainResult:
    params: WDLParams
    train_error: float
    valid_error: float
    iterations: int


class _Loop(nn_trainer._Loop):
    """The epochs of M members on one device (the JAX `one_iter` under
    the vmapped `while_loop`), or over a mesh's row shards (the NN loop's
    `_sum` and `_flats`: a shard's gradient and error sums on its rows,
    added on the lead device in shard order); `run` is the NN loop's."""

    def __init__(self, cfg: WDLTrainConfig, shapes, n_cat: int, dense,
                 codes, t, sig_t, sig_v, nts: torch.Tensor, mesh=None):
        self.cfg = cfg
        self.shapes, self.n_cat = shapes, n_cat
        self.mesh = mesh
        self.parts = (list(zip(dense, codes, t, sig_t, sig_v))
                      if mesh is not None
                      else [(dense, codes, t, sig_t, sig_v)])
        self.nts = nts
        self.den_t = torch.clamp_min(
            self._sum([p[3].sum(dim=-1) for p in self.parts]), 1.0)
        self.den_v = torch.clamp_min(
            self._sum([p[4].sum(dim=-1) for p in self.parts]), 1.0)
        self.init_state, self.apply_update = make_updater(
            cfg.optimizer if cfg.optimizer != "GD" else "B", momentum=0.0,
            reg=cfg.l2_reg, reg_level="L2" if cfg.l2_reg else "NONE")
        self.can_halt = cfg.early_stop_window > 0

    def descent(self, flat: torch.Tensor, dense=None, codes=None, t=None,
                sig_t=None):
        """(g = -dE/dw [M, n_flat], the probability [M, n] detached) of
        one part's rows (default: the one device's)."""
        if dense is None:
            dense, codes, t, sig_t, _sv = self.parts[0]
        w = flat.detach().requires_grad_(True)
        with torch.enable_grad():
            p = wdl_forward(unflatten_members(w, self.shapes, self.n_cat),
                            dense, codes, self.cfg.activations)
            pc = torch.clamp(p, LOG_EPS, 1 - LOG_EPS)
            ll = -(t * torch.log(pc) + (1 - t) * torch.log(1 - pc))
            (grad,) = torch.autograd.grad(torch.sum(sig_t * ll), w)
        return -grad, p.detach()

    def _terms(self, flat: torch.Tensor):
        """(g = -dE/dw [M, n_flat] summed over the shards, the train and
        valid errors [M])."""
        gs, trs, vas = [], [], []
        for f, (dense, codes, t, sig_t, sig_v) in zip(self._flats(flat),
                                                      self.parts):
            g, p = self.descent(f, dense, codes, t, sig_t)
            sq = (t - p) ** 2
            gs.append(g)
            trs.append((sig_t * sq).sum(dim=-1))
            vas.append((sig_v * sq).sum(dim=-1))
        return (self._sum(gs), self._sum(trs) / self.den_t,
                self._sum(vas) / self.den_v)

    def epoch(self, c: _Members, e: int = 0) -> None:
        g, tr, va = self._terms(c.flat)
        new_flat, new_opt = self.apply_update(c.opt, c.flat, g, c.lr,
                                              c.it + 1, self.nts)
        improved = va < c.best_val
        best_val = torch.where(improved, va, c.best_val)
        # va was measured on the PRE-update weights: keep those as best
        best_flat = torch.where(improved[:, None], c.flat, c.best_flat)
        bad = torch.where(improved, torch.zeros_like(c.bad), c.bad + 1)
        halt = (bad >= self.cfg.early_stop_window if self.can_halt
                else torch.zeros_like(c.halt))
        # a halted member is frozen
        act = ~c.halt
        col = act[:, None]
        c.flat = torch.where(col, new_flat, c.flat)
        c.opt = {k: torch.where(col, v, c.opt[k]) for k, v in new_opt.items()}
        c.it = torch.where(act, c.it + 1, c.it)
        c.best_val = torch.where(act, best_val, c.best_val)
        c.best_flat = torch.where(col, best_flat, c.best_flat)
        c.bad = torch.where(act, bad, c.bad)
        c.halt = torch.where(act, halt, c.halt)
        c.tr = torch.where(act, tr, c.tr)
        c.va = torch.where(act, va, c.va)


def _train_members(cfg: WDLTrainConfig, template: WDLParams,
                   flat0s: List[np.ndarray], dense, codes, t, sig_t, sig_v,
                   ntss: Sequence[float], lrs: Sequence[float],
                   report: Optional[Callable[[_Members], None]],
                   dev: torch.device, mesh=None) -> _Members:
    """Train M members; `report(carry)` at every checkpoint segment's end
    (cfg.checkpoint_every > 0). On a mesh the rows pad with zero
    significance and split over its shards."""
    if mesh is not None:
        dense, codes, t = (shard_padded(a, mesh) for a in (dense, codes, t))
        sig_t, sig_v = (shard_padded(sig_t, mesh, axis=1),
                        shard_padded(sig_v, mesh, axis=1))
    loop = _Loop(cfg, wdl_shapes(template), len(template.embed), dense,
                 codes, t, sig_t, sig_v,
                 torch.as_tensor(np.asarray(ntss, np.float32), device=dev),
                 mesh)
    flat0 = torch.as_tensor(np.stack(flat0s).astype(np.float32), device=dev)
    m, n_flat = flat0.shape
    c = _Members(flat0, loop.init_state(m, n_flat, dev),
                 torch.as_tensor(np.asarray(lrs, np.float32), device=dev))
    run_segments(loop, c, cfg.num_epochs, cfg.checkpoint_every, report)
    return c


def _inputs(dense, codes, tags, dev):
    return (_as_device(dense, torch.float32, dev),
            _as_device(codes, torch.int64, dev),
            _as_device(tags, torch.float32, dev))


def _host_params(flat: np.ndarray, template: WDLParams) -> WDLParams:
    p = unflatten_wdl(np.array(flat, dtype=np.float32), template)
    return WDLParams(embed=list(p.embed), wide=list(p.wide),
                     wide_dense=p.wide_dense,
                     dense_layers=[dict(layer) for layer in p.dense_layers],
                     bias=p.bias)


def train_wdl(
    dense,
    codes,
    tags,
    weights,
    vocab_sizes: List[int],
    cfg: WDLTrainConfig,
    init_flat: Optional[np.ndarray] = None,
    device: DeviceLike = None,
    mesh=None,
) -> WDLTrainResult:
    """One WDL model on one device (`device=None` = cuda), or over the
    row shards of `mesh` (rows only; JAX `train_wdl(mesh=)` without the
    `model` axis). dense [n, Dn] f32, codes [n, Dc], tags [n] {0,1},
    weights [n]: numpy arrays or tensors (tensors already on the device
    stay there). `init_flat` resumes continuous training from existing
    weights."""
    mesh, dev = mesh_device(mesh, device)
    n = dense.shape[0]
    template = init_wdl_params(dense.shape[1], vocab_sizes, cfg.embed_dim,
                               cfg.hidden, seed=cfg.seed)
    flat0 = flatten_wdl(template)
    if init_flat is not None and init_flat.size == flat0.size:
        flat0 = init_flat.astype(np.float32)
    d, c_, t = _inputs(dense, codes, tags, dev)
    sig_d, valid_d, nts = _device_split_and_sample(n, cfg, dev)
    w = _as_device(weights, torch.float32, dev)
    sig_t, sig_v = (sig_d * w)[None], (valid_d * w)[None]

    def report(c: _Members):
        it = int(c.it[0])
        if cfg.progress_cb:
            cfg.progress_cb(it, float(c.tr[0]), float(c.va[0]))
        if cfg.checkpoint_path:
            atomic_save_npy(cfg.checkpoint_path, c.flat[0].cpu().numpy())

    with profile.scaled(cfg.num_epochs):
        c = profile.dispatch(
            "wdl.train_program", _train_members, cfg, template, [flat0], d,
            c_, t, sig_t, sig_v, [nts], [cfg.learning_rate], report, dev,
            mesh, sync=True)
    # one host read for all scalars
    it_n, bv, tr_h, va_h = torch.stack([
        c.it[0].to(torch.float32), c.best_val[0], c.tr[0], c.va[0]]).tolist()
    use_best = cfg.valid_set_rate > 0 and math.isfinite(bv)
    chosen = (c.best_flat[0] if use_best else c.flat[0]).cpu().numpy()
    final_valid = float(bv) if use_best else float(va_h)
    log.info("wdl train done: %d iterations, train_err %.6f valid_err %.6f",
             int(it_n), tr_h, final_valid)
    return WDLTrainResult(params=_host_params(chosen, template),
                          train_error=float(tr_h), valid_error=final_valid,
                          iterations=int(it_n))


def train_wdl_bagged(
    dense,
    codes,
    tags,
    weights,
    vocab_sizes: List[int],
    base_cfg: WDLTrainConfig,
    n_members: int,
    init_flats: Optional[List[Optional[np.ndarray]]] = None,
    member_lrs: Optional[List[float]] = None,
    member_sigs: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    checkpoint_paths: Optional[List[str]] = None,
    device: DeviceLike = None,
    mesh=None,
) -> List[WDLTrainResult]:
    """All bagging members / grid trials / k-folds in one member loop (the
    reference fans WDL bagging out as Guagua jobs exactly like NN,
    TrainModelProcessor.java:768-945 + prepareWDLParams :1474).

    Member i starts from seed base.seed + i*1000 (its init and its draws);
    the unflatten template is the base seed's. `member_lrs` batches grid
    trials that differ only in LearningRate; `member_sigs` (sig_train
    [M, n], sig_valid [M, n]) batches k-fold folds, which keep their final
    weights and final holdout error, with nts the COUNT of positive
    train significance. `mesh` shards the rows as in `train_wdl`."""
    mesh, dev = mesh_device(mesh, device)
    n = dense.shape[0]
    m = n_members
    template = init_wdl_params(dense.shape[1], vocab_sizes,
                               base_cfg.embed_dim, base_cfg.hidden,
                               seed=base_cfg.seed)
    w = _as_device(weights, torch.float32, dev)
    flat0s, sig_ts, sig_vs, ntss = [], [], [], []
    for i in range(m):
        seed_i = base_cfg.seed + i * 1000
        flat0 = flatten_wdl(init_wdl_params(
            dense.shape[1], vocab_sizes, base_cfg.embed_dim, base_cfg.hidden,
            seed=seed_i))
        init_i = (init_flats or [None] * m)[i]
        if init_i is not None and init_i.size == flat0.size:
            flat0 = init_i.astype(np.float32)
        flat0s.append(flat0)
        if member_sigs is not None:
            sig_ts.append(_as_device(member_sigs[0][i], torch.float32, dev))
            sig_vs.append(_as_device(member_sigs[1][i], torch.float32, dev))
            ntss.append(float(max((np.asarray(member_sigs[0][i]) > 0).sum(),
                                  1.0)))
        else:
            cfg_i = WDLTrainConfig(**{**base_cfg.__dict__, "seed": seed_i})
            sig_d, valid_d, nts_i = _device_split_and_sample(n, cfg_i, dev)
            sig_ts.append(sig_d * w)
            sig_vs.append(valid_d * w)
            ntss.append(nts_i)
    d, c_, t = _inputs(dense, codes, tags, dev)
    lrs = (list(member_lrs) if member_lrs is not None
           else [base_cfg.learning_rate] * m)

    last_reported = [-1] * m

    def report(c: _Members):
        its = c.it.tolist()
        trs, vas = c.tr.tolist(), c.va.tolist()
        flats = c.flat.cpu().numpy() if checkpoint_paths else None
        for i in range(m):
            if its[i] == last_reported[i]:
                continue  # member already halted; don't re-report
            last_reported[i] = its[i]
            if base_cfg.progress_cb:
                base_cfg.progress_cb((i, its[i]), trs[i], vas[i])
            if checkpoint_paths and checkpoint_paths[i]:
                atomic_save_npy(checkpoint_paths[i], flats[i])

    with profile.scaled(base_cfg.num_epochs):
        c = profile.dispatch(
            "wdl.train_program_bagged", _train_members, base_cfg, template,
            flat0s, d, c_, t, torch.stack(sig_ts), torch.stack(sig_vs),
            ntss, lrs, report, dev, mesh, sync=True)
    flat_f, best_flat = c.flat.cpu().numpy(), c.best_flat.cpu().numpy()
    best_val, tr_e, va_e = (c.best_val.tolist(), c.tr.tolist(),
                            c.va.tolist())
    its = c.it.tolist()
    results = []
    for i in range(m):
        bv = float(best_val[i])
        use_best = (member_sigs is None and base_cfg.valid_set_rate > 0
                    and math.isfinite(bv))
        chosen = best_flat[i] if use_best else flat_f[i]
        results.append(WDLTrainResult(
            params=_host_params(chosen, template),
            train_error=float(tr_e[i]),
            valid_error=bv if use_best else float(va_e[i]),
            iterations=int(its[i]),
        ))
    log.info("wdl bagged train done: %d members in one loop, avg valid "
             "%.6f", m, float(np.mean([r.valid_error for r in results])))
    return results

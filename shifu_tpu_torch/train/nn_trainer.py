"""NN/LR/SVM trainer on one device or a mesh's row shards (counterpart
of `shifu_tpu/train/nn_trainer.py`).

What the reference spreads across NNMaster/NNWorker/Guagua (per-iteration
gradient exchange, master gradient sum, Weight update, early-stop halt
flag) is one epoch loop over a leading MEMBER axis: bagging members,
ONEVSALL classes, grid trials and k-fold folds are rows of one [M, n_flat]
weight tensor and train together; a single model is the loop with M = 1.

    worker gradients      -> torch.autograd over the whole matrix, or a
                             shard's rows a mesh shard, added on the
                             lead device in shard order (`_Loop`)
    master Weight update  -> updaters.make_updater on [M, n_flat]
    halt flag             -> a per-member bool tensor; a halted member is
                             frozen with torch.where (its `it`, weights and
                             errors stop changing), as the JAX package's
                             vmapped while_loop freezes it
    NNOutput checkpoints  -> host reads at segment ends only

The errors, `it` and `halt` stay on the device: the host reads them at a
segment's end (the checkpoint cadence, or every HALT_CHECK_EVERY epochs
when a member can halt), never once an epoch, so the card does not wait
on the host between epochs.

The gradient convention is Encog's: g = -dE/dw SUMMED over records
(NNMaster.java:240-249), the errors are significance-weighted means of
squared error (under log loss too; hinge passes through sigmoid first).
LR decay per iteration (NNMaster.java:267), window early stop
(earlystop/WindowEarlyStop.java:23), convergence threshold
(ConvergeAndValidToleranceEarlyStop.java:22), rotating mini-batch slices
(MiniBatchs), bagging/validation sampling (AbstractNNWorker.sampleWeights
:668) with the JAX package's numpy draws. LR is the same trainer with no
hidden layer and log loss; SVM the liblinear path (linear kernel,
L2-regularized hinge, reg = 1/C).

Dropout draws from a `torch.Generator` seeded from each member's seed: it
is not bit-equal to the JAX package's `jax.random` masks.
`mixed_precision` runs each matmul on bf16 operands with a bf16 product
cast to f32, as the JAX package's `matmul` does.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from shifu_tpu_torch.models.nn import (
    activation_fn,
    flatten_params,
    hidden_activation,
    init_params,
    unflatten_params,
)
from shifu_tpu_torch.parallel.mesh import (mesh_device, psum, replicate,
                                           shard_padded)
from shifu_tpu_torch.resilience.checkpoint import atomic_save_npy
from shifu_tpu_torch.train.updaters import make_updater
from shifu_tpu_torch.utils.log import get_logger
from shifu_tpu_torch.utils.platform import DeviceLike

log = get_logger(__name__)

# epochs between two host reads of the halt flags, when a member can halt
# and no checkpoint cadence is set
HALT_CHECK_EVERY = 16


@dataclass
class NNTrainConfig:
    hidden_nodes: List[int] = field(default_factory=lambda: [50])
    activations: List[str] = field(default_factory=lambda: ["tanh"])
    learning_rate: float = 0.1
    propagation: str = "Q"
    momentum: float = 0.5
    learning_decay: float = 0.0
    regularized_constant: float = 0.0
    reg_level: str = "NONE"  # NONE | L1 | L2 (RegulationLevel.java)
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    num_epochs: int = 100
    mini_batchs: int = 1  # epoch split count; 1 = full batch
    dropout_rate: float = 0.0
    loss: str = "squared"  # squared | log | absolute | hinge
    valid_set_rate: float = 0.2
    bagging_sample_rate: float = 1.0
    bagging_with_replacement: bool = False
    early_stop_window: int = 0  # 0 = disabled
    convergence_threshold: float = 0.0
    weight_init: str = "xavier"
    n_classes: int = 2  # >2 = NATIVE multi-class: one-hot ideal, K outputs
    seed: int = 0
    mixed_precision: bool = False  # bf16 matmul operands, f32 after
    checkpoint_every: int = 0
    checkpoint_path: Optional[str] = None
    progress_cb: Optional[Callable] = None

    @classmethod
    def from_model_config(cls, mc, trainer_id: int = 0) -> "NNTrainConfig":
        """Wire train.params the way TrainModelProcessor.prepareNNParams
        (TrainModelProcessor.java:1338) feeds NNMaster/Workers."""
        t = mc.train

        def g(key, default):
            v = t.get_param(key, default)
            return default if v is None else v

        alg = t.algorithm.value if hasattr(t.algorithm, "value") else str(t.algorithm)
        hidden = list(g("NumHiddenNodes", [50]))
        acts = [str(a) for a in g("ActivationFunc", ["tanh"])]
        if alg == "LR":
            hidden, acts = [], []
        if alg == "SVM":
            # liblinear parity (core/alg/SVMTrainer.java:38): linear
            # kernel only, L2-regularized hinge with Const -> C (reg=1/C).
            kernel = str(g("Kernel", "linear")).lower()
            if kernel != "linear":
                raise ValueError(
                    f"SVM Kernel={kernel!r} is not supported — the port "
                    "build trains the liblinear path (linear kernel); use "
                    "Kernel=linear or algorithm=NN")
            c_const = float(g("Const", 1.0))
            return cls(
                n_classes=2,
                hidden_nodes=[], activations=[], loss="hinge",
                learning_rate=float(g("LearningRate", 0.1)),
                propagation=str(g("Propagation", "Q")),
                reg_level="L2",
                regularized_constant=1.0 / max(c_const, 1e-12),
                num_epochs=int(t.num_train_epochs or 100),
                valid_set_rate=float(t.valid_set_rate or 0.0),
                bagging_sample_rate=float(t.bagging_sample_rate or 1.0),
                bagging_with_replacement=bool(t.bagging_with_replacement),
                early_stop_window=int(g("EarlyStopWindowSize", 0)),
                convergence_threshold=float(t.convergence_threshold or 0.0),
                seed=trainer_id * 1000 + 7,
            )
        # NATIVE multi-class: K output nodes, one-hot ideal (NNWorker.java:128);
        # ONEVSALL stays binary per trainer.
        n_classes = 2
        if mc.is_multi_classification() and not t.is_one_vs_all():
            n_classes = len(mc.tags())
        return cls(
            n_classes=n_classes,
            hidden_nodes=hidden,
            activations=acts,
            learning_rate=float(g("LearningRate", 0.1)),
            propagation=str(g("Propagation", "Q")),
            momentum=float(g("Momentum", 0.5)),
            learning_decay=float(g("LearningDecay", 0.0)),
            regularized_constant=float(g("RegularizedConstant", 0.0)),
            reg_level=str(g("L1orL2", "NONE")).upper(),
            adam_beta1=float(g("AdamBeta1", 0.9)),
            adam_beta2=float(g("AdamBeta2", 0.999)),
            num_epochs=int(t.num_train_epochs or 100),
            mini_batchs=max(1, int(g("MiniBatchs", 1))),
            dropout_rate=float(g("DropoutRate", 0.0)),
            loss=str(g("Loss", "log" if alg == "LR" else "squared")).lower(),
            valid_set_rate=float(t.valid_set_rate or 0.0),
            bagging_sample_rate=float(t.bagging_sample_rate or 1.0),
            bagging_with_replacement=bool(t.bagging_with_replacement),
            early_stop_window=int(g("EarlyStopWindowSize", 0)),
            convergence_threshold=float(t.convergence_threshold or 0.0),
            weight_init=str(g("WeightInitializer", "xavier")).lower(),
            seed=trainer_id * 1000 + 7,
        )


@dataclass
class TrainResult:
    params: List[Dict[str, np.ndarray]]
    train_error: float
    valid_error: float
    iterations: int


def split_and_sample(
    n: int, cfg: NNTrainConfig
) -> Tuple[np.ndarray, np.ndarray]:
    """(train significance multiplier [n], valid mask [n]) — the JAX
    package's draws (AbstractNNWorker.sampleWeights:668)."""
    rng = np.random.default_rng(cfg.seed)
    valid = rng.random(n) < cfg.valid_set_rate
    if cfg.bagging_with_replacement:
        sig = rng.poisson(cfg.bagging_sample_rate, size=n).astype(np.float32)
    else:
        sig = (rng.random(n) < cfg.bagging_sample_rate).astype(np.float32)
    sig[valid] = 0.0
    return sig, valid


# Device-resident sampling draws, keyed by everything that determines them
# (the device included): repeated runs on one dataset (grid members,
# benches, retrains) skip the host->device copy of two [n] f32 masks.
_SAMPLE_CACHE: Dict[tuple, tuple] = {}
_SAMPLE_CACHE_BYTES = 128 << 20


def _device_split_and_sample(n: int, cfg: NNTrainConfig,
                             dev: torch.device):
    """(sig [n] f32, valid_f [n] f32, n_train_size) on `dev`."""
    key = (str(dev), n, cfg.seed, round(float(cfg.valid_set_rate), 9),
           round(float(cfg.bagging_sample_rate), 9),
           bool(cfg.bagging_with_replacement))
    ent = _SAMPLE_CACHE.get(key)
    if ent is None:
        sig, valid = split_and_sample(n, cfg)
        # bound the cached BYTES, not the entry count
        cached = sum(e[0].numel() * 8 for e in _SAMPLE_CACHE.values())
        if cached + n * 8 > _SAMPLE_CACHE_BYTES:
            _SAMPLE_CACHE.clear()
        ent = (torch.as_tensor(sig, device=dev),
               torch.as_tensor(valid.astype(np.float32), device=dev),
               float(max(sig.sum(), 1.0)))
        _SAMPLE_CACHE[key] = ent
    return ent


def _as_device(a, dtype, dev: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=dev, dtype=dtype)
    a = np.asarray(a)
    if not a.flags.writeable:  # a memory-mapped shard: torch wants a copy
        a = a.copy()
    return torch.as_tensor(a, device=dev).to(dtype)


# ---------------------------------------------------------------------------
# the network over the member axis
# ---------------------------------------------------------------------------


class _Net:
    """Forward, loss, descent gradient and errors of M members at once:
    flat [M, n_flat] in the flat layout of `flatten_params`."""

    def __init__(self, cfg: NNTrainConfig, shapes: Sequence[Tuple[int, int]]):
        self.cfg = cfg
        self.shapes = [tuple(s) for s in shapes]
        self.n_hidden = len(cfg.hidden_nodes)
        # output width from the last layer; > 1 means NATIVE multi-class
        # (t holds class indices, the ideal is one-hot)
        self.out_dim = self.shapes[-1][1]
        # hinge = linear SVM: the raw decision value w.x + b, the loss
        # max(0, 1 - y f(x)) with y in {-1, +1}
        self.hinge = cfg.loss == "hinge"

    def layers(self, flat: torch.Tensor):
        """[(W [M, in, out], b [M, 1, out])], views of `flat`."""
        out, off, m = [], 0, flat.shape[0]
        for fi, fo in self.shapes:
            w = flat[:, off: off + fi * fo].view(m, fi, fo)
            off += fi * fo
            b = flat[:, off: off + fo].view(m, 1, fo)
            off += fo
            out.append((w, b))
        return out

    def matmul(self, h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.cfg.mixed_precision:  # bf16 operands, bf16 product -> f32
            return torch.matmul(h.to(torch.bfloat16),
                                w.to(torch.bfloat16)).to(torch.float32)
        return torch.matmul(h, w)

    def forward(self, flat, x, keep_masks=None) -> torch.Tensor:
        """x [rows, d] -> p [M, rows] (or [M, rows, K]). `keep_masks`
        (a list of [M, rows, h] bool, one a hidden layer) applies dropout."""
        layers = self.layers(flat)
        h = x
        rate = self.cfg.dropout_rate
        for i in range(self.n_hidden):
            w, b = layers[i]
            h = activation_fn(hidden_activation(self.cfg.activations, i))(
                self.matmul(h, w) + b)
            if keep_masks is not None:
                h = torch.where(keep_masks[i], h / (1.0 - rate),
                                torch.zeros_like(h))
        w, b = layers[-1]
        out = self.matmul(h, w) + b
        if not self.hinge:  # SVM keeps the raw decision value
            out = activation_fn("sigmoid")(out)
        return out if self.out_dim > 1 else out[..., 0]

    def ideal(self, t: torch.Tensor) -> torch.Tensor:
        """Binary t in {0,1}; multi-class t is the class index, the ideal
        one-hot over K sigmoid outputs (NNWorker.java:128)."""
        if self.out_dim > 1:
            return torch.nn.functional.one_hot(
                t.to(torch.int64), self.out_dim).to(torch.float32)
        return t

    def record_loss(self, p, ideal):
        if self.hinge:
            pm = 2.0 * ideal - 1.0  # {0,1} -> {-1,+1}
            return torch.clamp_min(1.0 - pm * p, 0.0)
        loss = self.cfg.loss
        if loss == "log":
            eps = 1e-7
            pc = torch.clamp(p, eps, 1 - eps)
            e = -(ideal * torch.log(pc) + (1 - ideal) * torch.log(1 - pc))
        elif loss == "absolute":
            e = torch.abs(ideal - p)
        else:
            e = 0.5 * (ideal - p) ** 2
        return e.sum(dim=-1) if self.out_dim > 1 else e

    def descent(self, flat, x, t, sig, keep_masks=None):
        """(g = -dE/dw summed over records [M, n_flat], p detached)."""
        w = flat.detach().requires_grad_(True)
        with torch.enable_grad():
            p = self.forward(w, x, keep_masks)
            total = torch.sum(sig * self.record_loss(p, self.ideal(t)))
            (grad,) = torch.autograd.grad(total, w)
        return -grad, p.detach()

    def sq_error(self, p, t):
        """Per-record squared error of the reported errors (Encog
        calculateError; the mean over the K outputs when K > 2)."""
        if self.hinge:
            p = activation_fn("sigmoid")(p)
        sq = (self.ideal(t) - p) ** 2
        return sq.mean(dim=-1) if self.out_dim > 1 else sq


def descent_gradient(cfg: NNTrainConfig, shapes, flat, x, t, sig
                     ) -> torch.Tensor:
    """The first epoch's descent direction g = -dE/dw of members `flat`
    [M, n_flat] over rows `x` [n, d] with targets `t` and significance
    `sig` [M, n], without dropout: the card's and the CPU's are held
    against each other directly."""
    g, _ = _Net(cfg, shapes).descent(flat, x, t, sig)
    return g


# ---------------------------------------------------------------------------
# the epoch loop
# ---------------------------------------------------------------------------


class _Members:
    """The loop's carry for M members, every field a device tensor:
    flat, opt, it, lr, best_val, best_flat, bad, halt, tr, va."""

    def __init__(self, flat0: torch.Tensor, opt0: dict, lrs: torch.Tensor):
        m, dev = flat0.shape[0], flat0.device
        self.flat = flat0
        self.opt = opt0
        self.it = torch.zeros(m, dtype=torch.int32, device=dev)
        self.lr = lrs
        self.best_val = torch.full((m,), math.inf, dtype=torch.float32,
                                   device=dev)
        self.best_flat = flat0
        self.bad = torch.zeros(m, dtype=torch.int32, device=dev)
        self.halt = torch.zeros(m, dtype=torch.bool, device=dev)
        self.tr = torch.zeros(m, dtype=torch.float32, device=dev)
        self.va = torch.zeros(m, dtype=torch.float32, device=dev)


class _Loop:
    """The epochs of M members on one device (the JAX `one_iter` under
    the vmapped `while_loop`), or over a mesh's row shards: there x, t,
    sig_t and sig_v are lists a shard (t and the significances split on
    their last, row, axis), each shard runs forward and backward on its
    rows with its device's copy of the weights, and the gradients and
    error sums add on the lead device in shard order, in f32 (the JAX
    psum); the update runs once there."""

    def __init__(self, cfg: NNTrainConfig, shapes, x, t, sig_t, sig_v,
                 nts: torch.Tensor, seeds: Sequence[int], mesh=None):
        self.cfg = cfg
        self.net = _Net(cfg, shapes)
        self.mesh = mesh
        self.parts = (list(zip(x, t, sig_t, sig_v)) if mesh is not None
                      else [(x, t, sig_t, sig_v)])
        self.lead = self.parts[0][0].device
        self.nts = nts
        sizes = [p[0].shape[0] for p in self.parts]
        self.starts = np.cumsum([0] + sizes[:-1]).tolist()
        self.rows = sum(sizes)
        self.n_batches = cfg.mini_batchs
        # ceil so rotating slices cover every row (the last slice overlaps
        # the tail instead of dropping rows % n_batches records)
        self.batch = (-(-self.rows // self.n_batches) if self.n_batches > 1
                      else self.rows)
        self.den_t = torch.clamp_min(
            self._sum([p[2].sum(dim=-1) for p in self.parts]), 1.0)
        self.den_v = torch.clamp_min(
            self._sum([p[3].sum(dim=-1) for p in self.parts]), 1.0)
        self.init_state, self.apply_update = make_updater(
            cfg.propagation, momentum=cfg.momentum,
            reg=cfg.regularized_constant, reg_level=cfg.reg_level,
            adam_beta1=cfg.adam_beta1, adam_beta2=cfg.adam_beta2)
        self.gens = None
        if cfg.dropout_rate > 0.0:
            self.gens = []
            for s in seeds:
                gen = torch.Generator(device=self.lead)
                gen.manual_seed(int(s))
                self.gens.append(gen)
        self.can_halt = (cfg.early_stop_window > 0
                         or cfg.convergence_threshold > 0.0)

    def _sum(self, parts: List[torch.Tensor]) -> torch.Tensor:
        """The shards' partials added on the lead device in shard order."""
        return parts[0] if self.mesh is None else psum(parts, self.mesh)

    def _flats(self, flat: torch.Tensor) -> List[torch.Tensor]:
        """The weights, one copy a shard's device."""
        return [flat] if self.mesh is None else replicate(flat, self.mesh)

    def _keep_masks(self, rows: int):
        if self.gens is None:
            return None
        keep = 1.0 - self.cfg.dropout_rate
        return [torch.stack([
            torch.rand((rows, h), generator=gen, device=self.lead) < keep
            for gen in self.gens]) for h in self.cfg.hidden_nodes]

    def _descent(self, flat, lo: int, hi: int, masks, full: bool):
        """(g [M, n_flat] of rows [lo, hi) of the whole set, summed over
        the shards; their predictions a shard when `full`, else None).
        `masks` cover the rows [lo, hi) on the lead device; a shard takes
        its part of them."""
        net = self.net
        gs, ps = [], []
        for f, a, (x, t, st, _sv) in zip(self._flats(flat), self.starts,
                                          self.parts):
            n = x.shape[0]
            lo_s, hi_s = min(max(lo - a, 0), n), min(max(hi - a, 0), n)
            ms = (None if masks is None else
                  [m[:, a + lo_s - lo:a + hi_s - lo].to(x.device)
                   for m in masks])
            g, p = net.descent(f, x[lo_s:hi_s], t[..., lo_s:hi_s],
                               st[:, lo_s:hi_s], ms)
            gs.append(g)
            ps.append(p)
        return self._sum(gs), (ps if full else None)

    def _forward(self, flat) -> List[torch.Tensor]:
        return [self.net.forward(f, p[0])
                for f, p in zip(self._flats(flat), self.parts)]

    def _errors(self, ps: List[torch.Tensor]):
        sqs = [self.net.sq_error(p, part[1]) for p, part in zip(ps,
                                                                 self.parts)]
        return (self._sum([(part[2] * sq).sum(dim=-1)
                           for sq, part in zip(sqs, self.parts)]) / self.den_t,
                self._sum([(part[3] * sq).sum(dim=-1)
                           for sq, part in zip(sqs, self.parts)]) / self.den_v)

    def epoch(self, c: _Members, e: int) -> None:
        """One epoch; every member not halted takes it (they share the
        epoch count `e`, so the mini-batch slice is a host integer)."""
        cfg = self.cfg
        masks = self._keep_masks(self.batch)
        if self.n_batches > 1:
            start = min((e % self.n_batches) * self.batch,
                        self.rows - self.batch)
            g, ps = self._descent(c.flat, start, start + self.batch, masks,
                                  full=False)
        else:
            g, ps = self._descent(c.flat, 0, self.rows, masks, full=True)
        if ps is None or masks is not None:
            with torch.no_grad():  # errors on the full data, no dropout
                ps = self._forward(c.flat)
        tr, va = self._errors(ps)
        new_flat, new_opt = self.apply_update(c.opt, c.flat, g, c.lr,
                                              c.it + 1, self.nts)
        improved = va < c.best_val
        best_val = torch.where(improved, va, c.best_val)
        # va was measured on the PRE-update weights: keep those as best
        best_flat = torch.where(improved[:, None], c.flat, c.best_flat)
        bad = torch.where(improved, torch.zeros_like(c.bad), c.bad + 1)
        halt = torch.zeros_like(c.halt)
        if cfg.early_stop_window > 0:
            halt = halt | (bad >= cfg.early_stop_window)
        if cfg.convergence_threshold > 0.0:
            halt = halt | ((tr + va) / 2.0 <= cfg.convergence_threshold)
        lr = c.lr * (1.0 - cfg.learning_decay)

        # a halted member is frozen
        act = ~c.halt
        col = act[:, None]
        c.flat = torch.where(col, new_flat, c.flat)
        c.opt = {k: torch.where(col, v, c.opt[k]) for k, v in new_opt.items()}
        c.it = torch.where(act, c.it + 1, c.it)
        c.lr = torch.where(act, lr, c.lr)
        c.best_val = torch.where(act, best_val, c.best_val)
        c.best_flat = torch.where(col, best_flat, c.best_flat)
        c.bad = torch.where(act, bad, c.bad)
        c.halt = torch.where(act, halt, c.halt)
        c.tr = torch.where(act, tr, c.tr)
        c.va = torch.where(act, va, c.va)

    def run(self, c: _Members, start: int, limit: int) -> int:
        """Epochs start..limit-1, stopping early once every member has
        halted (read every HALT_CHECK_EVERY epochs). Returns the epoch
        reached."""
        e = start
        while e < limit:
            stop = (min(e + HALT_CHECK_EVERY, limit) if self.can_halt
                    else limit)
            for ep in range(e, stop):
                self.epoch(c, ep)
            e = stop
            if self.can_halt and bool(c.halt.all()):
                break
        return e


def _train_members(cfg: NNTrainConfig, shapes, flat0s: List[np.ndarray],
                   x, t, sig_t, sig_v, ntss: Sequence[float],
                   lrs: Sequence[float], seeds: Sequence[int],
                   report: Optional[Callable[[_Members], None]],
                   dev: torch.device, mesh=None) -> _Members:
    """Train M members; `report(carry)` at every checkpoint segment's end
    (cfg.checkpoint_every > 0). On a mesh the rows (x's first axis, the
    last of t and the significances) pad with zero significance and
    split over its shards."""
    if mesh is not None:
        x = shard_padded(x, mesh)
        t = shard_padded(t, mesh, axis=-1 % t.dim())
        sig_t, sig_v = (shard_padded(sig_t, mesh, axis=1),
                        shard_padded(sig_v, mesh, axis=1))
    loop = _Loop(cfg, shapes, x, t, sig_t, sig_v,
                 torch.as_tensor(np.asarray(ntss, np.float32), device=dev),
                 seeds, mesh)
    flat0 = torch.as_tensor(np.stack(flat0s).astype(np.float32), device=dev)
    m, n_flat = flat0.shape
    c = _Members(flat0, loop.init_state(m, n_flat, dev),
                 torch.as_tensor(np.asarray(lrs, np.float32), device=dev))
    run_segments(loop, c, cfg.num_epochs, cfg.checkpoint_every, report)
    return c


def run_segments(loop, c: _Members, epochs: int, every: int,
                 report: Optional[Callable[[_Members], None]]) -> None:
    """`loop.run` over `epochs` epochs; with `every` > 0 in segments of
    that many, `report(c)` after each (progress and checkpoints between
    segments, NNOutput.postIteration:158)."""
    if not (every and every > 0):
        loop.run(c, 0, epochs)
        return
    e = 0
    while e < epochs:
        e = loop.run(c, e, min(e + every, epochs))
        if report is not None:
            report(c)
        if e >= epochs or bool(c.halt.all()):
            break


def _layer_sizes(d: int, cfg: NNTrainConfig) -> List[int]:
    out_dim = cfg.n_classes if cfg.n_classes > 2 else 1
    return [d] + list(cfg.hidden_nodes) + [out_dim]


def train_nn(
    features,
    tags,
    weights,
    cfg: NNTrainConfig,
    init_flat: Optional[np.ndarray] = None,
    device: DeviceLike = None,
    mesh=None,
) -> TrainResult:
    """Train one model on one device (`device=None` = cuda), or over the
    row shards of `mesh` (JAX `train_nn(mesh=)`: the draws on the
    unpadded rows, the rows then padded with zero significance). features
    [n, d] f32 (normalized), tags [n] {0,1} (class index when NATIVE),
    weights [n] significance; numpy arrays or tensors (tensors already on
    the device stay there)."""
    mesh, dev = mesh_device(mesh, device)
    n, d = features.shape
    params0 = init_params(_layer_sizes(d, cfg), seed=cfg.seed,
                          init=cfg.weight_init)
    flat0, shapes = flatten_params(params0)
    if init_flat is not None and init_flat.size == flat0.size:
        flat0 = init_flat.astype(np.float32)  # continuous training resume

    x = _as_device(features, torch.float32, dev)
    t = _as_device(tags, torch.float32, dev)
    w = _as_device(weights, torch.float32, dev)
    sig_d, valid_d, nts = _device_split_and_sample(n, cfg, dev)
    sig_t = (sig_d * w)[None]
    sig_v = (valid_d * w)[None]

    def report(c: _Members):
        it = int(c.it[0])
        if cfg.progress_cb:
            cfg.progress_cb(it, float(c.tr[0]), float(c.va[0]))
        if cfg.checkpoint_path:
            atomic_save_npy(cfg.checkpoint_path, c.flat[0].cpu().numpy())

    c = _train_members(cfg, shapes, [flat0], x, t, sig_t, sig_v, [nts],
                       [cfg.learning_rate], [cfg.seed], report, dev, mesh)
    # one host read for all scalars
    it_n, bv, tr_h, va_h = torch.stack([
        c.it[0].to(torch.float32), c.best_val[0], c.tr[0], c.va[0]]).tolist()
    it_n = int(it_n)
    final_valid = float(bv) if math.isfinite(bv) else float(va_h)
    use_best = cfg.valid_set_rate > 0 and math.isfinite(bv)
    chosen = c.best_flat[0] if use_best else c.flat[0]
    params = unflatten_params(chosen.cpu().numpy(), shapes)
    log.info("train done: %d iterations, train_err %.6f valid_err %.6f",
             it_n, tr_h, final_valid)
    return TrainResult(params=params, train_error=float(tr_h),
                       valid_error=final_valid, iterations=it_n)


def train_nn_bagged(
    features,
    tags,
    weights,
    base_cfg: NNTrainConfig,
    n_members: int,
    init_flats: Optional[List[Optional[np.ndarray]]] = None,
    member_seed: Callable[[int], int] = lambda i: i * 1000 + 7,
    checkpoint_paths: Optional[List[str]] = None,
    member_tags: Optional[np.ndarray] = None,
    member_lrs: Optional[List[float]] = None,
    member_sigs: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    device: DeviceLike = None,
    mesh=None,
) -> List[TrainResult]:
    """Train M members in one loop on the member axis (the reference fans
    bag members out as parallel Guagua jobs, TrainModelProcessor.java:
    768-945).

    `member_tags` [M, n] overrides the shared tags per member (ONEVSALL:
    trainer i's ideal is tag==i, NNWorker.java:116-120). `member_lrs` [M]
    gives each member its own learning rate (grid trials that differ only
    in it, gs/GridSearch.java:44). `member_sigs` (sig_train [M, n],
    sig_valid [M, n]) overrides the sampling (k-fold: fold i's sig_valid
    marks its held-out fold, TrainModelProcessor.java:947-969); those
    members keep their final weights and final holdout error. `mesh`
    shards the rows as in `train_nn`; each shard holds [M, rows_s]
    significances."""
    mesh, dev = mesh_device(mesh, device)
    n, d = features.shape
    sizes = _layer_sizes(d, base_cfg)
    shapes = None
    flat0s, sig_ts, sig_vs, ntss, seeds = [], [], [], [], []
    for i in range(n_members):
        seed_i = member_seed(i)
        seeds.append(seed_i)
        flat0, shapes = flatten_params(
            init_params(sizes, seed=seed_i, init=base_cfg.weight_init))
        init_i = (init_flats or [None] * n_members)[i]
        if init_i is not None and init_i.size == flat0.size:
            flat0 = init_i.astype(np.float32)
        flat0s.append(flat0)
        if member_sigs is not None:
            sig_ts.append(_as_device(member_sigs[0][i], torch.float32, dev))
            sig_vs.append(_as_device(member_sigs[1][i], torch.float32, dev))
            ntss.append(float(max((np.asarray(member_sigs[0][i]) > 0).sum(),
                                  1.0)))
        else:
            cfg_i = NNTrainConfig(**{**base_cfg.__dict__, "seed": seed_i})
            sig_d, valid_d, nts_i = _device_split_and_sample(n, cfg_i, dev)
            sig_ts.append(sig_d)
            sig_vs.append(valid_d)
            ntss.append(nts_i)

    x = _as_device(features, torch.float32, dev)
    t = _as_device(member_tags if member_tags is not None else tags,
                   torch.float32, dev)
    sig_t = torch.stack(sig_ts)
    sig_v = torch.stack(sig_vs)
    if member_sigs is None:
        w = _as_device(weights, torch.float32, dev)[None, :]
        sig_t, sig_v = sig_t * w, sig_v * w
    lrs = (list(member_lrs) if member_lrs is not None
           else [base_cfg.learning_rate] * n_members)

    last_reported = [-1] * n_members

    def report(c: _Members):
        its = c.it.tolist()
        trs, vas = c.tr.tolist(), c.va.tolist()
        flats = c.flat.cpu().numpy() if checkpoint_paths else None
        for i in range(n_members):
            if its[i] == last_reported[i]:
                continue  # member already halted; don't re-report
            last_reported[i] = its[i]
            if base_cfg.progress_cb:
                base_cfg.progress_cb((i, its[i]), trs[i], vas[i])
            if checkpoint_paths and checkpoint_paths[i]:
                atomic_save_npy(checkpoint_paths[i], flats[i])

    c = _train_members(base_cfg, shapes, flat0s, x, t, sig_t, sig_v, ntss,
                       lrs, seeds, report, dev, mesh)
    flat_f, best_flat = c.flat.cpu().numpy(), c.best_flat.cpu().numpy()
    best_val, tr_e, va_e = (c.best_val.tolist(), c.tr.tolist(),
                            c.va.tolist())
    its = c.it.tolist()
    results = []
    for i in range(n_members):
        bv = float(best_val[i])
        # k-fold stays an UNBIASED holdout: final weights and the
        # final-epoch holdout error (TrainModelProcessor.java:947-969)
        use_best = (member_sigs is None and base_cfg.valid_set_rate > 0
                    and math.isfinite(bv))
        chosen = best_flat[i] if use_best else flat_f[i]
        results.append(TrainResult(
            params=unflatten_params(chosen, shapes),
            train_error=float(tr_e[i]),
            valid_error=bv if use_best else float(va_e[i]),
            iterations=int(its[i]),
        ))
    log.info("bagged train done: %d members in one loop, avg valid %.6f",
             n_members, float(np.mean([r.valid_error for r in results])))
    return results

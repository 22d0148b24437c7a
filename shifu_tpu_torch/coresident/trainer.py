"""Co-resident epoch loops: NN/WDL retraining as a background tenant
(counterpart of `shifu_tpu/coresident/trainer.py`).

Two execution shapes behind one loop:

  stages=1          the DEGENERATE path — it calls the very shard
                    program of train/streaming.py (`_nn_shard_grad`) or
                    train/streaming_wdl.py (`_wdl_shard_grad`) under the
                    same seam name and folds gradients in the same
                    order, so `stages=1, microbatches=1` is
                    BIT-IDENTICAL to `train_nn_streamed` /
                    `train_wdl_streamed`. microbatches>1 slices each
                    shard into M row groups and folds them SEQUENTIALLY
                    in m order.
  stages=K>=2       the pipeline: per-stage programs (coresident/
                    pipeline.py) on per-stage devices, boundary
                    activations forwarded stage to stage (f32), backward
                    rematerialized per stage, per-stage gradients folded
                    sequentially per microbatch then per shard. With
                    `-Dshifu.coresident.replicas=R` > 1 the shard list
                    partitions round-robin over R pipeline replicas and
                    the per-stage epoch gradients meet in
                    `parallel/mesh.fleet_reduce`.

Ledger discipline: every host-counted buffer is grant-acquired BEFORE
its `.to(device)` — the weights, the optimizer state, the activation
estimate and the microbatch uploads; after the first epoch the stage
programs' counted allocations true the charge up (the serving tenants'
two-step). Eviction (grant heartbeat) checkpoints through a
`ShardedStreamCheckpoint` family (one part a STAGE, stamped
`part_kind="stages"`), drops every device reference, releases the
charge, then polls for re-admission — resume is bit-identical to an
uninterrupted run at any epoch boundary.

Stage s of replica r runs on `cuda:(r*K + s) % device_count` when the
run is on the card (every stage on `cuda:0` with one card), on the
given device otherwise.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from shifu_tpu_torch.coresident.config import CoresidentConfig
from shifu_tpu_torch.coresident.pipeline import (make_nn_stage_programs,
                                                 make_wdl_stage_programs)
from shifu_tpu_torch.coresident.plan import (StagePlan, default_stages,
                                             nn_plan, wdl_plan)
from shifu_tpu_torch.coresident.tenant import (EvictedError, Grant,
                                               HttpGrant, LocalGrant)
from shifu_tpu_torch.obs import profile
from shifu_tpu_torch.resilience import checkpoint as ckpt_mod
from shifu_tpu_torch.resilience import faults
from shifu_tpu_torch.serve.registry import _CountAllocs
from shifu_tpu_torch.train.nn_trainer import NNTrainConfig, TrainResult
from shifu_tpu_torch.utils.log import get_logger
from shifu_tpu_torch.utils.platform import DeviceLike, resolve_device

log = get_logger(__name__)

F32 = 4
_CPU = torch.device("cpu")


def _opt_leaves(init_state) -> int:
    return len(init_state(1, 1, _CPU))


def _first(parts):
    """The one-device reduce of a shard program's partials."""
    return parts[0]


def _microbatches(arrs, m: int):
    """Split row-aligned host arrays into m equal microbatches (zero-
    padded tail rows carry zero significance, so they contribute
    nothing to gradients or error sums)."""
    rows = int(arrs[0].shape[0])
    mb = -(-rows // m)
    pad = mb * m - rows
    padded = []
    for a in arrs:
        if pad:
            a = np.pad(a, ((0, pad),) + ((0, 0),) * (a.ndim - 1))
        padded.append(a)
    return [tuple(a[i * mb:(i + 1) * mb] for a in padded)
            for i in range(m)], mb


def _family_checkpoint(root: str, family: str, sha: str, sections,
                       n_stages: int):
    base = ckpt_mod.ckpt_base(root, "coresident", family)
    return ckpt_mod.ShardedStreamCheckpoint(
        base, sha, n_shards=n_stages, every=0, sections=sections,
        part_kind="stages")


def _stage_devices(k: int, replicas: int, device: torch.device):
    """Replica r's stage s -> cuda:(r*K + s) % device_count on the card
    (deterministic: a K=2, R=1 trainer on two cards takes both), every
    stage on `device` otherwise."""
    if device.type != "cuda":
        return [[device] * k for _ in range(replicas)]
    n = max(1, torch.cuda.device_count())
    return [[torch.device("cuda", (r * k + s) % n) for s in range(k)]
            for r in range(replicas)]


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _upload(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array on `dev` in its own layout, as the shard feeds
    upload it (the column-subset shards are column-major, and a matmul
    over another layout may round differently)."""
    return torch.from_numpy(a).to(dev)


def _opt_arrays(opt: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {f"opt_{name}": _host(v)[0] for name, v in opt.items()}


class _Exec:
    """What both execution shapes share: the first epoch's allocation
    count behind `true_up`."""

    grant: Grant
    total_bytes: int
    _act_estimate: int

    def _init_count(self, copies: int = 1) -> None:
        """Count the first epoch's allocations of each seam; `copies`
        programs run them (a pipeline's replicas)."""
        self._counting = True
        self._measured: Dict[str, int] = {}
        self._copies = copies

    def _dispatch(self, seam: str, fn: Callable, *args):
        if not self._counting:
            return profile.dispatch(seam, fn, *args, sync=False)
        count = _CountAllocs()
        with count:
            out = profile.dispatch(seam, fn, *args, sync=False)
        self._measured[seam] = max(self._measured.get(seam, 0),
                                   count.nbytes)
        return out

    def true_up(self) -> None:
        """After the first epoch: charge what the programs allocated past
        the activation estimate (each seam's largest call, counted from
        the tensors its torch calls return, summed over seams)."""
        self._counting = False
        measured = sum(self._measured.values()) * self._copies
        extra = int(measured) - self._act_estimate
        if extra > 0:
            self.grant.acquire(extra)
            self.total_bytes += extra
            self._act_estimate += extra


class _SingleExec(_Exec):
    """stages=1: the streamed trainers' shard program itself (same
    function, same seam, same fold order: bit-identical math)."""

    def __init__(self, kind: str, feed, flat0: np.ndarray, prog, seam: str,
                 updater, grant: Grant, microbatches: int,
                 dev: torch.device, row_bytes: int) -> None:
        self.kind = kind
        self.feed = feed
        self.prog = prog
        self.seam = seam
        self.init_state, self.apply_update = updater
        self.m = max(1, int(microbatches))
        self.grant = grant
        self.dev = dev
        leaves = _opt_leaves(self.init_state)
        # the feed double-buffers one padded shard on the device
        self._act_estimate = 2 * max(feed.meta.shard_rows) * row_bytes
        self.total_bytes = flat0.nbytes * (1 + leaves) + self._act_estimate
        # the invariant: acquired BEFORE the .to(device) below
        grant.acquire(self.total_bytes)
        self.flat = torch.as_tensor(flat0, device=dev)[None]
        self.opt = self.init_state(1, flat0.size, dev)
        self.nts = torch.tensor([feed.n_train_size], dtype=torch.float32,
                                device=dev)
        self._g = None
        self._init_count()

    def epoch_grads(self):
        g_sum = sums = None
        if self.m == 1:
            # the parity path: the streamed loop's iteration, seam and
            # fold order
            shards = ((self.seam, shard) for shard in self.feed)
        else:
            shards = self._microbatch_shards()
        for seam, shard in shards:
            g, *s = self._dispatch(seam, self.prog, [self.flat], [shard],
                                   _first)
            if g_sum is None:
                g_sum, sums = g, s
            else:
                g_sum = g_sum + g
                sums = [a + b for a, b in zip(sums, s)]
        self._g = g_sum
        tr_sum, va_sum, tr_w, va_w = sums
        return (float(tr_sum / torch.clamp_min(tr_w, 1.0)),
                float(va_sum / torch.clamp_min(va_w, 1.0)))

    def _microbatch_shards(self):
        seam = f"coresident.{self.kind}.mb"
        for s in range(self.feed.n_shards):
            mbs, _rows = _microbatches(self.feed._load_host(s), self.m)
            for chunk in mbs:  # SEQUENTIAL m order — pinned
                yield seam, tuple(_upload(a, self.dev) for a in chunk)

    def apply(self, lr: float, it: int) -> None:
        dev = self.dev
        self.flat, self.opt = self.apply_update(
            self.opt, self.flat, self._g,
            torch.tensor([lr], dtype=torch.float32, device=dev),
            torch.tensor([it], dtype=torch.int32, device=dev), self.nts)

    # ---- state ----
    def full_flat(self) -> np.ndarray:
        return _host(self.flat)[0]

    def stage_arrays(self) -> List[dict]:
        return [{"flat": self.full_flat(), **_opt_arrays(self.opt)}]

    def restore(self, per_stage: List[dict]) -> None:
        arrays = per_stage[0]
        self.flat = torch.as_tensor(arrays["flat"], device=self.dev)[None]
        self.opt = {k[len("opt_"):]: torch.as_tensor(v, device=self.dev)[None]
                    for k, v in arrays.items() if k.startswith("opt_")}

    def drop(self) -> List[dict]:
        state = self.stage_arrays()
        self.flat = self.opt = self._g = None
        return state

    def replace(self, per_stage: List[dict]) -> None:
        # re-admission already re-acquired total_bytes: the uploads land
        # inside the held charge
        self.restore(per_stage)


class _PipelineExec(_Exec):
    """stages>=2: per-stage programs on per-stage devices, GPipe
    microbatching, optional data-parallel replicas meeting in
    fleet_reduce."""

    def __init__(self, kind: str, feed, flat0: np.ndarray, plan: StagePlan,
                 progs, updater, grant: Grant, microbatches: int,
                 replicas: int, dev: torch.device,
                 in_bytes: int) -> None:
        self.kind = kind
        self.feed = feed
        self.plan = plan
        self.progs = progs
        self.init_state, self.apply_update = updater
        self.k = plan.n_stages
        self.m = max(1, int(microbatches))
        self.r = max(1, int(replicas))
        self.grant = grant
        self.devices = _stage_devices(self.k, self.r, dev)
        self.leaves = _opt_leaves(self.init_state)
        self.mb_rows = -(-max(feed.meta.shard_rows) // self.m)
        self.nts = float(feed.n_train_size)
        # a microbatch's uploads: stage 0's input rows, the last stage's
        # targets and significances
        self._uploads = [0] * self.k
        self._uploads[0] += self.mb_rows * in_bytes
        self._uploads[-1] += self.mb_rows * 3 * F32
        self._act_estimate = sum(
            plan.resident_bytes(k, 0, self.mb_rows) - plan.param_bytes(k)
            for k in range(self.k)) * self.r
        self.total_bytes = 0
        self.flats: List[list] = []
        self.opts: List[list] = []
        self._place([{"flat": np.asarray(flat0[s.lo:s.hi], np.float32)}
                     for s in plan.stages])
        self._g: Optional[List] = None
        self._init_count(self.r)

    # ---- placement / ledger ----
    def _place(self, per_stage: List[dict]) -> None:
        """Every replica's stage buffers on their devices, each stage's
        bytes acquired BEFORE its uploads; the optimizer state from
        `per_stage`'s `opt_*` arrays, fresh when it has none."""
        self.flats = [[None] * self.k for _ in range(self.r)]
        self.opts = [[None] * self.k for _ in range(self.r)]
        for r in range(self.r):
            for k in range(self.k):
                dev = self.devices[r][k]
                ask = (self.plan.resident_bytes(k, self.leaves, self.mb_rows)
                       + self._uploads[k])
                self.grant.acquire(ask)
                self.total_bytes += ask
                arrays = per_stage[k]
                self.flats[r][k] = torch.as_tensor(
                    np.asarray(arrays["flat"], np.float32), device=dev)[None]
                opt = {name[len("opt_"):]: torch.as_tensor(v, device=dev)[None]
                       for name, v in arrays.items()
                       if name.startswith("opt_")}
                self.opts[r][k] = opt or self.init_state(
                    1, self.flats[r][k].shape[1], dev)

    # ---- epoch ----
    def epoch_grads(self):
        g = [[None] * self.k for _ in range(self.r)]
        met = [None] * self.r
        for s in range(self.feed.n_shards):
            r = s % self.r
            mbs, _rows = _microbatches(self.feed._load_host(s), self.m)
            for chunk in mbs:  # SEQUENTIAL m order — pinned
                gs, metrics = self._one_microbatch(r, chunk)
                for k in range(self.k):
                    g[r][k] = gs[k] if g[r][k] is None else g[r][k] + gs[k]
                met[r] = (metrics if met[r] is None else
                          [a + b for a, b in zip(met[r], metrics)])
        if self.r == 1:
            self._g = g
            tr_sum, va_sum, tr_w, va_w = met[0]
            return (float(tr_sum / torch.clamp_min(tr_w, 1.0)),
                    float(va_sum / torch.clamp_min(va_w, 1.0)))
        # data-parallel replicas: the per-stage epoch gradients (and the
        # metric sums) meet in the serving fleet's reduce
        from shifu_tpu_torch.parallel.mesh import fleet_mesh, fleet_reduce

        mesh = fleet_mesh(self.r, self.devices[0][0])
        reduced = [fleet_reduce(mesh, np.stack(
            [_host(g[r][k])[0] for r in range(self.r)])).astype(np.float32)
            for k in range(self.k)]
        msum = fleet_reduce(mesh, np.stack([
            np.asarray([float(v) for v in met[r]], np.float32)
            for r in range(self.r)]))
        self._g = [[torch.as_tensor(reduced[k], device=self.devices[r][k])
                    [None] for k in range(self.k)] for r in range(self.r)]
        return (float(msum[0] / max(msum[2], 1.0)),
                float(msum[1] / max(msum[3], 1.0)))

    def _one_microbatch(self, r: int, chunk):
        devs = self.devices[r]
        flats = self.flats[r]
        last = devs[-1]
        gs = [None] * self.k
        if self.kind == "nn":
            x, t, sig_t, sig_v = chunk
            h = _upload(x, devs[0])
            bounds = [h]
            for k in range(self.k - 1):
                h = self._dispatch(f"coresident.nn.s{k}",
                                   self.progs["fwd"][k], flats[k], h)
                h = h.to(devs[k + 1])  # the boundary hop
                bounds.append(h)
            gs[-1], cot, *metrics = self._dispatch(
                "coresident.nn.head", self.progs["head"], flats[-1], h,
                _upload(t, last), _upload(sig_t, last),
                _upload(sig_v, last))
            for k in range(self.k - 2, -1, -1):
                gs[k], cot = self._dispatch(
                    f"coresident.nn.b{k}", self.progs["bwd"][k], flats[k],
                    bounds[k], cot.to(devs[k]))
            return gs, metrics
        # ---- wdl: the carry is (deep activation, wide logit) ----
        dense, codes, t, sig_t, sig_v = chunk
        dd, cd = _upload(dense, devs[0]), _upload(codes, devs[0])
        h, wl = self._dispatch("coresident.wdl.s0", self.progs["first_fwd"],
                               flats[0], dd, cd)
        bounds = [None]
        for k in range(1, self.k - 1):
            h, wl = h.to(devs[k]), wl.to(devs[k])
            bounds.append((h, wl))
            h, wl = self._dispatch(f"coresident.wdl.s{k}",
                                   self.progs["mid_fwd"][k - 1], flats[k],
                                   h, wl)
        gs[-1], cot_h, cot_wl, *metrics = self._dispatch(
            "coresident.wdl.head", self.progs["head"], flats[-1],
            h.to(last), wl.to(last), _upload(t, last),
            _upload(sig_t, last), _upload(sig_v, last))
        for k in range(self.k - 2, 0, -1):
            hb, wlb = bounds[k]
            gs[k], cot_h, cot_wl = self._dispatch(
                f"coresident.wdl.b{k}", self.progs["mid_bwd"][k - 1],
                flats[k], hb, wlb, cot_h.to(devs[k]), cot_wl.to(devs[k]))
        gs[0] = self._dispatch("coresident.wdl.b0", self.progs["first_bwd"],
                               flats[0], dd, cd, cot_h.to(devs[0]),
                               cot_wl.to(devs[0]))
        return gs, metrics

    def apply(self, lr: float, it: int) -> None:
        for r in range(self.r):
            for k in range(self.k):
                dev = self.devices[r][k]
                # elementwise update rules: per-slice updates on the
                # stage device concatenate bit-identically to the
                # full-vector update
                self.flats[r][k], self.opts[r][k] = self.apply_update(
                    self.opts[r][k], self.flats[r][k], self._g[r][k],
                    torch.tensor([lr], dtype=torch.float32, device=dev),
                    torch.tensor([it], dtype=torch.int32, device=dev),
                    torch.tensor([self.nts], dtype=torch.float32,
                                 device=dev))

    # ---- state ----
    def full_flat(self) -> np.ndarray:
        return np.concatenate([_host(f)[0] for f in self.flats[0]])

    def stage_arrays(self) -> List[dict]:
        return [{"flat": _host(self.flats[0][k])[0],
                 **_opt_arrays(self.opts[0][k])} for k in range(self.k)]

    def restore(self, per_stage: List[dict]) -> None:
        """Load a checkpoint into the placed buffers, in place: no new
        device bytes."""
        for r in range(self.r):
            for k in range(self.k):
                arrays = per_stage[k]
                self.flats[r][k].copy_(torch.as_tensor(arrays["flat"])[None])
                for name, v in self.opts[r][k].items():
                    v.copy_(torch.as_tensor(arrays[f"opt_{name}"])[None])

    def drop(self) -> List[dict]:
        state = self.stage_arrays()
        self.flats, self.opts, self._g = [], [], None
        return state

    def replace(self, per_stage: List[dict]) -> None:
        # the wait_readmit acquire holds total_bytes already: rebuild
        # the placement without double-charging
        held, self.total_bytes = self.total_bytes, 0
        grant, self.grant = self.grant, _PrepaidGrant(held)
        try:
            self._place(per_stage)
        finally:
            self.grant = grant
            self.total_bytes = held


class _PrepaidGrant(Grant):
    """Placement-time stand-in after wait_readmit already holds the
    whole charge: acquires are accounted against the prepaid total."""

    def __init__(self, held: int) -> None:
        self.held = int(held)

    def acquire(self, nbytes: int) -> None:
        self.held -= int(nbytes)
        if self.held < 0:
            raise AssertionError(
                "re-placement asked for more bytes than re-admission "
                "granted")


def _make_grant(ccfg: CoresidentConfig) -> Grant:
    if ccfg.serve_url:
        return HttpGrant(ccfg.serve_url, ccfg.tenant)
    return LocalGrant(ccfg.tenant)


def _resolve_stages(ccfg: CoresidentConfig, grant: Grant,
                    total_param_bytes: int, max_stages: int,
                    opt_leaves: int) -> int:
    if ccfg.stages:
        return int(ccfg.stages)
    k = default_stages(grant.free_bytes(), total_param_bytes, max_stages,
                       opt_leaves)
    log.info("coresident: stages not pinned; grant free budget chose "
             "K=%d", k)
    return k


def _handle_heartbeat(grant: Grant, exec_, ccfg: CoresidentConfig,
                      it_done: int) -> None:
    """The preemption channel, honored at the epoch boundary AFTER the
    epoch's checkpoint landed: drop every device reference, release the
    charge, poll for re-admission, re-place — or surface EvictedError
    with the state safely on disk."""
    if not grant.heartbeat(it_done):
        return
    log.warning("coresident trainer %s evicted at epoch %d; state is "
                "checkpointed, polling %.0fms for re-admission",
                ccfg.tenant, it_done, ccfg.wait_ms)
    state = exec_.drop()
    grant.release(final=False)
    if not grant.wait_readmit(exec_.total_bytes, ccfg.wait_ms):
        raise EvictedError(ccfg.tenant, it_done)
    exec_.replace(state)
    log.info("coresident trainer %s re-admitted at epoch %d", ccfg.tenant,
             it_done)


class _Loop:
    """The epoch loop both entries share (the streamed loop's order:
    gradients, best-weights bookkeeping on the pre-update weights, one
    update, the decay), with a checkpoint and a heartbeat every epoch
    boundary."""

    def __init__(self, cfg, exec_, ccfg: CoresidentConfig, grant: Grant,
                 ck, algo: str, decay: float = 0.0,
                 convergence: float = 0.0) -> None:
        self.cfg, self.exec_, self.ccfg, self.grant = cfg, exec_, ccfg, grant
        self.ck, self.algo = ck, algo
        self.decay, self.convergence = decay, convergence
        self.lr = float(cfg.learning_rate)
        self.best_val = math.inf
        self.best_flat = exec_.full_flat()
        self.bad = 0
        self.tr_e = self.va_e = 0.0
        self.it_done = 0

    def resume(self, k: int) -> None:
        loaded = self.ck.load()
        if loaded is None:
            return
        _cursors, per_stage, shared = loaded
        meta = shared[1]
        self.it_done = int(meta["it"])
        self.lr = float(meta["lr"])
        self.best_val = float(meta["bestVal"])
        self.bad = int(meta["bad"])
        self.tr_e, self.va_e = float(meta["trE"]), float(meta["vaE"])
        self.best_flat = np.asarray(shared[0]["bestFlat"])
        self.exec_.restore([arrays for (arrays, _m, _b) in per_stage])
        faults.survived("preempt")
        log.info("resuming coresident %s at epoch %d (K=%d)",
                 self.algo.upper(), self.it_done, k)

    def run(self) -> None:
        cfg, exec_ = self.cfg, self.exec_
        every = cfg.checkpoint_every
        trued = False
        while self.it_done < cfg.num_epochs:
            faults.fault_point("epoch")
            self.tr_e, self.va_e = exec_.epoch_grads()
            if not trued:
                exec_.true_up()
                trued = True
            if self.va_e < self.best_val:  # the pre-update weights
                self.best_val = self.va_e
                self.best_flat = exec_.full_flat()
                self.bad = 0
            else:
                self.bad += 1
            exec_.apply(self.lr, self.it_done + 1)
            self.lr *= 1.0 - self.decay
            self.it_done += 1
            if every and self.it_done % every == 0:
                if cfg.progress_cb:
                    cfg.progress_cb(self.it_done, self.tr_e, self.va_e)
                if cfg.checkpoint_path:
                    ckpt_mod.atomic_save_npy(cfg.checkpoint_path,
                                             exec_.full_flat())
            # the eviction checkpoint: EVERY epoch boundary is resumable
            # (the grant can preempt the trainer at any heartbeat)
            self.ck.save(
                [(self.it_done, arrays, None, None)
                 for arrays in exec_.stage_arrays()],
                ({"bestFlat": np.asarray(self.best_flat)},
                 {"it": self.it_done, "lr": self.lr,
                  "bestVal": self.best_val, "bad": self.bad,
                  "trE": self.tr_e, "vaE": self.va_e, "algo": self.algo,
                  "tenant": self.ccfg.tenant}, None))
            _handle_heartbeat(self.grant, exec_, self.ccfg, self.it_done)
            if cfg.early_stop_window and self.bad >= cfg.early_stop_window:
                log.info("coresident %s early stop at epoch %d",
                         self.algo.upper(), self.it_done)
                break
            if self.convergence and \
                    (self.tr_e + self.va_e) / 2.0 <= self.convergence:
                break
            if self.ccfg.throttle_ms > 0:
                time.sleep(self.ccfg.throttle_ms / 1000.0)
        self.ck.clear()  # completed: nothing left to resume
        self.grant.release(final=True)

    def chosen(self):
        """(weights, valid error): the best pre-update weights when a
        valid set exists, else the final ones."""
        use_best = self.cfg.valid_set_rate > 0 and math.isfinite(
            self.best_val)
        flat = self.best_flat if use_best else self.exec_.full_flat()
        return flat, (self.best_val if use_best else self.va_e)


def _train_section(cfg) -> dict:
    return {kk: v for kk, v in cfg.__dict__.items()
            if not callable(v) and kk != "progress_cb"}


def train_nn_coresident(
    data_dir: str,
    cfg: NNTrainConfig,
    ccfg: Optional[CoresidentConfig] = None,
    init_flat: Optional[np.ndarray] = None,
    target_class: Optional[int] = None,
    grant: Optional[Grant] = None,
    resume: bool = False,
    ident_extra: Optional[dict] = None,
    device: DeviceLike = None,
) -> TrainResult:
    """`shifu retrain --coresident` for NN: the streamed full-batch epoch
    loop, run as a background ledger tenant on `device` (None = cuda).
    With `stages=1, microbatches=1` this is BIT-IDENTICAL to
    train_nn_streamed; K>=2 pipelines the layer groups over the stage
    devices."""
    from shifu_tpu_torch.models.nn import (flatten_params, init_params,
                                           unflatten_params)
    from shifu_tpu_torch.train.nn_trainer import _layer_sizes
    from shifu_tpu_torch.train.streaming import ShardFeed, _nn_shard_grad
    from shifu_tpu_torch.train.updaters import make_updater

    dev = resolve_device(device)
    ccfg = (ccfg or CoresidentConfig()).resolve()
    grant = grant or _make_grant(ccfg)
    feed = ShardFeed(data_dir, cfg, dev)
    d = len(feed.meta.columns)
    flat0, shapes = flatten_params(init_params(
        _layer_sizes(d, cfg), seed=cfg.seed, init=cfg.weight_init))
    if init_flat is not None and init_flat.size == flat0.size:
        flat0 = init_flat.astype(np.float32)
    updater = make_updater(
        cfg.propagation, momentum=cfg.momentum,
        reg=cfg.regularized_constant, reg_level=cfg.reg_level,
        adam_beta1=cfg.adam_beta1, adam_beta2=cfg.adam_beta2)
    leaves = _opt_leaves(updater[0])

    grant.admit(meta={"algo": "nn", **(ccfg.meta or {})})
    k = _resolve_stages(ccfg, grant, flat0.nbytes, len(shapes), leaves)
    if k > 1 and cfg.dropout_rate > 0:
        raise ValueError(
            "coresident stages>1 cannot honor dropout (the mask is drawn "
            "per monolithic program) — set stages=1 or DropoutRate=0")
    # second admit = meta update only: K was sized FROM the grant, so
    # it cannot ride the first call; /healthz and `shifu top` read it
    grant.admit(meta={"algo": "nn", "stages": k, **(ccfg.meta or {})})
    m = ccfg.microbatches
    r = ccfg.replicas if k > 1 else 1

    if k == 1:
        exec_ = _SingleExec(
            "nn", feed, flat0, _nn_shard_grad(cfg, shapes, target_class, dev),
            "nn.shard_grad", updater, grant, m, dev, (d + 3) * F32)
    else:
        plan = nn_plan(shapes, k)
        exec_ = _PipelineExec(
            "nn", feed, flat0, plan,
            make_nn_stage_programs(cfg, plan, target_class), updater,
            grant, m, r, dev, d * F32)

    # the family identity deliberately EXCLUDES stages: a resume under a
    # different K must reject with reason="stages" (the part-count
    # stamp), not dissolve into an anonymous config mismatch
    sections = {
        "train": _train_section(cfg),
        "data": {"shardRows": list(feed.meta.shard_rows),
                 "columns": list(feed.meta.columns),
                 "targetClass": target_class},
        "coresident": {"microbatches": m, "replicas": r},
    }
    if ident_extra:
        sections["loop"] = dict(ident_extra)
    sha, sha_sections = ckpt_mod.sectioned_sha(sections)
    family = f"{ccfg.tenant}-nn" + (
        f"-c{target_class}" if target_class is not None else "")
    ck = _family_checkpoint(ccfg.family_dir, family, sha, sha_sections, k)

    loop = _Loop(cfg, exec_, ccfg, grant, ck, "nn",
                 decay=cfg.learning_decay,
                 convergence=cfg.convergence_threshold)
    if resume:
        loop.resume(k)
    loop.run()
    chosen, valid = loop.chosen()
    log.info("coresident NN done: %d epochs, K=%d M=%d R=%d, train %.6f "
             "valid %.6f", loop.it_done, k, m, r, loop.tr_e, valid)
    return TrainResult(params=unflatten_params(chosen, shapes),
                       train_error=loop.tr_e, valid_error=valid,
                       iterations=loop.it_done)


def train_wdl_coresident(
    norm_dir: str,
    codes_dir: str,
    num_idx,
    cat_idx,
    vocab_sizes,
    cfg,
    ccfg: Optional[CoresidentConfig] = None,
    init_flat: Optional[np.ndarray] = None,
    grant: Optional[Grant] = None,
    resume: bool = False,
    device: DeviceLike = None,
):
    """`shifu retrain --coresident` for WDL — the NN path's loop
    (stages=1, microbatches=1 is bit-identical to train_wdl_streamed);
    the pipeline splits the DENSE tower, with the embedding/wide block
    welded to stage 0."""
    from shifu_tpu_torch.models.wdl import (flatten_wdl, init_wdl_params,
                                            wdl_shapes)
    from shifu_tpu_torch.train.streaming_wdl import (WDLShardFeed,
                                                     _wdl_shard_grad)
    from shifu_tpu_torch.train.updaters import make_updater
    from shifu_tpu_torch.train.wdl_trainer import (WDLTrainResult,
                                                   _host_params)

    dev = resolve_device(device)
    ccfg = (ccfg or CoresidentConfig()).resolve()
    grant = grant or _make_grant(ccfg)
    feed = WDLShardFeed(norm_dir, codes_dir, num_idx, cat_idx, cfg, dev)
    template = init_wdl_params(len(num_idx), vocab_sizes, cfg.embed_dim,
                               cfg.hidden, seed=cfg.seed)
    flat0 = flatten_wdl(template)
    if init_flat is not None and init_flat.size == flat0.size:
        flat0 = init_flat.astype(np.float32)
    shapes = wdl_shapes(template)
    n_cat = len(template.embed)
    n_dense = len(template.dense_layers)
    updater = make_updater(
        cfg.optimizer if cfg.optimizer != "GD" else "B", momentum=0.0,
        reg=cfg.l2_reg, reg_level="L2" if cfg.l2_reg else "NONE")
    leaves = _opt_leaves(updater[0])

    grant.admit(meta={"algo": "wdl", **(ccfg.meta or {})})
    k = _resolve_stages(ccfg, grant, flat0.nbytes, n_dense, leaves)
    grant.admit(meta={"algo": "wdl", "stages": k, **(ccfg.meta or {})})
    m = ccfg.microbatches
    r = ccfg.replicas if k > 1 else 1
    # a row's device bytes: the dense columns (f32), the codes (int64)
    in_bytes = len(num_idx) * F32 + len(cat_idx) * 8

    if k == 1:
        exec_ = _SingleExec(
            "wdl", feed, flat0, _wdl_shard_grad(cfg, shapes, n_cat),
            "wdl.shard_grad", updater, grant, m, dev, in_bytes + 3 * F32)
    else:
        plan = wdl_plan(shapes, n_cat, k)
        exec_ = _PipelineExec(
            "wdl", feed, flat0, plan, make_wdl_stage_programs(cfg, plan),
            updater, grant, m, r, dev, in_bytes)

    sections = {
        "train": _train_section(cfg),
        "data": {"shardRows": list(feed.meta.shard_rows),
                 "numIdx": list(num_idx), "catIdx": list(cat_idx),
                 "vocab": list(vocab_sizes)},
        "coresident": {"microbatches": m, "replicas": r},
    }
    sha, sha_sections = ckpt_mod.sectioned_sha(sections)
    ck = _family_checkpoint(ccfg.family_dir, f"{ccfg.tenant}-wdl", sha,
                            sha_sections, k)

    loop = _Loop(cfg, exec_, ccfg, grant, ck, "wdl")
    if resume:
        loop.resume(k)
    loop.run()
    chosen, valid = loop.chosen()
    log.info("coresident WDL done: %d epochs, K=%d M=%d R=%d, train %.6f "
             "valid %.6f", loop.it_done, k, m, r, loop.tr_e, valid)
    return WDLTrainResult(params=_host_params(chosen, template),
                          train_error=loop.tr_e, valid_error=valid,
                          iterations=loop.it_done)

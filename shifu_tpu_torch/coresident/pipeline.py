"""Per-stage programs: the pipeline bodies for NN and WDL (counterpart of
`shifu_tpu/coresident/pipeline.py`).

One program per stage, as a torch function of the stage's flat slice
(`[1, n_k]`, the streamed trainers' member axis of one). A stage runs
where its slice and its input live (the trainer places both on the
stage's device). The backward is GPipe with rematerialization: a
stage's backward reruns its forward under `torch.enable_grad()` on a
detached input and calls `torch.autograd.grad` for the slice and for the
boundary cotangent, so no stage keeps another microbatch's activations;
the only cross-stage traffic is the boundary activation forward and its
cotangent backward.

The ops are the monolithic programs', one for one: the NN layers are
`train/nn_trainer._Net.layer_out` and the head is the loss, metrics and
ONEVSALL transform of `train/streaming._nn_shard_grad`; the WDL stages
run `models/wdl.wdl_deep_input` / `wdl_dense` / `wdl_wide_logit` and the
head the log loss of `train/streaming_wdl._wdl_shard_grad`. So a split
changes which function computes a value, not the value.

Precision policy: stage-BOUNDARY activations are always f32; bf16 lives
only inside the matmuls when `mixed_precision` is set (`_Net.matmul`).

Gradient convention matches train/streaming.py: stages return the
DESCENT direction g = -dL/dw summed over records.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from shifu_tpu_torch.coresident.plan import StagePlan
from shifu_tpu_torch.models.wdl import (wdl_deep_input, wdl_dense,
                                        wdl_field_index, wdl_wide_logit)
from shifu_tpu_torch.train.nn_trainer import NNTrainConfig, _Net
from shifu_tpu_torch.train.wdl_trainer import LOG_EPS

F32 = torch.float32


def _leaf(t: Optional[torch.Tensor], grad: bool):
    """A detached copy-free leaf of `t` that autograd differentiates
    against (None stays None)."""
    if t is None:
        return None
    return t.detach().requires_grad_(grad)


def make_nn_stage_programs(cfg: NNTrainConfig, plan: StagePlan,
                           target_class: Optional[int] = None):
    """{"fwd": [K-1 (flat_k, h) -> h'], "bwd": [K-1 (flat_k, h, cot) ->
    (g_k, cot_in)], "head": (flat_K, h, t, sig_t, sig_v) -> (g_K,
    cot_in, tr_sum, va_sum, tr_w, va_w)}. Stage 0's input is the
    feature rows [rows, d] and its backward returns cot_in None (the
    data gets no gradient, as in the monolithic program)."""
    net = _Net(cfg, plan.shapes)

    def group_fwd(flat_k, h, lo, hi):
        for i, (w, b) in enumerate(net.layers(flat_k, lo, hi), start=lo):
            h = net.layer_out(i, h, w, b)
        return h

    def make_fwd(lo, hi):
        def fwd(flat_k, h):
            with torch.no_grad():
                # boundary contract: f32 leaves the stage, whatever
                # lived inside the matmuls
                return group_fwd(flat_k, h, lo, hi).to(F32)

        return fwd

    def make_bwd(lo, hi):
        def bwd(flat_k, h, cot):
            w = _leaf(flat_k, True)
            hh = _leaf(h, lo > 0)  # the data rows get no gradient
            with torch.enable_grad():
                # remat: the backward reruns this stage's forward
                out = group_fwd(w, hh, lo, hi).to(F32)
                grads = torch.autograd.grad(
                    out, (w, hh) if lo > 0 else (w,), grad_outputs=cot)
            cot_in = grads[1].to(F32) if lo > 0 else None
            return -grads[0], cot_in

        return bwd

    last = plan.stages[-1]

    def head(flat_k, h, t, sig_t, sig_v):
        if target_class is not None:  # ONEVSALL member: tag == class
            t = (t == float(target_class)).to(F32)
        w = _leaf(flat_k, True)
        hh = _leaf(h, True)
        with torch.enable_grad():
            p = net.output(group_fwd(w, hh, last.layer_lo, last.layer_hi))
            total = torch.sum(sig_t[None] * net.record_loss(p, net.ideal(t)))
            g, cot_in = torch.autograd.grad(total, (w, hh))
        sq = net.sq_error(p.detach(), t)[0]
        tr, va = (sig_t * sq).sum(), (sig_v * sq).sum()
        tr_w, va_w = sig_t.sum(), sig_v.sum()
        # the streamed shard program's weighted means times their weights
        tr = tr / torch.clamp_min(tr_w, 1.0) * tr_w
        va = va / torch.clamp_min(va_w, 1.0) * va_w
        return -g, cot_in.to(F32), tr, va, tr_w, va_w

    return {
        "fwd": [make_fwd(s.layer_lo, s.layer_hi) for s in plan.stages[:-1]],
        "bwd": [make_bwd(s.layer_lo, s.layer_hi) for s in plan.stages[:-1]],
        "head": head,
    }


def _unflatten_group(flat_k: torch.Tensor, shapes):
    """[1, *shape] views of consecutive arrays of `shapes` in `flat_k`."""
    parts, off = [], 0
    for shp in shapes:
        size = int(np.prod(shp))
        parts.append(flat_k[:, off: off + size].reshape((1,) + tuple(shp)))
        off += size
    return parts


def _dense_layers(parts):
    return [{"W": parts[i], "b": parts[i + 1]}
            for i in range(0, len(parts), 2)]


def make_wdl_stage_programs(cfg, plan: StagePlan):
    """WDL pipeline bodies. Stage 0 owns the embedding gather and the
    wide tower (its logit is data-only, so it is computed once and
    carried beside the deep activation); mid stages apply their dense
    layers and carry the wide logit through unchanged; the head owns
    the output layer, the bias and the log-loss + squared-error math of
    train/streaming_wdl.py."""
    shapes = plan.shapes
    n_cat = plan.n_cat
    head_arrays = 2 * n_cat + 1
    n_dense = (len(shapes) - head_arrays - 1) // 2
    n_hidden = n_dense - 1
    acts = cfg.activations

    def first_body(flat_k, dense, codes, stage):
        a_hi = head_arrays + 2 * stage.layer_hi
        parts = _unflatten_group(flat_k, shapes[:a_hi])
        embed, wide = parts[:n_cat], parts[n_cat: 2 * n_cat]
        wide_dense = parts[2 * n_cat]
        idx = wdl_field_index(embed, codes)
        h = wdl_deep_input(embed, dense, idx, 1)
        h = wdl_dense(_dense_layers(parts[head_arrays:]), h, acts,
                      stage.layer_lo, n_hidden, True)
        wl = wdl_wide_logit(wide, wide_dense, dense, idx, True)
        return h.to(F32), wl.to(F32)

    def mid_body(flat_k, h, stage):
        a_lo = head_arrays + 2 * stage.layer_lo
        a_hi = head_arrays + 2 * stage.layer_hi
        layers = _dense_layers(_unflatten_group(flat_k, shapes[a_lo:a_hi]))
        return wdl_dense(layers, h, acts, stage.layer_lo, n_hidden,
                         True).to(F32)

    first = plan.stages[0]

    def first_fwd(flat_k, dense, codes):
        with torch.no_grad():
            return first_body(flat_k, dense, codes, first)

    def first_bwd(flat_k, dense, codes, cot_h, cot_wl):
        w = _leaf(flat_k, True)
        with torch.enable_grad():
            h, wl = first_body(w, dense, codes, first)
            (g,) = torch.autograd.grad((h, wl), (w,),
                                       grad_outputs=(cot_h, cot_wl))
        return -g

    def make_mid(stage):
        def fwd(flat_k, h, wl):
            with torch.no_grad():
                # the wide logit rides through untouched, so its
                # cotangent routes back to stage 0 with the activation's
                return mid_body(flat_k, h, stage), wl

        def bwd(flat_k, h, wl, cot_h, cot_wl):
            w, hh = _leaf(flat_k, True), _leaf(h, True)
            with torch.enable_grad():
                out = mid_body(w, hh, stage)
                g, cot_h_in = torch.autograd.grad(out, (w, hh),
                                                  grad_outputs=cot_h)
            return -g, cot_h_in.to(F32), cot_wl

        return fwd, bwd

    last = plan.stages[-1]
    a_lo = head_arrays + 2 * last.layer_lo

    def head(flat_k, h, wl, t, sig_t, sig_v):
        w, hh, wwl = _leaf(flat_k, True), _leaf(h, True), _leaf(wl, True)
        with torch.enable_grad():
            parts = _unflatten_group(w, shapes[a_lo:])
            hd = wdl_dense(_dense_layers(parts[:-1]), hh, acts,
                           last.layer_lo, n_hidden, True)
            logit = hd[..., 0] + wwl + parts[-1][..., :1]
            p = 1.0 / (1.0 + torch.exp(-logit))
            pc = torch.clamp(p, LOG_EPS, 1 - LOG_EPS)
            ll = -(t * torch.log(pc) + (1 - t) * torch.log(1 - pc))
            g, cot_h, cot_wl = torch.autograd.grad(torch.sum(sig_t * ll),
                                                   (w, hh, wwl))
        sq = (t - p.detach()[0]) ** 2
        return (-g, cot_h.to(F32), cot_wl.to(F32), (sig_t * sq).sum(),
                (sig_v * sq).sum(), sig_t.sum(), sig_v.sum())

    mids = [make_mid(s) for s in plan.stages[1:-1]]
    return {
        "first_fwd": first_fwd,
        "first_bwd": first_bwd,
        "mid_fwd": [m[0] for m in mids],
        "mid_bwd": [m[1] for m in mids],
        "head": head,
    }


"""Weight-update rules over flat parameter vectors (counterpart of
`shifu_tpu/train/updaters.py`).

Parity with core/dtrain/Weight.java and core/dtrain/nn/update/*,
expressed as plain functions (state, w, g) -> (w', state') on f32
tensors with a leading member axis: `w`, `g` and every state entry are
[M, n_flat]; `lr`, `it` and `nts` are [M] tensors, so grid trials
(their own `lr`), bagging members (their own `nts`) and ADAM's bias
correction (each member's own `it`) ride one call.

Convention inherited from Encog: `g` is the DESCENT direction
(accumulated -dE/dw summed over records, NOT averaged), so every rule
does `w += step(g)`. Propagation codes (train params "Propagation"):
    B  back propagation w/ momentum     Weight.updateWeightBP:246
    Q  quick propagation                Weight.updateWeightQBP:252
    M  manhattan                        Weight.updateWeightMHP:300
    R  resilient (RPROP+)               Weight.updateWeightRLP:313
    ADAM / ADAGRAD / RMSPROP / MOMENTUM / NESTEROV   nn/update/*.java
Regularization (Weight.calculateWeights:194-221): L2 subtracts
reg*w/numTrainSize from the step; L1 soft-thresholds the updated weight
by reg/numTrainSize. The optimizer rules fold the penalty into `g`.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

# RPROP constants (DTrainUtils.java:74-85, Weight.java:72-74)
POSITIVE_ETA = 1.2
NEGATIVE_ETA = 0.5
DELTA_MIN = 1e-6
DEFAULT_INITIAL_UPDATE = 0.1
DEFAULT_MAX_STEP = 50.0
ZERO_TOLERANCE = 1e-17
QPROP_DECAY = 1e-4
QPROP_OUTPUT_EPSILON = 0.35

State = Dict[str, torch.Tensor]
InitFn = Callable[[int, int, torch.device], State]
ApplyFn = Callable[..., Tuple[torch.Tensor, State]]


def _zeros(m: int, n: int, dev) -> torch.Tensor:
    return torch.zeros((m, n), dtype=torch.float32, device=dev)


def make_updater(
    propagation: str,
    momentum: float = 0.5,
    reg: float = 0.0,
    reg_level: str = "NONE",
    adam_beta1: float = 0.9,
    adam_beta2: float = 0.999,
) -> Tuple[InitFn, ApplyFn]:
    """Returns (init(M, n_weights, device) -> state,
                apply(state, w, g, lr, it, nts) -> (w', state'))."""
    prop = (propagation or "Q").upper()

    def regularize(w, step, nts):
        """Apply the step plus L1/L2 regularization (Weight.java:199-218)."""
        if reg_level == "L2" and reg != 0.0:
            return w + step - reg * w / nts
        if reg_level == "L1" and reg != 0.0:
            shrink = reg / nts
            updated = w + step
            return torch.sign(updated) * torch.clamp_min(
                torch.abs(updated) - shrink, 0.0)
        return w + step

    def reg_gradient(w, g, nts):
        """Fold the penalty into the descent direction for the optimizer
        branches (DenseLayer.java:193), so L2 works under every
        optimizer."""
        if reg_level == "L2" and reg != 0.0:
            return g - reg * w / nts
        if reg_level == "L1" and reg != 0.0:
            return g - reg * torch.sign(w) / nts
        return g

    def col(v):
        """[M] -> [M, 1], to broadcast over the flat axis."""
        return v[:, None]

    if prop == "B":

        def init(m, n, dev):
            return {"last_delta": _zeros(m, n, dev)}

        def apply(state, w, g, lr, it, nts):
            delta = g * col(lr) + state["last_delta"] * momentum
            return regularize(w, delta, col(nts)), {"last_delta": delta}

        return init, apply

    if prop == "M":

        def init(m, n, dev):
            return {}

        def apply(state, w, g, lr, it, nts):
            step = torch.where(torch.abs(g) < ZERO_TOLERANCE,
                               torch.zeros_like(g), torch.sign(g) * col(lr))
            return regularize(w, step, col(nts)), state

        return init, apply

    if prop == "Q":
        # Quickprop (Weight.updateWeightQBP:252-297); eps follows the
        # member's sample size

        def init(m, n, dev):
            return {"last_delta": _zeros(m, n, dev),
                    "last_gradient": _zeros(m, n, dev)}

        def apply(state, w, g, lr, it, nts):
            lr = col(lr)
            eps = QPROP_OUTPUT_EPSILON / torch.clamp_min(col(nts), 1.0)
            shrink = lr / (1.0 + lr)
            d = state["last_delta"]
            s = -g + QPROP_DECAY * w
            p = -state["last_gradient"]
            quad = d * s / (p - s)
            lin = -eps * s
            zero = torch.zeros_like(s)
            step_neg = torch.where(s > 0.0, lin, zero) + torch.where(
                s >= shrink * p, lr * d, quad)
            step_pos = torch.where(s < 0.0, lin, zero) + torch.where(
                s <= shrink * p, lr * d, quad)
            next_step = torch.where(
                d < 0.0, step_neg, torch.where(d > 0.0, step_pos, lin))
            return regularize(w, next_step, col(nts)), {
                "last_delta": next_step, "last_gradient": g}

        return init, apply

    if prop == "R":
        # RPROP+ (Weight.updateWeightRLP:313-343): per-weight adaptive
        # step, sign-change backtracking, last gradient zeroed after a
        # reversal

        def init(m, n, dev):
            return {
                "update_values": torch.full((m, n), DEFAULT_INITIAL_UPDATE,
                                            dtype=torch.float32, device=dev),
                "last_gradient": _zeros(m, n, dev),
                "last_delta": _zeros(m, n, dev),
            }

        def apply(state, w, g, lr, it, nts):
            change = torch.sign(g * state["last_gradient"])
            upd = state["update_values"]
            delta_pos = torch.clamp_max(upd * POSITIVE_ETA, DEFAULT_MAX_STEP)
            delta_neg = torch.clamp_min(upd * NEGATIVE_ETA, DELTA_MIN)
            new_upd = torch.where(
                change > 0, delta_pos, torch.where(change < 0, delta_neg, upd))
            wchange = torch.where(
                change > 0, torch.sign(g) * delta_pos,
                torch.where(change < 0, -state["last_delta"],
                            torch.sign(g) * upd))
            new_last_g = torch.where(change < 0, torch.zeros_like(g), g)
            return regularize(w, wchange, col(nts)), {
                "update_values": new_upd,
                "last_gradient": new_last_g,
                "last_delta": wchange,
            }

        return init, apply

    if prop == "ADAM":

        def init(m, n, dev):
            return {"m": _zeros(m, n, dev), "v": _zeros(m, n, dev)}

        def apply(state, w, g, lr, it, nts):
            g = reg_gradient(w, g, col(nts))
            m = adam_beta1 * state["m"] + (1 - adam_beta1) * g
            v = adam_beta2 * state["v"] + (1 - adam_beta2) * g * g
            it_f = col(torch.clamp_min(it.to(torch.float32), 1.0))
            m_hat = m / (1 - torch.pow(adam_beta1, it_f))
            v_hat = v / (1 - torch.pow(adam_beta2, it_f))
            step = col(lr) * m_hat / (torch.sqrt(v_hat) + 1e-8)
            return w + step, {"m": m, "v": v}

        return init, apply

    if prop == "ADAGRAD":

        def init(m, n, dev):
            return {"sum_sq": _zeros(m, n, dev)}

        def apply(state, w, g, lr, it, nts):
            g = reg_gradient(w, g, col(nts))
            s = state["sum_sq"] + g * g
            step = col(lr) * g / (torch.sqrt(s) + 1e-8)
            return w + step, {"sum_sq": s}

        return init, apply

    if prop == "RMSPROP":

        def init(m, n, dev):
            return {"cache": _zeros(m, n, dev)}

        def apply(state, w, g, lr, it, nts):
            g = reg_gradient(w, g, col(nts))
            cache = 0.9 * state["cache"] + 0.1 * g * g
            step = col(lr) * g / (torch.sqrt(cache) + 1e-8)
            return w + step, {"cache": cache}

        return init, apply

    if prop == "MOMENTUM":

        def init(m, n, dev):
            return {"v": _zeros(m, n, dev)}

        def apply(state, w, g, lr, it, nts):
            g = reg_gradient(w, g, col(nts))
            v = momentum * state["v"] + col(lr) * g
            return w + v, {"v": v}

        return init, apply

    if prop == "NESTEROV":

        def init(m, n, dev):
            return {"v": _zeros(m, n, dev)}

        def apply(state, w, g, lr, it, nts):
            g = reg_gradient(w, g, col(nts))
            v_prev = state["v"]
            v = momentum * v_prev - col(lr) * (-g)  # v = mom*v + lr*g
            w_new = w - momentum * v_prev + (1 + momentum) * v
            return w_new, {"v": v}

        return init, apply

    raise ValueError(f"unknown propagation/optimizer: {propagation}")

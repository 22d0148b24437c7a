"""Voted variable selection — the dvarsel genetic wrapper over a member
axis (counterpart of `shifu_tpu/varsel/voted.py`).

Parity: core/dvarsel/VarSelMaster.java:39 + wrapper/CandidateGenerator.java —
a population of candidate variable subsets ("seeds") evolves over
generations: every seed is trained/validated, seeds sort by validation
error, the best INHERIT, the middle CROSS over, the worst MUTATE
(nextGeneration), and after the configured generations the best seed wins
the vote (voteBestSeed).

One generation is one batched function over a leading member axis
[P, ...]: each candidate's feature subset is a {0,1} mask over the
feature axis applied to the first dense layer (x @ (W1 * mask[:, None]):
masked features get zero forward signal AND zero gradient), so P
candidate models train together on the shared matrix. The JAX package
vmaps one candidate's program; here the members' layers are batched
matmuls (`torch.matmul` of [n, d] by [P, d, h]) and the gradient of the
members' summed loss is each member's own (no term mixes two members).
The numpy draws (seeds, the valid mask, each generation's initial
weights, the GA's choices) are the JAX package's, in its order. Matmuls
stay in f32 (PyTorch's default keeps TF32 off for them).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from shifu_tpu_torch.utils.log import get_logger
from shifu_tpu_torch.utils.platform import DeviceLike, resolve_device

log = get_logger(__name__)


@dataclass
class VotedConfig:
    """Knobs mirror CandidateGenerator's params (defaults follow
    Constants.java / dvarsel defaults where the reference defines them).

    The candidate-model architecture/hyperparams come from the MODEL's
    training config (ValidationConductor trains the CONFIGURED network per
    seed, core/dvarsel/wrapper/ValidationConductor.java — not a fixed
    surrogate); `from_model_config` wires them."""

    expect_var_count: int = 20  # EXPECT_VARIABLE_CNT (varSelect.wrapperNum)
    population_size: int = 30  # POPULATION_LIVE_SIZE
    generations: int = 5  # POPULATION_MULTIPLY_CNT
    cross_percent: int = 60  # HYBRID_PERCENT
    mutation_percent: int = 20  # MUTATION_PERCENT
    hidden_nodes: List[int] = field(default_factory=lambda: [10])
    activations: List[str] = field(default_factory=lambda: ["tanh"])
    epochs: int = 30
    learning_rate: float = 0.05
    valid_rate: float = 0.2
    seed: int = 0

    @classmethod
    def from_model_config(cls, mc, **overrides) -> "VotedConfig":
        """Candidates train the model's own architecture/params (the NN
        trainer's wiring, so NumHiddenNodes/ActivationFunc/LearningRate
        track the deliverable model exactly); the epoch count is capped —
        the probe needs ranking fidelity, not a converged deliverable."""
        from shifu_tpu_torch.train.nn_trainer import NNTrainConfig

        ncfg = NNTrainConfig.from_model_config(mc)
        return cls(
            hidden_nodes=list(ncfg.hidden_nodes) or [10],
            activations=list(ncfg.activations) or ["tanh"],
            epochs=min(int(ncfg.num_epochs), 50),
            learning_rate=float(ncfg.learning_rate),
            valid_rate=float(ncfg.valid_set_rate or 0.2),
            **overrides,
        )


def layer_shapes(d: int, hidden_nodes) -> List[Tuple[int, int]]:
    sizes = [d] + list(hidden_nodes) + [1]
    return list(zip(sizes[:-1], sizes[1:]))


def n_weights(d: int, hidden_nodes) -> int:
    """Length of one candidate's flat weight vector."""
    return sum(fi * fo + fo for fi, fo in layer_shapes(d, hidden_nodes))


def eval_candidates(flat0: torch.Tensor, masks: torch.Tensor,
                    x: torch.Tensor, t: torch.Tensor, sig_tr: torch.Tensor,
                    sig_va: torch.Tensor, hidden_nodes, activations,
                    epochs: int, lr: float) -> torch.Tensor:
    """The candidates' validation errors [P]: flat0 [P, n_w] initial
    weights (the JAX `unflatten` layout: each layer's W [in, out] row-major
    then its b), masks [P, d], x [n, d], t / sig_tr / sig_va [n]. Each
    member takes `epochs` full-batch Adam steps (betas 0.9 / 0.999, bias
    correction 1 - beta^(step+1), eps 1e-8) on sum(sig_tr * (t - p)^2),
    p the sigmoid output; the error is the sig_va-weighted MSE."""
    from shifu_tpu_torch.models.nn import activation_fn, hidden_activation

    d = x.shape[1]
    shapes = layer_shapes(d, hidden_nodes)
    acts = list(activations)
    mask_col = masks[:, :, None]

    def fwd(flat: torch.Tensor) -> torch.Tensor:
        off = 0
        layers = []
        for fi, fo in shapes:
            w = flat[:, off:off + fi * fo].reshape(-1, fi, fo)
            off += fi * fo
            layers.append((w, flat[:, off:off + fo]))
            off += fo
        h = x
        for i, (w, b) in enumerate(layers[:-1]):
            if i == 0:
                w = w * mask_col
            h = activation_fn(hidden_activation(acts, i))(
                torch.matmul(h, w) + b[:, None, :])
        w, b = layers[-1]
        if len(layers) == 1:
            w = w * mask_col
        z = (torch.matmul(h, w) + b[:, None, :])[..., 0]
        return 1.0 / (1.0 + torch.exp(-z))

    flat = flat0.clone()
    m = torch.zeros_like(flat)
    v = torch.zeros_like(flat)
    one = np.float32(1.0)
    for step in range(int(epochs)):
        w = flat.detach().requires_grad_(True)
        with torch.enable_grad():
            p = fwd(w)
            (g,) = torch.autograd.grad((sig_tr * (t - p) ** 2).sum(), w)
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        k = np.float32(step + 1)
        mh = m / float(one - np.float32(0.9) ** k)
        vh = v / float(one - np.float32(0.999) ** k)
        flat = flat - lr * mh / (torch.sqrt(vh) + 1e-8)
    with torch.no_grad():
        sq = (t - fwd(flat)) ** 2
        return (sig_va * sq).sum(dim=1) / torch.clamp_min(sig_va.sum(), 1.0)


_PROGRAMS: Dict[tuple, object] = {}


def _get_eval_program(hidden_nodes: tuple, activations: tuple, epochs: int,
                      lr: float) -> Callable:
    """`eval_candidates` for one architecture behind the
    `varsel.vmap_train` profile seam (sync=True, as the JAX program)."""
    key = (tuple(hidden_nodes), tuple(activations), int(epochs), float(lr))
    prog = _PROGRAMS.get(key)
    if prog is None:
        from shifu_tpu_torch.obs import profile

        def run(flat0, masks, x, t, sig_tr, sig_va):
            return eval_candidates(flat0, masks, x, t, sig_tr, sig_va,
                                   hidden_nodes, activations, epochs, lr)

        prog = profile.wrap("varsel.vmap_train", run, sync=True)
        _PROGRAMS[key] = prog
    return prog


def _masks_from_seeds(seeds: List[List[int]], d: int) -> np.ndarray:
    masks = np.zeros((len(seeds), d), np.float32)
    for i, s in enumerate(seeds):
        masks[i, list(s)] = 1.0
    return masks


def _next_generation(seeds: List[List[int]], errors: np.ndarray,
                     cfg: VotedConfig, rng, d: int) -> List[List[int]]:
    """CandidateGenerator.nextGeneration: sort by error; best inherit,
    middle crossover (parents from the best pool), worst replaced by
    mutants."""
    order = np.argsort(errors)
    seeds = [seeds[i] for i in order]
    p = len(seeds)
    n_best = max(1, (100 - cfg.cross_percent - cfg.mutation_percent) * p // 100)
    n_cross = cfg.cross_percent * p // 100
    k = cfg.expect_var_count
    out = [list(s) for s in seeds[:n_best]]
    while len(out) < n_best + n_cross:
        a, b = rng.choice(n_best, size=2, replace=True)
        pool = sorted(set(seeds[a]) | set(seeds[b]))
        out.append(sorted(rng.choice(pool, size=min(k, len(pool)),
                                     replace=False).tolist()))
    while len(out) < p:
        out.append(sorted(rng.choice(d, size=min(k, d),
                                     replace=False).tolist()))
    return out


def voted_selection(
    feats: np.ndarray,
    tags: np.ndarray,
    weights: np.ndarray,
    cfg: VotedConfig,
    device: DeviceLike = None,
    history: Optional[List[Tuple[List[List[int]], np.ndarray]]] = None,
) -> Tuple[List[int], np.ndarray]:
    """Run the GA on `device` (None: the card); returns (best seed column
    indices, per-column vote frequency over the final population —
    diagnostic like the reference's worker vote tallies). `history`,
    when given, gets each generation's (seeds, candidate errors)."""
    dev = resolve_device(device)
    n, d = feats.shape
    rng = np.random.default_rng(cfg.seed)
    k = min(cfg.expect_var_count, d)
    seeds = [
        sorted(rng.choice(d, size=k, replace=False).tolist())
        for _ in range(cfg.population_size)
    ]
    valid = rng.random(n) < cfg.valid_rate
    sig_tr = (np.where(valid, 0.0, weights)).astype(np.float32)
    sig_va = (np.where(valid, weights, 0.0)).astype(np.float32)

    prog = _get_eval_program(tuple(cfg.hidden_nodes), tuple(cfg.activations),
                             cfg.epochs, cfg.learning_rate)
    n_total = n_weights(d, cfg.hidden_nodes)

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                               device=dev)

    x, t = put(feats), put(tags)
    sig_tr_t, sig_va_t = put(sig_tr), put(sig_va)

    best_seed: List[int] = seeds[0]
    best_err = float("inf")
    errors = np.zeros(len(seeds))
    for gen in range(cfg.generations):
        flats = rng.normal(0, 0.1, size=(len(seeds), n_total)).astype(
            np.float32)
        masks = _masks_from_seeds(seeds, d)
        errors = prog(put(flats), put(masks), x, t, sig_tr_t,
                      sig_va_t).cpu().numpy()
        if history is not None:
            history.append(([list(sd) for sd in seeds], errors))
        gi = int(np.argmin(errors))
        if float(errors[gi]) < best_err:
            best_err = float(errors[gi])
            best_seed = list(seeds[gi])
        log.info("voted varsel generation %d/%d: best err %.6f "
                 "(global best %.6f)", gen + 1, cfg.generations,
                 float(errors[gi]), best_err)
        if gen + 1 < cfg.generations:
            seeds = _next_generation(seeds, errors, cfg, rng, d)

    votes = _masks_from_seeds(seeds, d).sum(axis=0) / max(len(seeds), 1)
    return sorted(best_seed), votes

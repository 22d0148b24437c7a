"""Wide & Deep model: functional forward and the .wdl model spec
(counterpart of `shifu_tpu/models/wdl.py`).

Parity target: core/dtrain/wdl/WideAndDeep.java:50 (forward :163): a dense
input layer plus per-categorical-field embeddings feed an MLP (deep); a
wide tower of per-field vocab weights plus a linear dense part; the two
logits add and pass through a sigmoid. The whole batch is embedding
gathers and matmuls in torch on one device.

Inputs: dense [n, Dn] float32 (z-scaled numerics) and codes [n, Dc] int
(categorical bin indices incl. the missing slot, from CleanedData). Code
indices are clipped to [0, vocab - 1], never raised on.

A gather's backward sums up to a few thousand rows into each table row,
and that sum must run in one fixed order for two card runs to train to
the same bits. On the card the gather is advanced indexing, whose
backward (`index_put_(accumulate=True)`) sorts the indices and sums each
row's run in order; `embedding`'s backward there gave other bits from
run to run on an H100 at a [100, 8] table (`chip_smoke.py` phase 13
checks both). All the fields gather in one call, their tables stacked.
On the CPU it is `embedding`, whose backward adds each table row's
gradients in row order, where the CPU `index_put_` adds with float
atomics across threads (tests/test_torch_wdl.py pins three CPU runs
bit-equal). Parameters may carry a leading member axis
([M, ...] tables and layers) for the trainer's member loop; the forward
then returns [M, n].

The file is the JAX package's self-describing binary (magic `STWD`, `<I`
header length, the JSON header, raw `<f4` flat weights), byte for byte.
"""

from __future__ import annotations

import io
import json
import os
import struct
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from shifu_tpu_torch.models.nn import activation_fn
from shifu_tpu_torch.utils.platform import DeviceLike, resolve_device

MAGIC = b"STWD"
FORMAT_VERSION = 1


@dataclass
class WDLParams:
    """All arrays, grouped (numpy on the host, or tensors). Flattens to
    one vector for the update rules."""

    embed: List[Any]  # per cat field [vocab_f, E]
    wide: List[Any]  # per cat field [vocab_f]
    wide_dense: Any  # [Dn]
    dense_layers: List[Dict[str, Any]]  # deep MLP on [Dn + Dc*E]
    bias: Any  # [1]


def init_wdl_params(
    n_dense: int,
    vocab_sizes: List[int],
    embed_dim: int,
    hidden: List[int],
    seed: int = 0,
) -> WDLParams:
    """The JAX package's numpy draws from one default_rng(seed): the
    embeddings normal(0, 0.05) per field first, then Xavier-uniform per
    layer; wide, wide_dense, biases and bias start at zeros."""
    rng = np.random.default_rng(seed)
    embed = [
        rng.normal(0, 0.05, size=(v, embed_dim)).astype(np.float32)
        for v in vocab_sizes
    ]
    wide = [np.zeros(v, dtype=np.float32) for v in vocab_sizes]
    deep_in = n_dense + len(vocab_sizes) * embed_dim
    sizes = [deep_in] + list(hidden) + [1]
    dense_layers = []
    for fi, fo in zip(sizes[:-1], sizes[1:]):
        limit = np.sqrt(6.0 / (fi + fo))
        dense_layers.append({
            "W": rng.uniform(-limit, limit, size=(fi, fo)).astype(np.float32),
            "b": np.zeros(fo, dtype=np.float32),
        })
    return WDLParams(
        embed=embed,
        wide=wide,
        wide_dense=np.zeros(n_dense, dtype=np.float32),
        dense_layers=dense_layers,
        bias=np.zeros(1, dtype=np.float32),
    )


def params_from_jax(p) -> WDLParams:
    """Any WDLParams-like object (the JAX package's, numpy or jax arrays)
    -> this module's WDLParams of f32 numpy arrays."""
    f32 = lambda a: np.asarray(a, dtype=np.float32)  # noqa: E731
    return WDLParams(
        embed=[f32(a) for a in p.embed],
        wide=[f32(a) for a in p.wide],
        wide_dense=f32(p.wide_dense),
        dense_layers=[{"W": f32(layer["W"]), "b": f32(layer["b"])}
                      for layer in p.dense_layers],
        bias=f32(p.bias),
    )


def wdl_arrays(p: WDLParams) -> List[Any]:
    """The flat layout's order: embed..., wide..., wide_dense, (W, b)...,
    bias. The updaters, the checkpoints and the file depend on it."""
    out = list(p.embed) + list(p.wide) + [p.wide_dense]
    for layer in p.dense_layers:
        out.extend([layer["W"], layer["b"]])
    out.append(p.bias)
    return out


def wdl_shapes(p: WDLParams) -> List[Tuple[int, ...]]:
    return [tuple(a.shape) for a in wdl_arrays(p)]


def flatten_wdl(p: WDLParams) -> np.ndarray:
    return np.concatenate([np.asarray(a).ravel() for a in wdl_arrays(p)])


def _group(parts: list, n_cat: int) -> WDLParams:
    rest = parts[2 * n_cat + 1: -1]
    return WDLParams(
        embed=parts[:n_cat], wide=parts[n_cat: 2 * n_cat],
        wide_dense=parts[2 * n_cat],
        dense_layers=[{"W": rest[i], "b": rest[i + 1]}
                      for i in range(0, len(rest), 2)],
        bias=parts[-1])


def unflatten_wdl_from_shapes(flat, shapes, n_cat: int) -> WDLParams:
    """flat [n_flat] (numpy or tensor) -> WDLParams of views of it."""
    parts, off = [], 0
    for shp in shapes:
        size = int(np.prod(shp))
        parts.append(flat[off: off + size].reshape(shp))
        off += size
    return _group(parts, n_cat)


def unflatten_members(flat: torch.Tensor, shapes, n_cat: int) -> WDLParams:
    """flat [M, n_flat] -> WDLParams of [M, *shape] views (the trainer's
    member axis)."""
    parts, off, m = [], 0, flat.shape[0]
    for shp in shapes:
        size = int(np.prod(shp))
        parts.append(flat[:, off: off + size].reshape((m,) + tuple(shp)))
        off += size
    return _group(parts, n_cat)


def unflatten_wdl(flat, template: WDLParams) -> WDLParams:
    return unflatten_wdl_from_shapes(
        flat, wdl_shapes(template), len(template.embed)
    )


def params_to(p: WDLParams, device: DeviceLike) -> WDLParams:
    """WDLParams of f32 tensors on `device` (`None` is the card)."""
    dev = resolve_device(device)
    t = lambda a: torch.as_tensor(  # noqa: E731
        np.asarray(a, np.float32), device=dev)
    return WDLParams(
        embed=[t(a) for a in p.embed], wide=[t(a) for a in p.wide],
        wide_dense=t(p.wide_dense),
        dense_layers=[{"W": t(layer["W"]), "b": t(layer["b"])}
                      for layer in p.dense_layers],
        bias=t(p.bias))


def _gather_fields(tables, idx: torch.Tensor) -> torch.Tensor:
    """Per-field tables [V_f, E] (or [M, V_f, E]) and clipped codes
    idx [n, F] -> [n, F, E] (or [M, n, F, E]) in one gather over the
    tables stacked row-wise (and the members' stacked after each other),
    by the op whose backward sums in a fixed order on the tables' device
    (module docstring). One gather, not one a field: the card's sorted
    backward sums each table row's run in one warp, so it spreads over
    every field's and every member's rows at once."""
    vocab = [t.shape[-2] for t in tables]
    idx = idx + torch.as_tensor(np.cumsum([0] + vocab[:-1]),
                                device=idx.device)
    table = torch.cat(list(tables), dim=-2)
    if table.dim() == 3:
        m, v = table.shape[0], table.shape[1]
        offs = torch.arange(m, device=idx.device)[:, None, None] * v
        idx = idx[None] + offs
        table = table.reshape(m * v, table.shape[2])
    if table.is_cuda:
        return table[idx]
    return torch.nn.functional.embedding(idx, table)


def _gather_split(tables, idx: torch.Tensor, devices) -> torch.Tensor:
    """`_gather_fields` with the tables' embed columns split into one
    contiguous block a device of `devices` (a mesh's model group): each
    device gathers its block, and the blocks concatenate on the tables'
    device — the values (and, through autograd, each column's gradient)
    of the one-device gather."""
    home = tables[0].device
    e = tables[0].shape[-1]
    bounds = np.linspace(0, e, len(devices) + 1).round().astype(int)
    blocks = []
    for dev, lo, hi in zip(devices, bounds[:-1], bounds[1:]):
        if hi <= lo:
            continue
        part = [t[..., lo:hi].to(dev) for t in tables]
        blocks.append(_gather_fields(part, idx.to(dev)).to(home))
    return blocks[0] if len(blocks) == 1 else torch.cat(blocks, dim=-1)


def wdl_forward(p: WDLParams, dense: torch.Tensor, codes: torch.Tensor,
                activations: Sequence[str], logits_only: bool = False,
                embed_devices: Optional[Sequence[torch.device]] = None
                ) -> torch.Tensor:
    """dense [n, Dn], codes [n, Dc] -> [n] probability (or raw logit);
    with a member axis on `p`, [M, n]. The hidden activation of layer i is
    activations[i % len], relu when the list is empty. `embed_devices`
    (a mesh's model group) splits the embedding lookup's columns over
    those devices (`_gather_split`). The pieces (`wdl_deep_input`,
    `wdl_dense`, `wdl_wide_logit`) are what the co-resident pipeline's
    stages run, the same ops in the same order."""
    members = p.bias.dim() == 2
    idx = wdl_field_index(p.embed, codes)
    h = wdl_deep_input(p.embed, dense, idx,
                       p.bias.shape[0] if members else 0, embed_devices)
    h = wdl_dense(p.dense_layers, h, activations, 0,
                  len(p.dense_layers) - 1, members)
    deep_logit = h[..., 0]
    wide_logit = wdl_wide_logit(p.wide, p.wide_dense, dense, idx, members)
    logit = deep_logit + wide_logit + p.bias[..., :1]
    if logits_only:
        return logit
    return 1.0 / (1.0 + torch.exp(-logit))


def wdl_field_index(embed, codes: torch.Tensor) -> Optional[torch.Tensor]:
    """The categorical codes [n, F] clipped into each field's table, or
    None without categorical fields."""
    if not len(embed):
        return None
    return torch.stack([
        torch.clamp(codes[:, f].long(), 0, table.shape[-2] - 1)
        for f, table in enumerate(embed)], dim=1)


def wdl_deep_input(embed, dense: torch.Tensor, idx: Optional[torch.Tensor],
                   members: int = 0,
                   embed_devices: Optional[Sequence[torch.device]] = None
                   ) -> torch.Tensor:
    """The deep tower's input: the dense columns beside the embeddings
    ([n, Dn + F*E], or [M, n, ...] for `members` > 0)."""
    pieces = [dense.expand(members, *dense.shape) if members else dense]
    if idx is not None:
        emb = (_gather_split(embed, idx, embed_devices)
               if embed_devices is not None and len(embed_devices) > 1
               else _gather_fields(embed, idx))
        pieces.append(emb.reshape(*emb.shape[:-2], -1))
    return torch.cat(pieces, dim=-1)


def wdl_dense(layers, h: torch.Tensor, activations: Sequence[str], lo: int,
              n_hidden: int, members: bool) -> torch.Tensor:
    """Dense layers lo, lo + 1, ... of the deep tower over `h`: layer i
    below `n_hidden` applies its activation, the output layer none."""
    for i, layer in enumerate(layers, start=lo):
        z = torch.matmul(h, layer["W"]) + _row(layer["b"], members)
        if i < n_hidden:
            z = activation_fn(activations[i % len(activations)]
                              if activations else "relu")(z)
        h = z
    return h


def wdl_wide_logit(wide, wide_dense, dense: torch.Tensor,
                   idx: Optional[torch.Tensor], members: bool
                   ) -> torch.Tensor:
    """The wide tower's logit [n] (or [M, n]): the dense columns' linear
    term, then each field's table entry in field order."""
    if members:
        wide_logit = torch.matmul(wide_dense, dense.T)
    else:
        wide_logit = dense @ wide_dense
    if idx is not None:
        w = _gather_fields([t[..., None] for t in wide], idx)[..., 0]
        for f in range(len(wide)):
            wide_logit = wide_logit + w[..., f]
    return wide_logit


def _row(b: torch.Tensor, members: bool) -> torch.Tensor:
    """A bias [out] (or [M, out]) shaped to add to [n, out] ([M, n, out])."""
    return b[:, None, :] if members else b


class WDLNet(torch.nn.Module):
    """The forward as a module: the arrays are its parameters."""

    def __init__(self, params: WDLParams, activations: Sequence[str],
                 device: DeviceLike = None):
        super().__init__()
        p = params_to(params, device)
        param = torch.nn.Parameter
        self.embed = torch.nn.ParameterList([param(a) for a in p.embed])
        self.wide = torch.nn.ParameterList([param(a) for a in p.wide])
        self.wide_dense = param(p.wide_dense)
        self.weights = torch.nn.ParameterList(
            [param(layer["W"]) for layer in p.dense_layers])
        self.biases = torch.nn.ParameterList(
            [param(layer["b"]) for layer in p.dense_layers])
        self.bias = param(p.bias)
        self.activations = list(activations)

    def params(self) -> WDLParams:
        return WDLParams(
            embed=list(self.embed), wide=list(self.wide),
            wide_dense=self.wide_dense,
            dense_layers=[{"W": w, "b": b}
                          for w, b in zip(self.weights, self.biases)],
            bias=self.bias)

    def forward(self, dense: torch.Tensor, codes: torch.Tensor,
                logits_only: bool = False) -> torch.Tensor:
        return wdl_forward(self.params(), dense, codes, self.activations,
                           logits_only=logits_only)


@dataclass
class WDLModelSpec:
    hidden: List[int]
    activations: List[str]
    embed_dim: int
    dense_columns: List[str]
    cat_columns: List[str]
    vocab_sizes: List[int]
    # raw-record scoring info
    norm_specs: List[Dict[str, Any]] = field(default_factory=list)  # dense
    norm_cutoff: float = 4.0
    categories: List[List[str]] = field(default_factory=list)  # per cat col
    norm_type: str = "ZSCALE"
    algorithm: str = "WDL"
    params: Optional[WDLParams] = None
    train_error: Optional[float] = None
    valid_error: Optional[float] = None

    def header(self) -> dict:
        return {
            "formatVersion": FORMAT_VERSION,
            "algorithm": "WDL",
            "hidden": self.hidden,
            "activations": self.activations,
            "embedDim": self.embed_dim,
            "denseColumns": self.dense_columns,
            "catColumns": self.cat_columns,
            "vocabSizes": self.vocab_sizes,
            "normSpecs": self.norm_specs,
            "normCutoff": self.norm_cutoff,
            "categories": self.categories,
            "normType": self.norm_type,
            "trainError": self.train_error,
            "validError": self.valid_error,
            "shapes": [list(s) for s in wdl_shapes(self.params)],
        }

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        head_bytes = json.dumps(self.header()).encode("utf-8")
        buf = io.BytesIO()
        buf.write(MAGIC)
        buf.write(struct.pack("<I", len(head_bytes)))
        buf.write(head_bytes)
        buf.write(flatten_wdl(self.params).astype("<f4").tobytes())
        with open(path, "wb") as fh:
            fh.write(buf.getvalue())

    @classmethod
    def load(cls, path: str) -> "WDLModelSpec":
        with open(path, "rb") as fh:
            data = fh.read()
        if data[:4] != MAGIC:
            raise ValueError(f"{path}: not a shifu-tpu .wdl model")
        (hlen,) = struct.unpack("<I", data[4:8])
        head = json.loads(data[8: 8 + hlen].decode("utf-8"))
        flat = np.frombuffer(data[8 + hlen:], dtype="<f4").copy()
        spec = cls(
            hidden=head["hidden"],
            activations=head["activations"],
            embed_dim=head["embedDim"],
            dense_columns=head["denseColumns"],
            cat_columns=head["catColumns"],
            vocab_sizes=head["vocabSizes"],
            norm_specs=head.get("normSpecs", []),
            norm_cutoff=float(head.get("normCutoff", 4.0)),
            categories=head.get("categories", []),
            norm_type=head.get("normType", "ZSCALE"),
            train_error=head.get("trainError"),
            valid_error=head.get("validError"),
        )
        spec.params = unflatten_wdl(flat, spec.template())
        return spec

    def template(self) -> WDLParams:
        """Zero-seed params of this spec's shapes (the unflatten layout)."""
        return init_wdl_params(len(self.dense_columns), self.vocab_sizes,
                               self.embed_dim, self.hidden)

    def independent(self, device: DeviceLike = None
                    ) -> "IndependentWDLModel":
        return IndependentWDLModel(self, device=device)


class IndependentWDLModel:
    """Zero-dependency scorer (parity: wdl/IndependentWDLModel.java:46)
    with its weights on `device` (`None` is the card)."""

    def __init__(self, spec: WDLModelSpec, device: DeviceLike = None):
        self.spec = spec
        self.device = resolve_device(device)
        self.params = params_to(spec.params, self.device)

    @classmethod
    def load(cls, path: str, device: DeviceLike = None
             ) -> "IndependentWDLModel":
        return cls(WDLModelSpec.load(path), device=device)

    def inputs_from_raw(self, data) -> Tuple[np.ndarray, np.ndarray]:
        """ColumnarData -> (dense [n, Dn], codes [n, Dc]) using the embedded
        norm plan (dense) and category lists."""
        from shifu_tpu_torch.norm.normalizer import (apply_norm_plan,
                                                     plan_from_json)

        plan = plan_from_json({
            "normType": self.spec.norm_type,
            "cutoff": self.spec.norm_cutoff,
            "columns": self.spec.norm_specs,
        })
        dense = (
            apply_norm_plan(plan, data, device=self.device)
            if plan.specs
            else np.zeros((data.n_rows, 0), np.float32)
        )
        return dense, wdl_codes(self.spec, data)

    def compute_parts(self, dense: np.ndarray, codes: np.ndarray
                      ) -> np.ndarray:
        """(dense, codes) -> [n] f32 probabilities. The dense matrix is
        made row-major first: a column selection may be column-major, and
        the GEMM's bits follow the layout."""
        d = torch.as_tensor(np.ascontiguousarray(dense, np.float32),
                            device=self.device)
        c = torch.as_tensor(np.asarray(codes, np.int64), device=self.device)
        with torch.no_grad():
            out = wdl_forward(self.params, d, c, self.spec.activations)
        return out.cpu().numpy()

    def compute_raw(self, data) -> np.ndarray:
        dense, codes = self.inputs_from_raw(data)
        return self.compute_parts(dense, codes)


def wdl_codes(spec: WDLModelSpec, data) -> np.ndarray:
    """The categorical index matrix [n, Dc] of raw records: each field's
    category position, the missing slot len(categories) for unseen or
    missing values."""
    from shifu_tpu_torch.stats.binning import categorical_bin_index

    codes = np.zeros((data.n_rows, len(spec.cat_columns)), np.int32)
    for f, name in enumerate(spec.cat_columns):
        codes[:, f] = categorical_bin_index(
            data.column(name), spec.categories[f], data.missing_mask(name))
    return codes

"""Device mesh of the data-parallel trainers (counterpart of
`shifu_tpu/parallel/mesh.py`).

The reference trains master + workers as Hadoop mappers (Guagua); the
JAX package runs one SPMD program over a mesh of local devices. Here a
mesh is one process over local devices too: an ordered tuple of
`torch.device`s, one a ROW SHARD. A trainer splits its rows into
contiguous blocks, block s on `devices[s]`, keeps replicated state on
each distinct device, and merges the shards' partial sums on the lead
device (`devices[0]`) in shard order (`psum`): the DTMaster / NNMaster
merge, with shards standing in for workers.

A device may repeat: `data_mesh(virtual=S)` puts S shards on one device.
Such a virtual mesh runs every line of the meshed path but the copies
between devices; it is what the tests run on the CPU (the counterpart of
the JAX package's 8 virtual CPU devices), and what one card runs.
Between two cards a partial travels as one peer copy (`Tensor.to` of the
lead device, which orders itself after the producing stream); there is
no process group and no NCCL: NCCL wants a process a card.

Axis names are the JAX package's: ('data',), or ('dcn', 'data') when
`dcn_slices` groups the shards (the reduce then sums within each slice
first, `hierarchical_reduce`). The `model` axis (WDL embedding tensor
parallelism) is ROADMAP A.13. More than one host is a data-plane
matter, not a mesh one: `lifecycle_hosts` / `lifecycle_host_index` give
the process count and index the lifecycle's `HostPlan` splits chunks by
(`data/pipeline.py`, `parallel/hostsync.py`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from shifu_tpu_torch.obs import registry
from shifu_tpu_torch.utils import environment
from shifu_tpu_torch.utils.errors import ErrorCode, ShifuError
from shifu_tpu_torch.utils.platform import DeviceLike, resolve_device


@dataclass(frozen=True)
class Mesh:
    """Row shards over devices: `devices[s]` holds shard s; `shape` is
    the device grid over `axis_names` (row-major, shard s = flat index)."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = ("data",)
    shape: Tuple[int, ...] = ()

    def __post_init__(self):
        if not self.shape:
            object.__setattr__(self, "shape", (len(self.devices),))
        if int(np.prod(self.shape)) != len(self.devices):
            raise ValueError(f"mesh shape {self.shape} does not hold "
                             f"{len(self.devices)} devices")

    @property
    def lead(self) -> torch.device:
        return self.devices[0]

    @property
    def size(self) -> int:
        return len(self.devices)

    def distinct(self) -> List[torch.device]:
        """The mesh's devices without repeats, in shard order."""
        out: List[torch.device] = []
        for d in self.devices:
            if d not in out:
                out.append(d)
        return out


def _not_ported(what: str) -> ShifuError:
    return ShifuError(ErrorCode.ILLEGAL_ARGUMENT,
                      f"{what} is not ported yet (ROADMAP A.13)")


def data_mesh(n_devices: Optional[int] = None, model_axis: int = 1,
              dcn_slices: Optional[int] = None, *,
              device: DeviceLike = None,
              virtual: Optional[int] = None) -> Mesh:
    """Mesh over the first `n_devices` of the `torch.cuda.device_count()`
    cards (all by default), or with `virtual=S`, S shards on `device`
    (cuda by default; "cpu" in the tests). `dcn_slices` groups the
    shards into that many slices, outermost, as the JAX mesh's `dcn`
    axis. `model_axis` > 1 raises naming ROADMAP A.13."""
    if model_axis > 1:
        raise _not_ported(f"data_mesh(model_axis={model_axis}): the WDL "
                          "embedding tables' model axis")
    if virtual is not None:
        dev = resolve_device(device)
        devices = [dev] * max(1, int(virtual))
    else:
        resolve_device(device if device is not None else "cuda")
        count = torch.cuda.device_count()
        n = count if n_devices is None else int(n_devices)
        if not 1 <= n <= count:
            raise ValueError(f"data_mesh({n_devices}): {count} card(s)")
        devices = [torch.device("cuda", i) for i in range(n)]
    n = len(devices)
    registry().gauge("mesh.devices").set(n)
    if dcn_slices and dcn_slices > 1:
        if n % dcn_slices:
            raise ValueError(f"{n} shards do not split into {dcn_slices} "
                             "slices")
        return Mesh(tuple(devices), ("dcn", "data"),
                    (dcn_slices, n // dcn_slices))
    return Mesh(tuple(devices))


def train_mesh(device: torch.device) -> Optional[Mesh]:
    """The `shifu train` steps' mesh (JAX `processor/train_tree.py:125`,
    `processor/train.py:603-608`): every card when the step runs on cuda
    and there is more than one, else None (one device)."""
    if device.type == "cuda" and torch.cuda.device_count() > 1:
        return data_mesh()
    return None


def lifecycle_hosts() -> int:
    """Host (process) count of the lifecycle data plane:
    `shifu.lifecycle.hosts` when set (> 0), else 1."""
    return max(1, environment.get_int("shifu.lifecycle.hosts", 1))


def lifecycle_host_index() -> int:
    """This process's host index in [0, lifecycle_hosts()):
    `shifu.lifecycle.hostIndex` when set, else 0. The JAX package falls
    back to `jax.process_index()`; torch has no process numbering
    without a process group, so the launcher pins the index."""
    return max(0, environment.get_int("shifu.lifecycle.hostIndex", 0))


def lifecycle_shards(device: DeviceLike = None) -> int:
    """Row shards of the streamed lifecycle folds: `shifu.lifecycle.
    shards` when set (> 0), else the mesh's device count: every card
    when the step runs on cuda, 1 on the CPU."""
    n = environment.get_int("shifu.lifecycle.shards", 0)
    if n > 0:
        return n
    if device is not None and torch.device(device).type == "cuda":
        return max(1, torch.cuda.device_count())
    return 1


def lifecycle_mesh(n_shards: int, device: torch.device) -> Mesh:
    """The folds' mesh: shard s on card s % count on cuda (more shards
    than cards share them), every shard on the CPU otherwise."""
    n = max(1, int(n_shards))
    if device.type == "cuda":
        count = max(1, torch.cuda.device_count())
        return Mesh(tuple(torch.device("cuda", s % count)
                          for s in range(n)))
    return Mesh((device,) * n)


def reduce_topology() -> str:
    """shifu.reduce.topology: `auto` (hierarchical on a mesh with a dcn
    axis), `hierarchical`, or `flat` (one pass in shard order, the
    bit-parity reference)."""
    v = environment.get_property("shifu.reduce.topology", "auto")
    v = (v or "auto").strip().lower()
    return v if v in ("auto", "hierarchical", "flat") else "auto"


def hierarchical_reduce(mesh: Mesh) -> bool:
    """Whether `psum` sums within each dcn slice first, then one partial
    a slice across slices."""
    return "dcn" in row_axes(mesh) and reduce_topology() != "flat"


def row_axes(mesh: Mesh) -> Tuple[str, ...]:
    """Axis names rows shard over: ('dcn', 'data') or ('data',)."""
    return tuple(a for a in mesh.axis_names if a in ("dcn", "data"))


def row_shard_count(mesh: Mesh) -> int:
    """Row shards = the product of the row axes' sizes."""
    shape = dict(zip(mesh.axis_names, mesh.shape))
    n = 1
    for a in row_axes(mesh):
        n *= shape.get(a, 1)
    return n


def round_up_rows(n: int, mesh: Mesh) -> int:
    """Smallest row count >= n that splits evenly over the row shards."""
    m = row_shard_count(mesh)
    return -(-n // m) * m


def pad_rows(arrays: Sequence[np.ndarray], multiple: int
             ) -> Tuple[list, int]:
    """Pad the row axis to a multiple with zeros (padded rows must carry
    zero significance). Returns (arrays, original row count)."""
    n = arrays[0].shape[0]
    target = -(-n // multiple) * multiple
    if target == n:
        return list(arrays), n
    out = []
    for a in arrays:
        pad = np.zeros((target - n,) + a.shape[1:], dtype=a.dtype)
        out.append(np.concatenate([a, pad], axis=0))
    return out, n


def shard_rows(array, mesh: Mesh) -> List[torch.Tensor]:
    """Split the leading axis into `mesh.size` contiguous blocks, block s
    on `devices[s]` (as `NamedSharding` splits it). The row count must
    divide evenly (`pad_rows`)."""
    t = array if isinstance(array, torch.Tensor) else torch.as_tensor(
        np.ascontiguousarray(array))
    S = mesh.size
    if t.shape[0] % S:
        raise ValueError(f"{t.shape[0]} rows do not split over {S} shards")
    b = t.shape[0] // S
    reg = registry()
    reg.counter("mesh.shard_rows", axes="x".join(row_axes(mesh))).inc()
    reg.counter("mesh.h2d_bytes").inc(float(t.numel() * t.element_size()))
    return [t[s * b:(s + 1) * b].to(d).contiguous()
            for s, d in enumerate(mesh.devices)]


def shard_padded(t: torch.Tensor, mesh: Mesh, axis: int = 0
                 ) -> List[torch.Tensor]:
    """`t` padded with zeros along `axis` to `round_up_rows` and split
    into one contiguous block a shard, block s on `devices[s]` (the
    padding must carry zero significance, as in `pad_rows`)."""
    n = t.shape[axis]
    n_pad = round_up_rows(n, mesh)
    if n_pad > n:
        shape = list(t.shape)
        shape[axis] = n_pad - n
        t = torch.cat([t, torch.zeros(shape, dtype=t.dtype,
                                      device=t.device)], dim=axis)
    b = n_pad // mesh.size
    return [t.narrow(axis, s * b, b).to(d).contiguous()
            for s, d in enumerate(mesh.devices)]


def mesh_device(mesh: Optional[Mesh], device: DeviceLike
                ) -> Tuple[Optional[Mesh], torch.device]:
    """(mesh, the device replicated state lives on) of a trainer's
    arguments: a mesh's lead device (its devices replace `device`), and
    a one-shard mesh is the one-device run on its device."""
    if mesh is None:
        return None, resolve_device(device)
    if mesh.size == 1:
        return None, mesh.lead
    return mesh, mesh.lead


def replicate(t: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    """One copy of `t` a distinct device, as a list a shard (shards on
    one device share it)."""
    reg = registry()
    reg.counter("mesh.replicated_arrays").inc()
    reg.counter("mesh.h2d_bytes").inc(float(t.numel() * t.element_size()))
    by_dev = {d: (t if t.device == d else t.to(d, non_blocking=True))
              for d in mesh.distinct()}
    return [by_dev[d] for d in mesh.devices]


def psum(parts: Sequence[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """Sum of the shards' partials on the lead device in shard order, in
    their dtype; under `hierarchical_reduce`, within each dcn slice
    first, then the slices' sums in slice order."""
    lead = mesh.lead

    def add(xs):
        out = xs[0].to(lead, non_blocking=True)
        for x in xs[1:]:
            out = out + x.to(lead, non_blocking=True)
        return out

    if hierarchical_reduce(mesh):
        per = mesh.shape[-1]
        return add([add(list(parts[i:i + per]))
                    for i in range(0, len(parts), per)])
    return add(list(parts))

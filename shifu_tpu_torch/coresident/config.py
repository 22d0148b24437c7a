"""Co-resident trainer knobs + run configuration (counterpart of
`shifu_tpu/coresident/config.py`).

Every operational choice is a `-Dshifu.coresident.*` knob, so the
trainer is tuned from the same surface as the serving fleet it rides
on.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from shifu_tpu_torch.utils import environment

DEFAULT_WAIT_MS = 30000.0


def stages_setting() -> int:
    """shifu.coresident.stages — pipeline stage count K (0 = choose from
    the ledger grant's free budget, see plan.default_stages)."""
    return environment.get_int("shifu.coresident.stages", 0)


def microbatches_setting() -> int:
    """shifu.coresident.microbatches — GPipe microbatches per shard
    filling the pipeline (1 = whole shard at once)."""
    return environment.get_int("shifu.coresident.microbatches", 1)


def wait_ms_setting() -> float:
    """shifu.coresident.waitMs — how long an evicted trainer polls for
    re-admission before giving up with EvictedError."""
    return environment.get_float("shifu.coresident.waitMs",
                                 DEFAULT_WAIT_MS)


def throttle_ms_setting() -> float:
    """shifu.coresident.throttleMs — host sleep between epochs: the
    background tenant yields the devices to serving traffic (0 = run
    flat out)."""
    return environment.get_float("shifu.coresident.throttleMs", 0.0)


def tenant_setting() -> str:
    """shifu.coresident.tenant — the ledger tenant name the trainer
    registers under (the `/admin`-visible identity)."""
    return environment.get_property("shifu.coresident.tenant",
                                    "retrain") or "retrain"


def replicas_setting() -> int:
    """shifu.coresident.replicas — data-parallel pipeline replicas; the
    per-stage gradients all-reduce through parallel/mesh.fleet_reduce
    when > 1."""
    return environment.get_int("shifu.coresident.replicas", 1)


@dataclass
class CoresidentConfig:
    """One co-resident training run's shape. Field defaults of 0/""
    mean "read the knob" — resolve() pins them so the checkpoint
    identity hashes concrete values."""

    stages: int = 0           # 0 = from the grant (plan.default_stages)
    microbatches: int = 0     # 0 = knob (default 1)
    replicas: int = 0         # 0 = knob (default 1)
    tenant: str = ""          # "" = knob (default "retrain")
    serve_url: Optional[str] = None
    wait_ms: float = -1.0     # < 0 = knob
    throttle_ms: float = -1.0  # < 0 = knob
    family_dir: str = "."     # checkpoint-family root (.shifu/runs/ckpt)
    meta: dict = field(default_factory=dict)

    def resolve(self) -> "CoresidentConfig":
        if not self.stages:
            self.stages = max(0, stages_setting())
        if not self.microbatches:
            self.microbatches = max(1, microbatches_setting())
        if not self.replicas:
            self.replicas = max(1, replicas_setting())
        if not self.tenant:
            self.tenant = tenant_setting()
        if self.wait_ms < 0:
            self.wait_ms = max(0.0, wait_ms_setting())
        if self.throttle_ms < 0:
            self.throttle_ms = max(0.0, throttle_ms_setting())
        return self

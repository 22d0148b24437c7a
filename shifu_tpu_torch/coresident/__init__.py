"""Co-resident preemptible trainer: retrain as a device-memory ledger
tenant (counterpart of `shifu_tpu/coresident/`).

`shifu retrain` can run beside the serving fleet on the same card
instead of needing a card of its own: the trainer is a
`priority=background` tenant of the zoo's `HbmLedger` (serve/zoo.py),
evicted first under serving pressure, and resumes bit-identically.

  config.py    the `-Dshifu.coresident.*` knobs and `CoresidentConfig`.
  plan.py      stage partitioning — split the NN/WDL flat parameter
               vector into K contiguous layer groups (pipeline
               parallelism), each stage on one device.
  pipeline.py  the per-stage forward/backward programs; stage
               boundaries carry f32 activations (bf16 lives only inside
               matmuls) and the backward rematerializes the forward
               (GPipe).
  tenant.py    the grant protocol — the trainer is a `background`
               ledger tenant: bytes acquired BEFORE every
               `.to(device)`, evictable strictly first under serving
               pressure, never the other way around.
  trainer.py   the epoch loops. `stages=1, microbatches=1` is
               bit-identical to train_nn_streamed / train_wdl_streamed;
               eviction checkpoints through a ShardedStreamCheckpoint
               family (one part a stage) and resume is bit-identical to
               an uninterrupted run.
"""

from shifu_tpu_torch.coresident.config import CoresidentConfig
from shifu_tpu_torch.coresident.tenant import (
    EvictedError,
    GrantFullError,
    HttpGrant,
    LocalGrant,
    ZooGrant,
)
from shifu_tpu_torch.coresident.trainer import (
    train_nn_coresident,
    train_wdl_coresident,
)

__all__ = [
    "CoresidentConfig",
    "EvictedError",
    "GrantFullError",
    "HttpGrant",
    "LocalGrant",
    "ZooGrant",
    "train_nn_coresident",
    "train_wdl_coresident",
]

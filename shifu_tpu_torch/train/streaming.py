"""Larger-than-memory training: the route decision only (counterpart of
`shifu_tpu/train/streaming.py:44-66`).

`should_stream_training` decides whether a data directory is trained in
memory or streamed shard by shard. The streamed trainers themselves
(`ShardFeed`, the streamed NN and tree growers) wait for ROADMAP A.13;
until then a caller that is told "stream" raises.
"""

from __future__ import annotations

from shifu_tpu_torch.norm.dataset import read_meta
from shifu_tpu_torch.utils import environment

DEFAULT_TRAIN_BUDGET_MB = 1024


def train_memory_budget_bytes() -> int:
    """shifu.train.memoryBudgetMB — datasets whose normalized matrix exceeds
    it stream from shards instead of concatenating into one host array
    (the reference's trainOnDisk / MemoryDiskFloatMLDataSet envelope,
    shifuconfig:46-50)."""
    mb = environment.get_int("shifu.train.memoryBudgetMB",
                             DEFAULT_TRAIN_BUDGET_MB)
    return int(mb) * 1024 * 1024


def should_stream_training(data_dir: str, force_attr: bool = False) -> bool:
    if environment.get_property("shifu.train.forceStreaming", "") in (
        "true", "1",
    ):
        return True
    if force_attr:
        return True
    try:
        meta = read_meta(data_dir)
    except Exception:  # no shard meta yet: nothing on disk to stream
        return False
    n_cols = len(meta.columns)
    return meta.n_rows * n_cols * 4 > train_memory_budget_bytes()

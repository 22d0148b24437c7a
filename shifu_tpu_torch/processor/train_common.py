"""Shared trainer-orchestration helpers (counterpart of
`shifu_tpu/processor/train_common.py`).

The progress-line format is a CONTRACT (the reference's NNOutput progress
files are tailed by TailThread and parsed by downstream tooling,
TrainModelProcessor.java:1862) — it must exist in exactly one place.

Both writers ALSO record the per-epoch errors as registry time series
(train.train_error / train.valid_error labeled by trainer), so the run
manifest carries the full loss curve, not just the tail of a progress file.
"""

from __future__ import annotations

from typing import Callable, List


def progress_line(trainer_id: int, epoch: int, train_err: float,
                  valid_err: float) -> str:
    return (f"Trainer {trainer_id} Epoch #{epoch} "
            f"Train Error:{train_err:.8f} Validation Error:{valid_err:.8f}\n")


def record_epoch(trainer_id: int, epoch: int, train_err: float,
                 valid_err: float) -> None:
    """Per-epoch loss point -> registry series (resolved at call time so a
    step-boundary registry reset redirects recording transparently)."""
    from shifu_tpu_torch.obs import registry

    reg = registry()
    reg.series("train.train_error", trainer=trainer_id).append(
        epoch, train_err)
    reg.series("train.valid_error", trainer=trainer_id).append(
        epoch, valid_err)


def progress_writer(path: str, trainer_id: int = 0,
                    echo: bool = True) -> Callable:
    """Single-trainer progress callback: (epoch, train_err, valid_err).
    `echo` mirrors the line to the console (the reference TailThread tails
    progress files to the console for interactive runs)."""
    from shifu_tpu_torch.utils.log import get_logger

    log = get_logger(__name__)

    def cb(it, tr, va):
        with open(path, "a") as fh:
            fh.write(progress_line(trainer_id, it, tr, va))
        record_epoch(trainer_id, it, tr, va)
        if echo:
            log.info("trainer %d epoch %d train %.6f valid %.6f",
                     trainer_id, it, tr, va)

    return cb


def member_progress_writer(paths: List[str]) -> Callable:
    """Member-axis progress callback: ((member, epoch), tr, va)."""

    def cb(member_it, tr, va):
        i, it = member_it
        with open(paths[i], "a") as fh:
            fh.write(progress_line(i, it, tr, va))
        record_epoch(i, it, tr, va)

    return cb

"""Logging setup shared by the port's modules."""

from __future__ import annotations

import logging
import sys


def get_logger(name: str) -> logging.Logger:
    return logging.getLogger(name)


def configure(verbose: bool = False) -> None:
    """Idempotent on repeated calls (force=True replaces root handlers, so
    the latest call wins)."""
    logging.basicConfig(
        level=logging.DEBUG if verbose else logging.INFO,
        stream=sys.stderr,
        format="%(asctime)s %(levelname)-5s %(name)s - %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S",
        force=True,
    )

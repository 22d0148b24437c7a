"""Device resolution shared by every entry point of the port.

`device=None` means the card: cuda when it is present, an error when it
is not. The CPU runs only when a caller asks for it by name (the tests
do), so a run never drops quietly from the card to the CPU.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[None, str, torch.device]


class DeviceUnavailable(RuntimeError):
    """The card was asked for (explicitly or by default) and is absent."""


def resolve_device(device: DeviceLike = None) -> torch.device:
    """None -> cuda (raises without CUDA); "cpu"/"cuda[:i]"/torch.device
    as given, with cuda checked for availability."""
    if device is None:
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DeviceUnavailable(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU explicitly")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


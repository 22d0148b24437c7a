"""Per-chip peak table + roofline math for the program profiler
(counterpart of `shifu_tpu/obs/costmodel.py`).

A profile seam's cost says what a program *does* (FLOPs, bytes moved):
on the port that is the analytic count of a kernel entry's bound
(ops/hist_kernel.py `entry_cost`), since torch has no XLA
`cost_analysis()`. This module says what the card *could* do (peak
dense-matmul FLOP/s, peak memory bandwidth), so the profiler
(obs/profile.py) can turn the counts into achieved-vs-peak utilization
(MFU), arithmetic intensity, and a roofline verdict: a program whose
FLOPs-per-byte sits below the card's machine balance is memory-bound —
more tensor-core efficiency cannot speed it up, only fewer bytes can
(the Williams/Waterman/Patterson roofline model).

Peaks are public per-card numbers (dense bf16 TFLOP/s, HBM GB/s),
matched by the `torch.cuda.get_device_name` substring. The CPU entry is
a NOMINAL figure so dev-harness rooflines classify sensibly; treat CPU
MFU as relative only.

Override knobs (for unlisted cards, or a card capped below 700 W):
    -Dshifu.profile.peakTflops=<float>   peak dense TFLOP/s
    -Dshifu.profile.peakGBs=<float>      peak memory bandwidth GB/s
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional


class ChipPeaks(NamedTuple):
    """Peak envelope of one accelerator chip."""

    name: str
    kind: str            # raw device name (or "" when undetected)
    peak_tflops: float   # dense matmul TFLOP/s (bf16)
    peak_hbm_gbs: float  # memory bandwidth GB/s
    source: str          # "table" | "override" | "nominal"

    @property
    def machine_balance(self) -> float:
        """FLOPs per byte at the roofline ridge point."""
        return (self.peak_tflops * 1e12) / (self.peak_hbm_gbs * 1e9)


# device-name substring -> (display name, peak dense bf16 TFLOP/s,
# HBM GB/s). The H100 SXM (NVIDIA H100 80GB HBM3) at its 700 W limit.
# First substring match wins.
CHIP_TABLE = (
    ("h100", ("NVIDIA H100 SXM", 989.0, 3350.0)),
)

# Dev-harness nominal: a few AVX cores' worth of f32 matmul and one DDR
# channel-ish of bandwidth. Roofline classification stays meaningful;
# absolute CPU MFU is not a benchmark number.
CPU_NOMINAL = ("CPU (nominal)", 0.25, 25.0)


def lookup(kind: str) -> Optional[ChipPeaks]:
    """Table entry for a device_kind string, or None if unlisted."""
    low = (kind or "").lower()
    for key, (name, tflops, gbs) in CHIP_TABLE:
        if key in low:
            return ChipPeaks(name, kind, tflops, gbs, "table")
    return None


def _overridden(peaks: ChipPeaks) -> ChipPeaks:
    from shifu_tpu_torch.utils import environment

    tflops = environment.get_float("shifu.profile.peakTflops", 0.0)
    gbs = environment.get_float("shifu.profile.peakGBs", 0.0)
    if tflops <= 0.0 and gbs <= 0.0:
        return peaks
    return ChipPeaks(
        peaks.name,
        peaks.kind,
        tflops if tflops > 0.0 else peaks.peak_tflops,
        gbs if gbs > 0.0 else peaks.peak_hbm_gbs,
        "override",
    )


def detect() -> ChipPeaks:
    """Peaks for the current card (override > table > nominal), read
    through `torch.cuda.get_device_name`. Never raises: no card (or no
    CUDA build of torch) yields the nominal CPU entry."""
    kind = ""
    try:
        import torch

        if torch.cuda.is_available():
            kind = torch.cuda.get_device_name(0)
    except Exception:  # any torch/CUDA init failure -> nominal CPU entry
        kind = ""
    entry = lookup(kind)
    if entry is None:
        name, tflops, gbs = CPU_NOMINAL
        entry = ChipPeaks(name, kind, tflops, gbs, "nominal")
    return _overridden(entry)


def roofline_verdict(flops: float, bytes_accessed: float,
                     peaks: ChipPeaks) -> Optional[str]:
    """Static classification from arithmetic intensity vs machine balance
    (needs no timing, so it holds for async-dispatched programs too)."""
    if not bytes_accessed or flops is None:
        return None
    ai = flops / bytes_accessed
    return "compute-bound" if ai >= peaks.machine_balance else "memory-bound"


def derive(flops: Optional[float], bytes_accessed: Optional[float],
           device_seconds: Optional[float],
           peaks: ChipPeaks) -> Dict[str, Optional[float]]:
    """Achieved-vs-peak numbers for one program (or a totals row).
    Timing-dependent fields are None when `device_seconds` is falsy."""
    out: Dict[str, Optional[float]] = {
        "arithmeticIntensity": None,
        "achievedTflops": None,
        "achievedGBps": None,
        "mfu": None,
        "membw": None,
        "roofline": None,
    }
    if flops is None:
        return out
    if bytes_accessed:
        out["arithmeticIntensity"] = round(flops / bytes_accessed, 4)
        out["roofline"] = roofline_verdict(flops, bytes_accessed, peaks)
    if device_seconds and device_seconds > 0.0:
        tflops = flops / device_seconds / 1e12
        out["achievedTflops"] = round(tflops, 6)
        out["mfu"] = round(tflops / peaks.peak_tflops, 6)
        if bytes_accessed:
            gbps = bytes_accessed / device_seconds / 1e9
            out["achievedGBps"] = round(gbps, 4)
            out["membw"] = round(gbps / peaks.peak_hbm_gbs, 6)
    return out


def peaks_dict(peaks: ChipPeaks) -> dict:
    """JSON form embedded in profile snapshots/manifests."""
    return {
        "name": peaks.name,
        "deviceKind": peaks.kind,
        "peakTflops": peaks.peak_tflops,
        "peakHbmGBs": peaks.peak_hbm_gbs,
        "machineBalance": round(peaks.machine_balance, 4),
        "source": peaks.source,
    }

"""Stage wall-clock timers (counterpart of `shifu_tpu/utils/timing.py`).

`StageTimers` lives in the metrics registry (obs/metrics.py) as the
multi-stage facade over the Timer kind; importing it from here keeps
working. Registry-backed construction (`MetricsRegistry.stage_timers(
prefix)`) additionally lands the timings in the step's run manifest.
"""

from __future__ import annotations

from shifu_tpu_torch.obs.metrics import StageTimers

__all__ = ["StageTimers"]

"""Admission control: a bounded queue, explicit load-shed, drain on
shutdown (counterpart of `shifu_tpu/serve/queue.py`).

Under overload the contract is to reject, not to buffer: a request the
backend cannot start within its budget is worth more as an immediate
429-style `RejectedError` than as a queue entry that times out. The
micro-batcher (batcher.py) drains this queue as fast as the device
scores; everything past `depth` waiting requests is shed at the door.

`close()` flips the queue to rejecting at once; admitted requests keep
draining (`get` returns None only once the queue is closed AND empty).

The JAX package counts admissions and sheds in its metrics registry;
here they are plain numbers on the queue (`admitted`, `shed`), read by
the replica's snapshot and /healthz.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, Optional

from shifu_tpu_torch.utils import environment

DEFAULT_QUEUE_DEPTH = 128


def queue_depth_setting() -> int:
    """shifu.serve.queueDepth: the admission bound (shed beyond it)."""
    return environment.get_int("shifu.serve.queueDepth", DEFAULT_QUEUE_DEPTH)


class RejectedError(RuntimeError):
    """Request shed by admission control (HTTP 429).

    `reason` is "full" (depth saturated) or "closed" (shutdown)."""

    def __init__(self, reason: str, depth: int = 0) -> None:
        self.reason = reason
        self.depth = depth
        msg = ("admission queue full (depth %d) — load shed" % depth
               if reason == "full"
               else "server shutting down — request rejected")
        super().__init__(msg)


class AdmissionQueue:
    """Bounded FIFO with shed-on-full admission and drain-aware close."""

    def __init__(self, depth: Optional[int] = None) -> None:
        self.depth = queue_depth_setting() if depth is None else int(depth)
        if self.depth <= 0:
            raise ValueError("admission queue depth must be positive")
        self._items: deque = deque()
        self._cond = threading.Condition()
        self._closed = False
        self.admitted = 0
        self.shed: Dict[str, int] = {"full": 0, "closed": 0}

    def put(self, item: Any) -> None:
        """Admit `item` or raise RejectedError; never blocks."""
        with self._cond:
            if self._closed:
                self.shed["closed"] += 1
                raise RejectedError("closed")
            if len(self._items) >= self.depth:
                self.shed["full"] += 1
                raise RejectedError("full", depth=self.depth)
            self._items.append(item)
            self.admitted += 1
            self._cond.notify()

    def get(self, timeout: Optional[float] = None) -> Optional[Any]:
        """The next admitted item; None when the queue is closed AND
        empty (drain complete) or, with a timeout, when nothing arrived
        in time (`closed` tells the two apart)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while not self._items:
                if self._closed:
                    return None
                if deadline is None:
                    self._cond.wait()
                else:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or not self._cond.wait(remaining):
                        if not self._items:
                            return None
            return self._items.popleft()

    def close(self) -> None:
        """Stop admitting; wake every waiter so the drain can finish."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    @property
    def closed(self) -> bool:
        with self._cond:
            return self._closed

    def __len__(self) -> int:
        with self._cond:
            return len(self._items)

    def snapshot(self) -> dict:
        with self._cond:
            return {"depth": self.depth, "queued": len(self._items),
                    "admitted": self.admitted, "shed": dict(self.shed),
                    "closed": self._closed}

"""Admission control: a bounded queue, explicit load-shed, drain on
shutdown (counterpart of `shifu_tpu/serve/queue.py`).

Under overload the contract is to reject, not to buffer: a request the
backend cannot start within its budget is worth more as an immediate
429-style `RejectedError` than as a queue entry that times out. The
micro-batcher (batcher.py) drains this queue as fast as the device
scores; everything past `depth` waiting requests is shed at the door.

`close()` flips the queue to rejecting at once; admitted requests keep
draining (`get` returns None only once the queue is closed AND empty).

Admissions and sheds count in the obs registry (`serve.queue.admitted`,
`serve.queue.shed{reason=}`, the `serve.queue.depth` gauge, labeled by
replica) as in the JAX package; the replica's snapshot reads them
back from there.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from shifu_tpu_torch.obs import registry
from shifu_tpu_torch.obs.metrics import _parse_key
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

    def __init__(self, depth: Optional[int] = None,
                 labels: Optional[dict] = None) -> None:
        self.depth = queue_depth_setting() if depth is None else int(depth)
        if self.depth <= 0:
            raise ValueError("admission queue depth must be positive")
        self.labels = dict(labels or {})
        self._items: deque = deque()
        self._cond = threading.Condition()
        self._closed = False

    def put(self, item: Any) -> None:
        """Admit `item` or raise RejectedError; never blocks."""
        reg = registry()
        with self._cond:
            if self._closed:
                reg.counter("serve.queue.shed", reason="closed",
                            **self.labels).inc()
                raise RejectedError("closed")
            if len(self._items) >= self.depth:
                reg.counter("serve.queue.shed", reason="full",
                            **self.labels).inc()
                raise RejectedError("full", depth=self.depth)
            self._items.append(item)
            depth = len(self._items)
            self._cond.notify()
        reg.counter("serve.queue.admitted", **self.labels).inc()
        reg.gauge("serve.queue.depth", **self.labels).set(depth)

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
        """Its state, and its counts read from the obs registry."""
        snap = registry().snapshot()
        shed = {"full": 0, "closed": 0}
        for labels, v in labelled_values(snap, "counters", "serve.queue.shed",
                                         self.labels):
            shed[labels["reason"]] += int(v)
        admitted = sum(v for _, v in labelled_values(
            snap, "counters", "serve.queue.admitted", self.labels))
        with self._cond:
            return {"depth": self.depth, "queued": len(self._items),
                    "admitted": int(admitted), "shed": shed,
                    "closed": self._closed}


def labelled_values(snap: dict, kind: str, name: str,
                    labels: Dict[str, str]) -> List[Tuple[dict, Any]]:
    """(labels, value) of each series of `name` in a registry snapshot's
    `kind` section that carries every one of `labels` (a replica's
    series; with no labels, every series)."""
    out = []
    for key, v in snap[kind].items():
        n, got = _parse_key(key)
        if n == name and all(got.get(k) == x for k, x in labels.items()):
            out.append((got, v))
    return out

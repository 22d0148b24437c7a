"""The trainer-as-tenant grant protocol (counterpart of
`shifu_tpu/coresident/tenant.py`).

The trainer never touches a device byte it has not been granted: every
host-counted buffer is `acquire`d BEFORE its `.to(device)` (the serving
tenants' invariant, applied to training). Three grant backends, one
protocol:

  ZooGrant    in-process against a live ModelZoo (a serve process
              trains inside itself).
  HttpGrant   against a remote serve process's `/admin/coresident/*`
              plane (`shifu retrain --coresident --serve-url ...`).
  LocalGrant  a private HbmLedger with no serving fleet — standalone
              runs and tests keep the exact accounting discipline
              without a zoo.

`heartbeat` is the preemption channel: the zoo evicts a background
tenant by dropping its ledger charge and flagging it; the trainer
learns at its next epoch boundary, checkpoints, releases its buffers,
and polls for re-admission — or surfaces `EvictedError` so the caller
can `--resume` later. The grace window between the flag and the drop
is bounded by one epoch.
"""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.request
from typing import Optional

from shifu_tpu_torch.utils.log import get_logger

log = get_logger(__name__)


class GrantFullError(RuntimeError):
    """The grant cannot fit the requested bytes right now (background
    acquires are fit-or-fail: a trainer never evicts a serving
    tenant)."""

    def __init__(self, msg: str, deficit: int = 0) -> None:
        super().__init__(msg)
        self.deficit = int(deficit)


class EvictedError(RuntimeError):
    """The ledger evicted the trainer and re-admission did not land
    within the wait window. State is checkpointed; resume with
    `--resume` once serving pressure subsides."""

    def __init__(self, tenant: str, epoch: int) -> None:
        super().__init__(
            f"co-resident trainer {tenant!r} evicted at epoch {epoch}; "
            "checkpointed — resume with --resume")
        self.tenant = tenant
        self.epoch = int(epoch)


class Grant:
    """Protocol base. Subclasses implement the five verbs."""

    name = ""

    def admit(self, meta: Optional[dict] = None) -> dict:
        raise NotImplementedError

    def acquire(self, nbytes: int) -> None:
        raise NotImplementedError

    def reduce(self, nbytes: int) -> None:
        raise NotImplementedError

    def heartbeat(self, epoch: int) -> bool:
        raise NotImplementedError

    def release(self, final: bool = False) -> None:
        raise NotImplementedError

    def free_bytes(self) -> Optional[int]:
        """Unused budget headroom (None = unbounded) — what
        plan.default_stages sizes K from."""
        return None

    def wait_readmit(self, nbytes: int, wait_ms: float,
                     poll_s: float = 0.25) -> bool:
        """Poll `acquire` until the evicted trainer's bytes fit again
        or the window closes. On True the charge is HELD — the caller
        places its buffers without re-acquiring."""
        deadline = time.monotonic() + max(0.0, wait_ms) / 1000.0
        while True:
            try:
                self.admit()  # clears the evicted flag server-side
                self.acquire(nbytes)
                return True
            except (GrantFullError, OSError):
                if time.monotonic() >= deadline:
                    return False
                time.sleep(poll_s)


class LocalGrant(Grant):
    """A private ledger: same acquire-before-put bookkeeping, no
    serving fleet to contend with (budget_mb=0 = unbounded)."""

    def __init__(self, name: str = "retrain",
                 budget_mb: float = 0.0) -> None:
        from shifu_tpu_torch.serve.zoo import HbmLedger

        self.name = name
        self.ledger = HbmLedger(budget_mb)

    def admit(self, meta: Optional[dict] = None) -> dict:
        return {"freeBytes": self.free_bytes(), "devices": 0}

    def acquire(self, nbytes: int) -> None:
        from shifu_tpu_torch.serve.zoo import LedgerFullError

        try:
            self.ledger.acquire(self.name, "background", int(nbytes))
        except LedgerFullError as e:
            raise GrantFullError(str(e), e.deficit) from e

    def reduce(self, nbytes: int) -> None:
        self.ledger.reduce(self.name, "background", int(nbytes))

    def heartbeat(self, epoch: int) -> bool:
        return False

    def release(self, final: bool = False) -> None:
        self.ledger.release(self.name, "background")

    def free_bytes(self) -> Optional[int]:
        if not self.ledger.budget_bytes:
            return None
        return max(0, self.ledger.budget_bytes - self.ledger.used)


class ZooGrant(Grant):
    """In-process grant against a live ModelZoo: the trainer is a
    first-class `priority=background` tenant of the serving ledger."""

    def __init__(self, zoo, name: str = "retrain") -> None:
        self.zoo = zoo
        self.name = name

    def admit(self, meta: Optional[dict] = None) -> dict:
        return self.zoo.admit_background(self.name, meta=meta)

    def acquire(self, nbytes: int) -> None:
        from shifu_tpu_torch.serve.zoo import LedgerFullError

        try:
            self.zoo.background_acquire(self.name, int(nbytes))
        except LedgerFullError as e:
            raise GrantFullError(str(e), e.deficit) from e

    def reduce(self, nbytes: int) -> None:
        self.zoo.background_reduce(self.name, int(nbytes))

    def heartbeat(self, epoch: int) -> bool:
        return bool(self.zoo.background_heartbeat(self.name, epoch))

    def release(self, final: bool = False) -> None:
        self.zoo.background_release(self.name, final=final)

    def free_bytes(self) -> Optional[int]:
        ledger = self.zoo.ledger
        if not ledger.budget_bytes:
            return None
        return max(0, ledger.budget_bytes - ledger.used)


class HttpGrant(Grant):
    """Grant over the serve process's `/admin/coresident/*` plane."""

    def __init__(self, url: str, name: str = "retrain",
                 timeout_s: float = 10.0) -> None:
        self.url = url.rstrip("/")
        self.name = name
        self.timeout_s = float(timeout_s)
        self._free: Optional[int] = None

    def _post(self, action: str, payload: dict) -> dict:
        body = json.dumps({"tenant": self.name, **payload}).encode()
        req = urllib.request.Request(
            f"{self.url}/admin/coresident/{action}", data=body,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req,
                                        timeout=self.timeout_s) as resp:
                return json.loads(resp.read().decode() or "{}")
        except urllib.error.HTTPError as e:
            detail = e.read().decode(errors="replace")
            if e.code == 409:
                deficit = 0
                try:
                    deficit = int(json.loads(detail).get("deficit", 0))
                except (ValueError, TypeError, AttributeError):
                    deficit = 0  # detail is free-form on other 409s
                raise GrantFullError(
                    f"grant {action} refused: {detail}", deficit) from e
            raise

    def admit(self, meta: Optional[dict] = None) -> dict:
        out = self._post("admit", {"meta": meta or {}})
        self._free = out.get("freeBytes")
        return out

    def acquire(self, nbytes: int) -> None:
        self._post("charge", {"bytes": int(nbytes)})

    def reduce(self, nbytes: int) -> None:
        self._post("charge", {"bytes": -int(nbytes)})

    def heartbeat(self, epoch: int) -> bool:
        return bool(self._post("heartbeat",
                               {"epoch": int(epoch)}).get("evicted"))

    def release(self, final: bool = False) -> None:
        self._post("release", {"final": bool(final)})

    def free_bytes(self) -> Optional[int]:
        return self._free

"""Multi-tenant model zoo on a bounded device-memory budget (counterpart
of `shifu_tpu/serve/zoo.py`).

One deployment, many model sets: the reference serves one model set per
JVM fleet; a plain `ScoringServer` keeps that assumption — one resident
`ReplicaFleet`. Production wants the TensorFlow-paper shape
instead (shared devices partitioned between heterogeneous programs): N
tenants behind one server on a FIXED device-memory budget, where a
tenant is a complete model set with its own `/score/<set>` route, its
own per-replica `SwappableRegistry` stack (drift windows, version
counters, traffic-log stream, shadow gates) — all riding the existing
replica fleet — and residency is a managed, accounted resource rather
than an accident of construction order.

Three pieces:

  HbmLedger   the budget ledger. Every byte a tenant puts on device is
              acquired BEFORE the copy that moves it (the registry's
              `put_hook` seam) and priced afterwards from the registry's
              `memory_analysis()` (weights + the widest warm bucket's
              analytic program bytes + the device staging buffers), so
              `used <= budget` holds at every instant BY CONSTRUCTION
              and the ledger's high-water mark (`peak`) is the proof.
              `-Dshifu.serve.hbmBudgetMB` (0 = unbounded). The budget
              bounds allocated bytes (`torch.cuda.memory_allocated`),
              not the caching allocator's reserved ones.
  ZooTenant   one registered model set: registration survives eviction
              (models dir — the PROMOTED dir, not the original —, warm
              buckets to re-warm, last measured cost, the traffic-log
              stream and drift monitor), residency does not.
  ModelZoo    admission, LRU eviction, streamed shadow staging, and the
              per-tenant continuous-loop seams.

Admission & eviction: a tenant whose weights alone exceed the whole
budget is rejected at REGISTRATION (`ErrorCode.ILLEGAL_ARGUMENT` — it
could never serve). Admission past the budget evicts cold tenants in
strict LRU order (least-recently-scored first; ties break by
registration order then name, deterministically) — an evicted tenant's
device weights, staging buffers and drift window are dropped together
(`ModelRegistry.release`), the eviction is ledgered
(`serve.zoo.evictions{tenant=,reason=}`), and re-admission rebuilds the
identical registry from the identical files, so re-admitted scores are
bit-identical to never-evicted ones (pinned in tests/test_zoo.py). A
tenant mid-stage/mid-promote, or with a staged shadow, is never chosen
and an explicit evict of it is REFUSED — evicting the swap target would
strand the rollout.

Cold starts never hang the admission queue: a request for a non-
resident tenant kicks a background admission and is answered 429 with a
Retry-After derived from OBSERVED warm-up time (this tenant's last
admission, else the zoo-wide average, else
`-Dshifu.serve.zoo.warmupMs`), minus the time the in-flight admission
has already spent. `/healthz` carries `zoo.residentTenants` /
`zoo.hbmBudgetUsedMB` and a non-sticky `cold_start` degrade reason
while any admission is in flight.

Streamed shadow staging: `stage()` threads the ledger's acquire through
the registry's per-layer-group `put_hook`, so a candidate's weights
land group by group, each group admitted (evicting cold tenants if
needed) BEFORE its copy to the device — a promote on a near-full budget
never materializes a full second registry and never OOMs; the ledger's
peak proves residency stayed inside the budget through the whole
stage -> shadow-score -> promote sequence. On promote the OLD active
version's charge is released and the shadow's charge becomes the
active one.
"""

from __future__ import annotations

import os
import re
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

from shifu_tpu_torch.analysis.racetrack import tracked_lock
from shifu_tpu_torch.serve.fleet import ReplicaFleet, replica_devices
from shifu_tpu_torch.serve.registry import estimate_weights_bytes
from shifu_tpu_torch.utils import environment
from shifu_tpu_torch.utils.errors import ErrorCode, ShifuError
from shifu_tpu_torch.utils.log import get_logger
from shifu_tpu_torch.utils.platform import DeviceLike

log = get_logger(__name__)

MB = 1024.0 * 1024.0

# tenant states
COLD = "cold"            # registered, nothing on device
ADMITTING = "admitting"  # background build+warm in flight
RESIDENT = "resident"    # serving
EVICTING = "evicting"    # draining out of the budget

# URL-safe tenant names: they become /score/<set> path segments and
# tenant= metric label values
_NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9_.-]{0,63}$")

# cold-start histogram edges: admissions are 100ms..minutes, not the
# sub-ms LATENCY_BUCKETS scale
COLD_START_BUCKETS = tuple(0.05 * 2 ** k for k in range(16)) + (
    float("inf"),)

# Retry-After clamp for cold starts (wider than the queue clamp: a
# an admission that warms many buckets legitimately takes seconds)
COLD_RETRY_MIN_S = 1.0
COLD_RETRY_MAX_S = 120.0

DEFAULT_WARMUP_MS = 5000.0
EVICT_DRAIN_TIMEOUT_S = 30.0


def hbm_budget_mb_setting() -> float:
    """shifu.serve.hbmBudgetMB — total device-memory budget the zoo's
    ledger admits tenants against (0 = unbounded)."""
    return environment.get_float("shifu.serve.hbmBudgetMB", 0.0)


def zoo_warmup_ms_setting() -> float:
    """shifu.serve.zoo.warmupMs — cold-start Retry-After fallback before
    any admission has been observed."""
    return environment.get_float("shifu.serve.zoo.warmupMs",
                                 DEFAULT_WARMUP_MS)


class LedgerFullError(RuntimeError):
    """The budget cannot fit the requested bytes and nothing is
    evictable (every other tenant is cold, busy, or shadow-staged)."""

    def __init__(self, msg: str, deficit: int = 0) -> None:
        super().__init__(msg)
        self.deficit = int(deficit)


class ColdStartError(RuntimeError):
    """The tenant is not resident; admission is in flight. HTTP answers
    429 + Retry-After (never a hung connection while a warm-up runs)."""

    def __init__(self, tenant: str, retry_after_s: float,
                 detail: str = "") -> None:
        super().__init__(
            f"tenant {tenant} is warming up"
            + (f" ({detail})" if detail else "")
            + f" — retry in {retry_after_s:.0f}s")
        self.tenant = tenant
        self.reason = "cold_start"
        self.retry_after_s = float(retry_after_s)


class HbmLedger:
    """Budget-accounted residency: (tenant, kind) -> charged bytes.

    `kind` is "active" (the serving version) or "shadow" (a staged
    candidate); `transfer()` renames shadow -> active at promote.
    Acquire NEVER records past the budget — the caller (ModelZoo) evicts
    between attempts — so `peak <= budget` is an invariant, not a hope;
    the gauges serve.zoo.hbm_used_bytes / hbm_peak_bytes publish it."""

    def __init__(self, budget_mb: float = 0.0) -> None:
        self.budget_bytes = int(max(0.0, float(budget_mb)) * MB)
        self._lock = tracked_lock("serve.zoo.ledger")
        self._charges: Dict[tuple, int] = {}
        self._used = 0
        self._peak = 0
        from shifu_tpu_torch.obs import registry

        registry().gauge("serve.zoo.hbm_budget_bytes").set(
            self.budget_bytes)

    def acquire(self, tenant: str, kind: str, nbytes: int) -> None:
        """Charge `nbytes` to (tenant, kind) or raise LedgerFullError
        with the deficit — never over-commits."""
        nbytes = int(nbytes)
        if nbytes <= 0:
            return
        with self._lock:
            if (self.budget_bytes
                    and self._used + nbytes > self.budget_bytes):
                deficit = self._used + nbytes - self.budget_bytes
                raise LedgerFullError(
                    f"HBM budget full: {tenant}/{kind} needs {nbytes} "
                    f"bytes, {deficit} over the "
                    f"{self.budget_bytes} budget", deficit)
            self._charges[(tenant, kind)] = (
                self._charges.get((tenant, kind), 0) + nbytes)
            self._used += nbytes
            self._peak = max(self._peak, self._used)
            used = self._used
            peak = self._peak
            tb = self._tenant_bytes(tenant)
        self._publish(used, peak, tenant, tb)

    def reduce(self, tenant: str, kind: str, nbytes: int) -> None:
        """Shrink a charge (measured cost came in under the streamed
        estimate)."""
        with self._lock:
            have = self._charges.get((tenant, kind), 0)
            cut = min(have, max(0, int(nbytes)))
            if cut:
                self._charges[(tenant, kind)] = have - cut
                self._used -= cut
            used, peak = self._used, self._peak
            tb = self._tenant_bytes(tenant)
        self._publish(used, peak, tenant, tb)

    def release(self, tenant: str, kind: str) -> int:
        """Drop the whole (tenant, kind) charge; returns it."""
        with self._lock:
            freed = self._charges.pop((tenant, kind), 0)
            self._used -= freed
            used, peak = self._used, self._peak
            tb = self._tenant_bytes(tenant)
        self._publish(used, peak, tenant, tb)
        return freed

    def transfer(self, tenant: str, src: str, dst: str) -> None:
        """Rename a charge (shadow -> active at promote): no byte moves,
        so no budget check and no instant of double counting."""
        with self._lock:
            amt = self._charges.pop((tenant, src), 0)
            if amt:
                self._charges[(tenant, dst)] = (
                    self._charges.get((tenant, dst), 0) + amt)
            used, peak = self._used, self._peak
            tb = self._tenant_bytes(tenant)
        self._publish(used, peak, tenant, tb)

    def charge_of(self, tenant: str, kind: Optional[str] = None) -> int:
        with self._lock:
            if kind is not None:
                return self._charges.get((tenant, kind), 0)
            return sum(v for (t, _k), v in self._charges.items()
                       if t == tenant)

    @property
    def used(self) -> int:
        with self._lock:
            return self._used

    @property
    def peak(self) -> int:
        with self._lock:
            return self._peak

    def _tenant_bytes(self, tenant: str) -> int:
        # caller holds self._lock
        return sum(v for (t, _k), v in self._charges.items()
                   if t == tenant)

    def _publish(self, used: int, peak: int,
                 tenant: Optional[str] = None,
                 tenant_bytes: int = 0) -> None:
        # gauges set OUTSIDE the ledger lock (the racetrack discipline:
        # tracked metric locks never nest under subsystem locks)
        from shifu_tpu_torch.obs import registry

        reg = registry()
        reg.gauge("serve.zoo.hbm_used_bytes").set(used)
        reg.gauge("serve.zoo.hbm_peak_bytes").set(peak)
        if tenant is not None:
            # per-tenant residency: the mutated tenant's new total
            # (evicted = 0, so the series reads true, not stale) — the
            # fleet view / `shifu top` attribute HBM occupancy per
            # tenant per process from this one series
            reg.gauge("serve.zoo.tenant_hbm_bytes",
                      tenant=tenant).set(tenant_bytes)

    def snapshot(self) -> dict:
        with self._lock:
            charges = dict(self._charges)
            used, peak = self._used, self._peak
        per: Dict[str, float] = {}
        for (tenant, _kind), v in charges.items():
            per[tenant] = per.get(tenant, 0) + v
        return {
            "budgetMB": round(self.budget_bytes / MB, 3),
            "usedMB": round(used / MB, 3),
            "peakMB": round(peak / MB, 3),
            "tenantsMB": {t: round(v / MB, 3)
                          for t, v in sorted(per.items())},
        }


class BackgroundTenant:
    """A `priority=background` ledger tenant — the co-resident trainer.

    Background tenants hold ledger bytes but never serve scores; under
    serving pressure they are evicted STRICTLY FIRST (the LRU never
    picks a serving tenant while any background charge remains), and
    their own acquires are fit-or-fail (a trainer never evicts a
    serving tenant to stay resident). Eviction here is a FLAG plus an
    immediate charge drop: the trainer observes the flag at its next
    epoch-boundary heartbeat, checkpoints, and frees its device buffers
    — a grace window bounded by one epoch (see docs/SERVING.md)."""

    def __init__(self, name: str, reg_seq: int,
                 meta: Optional[dict] = None) -> None:
        self.name = name
        self.reg_seq = int(reg_seq)
        self.meta = dict(meta or {})
        self.epoch = -1                 # last heartbeat epoch
        self.evict_requested = False
        self.evictions = 0
        self.admitted_at = time.time()

    def snapshot(self) -> dict:
        return {
            "priority": "background",
            "epoch": self.epoch,
            "stages": self.meta.get("stages"),
            "algo": self.meta.get("algo"),
            "evictRequested": self.evict_requested,
            "evictions": self.evictions,
        }


def load_set_configs(root: str):
    """(column configs, model config) of the model set at `root`, each
    None where its file is absent or malformed: serving degrades to
    plain scoring, never to a failed start (one loader for the
    single-tenant server and the zoo)."""
    from shifu_tpu_torch.config import ModelConfig, load_column_config_list

    ccs = mc = None
    cc_path = os.path.join(root, "ColumnConfig.json")
    mc_path = os.path.join(root, "ModelConfig.json")
    try:
        if os.path.isfile(cc_path):
            ccs = load_column_config_list(cc_path)
    except Exception as e:  # a malformed config degrades, never kills
        log.warning("cannot load %s (%s)", cc_path, e)
    try:
        if os.path.isfile(mc_path):
            mc = ModelConfig.load(mc_path)
    except Exception as e:  # a malformed config degrades, never kills
        log.warning("cannot load %s (%s)", mc_path, e)
    return ccs, mc


def drift_monitor_for(models_dir: str, column_configs, model_config):
    """The set's drift monitor over the columns its models read (a
    column varsel dropped is not in the requests; the JAX server watches
    every binned column and fails each batch on such a set: ROADMAP
    C.16), or None when nothing is watchable."""
    if not column_configs:
        return None
    from shifu_tpu_torch.loop.drift import DriftMonitor
    from shifu_tpu_torch.serve.registry import model_set_columns

    schema = set(model_set_columns(models_dir, column_configs,
                                   model_config))
    drift = DriftMonitor([cc for cc in column_configs
                          if cc.column_name in schema])
    return drift if drift.enabled else None


class ZooTenant:
    """One registered model set. Registration state survives eviction;
    everything device-resident lives behind `fleet` and drops with it."""

    def __init__(self, name: str, root: str, models_dir: str,
                 column_configs=None, model_config=None,
                 reg_seq: int = 0) -> None:
        self.name = name
        self.root = root              # the set's own config root
        self.models_dir = models_dir  # as registered
        self.active_dir = models_dir  # tracks promotes across evictions
        self.column_configs = column_configs
        self.model_config = model_config
        self.reg_seq = int(reg_seq)
        self.state = COLD
        self.fleet: Optional[ReplicaFleet] = None
        self.scorer = None
        self.drift = None
        self.traffic = None
        self.label_cols: List[str] = []
        self.busy: Optional[str] = None   # "stage" | "promote" in flight
        self.shadow_staged = False
        self.last_used = 0.0              # monotonic; 0 = never scored
        self.requests = 0
        self.evictions = 0
        self.warm_buckets: List[int] = []
        self.warm_seconds: Optional[float] = None  # observed admission
        self.admit_started = 0.0
        self.admit_event: Optional[threading.Event] = None
        self.admit_error: Optional[str] = None
        self.admit_evict = True  # may this admission evict others?
        self._obs_lock = tracked_lock("serve.zoo.tenant_observe")
        self.observed_batches = 0
        self.last_drift_verdict: Optional[dict] = None

    def lru_key(self) -> tuple:
        """Strict, deterministic eviction order: least-recently-scored
        first; never-scored tenants tie at 0.0 and break by registration
        order, then name — so an eviction decision is reproducible from
        the ledger alone."""
        return (self.last_used, self.reg_seq, self.name)

    def snapshot(self) -> dict:
        snap = {
            "state": self.state,
            "modelsDir": self.active_dir,
            "requests": self.requests,
            "evictions": self.evictions,
            "warmBuckets": list(self.warm_buckets),
        }
        if self.warm_seconds is not None:
            snap["warmSeconds"] = round(self.warm_seconds, 3)
        if self.busy:
            snap["busy"] = self.busy
        if self.shadow_staged:
            snap["shadowStaged"] = True
        if self.admit_error:
            snap["admitError"] = self.admit_error
        fleet = self.fleet
        if fleet is not None and self.state == RESIDENT:
            snap["sha"] = fleet.sha
            if self.last_drift_verdict is not None:
                v = self.last_drift_verdict
                snap["drift"] = {"status": v["status"],
                                 "maxPsi": round(v["maxPsi"], 6)}
        return snap


class ModelZoo:
    """N model sets behind one server on one HBM budget."""

    def __init__(self, root: str = ".",
                 n_replicas: Optional[int] = None,
                 budget_mb: Optional[float] = None,
                 queue_depth: Optional[int] = None,
                 max_batch_rows: Optional[int] = None,
                 max_wait_ms: Optional[float] = None,
                 batching: Optional[str] = None,
                 scale: Optional[float] = None,
                 device: DeviceLike = None) -> None:
        self.root = os.path.abspath(root)
        self.device = device  # None: the card
        self.n_replicas = n_replicas
        self.queue_depth = queue_depth
        self.max_batch_rows = max_batch_rows
        self.max_wait_ms = max_wait_ms
        self.batching = batching
        self.scale = scale
        self.ledger = HbmLedger(hbm_budget_mb_setting()
                                if budget_mb is None else budget_mb)
        self._lock = tracked_lock("serve.zoo")
        # fleet traffic-log writer id (the server's lease id); set by the
        # owning server once the lease exists, adopted by every tenant
        # stream wired after that — see ServeServer._finish_init
        self.writer = ""
        self._tenants: Dict[str, ZooTenant] = {}
        self._background: Dict[str, BackgroundTenant] = {}
        self._reg_seq = 0
        self._default_name: Optional[str] = None  # first registered
        self._closed = False
        self._warm_ema: Optional[float] = None  # zoo-wide observed
        from shifu_tpu_torch.loop import drift_check_batches_setting

        self._drift_check_every = max(1, drift_check_batches_setting())

    # ---- registration ----
    def _replica_count(self) -> int:
        return len(replica_devices(self.n_replicas, self.device))

    def register(self, name: str, path: str,
                 column_configs=None, model_config=None,
                 admit: bool = False) -> ZooTenant:
        """Register one model set as tenant `name`. `path` is a model-
        set root (ColumnConfig.json/ModelConfig.json beside a models/
        dir) or a bare models dir. Rejects names that cannot be URL/
        label segments and — when a budget is set — tenants whose
        weights ALONE exceed the whole budget (they could never be
        resident; failing at registration beats failing on the first
        request)."""
        if not _NAME_RE.match(name or ""):
            raise ShifuError(
                ErrorCode.ILLEGAL_ARGUMENT,
                f"tenant name {name!r} must match {_NAME_RE.pattern} "
                "(it becomes the /score/<set> route and the tenant= "
                "metric label)")
        path = os.path.abspath(path)
        sub = os.path.join(path, "models")
        models_dir = sub if os.path.isdir(sub) else path
        if column_configs is None and model_config is None:
            column_configs, model_config = load_set_configs(path)
        with self._lock:
            if name in self._tenants:
                raise ShifuError(
                    ErrorCode.ILLEGAL_ARGUMENT,
                    f"tenant {name} is already registered")
            if name in self._background:
                raise ShifuError(
                    ErrorCode.ILLEGAL_ARGUMENT,
                    f"tenant name {name!r} is held by a background "
                    "(co-resident trainer) tenant")
        n_rep = self._replica_count()
        weights = estimate_weights_bytes(models_dir, column_configs,
                                         model_config) * n_rep
        if self.ledger.budget_bytes and weights > self.ledger.budget_bytes:
            raise ShifuError(
                ErrorCode.ILLEGAL_ARGUMENT,
                f"tenant {name} needs {weights} weight bytes across "
                f"{n_rep} replica(s) — more than the whole "
                f"{self.ledger.budget_bytes}-byte HBM budget; it could "
                "never be resident")
        with self._lock:
            if name in self._tenants:  # raced registration
                raise ShifuError(
                    ErrorCode.ILLEGAL_ARGUMENT,
                    f"tenant {name} is already registered")
            if name in self._background:  # raced background admit
                raise ShifuError(
                    ErrorCode.ILLEGAL_ARGUMENT,
                    f"tenant name {name!r} is held by a background "
                    "(co-resident trainer) tenant")
            tenant = ZooTenant(name, path, models_dir,
                               column_configs=column_configs,
                               model_config=model_config,
                               reg_seq=self._reg_seq)
            self._reg_seq += 1
            self._tenants[name] = tenant
            if self._default_name is None:
                self._default_name = name
            count = len(self._tenants)
        from shifu_tpu_torch.obs import registry

        registry().gauge("serve.zoo.tenants").set(count)
        log.info("zoo: registered tenant %s (%s, ~%d weight bytes x %d "
                 "replicas)", name, models_dir, weights // max(1, n_rep),
                 n_rep)
        if admit:
            self.ensure_resident(name)
        return tenant

    def tenants(self) -> List[str]:
        with self._lock:
            return sorted(self._tenants)

    def _get(self, name: str) -> ZooTenant:
        with self._lock:
            if name not in self._tenants:
                raise KeyError(f"unknown tenant {name!r} "
                               f"(registered: {sorted(self._tenants)})")
            return self._tenants[name]

    @property
    def default_tenant(self) -> Optional[str]:
        """First-registered tenant: what a bare /score routes to.
        Cached at registration — registration order never changes, and
        this is read on every request/health probe (no lock, no
        scan)."""
        return self._default_name

    # ---- residency ----
    def ensure_resident(self, name: str, wait: bool = True,
                        evict: bool = True) -> Optional[ReplicaFleet]:
        """Make `name` resident. `wait=True` blocks through the build +
        warm (tests, eager startup); `wait=False` kicks a background
        admission and raises ColdStartError (the request path).
        `evict=False` (eager startup warm-up) admits only into FREE
        budget — pre-warming tenant N must not evict tenant N-1 that
        was just admitted; only demand (a scored request) earns an
        eviction."""
        tenant = self._get(name)
        while True:
            with self._lock:
                if self._closed:
                    raise RuntimeError(
                        "zoo is closed — no admissions after shutdown")
                state = tenant.state
                if state == RESIDENT:
                    return tenant.fleet
                if state == COLD:
                    tenant.state = ADMITTING
                    tenant.admit_event = threading.Event()
                    tenant.admit_started = time.monotonic()
                    tenant.admit_error = None
                    tenant.admit_evict = evict
                    claimed = True
                else:
                    claimed = False
                event = tenant.admit_event
            if claimed:
                if wait:
                    self._admit(tenant)  # raises on failure
                    return tenant.fleet
                threading.Thread(target=self._admit_bg, args=(tenant,),
                                 name=f"shifu-zoo-admit-{name}",
                                 daemon=True).start()
                raise ColdStartError(name, self._cold_retry_after(tenant))
            if not wait:
                raise ColdStartError(
                    name, self._cold_retry_after(tenant),
                    detail=state)
            if event is not None:
                event.wait(timeout=600.0)
            else:
                time.sleep(0.05)  # EVICTING: poll until it lands cold
            with self._lock:
                if (tenant.state == COLD
                        and tenant.admit_error is not None):
                    raise RuntimeError(
                        f"tenant {name} admission failed: "
                        f"{tenant.admit_error}")

    def _admit_bg(self, tenant: ZooTenant) -> None:
        # failures are fully recorded (log + admit_error + counter) by
        # _admit BEFORE it signals waiters, so this wrapper must emit
        # nothing afterwards — a late log line from this daemon thread
        # would land outside any captured test/CI scope
        import contextlib

        with contextlib.suppress(Exception):
            self._admit(tenant)

    def _admit(self, tenant: ZooTenant) -> None:
        """Build + warm the tenant's fleet inside the budget. Caller has
        already flipped the tenant to ADMITTING."""
        from shifu_tpu_torch.obs import registry as obs_registry

        reg = obs_registry()
        kind = "readmit" if tenant.evictions else "initial"
        reg.counter("serve.zoo.admissions", tenant=tenant.name,
                    kind=kind).inc()
        t0 = time.perf_counter()
        fleet = None
        try:
            drift = tenant.drift
            if drift is None and tenant.column_configs:
                drift = drift_monitor_for(tenant.active_dir,
                                          tenant.column_configs,
                                          tenant.model_config)
                tenant.drift = drift
            fleet = ReplicaFleet.build(
                tenant.active_dir,
                n_replicas=self.n_replicas,
                device=self.device,
                column_configs=tenant.column_configs,
                model_config=tenant.model_config,
                drift=drift,
                queue_depth=self.queue_depth,
                max_batch_rows=self.max_batch_rows,
                max_wait_ms=self.max_wait_ms,
                batching=self.batching,
                observer=self._observer(tenant),
                tenant=tenant.name,
                put_hook=lambda n: self._acquire(
                    tenant, "active", n, evict=tenant.admit_evict),
                cost_hook=lambda: self._reprice(tenant),
                **({"scale": self.scale}
                   if self.scale is not None else {}))
            buckets = tenant.warm_buckets or [1]
            fleet.warm(buckets)
            # true-up: streamed weight acquires covered the puts; the
            # warm buckets' staging and analytic program bytes
            # (memory_analysis) join the charge now they exist
            measured = fleet.memory_analysis()["residentBytes"]
            charged = self.ledger.charge_of(tenant.name, "active")
            if measured > charged:
                self._acquire(tenant, "active", measured - charged,
                              evict=tenant.admit_evict)
            elif measured < charged:
                self.ledger.reduce(tenant.name, "active",
                                   charged - measured)
            self._wire_loop(tenant, fleet)
            from shifu_tpu_torch.serve.server import Scorer

            scorer = Scorer(fleet=fleet,
                            extra_columns=tenant.label_cols)
            warm_s = time.perf_counter() - t0
            # every side effect (histogram, log) lands BEFORE the state
            # flips to RESIDENT: the moment a poller can see the tenant
            # serving, this background thread must have nothing left to
            # emit (a post-teardown log line from an admission thread
            # corrupts captured test/CI output)
            reg.histogram("serve.zoo.cold_start_seconds",
                          buckets=COLD_START_BUCKETS,
                          tenant=tenant.name).observe(warm_s)
            log.info("zoo: tenant %s resident in %.2fs (%d bytes "
                     "ledgered)", tenant.name, warm_s,
                     self.ledger.charge_of(tenant.name))
            with self._lock:
                closed = self._closed
                if not closed:
                    tenant.fleet = fleet
                    tenant.scorer = scorer
                    tenant.state = RESIDENT
                    tenant.warm_seconds = warm_s
                    if self._warm_ema is None:
                        self._warm_ema = warm_s
                    else:
                        self._warm_ema = (0.7 * self._warm_ema
                                          + 0.3 * warm_s)
                else:
                    # the zoo closed while this admission warmed
                    # (close() waits a bounded time, not forever): the
                    # fleet must not outlive the shutdown — tear it
                    # down and leave the tenant cold
                    tenant.state = COLD
                event = tenant.admit_event
                tenant.admit_event = None
            if closed:
                fleet.close(timeout=1.0)
                fleet.release()
                self.ledger.release(tenant.name, "active")
                if event is not None:
                    event.set()
                return
            self._publish_resident()
            if event is not None:
                event.set()
        except BaseException as e:
            if fleet is not None:
                try:  # tear a partial build down so its programs free
                    fleet.close(timeout=1.0)
                    fleet.release()
                except Exception as te:  # best-effort: the charge
                    # release below is the accounting that matters
                    log.warning("zoo: partial-build teardown of %s: %s",
                                tenant.name, te)
            self.ledger.release(tenant.name, "active")
            with self._lock:
                tenant.state = COLD
                tenant.fleet = None
                tenant.scorer = None
                tenant.admit_error = f"{type(e).__name__}: {e}"
                event = tenant.admit_event
                tenant.admit_event = None
            reg.counter("serve.zoo.admission_errors",
                        tenant=tenant.name).inc()
            log.warning("zoo: admission of %s failed: %s: %s",
                        tenant.name, type(e).__name__, e)
            if event is not None:
                event.set()
            raise

    def _reprice(self, tenant: ZooTenant) -> None:
        """Registry cost-hook: a NEW row bucket was run by live (or
        shadow) traffic after admission — re-read memory_analysis and
        true the tenant's total charge UP so the ledger keeps describing
        actual residency. Downward corrections happen at admission and
        promote; this only ever adds, so used <= budget keeps holding.

        Runs on the replica's scoring worker, so it must NEVER block on
        another tenant's eviction drain (up to 30 s — a p99 cliff for
        every rider queued behind the batch): when the extra bytes
        don't fit the free budget, the evict-and-acquire pass is
        deferred to a background thread and the ledger catches up
        within one drain — the same off-request-path discipline as
        cold-start admission."""
        with self._lock:
            if tenant.state != RESIDENT or tenant.fleet is None:
                return
            fleet = tenant.fleet
        measured = fleet.memory_analysis()["residentBytes"]
        charged = self.ledger.charge_of(tenant.name)
        if measured <= charged:
            return
        try:
            self.ledger.acquire(tenant.name, "active", measured - charged)
        except LedgerFullError:
            threading.Thread(target=self._reprice_evicting,
                             args=(tenant,),
                             name=f"shifu-zoo-reprice-{tenant.name}",
                             daemon=True).start()

    def _reprice_evicting(self, tenant: ZooTenant) -> None:
        """Background half of _reprice: recompute the deficit fresh
        (racing reprices must not double-charge) and acquire with LRU
        eviction allowed."""
        import contextlib

        with contextlib.suppress(Exception):  # accounting must never
            # kill the thread loudly; the next new bucket re-trues
            with self._lock:
                if tenant.state != RESIDENT or tenant.fleet is None:
                    return
                fleet = tenant.fleet
            measured = fleet.memory_analysis()["residentBytes"]
            charged = self.ledger.charge_of(tenant.name)
            if measured > charged:
                self._acquire(tenant, "active", measured - charged)

    def _acquire(self, tenant: ZooTenant, kind: str,
                 nbytes: int, evict: bool = True) -> None:
        """Ledger acquire with LRU eviction between attempts: evict the
        least-recently-scored evictable tenant until the bytes fit or
        nothing is left to evict (`evict=False`: fit-or-fail)."""
        while True:
            try:
                self.ledger.acquire(tenant.name, kind, nbytes)
                return
            except LedgerFullError as e:
                if evict:
                    # background tenants (co-resident trainers) go
                    # STRICTLY FIRST: the LRU never evicts a serving
                    # tenant while any background charge remains
                    bg = self._claim_background_victim()
                    if bg is not None:
                        self._evict_background(
                            bg, reason="pressure_background")
                        continue
                victim = (self._claim_victim(exclude=tenant)
                          if evict else None)
                if victim is None:
                    raise LedgerFullError(
                        f"cannot fit {nbytes} bytes for {tenant.name}/"
                        f"{kind}: {e.deficit} bytes over budget and no "
                        "evictable tenant (others are cold, mid-"
                        "rollout, or shadow-staged)", e.deficit)
                self._evict(victim, reason="pressure")

    def _claim_victim(self, exclude: Optional[ZooTenant] = None
                      ) -> Optional[ZooTenant]:
        with self._lock:
            candidates = [
                t for t in self._tenants.values()
                if (t.state == RESIDENT and t is not exclude
                    and t.busy is None and not t.shadow_staged)
            ]
            if not candidates:
                return None
            victim = min(candidates, key=lambda t: t.lru_key())
            victim.state = EVICTING
            return victim

    def evict(self, name: str, reason: str = "admin") -> None:
        """Explicit eviction. Refused for a tenant mid-stage/mid-promote
        or with a staged shadow — evicting the swap target would strand
        the rollout half-rolled."""
        with self._lock:
            bt = self._background.get(name)
        if bt is not None:
            self._evict_background(bt, reason=reason)
            return
        tenant = self._get(name)
        with self._lock:
            if tenant.state != RESIDENT:
                raise ValueError(
                    f"tenant {name} is {tenant.state}, not resident")
            if tenant.busy is not None:
                raise ValueError(
                    f"tenant {name} is mid-{tenant.busy} — eviction "
                    "refused until the rollout operation completes")
            if tenant.shadow_staged:
                raise ValueError(
                    f"tenant {name} has a staged shadow — unstage or "
                    "promote before evicting")
            tenant.state = EVICTING
        self._evict(tenant, reason=reason)

    def _evict(self, tenant: ZooTenant, reason: str) -> None:
        """Tear down a claimed (state=EVICTING) tenant: drain its fleet,
        drop its device tensors, release the ledger charge, remember
        what re-admission needs."""
        from shifu_tpu_torch.obs import registry as obs_registry

        with self._lock:
            fleet, tenant.fleet = tenant.fleet, None
            tenant.scorer = None
        if fleet is not None:
            # remember BEFORE teardown: re-admission rebuilds the
            # promoted dir and re-warms the buckets live traffic used
            tenant.active_dir = fleet.active_models_dir
            try:
                tenant.warm_buckets = list(
                    fleet.snapshot().get("warmBuckets", [])) or \
                    tenant.warm_buckets
            except Exception as se:  # snapshot trouble must not block
                log.warning("zoo: cannot read %s warm buckets at "
                            "evict: %s", tenant.name, se)
            fleet.close(timeout=EVICT_DRAIN_TIMEOUT_S)
            dropped = fleet.release()
        else:
            dropped = 0
        freed = (self.ledger.release(tenant.name, "active")
                 + self.ledger.release(tenant.name, "shadow"))
        with self._lock:
            tenant.state = COLD
            tenant.evictions += 1
            tenant.last_drift_verdict = None
        obs_registry().counter("serve.zoo.evictions",
                               tenant=tenant.name, reason=reason).inc()
        self._publish_resident()
        log.info("zoo: evicted tenant %s (%s): freed %d ledgered bytes, "
                 "dropped %d staged bucket(s)",
                 tenant.name, reason, freed, dropped)

    def _publish_resident(self) -> None:
        from shifu_tpu_torch.obs import registry

        with self._lock:
            n = sum(1 for t in self._tenants.values()
                    if t.state == RESIDENT)
        registry().gauge("serve.zoo.resident_tenants").set(n)

    # ---- background tenants (the co-resident trainer plane) ----
    def admit_background(self, name: str,
                         meta: Optional[dict] = None) -> dict:
        """Admit (or re-admit) `name` as a `priority=background` ledger
        tenant. Idempotent: a re-admit clears a pending eviction flag —
        that is how an evicted trainer comes back once pressure
        subsides. Returns the grant info the trainer sizes its stage
        plan from."""
        if not _NAME_RE.match(name or ""):
            raise ShifuError(
                ErrorCode.ILLEGAL_ARGUMENT,
                f"background tenant name {name!r} must match "
                f"{_NAME_RE.pattern}")
        with self._lock:
            if self._closed:
                raise ValueError("zoo is closed")
            if name in self._tenants:
                raise ValueError(
                    f"{name!r} is a registered serving tenant — pick a "
                    "different -Dshifu.coresident.tenant name")
            bt = self._background.get(name)
            if bt is None:
                bt = BackgroundTenant(name, self._reg_seq, meta)
                self._reg_seq += 1
                self._background[name] = bt
                log.info("zoo: admitted background tenant %s", name)
            else:
                bt.evict_requested = False
                if meta:
                    bt.meta.update(meta)
        free = (max(0, self.ledger.budget_bytes - self.ledger.used)
                if self.ledger.budget_bytes else None)
        return {"freeBytes": free,
                "devices": len(set(replica_devices(None, self.device)))}

    def _get_background(self, name: str) -> BackgroundTenant:
        with self._lock:
            bt = self._background.get(name)
        if bt is None:
            raise KeyError(
                f"unknown background tenant {name!r} "
                f"(admitted: {sorted(self._background)})")
        return bt

    def background_acquire(self, name: str, nbytes: int) -> None:
        """Fit-or-fail: a background tenant NEVER triggers eviction —
        the trainer waits out serving pressure instead of creating
        it."""
        bt = self._get_background(name)
        if bt.evict_requested:
            raise LedgerFullError(
                f"background tenant {name} is flagged for eviction — "
                "heartbeat, checkpoint, and re-admit", int(nbytes))
        self.ledger.acquire(name, "background", int(nbytes))

    def background_reduce(self, name: str, nbytes: int) -> None:
        self._get_background(name)
        self.ledger.reduce(name, "background", int(nbytes))

    def background_heartbeat(self, name: str, epoch: int) -> bool:
        """Record training progress; returns True when the zoo wants
        the devices back (the trainer then checkpoints + releases)."""
        bt = self._get_background(name)
        with self._lock:
            bt.epoch = max(bt.epoch, int(epoch))
            return bt.evict_requested

    def background_release(self, name: str, final: bool = False) -> None:
        """Drop the tenant's whole charge. `final=True` (training
        completed) forgets the tenant; an eviction release keeps the
        record so `/healthz` still lists the checkpointed epoch."""
        bt = self._get_background(name)
        self.ledger.release(name, "background")
        if final:
            with self._lock:
                self._background.pop(name, None)
            log.info("zoo: background tenant %s completed and released",
                     name)

    def _claim_background_victim(self) -> Optional[BackgroundTenant]:
        with self._lock:
            candidates = [bt for bt in self._background.values()
                          if not bt.evict_requested]
        candidates = [bt for bt in candidates
                      if self.ledger.charge_of(bt.name, "background") > 0]
        if not candidates:
            return None
        return min(candidates, key=lambda bt: bt.reg_seq)

    def _evict_background(self, bt: BackgroundTenant,
                          reason: str = "pressure_background") -> int:
        """Flag + immediate charge drop. The trainer sees the flag at
        its next epoch-boundary heartbeat and frees its device buffers
        then — the byte-accounting grace window is bounded by one
        training epoch."""
        from shifu_tpu_torch.obs import registry as obs_registry

        with self._lock:
            bt.evict_requested = True
            bt.evictions += 1
        freed = self.ledger.release(bt.name, "background")
        obs_registry().counter("serve.zoo.evictions",
                               tenant=bt.name, reason=reason).inc()
        log.warning("zoo: evicted background tenant %s (%s): freed %d "
                    "ledgered bytes (trainer checkpoints at its next "
                    "heartbeat, epoch %d last seen)",
                    bt.name, reason, freed, bt.epoch)
        return freed

    # ---- scoring ----
    def _cold_retry_after(self, tenant: ZooTenant) -> float:
        """Retry-After for a cold/admitting tenant, from OBSERVED warm-up
        time: this tenant's last admission, else the zoo-wide EMA, else
        the -Dshifu.serve.zoo.warmupMs fallback — minus what an in-
        flight admission has already spent, clamped."""
        with self._lock:
            est = tenant.warm_seconds
            if est is None:
                est = self._warm_ema
            if est is None:
                est = zoo_warmup_ms_setting() / 1000.0
            if tenant.state == ADMITTING and tenant.admit_started:
                est -= time.monotonic() - tenant.admit_started
        return min(max(est, COLD_RETRY_MIN_S), COLD_RETRY_MAX_S)

    def score_batch(self, name: str, records: Sequence[dict],
                    timeout: Optional[float] = None, trace=None):
        """Score on tenant `name`. Resident: the ordinary routed path
        (LRU touched). Cold: kick a background admission and raise
        ColdStartError — the caller answers 429 + Retry-After; the
        admission queue never blocks behind a warm-up.

        `records` is a list of dicts (JSON) or an already-columnar
        batch (a decoded binary wire payload) — both flow through the
        tenant fleet unchanged. The per-bucket staging buffers a
        tenant's registries allocate for the one-copy handoff are
        charged to this ledger exactly once, via memory_analysis()'s
        stagingBytes inside residentBytes (the same true-up that prices
        weights and programs)."""
        from shifu_tpu_torch.obs import registry

        from shifu_tpu_torch.serve.queue import RejectedError

        tenant = self._get(name)
        for _attempt in (0, 1):
            with self._lock:
                resident = tenant.state == RESIDENT
                if resident:
                    tenant.last_used = time.monotonic()
                    tenant.requests += 1
                    scorer = tenant.scorer
            if resident:
                if trace is not None:
                    trace.annotate(tenant=name)
                kw = {} if timeout is None else {"timeout": timeout}
                return scorer.score_batch(records, trace=trace, **kw)
            try:
                self.ensure_resident(name, wait=False)
            except ColdStartError:
                registry().counter("serve.zoo.cold_shed",
                                   tenant=name).inc()
                raise
            except RuntimeError as e:
                # zoo closed mid-request: the standard shutdown
                # rejection, not a 500
                raise RejectedError("closed") from e
            # no ColdStartError: the admission RACED IN between the
            # resident check and here — loop once and score instead of
            # telling a served tenant's client to come back later
        registry().counter("serve.zoo.cold_shed", tenant=name).inc()
        raise ColdStartError(name, self._cold_retry_after(tenant))

    def fleet_of(self, name: str) -> ReplicaFleet:
        """The tenant's resident fleet (raises if not resident)."""
        tenant = self._get(name)
        with self._lock:
            if tenant.state != RESIDENT or tenant.fleet is None:
                raise ValueError(f"tenant {name} is {tenant.state}")
            return tenant.fleet

    # ---- per-tenant continuous-loop seams ----
    def _wire_loop(self, tenant: ZooTenant, fleet: ReplicaFleet) -> None:
        """Per-tenant traffic-log stream + label columns, created on
        first admission (needs the registry's input columns) and kept
        ACROSS evictions — a tenant's logged traffic and drift history
        belong to the tenant, not to one residency."""
        from shifu_tpu_torch.loop import log_sample_setting
        from shifu_tpu_torch.loop.traffic import TrafficLog, traffic_columns

        if tenant.traffic is not None or log_sample_setting() <= 0.0:
            return
        input_columns = list(fleet.input_columns)
        label_cols = []
        mc = tenant.model_config
        if mc is not None:
            for extra_col in (mc.data_set.target_column_name,
                              mc.data_set.weight_column_name):
                if (extra_col and extra_col not in label_cols
                        and extra_col not in input_columns):
                    label_cols.append(extra_col)
        tenant.label_cols = label_cols
        tenant.traffic = TrafficLog(
            self.root, traffic_columns(input_columns + label_cols),
            stream=tenant.name, writer=self.writer)

    def _observer(self, tenant: ZooTenant) -> Callable:
        """The per-replica post-resolution hook for ONE tenant: its own
        traffic stream, its own shadow observer, its own drift cadence
        against its own fleet's health — the single-tenant server's
        _observe, owned per set."""

        def observe(replica, data, result):
            if tenant.traffic is not None:
                tenant.traffic.record(
                    data, result,
                    getattr(replica.registry, "scored_sha",
                            replica.registry.sha))
            replica.registry.observe(data, result)
            fleet = tenant.fleet
            drift = tenant.drift
            if fleet is None or drift is None:
                return
            with tenant._obs_lock:
                tenant.observed_batches += 1
                check = (tenant.observed_batches
                         % self._drift_check_every == 0)
            if check:
                # outside the cadence lock (forces a d2h flush, SH203)
                tenant.last_drift_verdict = drift.check_degrade(
                    fleet.health, self.root, model_sha=fleet.sha,
                    reporter=self.writer)

        return observe

    def _busy_guard(self, tenant: ZooTenant, op: str):
        with self._lock:
            if tenant.busy is not None:
                raise ValueError(
                    f"tenant {tenant.name} {tenant.busy} in progress — "
                    "retry when it completes")
            tenant.busy = op

    def _busy_clear(self, tenant: ZooTenant) -> None:
        with self._lock:
            tenant.busy = None

    def stage(self, name: str, models_dir: str) -> Optional[dict]:
        """STREAMED shadow stage for one tenant: the candidate's weights
        land layer-group by layer-group, each group ledger-acquired
        (evicting cold tenants as needed) before its copy — a
        stage on a near-full budget cannot OOM, and the ledger's peak
        proves residency never left the budget."""
        tenant = self._get(name)
        # busy FIRST, residency second: the busy flag is what shields
        # this tenant from a concurrent admission's LRU eviction — the
        # other order leaves a gap where ensure_resident's fleet is
        # torn down before the stage touches it
        self._busy_guard(tenant, "stage")
        try:
            self.ensure_resident(name)
            fleet = tenant.fleet
            snap = fleet.stage(
                models_dir,
                column_configs=tenant.column_configs,
                model_config=tenant.model_config,
                drift=tenant.drift,
                put_hook=lambda n: self._acquire(tenant, "shadow", n))
            # true-up the staged buckets' staging and program bytes
            ma = fleet.memory_analysis()
            shadow_bytes = sum(
                int(r.get("shadow", {}).get("residentBytes", 0))
                for r in ma["replicas"])
            charged = self.ledger.charge_of(tenant.name, "shadow")
            if shadow_bytes > charged:
                self._acquire(tenant, "shadow", shadow_bytes - charged)
            elif shadow_bytes < charged:
                self.ledger.reduce(tenant.name, "shadow",
                                   charged - shadow_bytes)
            with self._lock:
                tenant.shadow_staged = True
            return snap
        except BaseException:
            # roll the partial stage back everywhere so the ledger's
            # shadow charge and the device agree again
            try:
                fleet = tenant.fleet
                if fleet is not None:
                    fleet.unstage()
            except Exception as ue:  # rollback is best-effort
                log.warning("zoo: unstage after failed stage on %s: %s",
                            name, ue)
            self.ledger.release(tenant.name, "shadow")
            with self._lock:
                tenant.shadow_staged = False
            raise
        finally:
            self._busy_clear(tenant)

    def unstage(self, name: str) -> None:
        tenant = self._get(name)
        self._busy_guard(tenant, "unstage")
        try:
            fleet = tenant.fleet
            if fleet is not None:
                fleet.unstage()
            self.ledger.release(tenant.name, "shadow")
            # re-price from measurement: buckets the SHADOW ran
            # while staged were charged to "active" by _reprice and
            # just freed with the unstage — without this the charge
            # overstates residency until the next promote/evict
            if fleet is not None:
                measured = fleet.memory_analysis()["residentBytes"]
                charged = self.ledger.charge_of(tenant.name)
                if measured < charged:
                    self.ledger.reduce(tenant.name, "active",
                                       charged - measured)
            with self._lock:
                tenant.shadow_staged = False
        finally:
            self._busy_clear(tenant)

    def shadow_snapshot(self, name: str) -> Optional[dict]:
        tenant = self._get(name)
        fleet = tenant.fleet
        return None if fleet is None else fleet.shadow_snapshot()

    def promote(self, name: str, expected_sha: Optional[str] = None,
                step_cb: Optional[Callable] = None) -> dict:
        """Rolling promote for one tenant; afterwards the OLD active
        version's ledger charge is released and the shadow's charge
        becomes the active one — residency shrinks back to one version
        per replica, with the whole sequence inside the budget."""
        tenant = self._get(name)
        # busy first (shields against LRU eviction), then the resident
        # check is race-free
        self._busy_guard(tenant, "promote")
        try:
            with self._lock:
                fleet = tenant.fleet
                if tenant.state != RESIDENT or fleet is None:
                    raise ValueError(
                        f"tenant {name} is {tenant.state} — nothing to "
                        "promote")
            swap = fleet.promote(expected_sha, step_cb=step_cb)
            # re-price from MEASUREMENT, not bookkeeping: the promoted
            # fleet's residency replaces both old charges, and the
            # blind release+transfer would drop bytes _reprice charged
            # to "active" for buckets the SHADOW ran while staged
            # (that staging is the new active's and still resident)
            self.ledger.release(tenant.name, "active")
            self.ledger.transfer(tenant.name, "shadow", "active")
            measured = fleet.memory_analysis()["residentBytes"]
            charged = self.ledger.charge_of(tenant.name)
            if measured > charged:
                self._acquire(tenant, "active", measured - charged)
            elif measured < charged:
                self.ledger.reduce(tenant.name, "active",
                                   charged - measured)
            with self._lock:
                tenant.shadow_staged = False
                tenant.active_dir = tenant.fleet.active_models_dir
            tenant.fleet.health.clear_degraded()
            if tenant.drift is not None:
                tenant.drift.reset()
            tenant.last_drift_verdict = None
            return swap
        finally:
            self._busy_clear(tenant)

    # ---- surfaces ----
    def admitting_tenants(self) -> List[str]:
        with self._lock:
            return sorted(t.name for t in self._tenants.values()
                          if t.state == ADMITTING)

    def fleet_health_snapshot(self) -> dict:
        """Process-level health for a zoo server: aggregated over the
        RESIDENT tenants' fleet health only. An evicted tenant's torn-
        down fleet must not make /healthz report the process as
        draining — eviction is budget management, not shutdown; a zoo
        with zero resident tenants still admits cold starts and is
        `ok`."""
        with self._lock:
            resident = [(t.name, t.fleet)
                        for t in self._tenants.values()
                        if t.state == RESIDENT and t.fleet is not None]
        per = {}
        crashes = 0
        reasons = []
        draining = bool(resident)
        for name, fleet in resident:
            s = fleet.health_snapshot()
            per[name] = s
            crashes += int(s.get("workerCrashes", 0))
            if s["status"] == "degraded":
                reasons.append(
                    f"tenant {name}"
                    + (f": {s['reason']}" if s.get("reason") else ""))
            if s["status"] != "draining":
                draining = False
        if draining:
            status, reason = "draining", "all tenants draining"
        elif reasons:
            status, reason = "degraded", "; ".join(reasons)
        else:
            status, reason = "ok", ""
        return {"status": status, "reason": reason,
                "workerCrashes": crashes, "tenantsHealth": per}

    def health_snapshot(self) -> dict:
        """The /healthz `zoo` section: budget occupancy + per-tenant
        state. `residentTenants`/`hbmBudgetUsedMB` are the headline
        numbers; a non-sticky cold_start degrade reason is computed by
        the server from `admitting`."""
        ledger = self.ledger.snapshot()
        with self._lock:
            tenants = {name: t.snapshot()
                       for name, t in sorted(self._tenants.items())}
            resident = sum(1 for t in self._tenants.values()
                           if t.state == RESIDENT)
            admitting = sorted(t.name for t in self._tenants.values()
                               if t.state == ADMITTING)
            background = {name: bt.snapshot()
                          for name, bt in
                          sorted(self._background.items())}
        for name, snap in background.items():
            snap["hbmMB"] = round(
                self.ledger.charge_of(name, "background") / MB, 3)
        return {
            "tenants": tenants,
            "residentTenants": resident,
            "admitting": admitting,
            "background": background,
            "hbmBudgetMB": ledger["budgetMB"],
            "hbmBudgetUsedMB": ledger["usedMB"],
            "hbmPeakUsedMB": ledger["peakMB"],
        }

    def snapshot(self) -> dict:
        """Manifest view: ledger + per-tenant detail incl. resident
        fleet snapshots. After close(), the snapshot taken at the START
        of the drain is returned — the shutdown manifest must describe
        what was serving, not the post-teardown rubble."""
        closed = getattr(self, "_closed_snapshot", None)
        if closed is not None:
            return closed
        out = {
            "ledger": self.ledger.snapshot(),
            "tenants": {},
        }
        with self._lock:
            items = list(self._tenants.items())
            out["background"] = {name: bt.snapshot()
                                 for name, bt in
                                 sorted(self._background.items())}
        for name, tenant in sorted(items):
            snap = tenant.snapshot()
            fleet = tenant.fleet
            if fleet is not None and tenant.state == RESIDENT:
                try:
                    snap["fleet"] = fleet.snapshot()
                    snap["memory"] = fleet.memory_analysis()
                except Exception as se:  # manifest must not fail on a
                    # mid-transition tenant
                    snap["fleetError"] = f"{type(se).__name__}: {se}"
            if tenant.traffic is not None:
                snap["traffic"] = tenant.traffic.snapshot()
            out["tenants"][name] = snap
        return out

    def close(self, timeout: Optional[float] = 30.0) -> None:
        """Drain every resident tenant and flush its traffic stream.
        The zoo is FENCED first (no new admissions accepted), then
        in-flight background admissions are waited out; one that
        outlasts the bounded wait finds the fence at its final flip and
        tears its fleet down instead of resurrecting a closed zoo."""
        with self._lock:
            self._closed = True
            pending = [t.admit_event for t in self._tenants.values()
                       if t.state == ADMITTING
                       and t.admit_event is not None]
        for event in pending:
            event.wait(timeout if timeout is not None else 60.0)
        self._closed_snapshot = self.snapshot()
        with self._lock:
            tenants = list(self._tenants.values())
        for tenant in tenants:
            fleet = tenant.fleet
            if fleet is not None:
                fleet.close(timeout)
                fleet.release()
            if tenant.traffic is not None:
                tenant.traffic.close()
            with self._lock:
                tenant.state = COLD
                tenant.fleet = None
                tenant.scorer = None
        with self._lock:
            backgrounds = list(self._background.values())
        for bt in backgrounds:
            # the trainer's own process frees its buffers; the closing
            # zoo just zeroes the accounting
            self.ledger.release(bt.name, "background")
        self._publish_resident()

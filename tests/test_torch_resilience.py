"""The port's fault injection, retry and atomic writes
(`shifu_tpu_torch/resilience/{faults,retry,checkpoint}.py`) against the
JAX package's, on the CPU.

Exact throughout: the same spec parses to the same clauses, fires at the
same event ordinals (both draw numpy `default_rng`), and the retry
windows and jittered delays are the same numbers for the same
`random.Random` seed.
"""

import os
import random
import signal
import threading
import time

import numpy as np
import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

from shifu_tpu.resilience import faults as jfaults  # noqa: E402
from shifu_tpu.resilience import retry as jretry  # noqa: E402
from shifu_tpu_torch.analysis import sanitize as psanitize  # noqa: E402
from shifu_tpu_torch.data import pipeline as pp  # noqa: E402
from shifu_tpu_torch.resilience import checkpoint as ckpt_mod  # noqa: E402
from shifu_tpu_torch.resilience import faults, retry  # noqa: E402
from shifu_tpu_torch.resilience.faults import (  # noqa: E402
    FaultPlan,
    FaultSpecError,
    InjectedFaultError,
    PreemptionError,
)
from shifu_tpu_torch.utils import environment as penv  # noqa: E402
from tests.test_torch_obs import counts, obs_scope  # noqa: E402

# the examples of the grammar's docstring (shifu_tpu/resilience/faults.py)
EXAMPLES = ["io:p=0.01:seed=7", "device", "preempt@chunk=40",
            "slow:ms=250", "device_dead@replica=1", "lease_stall:ms=800",
            "peer_kill@lease=5"]
FIELDS = ("seam", "counter", "at", "p", "seed", "ms", "max", "replica")


@pytest.mark.parametrize("spec", EXAMPLES)
def test_grammar_round_trip_matches_jax(spec):
    (jc,) = jfaults.FaultPlan.parse(spec).clauses
    if jc.seam in faults.UNREACHED:
        # the port has no such seam yet: it refuses, never arms silently
        with pytest.raises(FaultSpecError, match="A.14"):
            FaultPlan.parse(spec)
        return
    (pc,) = FaultPlan.parse(spec).clauses
    assert [getattr(pc, f) for f in FIELDS] == \
        [getattr(jc, f) for f in FIELDS]
    assert pc.describe() == jc.describe()


@pytest.mark.parametrize("bad", [
    "bogus", "io:p=2", "preempt@chunk", "io:frobnicate=1", "io:p=abc",
    "preempt@chunk=x",
])
def test_bad_specs_raise_at_parse(bad):
    with pytest.raises(jfaults.FaultSpecError):
        jfaults.FaultPlan.parse(bad)
    with pytest.raises(FaultSpecError):
        FaultPlan.parse(bad)


def _firings(mod, spec, counter, n=1000, indexed=False):
    """(event, exception name) of every firing over n events."""
    plan = mod.FaultPlan.parse(spec)
    out = []
    for k in range(n):
        try:
            plan.fire(counter, index=k if indexed else None)
        except (mod.InjectedFaultError, mod.PreemptionError) as e:
            out.append((k, type(e).__name__))
    return out


@pytest.mark.parametrize("spec, counter, indexed", [
    ("preempt@chunk=40", "chunk", False),          # scheduled
    ("io@io=7", "io", False),
    ("io:p=1:max=0,preempt@io=3", "io", False),     # severity order
    ("io:p=0.01:seed=7", "io", False),             # seeded
    ("io:p=0.3:seed=11,prefetch:p=0.2", "io", False),
    ("serve:p=0.05:seed=3:max=4", "serve", False),
    ("io:p=0.05:seed=7", "io", True),              # index-keyed
    ("preempt@chunk=500", "chunk", True),
])
def test_firing_ordinals_match_jax(spec, counter, indexed):
    want = _firings(jfaults, spec, counter, indexed=indexed)
    assert want  # every case fires at least once in 1,000 events
    assert _firings(faults, spec, counter, indexed=indexed) == want


def test_sleep_seam_and_counters():
    with obs_scope(), \
            faults.activate(FaultPlan.parse("slow:ms=1,io:p=1:max=2")):
        for _ in range(2):
            with pytest.raises(InjectedFaultError):
                faults.fault_point("io")
        faults.fault_point("io")  # the io budget is spent: sleep only
        assert counts("fault.injected", "seam") == {"slow": 3, "io": 2}
    faults.fault_point("io")  # no plan armed: a no-op


def test_unreachable_seams_raise_naming_a14():
    penv.set_property(faults.FAULTS_PROPERTY, "io:p=0,lease_stall:ms=5")
    try:
        assert faults.plan_active()
        with pytest.raises(FaultSpecError, match="A.14"):
            faults.fault_point("io")
    finally:
        penv.set_property(faults.FAULTS_PROPERTY, "")
        faults.reset()
    for mode in ("transfer", "nan", "recompile", "all"):
        penv.set_property("shifu.sanitize", mode)
        try:
            with pytest.raises(ValueError, match="A.14"):
                psanitize.from_environment()
        finally:
            penv.set_property("shifu.sanitize", "")
    # the device seam (every profile dispatch) and the race mode are
    # ported: they parse and arm
    assert FaultPlan.parse("device:p=0.5").clauses[0].seam == "device"
    penv.set_property("shifu.sanitize", "race")
    try:
        assert psanitize.from_environment().modes == {"race"}
    finally:
        penv.set_property("shifu.sanitize", "")


# ---- retry -----------------------------------------------------------------

def test_retry_recovers_and_counts():
    calls, sleeps = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise InjectedFaultError("io", len(calls))
        return "ok"

    with obs_scope():
        assert retry.retry_call(flaky, seam="io",
                                sleeper=sleeps.append) == "ok"
        assert counts("retry.attempts", "seam") == {"io": 2}
        assert counts("retry.recovered", "seam") == {"io": 1}
        assert counts("fault.survived", "seam") == {"io": 2}
    assert len(calls) == 3 and len(sleeps) == 2


def test_retry_budget_exhaustion_reraises_original():
    def always():
        raise OSError("flaky disk")

    with obs_scope():
        with pytest.raises(OSError, match="flaky disk"):
            retry.retry_call(always, seam="io", sleeper=lambda s: None)
        assert counts("retry.exhausted", "seam") == {"io": 1}
    # a non-transient error is not retried at all
    calls = []

    def bad():
        calls.append(1)
        raise KeyError("x")

    with pytest.raises(KeyError):
        retry.retry_call(bad, seam="io", sleeper=lambda s: None)
    assert len(calls) == 1


def test_preemption_never_retried():
    calls = []

    def pre():
        calls.append(1)
        raise PreemptionError("now")

    # even when the caller names it retryable
    with pytest.raises(PreemptionError):
        retry.retry_call(pre, seam="io", sleeper=lambda s: None,
                         retryable=(Exception,))
    assert len(calls) == 1


@pytest.mark.parametrize("seam", ["io", "ckpt"])
def test_backoff_windows_and_jitter_match_jax(seam):
    for attempt in range(1, 9):
        assert retry.backoff_window_ms(25.0, 2000.0, attempt) == \
            jretry.backoff_window_ms(25.0, 2000.0, attempt)
    assert retry.backoff_ms(seam) == jretry.backoff_ms(seam)
    a, b = random.Random(3), random.Random(3)
    d = [retry.backoff_delay(seam, k % 4 + 1, rng=a) for k in range(60)]
    assert d == [jretry.backoff_delay(seam, k % 4 + 1, rng=b)
                 for k in range(60)]
    base, _cap = retry.backoff_ms(seam)
    assert all(0 <= x <= 8 * base / 1000.0 for x in d)
    assert len({round(x, 9) for x in d}) > 30  # full jitter, not fixed


def test_per_seam_budget_override():
    penv.set_property("shifu.retry.io.max", "5")
    try:
        assert retry.max_attempts("io") == 5
        assert retry.max_attempts("ckpt") == 3
    finally:
        penv.set_property("shifu.retry.io.max", "")


# ---- atomic writes and snapshots --------------------------------------------

def test_kill_during_atomic_write_preserves_previous(tmp_path):
    path = str(tmp_path / "weights.npy")
    ckpt_mod.atomic_save_npy(path, np.arange(4.0))
    # the ckpt fault fires after the temp bytes land, before the rename
    with faults.activate(FaultPlan.parse("ckpt@ckpt=1")):
        with pytest.raises(InjectedFaultError):
            ckpt_mod.atomic_write(path, b"torn")
    np.testing.assert_array_equal(np.load(path), np.arange(4.0))
    assert os.listdir(str(tmp_path)) == ["weights.npy"]  # no temp debris


def test_stream_checkpoint_save_retries_injected_ckpt_fault(tmp_path):
    ck = ckpt_mod.StreamCheckpoint(str(tmp_path / "s.ckpt.npz"), "sha")
    with obs_scope():
        with faults.activate(FaultPlan.parse("ckpt@ckpt=1")):
            ck.save(3, arrays={"a": np.ones(2)}, meta={"k": 1})
        ci, arrays, meta, blob = ck.load()
        assert counts("fault.survived", "seam") == {"ckpt": 1}
        assert counts("ckpt.writes", None) == {"": 1}
        assert counts("ckpt.resumes", None) == {"": 1}
    assert ci == 3 and meta == {"k": 1} and blob is None
    np.testing.assert_array_equal(arrays["a"], np.ones(2))


# ---- the prefetch seams ---------------------------------------------------

@pytest.mark.parametrize("depth", [0, 2])
def test_prefetch_io_and_prefetch_faults_are_absorbed(depth):
    penv.set_property("shifu.retry.max", "10")
    penv.set_property("shifu.retry.baseMs", "0")
    try:
        with obs_scope(), faults.activate(FaultPlan.parse(
                "io:p=0.3:seed=7,prefetch:p=0.3:seed=5")):
            got = list(pp.prefetch_iter(iter(range(40)), depth=depth,
                                        transform=lambda x: x * 2))
            inj = counts("fault.injected", "seam")
            survived = counts("fault.survived", "seam")
            chunks = counts("pipeline.chunks", None)
    finally:
        penv.set_property("shifu.retry.max", "")
        penv.set_property("shifu.retry.baseMs", "")
    assert got == [2 * x for x in range(40)]
    assert inj["io"] > 0 and inj["prefetch"] > 0
    assert survived == inj
    assert chunks == {"": 40}


def test_prefetch_real_read_error_stays_loud():
    def source():
        yield 1
        raise OSError("disk gone")

    with faults.activate(FaultPlan.parse("io:p=0")):
        it = pp.prefetch_iter(source(), depth=0)
        assert next(it) == 1
        with pytest.raises(OSError, match="disk gone"):
            next(it)


# ---- SIGTERM -> PreemptionError ----------------------------------------------

def test_preemption_handler_main_thread_only():
    got = []
    t = threading.Thread(
        target=lambda: got.append(faults.install_preemption_handler()))
    t.start()
    t.join(timeout=10)
    assert not t.is_alive() and got == [None]
    if threading.current_thread() is not threading.main_thread():
        assert faults.install_preemption_handler() is None
        return
    prev = signal.getsignal(signal.SIGTERM)
    restore = faults.install_preemption_handler()
    assert restore is not None
    try:
        with pytest.raises(PreemptionError, match="signal"):
            os.kill(os.getpid(), signal.SIGTERM)
            time.sleep(5)  # the handler raises out of the sleep
    finally:
        restore()
    assert signal.getsignal(signal.SIGTERM) is prev

"""`-Dshifu.sanitize=race` in the port (`shifu_tpu_torch/analysis/
racetrack.py`): the cases of `tests/test_racetrack.py` that need no JAX.

The unarmed contract (`tracked_lock` returns a plain `threading.Lock`),
arming by the environment, an order inversion flagged with both lock
names and sites, a consistent order and same-named instances clean, a
`guarded_by` breach naming lock, attribute and method, a long hold
reported without gating, the event cap bounding details but never counts,
the sanitizer's delta scoping, the labeled-metric race, the batcher
restarting while draining, and a race-armed serving run whose verdict is
clean.
"""

import threading
import time

import numpy as np
import pytest

pytest.importorskip("torch")

from shifu_tpu_torch.analysis import racetrack  # noqa: E402
from shifu_tpu_torch.analysis.sanitize import Sanitizer  # noqa: E402
from shifu_tpu_torch.utils import environment  # noqa: E402


@pytest.fixture()
def armed():
    """Force race arming + a clean tracker for one test."""
    tr = racetrack.tracker()
    tr.reset()
    racetrack.arm(True)
    yield tr
    racetrack.arm(None)
    tr.reset()


class _Props:
    def __init__(self, **props):
        self.props = {k.replace("_", "."): v for k, v in props.items()}

    def __enter__(self):
        for k, v in self.props.items():
            environment.set_property(k, v)
        return self

    def __exit__(self, *exc):
        for k in self.props:
            environment.set_property(k, "")


def test_unarmed_returns_plain_lock():
    racetrack.arm(False)
    try:
        lk = racetrack.tracked_lock("test.plain")
        assert not isinstance(lk, racetrack.TrackedLock)
        assert isinstance(lk, type(threading.Lock()))
    finally:
        racetrack.arm(None)


def test_environment_arms_construction():
    with _Props(shifu_sanitize="race"):
        lk = racetrack.tracked_lock("test.env")
    assert isinstance(lk, racetrack.TrackedLock)
    with _Props(shifu_sanitize="divergence"):
        lk2 = racetrack.tracked_lock("test.env2")
    assert not isinstance(lk2, racetrack.TrackedLock)
    assert not isinstance(racetrack.tracked_lock("test.env3"),
                          racetrack.TrackedLock)


def test_guarded_by_unarmed_is_passthrough_behavior():
    calls = []

    class C:
        _lock = None

        @racetrack.guarded_by("_lock")
        def m(self):
            calls.append(1)

    racetrack.arm(False)
    try:
        C().m()
    finally:
        racetrack.arm(None)
    assert calls == [1]
    assert C.m.__shifu_guarded_by__ == "_lock"


def test_inverted_order_flagged_with_both_lock_names(armed):
    a = racetrack.TrackedLock("test.lockA")
    b = racetrack.TrackedLock("test.lockB")
    first_done = threading.Event()

    def t1():
        try:
            with a:
                with b:
                    pass
        finally:
            first_done.set()

    def t2():
        # event-sequenced: the inversion is a witnessed order, so no
        # real deadlock is needed to flag it
        assert first_done.wait(5)
        with b:
            with a:
                pass

    ts = [threading.Thread(target=t1), threading.Thread(target=t2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(10)
    v = armed.verdict()
    assert v["inversions"] == 1
    (ev,) = v["inversionEvents"]
    assert ev["locks"] == ["test.lockA", "test.lockB"]
    assert set(ev["order"]) == {"test.lockA -> test.lockB",
                                "test.lockB -> test.lockA"}
    for site in ev["order"].values():
        assert "test_torch_racetrack.py" in site


def test_consistent_order_and_same_name_instances_are_clean(armed):
    a = racetrack.TrackedLock("test.okA")
    b = racetrack.TrackedLock("test.okB")

    def go():
        for _ in range(50):
            with a:
                with b:
                    pass

    ts = [threading.Thread(target=go) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(10)
    s1, s2 = (racetrack.TrackedLock("test.same") for _ in range(2))
    with s1:
        with s2:
            pass
    with s2:
        with s1:
            pass
    v = armed.verdict()
    assert v["inversions"] == 0
    assert v["acquisitions"] >= 400


def test_guarded_violation_names_lock_attr_method(armed):
    class Counter:
        def __init__(self):
            self._lock = racetrack.tracked_lock("test.guarded")
            self.n = 0

        @racetrack.guarded_by("_lock")
        def bump_locked(self):
            self.n += 1

        def bump_correctly(self):
            with self._lock:
                self.bump_locked()

    c = Counter()
    c.bump_correctly()
    assert armed.verdict()["guardViolations"] == 0
    # another thread HOLDS the lock while this thread calls the guarded
    # method: only per-thread ownership tracking can catch it
    holding, release = threading.Event(), threading.Event()

    def holder():
        with c._lock:
            holding.set()
            release.wait(5)

    t = threading.Thread(target=holder)
    t.start()
    assert holding.wait(5)
    c.bump_locked()
    release.set()
    t.join(5)
    v = armed.verdict()
    assert v["guardViolations"] == 1
    (ev,) = v["guardViolationEvents"]
    assert (ev["lock"], ev["attr"]) == ("test.guarded", "_lock")
    assert ev["method"].endswith("bump_locked")


def test_long_hold_recorded_not_gating(armed):
    with _Props(**{"shifu_sanitize_race_holdMs": "1"}):
        san = Sanitizer(["race"])
        lk = racetrack.TrackedLock("test.slow")
        with lk:
            time.sleep(0.02)
        v = san.verdict()
    assert v["race"]["longHolds"] == 1
    ev = v["race"]["longHoldEvents"][0]
    assert ev["lock"] == "test.slow" and ev["heldMs"] >= 1.0
    assert v["clean"] is True  # a perf hazard, not a correctness trap


def test_event_cap_limits_details_never_counts(armed, monkeypatch):
    monkeypatch.setattr(racetrack, "MAX_EVENTS", 3)

    class C:
        def __init__(self):
            self._lock = racetrack.tracked_lock("test.capped")

        @racetrack.guarded_by("_lock")
        def bump_locked(self):
            pass

    c = C()
    for _ in range(5):
        c.bump_locked()
    v = armed.verdict()
    assert v["guardViolations"] == 5
    assert len(v["guardViolationEvents"]) == 3
    san = Sanitizer(["race"])  # mark taken past the detail cap
    c.bump_locked()
    v = san.verdict()["race"]
    assert v["guardViolations"] == 1 and v["guardViolationEvents"] == []


def test_sanitizer_delta_scoping_and_unclean_on_inversion(armed):
    a = racetrack.TrackedLock("test.dA")
    b = racetrack.TrackedLock("test.dB")
    with a:
        with b:
            pass
    san = Sanitizer(["race"])  # the prior edge is before its mark
    with b:
        with a:
            pass
    v = san.verdict()
    assert v["race"]["armed"] is True
    assert v["race"]["inversions"] == 1 and v["clean"] is False
    san2 = Sanitizer(["race"])
    with b:
        with a:
            pass
    v2 = san2.verdict()
    assert v2["race"]["inversions"] == 1
    assert v2["race"]["inversionEvents"] == []  # detail deduped
    assert v2["clean"] is False


def test_metrics_labeled_child_creation_is_single_instance():
    from shifu_tpu_torch.obs.metrics import MetricsRegistry

    reg = MetricsRegistry()
    barrier = threading.Barrier(8)

    def hammer():
        barrier.wait(5)
        for k in range(200):
            reg.counter("race.c", shard=str(k % 3)).inc()

    ts = [threading.Thread(target=hammer) for _ in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(10)
    snap = reg.snapshot()["counters"]
    assert sum(v for k, v in snap.items() if k.startswith("race.c")) \
        == 8 * 200
    assert len([k for k in snap if k.startswith("race.c")]) == 3


class _Data:
    n_rows = 1
    names = ["a"]
    wire_format = "json"
    raw = {"a": np.asarray(["1"], object)}
    missing_values = ()

    def column(self, _c):
        return self.raw["a"]


def test_batcher_restart_while_draining_answers_everything():
    from shifu_tpu_torch.serve.batcher import MicroBatcher
    from shifu_tpu_torch.serve.queue import AdmissionQueue, RejectedError

    def crash(_data):
        raise AssertionError("boom")  # kills the worker

    admission = AdmissionQueue(64)
    mb = MicroBatcher(crash, admission, max_wait_ms=0.5, max_restarts=2)
    reqs = []
    for i in range(32):
        try:
            reqs.append(mb.submit(_Data()))
        except RejectedError:
            pass
        if i == 10:
            admission.close()  # the drain starts while crashes burn the
            # restart budget
    mb.join(20)
    for r in reqs:
        with pytest.raises(Exception):
            r.wait(10)


def test_race_armed_serving_run_is_clean(armed):
    """A scoring run (router, queue, batcher, health, breaker, obs
    registry, request traces) with every lock tracked: no inversion, no
    guard breach."""
    from shifu_tpu_torch.eval.scorer import ScoreResult
    from shifu_tpu_torch.serve.server import Scorer

    class _Registry:
        input_columns = ["a"]

        def score_raw(self, data):
            n = data.n_rows
            z = np.zeros(n, np.float32)
            return ScoreResult(model_scores=np.zeros((n, 1), np.float32),
                               mean=z, max=z, min=z, median=z,
                               model_names=["m"], model_widths=[1])

    san = Sanitizer(["race"])
    scorer = Scorer(_Registry(), max_wait_ms=0.5)
    try:
        def client():
            for _ in range(20):
                scorer.score_batch([{"a": "1"}, {"a": "2"}], timeout=10)

        ts = [threading.Thread(target=client) for _ in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(30)
    finally:
        scorer.close(10)
    v = san.verdict()
    assert v["race"]["acquisitions"] > 0
    assert v["race"]["inversions"] == 0
    assert v["race"]["guardViolations"] == 0
    assert v["clean"] is True

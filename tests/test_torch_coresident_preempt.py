"""Preemption as a ledger policy in the port (`shifu_tpu_torch/
coresident/`): the cases of the JAX package's
`tests/test_coresident_preempt.py` on the port. The grant's heartbeat can
evict the trainer at ANY epoch boundary; the per-stage checkpoint family
makes that loss-free — resume is bit-identical to an uninterrupted run,
re-admission self-heals in-process, and resuming under a CHANGED stage
count is refused with `ckpt.rejected{reason="stages"}` instead of
silently mixing slices. On top: the grant sees every byte before it is
placed (a ledger that refuses the first acquire leaves no tensor
placed), an eviction returns the whole charge, and the trainer through
`HttpGrant` against the port's zoo server is evicted first under serving
pressure and finishes bit-identical after re-admission.
"""

import json
import os
import threading
import time
import urllib.request

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from shifu_tpu_torch.coresident import (CoresidentConfig,  # noqa: E402
                                        EvictedError, train_nn_coresident)
from shifu_tpu_torch.coresident.tenant import (GrantFullError,  # noqa: E402
                                               LocalGrant)
from shifu_tpu_torch.norm.dataset import write_normalized  # noqa: E402
from shifu_tpu_torch.train.nn_trainer import NNTrainConfig  # noqa: E402


def _write_shards(tmp_path, n=500, d=6, seed=7):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    t = ((x[:, 0] - x[:, 1]) > 0).astype(np.int8)
    w = np.ones(n, np.float32)
    out = str(tmp_path / "NormalizedData")
    write_normalized(out, x, t, w, [f"c{i}" for i in range(d)],
                     n_shards=2)
    return out


def _cfg(**kw):
    base = dict(hidden_nodes=[6, 5], activations=["tanh"],
                propagation="R", num_epochs=8, valid_set_rate=0.2,
                seed=11)
    base.update(kw)
    return NNTrainConfig(**base)


def _flat(params):
    from shifu_tpu_torch.models.nn import flatten_params

    return np.asarray(flatten_params(params)[0])


class _EvictingGrant(LocalGrant):
    """Trips the eviction flag at one epoch. `readmit=False` also
    refuses the re-admission acquire (sustained pressure), which is
    what surfaces EvictedError; `readmit=True` models pressure that
    clears immediately — the trainer must self-heal in-process."""

    def __init__(self, evict_at, readmit=False):
        super().__init__("t")
        self.evict_at = int(evict_at)
        self.readmit = readmit
        self.tripped = False

    def heartbeat(self, epoch):
        if epoch == self.evict_at:
            self.tripped = True
            return True
        return False

    def acquire(self, nbytes):
        if self.tripped and not self.readmit:
            raise GrantFullError("pressure holds", int(nbytes))
        super().acquire(nbytes)


def _run(data_dir, cfg, fam, stages=2, microbatches=2, grant=None,
         resume=False, wait_ms=-1.0):
    ccfg = CoresidentConfig(stages=stages, microbatches=microbatches,
                            family_dir=str(fam), wait_ms=wait_ms)
    return train_nn_coresident(data_dir, cfg, ccfg,
                               grant=grant or LocalGrant(),
                               resume=resume, device="cpu")


def test_evict_resume_bit_identical(tmp_path):
    data_dir = _write_shards(tmp_path)
    cfg = _cfg()
    ref = _run(data_dir, cfg, tmp_path / "a")

    with pytest.raises(EvictedError) as ei:
        _run(data_dir, cfg, tmp_path / "b",
             grant=_EvictingGrant(4), wait_ms=0.0)
    assert ei.value.epoch == 4
    assert "resume" in str(ei.value)

    res = _run(data_dir, cfg, tmp_path / "b", resume=True)
    assert res.iterations == ref.iterations
    np.testing.assert_array_equal(_flat(ref.params), _flat(res.params))


def test_readmission_self_heals_in_process(tmp_path):
    """When the wait window finds room again, the trainer re-places its
    stages and finishes — same bits as never-evicted, no operator in
    the loop."""
    data_dir = _write_shards(tmp_path)
    cfg = _cfg()
    ref = _run(data_dir, cfg, tmp_path / "a")
    healed = _run(data_dir, cfg, tmp_path / "b",
                  grant=_EvictingGrant(3, readmit=True), wait_ms=50.0)
    assert healed.iterations == cfg.num_epochs
    np.testing.assert_array_equal(_flat(ref.params), _flat(healed.params))


def test_resume_across_changed_stages_rejected(tmp_path):
    """K is a placement choice, never training state: each stored part
    covers a different flat slice under a different K, so the family is
    refused (counted) and training starts fresh — still correct."""
    from shifu_tpu_torch import obs

    data_dir = _write_shards(tmp_path)
    cfg = _cfg()
    with pytest.raises(EvictedError):
        _run(data_dir, cfg, tmp_path / "fam",
             grant=_EvictingGrant(3), wait_ms=0.0)

    obs.reset()
    res = _run(data_dir, cfg, tmp_path / "fam", stages=1, microbatches=2,
               resume=True)
    reg = obs.registry()
    assert reg.counter("ckpt.rejected", reason="stages").value >= 1
    # fresh start, full run — and the fresh K=1 result is the ordinary
    # streamed trajectory
    assert res.iterations == cfg.num_epochs
    ref = _run(data_dir, cfg, tmp_path / "ref", stages=1, microbatches=2)
    np.testing.assert_array_equal(_flat(ref.params), _flat(res.params))


def test_evicted_snapshot_listed_resumable(tmp_path):
    """`shifu runs --resumable` material: an evicted co-resident family
    surfaces one aggregated row (family name, epoch, stage count), not
    K raw slot files."""
    from shifu_tpu_torch.resilience.checkpoint import list_resumable

    data_dir = _write_shards(tmp_path)
    cfg = _cfg()
    with pytest.raises(EvictedError):
        _run(data_dir, cfg, tmp_path / "fam",
             grant=_EvictingGrant(4), wait_ms=0.0)

    entries = [e for e in list_resumable(str(tmp_path / "fam"))
               if e.get("family") == "coresident"]
    assert len(entries) == 1, entries
    e = entries[0]
    assert e["epoch"] == 4
    assert e["stages"] == 2
    assert e["configSha"]
    assert e["bytes"] > 0
    # completion clears the family: nothing left to resume
    _run(data_dir, cfg, tmp_path / "fam", resume=True)
    assert not [e for e in list_resumable(str(tmp_path / "fam"))
                if e.get("family") == "coresident"]


class _RecordingGrant(LocalGrant):
    """Records every acquire; refuses from the `refuse_at`-th on."""

    def __init__(self, refuse_at=None):
        super().__init__("t")
        self.asks = []
        self.refuse_at = refuse_at

    def acquire(self, nbytes):
        if self.refuse_at is not None and len(self.asks) >= self.refuse_at:
            raise GrantFullError("full", int(nbytes))
        self.asks.append(int(nbytes))
        super().acquire(nbytes)


@pytest.mark.parametrize("stages", [1, 2])
def test_bytes_acquired_before_placement(tmp_path, stages, monkeypatch):
    """No tensor reaches the trainer's device before the grant charged
    it: a grant that refuses the first acquire fails the run before the
    first placement, and a stage's charge covers its weights, optimizer
    state and boundary buffers (the JAX plan's resident_bytes)."""
    from shifu_tpu_torch.coresident import trainer as tr

    data_dir = _write_shards(tmp_path)
    placed = []
    real = torch.as_tensor

    def spy(data, *a, **kw):
        placed.append(kw.get("device"))
        return real(data, *a, **kw)

    monkeypatch.setattr(tr.torch, "as_tensor", spy)
    with pytest.raises(GrantFullError):
        _run(data_dir, _cfg(), tmp_path / "a", stages=stages,
             grant=_RecordingGrant(refuse_at=0))
    assert placed == []
    monkeypatch.setattr(tr.torch, "as_tensor", real)
    grant = _RecordingGrant()
    _run(data_dir, _cfg(num_epochs=2), tmp_path / "b", stages=stages,
         grant=grant)
    assert len(grant.asks) >= stages
    assert all(a > 0 for a in grant.asks)
    # the run released its whole charge at the end
    assert grant.ledger.used == 0


def test_eviction_drops_every_device_reference(tmp_path):
    """An eviction releases the charge only after the stage buffers are
    dropped, and re-placement asks for no more than was held."""
    from shifu_tpu_torch.coresident import trainer as tr

    data_dir = _write_shards(tmp_path)
    seen = {}
    real_release = LocalGrant.release

    class _Spy(_EvictingGrant):
        def release(self, final=False):
            if not final:
                ex = seen["exec"]
                seen["flats_at_release"] = (ex.flats, ex.opts, ex._g)
            real_release(self, final)

    real_init = tr._PipelineExec.__init__

    def init(self, *a, **kw):
        real_init(self, *a, **kw)
        seen["exec"] = self

    tr._PipelineExec.__init__ = init
    try:
        _run(data_dir, _cfg(), tmp_path / "a",
             grant=_Spy(3, readmit=True), wait_ms=50.0)
    finally:
        tr._PipelineExec.__init__ = real_init
    assert seen["flats_at_release"] == ([], [], None)


# ---------------------------------------------------------------------------
# the trainer through HttpGrant against the port's zoo server
# ---------------------------------------------------------------------------


def _make_set(d, cols_n=4, hidden=3, seed=0):
    from shifu_tpu.models.nn import NNModelSpec, init_params

    cols = [f"c{i}" for i in range(cols_n)]
    sizes = [cols_n, hidden, 1]
    os.makedirs(os.path.join(d, "models"), exist_ok=True)
    specs = [{"name": c, "kind": "value", "outNames": [c], "mean": 0.0,
              "std": 1.0, "fill": 0.0, "zscore": True} for c in cols]
    NNModelSpec(layer_sizes=sizes, activations=["tanh"],
                input_columns=cols, norm_specs=specs,
                params=init_params(sizes, seed=seed),
                ).save(os.path.join(d, "models", "model0.nn"))
    return cols


def _post(port, path, doc):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", json.dumps(doc).encode(),
        {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e)


def test_http_grant_evicted_first_then_bit_identical(tmp_path):
    """`shifu retrain --coresident --serve-url` in miniature: the trainer
    charges the port server's zoo ledger over /admin/coresident/*; a
    cold serving set loading under the budget evicts the trainer first
    (reason pressure_background), the trainer checkpoints, waits, is
    re-admitted and finishes bit-identical to an uninterrupted run; the
    ledger's peak stays within the budget and every request is
    answered."""
    from shifu_tpu_torch import obs
    from shifu_tpu_torch.coresident.tenant import HttpGrant
    from shifu_tpu_torch.serve.server import ScoringServer
    from shifu_tpu_torch.serve.zoo import ModelZoo
    from shifu_tpu_torch.utils import environment

    root = str(tmp_path / "zoo")
    cols = _make_set(os.path.join(root, "a"), seed=0)
    _make_set(os.path.join(root, "b"), seed=7)
    probe = ModelZoo(root, n_replicas=1, budget_mb=0, device="cpu")
    try:
        probe.register("a", os.path.join(root, "a"))
        probe.ensure_resident("a")
        cost = probe.ledger.used  # one resident set's charge
    finally:
        probe.close(5.0)
    data_dir = _write_shards(tmp_path)
    cfg = _cfg()
    local = LocalGrant("retrain")
    ref = _run(data_dir, cfg, tmp_path / "ref", grant=local)
    need = local.ledger.peak  # the trainer's whole charge
    obs.reset()
    environment.set_property("shifu.lease.ttlMs", "0")
    # a and the trainer fit; b's load needs the trainer's bytes
    environment.set_property("shifu.serve.hbmBudgetMB",
                             str((cost + need + cost // 4) / (1024 * 1024)))
    srv = ScoringServer(root=root, port=0, replicas=1, device="cpu",
                        zoo={"a": os.path.join(root, "a")}).start()
    try:
        zoo = srv.zoo
        zoo.register("b", os.path.join(root, "b"))  # cold until asked
        base = f"http://127.0.0.1:{srv.port}"
        assert _post(srv.port, "/score/a",
                     {"records": [{c: "0.5" for c in cols}]})[0] == 200
        answers = []
        evicted_at = []

        class _Pressure(HttpGrant):
            """At epoch 3 a cold serving set is asked for: its load
            needs the trainer's bytes."""

            def heartbeat(self, epoch):
                if epoch == 3 and not evicted_at:
                    evicted_at.append(epoch)
                    rec = {c: "0.5" for c in cols}
                    for _ in range(200):
                        code, _d = _post(srv.port, "/score/b",
                                         {"records": [rec]})
                        if code == 200:
                            answers.append(code)
                            break
                        time.sleep(0.05)
                return super().heartbeat(epoch)

        grant = _Pressure(base, "retrain")
        ccfg = CoresidentConfig(stages=2, microbatches=2,
                                family_dir=str(tmp_path / "fam"),
                                wait_ms=30000.0)

        def release_pressure():
            # the serving set leaves again, so the trainer fits back
            deadline = time.monotonic() + 60
            while not evicted_at and time.monotonic() < deadline:
                time.sleep(0.02)
            time.sleep(0.3)
            zoo.evict("b", reason="admin")

        t = threading.Thread(target=release_pressure, daemon=True)
        t.start()
        res = train_nn_coresident(data_dir, cfg, ccfg, grant=grant,
                                  device="cpu")
        t.join(60)
        counters = obs.registry().snapshot()["counters"]
        assert counters.get('serve.zoo.evictions{reason='
                            '"pressure_background",tenant="retrain"}') == 1
        assert answers == [200]
        assert zoo.ledger.peak <= zoo.ledger.budget_bytes
        assert res.iterations == ref.iterations
        np.testing.assert_array_equal(_flat(ref.params), _flat(res.params))
        # completion forgot the tenant and returned its charge
        assert "retrain" not in (zoo.health_snapshot().get("background")
                                 or {})
        assert zoo.ledger.charge_of("retrain") == 0
    finally:
        srv.shutdown(10)
        environment.set_property("shifu.lease.ttlMs", "")
        environment.set_property("shifu.serve.hbmBudgetMB", "")

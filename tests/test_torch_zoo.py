"""The port's model zoo (`shifu_tpu_torch/serve/zoo.py`) against the JAX
package's (`shifu_tpu/serve/zoo.py`), on the CPU: every case of
tests/test_zoo.py, each driven through both zoos with the same sequence.

Both zoos read the same model files (written with the JAX package's
`.nn` writer). Each side's budget is set in its own priced cost, as
tests/test_zoo.py sets it (`2.5 * cost` of one set warmed at buckets 1
and 8): the JAX cost comes from XLA's `memory_analysis()`, the port's
from its analytic count (serve/registry.py `memory_analysis`), so byte
counts are not compared; the decisions are. Held equal: the tenant
states after each step, the eviction counters and reasons, the
refusals and error codes, the Retry-After arithmetic given the same
observed warm-ups, the tenant labels on the one /metrics page, and the
keys of the health and snapshot views. Scores: within the registry's
ATOL = 2e-3 (tests/test_torch_serve_registry.py) of the JAX zoo's, and a
re-admitted tenant's bit-equal to the port's own earlier ones.

Every zoo and server a test starts is closed in a fixture's teardown,
so no admission, batcher or lease thread outlives its test.
"""

import json
import os
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from shifu_tpu import obs as jobs  # noqa: E402
from shifu_tpu.serve import zoo as jzoo_mod  # noqa: E402
from shifu_tpu.utils import environment as jenv  # noqa: E402
from shifu_tpu.utils.errors import ErrorCode as JErrorCode  # noqa: E402
from shifu_tpu.utils.errors import ShifuError as JShifuError  # noqa: E402
from shifu_tpu_torch import obs as pobs  # noqa: E402
from shifu_tpu_torch.serve import zoo as pzoo_mod  # noqa: E402
from shifu_tpu_torch.utils import environment as penv  # noqa: E402
from shifu_tpu_torch.utils.errors import ErrorCode  # noqa: E402
from shifu_tpu_torch.utils.errors import ShifuError  # noqa: E402

ATOL = 2e-3
MB = 1024.0 * 1024.0


def _make_set(d, cols_n=4, hidden=3, bags=1, seed=0):
    from shifu_tpu.models.nn import NNModelSpec, init_params

    cols = [f"c{i}" for i in range(cols_n)]
    sizes = [cols_n, hidden, 1]
    models = os.path.join(d, "models")
    os.makedirs(models, exist_ok=True)
    for b in range(bags):
        specs = [{"name": c, "kind": "value", "outNames": [c],
                  "mean": 0.0, "std": 1.0, "fill": 0.0, "zscore": True}
                 for c in cols]
        NNModelSpec(layer_sizes=sizes, activations=["tanh"],
                    input_columns=cols, norm_specs=specs,
                    params=init_params(sizes, seed=seed + b),
                    ).save(os.path.join(models, f"model{b}.nn"))
    return cols


def _records(cols, n=2, seed=0):
    rng = np.random.default_rng(seed)
    return [{c: f"{v:.5f}" for c, v in zip(cols, row)}
            for row in rng.normal(size=(n, len(cols)))]


def _costs(models_dir, buckets=(1, 8)):
    """(JAX cost, port cost): one set's priced residency on each side at
    replicas=1, by the memory_analysis its ledger prices with."""
    from shifu_tpu.serve.registry import ModelRegistry as JRegistry
    from shifu_tpu_torch.serve.registry import ModelRegistry as PRegistry

    jreg = JRegistry(models_dir)
    jreg.warm(buckets)
    jcost = jreg.memory_analysis()["residentBytes"]
    jreg.release()
    preg = PRegistry(models_dir, device="cpu")
    preg.warm(buckets)
    pcost = preg.memory_analysis()["residentBytes"]
    preg.release()
    return jcost, pcost


@pytest.fixture()
def three_sets(tmp_path):
    root = str(tmp_path)
    cols = _make_set(os.path.join(root, "a"), seed=0)
    _make_set(os.path.join(root, "b"), seed=7)
    _make_set(os.path.join(root, "c"), seed=13)
    return root, cols


@pytest.fixture()
def zoos():
    """make(root, factor, **kw) -> (JAX zoo, port zoo) with a, b, c
    registered; `factor` x each side's own cost is its budget (0 =
    unbounded). Every zoo made is closed at teardown."""
    made = []

    def make(root, factor=0.0, names=("a", "b", "c"), **kw):
        n_replicas = kw.pop("n_replicas", 1)
        jb = pb = 0.0
        if factor:
            jcost, pcost = _costs(os.path.join(root, "a", "models"))
            jb, pb = factor * jcost / MB, factor * pcost / MB
        jobs.reset()
        pobs.reset()
        jz = jzoo_mod.ModelZoo(root, n_replicas=n_replicas, budget_mb=jb,
                               **kw)
        pz = pzoo_mod.ModelZoo(root, n_replicas=n_replicas, budget_mb=pb,
                               device="cpu", **kw)
        made.extend([jz, pz])
        for name in names:
            jz.register(name, os.path.join(root, name))
            pz.register(name, os.path.join(root, name))
        return jz, pz

    yield make
    for z in made:
        z.close(5.0)


def _states(z):
    return {n: z._get(n).state for n in z.tenants()}


def _evictions(counters):
    return {k: v for k, v in counters.items()
            if k.startswith("serve.zoo.evictions")}


# ---------------------------------------------------------------------------
# registration
# ---------------------------------------------------------------------------


def test_oversized_tenant_rejected_at_registration(tmp_path):
    root = str(tmp_path)
    _make_set(os.path.join(root, "big"), cols_n=16, hidden=64, bags=2)
    jz = jzoo_mod.ModelZoo(root, n_replicas=1, budget_mb=0.001)
    pz = pzoo_mod.ModelZoo(root, n_replicas=1, budget_mb=0.001,
                           device="cpu")
    with pytest.raises(JShifuError) as je:
        jz.register("big", os.path.join(root, "big"))
    with pytest.raises(ShifuError) as pe:
        pz.register("big", os.path.join(root, "big"))
    assert je.value.code is JErrorCode.ILLEGAL_ARGUMENT
    assert pe.value.code is ErrorCode.ILLEGAL_ARGUMENT
    assert "big" not in pz.tenants() and "big" not in jz.tenants()


@pytest.mark.parametrize("bad", ["", "a/b", "a b", ".hidden", "x" * 70])
def test_bad_names_rejected(tmp_path, bad):
    root = str(tmp_path)
    _make_set(os.path.join(root, "a"))
    jz = jzoo_mod.ModelZoo(root, n_replicas=1, budget_mb=0)
    pz = pzoo_mod.ModelZoo(root, n_replicas=1, budget_mb=0, device="cpu")
    with pytest.raises(JShifuError) as je:
        jz.register(bad, os.path.join(root, "a"))
    with pytest.raises(ShifuError) as pe:
        pz.register(bad, os.path.join(root, "a"))
    assert pe.value.code.name == je.value.code.name == "ILLEGAL_ARGUMENT"


def test_duplicate_name_and_empty_dir_rejected(three_sets, zoos, tmp_path):
    root, _cols = three_sets
    jz, pz = zoos(root)
    for z, err in ((jz, JShifuError), (pz, ShifuError)):
        with pytest.raises(err) as ei:
            z.register("a", os.path.join(root, "a"))
        assert ei.value.code.name == "ILLEGAL_ARGUMENT"
    empty = tmp_path / "empty"
    empty.mkdir()
    for z in (jz, pz):
        with pytest.raises(ValueError, match="no models"):
            z.register("empty", str(empty))


# ---------------------------------------------------------------------------
# LRU eviction
# ---------------------------------------------------------------------------


def test_admission_past_budget_evicts_lru_and_ledgers_it(three_sets, zoos):
    root, cols = three_sets
    jz, pz = zoos(root, 2.5)
    got = []
    for z, obs in ((jz, jobs), (pz, pobs)):
        z.ensure_resident("a")
        z.ensure_resident("b")
        z.score_batch("a", _records(cols))  # b is now the LRU
        z.ensure_resident("c")              # must evict b
        got.append((_states(z),
                    _evictions(obs.registry().snapshot()["counters"])))
        assert z.ledger.peak <= z.ledger.budget_bytes
    assert got[0] == got[1]
    assert got[1][0] == {"a": "resident", "b": "cold", "c": "resident"}
    assert got[1][1] == {
        'serve.zoo.evictions{reason="pressure",tenant="b"}': 1}


def test_lru_tie_break_is_deterministic(three_sets, zoos):
    """Never-scored tenants tie at last_used=0.0 and break by
    registration order: the first-registered goes."""
    root, _cols = three_sets
    jz, pz = zoos(root, 2.5)
    for z in (jz, pz):
        z.ensure_resident("a")
        z.ensure_resident("b")
        z.ensure_resident("c")
    assert _states(jz) == _states(pz) == {
        "a": "cold", "b": "resident", "c": "resident"}


def test_readmission_scores_bit_identically(three_sets, zoos):
    root, cols = three_sets
    jz, pz = zoos(root, 2.5)
    recs = _records(cols, n=4, seed=3)
    out = []
    for z in (jz, pz):
        z.ensure_resident("a")
        z.ensure_resident("b")
        before = z.score_batch("a", recs)
        z.score_batch("b", recs)           # b now most-recent
        z.ensure_resident("c")             # evicts a (LRU)
        assert z._get("a").state == "cold"
        z.ensure_resident("a")             # re-admits a, evicting LRU
        again = z.score_batch("a", recs)
        out.append((before, again, _states(z), z._get("a").evictions))
    (jb, _ja, js, je), (pb, pa, ps, pe) = out
    assert js == ps and je == pe == 1
    # the port against itself: bit-equal after re-admission
    np.testing.assert_array_equal(pb.model_scores, pa.model_scores)
    np.testing.assert_array_equal(pb.mean, pa.mean)
    # the port against the JAX zoo: within the registry's tolerance
    np.testing.assert_allclose(pb.model_scores, jb.model_scores,
                               atol=ATOL, rtol=0)


def test_readmission_rewarms_remembered_buckets(three_sets, zoos):
    root, cols = three_sets
    jz, pz = zoos(root, 2.2)
    for z in (jz, pz):
        z.ensure_resident("a")
        z.score_batch("a", _records(cols, n=1))
        z.evict("a", reason="test")
    assert jz._get("a").warm_buckets == pz._get("a").warm_buckets
    assert 8 in pz._get("a").warm_buckets  # SERVE_MIN_ROW_BUCKET
    for z in (jz, pz):
        z.ensure_resident("a")
        assert 8 in z._get("a").fleet.snapshot()["warmBuckets"]


def test_evicting_mid_promote_tenant_is_refused(three_sets, zoos):
    root, _cols = three_sets
    jz, pz = zoos(root)
    for z in (jz, pz):
        z.ensure_resident("a")
        tenant = z._get("a")
        z._busy_guard(tenant, "promote")  # a promote is in flight
        try:
            with pytest.raises(ValueError, match="mid-promote"):
                z.evict("a")
            assert z._claim_victim() is None  # nor may the LRU pick it
        finally:
            z._busy_clear(tenant)


def test_evicting_shadow_staged_tenant_is_refused(three_sets, zoos):
    root, _cols = three_sets
    jz, pz = zoos(root)
    for z in (jz, pz):
        z.ensure_resident("a")
        z.stage("a", os.path.join(root, "b", "models"))
        with pytest.raises(ValueError, match="staged shadow"):
            z.evict("a")
        assert z._claim_victim() is None
        z.unstage("a")
        z.evict("a")  # now legal
    assert _states(jz) == _states(pz)
    assert pz._get("a").state == "cold"


def test_cold_tenant_is_not_evictable(three_sets, zoos):
    root, _cols = three_sets
    jz, pz = zoos(root)
    for z in (jz, pz):
        with pytest.raises(ValueError, match="not resident"):
            z.evict("a")


# ---------------------------------------------------------------------------
# the budget ledger
# ---------------------------------------------------------------------------


def test_ledger_never_exceeds_budget_through_stage_and_promote(
        three_sets, zoos):
    root, cols = three_sets
    jz, pz = zoos(root, 2.6)
    for z in (jz, pz):
        budget = z.ledger.budget_bytes
        z.ensure_resident("a")
        z.ensure_resident("b")
        z.score_batch("a", _records(cols))
        z.stage("a", os.path.join(root, "c", "models"))
        assert z.ledger.peak <= budget
        assert z._get("b").state == "cold"  # made room for the stage
        shadow = z.shadow_snapshot("a")
        swap = z.promote("a", expected_sha=shadow["sha"])
        assert swap["to"] == shadow["sha"]
        assert z.ledger.peak <= budget
        assert z.ledger.charge_of("a", "shadow") == 0
        assert z.ledger.charge_of("a", "active") > 0
        assert z._get("a").active_dir == os.path.join(root, "c", "models")
    assert _states(jz) == _states(pz)
    assert (jz.shadow_snapshot("a") is None) == (pz.shadow_snapshot("a")
                                                 is None)


def test_stage_is_streamed_in_groups(three_sets, zoos):
    root, _cols = three_sets
    jz, pz = zoos(root)
    for z in (jz, pz):
        z.ensure_resident("a")
        groups = []
        orig = z.ledger.acquire

        def spy(tenant, kind, nbytes, _orig=orig, _groups=groups):
            if kind == "shadow":
                _groups.append(int(nbytes))
            return _orig(tenant, kind, nbytes)

        z.ledger.acquire = spy
        try:
            z.stage("a", os.path.join(root, "b", "models"))
        finally:
            z.ledger.acquire = orig
        # the plan's constants and each layer's W and b: several acquires
        # before the true-up, none of them the whole registry
        assert len(groups) >= 4, groups
        z.unstage("a")
        assert z.ledger.charge_of("a", "shadow") == 0


def test_failed_admission_releases_charge(three_sets, zoos, tmp_path):
    root, _cols = three_sets
    jz, pz = zoos(root)
    for z in (jz, pz):
        tenant = z.register("broken", os.path.join(root, "b"))
        tenant.active_dir = str(tmp_path / "vanished-models")
        with pytest.raises(Exception):
            z.ensure_resident("broken")
        assert z.ledger.charge_of("broken") == 0
        assert z._get("broken").state == "cold"
    counters = [o.registry().snapshot()["counters"] for o in (jobs, pobs)]
    key = 'serve.zoo.admission_errors{tenant="broken"}'
    assert counters[0].get(key) == counters[1].get(key) == 1


# ---------------------------------------------------------------------------
# cold starts
# ---------------------------------------------------------------------------


def _wait_scored(z, name, recs):
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        try:
            return z.score_batch(name, recs)
        except (jzoo_mod.ColdStartError, pzoo_mod.ColdStartError):
            time.sleep(0.05)
    pytest.fail("background admission never completed")


def test_cold_request_answers_coldstart_not_hang(three_sets, zoos):
    root, cols = three_sets
    jz, pz = zoos(root)
    errs = {}
    for z, cold in ((jz, jzoo_mod.ColdStartError),
                    (pz, pzoo_mod.ColdStartError)):
        t0 = time.perf_counter()
        with pytest.raises(cold) as ei:
            z.score_batch("a", _records(cols))
        assert time.perf_counter() - t0 < 1.0  # answered at once
        errs[z] = ei.value
    je, pe = errs[jz], errs[pz]
    assert pe.reason == je.reason == "cold_start"
    # the fallback hint (no admission observed yet), minus the time the
    # in-flight admission already spent, clamped to the 1 s floor
    assert pe.retry_after_s >= 1.0 and je.retry_after_s >= 1.0
    jr = _wait_scored(jz, "a", _records(cols))
    pr = _wait_scored(pz, "a", _records(cols))
    assert pr.mean.shape == jr.mean.shape == (2,)
    np.testing.assert_allclose(pr.mean, jr.mean, atol=ATOL, rtol=0)


@pytest.mark.parametrize("observed", [None, 0.2, 3.5, 500.0])
def test_retry_after_arithmetic_matches(three_sets, zoos, observed):
    """Given the same observed warm-ups (this tenant's, else the zoo's
    EMA, else shifu.serve.zoo.warmupMs), both zoos hint the same
    Retry-After, clamped to [1, 120] s."""
    root, _cols = three_sets
    jz, pz = zoos(root)
    hints = []
    for z in (jz, pz):
        t = z._get("b")
        t.warm_seconds = observed
        z._warm_ema = None if observed is None else observed * 2
        hints.append((z._cold_retry_after(t),
                      z._cold_retry_after(z._get("c"))))
    assert hints[0] == hints[1]
    if observed is None:
        assert hints[1][0] == pytest.approx(5.0)  # the 5 s fallback
    jenv.set_property("shifu.serve.zoo.warmupMs", "2500")
    penv.set_property("shifu.serve.zoo.warmupMs", "2500")
    try:
        assert (jz._cold_retry_after(jz._get("a"))
                == pz._cold_retry_after(pz._get("a")))
    finally:
        jenv.set_property("shifu.serve.zoo.warmupMs", "")
        penv.set_property("shifu.serve.zoo.warmupMs", "")


def test_retry_after_uses_observed_warmup(three_sets, zoos):
    root, _cols = three_sets
    _jz, pz = zoos(root)
    pz.ensure_resident("a")
    observed = pz._get("a").warm_seconds
    assert observed is not None and observed > 0
    pz.evict("a", reason="test")
    hint = pz._cold_retry_after(pz._get("a"))
    assert hint == pytest.approx(max(observed, 1.0), abs=0.5)


# ---------------------------------------------------------------------------
# metrics and health
# ---------------------------------------------------------------------------

# series whose tenant labels both packages put on the one /metrics page
TENANT_SERIES = ("serve_requests_total", "serve_queue_depth",
                 "serve_queue_admitted_total", "serve_batches_total",
                 "serve_records_total", "serve_version_batches_total",
                 "serve_zoo_admissions_total", "serve_zoo_tenant_hbm_bytes",
                 "serve_zoo_cold_start_seconds_count", "serve_replicas")


def _tenant_series(page):
    from shifu_tpu_torch.obs.metrics import _parse_key, parse_prometheus

    out = set()
    for key in parse_prometheus(page):
        name, labels = _parse_key(key)
        if name in TENANT_SERIES and "tenant" in labels:
            labels.pop("sha", None)  # the model-set hash: byte-equal
            out.add((name, tuple(sorted(labels.items()))))
    return out


def test_tenant_labels_on_single_exporter_page(three_sets, zoos):
    root, cols = three_sets
    jz, pz = zoos(root, n_replicas=2)
    for z in (jz, pz):
        z.ensure_resident("a")
        z.ensure_resident("b")
        z.score_batch("a", _records(cols))
        z.score_batch("b", _records(cols))
    jpage = jobs.registry().to_prometheus()
    page = pobs.registry().to_prometheus()
    for name in ('serve_requests_total{format="json",replica="0",'
                 'tenant="a"}',
                 'serve_requests_total{format="json",replica="0",'
                 'tenant="b"}',
                 'serve_queue_depth{replica="0",tenant="a"}',
                 'serve_zoo_hbm_used_bytes', 'serve_zoo_resident_tenants 2'):
        assert name in page and name in jpage, name
    types = [ln.split()[2] for ln in page.splitlines()
             if ln.startswith("# TYPE")]
    assert len(types) == len(set(types))  # one valid page
    assert _tenant_series(page) == _tenant_series(jpage)
    assert any(n == "serve_requests_total" for n, _ in _tenant_series(page))


def test_health_and_snapshot_views_have_the_jax_keys(three_sets, zoos):
    root, cols = three_sets
    jz, pz = zoos(root, 2.5)
    views = []
    for z in (jz, pz):
        z.ensure_resident("a")
        z.score_batch("a", _records(cols))
        h = z.health_snapshot()
        assert h["residentTenants"] == 1
        assert 0 < h["hbmBudgetUsedMB"] <= h["hbmBudgetMB"]
        assert h["tenants"]["a"]["state"] == "resident"
        assert h["tenants"]["b"]["state"] == "cold"
        snap = z.snapshot()
        views.append((set(h), {k: set(v) for k, v in h["tenants"].items()},
                      set(snap), set(snap["ledger"]),
                      {k: set(v) for k, v in snap["tenants"].items()},
                      set(z.fleet_health_snapshot())))
    assert views[0] == views[1]
    mem = pz.snapshot()["tenants"]["a"]["memory"]
    assert set(mem) == {"replicas", "residentBytes"}
    assert {"weightsBytes", "programPeakBytes", "stagingBytes",
            "residentBytes"} <= set(mem["replicas"][0]["active"])


def test_alloc_count_takes_new_storage_only():
    """The port's program price counts an op's result only where its
    storage is new: views and in-place results add nothing, every new
    tensor adds its bytes rounded up to the allocator's 512-byte block."""
    from shifu_tpu_torch.serve.registry import _CountAllocs

    x = torch.ones(10, 100)  # 4,000 bytes: one 4,096-byte charge
    with torch.inference_mode():
        x = x.clone()
        with _CountAllocs() as count:
            x[:, :3].t()
            x.add_(1.0)
        assert count.nbytes == 0
        with _CountAllocs() as count:
            y = x + 1.0
            torch.sort(y[:1], dim=1)  # values (400 B), indices (800 B)
    assert count.nbytes == 4096 + 512 + 1024


def test_program_bytes_counted_on_each_buckets_first_call(tmp_path):
    """Each bucket's price is counted on its first call, warm or not,
    fires the cost hook, and stays as counted; it covers at least the
    call's output."""
    from shifu_tpu_torch.serve.registry import ModelRegistry, _block

    cols = _make_set(str(tmp_path), cols_n=6, hidden=5, bags=3)
    reg = ModelRegistry(str(tmp_path / "models"), device="cpu")
    hooked = []
    reg.cost_hook = lambda: hooked.append(
        (reg.program_bytes(8), reg.program_bytes(64)))
    assert reg.program_bytes(8) == 0
    reg.warm([1])
    first = reg.program_bytes(8)
    out_bytes = _block(8 * (3 + 4) * 4)  # the scores and 4 aggregates
    assert first > out_bytes
    reg.score_records(_records(cols, n=40))  # bucket 64, first call
    assert hooked == [(first, 0), (first, reg.program_bytes(64))]
    assert reg.program_bytes(64) > first
    reg.score_records(_records(cols, n=3))
    assert reg.program_bytes(8) == first
    mem = reg.memory_analysis()
    assert [(p["bucket"], p["peakBytes"]) for p in mem["programs"]] == [
        (8, first), (64, reg.program_bytes(64))]
    assert mem["programPeakBytes"] == reg.program_bytes(64)
    reg.release()


# ---------------------------------------------------------------------------
# the HTTP surface
# ---------------------------------------------------------------------------


def _post(port, path, doc):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", json.dumps(doc).encode(),
        {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.load(r), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e), dict(e.headers)


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as r:
        return r.status, json.load(r)


@pytest.fixture()
def servers(three_sets):
    """A JAX and a port zoo server on a, b, c, each budget 2.6 x its own
    set cost (a and b fit at startup, c stays cold); leases off on both,
    as tests/test_zoo.py runs them."""
    from shifu_tpu.serve.server import ScoringServer as JServer
    from shifu_tpu_torch.serve.server import ScoringServer as PServer

    root, cols = three_sets
    jcost, pcost = _costs(os.path.join(root, "a", "models"))
    jobs.reset()
    pobs.reset()
    sets = {n: os.path.join(root, n) for n in ("a", "b", "c")}
    made = []
    try:
        for env, cost in ((jenv, jcost), (penv, pcost)):
            env.set_property("shifu.serve.hbmBudgetMB",
                             str(2.6 * cost / MB))
            env.set_property("shifu.lease.ttlMs", "0")
        js = JServer(root=root, port=0, replicas=1, zoo=sets)
        made.append(js.start())
        ps = PServer(root=root, port=0, replicas=1, device="cpu", zoo=sets)
        made.append(ps.start())
        yield js, ps, root, cols
    finally:
        for srv in made:
            srv.shutdown(10)
        for env in (jenv, penv):
            env.set_property("shifu.serve.hbmBudgetMB", "")
            env.set_property("shifu.lease.ttlMs", "")


def test_per_set_routes_and_cold_429(servers):
    js, ps, _root, cols = servers
    body = {"records": _records(cols)}
    answers = []
    for srv in (js, ps):
        code, doc, _h = _post(srv.port, "/score/a", body)
        assert code == 200 and doc["scores"]
        default = _post(srv.port, "/score", body)[0]  # the default: a
        cold = _post(srv.port, "/score/c", body)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            code, warm, _h = _post(srv.port, "/score/c", body)
            if code == 200:
                break
            time.sleep(0.1)
        unknown = _post(srv.port, "/score/nope", body)
        answers.append((doc, default, cold, code, warm, unknown))
    (jdoc, jdef, jcold, jcode, jwarm, junk), \
        (pdoc, pdef, pcold, pcode, pwarm, punk) = answers
    assert jdef == pdef == 200
    assert pcold[0] == jcold[0] == 429
    assert pcold[1]["reason"] == jcold[1]["reason"] == "cold_start"
    assert set(pcold[1]) == set(jcold[1])
    assert int(pcold[2]["Retry-After"]) >= 1
    assert pcode == jcode == 200
    assert punk[0] == junk[0] == 404 and "nope" in punk[1]["error"]
    for j, p in ((jdoc, pdoc), (jwarm, pwarm)):
        np.testing.assert_allclose(
            [r["mean"] for r in p["scores"]],
            [r["mean"] for r in j["scores"]], atol=ATOL, rtol=0)


def test_healthz_zoo_section(servers):
    js, ps, _root, _cols = servers
    docs = [_get(srv.port, "/healthz") for srv in (js, ps)]
    (jc, jh), (pc, ph) = docs
    assert jc == pc == 200
    assert set(ph["zoo"]) == set(jh["zoo"])
    z = ph["zoo"]
    assert z["residentTenants"] == jh["zoo"]["residentTenants"] >= 1
    assert z["hbmBudgetUsedMB"] <= z["hbmBudgetMB"]
    assert set(z["tenants"]) == {"a", "b", "c"}
    assert {t: v["state"] for t, v in z["tenants"].items()} == \
        {t: v["state"] for t, v in jh["zoo"]["tenants"].items()}


def test_admin_evict_stage_and_promote_by_set(servers):
    js, ps, root, cols = servers
    out = []
    for srv in (js, ps):
        ev = _post(srv.port, "/admin/evict", {"set": "b"})
        again = _post(srv.port, "/admin/evict", {"set": "b"})  # cold now
        missing = _post(srv.port, "/admin/evict", {})
        st = _post(srv.port, "/admin/stage",
                   {"set": "a",
                    "modelsDir": os.path.join(root, "b", "models")})
        busy = _post(srv.port, "/admin/evict", {"set": "a"})  # staged
        sha = st[1]["staged"]["sha"]
        shadow = _get(srv.port, "/admin/shadow?set=a")
        bad = _post(srv.port, "/admin/promote", {"set": "a", "sha": "x"})
        pr = _post(srv.port, "/admin/promote", {"set": "a", "sha": sha})
        score = _post(srv.port, "/score/a", {"records": _records(cols)})
        out.append((ev, again, missing, st, busy, sha, shadow, bad, pr,
                    score))
    for j, p in zip(out[0], out[1]):
        if isinstance(j, tuple):
            assert p[0] == j[0], (p, j)
    (jev, *_rest), (pev, _ag, _mi, _st, _bu, psha, pshadow, _bad, ppr,
                    _sc) = out
    assert pev[1]["zoo"]["tenants"]["b"]["state"] == "cold"
    assert set(pev[1]) == set(jev[1])
    assert psha == out[0][5]  # the same files: the same content sha
    assert pshadow[1]["shadow"]["sha"] == psha
    assert ppr[1]["to"] == psha


def test_shutdown_manifest_carries_zoo_ledger(three_sets):
    from shifu_tpu.serve.server import ScoringServer as JServer
    from shifu_tpu_torch.serve.server import ScoringServer as PServer

    root, cols = three_sets
    mans = []
    for env, srv_cls, kw, obs in ((jenv, JServer, {}, jobs),
                                  (penv, PServer, {"device": "cpu"}, pobs)):
        obs.reset()
        env.set_property("shifu.lease.ttlMs", "0")
        try:
            srv = srv_cls(root=root, port=0, replicas=1,
                          zoo={"a": os.path.join(root, "a")}, **kw)
            srv.start()
            try:
                _post(srv.port, "/score/a", {"records": _records(cols)})
            finally:
                out = srv.shutdown(10)
        finally:
            env.set_property("shifu.lease.ttlMs", "")
        path = out if isinstance(out, str) else srv.manifest_path
        with open(path) as fh:
            mans.append(json.load(fh)["zoo"])
    jman, pman = mans
    assert set(pman) == set(jman)
    assert set(pman["ledger"]) == set(jman["ledger"])
    assert pman["tenants"]["a"]["requests"] == 1
    assert set(pman["tenants"]["a"]) == set(jman["tenants"]["a"])
    assert "memory" in pman["tenants"]["a"]


def test_zoo_route_refusals_on_a_single_tenant_server(three_sets):
    from shifu_tpu_torch.serve.server import ScoringServer as PServer

    root, cols = three_sets
    penv.set_property("shifu.lease.ttlMs", "0")
    srv = PServer(root=os.path.join(root, "a"), port=0, replicas=1,
                  device="cpu").start()
    try:
        code, doc, _h = _post(srv.port, "/admin/evict", {"set": "a"})
        assert code == 409 and "single-tenant" in doc["error"]
        code, doc, _h = _post(srv.port, "/admin/evict", {})
        assert code == 409 and "zoo mode" in doc["error"]
        code, doc, _h = _post(srv.port, "/score/a",
                              {"records": _records(cols)})
        assert code == 404 and "single-tenant" in doc["error"]
        # the co-resident grant plane rides a zoo's ledger
        code, doc, _h = _post(srv.port, "/admin/coresident/admit", {})
        assert code == 409 and "zoo mode" in doc["error"]
    finally:
        srv.shutdown(10)
        penv.set_property("shifu.lease.ttlMs", "")


# ---------------------------------------------------------------------------
# background tenants (the co-resident trainer's ledger plane)
# ---------------------------------------------------------------------------


def test_background_acquire_is_fit_or_fail(three_sets, zoos):
    root, _cols = three_sets
    jz, pz = zoos(root, 2.5)
    for z, full in ((jz, jzoo_mod.LedgerFullError),
                    (pz, pzoo_mod.LedgerFullError)):
        z.ensure_resident("a")
        z.ensure_resident("b")
        grant = z.admit_background("retrain", meta={"algo": "nn"})
        assert grant["freeBytes"] is not None and grant["devices"] >= 1
        with pytest.raises(full) as ei:
            z.background_acquire("retrain", grant["freeBytes"] + 1)
        assert ei.value.deficit >= 1
        # fit-or-fail: no serving tenant was evicted to make room
        assert z._get("a").state == z._get("b").state == "resident"
        z.background_acquire("retrain", grant["freeBytes"])  # fits


def test_serving_pressure_evicts_background_first(three_sets, zoos):
    root, _cols = three_sets
    jz, pz = zoos(root, 2.5)
    got = []
    for z, obs in ((jz, jobs), (pz, pobs)):
        z.ensure_resident("a")
        z.ensure_resident("b")
        grant = z.admit_background("retrain", meta={"stages": 2})
        z.background_acquire("retrain", grant["freeBytes"])
        assert z.background_heartbeat("retrain", 3) is False
        z.ensure_resident("c")  # needs the trainer's bytes AND a's
        counters = _evictions(obs.registry().snapshot()["counters"])
        got.append((counters, _states(z),
                    z.background_heartbeat("retrain", 4)))
    assert got[0] == got[1]
    counters, states, flagged = got[1]
    assert counters == {
        'serve.zoo.evictions{reason="pressure_background",'
        'tenant="retrain"}': 1,
        'serve.zoo.evictions{reason="pressure",tenant="a"}': 1}
    assert states["b"] == "resident" and flagged is True


def test_evicted_record_survives_until_final_release(three_sets, zoos):
    root, _cols = three_sets
    jz, pz = zoos(root)
    snaps = []
    for z in (jz, pz):
        z.admit_background("retrain", meta={"algo": "nn", "stages": 2})
        z.background_acquire("retrain", 4096)
        z.background_heartbeat("retrain", 5)
        z.evict("retrain")  # the /admin/evict path, background branch
        snaps.append(z.health_snapshot()["background"]["retrain"])
        z.background_release("retrain", final=False)
        assert "retrain" in z.health_snapshot()["background"]
        z.admit_background("retrain")
        assert z.background_heartbeat("retrain", 6) is False
        z.background_release("retrain", final=True)
        assert "retrain" not in (z.health_snapshot().get("background")
                                 or {})
    assert snaps[0] == snaps[1]
    assert snaps[1]["evictRequested"] and snaps[1]["evictions"] == 1
    assert snaps[1]["epoch"] == 5 and snaps[1]["stages"] == 2


def test_background_name_collisions_and_flagged_reacquire(three_sets,
                                                         zoos):
    root, _cols = three_sets
    jz, pz = zoos(root)
    for z, err, full in ((jz, JShifuError, jzoo_mod.LedgerFullError),
                         (pz, ShifuError, pzoo_mod.LedgerFullError)):
        with pytest.raises(ValueError, match="serving tenant"):
            z.admit_background("a")
        z.admit_background("retrain")
        with pytest.raises(err) as ei:
            z.register("retrain", os.path.join(root, "a"))
        assert ei.value.code.name == "ILLEGAL_ARGUMENT"
        z.background_acquire("retrain", 1024)
        z.evict("retrain")
        with pytest.raises(full, match="flagged"):
            z.background_acquire("retrain", 1024)


# ---------------------------------------------------------------------------
# the background tenants over HTTP: /admin/coresident/* on both servers
# ---------------------------------------------------------------------------


def _grant(srv, action, doc):
    return _post(srv.port, f"/admin/coresident/{action}",
                 {"tenant": "retrain", **doc})


def _zoo_health(srv):
    return _get(srv.port, "/healthz")[1]["zoo"]


def _score_until_200(srv, name, cols, seconds=60):
    deadline = time.monotonic() + seconds
    while time.monotonic() < deadline:
        code, _doc, _h = _post(srv.port, f"/score/{name}",
                               {"records": _records(cols)})
        if code == 200:
            return code
        time.sleep(0.1)
    return code


def test_coresident_http_charge_is_fit_or_fail(servers):
    """tests/test_zoo.py's fit-or-fail case through `/admin/coresident/*`
    (the plane `HttpGrant` posts to): a charge one byte past the free
    budget is a 409 with the deficit, evicts no serving tenant, and the
    free budget itself fits."""
    js, ps, _root, _cols = servers
    got = []
    for srv in (js, ps):
        code, grant, _h = _grant(srv, "admit", {"meta": {"algo": "nn"}})
        assert code == 200 and grant["freeBytes"] > 0
        over = _grant(srv, "charge", {"bytes": grant["freeBytes"] + 1})
        states = {n: t["state"]
                  for n, t in _zoo_health(srv)["tenants"].items()}
        fits = _grant(srv, "charge", {"bytes": grant["freeBytes"]})
        back = _grant(srv, "charge", {"bytes": -1024})
        got.append((sorted(grant), over[0], over[1]["deficit"], states,
                    fits[:2], back[:2]))
    (jkeys, jover, jdef, jstates, jfits, jback), \
        (pkeys, pover, pdef, pstates, pfits, pback) = got
    assert pkeys == jkeys
    assert pover == jover == 409 and pdef >= 1 and jdef >= 1
    assert pstates == jstates
    assert pstates["a"] == pstates["b"] == "resident"
    assert pfits[0] == jfits[0] == 200
    assert pback == jback == (200, {"charged": -1024})


def test_coresident_http_serving_pressure_evicts_background_first(
        servers):
    """A cold set loading under the budget evicts the charged trainer
    first (reason pressure_background), and the next heartbeat says so."""
    js, ps, _root, cols = servers
    got = []
    for srv, obs in ((js, jobs), (ps, pobs)):
        _code, grant, _h = _grant(srv, "admit", {"meta": {"stages": 2}})
        assert _grant(srv, "charge",
                      {"bytes": grant["freeBytes"]})[0] == 200
        quiet = _grant(srv, "heartbeat", {"epoch": 3})[1]
        answered = _score_until_200(srv, "c", cols)
        flagged = _grant(srv, "heartbeat", {"epoch": 4})[1]
        counters = _evictions(obs.registry().snapshot()["counters"])
        got.append((quiet, answered, flagged,
                    counters.get('serve.zoo.evictions{reason='
                                 '"pressure_background",'
                                 'tenant="retrain"}')))
    assert got[0] == got[1] == ({"evicted": False}, 200,
                                {"evicted": True}, 1)


def test_coresident_http_evicted_record_survives_until_final_release(
        servers):
    js, ps, _root, _cols = servers
    snaps = []
    for srv in (js, ps):
        code, grant, _h = _grant(srv, "admit", {"meta": {"algo": "nn",
                                                         "stages": 2}})
        assert code == 200
        # within each side's own priced budget
        assert _grant(srv, "charge",
                      {"bytes": grant["freeBytes"] // 2})[0] == 200
        _grant(srv, "heartbeat", {"epoch": 5})
        code, _doc, _h = _post(srv.port, "/admin/evict", {"set": "retrain"})
        assert code == 200
        snaps.append(_zoo_health(srv)["background"]["retrain"])
        # a flagged tenant's charge is refused until it re-admits
        assert _grant(srv, "charge", {"bytes": 1024})[0] == 409
        assert _grant(srv, "release", {"final": False})[1] == {
            "released": "retrain"}
        assert "retrain" in _zoo_health(srv)["background"]
        _grant(srv, "admit", {})
        assert _grant(srv, "heartbeat", {"epoch": 6})[1] == {
            "evicted": False}
        _grant(srv, "release", {"final": True})
        assert "retrain" not in (_zoo_health(srv).get("background") or {})
    assert set(snaps[0]) == set(snaps[1])
    for key in ("evictRequested", "evictions", "epoch", "stages"):
        assert snaps[1][key] == snaps[0][key]
    assert snaps[1]["evictRequested"] and snaps[1]["evictions"] == 1
    assert snaps[1]["epoch"] == 5 and snaps[1]["stages"] == 2


def test_coresident_http_refusals(servers):
    """A serving tenant's name is refused (409), an unknown tenant or
    action is a 404, a body that is not JSON a 400 — on both servers."""
    js, ps, _root, _cols = servers
    got = []
    for srv in (js, ps):
        clash = _post(srv.port, "/admin/coresident/admit", {"tenant": "a"})
        unknown = _post(srv.port, "/admin/coresident/charge",
                        {"tenant": "nobody", "bytes": 1})
        action = _grant(srv, "bogus", {})
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/admin/coresident/admit",
            b"{not json", {"Content-Type": "application/json"})
        try:
            urllib.request.urlopen(req, timeout=60)
            bad = 200
        except urllib.error.HTTPError as e:
            bad = e.code
        got.append((clash[0], "serving tenant" in clash[1]["error"],
                    unknown[0], action[0], "bogus" in action[1]["error"],
                    bad))
    assert got[0] == got[1] == (409, True, 404, 404, True, 400)

"""Chaos soak of the port (counterpart of tests/test_chaos_fleet.py): two
real `python -m shifu_tpu_torch serve --device cpu` processes on one
model set, race sanitizer armed, one SIGKILLed around a fleet-atomic
promotion (`shifu_tpu_torch/loop/promote.py` fleet mode).

The satellite acceptance: the round ABORTS with every survivor rolled
back to active (a half-promoted fleet is impossible), the survivor
stays `ok`-serving and reports the dead peer's lease expiry within
2 x TTL, the expiry is counted, and a RE-RUN promote (now fencing only
the survivor) succeeds — manifests sha-consistent throughout.

The victim is SIGKILLed while its lease is still live, immediately
before the coordinator prepares the round — from the protocol's view
the death is mid-round (the prepare fences the fresh lease, the ack
never comes, the deadline aborts). Killing after the ack instead would
legitimately commit (a dead-but-acked peer restarts into the new models
dir), so this is the timing that must prove the abort path, and it is
deterministic."""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.request

import numpy as np

TTL_MS = 1500


def _http(url, timeout=10):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read().decode())


def _write_model_set(models_dir, seed=0, bias=0.0):
    from shifu_tpu_torch.models.nn import NNModelSpec, init_params

    os.makedirs(models_dir, exist_ok=True)
    cols = [f"c{i}" for i in range(4)]
    sizes = [len(cols), 3, 1]
    specs = [{"name": c, "kind": "value", "outNames": [c],
              "mean": 0.0, "std": 1.0, "fill": 0.0, "zscore": True}
             for c in cols]
    params = init_params(sizes, seed=seed)
    if bias:
        params[-1]["b"] = np.asarray(params[-1]["b"]) + bias
    NNModelSpec(layer_sizes=sizes, activations=["tanh"],
                input_columns=cols, norm_specs=specs, params=params,
                ).save(os.path.join(models_dir, "model0.nn"))
    return cols


def _spawn_server(root):
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "shifu_tpu_torch", "serve", "--port", "0",
         "--replicas", "1", "--device", "cpu",
         f"-Dshifu.lease.ttlMs={TTL_MS}",
         "-Dshifu.sanitize=race"],
        cwd=root, env=env, stdout=subprocess.PIPE,
        stderr=open(os.path.join(root, f"peer-{time.time_ns()}.err"), "w"),
        text=True)
    line = ""
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if "listening on" in line:
            break
        if proc.poll() is not None:
            raise AssertionError(f"server died at startup: {line!r}")
    port = int(line.split(":")[-1].split()[0])
    return proc, port


def test_sigkill_mid_promotion_never_half_promotes(tmp_path):
    from shifu_tpu_torch.loop.promote import run_promote
    from shifu_tpu_torch.resilience import lease

    root = str(tmp_path)
    _write_model_set(os.path.join(root, "models"), seed=0)
    _write_model_set(os.path.join(root, "models.candidate"), seed=0,
                     bias=1e-3)
    victim = survivor = None
    try:
        victim, victim_port = _spawn_server(root)
        survivor, survivor_port = _spawn_server(root)
        # both processes hold live leases and see each other
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            h = _http(f"http://127.0.0.1:{survivor_port}/healthz")
            if (h.get("peers", {}).get("liveProcesses") == 2
                    and not h["peers"]["expiredProcesses"]):
                break
            time.sleep(0.1)
        else:
            raise AssertionError(f"peers never met: {h.get('peers')}")
        old_sha = h["sha"]
        assert len(lease.scan(root)) == 2

        # SIGKILL the victim: its lease stays live (renewed moments
        # ago), so the promote below fences a corpse — the ack never
        # comes and the round must abort with the survivor rolled back
        os.kill(victim.pid, signal.SIGKILL)
        victim.wait(10)
        rc = run_promote(root, os.path.join(root, "models.candidate"),
                         require_drift=False)
        assert rc == 1  # held: the round aborted

        # promote manifest: fleet mode, aborted round, sha-consistent
        # (the coordinator also leaves promote-<seq>.traces.json beside
        # the manifest — the round's trace spans, not a manifest)
        promotes = sorted(
            p for p in os.listdir(os.path.join(root, ".shifu", "runs"))
            if p.startswith("promote-")
            and not p.endswith(".traces.json"))
        m = json.load(open(os.path.join(root, ".shifu", "runs",
                                        promotes[-1])))["promote"]
        assert m["mode"] == "fleet"
        assert not m["decision"]["promote"]
        assert not m["round"]["committed"]
        assert "no ack" in m["round"]["reason"]

        # the survivor is NOT half-promoted: still serving the old sha,
        # still ok-scoring, its staged candidate rolled back
        h = _http(f"http://127.0.0.1:{survivor_port}/healthz")
        assert h["sha"] == old_sha
        # ...and within 2 x TTL it reports the dead peer's expiry as a
        # degrade reason, with the expiry counted on /metrics
        deadline = time.monotonic() + 2 * TTL_MS / 1000.0 + 5
        while time.monotonic() < deadline:
            h = _http(f"http://127.0.0.1:{survivor_port}/healthz")
            if h["peers"]["expiredProcesses"] == 1:
                break
            time.sleep(0.1)
        assert h["peers"]["expiredProcesses"] == 1, h["peers"]
        assert h["status"] == "degraded"
        assert "lease" in h["reason"] and "expired" in h["reason"]
        metrics = urllib.request.urlopen(
            f"http://127.0.0.1:{survivor_port}/metrics",
            timeout=10).read().decode()
        assert "peer_lease_expired_total 1" in metrics
        # the rollback: the survivor's verdict poll runs on its
        # heartbeat thread, so under load the unstage can land a few
        # beats after the abort record — poll for it
        deadline = time.monotonic() + 30
        while ("serve_swap_unstaged_total" not in metrics
               and time.monotonic() < deadline):
            time.sleep(0.1)
            metrics = urllib.request.urlopen(
                f"http://127.0.0.1:{survivor_port}/metrics",
                timeout=10).read().decode()
        assert "serve_swap_unstaged_total" in metrics  # rolled back

        # re-run: the corpse's lease has expired out of the fence set,
        # the survivor acks, the round commits, the dir swap lands
        rc = run_promote(root, os.path.join(root, "models.candidate"),
                         require_drift=False)
        assert rc == 0
        deadline = time.monotonic() + 30
        new_sha = old_sha
        while time.monotonic() < deadline:
            h = _http(f"http://127.0.0.1:{survivor_port}/healthz")
            new_sha = h["sha"]
            if new_sha != old_sha:
                break
            time.sleep(0.1)
        assert new_sha != old_sha
        promotes = sorted(
            p for p in os.listdir(os.path.join(root, ".shifu", "runs"))
            if p.startswith("promote-")
            and not p.endswith(".traces.json"))
        m2 = json.load(open(os.path.join(root, ".shifu", "runs",
                                         promotes[-1])))["promote"]
        assert m2["round"]["committed"]
        assert m2["swap"]["mode"] == "fleet"
        # the on-disk models dir now IS the promoted candidate: a
        # restarted process loads the same sha the survivor serves
        from shifu_tpu_torch.loop.promote import _models_sha

        assert _models_sha(os.path.join(root, "models")) == new_sha

        # clean shutdown: the survivor's manifest carries a clean race
        # verdict (all new lease/peers/breaker locks are tracked) and
        # its lease is RELEASED, not expired
        survivor.send_signal(signal.SIGTERM)
        survivor.wait(60)
        survivor = None
        serve_manifests = sorted(
            p for p in os.listdir(os.path.join(root, ".shifu", "runs"))
            if p.startswith("serve-") and p.endswith(".json")
            and ".traces" not in p)
        sm = json.load(open(os.path.join(root, ".shifu", "runs",
                                         serve_manifests[-1])))
        race = sm["sanitizer"]["race"]
        assert race["armed"] and race["inversions"] == 0, race
        assert race["guardViolations"] == 0, race
        assert sm["peers"]["enabled"]
        live = [p for p in lease.scan(root) if not p["expired"]]
        assert live == []
    finally:
        for proc in (victim, survivor):
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait(10)

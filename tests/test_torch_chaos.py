"""Chaos parity of the port (counterpart of `tests/test_chaos_parity.py`):
every resumable streamed path, stopped mid-stream by the deterministic
fault injector (`-Dshifu.faults`, `resilience/faults.py`) and resumed,
writes the bytes of an unbroken run, on the CPU:

  * stats (a kill in pass 1 and in pass 2), norm and eval under
    `preempt@chunk=N`, then `--resume`: ColumnConfig.json, NormalizedData
    and CleanedData, the score file byte-identical;
  * the streamed NN and WDL trainers under `preempt@epoch=N`, then
    resume: weights bit-identical;
  * one host of a 2-host stats fleet killed before its barrier, then the
    fleet resumed: ColumnConfig.json byte-identical to one host's;
  * a SIGTERM sent to a `shifu train` subprocess, then `--resume`: the
    model file byte-identical to an unbroken run's;
  * stats under transient `io` faults: retried, byte-identical;
  * serving under `device_dead@replica=0` over 2 replicas: every request
    answered with the clean scores, replica 0's breaker open.
"""

import contextlib
import json
import os
import shutil
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from shifu_tpu_torch.data.pipeline import HostPlan  # noqa: E402
from shifu_tpu_torch.norm.dataset import (write_codes,  # noqa: E402
                                          write_normalized)
from shifu_tpu_torch.processor.evaluate import EvalProcessor  # noqa: E402
from shifu_tpu_torch.processor.init import InitProcessor  # noqa: E402
from shifu_tpu_torch.processor.norm import NormProcessor  # noqa: E402
from shifu_tpu_torch.processor.stats import StatsProcessor  # noqa: E402
from shifu_tpu_torch.processor.train import TrainProcessor  # noqa: E402
from shifu_tpu_torch.resilience import checkpoint as ckpt_mod  # noqa: E402
from shifu_tpu_torch.resilience import faults, retry  # noqa: E402
from shifu_tpu_torch.resilience.faults import (FaultPlan,  # noqa: E402
                                               PreemptionError)
from shifu_tpu_torch.serve.fleet import ReplicaFleet  # noqa: E402
from shifu_tpu_torch.serve.health import BREAKER_OPEN  # noqa: E402
from shifu_tpu_torch.train import nn_trainer as P  # noqa: E402
from shifu_tpu_torch.train import streaming as pstream  # noqa: E402
from shifu_tpu_torch.train import streaming_wdl as pswdl  # noqa: E402
from shifu_tpu_torch.train import wdl_trainer as PW  # noqa: E402
from tests.test_torch_hosts import (STREAM, make_host_set,  # noqa: E402
                                    props, run_hosts)
from tests.test_torch_nn_trainer import make_xor_like  # noqa: E402
from tests.test_torch_serve import records, write_model_set  # noqa: E402
from tests.test_torch_wdl import VOCAB  # noqa: E402
from tests.test_torch_wdl import _data as wdl_data  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHAOS = {**STREAM, "shifu.ckpt.everyChunks": "1"}
NORM_DIRS = (os.path.join("tmp", "norm", "NormalizedData"),
             os.path.join("tmp", "norm", "CleanedData"))


def _bytes(root, rel):
    with open(os.path.join(root, rel), "rb") as fh:
        return fh.read()


def _tree(d):
    return {f: _bytes(d, f) for f in sorted(os.listdir(d))}


def _copy(src, dst):
    shutil.copytree(src, dst)
    return dst


@contextlib.contextmanager
def resumed():
    with props(**{"shifu.resume": "true"}):
        yield


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    """The integral set (12 chunks of 100 rows), RF small, after init;
    `stats` and `norm` roots after the unbroken streamed steps, `model`
    after a train."""
    d = tmp_path_factory.mktemp("chaos")
    init = make_host_set(str(d / "init"))
    path = os.path.join(init, "ModelConfig.json")
    mc = json.load(open(path))
    mc["train"]["params"].update(TreeNum=3, MaxDepth=4)
    json.dump(mc, open(path, "w"), indent=2)
    with props(**CHAOS):
        assert InitProcessor(init, device="cpu").run() == 0
        stats = _copy(init, str(d / "stats"))
        assert StatsProcessor(stats, device="cpu").run() == 0
        norm = _copy(stats, str(d / "norm"))
        assert NormProcessor(norm, device="cpu").run() == 0
        model = _copy(norm, str(d / "model"))
        assert TrainProcessor(model, device="cpu").run() == 0
    return dict(init=init, stats=stats, norm=norm, model=model)


# ---- stats, norm, eval --------------------------------------------------------

@pytest.mark.parametrize("at, label", [(4, "pass1"), (16, "pass2")])
def test_stats_preempt_resume_bit_identical(base, tmp_path, at, label):
    """12 chunks a pass: event 4 dies in pass 1, event 16 in pass 2."""
    root = _copy(base["init"], str(tmp_path / label))
    faults.reset_counters()
    with props(**CHAOS):
        with faults.activate(FaultPlan.parse(f"preempt@chunk={at}")):
            with pytest.raises(PreemptionError):
                StatsProcessor(root, device="cpu").run()
        names = {e["name"] for e in ckpt_mod.list_resumable(root)}
        assert {"stats-stream-shared",
                "stats-stream-shard00000-a"} & names, names
        with resumed():
            assert StatsProcessor(root, device="cpu").run() == 0
    assert _bytes(root, "ColumnConfig.json") == \
        _bytes(base["stats"], "ColumnConfig.json")
    assert ckpt_mod.list_resumable(root) == []
    assert faults.counters["fault.injected"] == {"preempt": 1}
    assert faults.counters["fault.survived"] == {"preempt": 1}


def test_norm_preempt_resume_bit_identical(base, tmp_path):
    root = _copy(base["stats"], str(tmp_path / "norm"))
    with props(**CHAOS):
        with faults.activate(FaultPlan.parse("preempt@chunk=3")):
            with pytest.raises(PreemptionError):
                NormProcessor(root, device="cpu").run()
        shared = (ckpt_mod.ckpt_base(root, "norm", "stream") + "-shared"
                  + ckpt_mod.CKPT_SUFFIX)
        assert os.path.isfile(shared)
        with resumed():
            assert NormProcessor(root, device="cpu").run() == 0
        assert not os.path.isfile(shared)
    for d in NORM_DIRS:
        assert _tree(os.path.join(root, d)) == \
            _tree(os.path.join(base["norm"], d)), d


def test_eval_preempt_resume_bit_identical(base, tmp_path):
    root = _copy(base["model"], str(tmp_path / "eval"))
    score = os.path.join("evals", "Eval1", "EvalScore.csv")
    with props(**CHAOS):
        assert EvalProcessor(root, score_name="Eval1",
                             device="cpu").run() == 0
        clean = _bytes(root, score)
        with faults.activate(FaultPlan.parse("preempt@chunk=3")):
            with pytest.raises(PreemptionError):
                EvalProcessor(root, score_name="Eval1", device="cpu").run()
        assert _bytes(root, score) != clean  # the kill landed mid-file
        shared = (ckpt_mod.ckpt_base(root, "eval", "score-Eval1")
                  + "-shared" + ckpt_mod.CKPT_SUFFIX)
        assert os.path.isfile(shared)
        with resumed():
            assert EvalProcessor(root, score_name="Eval1",
                                 device="cpu").run() == 0
        assert not os.path.isfile(shared)
    assert _bytes(root, score) == clean


def test_stats_io_faults_retried_byte_identical(base, tmp_path):
    root = _copy(base["init"], str(tmp_path / "io"))
    faults.reset_counters()
    retry.reset_counters()
    with props(**CHAOS, **{"shifu.faults": "io:p=0.05:seed=7",
                           "shifu.retry.baseMs": "1"}):
        assert StatsProcessor(root, device="cpu").run() == 0
    assert _bytes(root, "ColumnConfig.json") == \
        _bytes(base["stats"], "ColumnConfig.json")
    n = faults.counters["fault.injected"].get("io", 0)
    assert n > 0 and faults.counters["fault.survived"] == {"io": n}
    assert retry.counters["retry.attempts"] == {"io": n}


# ---- the streamed trainers ---------------------------------------------------

def _flat_nn(params):
    return np.concatenate([np.concatenate([p["W"].ravel(), p["b"].ravel()])
                           for p in params])


def test_streamed_nn_preempt_epoch_resume_bit_identical(tmp_path):
    x, t, w = make_xor_like()
    data_dir = str(tmp_path / "NormalizedData")
    write_normalized(data_dir, x, t, w, [f"x{i}" for i in range(x.shape[1])],
                     n_shards=3)

    def cfg(name):
        return P.NNTrainConfig(hidden_nodes=[6], activations=["tanh"],
                               propagation="ADAM", learning_rate=0.02,
                               num_epochs=9, valid_set_rate=0.2, seed=3,
                               checkpoint_every=2,
                               checkpoint_path=str(tmp_path / name))

    clean = pstream.train_nn_streamed(data_dir, cfg("a.npy"), device="cpu")
    state = str(tmp_path / "b.npy") + ".state" + ckpt_mod.CKPT_SUFFIX
    with faults.activate(FaultPlan.parse("preempt@epoch=6")):
        with pytest.raises(PreemptionError):
            pstream.train_nn_streamed(data_dir, cfg("b.npy"), device="cpu")
    assert os.path.isfile(state)  # the epoch-4 snapshot, intact
    np.load(str(tmp_path / "b.npy"))  # the weights file is whole
    got = pstream.train_nn_streamed(data_dir, cfg("b.npy"), resume=True,
                                    device="cpu")
    assert _flat_nn(got.params).tobytes() == _flat_nn(clean.params).tobytes()
    assert (got.iterations, got.valid_error) == \
        (clean.iterations, clean.valid_error)
    assert not os.path.isfile(state)


def test_streamed_wdl_preempt_epoch_resume_bit_identical(tmp_path):
    from shifu_tpu_torch.models.wdl import flatten_wdl

    dense, codes, t, w = wdl_data()
    nd, cd = str(tmp_path / "NormalizedData"), str(tmp_path / "CleanedData")
    write_normalized(nd, dense, t, w, [f"n{i}" for i in range(4)],
                     n_shards=3)
    write_codes(cd, codes, t, w, ["c0", "c1", "c2"], VOCAB, n_shards=3)
    args = (nd, cd, [0, 1, 2, 3], [0, 1, 2], VOCAB)

    def cfg(name):
        return PW.WDLTrainConfig(hidden=[8, 4], activations=["relu", "tanh"],
                                 embed_dim=3, learning_rate=0.05,
                                 num_epochs=8, valid_set_rate=0.2,
                                 checkpoint_every=1,
                                 checkpoint_path=str(tmp_path / name))

    clean = pswdl.train_wdl_streamed(*args, cfg("a.npy"), device="cpu")
    with faults.activate(FaultPlan.parse("preempt@epoch=3")):
        with pytest.raises(PreemptionError):
            pswdl.train_wdl_streamed(*args, cfg("b.npy"), device="cpu")
    got = pswdl.train_wdl_streamed(*args, cfg("b.npy"), resume=True,
                                   device="cpu")
    assert flatten_wdl(got.params).tobytes() == \
        flatten_wdl(clean.params).tobytes()
    assert (got.iterations, got.valid_error) == \
        (clean.iterations, clean.valid_error) == (8, clean.valid_error)


# ---- kill one host of a fleet --------------------------------------------------

def test_multi_host_kill_one_host_resume_byte_identical(base, tmp_path):
    root = _copy(base["init"], str(tmp_path / "fleet"))
    with props(**CHAOS):
        # host 1 runs alone and dies on its 3rd chunk: mid pass 1, before
        # it publishes (it owns 6 chunks)
        with faults.activate(FaultPlan.parse("preempt@chunk=3")):
            with pytest.raises(PreemptionError):
                StatsProcessor(root, device="cpu",
                               host_plan=HostPlan(2, 1)).run()
        names = {e["name"] for e in ckpt_mod.list_resumable(root)}
        assert "stats-stream-h001-shared" in names, sorted(names)
        assert not any(n.startswith("stats-stream-h000") for n in names)
        assert not any(n.startswith("stats-stream-s") for n in names)
        # the fleet resumes: host 1 from its cursors, host 0 fresh
        plans = [HostPlan(2, h) for h in range(2)]
        with resumed():
            run_hosts(lambda h: StatsProcessor(
                root, device="cpu", host_plan=plans[h]).run())
    assert _bytes(root, "ColumnConfig.json") == \
        _bytes(base["stats"], "ColumnConfig.json")
    assert ckpt_mod.list_resumable(root) == []
    # host 1 re-folded only the chunks past its snapshot in pass 1
    assert plans[0].counters["host.chunks"]["stats.pass1"] == 6
    assert plans[1].counters["host.chunks"]["stats.pass1"] == 4


# ---- SIGTERM to a `shifu train` subprocess -------------------------------------

def _nn_set(root):
    with props(**{"shifu.ingest.chunkRows": "100"}):
        make_host_set(root, n_rows=400, algorithm="NN")
        path = os.path.join(root, "ModelConfig.json")
        mc = json.load(open(path))
        mc["train"]["numTrainEpochs"] = 600
        mc["train"]["epochsPerIteration"] = 2
        mc["train"]["params"]["NumHiddenNodes"] = [4]
        mc["train"]["params"]["ActivationFunc"] = ["tanh"]
        json.dump(mc, open(path, "w"), indent=2)
        for step in (InitProcessor, StatsProcessor, NormProcessor):
            assert step(root, device="cpu").run() == 0
    return root


def _train(root, *extra, wait=True):
    cmd = [sys.executable, "-m", "shifu_tpu_torch", "train", "--device",
           "cpu", "-Dshifu.train.forceStreaming=true", *extra]
    env = dict(os.environ, PYTHONPATH=REPO)
    if wait:
        return subprocess.run(cmd, cwd=root, env=env, timeout=600,
                              stdout=subprocess.DEVNULL,
                              stderr=subprocess.DEVNULL).returncode
    return subprocess.Popen(cmd, cwd=root, env=env,
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)


def test_sigterm_mid_train_subprocess_resume_byte_identical(tmp_path):
    killed = _nn_set(str(tmp_path / "killed"))
    ref = _copy(killed, str(tmp_path / "ref"))
    state = os.path.join(killed, "tmp", "train", "checkpoint_0",
                         "weights.npy.state" + ckpt_mod.CKPT_SUFFIX)
    proc = _train(killed, wait=False)
    try:
        deadline = time.time() + 120
        while not os.path.isfile(state):
            assert proc.poll() is None, \
                "train finished before the SIGTERM could land"
            assert time.time() < deadline, "no checkpoint appeared"
            time.sleep(0.02)
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert rc == 1  # PreemptionError: the CLI's clean failure
    assert os.path.isfile(state)  # the snapshot the kill left is whole
    assert any(e["name"] == "train-checkpoint_0"
               for e in ckpt_mod.list_resumable(killed))
    assert _train(killed, "--resume") == 0
    assert _train(ref) == 0
    assert _bytes(killed, os.path.join("models", "model0.nn")) == \
        _bytes(ref, os.path.join("models", "model0.nn"))


# ---- serving ---------------------------------------------------------------

def test_device_dead_replica_fails_over_with_clean_scores(tmp_path):
    models = os.path.join(write_model_set(str(tmp_path)), "models")
    fleet = ReplicaFleet.build(models, n_replicas=2, device="cpu",
                               max_batch_rows=64, max_wait_ms=1)
    faults.reset_counters()
    try:
        recs = records(5)
        want = fleet.replicas[1].registry.score_records(recs)
        with faults.activate(FaultPlan.parse("device_dead@replica=0")):
            for _ in range(8):
                got = fleet.score_batch(recs, timeout=30)
                np.testing.assert_array_equal(got.model_scores,
                                              want.model_scores)
        assert fleet.replicas[0].breaker.state == BREAKER_OPEN
        assert fleet.replicas[1].breaker.state != BREAKER_OPEN
        assert fleet.failovers >= 1
        assert faults.counters["fault.injected"].get(
            "device_dead@replica=0", 0) >= 1
        assert not any(k.endswith("replica=1")
                       for k in faults.counters["fault.injected"])
    finally:
        fleet.close(10)

"""The port's `shifu retrain` (`shifu_tpu_torch/processor/retrain.py`)
against the JAX package's `tests/test_loop.py` `TestRetrain` and its
`shifu_tpu/processor/retrain.py`, on the CPU.

Each JAX case has its counterpart here under the same name, on model
sets the port's own steps prepared (`init`, `stats`, `norm`, `train` on
device="cpu"): the parent check, the source exclusivity, the NN warm
start with its provenance, the GBT append that keeps the parent's trees
bit for bit, the traffic log round trip through two serve processes,
the chaos parity (a retrain killed mid-stream by a `resilience/faults.py`
clause, then `--resume`, is bit-identical to an unbroken one) and the
`loop` section's rejection. The retrain manifests have the JAX ones'
keys, section for section (the JAX package retrains a set its own steps
prepared). On top: `--coresident` (a background ledger tenant, K=1 bit-
identical to the streamed retrain, resumable bit-identically), the
refusals of `--coresident` and `--serve-url`, and the CLI's exit 3 with
the resume hint when a co-resident retrain is evicted past its wait
window.
"""

import glob
import json
import os
import shutil

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from shifu_tpu_torch.utils import environment  # noqa: E402
from tests.helpers import make_binary_dataset, make_model_set  # noqa: E402
from tests.test_torch_config import jax_inline_ingest  # noqa: E402


class _Props:
    """Env-property overrides for one test, restored on exit."""

    def __init__(self, **props):
        self.props = {k.replace("_", "."): v for k, v in props.items()}

    def __enter__(self):
        for k, v in self.props.items():
            environment.set_property(k, v)
        return self

    def __exit__(self, *exc):
        for k in self.props:
            environment.set_property(k, "")


def _counter_delta(before, after, prefix):
    out = {}
    for k, v in after.items():
        if k.startswith(prefix):
            d = v - before.get(k, 0.0)
            if d:
                out[k] = d
    return out


def _snapshot_counters():
    from shifu_tpu_torch import obs

    return dict(obs.registry().snapshot().get("counters", {}))


def _write_mc(root, n_rows, epochs, algorithm, extra_mc):
    make_model_set(root, n_rows=n_rows, seed=7, algorithm=algorithm)
    mcp = os.path.join(root, "ModelConfig.json")
    mc = json.load(open(mcp))
    mc["train"]["numTrainEpochs"] = epochs
    mc["train"]["epochsPerIteration"] = 2
    for k, v in (extra_mc or {}).items():
        mc["train"][k] = v
    json.dump(mc, open(mcp, "w"), indent=2)


def _prep_trained(root, n_rows=300, epochs=12, algorithm="NN",
                  extra_mc=None):
    """A trained model set, every step through the port on the CPU."""
    from shifu_tpu_torch.processor.init import InitProcessor
    from shifu_tpu_torch.processor.norm import NormProcessor
    from shifu_tpu_torch.processor.stats import StatsProcessor
    from shifu_tpu_torch.processor.train import TrainProcessor

    _write_mc(root, n_rows, epochs, algorithm, extra_mc)
    for proc in (InitProcessor, StatsProcessor, NormProcessor,
                 TrainProcessor):
        assert proc(root, device="cpu").run() == 0
    return root


def _jax_prep_trained(root, n_rows=300, epochs=12, algorithm="NN",
                      extra_mc=None):
    from shifu_tpu.processor.init import InitProcessor
    from shifu_tpu.processor.norm import NormProcessor
    from shifu_tpu.processor.stats import StatsProcessor
    from shifu_tpu.processor.train import TrainProcessor

    _write_mc(root, n_rows, epochs, algorithm, extra_mc)
    with jax_inline_ingest():
        for proc in (InitProcessor, StatsProcessor, NormProcessor,
                     TrainProcessor):
            assert proc(root).run() == 0
    return root


def _last_manifest(root, step="retrain"):
    paths = sorted(
        (p for p in glob.glob(os.path.join(root, f".shifu/runs/{step}-*"
                                                 ".json"))
         if not p.endswith(".trace.json")),
        key=lambda p: int(p.rsplit("-", 1)[1].split(".")[0]))
    with open(paths[-1]) as fh:
        return json.load(fh)


def _keys(doc):
    """The nested key structure of a manifest section."""
    if isinstance(doc, dict):
        return {k: _keys(v) for k, v in doc.items()}
    return None


@pytest.fixture(scope="module")
def jax_manifests(tmp_path_factory):
    """The JAX package's retrain manifests ("nn", "gbt") on sets its own
    steps prepared."""
    from shifu_tpu.processor.retrain import RetrainProcessor

    base = tmp_path_factory.mktemp("jax_retrain")
    out = {}
    with jax_inline_ingest():
        nn = _jax_prep_trained(str(base / "nn"), n_rows=260, epochs=6)
        assert RetrainProcessor(nn).run() == 0
        out["nn"] = _last_manifest(nn)
        gbt = _jax_prep_trained(str(base / "gbt"), n_rows=260,
                                algorithm="GBT",
                                extra_mc={"params": {"TreeNum": 8}})
        assert RetrainProcessor(gbt, append_trees=4).run() == 0
        out["gbt"] = _last_manifest(gbt)
    return out


class TestRetrain:
    def test_requires_parent_models(self, tmp_path):
        from shifu_tpu_torch.processor.init import InitProcessor
        from shifu_tpu_torch.processor.retrain import RetrainProcessor
        from shifu_tpu_torch.utils.errors import ShifuError

        root = str(tmp_path / "ms")
        make_model_set(root, n_rows=120)
        assert InitProcessor(root, device="cpu").run() == 0
        with pytest.raises(ShifuError, match="shifu train"):
            RetrainProcessor(root, device="cpu").run()

    def test_from_traffic_and_data_are_mutually_exclusive(self, tmp_path):
        """Both flags name a source; silently preferring one would train
        on data the operator did not ask for — reject up front."""
        from shifu_tpu_torch.processor.retrain import RetrainProcessor
        from shifu_tpu_torch.utils.errors import ShifuError

        root = str(tmp_path / "ms")
        make_model_set(root, n_rows=120)
        with pytest.raises(ShifuError, match="mutually exclusive"):
            RetrainProcessor(root, from_traffic=True, data_path="new.csv",
                             device="cpu")
        with pytest.raises(ShifuError, match="cannot combine"):
            RetrainProcessor(root, traffic_stream="a", data_path="new.csv",
                             device="cpu")
        with pytest.raises(ShifuError, match="--coresident"):
            RetrainProcessor(root, serve_url="http://127.0.0.1:1",
                             device="cpu")

    def test_nn_warm_start_provenance_and_candidate(self, tmp_path,
                                                    jax_manifests):
        from shifu_tpu_torch.processor.retrain import RetrainProcessor
        from shifu_tpu_torch.serve.registry import model_set_sha

        model_set = _prep_trained(str(tmp_path / "ms"), n_rows=260,
                                  epochs=6)
        assert RetrainProcessor(model_set, device="cpu").run() == 0
        cand = os.path.join(model_set, "models.candidate")
        assert os.path.isfile(os.path.join(cand, "model0.nn"))
        m = _last_manifest(model_set)
        rt = m["retrain"]
        assert rt["parent"]["modelSetSha"] == model_set_sha(
            [os.path.join(model_set, "models", "model0.nn")])
        assert rt["candidate"]["modelSetSha"] != rt["parent"]["modelSetSha"]
        assert set(rt["configShas"]) == {"data", "train", "loop"}
        assert rt["source"]["kind"] == "data"
        assert rt["source"]["rows"] > 0
        # originals untouched: retrain normalizes into tmp/retrain
        assert os.path.isdir(os.path.join(model_set, "tmp", "retrain",
                                          "norm", "NormalizedData"))
        assert os.path.isfile(os.path.join(model_set, "models",
                                           "model0.nn"))
        # the JAX manifest's keys, section for section
        assert _keys(rt) == _keys(jax_manifests["nn"]["retrain"])
        assert set(m) == set(jax_manifests["nn"]) - {"jax"} | {"runtime"}

    def test_gbt_appends_parent_trees_bitwise(self, tmp_path,
                                              jax_manifests):
        from shifu_tpu_torch.models.tree import TreeModelSpec
        from shifu_tpu_torch.processor.retrain import RetrainProcessor

        root = _prep_trained(str(tmp_path / "gbt"), n_rows=260,
                             algorithm="GBT",
                             extra_mc={"params": {"TreeNum": 8}})
        parent = TreeModelSpec.load(os.path.join(root, "models",
                                                 "model0.gbt"))
        assert RetrainProcessor(root, append_trees=4,
                                device="cpu").run() == 0
        cand = TreeModelSpec.load(os.path.join(root, "models.candidate",
                                               "model0.gbt"))
        assert len(cand.trees) == len(parent.trees) + 4
        for a, b in zip(cand.trees, parent.trees):
            assert a.weight == b.weight
            for field in ("feature", "left_mask", "leaf_value", "left",
                          "right"):
                x, y = getattr(a, field), getattr(b, field)
                assert (x is None) == (y is None)
                if x is not None:
                    assert x.dtype == y.dtype
                    assert x.tobytes() == y.tobytes()
        rt = _last_manifest(root)["retrain"]
        assert rt["warmStart"]["appendedTrees"] == 4
        assert rt["parent"]["trees"] == len(parent.trees)
        assert _keys(rt) == _keys(jax_manifests["gbt"]["retrain"])

    def test_traffic_log_roundtrip_retrains(self, tmp_path):
        """Serve -> traffic log -> retrain: the log is label-joined (the
        target rides the request conversion as an extra raw column) and
        `shifu retrain --from-traffic` consumes exactly the logged
        chunks."""
        from shifu_tpu_torch.processor.retrain import RetrainProcessor
        from shifu_tpu_torch.serve.server import ScoringServer

        root = _prep_trained(str(tmp_path / "ms"), n_rows=260, epochs=6)
        names, rows, _ = make_binary_dataset(n_rows=120, seed=13)
        writers = set()
        with _Props(shifu_loop_logSample="1.0",
                    shifu_loop_logChunkRows="64"):
            # TWO serve processes in sequence (fresh lease each): the
            # fleet-shared log keeps one chunk family per writer and the
            # retrain below consumes the union
            for start_at in (0, 60):
                server = ScoringServer(root=root, port=0, device="cpu")
                server.start()
                try:
                    writers.add(server.traffic.writer)
                    for start in range(start_at, start_at + 60, 30):
                        recs = [dict(zip(names, r))
                                for r in rows[start:start + 30]]
                        server.scorer.score_batch(recs)
                finally:
                    out = server.shutdown()
                    manifest = (out if isinstance(out, str)
                                else server.manifest_path)
        assert len(writers) == 2 and all(writers)
        m = json.load(open(manifest))
        assert m["traffic"]["chunks"] >= 1
        assert RetrainProcessor(root, from_traffic=True,
                                device="cpu").run() == 0
        src = _last_manifest(root)["retrain"]["source"]
        assert src["kind"] == "traffic"
        assert src["trafficChunks"]
        assert src["rows"] > 0
        # the lineage manifest records the whole fleet's writers
        assert sorted(src["trafficWriters"]) == sorted(writers)
        assert os.path.isfile(os.path.join(root, "models.candidate",
                                           "model0.nn"))

    def test_chaos_parity_resume_bit_identical(self, tmp_path):
        """Acceptance: kill `shifu retrain` mid-stream, `--resume`
        produces weights bit-identical to an uninterrupted retrain."""
        from shifu_tpu_torch.models.nn import NNModelSpec, flatten_params
        from shifu_tpu_torch.processor.retrain import RetrainProcessor
        from shifu_tpu_torch.resilience.checkpoint import list_resumable
        from shifu_tpu_torch.resilience.faults import PreemptionError

        clean = _prep_trained(str(tmp_path / "clean"), n_rows=260,
                              epochs=10)
        chaos = str(tmp_path / "chaos")
        shutil.copytree(clean, chaos)
        with _Props(shifu_train_forceStreaming="true"):
            assert RetrainProcessor(clean, device="cpu").run() == 0
            with _Props(shifu_faults="preempt@epoch=4"):
                with pytest.raises(PreemptionError):
                    RetrainProcessor(chaos, device="cpu").run()
            m = json.load(open(os.path.join(
                chaos, ".shifu/runs/retrain-1.json")))
            assert m["status"] == "failed"
            c = m["metrics"]["counters"]
            assert c.get('fault.injected{seam="preempt"}') == 1.0
            # the retrain trainer checkpoint is listed as resumable
            names = [e["name"] for e in list_resumable(chaos)]
            assert any(n.startswith("retrain-") for n in names), names
            with _Props(shifu_resume="true"):
                assert RetrainProcessor(chaos, device="cpu").run() == 0
        a = flatten_params(NNModelSpec.load(os.path.join(
            clean, "models.candidate", "model0.nn")).params)[0]
        b = flatten_params(NNModelSpec.load(os.path.join(
            chaos, "models.candidate", "model0.nn")).params)[0]
        assert np.array_equal(a, b)

    def test_checkpoint_rejection_names_diverged_section(self, tmp_path):
        """A streamed-train snapshot whose `loop` section (warm-start
        parent) diverged is rejected naming exactly that section."""
        from shifu_tpu_torch.resilience.checkpoint import (
            StreamCheckpoint, sectioned_sha)

        path = str(tmp_path / "t.ckpt.npz")
        sha_a, sec_a = sectioned_sha({
            "train": {"lr": 0.1}, "data": {"rows": 10},
            "loop": {"parentModelSetSha": "aaaa"}})
        StreamCheckpoint(path, sha_a, every=0, sections=sec_a).save(
            3, arrays={"w": np.zeros(2)}, meta={"epoch": 3})
        sha_b, sec_b = sectioned_sha({
            "train": {"lr": 0.1}, "data": {"rows": 10},
            "loop": {"parentModelSetSha": "bbbb"}})
        before = _snapshot_counters()
        ck = StreamCheckpoint(path, sha_b, every=0, sections=sec_b)
        assert ck.load() is None
        d = _counter_delta(before, _snapshot_counters(), "ckpt.rejected")
        assert d.get('ckpt.rejected{reason="config",section="loop"}') \
            == 1.0, d


# ---------------------------------------------------------------------------
# --coresident
# ---------------------------------------------------------------------------


def _candidate_flat(root):
    from shifu_tpu_torch.models.nn import NNModelSpec, flatten_params

    return flatten_params(NNModelSpec.load(os.path.join(
        root, "models.candidate", "model0.nn")).params)[0]


def test_coresident_retrain_equals_streamed_and_resumes(tmp_path):
    """`retrain --coresident` at K=1 is the streamed retrain, bit for
    bit; its manifest names the tenant and the stage shape; killed at an
    epoch boundary it leaves one co-resident family, and `--resume`
    finishes bit-identical."""
    from shifu_tpu_torch.processor.retrain import RetrainProcessor
    from shifu_tpu_torch.resilience.checkpoint import list_resumable
    from shifu_tpu_torch.resilience.faults import PreemptionError

    streamed = _prep_trained(str(tmp_path / "s"), n_rows=260, epochs=8)
    co = str(tmp_path / "c")
    shutil.copytree(streamed, co)
    chaos = str(tmp_path / "k")
    shutil.copytree(streamed, chaos)
    with _Props(shifu_train_forceStreaming="true"):
        assert RetrainProcessor(streamed, device="cpu").run() == 0
    assert RetrainProcessor(co, coresident=True, device="cpu").run() == 0
    np.testing.assert_array_equal(_candidate_flat(co),
                                  _candidate_flat(streamed))
    rt = _last_manifest(co)["retrain"]
    assert rt["coresident"] == {"tenant": "retrain", "stages": None,
                                "microbatches": 1, "replicas": 1,
                                "serveUrl": None}
    with _Props(shifu_coresident_stages="2",
                shifu_coresident_microbatches="2"):
        with _Props(shifu_faults="preempt@epoch=3"):
            with pytest.raises(PreemptionError):
                RetrainProcessor(chaos, coresident=True,
                                 device="cpu").run()
        fams = [e for e in list_resumable(chaos)
                if e.get("family") == "coresident"]
        assert len(fams) == 1 and fams[0]["stages"] == 2, fams
        with _Props(shifu_resume="true"):
            assert RetrainProcessor(chaos, coresident=True,
                                    device="cpu").run() == 0
    # K=2/M=2 is bit-identical to K=1 (Rprop), resumed or not
    np.testing.assert_array_equal(_candidate_flat(chaos),
                                  _candidate_flat(co))
    assert not [e for e in list_resumable(chaos)
                if e.get("family") == "coresident"]


def test_coresident_refused_for_trees(tmp_path):
    from shifu_tpu_torch.processor.retrain import RetrainProcessor
    from shifu_tpu_torch.utils.errors import ShifuError

    from shifu_tpu_torch.processor.init import InitProcessor

    root = str(tmp_path / "gbt")
    _write_mc(root, 120, 4, "GBT", None)
    assert InitProcessor(root, device="cpu").run() == 0
    with pytest.raises(ShifuError, match="--coresident applies"):
        RetrainProcessor(root, coresident=True, device="cpu").run()


def test_cli_evicted_exits_3_with_resume_hint(tmp_path, monkeypatch,
                                              capsys):
    from shifu_tpu_torch import cli
    from shifu_tpu_torch.coresident import EvictedError
    from shifu_tpu_torch.processor.retrain import RetrainProcessor

    def evicted(self):
        raise EvictedError("retrain", 4)

    monkeypatch.setattr(RetrainProcessor, "run", evicted)
    monkeypatch.chdir(tmp_path)
    assert cli.main(["retrain", "--coresident", "--device", "cpu"]) == 3
    out = capsys.readouterr().out
    assert "evicted by serving pressure at epoch 4" in out
    assert "shifu retrain --coresident --resume" in out

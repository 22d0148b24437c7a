"""Package rules of the port: no JAX, device resolution, shared formats."""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from shifu_tpu_torch.norm import dataset as pds  # noqa: E402
from shifu_tpu_torch.train import tree_trainer as ptt  # noqa: E402
from shifu_tpu_torch.utils import platform  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = [
    "shifu_tpu_torch", "shifu_tpu_torch.__main__", "shifu_tpu_torch.cli",
    "shifu_tpu_torch.analysis", "shifu_tpu_torch.analysis.racetrack",
    "shifu_tpu_torch.analysis.sanitize",
    "shifu_tpu_torch.obs", "shifu_tpu_torch.obs.costmodel",
    "shifu_tpu_torch.obs.ledger", "shifu_tpu_torch.obs.metrics",
    "shifu_tpu_torch.obs.profile", "shifu_tpu_torch.obs.reqtrace",
    "shifu_tpu_torch.obs.timeseries", "shifu_tpu_torch.obs.top",
    "shifu_tpu_torch.obs.tracing", "shifu_tpu_torch.ops.hist_bounds",
    "shifu_tpu_torch.utils.timing",
    "shifu_tpu_torch.parallel.hostsync",
    "shifu_tpu_torch.resilience.faults", "shifu_tpu_torch.resilience.retry",
    "shifu_tpu_torch.config", "shifu_tpu_torch.config.column_config",
    "shifu_tpu_torch.config.inspector", "shifu_tpu_torch.config.jsonbase",
    "shifu_tpu_torch.config.meta", "shifu_tpu_torch.config.model_config",
    "shifu_tpu_torch.compat", "shifu_tpu_torch.compat.adapters",
    "shifu_tpu_torch.compat.egb", "shifu_tpu_torch.compat.encog",
    "shifu_tpu_torch.compat.javaio", "shifu_tpu_torch.compat.treespec",
    "shifu_tpu_torch.compat.wdl",
    "shifu_tpu_torch.convert", "shifu_tpu_torch.data.pipeline",
    "shifu_tpu_torch.data.purify",
    "shifu_tpu_torch.eval.gainchart", "shifu_tpu_torch.eval.metrics",
    "shifu_tpu_torch.eval.multiclass", "shifu_tpu_torch.eval.reasoner",
    "shifu_tpu_torch.eval.scorefile", "shifu_tpu_torch.eval.scorer",
    "shifu_tpu_torch.export.pmml",
    "shifu_tpu_torch.data.reader", "shifu_tpu_torch.data.stream",
    "shifu_tpu_torch.data.tokens", "shifu_tpu_torch.fs.listing",
    "shifu_tpu_torch.fs.pathfinder", "shifu_tpu_torch.models.nn",
    "shifu_tpu_torch.models.tree", "shifu_tpu_torch.models.wdl",
    "shifu_tpu_torch.norm.dataset", "shifu_tpu_torch.norm.normalizer",
    "shifu_tpu_torch.ops.binagg", "shifu_tpu_torch.ops.build",
    "shifu_tpu_torch.ops.hist_kernel", "shifu_tpu_torch.parallel.mesh",
    "shifu_tpu_torch.processor.analysis",
    "shifu_tpu_torch.processor.basic", "shifu_tpu_torch.processor.combo",
    "shifu_tpu_torch.processor.convert",
    "shifu_tpu_torch.processor.create", "shifu_tpu_torch.processor.encode",
    "shifu_tpu_torch.processor.evaluate",
    "shifu_tpu_torch.processor.export", "shifu_tpu_torch.processor.manage",
    "shifu_tpu_torch.processor.testdata",
    "shifu_tpu_torch.processor.init", "shifu_tpu_torch.processor.norm",
    "shifu_tpu_torch.processor.posttrain",
    "shifu_tpu_torch.processor.stats", "shifu_tpu_torch.processor.varsel",
    "shifu_tpu_torch.processor.train",
    "shifu_tpu_torch.processor.train_common",
    "shifu_tpu_torch.processor.train_tree",
    "shifu_tpu_torch.processor.train_wdl",
    "shifu_tpu_torch.resilience.checkpoint", "shifu_tpu_torch.serve",
    "shifu_tpu_torch.serve.batcher", "shifu_tpu_torch.serve.fleet",
    "shifu_tpu_torch.serve.health", "shifu_tpu_torch.serve.queue",
    "shifu_tpu_torch.serve.registry", "shifu_tpu_torch.serve.server",
    "shifu_tpu_torch.serve.wire",
    "shifu_tpu_torch.stats.binning", "shifu_tpu_torch.stats.correlation",
    "shifu_tpu_torch.stats.engine", "shifu_tpu_torch.stats.metrics",
    "shifu_tpu_torch.stats.psi", "shifu_tpu_torch.stats.rebin",
    "shifu_tpu_torch.stats.sketch", "shifu_tpu_torch.train.grid_search",
    "shifu_tpu_torch.train.nn_trainer", "shifu_tpu_torch.train.streaming",
    "shifu_tpu_torch.train.streaming_tree",
    "shifu_tpu_torch.train.streaming_wdl",
    "shifu_tpu_torch.train.tree_trainer", "shifu_tpu_torch.train.updaters",
    "shifu_tpu_torch.train.wdl_trainer",
    "shifu_tpu_torch.utils.environment", "shifu_tpu_torch.utils.errors",
    "shifu_tpu_torch.utils.log", "shifu_tpu_torch.utils.platform",
    "shifu_tpu_torch.varsel.importance", "shifu_tpu_torch.varsel.selector",
]


def test_every_module_is_listed():
    """A new module of the port joins the import check below (empty
    package markers aside)."""
    pkg = os.path.join(REPO, "shifu_tpu_torch")
    found = []
    for dirpath, dirs, files in os.walk(pkg):
        dirs[:] = [d for d in dirs if d != "_build"]  # build outputs
        for f in files:
            path = os.path.join(dirpath, f)
            if not f.endswith(".py") or (f == "__init__.py"
                                         and os.path.getsize(path) == 0):
                continue
            mod = os.path.relpath(path, REPO)[:-3].replace(os.sep, ".")
            found.append(mod.removesuffix(".__init__"))
    assert sorted(set(found) - set(MODULES)) == []


# what the port must never import: the JAX package and JAX, and pandas
# and pyarrow, which the card's machine does not have
FORBIDDEN = ("jax", "shifu_tpu", "pandas", "pyarrow")


def test_chip_smoke_imports_no_jax():
    import ast

    with open(os.path.join(REPO, "chip_smoke.py")) as fh:
        tree = ast.parse(fh.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module]
    bad = [m for m in names if m.split(".")[0] in FORBIDDEN]
    assert bad == []


def test_import_leaves_jax_and_reference_out():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(bad)\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        platform.resolve_device(None)
    codes = np.zeros((10, 2), np.int32)
    with pytest.raises(RuntimeError, match="CUDA"):
        ptt.train_trees(codes, np.zeros(10, np.float32),
                        np.ones(10, np.float32), [3, 3], [False, False],
                        ["a", "b"], ptt.TreeTrainConfig(tree_num=1))
    assert platform.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        platform.resolve_device("cuda:0")


def _cleaned(seed=0, n=700):
    rng = np.random.default_rng(seed)
    slots = [5, 40000, 12]  # one column past int16: int32 code shards
    codes = np.stack([rng.integers(0, s, size=n) for s in slots],
                     1).astype(np.int32)
    tags = (rng.random(n) < 0.3).astype(np.int8)
    w = rng.random(n).astype(np.float32)
    return codes, tags, w, ["a", "b", "c"], slots


@pytest.mark.parametrize("narrow", [True, False])
def test_cleaned_data_crosses_packages(tmp_path, narrow):
    jds = pytest.importorskip("shifu_tpu.norm.dataset")
    codes, tags, w, cols, slots = _cleaned()
    if narrow:  # int16 shards
        slots = [5, 300, 12]
        codes = np.minimum(codes, np.asarray(slots) - 1).astype(np.int32)
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jds.write_codes(str(jdir), codes, tags, w, cols, slots, n_shards=3)
    pds.write_codes(str(pdir), codes, tags, w, cols, slots, n_shards=3)
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(pdir))
    for nm in names:  # the same bytes on disk
        assert (jdir / nm).read_bytes() == (pdir / nm).read_bytes(), nm
    for src in (jdir, pdir):
        jm, jc, jt, jw = jds.load_codes(str(src))
        pm, pc, pt, pw = pds.load_codes(str(src))
        assert jm.to_json() == pm.to_json()
        for a, b in ((jc, pc), (jt, pt), (jw, pw)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(pc, codes)
        assert pds.read_meta(str(src)).extra == {"slots": slots}

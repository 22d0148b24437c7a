"""The port's config, path and environment copies vs the JAX package.

Model sets are made by `tests/helpers` and passed through the JAX init →
stats → norm steps; the port loads their `ModelConfig.json` and
`ColumnConfig.json` and must save the same bytes, and its inspector must
give the same causes for the same faults.

Every JAX step a port test runs as its reference runs under
`jax_inline_ingest()`: the JAX property `shifu.ingest.prefetchChunks=0`
makes the JAX ingest parse on the calling thread (the JAX package's own
docstring, `shifu_tpu/data/pipeline.py` `prefetch_iter`: the identical
pull/transform inline). pandas/pyarrow parsing in that package's
prefetch worker thread has crashed test workers with SIGSEGV.
"""

import contextlib
import os
import shutil

import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

from shifu_tpu.config import inspector as jinspector  # noqa: E402
from shifu_tpu.config import load_column_config_list as jload_cc  # noqa: E402
from shifu_tpu.config.model_config import ModelConfig as JModelConfig  # noqa: E402
from shifu_tpu_torch.config import (  # noqa: E402
    ModelConfig,
    load_column_config_list,
    save_column_config_list,
)
from shifu_tpu_torch.config.inspector import probe  # noqa: E402
from shifu_tpu_torch.fs.pathfinder import PathFinder  # noqa: E402
from shifu_tpu_torch.norm.normalizer import norm_columns  # noqa: E402
from shifu_tpu_torch.utils import environment  # noqa: E402
from tests.helpers import make_model_set, make_multiclass_model_set  # noqa: E402


@contextlib.contextmanager
def jax_inline_ingest():
    """The JAX steps inside parse inline (`prefetchChunks=0`); the
    property is restored afterwards."""
    from shifu_tpu.utils import environment as jenv

    key = "shifu.ingest.prefetchChunks"
    before = jenv.all_properties().get(key)
    jenv.set_property(key, "0")
    try:
        yield
    finally:
        if before is None:
            jenv._props.pop(key, None)
        else:
            jenv.set_property(key, before)


def prepare_model_set(root, kind, rows=600, **params):
    """A model set through the JAX init -> stats -> norm steps. kind:
    'binary' (make_model_set) or 'native' / 'onevsall'
    (make_multiclass_model_set); `params` update train.params, `alg` the
    algorithm."""
    from shifu_tpu.processor.init import InitProcessor
    from shifu_tpu.processor.norm import NormProcessor
    from shifu_tpu.processor.stats import StatsProcessor

    alg = params.pop("alg", "RF")
    if kind == "binary":
        make_model_set(root, n_rows=rows, algorithm=alg)
    else:
        make_multiclass_model_set(root, n_rows=rows, algorithm=alg,
                                  method=kind.upper())
    path = os.path.join(root, "ModelConfig.json")
    mc = JModelConfig.load(path)
    mc.train.params.update(params)
    mc.save(path)
    with jax_inline_ingest():
        for proc in (InitProcessor, StatsProcessor, NormProcessor):
            assert proc(root).run() == 0
    return root


@pytest.fixture(scope="module")
def model_sets(tmp_path_factory):
    base = tmp_path_factory.mktemp("sets")
    return {kind: prepare_model_set(str(base / kind), kind, rows=400,
                                    alg="GBT" if kind == "onevsall" else "RF")
            for kind in ("binary", "native", "onevsall")}


@pytest.mark.parametrize("kind", ["binary", "native", "onevsall"])
def test_configs_round_trip_byte_identical(model_sets, tmp_path, kind):
    root = model_sets[kind]
    mc_src = os.path.join(root, "ModelConfig.json")
    cc_src = os.path.join(root, "ColumnConfig.json")
    mc = ModelConfig.load(mc_src)
    mc.save(str(tmp_path / "mc.json"))
    with open(mc_src, "rb") as a:
        assert a.read() == (tmp_path / "mc.json").read_bytes()
    ccs = load_column_config_list(cc_src)
    save_column_config_list(str(tmp_path / "cc.json"), ccs)
    with open(cc_src, "rb") as a:
        assert a.read() == (tmp_path / "cc.json").read_bytes()
    # what the train step reads agrees with the JAX objects
    jmc = JModelConfig.load(mc_src)
    assert mc.tags() == jmc.tags()
    assert mc.is_multi_classification() == jmc.is_multi_classification()
    assert mc.train.is_one_vs_all() == jmc.train.is_one_vs_all()
    assert mc.train.get_param("treenum") == jmc.train.get_param("TreeNum")
    from shifu_tpu.norm.normalizer import norm_columns as jnorm_columns

    jcols = jnorm_columns(jload_cc(cc_src))
    assert [c.column_name for c in norm_columns(ccs)] == [
        c.column_name for c in jcols]
    assert [c.is_categorical() or c.is_hybrid() for c in norm_columns(ccs)] \
        == [c.is_categorical() or c.is_hybrid() for c in jcols]


@pytest.mark.parametrize("edit,needle", [
    (lambda mc: mc.train.params.update(MaxDepth=25), "MaxDepth"),
    (lambda mc: setattr(mc.train, "bagging_num", 0), "baggingNum"),
    (lambda mc: setattr(mc.basic, "name", ""), "basic.name"),
])
def test_probe_gives_the_jax_causes(model_sets, edit, needle):
    src = os.path.join(model_sets["native"], "ModelConfig.json")
    mc, jmc = ModelConfig.load(src), JModelConfig.load(src)
    edit(mc)
    edit(jmc)
    got = probe(mc, "train", base_dir=model_sets["native"])
    want = jinspector.probe(jmc, "train", base_dir=model_sets["native"])
    assert not got.status and not want.status
    assert got.causes == want.causes
    assert any(needle in c for c in got.causes)
    assert probe(ModelConfig.load(src), "train").status


def test_pathfinder_layout_matches_jax(tmp_path):
    from shifu_tpu.fs.pathfinder import PathFinder as JPathFinder

    a, b = PathFinder(str(tmp_path)), JPathFinder(str(tmp_path))
    for name in ("model_config_path", "column_config_path", "models_dir",
                 "cleaned_data_dir", "train_dir"):
        assert getattr(a, name)() == getattr(b, name)()
    for name in ("checkpoint_dir", "progress_path", "val_error_path"):
        assert getattr(a, name)(3) == getattr(b, name)(3)
    assert a.model_path(2, "rf") == b.model_path(2, "rf")
    d = a.ensure(str(tmp_path / "x" / "y"))
    assert os.path.isdir(d)
    shutil.rmtree(tmp_path / "x")


def test_environment_properties():
    environment.set_property("shifu.test.portKey", "7")
    assert environment.get_property("shifu.test.portKey") == "7"
    assert environment.get_int("shifu.test.portKey", 0) == 7
    environment.set_property("shifu.test.portKey", "")
    assert environment.get_bool("shifu.test.portKey", True) is True

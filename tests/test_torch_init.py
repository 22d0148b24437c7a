"""The port's `shifu init` vs the JAX package's, on the CPU.

Each model set is copied twice; the JAX `InitProcessor` runs on one copy
(ingest inline, `jax_inline_ingest`), the port's
`InitProcessor(device="cpu")` on the other. `ColumnConfig.json` and the
autotype JSON must be byte-identical, the HyperLogLog path past 4,096
distinct values included.
"""

import os
import shutil

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from shifu_tpu.config.model_config import ModelConfig as JModelConfig  # noqa: E402
from shifu_tpu.processor.init import InitProcessor as JInitProcessor  # noqa: E402
from shifu_tpu_torch.processor.init import InitProcessor  # noqa: E402
from shifu_tpu_torch.utils.platform import DeviceUnavailable  # noqa: E402
from tests.helpers import (make_model_set, make_multiclass_model_set,  # noqa: E402
                           write_dataset)
from tests.test_torch_config import jax_inline_ingest  # noqa: E402

ARTIFACTS = ("ColumnConfig.json", os.path.join("tmp", "autotype",
                                               "count_info.json"))


def _edit(root, fn):
    path = os.path.join(root, "ModelConfig.json")
    mc = JModelConfig.load(path)
    fn(mc)
    mc.save(path)


def make_roles_set(root):
    """make_model_set with meta, categorical, force-select/remove files
    and a weight column."""
    make_model_set(root, n_rows=500)
    files = {"meta.names": "num_9\n# a comment\n", "cate.names": "num_8\n",
             "select.names": "ns::num_1\n", "remove.names": "num_2\n\n"}
    for name, text in files.items():
        with open(os.path.join(root, name), "w") as fh:
            fh.write(text)

    def fn(mc):
        mc.data_set.meta_column_name_file = "meta.names"
        mc.data_set.categorical_column_name_file = "cate.names"
        mc.data_set.weight_column_name = "num_0"
        mc.var_select.force_select_column_name_file = "select.names"
        mc.var_select.force_remove_column_name_file = "remove.names"
    _edit(root, fn)
    return root


def make_wide_set(root, n_rows=6000, seed=5, with_header=False):
    """Columns past 4,096 distinct values (the HLL path): a float column,
    a string id, an integer id; a low-cardinality code column that is
    mostly numeric; a weight; the header as the data's first row unless
    `with_header`."""
    rng = np.random.default_rng(seed)
    names = ["label", "x_float", "uid", "int_id", "code", "wt", "unit"]
    y = rng.random(n_rows) < 0.3
    rows = []
    for i in range(n_rows):
        code = str(rng.integers(0, 9)) if rng.random() < 0.93 else "Z"
        rows.append([
            "1" if y[i] else "0",
            "" if rng.random() < 0.02 else f"{rng.normal(y[i], 1.0):.5f}",
            f"u{rng.integers(1 << 40):x}",
            str(int(rng.integers(-10**6, 10**6))),
            code,
            f"{rng.integers(1, 4)}",
            f"m{i % 12:02d}",
        ])
    if not with_header:
        rows.insert(0, names)
    make_model_set(root, n_rows=50)  # a ModelConfig to edit
    data_path, header_path = write_dataset(os.path.join(root, "wide"),
                                           names, rows)

    def fn(mc):
        mc.data_set.data_path = data_path
        mc.data_set.header_path = header_path if with_header else ""
        mc.data_set.target_column_name = "label"
        mc.data_set.pos_tags = ["1"]
        mc.data_set.neg_tags = ["0"]
        mc.data_set.weight_column_name = "wt"
    _edit(root, fn)
    return root


SETS = {
    "binary": lambda root: make_model_set(root, n_rows=600),
    "multiclass": lambda root: make_multiclass_model_set(root, n_rows=700),
    "roles": make_roles_set,
    "wide": make_wide_set,
}


def run_both(src, dst_base):
    """Copies of `src` under `dst_base`/{jax,port}; JAX init on one, the
    port's on the other. Returns the two roots."""
    roots = []
    for side in ("jax", "port"):
        dst = os.path.join(dst_base, side)
        shutil.copytree(src, dst)
        roots.append(dst)
    with jax_inline_ingest():
        assert JInitProcessor(roots[0]).run() == 0
    assert InitProcessor(roots[1], device="cpu").run() == 0
    return roots


@pytest.fixture(scope="module")
def initialized(tmp_path_factory):
    base = tmp_path_factory.mktemp("init_sets")
    out = {}
    for name, make in SETS.items():
        src = str(base / name / "src")
        make(src)
        out[name] = run_both(src, str(base / name))
    return out


@pytest.mark.parametrize("name", list(SETS))
@pytest.mark.parametrize("artifact", ARTIFACTS)
def test_init_byte_identical(initialized, name, artifact):
    jroot, proot = initialized[name]
    with open(os.path.join(jroot, artifact), "rb") as a, \
            open(os.path.join(proot, artifact), "rb") as b:
        assert a.read() == b.read()


def test_wide_set_takes_the_hll_path(initialized):
    import json

    _jroot, proot = initialized["wide"]
    with open(os.path.join(proot, ARTIFACTS[1])) as fh:
        info = json.load(fh)
    assert info["uid"]["distinctCount"] > 4096
    assert info["int_id"]["distinctCount"] > 4096
    assert info["code"]["numericRatio"] < 1.0


def test_header_file_route_byte_identical(tmp_path):
    """The wide set with a header file (the fixture's reads the header
    from the data's first row)."""
    src = make_wide_set(str(tmp_path / "src"), n_rows=300, with_header=True)
    jroot, proot = run_both(src, str(tmp_path))
    for artifact in ARTIFACTS:
        with open(os.path.join(jroot, artifact), "rb") as a, \
                open(os.path.join(proot, artifact), "rb") as b:
            assert a.read() == b.read()


def test_init_device_none_raises_without_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    make_model_set(str(tmp_path), n_rows=50)
    with pytest.raises(DeviceUnavailable):
        InitProcessor(str(tmp_path))

"""The port's `shifu convert` vs the JAX package's, on the CPU.

Models: an NN (bagging 2), a GBT, an RF and a WDL trained by the port on
one prepared set (tests/test_torch_compat.py `trained_sets`). Each mode
runs in both packages on the same file:
* -tozip: the port's JSON holds the JAX JSON's keys with equal values;
  -tobin of the port's JSON gives back the original file byte for byte,
  and so does -tobin of the JAX JSON of an NN; of a tree's or a WDL's
  (which lack fields) the JAX -tobin's bytes. The JAX round trip does
  not give back the original (ROADMAP C.12);
* -toref, -tozipref: the decompressed payloads and zip members equal;
* -toeg: the EG text equal but for its timestamp line;
* -fromref: the reference kind is recognized; a native file is refused;
* the CLI subcommand with the JAX CLI's flags, without a card.
"""

import gzip
import io
import json
import os
import shutil
import zipfile

import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from shifu_tpu.processor.convert import ConvertProcessor as JConvert  # noqa: E402
from shifu_tpu_torch import cli  # noqa: E402
from shifu_tpu_torch.processor.convert import ConvertProcessor  # noqa: E402
from shifu_tpu_torch.utils.errors import ShifuError  # noqa: E402
from tests.test_torch_compat import (_eg_body, model_path,  # noqa: E402
                                     trained_sets)

KINDS = ["nn", "gbt", "rf", "wdl"]


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    return trained_sets(str(tmp_path_factory.mktemp("convert")))


def _both(root, **kw):
    """Run the JAX and the port's ConvertProcessor with the same args."""
    assert JConvert(root, **kw).run() == 0
    kw = dict(kw, output_path=kw["output_path"] + ".port"
              if kw.get("output_path") else None)
    assert ConvertProcessor(root, **kw).run() == 0


@pytest.mark.parametrize("kind", KINDS)
def test_tozip_tobin_round_trip(sets, tmp_path, kind):
    src = model_path(sets[kind], kind)
    jj, pj = str(tmp_path / "j.json"), str(tmp_path / "p.json")
    assert JConvert(to_json=True, input_path=src, output_path=jj).run() == 0
    assert ConvertProcessor(to_json=True, input_path=src,
                            output_path=pj).run() == 0
    want, got = json.load(open(jj)), json.load(open(pj))
    assert {k: got[k] for k in want} == want
    # the port's JSON converts back to the original bytes
    out = str(tmp_path / f"back.{kind}")
    assert ConvertProcessor(to_json=False, input_path=pj,
                            output_path=out).run() == 0
    original = open(src, "rb").read()
    assert open(out, "rb").read() == original
    # the JAX JSON: an NN's holds every field (its header), so the port
    # gives back the original; a tree's or a WDL's lacks some, so the
    # port fills them as the JAX -tobin does
    jout, pout = str(tmp_path / f"j.{kind}"), str(tmp_path / f"p.{kind}")
    assert JConvert(to_json=False, input_path=jj, output_path=jout).run() == 0
    assert ConvertProcessor(to_json=False, input_path=jj,
                            output_path=pout).run() == 0
    assert open(pout, "rb").read() == (original if kind == "nn"
                                       else open(jout, "rb").read())
    # the JAX round trip does not give back the original (ROADMAP C.12:
    # its -tobin drops the errors, an NN's cutoff and class tags, a
    # tree set's F_0 and class count, a WDL's norm type and cutoff)
    assert open(jout, "rb").read() != original


def _final_select(root):
    """A copy of the set with the model's columns final-selected, as
    after varsel (the JAX EGB export needs it, ROADMAP C.13)."""
    from shifu_tpu_torch.models.nn import NNModelSpec

    names = {cd["name"] for cd in NNModelSpec.load(
        model_path(root, "nn")).norm_specs}
    path = os.path.join(root, "ColumnConfig.json")
    ccs = json.load(open(path))
    for cc in ccs:
        cc["finalSelect"] = cc["columnName"] in names
    with open(path, "w") as fh:
        json.dump(ccs, fh, indent=2)


@pytest.mark.parametrize("kind", KINDS)
def test_toref_matches_jax(sets, tmp_path, kind):
    root = str(tmp_path / "set")
    shutil.copytree(sets[kind], root)
    if kind == "nn":
        _final_select(root)
    src = model_path(root, kind)
    out = str(tmp_path / "ref")
    _both(root, input_path=src, output_path=out, mode="toref")
    got, want = open(out + ".port", "rb").read(), open(out, "rb").read()
    assert got[:2] == b"\x1f\x8b"
    assert gzip.decompress(got) == gzip.decompress(want)


def test_toeg_tozipref_fromref(sets, tmp_path):
    out = str(tmp_path / "eg")
    _both(sets["nn"], input_path=model_path(sets["nn"], "nn"),
          output_path=out, mode="toeg")
    assert _eg_body(open(out + ".port", "rb").read()) == _eg_body(
        open(out, "rb").read())
    for kind in ("gbt", "rf"):
        out = str(tmp_path / f"{kind}.zip")
        _both(sets[kind], input_path=model_path(sets[kind], kind),
              output_path=out, mode="tozipref")
        pz, jz = (zipfile.ZipFile(io.BytesIO(open(p, "rb").read()))
                  for p in (out + ".port", out))
        assert pz.namelist() == jz.namelist()
        for name in pz.namelist():
            assert pz.read(name) == jz.read(name)
        # a reference file is recognized; a native one is refused
        assert ConvertProcessor(input_path=out, mode="fromref").run() == 0
    with pytest.raises(ShifuError, match="not a reference-format"):
        ConvertProcessor(input_path=model_path(sets["rf"], "rf"),
                         mode="fromref").run()
    with pytest.raises(ShifuError, match="input model path"):
        ConvertProcessor().run()


def test_cli_convert_without_a_card(sets, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(sets["wdl"])
    src = model_path(sets["wdl"], "wdl")
    js = str(tmp_path / "m.json")
    back = str(tmp_path / "m.wdl")
    assert cli.main(["convert", "-tozip", src, js]) == 0
    assert cli.main(["convert", "-tobin", js, back]) == 0
    assert open(back, "rb").read() == open(src, "rb").read()
    ref = str(tmp_path / "m.ref.wdl")
    assert cli.main(["convert", "-toref", src, ref]) == 0
    assert cli.main(["convert", "-fromref", ref]) == 0
    assert cli.main(["convert", "-fromref", src]) == 1

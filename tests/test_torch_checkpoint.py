"""The port's stream checkpoints (`shifu_tpu_torch/resilience/checkpoint.py`)
against the JAX package's contract: cadence, clear, the sharded family's
commit pointer, `list_resumable`, and rejection of a snapshot of another
config or a corrupt one."""

import os

import numpy as np
import pytest

pytest.importorskip("torch")

from shifu_tpu_torch.resilience import checkpoint as pck  # noqa: E402
from shifu_tpu_torch.utils import environment as penv  # noqa: E402


def test_settings_and_sha_match_jax():
    from shifu_tpu.resilience import checkpoint as jck

    assert pck.every_chunks_setting() == jck.every_chunks_setting() == 16
    assert pck.ckpt_stream_enabled() and not pck.resume_requested()
    for key, value, fn, want in (
            ("shifu.ckpt.everyChunks", "0", pck.ckpt_stream_enabled, False),
            ("shifu.ckpt.stream", "false", pck.ckpt_stream_enabled, False),
            ("shifu.resume", "true", pck.resume_requested, True)):
        penv.set_property(key, value)
        try:
            assert fn() is want
        finally:
            penv._props.pop(key, None)
    ident = {"a": [1, 2], "b": {"c": 0.5}}
    assert pck.config_sha(ident) == jck.config_sha(ident)
    sections = {"data": {"x": 1}, "train": {"y": 2}}
    assert pck.sectioned_sha(sections) == jck.sectioned_sha(sections)
    assert list(pck.resume_slice(enumerate("abcde"), 2)) == list(
        jck.resume_slice(enumerate("abcde"), 2))
    assert pck.ckpt_path("/m", "norm", "stream") == jck.ckpt_path(
        "/m", "norm", "stream")


def test_stream_checkpoint_cadence_load_clear(tmp_path):
    path = str(tmp_path / "x" / "s.ckpt.npz")
    ck = pck.StreamCheckpoint(path, "sha1", every=3)
    calls = []

    def state():
        calls.append(1)
        return {"a": np.arange(4)}, {"k": len(calls)}, b"blob"

    saved = [ck.maybe_save(ci, state) for ci in range(7)]
    assert saved == [False, False, True, False, False, True, False]
    assert len(calls) == 2
    ci, arrays, meta, blob = ck.load()
    assert ci == 5 and meta == {"k": 2} and blob == b"blob"
    np.testing.assert_array_equal(arrays["a"], np.arange(4))
    ck.clear()
    assert ck.load() is None and not os.path.exists(path)
    ck.clear()  # twice is fine


def test_wrong_sha_or_corrupt_file_rejected(tmp_path):
    path = str(tmp_path / "s.ckpt.npz")
    pck.StreamCheckpoint(path, "aaa", sections={"data": "1"}).save(
        3, {"a": np.ones(2)})
    assert pck.StreamCheckpoint(path, "aaa").load()[0] == 3
    assert pck.StreamCheckpoint(path, "bbb",
                                sections={"data": "2"}).load() is None
    with open(path, "wb") as fh:
        fh.write(b"not a zip")
    assert pck.StreamCheckpoint(path, "aaa").load() is None


def test_sharded_family_commit_and_rejection(tmp_path):
    base = pck.ckpt_base(str(tmp_path), "norm", "stream")
    ck = pck.ShardedStreamCheckpoint(base, "sha", 2, every=2)

    def state(c0, c1):
        return ([(c0, {"v": np.array([c0])}, {"rows": 10}, None),
                 (c1, None, {"rows": 20}, b"b1")],
                (None, {"offset": c0 + c1}, None))

    assert not ck.maybe_save(lambda: state(0, 1))
    assert ck.maybe_save(lambda: state(2, 3))
    ck.save(*state(4, 5))
    cursors, per_shard, shared = pck.ShardedStreamCheckpoint(
        base, "sha", 2).load()
    assert cursors == [4, 5] and shared[1]["offset"] == 9
    assert per_shard[1][2] == b"b1" and per_shard[0][1]["rows"] == 10
    # another shard count, another config: rejected
    assert pck.ShardedStreamCheckpoint(base, "sha", 3).load() is None
    assert pck.ShardedStreamCheckpoint(base, "other", 2).load() is None
    # a shard file of the committed slot lost: the whole family rejected
    slot = shared[1]["slot"]
    os.unlink(f"{base}-shard00001-{slot}{pck.CKPT_SUFFIX}")
    assert pck.ShardedStreamCheckpoint(base, "sha", 2).load() is None
    listed = pck.list_resumable(str(tmp_path))
    assert {e["name"] for e in listed} >= {"norm-stream-shared"}
    ck.clear()
    assert pck.list_resumable(str(tmp_path)) == []


def test_list_resumable_names_trainer_snapshots(tmp_path):
    path = tmp_path / "tmp" / "train" / "checkpoint_1" / \
        ("weights.npy.state" + pck.CKPT_SUFFIX)
    pck.StreamCheckpoint(str(path), "s").save(4, meta={"epoch": 4})
    (path.parent / ("bad" + pck.CKPT_SUFFIX)).write_bytes(b"x")
    entries = {e["path"]: e for e in pck.list_resumable(str(tmp_path))}
    good = entries[str(path)]
    assert good["name"] == "train-checkpoint_1"
    assert good["chunkIndex"] == 4 and good["meta"] == {"epoch": 4}
    assert entries[str(path.parent / ("bad" + pck.CKPT_SUFFIX))]["corrupt"]

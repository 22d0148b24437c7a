"""The port's streamed NN and WDL trainers (`train/streaming.py`,
`train/streaming_wdl.py`) against the JAX package's on the CPU, on
NormalizedData / CleanedData written in 4 shards.

Tolerances are the in-memory parity tests' (`test_torch_nn_trainer.py`,
`test_torch_wdl.py`): equal epochs, errors rel 1e-4 / abs 1e-5, weights
rtol 2e-3 / atol 2e-4. Dropout stays 0 (the port's masks are not
jax.random's). A run stopped after k epochs by an exception from the
port's own shard feed, then resumed from its stream checkpoint, is
bit-equal to an unbroken run.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from shifu_tpu.train import nn_trainer as J  # noqa: E402
from shifu_tpu.train import wdl_trainer as JW  # noqa: E402
from shifu_tpu_torch.norm.dataset import (write_codes,  # noqa: E402
                                          write_normalized)
from shifu_tpu_torch.train import nn_trainer as P  # noqa: E402
from shifu_tpu_torch.train import streaming as pstream  # noqa: E402
from shifu_tpu_torch.train import streaming_wdl as pswdl  # noqa: E402
from shifu_tpu_torch.train import wdl_trainer as PW  # noqa: E402
from tests.test_torch_nn_trainer import (_same_result,  # noqa: E402
                                         make_xor_like)
from tests.test_torch_wdl import ERR, VOCAB, W_TOL  # noqa: E402
from tests.test_torch_wdl import _data as wdl_data  # noqa: E402

SHARDS = 4


def _norm_dir(tmp_path, classes=2):
    x, t, w = make_xor_like(classes=classes)
    out = str(tmp_path / "NormalizedData")
    write_normalized(out, x, t, w, [f"x{i}" for i in range(x.shape[1])],
                     n_shards=SHARDS)
    return out


def _nn_cfgs(**kw):
    base = dict(hidden_nodes=[8], activations=["tanh"], propagation="R",
                num_epochs=12, valid_set_rate=0.2)
    base.update(kw)
    return J.NNTrainConfig(**base), P.NNTrainConfig(**base)


NN_CASES = {
    "rprop": dict(),
    "backprop_decay": dict(propagation="B", learning_rate=0.05,
                           learning_decay=0.05),
    "adam_l2": dict(propagation="ADAM", learning_rate=0.01,
                    reg_level="L2", regularized_constant=0.1),
    "log_lr": dict(hidden_nodes=[], activations=[], loss="log",
                   propagation="Q"),
    "svm": dict(hidden_nodes=[], activations=[], loss="hinge",
                reg_level="L2", regularized_constant=1.0),
    "native3": dict(n_classes=3),
    "bagging_window": dict(bagging_sample_rate=0.8, early_stop_window=3,
                           num_epochs=20),
}


@pytest.mark.parametrize("case", sorted(NN_CASES))
def test_streamed_nn_matches_jax(tmp_path, case):
    from shifu_tpu.train.streaming import train_nn_streamed as jtrain

    kw = NN_CASES[case]
    data_dir = _norm_dir(tmp_path, classes=kw.get("n_classes", 2))
    jc, pc = _nn_cfgs(**kw)
    want = jtrain(data_dir, jc)
    got = pstream.train_nn_streamed(data_dir, pc, device="cpu")
    _same_result(got, want)


def test_streamed_nn_ova_and_kfold_match_jax(tmp_path):
    """A ONEVSALL member (tag == class) and a k-fold member (the global
    row index's fold through `sig_override`)."""
    from shifu_tpu.train.streaming import train_nn_streamed as jtrain

    data_dir = _norm_dir(tmp_path, classes=3)
    jc, pc = _nn_cfgs()
    _same_result(pstream.train_nn_streamed(data_dir, pc, target_class=2,
                                           device="cpu"),
                 jtrain(data_dir, jc, target_class=2))

    def fold1(s, rows, offset, w):
        fold = np.arange(offset, offset + rows) % 3
        return np.where(fold == 1, 0.0, w), np.where(fold == 1, w, 0.0)

    jc, pc = _nn_cfgs(valid_set_rate=0.0)
    _same_result(pstream.train_nn_streamed(data_dir, pc, device="cpu",
                                           sig_override=fold1),
                 jtrain(data_dir, jc, sig_override=fold1))


def _stop_after(monkeypatch, feed_cls, epochs):
    """The feed raises when epoch `epochs` starts (a preemption)."""
    real = feed_cls.__iter__
    seen = {"n": 0}

    def flaky(self):
        seen["n"] += 1
        if seen["n"] > epochs:
            raise RuntimeError("preempted")
        return real(self)

    monkeypatch.setattr(feed_cls, "__iter__", flaky)
    return lambda: monkeypatch.setattr(feed_cls, "__iter__", real)


def _flat(params):
    return np.concatenate([np.concatenate([p["W"].ravel(), p["b"].ravel()])
                           for p in params])


def test_streamed_nn_resume_bit_equal(tmp_path, monkeypatch):
    data_dir = _norm_dir(tmp_path)
    _jc, full_cfg = _nn_cfgs(propagation="ADAM", learning_rate=0.02,
                             learning_decay=0.01, checkpoint_every=2,
                             checkpoint_path=str(tmp_path / "a.npy"))
    full = pstream.train_nn_streamed(data_dir, full_cfg, device="cpu")
    _jc, cfg = _nn_cfgs(propagation="ADAM", learning_rate=0.02,
                        learning_decay=0.01, checkpoint_every=2,
                        checkpoint_path=str(tmp_path / "b.npy"))
    restore = _stop_after(monkeypatch, pstream.ShardFeed, 7)
    with pytest.raises(RuntimeError, match="preempted"):
        pstream.train_nn_streamed(data_dir, cfg, device="cpu")
    restore()
    resumed = pstream.train_nn_streamed(data_dir, cfg, resume=True,
                                        device="cpu")
    assert resumed.iterations == full.iterations
    assert _flat(resumed.params).tobytes() == _flat(full.params).tobytes()
    assert (resumed.train_error, resumed.valid_error) == \
        (full.train_error, full.valid_error)
    # a fresh run ignores (and a finished run clears) the snapshot
    assert not (tmp_path / ("b.npy.state.ckpt.npz")).exists()


def _wdl_dirs(tmp_path):
    dense, codes, t, w = wdl_data()
    nd, cd = str(tmp_path / "NormalizedData"), str(tmp_path / "CleanedData")
    write_normalized(nd, dense, t, w, [f"n{i}" for i in range(4)],
                     n_shards=SHARDS)
    write_codes(cd, codes, t, w, ["c0", "c1", "c2"], VOCAB,
                n_shards=SHARDS)
    return nd, cd


def _wdl_cfgs(**kw):
    base = dict(hidden=[8, 4], activations=["relu", "tanh"], embed_dim=3,
                learning_rate=0.05, num_epochs=10, valid_set_rate=0.2)
    base.update(kw)
    return JW.WDLTrainConfig(**base), PW.WDLTrainConfig(**base)


@pytest.mark.parametrize("opt", ["ADAM", "GD", "RMSPROP"])
def test_streamed_wdl_matches_jax(tmp_path, opt):
    from shifu_tpu.models.wdl import flatten_wdl as jflat
    from shifu_tpu.train.streaming_wdl import train_wdl_streamed as jtrain
    from shifu_tpu_torch.models.wdl import flatten_wdl as pflat

    nd, cd = _wdl_dirs(tmp_path)
    # GD's summed-gradient steps at the in-memory test's learning rate
    jc, pc = _wdl_cfgs(optimizer=opt, l2_reg=0.01 if opt == "GD" else 0.0,
                       learning_rate=0.001 if opt == "GD" else 0.05)
    want = jtrain(nd, cd, [0, 1, 2, 3], [0, 1, 2], VOCAB, jc)
    got = pswdl.train_wdl_streamed(nd, cd, [0, 1, 2, 3], [0, 1, 2], VOCAB,
                                   pc, device="cpu")
    assert got.iterations == want.iterations
    assert got.valid_error == pytest.approx(want.valid_error, **ERR)
    assert got.train_error == pytest.approx(want.train_error, **ERR)
    np.testing.assert_allclose(pflat(got.params), jflat(want.params),
                               **W_TOL)


def test_streamed_wdl_resume_bit_equal(tmp_path, monkeypatch):
    from shifu_tpu_torch.models.wdl import flatten_wdl

    nd, cd = _wdl_dirs(tmp_path)
    args = (nd, cd, [0, 1, 2, 3], [0, 1, 2], VOCAB)
    _j, full_cfg = _wdl_cfgs(checkpoint_every=3,
                             checkpoint_path=str(tmp_path / "a.npy"))
    full = pswdl.train_wdl_streamed(*args, full_cfg, device="cpu")
    _j, cfg = _wdl_cfgs(checkpoint_every=3,
                        checkpoint_path=str(tmp_path / "b.npy"))
    restore = _stop_after(monkeypatch, pswdl.WDLShardFeed, 7)
    with pytest.raises(RuntimeError, match="preempted"):
        pswdl.train_wdl_streamed(*args, cfg, device="cpu")
    restore()
    resumed = pswdl.train_wdl_streamed(*args, cfg, resume=True,
                                       device="cpu")
    assert resumed.iterations == full.iterations == 10
    assert flatten_wdl(resumed.params).tobytes() == \
        flatten_wdl(full.params).tobytes()
    assert resumed.valid_error == full.valid_error


"""The CUDA histogram -> split-scan kernel against its plain PyTorch versions,
on the card. Every test here is marked `cuda` and skips without a CUDA
device (the kernel has no CPU mode); this file imports no JAX, so it runs
on a machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from shifu_tpu_torch.ops import hist_kernel as hk  # noqa: E402
from shifu_tpu_torch.train import tree_trainer as tt  # noqa: E402

NAMES = ("feature", "cut_rank", "rank_flat", "leaf_value", "is_split",
         "best_gain", "left_mask", "node_cnt", "left_cnt")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _case(dev, slots, is_cat, n, L, seed):
    rng = np.random.default_rng(seed)
    lay = tt.make_layout(slots, is_cat)
    codes = np.stack([rng.integers(0, s - 1, size=n) for s in slots],
                     1).astype(np.int32)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    y = t((codes[:, 0] >= slots[0] // 2).astype(np.float32))  # exact planes
    w = t(rng.poisson(1.0, size=n).astype(np.float32))
    node = t(rng.integers(0, L, size=n).astype(np.int32))
    act = t(rng.random(n) < 0.9)
    return lay, t(codes), y, w, node, act


@pytest.mark.cuda
@pytest.mark.parametrize("slots,is_cat,L", [
    ([9] * 6 + [33, 65] + [1500], [False] * 6 + [True] * 3, 8),
    ([1500, 9, 33], [True, False, True], 4),
    ([33] * 30, [False] * 30, 32),
])
@pytest.mark.parametrize("impurity", ["variance", "gini"])
def test_fused_kernel_matches_plain(dev, slots, is_cat, L, impurity):
    """Integer-valued planes: histogram and the whole 9-tuple exact."""
    lay, codes, y, w, node, act = _case(dev, slots, is_cat, 20_000, L, 9)
    fok = torch.ones(lay.T, dtype=torch.bool, device=dev)
    fok[int(lay.off[1]):int(lay.off[1] + lay.slots[1])] = False
    kw = dict(L=L, lay=lay, impurity=impurity, min_inst=2, min_gain=0.0)
    c8 = hk.codes8_of(codes, lay) if lay.s_max <= 128 else None
    h_k, out_k = hk.fused_level(codes, y, w, node, act, fok, codes8=c8, **kw)
    h_p, out_p = hk.fused_level_reference(codes, y, w, node, act, fok, **kw)
    torch.cuda.synchronize()
    assert torch.equal(h_k, h_p)
    for nm, a, b in zip(NAMES, out_p, out_k):
        assert torch.equal(a, b), nm


@pytest.mark.cuda
@pytest.mark.parametrize("L", [64, 128])
def test_hist_kernel_matches_plain(dev, L):
    slots = [33] * 20 + [65] * 10
    lay, codes, y, w, node, act = _case(dev, slots, [False] * 20 + [True] * 10,
                                        50_000, L, 4)
    h_k = hk.hist_level(codes, y, w, node, act, L=L, lay=lay,
                        codes8=hk.codes8_of(codes, lay))
    h_p = hk.hist_level_reference(codes, y, w, node, act, L=L, lay=lay)
    torch.cuda.synchronize()
    assert torch.equal(h_k, h_p)


@pytest.mark.cuda
def test_bf16_planes_close_and_deterministic(dev):
    """Float GBT planes: counts exact, moments within summation-order
    tolerance of the plain version, and two launches give the same
    bits."""
    lay, codes, _y, _w, node, act = _case(dev, [33] * 30, [False] * 30,
                                          100_000, 16, 2)
    g = torch.Generator(device="cpu").manual_seed(0)
    y = (torch.rand(codes.shape[0], generator=g) - 0.4).to(dev)
    w = torch.ones_like(y)
    kw = dict(L=16, lay=lay, low_precision=True)
    h1 = hk.hist_level(codes, y, w, node, act, **kw)
    h2 = hk.hist_level(codes, y, w, node, act, **kw)
    hp = hk.hist_level_reference(codes, y, w, node, act, **kw)
    torch.cuda.synchronize()
    assert torch.equal(h1, h2)
    assert torch.equal(h1[0], hp[0])
    torch.testing.assert_close(h1, hp, rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
def test_wrappers_raise_on_bad_inputs(dev):
    lay, codes, y, w, node, act = _case(dev, [9, 9], [False, False], 100, 2,
                                        0)
    with pytest.raises(TypeError):
        hk.hist_level(codes.long(), y, w, node, act, L=2, lay=lay)
    with pytest.raises(ValueError):
        hk.hist_level(codes, y.cpu(), w, node, act, L=2, lay=lay)

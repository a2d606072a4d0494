"""The port's CUDA kernels on a card, against their plain PyTorch versions.

Every test here is marked `gpu` and skips without a CUDA card. The file
imports neither JAX nor the JAX package, so it also runs where only PyTorch
is installed; there, skip the repository's conftest (which sets JAX up):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

Tolerances: routed heap ids bit-identical; the margin update within 1e-5
(one f32 multiply-add); histograms within 1e-4 of each stat row's largest
magnitude against the plain version in float64, since the kernel sums in
float64 and casts once.
"""

import numpy as np
import pytest
import torch

HIST_RTOL = 1e-4
F_ATOL = 1e-5


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture()
def HC():
    from h2o3_tpu_torch.ops import hist_cuda
    return hist_cuda


def _inputs(dev, seed, *, n=1 << 16, c_pad=32, b_val=255, L=64):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, b_val, (c_pad, n)).astype(np.uint8)
    codes[rng.random((c_pad, n)) < 0.05] = b_val
    base = L - 1
    heap = rng.integers(base, base + L, n).astype(np.int32)
    heap[rng.random(n) < 0.1] = max(0, base - 1)
    stats = rng.normal(0, 1, (4, n)).astype(np.float32)
    stats[3] = 0.0
    return [torch.from_numpy(a).to(dev) for a in (codes, heap, stats)], base


def _rel_err(got, want):
    errs = []
    for s in range(got.shape[2]):
        scale = max(want[:, :, s].abs().max().item(), 1e-30)
        errs.append((got[:, :, s].double() - want[:, :, s]).abs().max().item()
                    / scale)
    return max(errs)


@pytest.mark.gpu
@pytest.mark.parametrize("emit_f", [False, True])
def test_route_kernel_matches_plain(dev, HC, emit_f):
    L, n_bins = 64, 256
    (codes, heap, _), base = _inputs(dev, 1, L=L)
    rng = np.random.default_rng(2)
    tbl = np.zeros((8, L), np.float32)
    tbl[0] = rng.integers(0, codes.shape[0], L)
    tbl[1] = rng.random(L) < 0.8
    route_f = (rng.random((L, n_bins)) < 0.5).astype(np.float32)
    valtab = np.zeros((8, 256), np.float32)
    valtab[0] = rng.normal(0, 1, 256)
    F = rng.normal(0, 1, codes.shape[1]).astype(np.float32)
    args = [codes, heap] + [torch.from_numpy(a).to(dev)
                            for a in (tbl, route_f, valtab, F)]
    kw = dict(base=base, L=L, eta=0.1, emit_f=emit_f)
    key = "route_f" if emit_f else "route"
    before = HC.LAUNCHES[key]
    h_k, f_k = HC.sbh_route(*args, **kw)
    h_p, f_p = HC.sbh_route_plain(*args, **kw)
    torch.cuda.synchronize()
    assert HC.LAUNCHES[key] == before + 1
    assert torch.equal(h_k, h_p)
    assert (h_k != heap).any()
    if emit_f:
        assert (f_k - f_p).abs().max().item() < F_ATOL
    else:
        assert f_k is None


@pytest.mark.gpu
@pytest.mark.parametrize("half", [False, True])
@pytest.mark.parametrize("L", [1, 64, 128])
def test_hist_kernel_matches_plain(dev, HC, L, half):
    (codes, heap, stats), base = _inputs(dev, 10 + L, L=L)
    kw = dict(base=base, L=L, n_bins=256, half=half)
    before = HC.LAUNCHES["hist"]
    got = HC.sbh_hist(codes, heap, stats, **kw)
    want = HC.sbh_hist_plain(codes, heap, stats.double(), **kw)
    torch.cuda.synchronize()
    assert HC.LAUNCHES["hist"] == before + 1
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _rel_err(got, want) <= HIST_RTOL


@pytest.mark.gpu
def test_wrappers_refuse_what_the_kernels_do_not_take(dev, HC):
    (codes, heap, stats), base = _inputs(dev, 3, L=1)
    with pytest.raises(TypeError, match="heap"):
        HC.sbh_hist(codes, heap.long(), stats, base=base, L=1, n_bins=256)
    with pytest.raises(ValueError, match="contiguous"):
        HC.sbh_hist(codes.t().contiguous().t(), heap, stats, base=base, L=1,
                    n_bins=256)
    with pytest.raises(ValueError, match="on cpu"):
        HC.sbh_hist(codes, heap.cpu(), stats, base=base, L=1, n_bins=256)


@pytest.mark.gpu
def test_gbm_trains_through_the_kernels(dev, HC):
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.core.frame import Frame, T_CAT, Vec
    h2o.init()
    rng = np.random.default_rng(4)
    X = rng.normal(size=(20000, 6)).astype(np.float32)
    y = (rng.random(20000) < 1 / (1 + np.exp(-2 * X[:, 0]))).astype(float)
    fr = Frame([f"x{j}" for j in range(6)] + ["y"],
               [Vec.from_numpy(X[:, j]) for j in range(6)]
               + [Vec.from_numpy(y, type=T_CAT, domain=["0", "1"])])
    HC.reset_launches()
    m = h2o.H2OGradientBoostingEstimator(ntrees=3, max_depth=4)
    m.train(y="y", training_frame=fr)
    assert HC.LAUNCHES == {"hist": 12, "route": 9, "route_f": 3}
    p = m.predict(fr).to_numpy()
    assert np.isfinite(p).all() and m.auc() > 0.75

"""The port's CUDA kernels on a card, against their plain PyTorch versions.

Every test here is marked `gpu` and skips without a CUDA card. The file
imports neither JAX nor the JAX package, so it also runs where only PyTorch
is installed; there, skip the repository's conftest (which sets JAX up):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

Tolerances: routed heap ids bit-identical; the margin update within 1e-5
(one f32 multiply-add); f32 histograms within 1e-4 of each stat row's
largest magnitude against the plain version in float64, since the kernels
sum in exact 64-bit fixed point and cast once; bins that a NaN or inf stat
reaches as in float64, and results bit-identical from launch to launch and
across launch layouts (column groups, window copies, threads, warp
aggregation); histograms of int32 stats (the int8 path) equal to the plain
version (`torch.equal`: integer sums are exact) in every layout. The
models without kernels (GLM, DeepLearning, KMeans, PCA, SVD, GLRM) are
held on the card against their CPU runs, each tolerance in its test; so
are the frame data plane's prefetch stream and spill ladder (bit for
bit) and the sparse GLM (bit for bit twice on the card; within 1e-4 of
the CPU's, whose float64 sums round in another order). A CSV parsed on
the card has the CPU parse's codecs and bits, whole and chunked; a GBM
saved on the card predicts bit for bit after loading there and within
1e-5 on the CPU (f32 sums in another order). Runs (at) and (av) small:
a GBM's H2O-3 MOJO imported and scored on the card routes as the model
(col, thr, na_left bit for bit, leaves f32(value * learn_rate)) and
gives its probabilities within 1e-5, as does its native MOJO; AutoML's
GBM steps launch the binned kernels, and each base model trained alone
is the same bit for bit. Run (ax) small: the scorer cache captures one
CUDA graph a row bucket for a GBM, GLM, DL and KMeans and replays it
bit for bit against the eager scorer on the same padded buffer, captures
again after a demote and a promote (from the host tier and from an npz),
gives 4 threads their serial answers, and runs a warm dispatch under
`torch.cuda.set_sync_debug_mode("error")`. Runs (ay)-(ba) small:
requests that coalesce into one micro-batched dispatch get the rows each
scored alone gets (GBM and KMeans bit for bit, GLM and DL within 1e-6);
leaders capture again while other threads replay under
H2O3_QOS_MAX_INFLIGHT=4 and lockdep raising; the drift baseline binned
on the card equals numpy's counts; the stage split (CUDA events) adds no
synchronising call. Runs (bb)-(bd) small: the REST server on the card
names it and torch/cuda, builds a GBM over REST with train()'s trees bit
for bit, answers row predictions equal to score_payload's, profiles the
binned kernels through torch.profiler, answers warm predicts under
H2O3_TRANSFER_GUARD=disallow while an .item() raises, and both
`python -m` entry points serve on the card.
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


def _inputs(dev, seed, *, n=1 << 16, c_pad=32, b_val=255, L=64, int8=False):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, b_val, (c_pad, n)).astype(np.uint8)
    codes[rng.random((c_pad, n)) < 0.05] = b_val
    codes[-2:] = 0                     # padding columns: every row in bin 0
    base = L - 1
    heap = rng.integers(base, base + L, n).astype(np.int32)
    heap[rng.random(n) < 0.1] = max(0, base - 1)
    stats = rng.normal(0, 1, (4, n)).astype(np.float32)
    stats[3] = 0.0
    if int8:
        stats = np.clip(np.round(stats * 40.0), -127, 127).astype(np.int32)
    return [torch.from_numpy(a).to(dev) for a in (codes, heap, stats)], base


def _tables(dev, seed, L, c_pad, n_bins=256):
    rng = np.random.default_rng(seed)
    lp = max(8, L)
    tbl = np.zeros((8, lp), np.float32)
    tbl[0, :L] = rng.integers(0, c_pad, L)
    tbl[1, :L] = rng.random(L) < 0.8
    route_f = (rng.random((lp, n_bins)) < 0.5).astype(np.float32)
    return torch.from_numpy(tbl).to(dev), torch.from_numpy(route_f).to(dev)


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
    got = HC.sbh_hist(codes, heap, stats, radix=False, **kw)
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
    # per tree: the shallow-window kernel at level 0, the fused kernel at
    # levels 1-3 (1, 2 and 4 left children), the terminal route
    assert HC.LAUNCHES == {"hist": 0, "hist_i8": 0, "radix": 3, "fused": 9,
                           "route": 0, "route_f": 3}
    p = m.predict(fr).to_numpy()
    assert np.isfinite(p).all() and m.auc() > 0.75
    HC.reset_launches()
    m8 = h2o.H2OGradientBoostingEstimator(ntrees=3, max_depth=4,
                                          int8_hist=True)
    m8.train(y="y", training_frame=fr)
    assert HC.LAUNCHES == {"hist": 0, "hist_i8": 0, "radix": 3, "fused": 9,
                           "route": 0, "route_f": 3}
    HC.reset_launches()
    ms = h2o.H2OGradientBoostingEstimator(ntrees=3, max_depth=4,
                                          radix_shallow=False,
                                          fused_level=False)
    ms.train(y="y", training_frame=fr)
    assert HC.LAUNCHES == {"hist": 12, "hist_i8": 0, "radix": 0, "fused": 0,
                           "route": 9, "route_f": 3}
    assert m8.auc() > 0.75 and abs(ms.auc() - m.auc()) < 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("half", [False, True])
@pytest.mark.parametrize("L", [1, 64, 128])
def test_hist_i8_kernel_matches_plain(dev, HC, L, half):
    (codes, heap, stats), base = _inputs(dev, 20 + L, L=L, int8=True)
    kw = dict(base=base, L=L, n_bins=256, half=half)
    before = HC.LAUNCHES["hist_i8"]
    got = HC.sbh_hist_i8(codes, heap, stats, radix=False, **kw)
    want = HC.sbh_hist_plain(codes, heap, stats, **kw)
    torch.cuda.synchronize()
    assert HC.LAUNCHES["hist_i8"] == before + 1
    assert got.dtype == torch.int32 and torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("L,half", [(1, False), (2, True), (4, True)])
def test_radix_kernel_matches_plain(dev, HC, L, half, int8):
    (codes, heap, stats), base = _inputs(dev, 30 + L, L=L, int8=int8)
    kw = dict(base=base, L=L, n_bins=256, half=half)
    before = HC.LAUNCHES["radix"]
    got = HC.sbh_hist_radix(codes, heap, stats, int8=int8, **kw)
    again = HC.sbh_hist_radix(codes, heap, stats, int8=int8, **kw)
    want = HC.sbh_hist_plain(codes, heap, stats if int8 else stats.double(),
                             **kw)
    torch.cuda.synchronize()
    assert HC.LAUNCHES["radix"] == before + 2
    assert got.shape == want.shape
    if int8:
        assert torch.equal(got, want) and torch.equal(again, want)
    else:
        assert _rel_err(got, want) <= HIST_RTOL
        assert got.dtype == torch.float32 and _bit_equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("L_h", [2, 4, 8, 16, 32])
def test_fused_kernel_matches_plain(dev, HC, L_h, int8):
    L_r = L_h // 2
    (codes, heap, stats), base_r = _inputs(dev, 40 + L_h, L=L_r, int8=int8)
    tbl, route_f = _tables(dev, 41 + L_h, L_r, codes.shape[0])
    kw = dict(base_r=base_r, L_r=L_r, base_h=L_h - 1, L_h=L_h, n_bins=256)
    before = HC.LAUNCHES["fused"]
    h_k, got = HC.sbh_route_hist_fused(codes, heap, tbl, route_f, stats,
                                       int8=int8, **kw)
    h_p, want = HC.sbh_route_hist_plain(
        codes, heap, tbl, route_f, stats if int8 else stats.double(), **kw)
    torch.cuda.synchronize()
    assert HC.LAUNCHES["fused"] == before + 1
    assert torch.equal(h_k, h_p) and (h_k != heap).any()
    assert got.shape == want.shape == (L_h // 2, codes.shape[0], 4, 256)
    if int8:
        assert torch.equal(got, want)
    else:
        assert _rel_err(got, want) <= HIST_RTOL


def _adversarial(dev, seed, kind, *, n=1 << 16, c_pad=32, L=64):
    """Weights up to 1e4, grads of alternating sign (exactly cancelling
    pairs in the first half), every row in one slot and one bin
    ("one_bin"), or one NaN grad and one inf hess in the window
    ("nonfinite")."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 255, (c_pad, n)).astype(np.uint8)
    codes[-2:] = 0
    base = L - 1
    heap = rng.integers(base, base + L, n).astype(np.int32)
    if kind == "one_bin":
        codes[:] = 7
        heap[:] = base
    w = rng.uniform(0.0, 1e4, n)
    g = w * rng.uniform(0.5, 1.5, n)
    g[1: n // 2: 2] = g[0: n // 2 - 1: 2]
    g[1::2] *= -1.0
    stats = np.stack([w, g, w * rng.uniform(0.05, 0.25, n),
                      np.zeros(n)]).astype(np.float32)
    if kind == "nonfinite":
        stats[1, 10], stats[2, 21] = np.nan, np.inf
        heap[[10, 21]] = base
    return [torch.from_numpy(a).to(dev) for a in (codes, heap, stats)], base


def _bit_equal(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def _hold_to_f64(got, want, nonfinite):
    fin = torch.isfinite(want)
    assert bool((~fin).any()) == nonfinite
    assert torch.equal(fin, torch.isfinite(got))
    assert torch.equal(torch.isnan(want), torch.isnan(got))
    inf = torch.isinf(want)
    assert torch.equal(got[inf].double(), want[inf])
    zero = torch.zeros((), dtype=torch.float64, device=want.device)
    assert _rel_err(torch.where(fin, got.double(), zero),
                    torch.where(fin, want, zero)) <= HIST_RTOL


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["one_bin", "heavy", "nonfinite"])
def test_dense_kernel_on_adversarial_stats(dev, HC, kind):
    L = 1 if kind == "one_bin" else 64
    (codes, heap, stats), base = _adversarial(dev, 50, kind, L=L)
    kw = dict(base=base, L=L, n_bins=256, half=L > 1)
    got = HC.sbh_hist(codes, heap, stats, radix=False, **kw)
    again = HC.sbh_hist_dense(codes, heap, stats, **kw)
    want = HC.sbh_hist_plain(codes, heap, stats.double(), **kw)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and _bit_equal(got, again)
    _hold_to_f64(got, want, kind == "nonfinite")


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["one_bin", "heavy", "nonfinite"])
def test_fused_kernel_on_adversarial_stats(dev, HC, kind):
    L_h = 2 if kind == "one_bin" else 32
    L_r = L_h // 2
    (codes, heap, stats), base_r = _adversarial(dev, 51, kind, L=L_r)
    tbl, route_f = _tables(dev, 52, L_r, codes.shape[0])
    if kind != "heavy":
        tbl[1, 0] = 1.0                       # leaf 0 splits, every row left
        route_f[0] = 0.0
    kw = dict(base_r=base_r, L_r=L_r, base_h=L_h - 1, L_h=L_h, n_bins=256)
    h_k, got = HC.sbh_route_hist_fused(codes, heap, tbl, route_f, stats, **kw)
    h_2, again = HC.sbh_route_hist_fused(codes, heap, tbl, route_f, stats,
                                         **kw)
    h_p, want = HC.sbh_route_hist_plain(codes, heap, tbl, route_f,
                                        stats.double(), **kw)
    torch.cuda.synchronize()
    assert torch.equal(h_k, h_p) and torch.equal(h_k, h_2)
    assert _bit_equal(got, again)
    _hold_to_f64(got, want, kind == "nonfinite")


@pytest.mark.gpu
@pytest.mark.parametrize("L", [2, 16, 64])
def test_column_groups_give_the_same_bits(dev, HC, L):
    """Every grouping of columns per block (and so every window width)
    gives the same fixed-point sums, bit for bit."""
    (codes, heap, stats), base = _inputs(dev, 60 + L, L=L)
    kw = dict(base=base, L=L, n_bins=256, half=True)
    outs = [HC.sbh_hist_dense(codes, heap, stats, group=g, **kw)
            for g in (None, 1, 2, 3, 32)]
    tbl, route_f = _tables(dev, 61 + L, L // 2, codes.shape[0])
    fkw = dict(base_r=L // 2 - 1, L_r=L // 2, base_h=L - 1, L_h=L,
               n_bins=256)
    fused = [HC.sbh_route_hist_fused(codes, heap, tbl, route_f, stats,
                                     group=g, **fkw)[1]
             for g in (None, 1, 2, 5)] if L <= 32 else []
    torch.cuda.synchronize()
    assert all(_bit_equal(o, outs[0]) for o in outs[1:])
    assert all(_bit_equal(o, fused[0]) for o in fused[1:])
    if L > 32:
        return
    # the int8 fused kernel at every group it is built for that fits,
    # 512 and 1024 threads: the plain version's int32 sums and heap
    (codes, heap, st8), _ = _inputs(dev, 62 + L, L=L, int8=True)
    h_p, want = HC.sbh_route_hist_plain(codes, heap, tbl, route_f, st8,
                                        **fkw)
    win = HC.level_grid(L // 2, 256, codes.shape[0], True)[0]
    groups = [g for g in HC.GROUPS if g * win * 3 * 4 * 256 <= HC.SMEM_MAX]
    for g in groups:
        for threads in (512, 1024):
            h_k, got = HC.sbh_route_hist_fused(codes, heap, tbl, route_f, st8,
                                               int8=True, group=g,
                                               threads=threads, **fkw)
            torch.cuda.synchronize()
            assert torch.equal(h_k, h_p) and torch.equal(got, want), \
                (g, threads)


@pytest.mark.gpu
def test_hist_scale_on_the_card_matches_the_cpu(dev, HC):
    rng = np.random.default_rng(70)
    stats = (rng.normal(0, 1, (4, 4096))
             * np.array([[1e-20], [3.0], [1e20], [0.0]])).astype(np.float32)
    stats[1, 7] = np.nan
    st = torch.from_numpy(stats)
    for n_rows in (None, 11_000_000):
        assert torch.equal(HC.hist_scale(st.to(dev), n_rows).cpu(),
                           HC.hist_scale(st, n_rows))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["one_bin", "heavy", "nonfinite"])
def test_radix_kernel_on_adversarial_stats(dev, HC, kind):
    """The shallow-window kernel's f32 form on stats that stress its
    fixed-point sum: every row in one slot and one bin (full warps of one
    key: warp aggregation), heavy cancelling weights over a half window of
    two slots, a NaN and an inf stat; two launches bit-identical."""
    L = 1 if kind == "one_bin" else 4
    (codes, heap, stats), base = _adversarial(dev, 53, kind, L=L)
    kw = dict(base=base, L=L, n_bins=256, half=L > 1)
    got = HC.sbh_hist(codes, heap, stats, **kw)
    again = HC.sbh_hist_radix(codes, heap, stats, **kw)
    want = HC.sbh_hist_plain(codes, heap, stats.double(), **kw)
    torch.cuda.synchronize()
    assert got.shape == (HC.hist_layout(L, L > 1)[0], codes.shape[0], 4, 256)
    assert got.dtype == torch.float32 and _bit_equal(got, again)
    _hold_to_f64(got, want, kind == "nonfinite")


@pytest.mark.gpu
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("L,half", [(1, False), (4, True)])
def test_radix_layouts_give_the_same_bits(dev, HC, L, half, int8):
    """Every layout of the shallow-window launch (each group it is built
    for that fits, with its window copies, 512 and 1024 threads, warp
    aggregation on and off) gives the same bits: the f32 form's fixed-point
    sums, the int8 form's int32 sums equal to the plain version's."""
    (codes, heap, stats), base = _inputs(dev, 63 + L, L=L, int8=int8)
    kw = dict(base=base, L=L, n_bins=256, half=half, int8=int8)
    ref = HC.sbh_hist_radix(codes, heap, stats, **kw)
    if int8:
        assert torch.equal(ref, HC.sbh_hist_plain(codes, heap, stats,
                                                  **{k: v for k, v in
                                                     kw.items()
                                                     if k != "int8"}))
    win = HC.hist_layout(L, half)[0]
    slot = win * 3 * (4 if int8 else 8) * 256
    for g in (g for g in HC.RADIX_GROUPS[int8] if g * slot <= HC.SMEM_MAX):
        for threads in (512, 1024):
            for agg in (False, True):
                got = HC.sbh_hist_radix(codes, heap, stats, group=g,
                                        threads=threads, agg=agg, **kw)
                torch.cuda.synchronize()
                assert _bit_equal(got, ref), (g, threads, agg)


def _i8_layouts(HC, l_eff, c_pad=32, n_bins=256):
    """The int8 dense layouts chip_smoke.py times at a level of l_eff
    slots: each window width with its widest group, at 512 and 1024
    threads, and the default window with and without the bank padding and
    at 1, 2 and 4 waves."""
    out = [{}]
    for win in sorted({l_eff, max(1, l_eff // 2), max(1, l_eff // 4)}):
        for threads in (512, 1024):
            try:                # a window wider than 227 KB holds
                HC.dense_i8_grid(l_eff, n_bins, c_pad, win=win)
            except ValueError:
                continue
            out.append(dict(win=win, threads=threads))
    out += [dict(spad=0), dict(waves=2), dict(waves=4)]
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("L,half", [(64, True), (128, True), (512, False)])
def test_hist_i8_layouts_give_the_same_bits(dev, HC, L, half):
    """The int8 dense kernel in every layout chip_smoke.py times (column
    groups, windows, one pass or two, threads, bank padding, waves) equals
    the plain version's int32 sums; at L=512 (full) the 512 slots take two
    bands of 256, each a pack launch and a histogram launch."""
    (codes, heap, stats), base = _inputs(dev, 70 + L, L=L, int8=True)
    kw = dict(base=base, L=L, n_bins=256, half=half)
    want = HC.sbh_hist_plain(codes, heap, stats, **kw)
    l_eff = HC.hist_layout(L, half)[0]
    for layout in _i8_layouts(HC, min(l_eff, HC.I8_BAND)):
        got = HC.sbh_hist_dense(codes, heap, stats, int8=True, **layout, **kw)
        torch.cuda.synchronize()
        assert got.dtype == torch.int32 and torch.equal(got, want), layout


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1 << 16, (1 << 16) + 3])
def test_route_layouts_match_plain(dev, HC, n):
    """The non-terminal route kernel at 64 leaves in every layout
    chip_smoke.py times (4 and 8 rows a thread-step; 256, 512, 1024
    threads): heap ids identical to the plain version's, also for a row
    count that is not a multiple of 4 (the tail rows)."""
    L, n_bins = 64, 256
    (codes, heap, _), base = _inputs(dev, 80, n=n, L=L)
    tbl, route_f = _tables(dev, 81, L, codes.shape[0], n_bins)
    want, _ = HC.sbh_route_plain(codes, heap, tbl, route_f, base=base, L=L)
    assert not torch.equal(want, heap)
    for rows in (4, 8):
        for threads in (256, 512, 1024):
            got, f = HC.sbh_route(codes, heap, tbl, route_f, base=base, L=L,
                                  rows=rows, threads=threads)
            torch.cuda.synchronize()
            assert f is None and torch.equal(got, want), (rows, threads)


# ---------------------------------------------------------------------------
# Covertype's width (54 columns, C_pad 56: a partial last column group in
# every kernel) and the levels 8 and 9 of a depth-10 tree (L 256 and 512).
@pytest.mark.gpu
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("kind", ["dense", "radix", "fused"])
def test_kernels_at_56_columns(dev, HC, kind, int8):
    """Each histogram kernel at C_pad 56, both forms, against the plain
    version (f32 within 1e-4 of each stat row's scale in float64, int32
    equal), the fused kernel's heap ids identical."""
    c_pad = 56
    if kind == "fused":
        L_h = 32
        (codes, heap, stats), base_r = _inputs(dev, 90, c_pad=c_pad,
                                               L=L_h // 2, int8=int8)
        tbl, route_f = _tables(dev, 91, L_h // 2, c_pad)
        kw = dict(base_r=base_r, L_r=L_h // 2, base_h=L_h - 1, L_h=L_h,
                  n_bins=256)
        h_k, got = HC.sbh_route_hist_fused(codes, heap, tbl, route_f, stats,
                                           int8=int8, **kw)
        h_p, want = HC.sbh_route_hist_plain(
            codes, heap, tbl, route_f, stats if int8 else stats.double(),
            **kw)
        assert torch.equal(h_k, h_p)
    else:
        L, half = (64, True) if kind == "dense" else (2, True)
        (codes, heap, stats), base = _inputs(dev, 92, c_pad=c_pad, L=L,
                                             int8=int8)
        kw = dict(base=base, L=L, n_bins=256, half=half)
        fn = HC.sbh_hist_dense if kind == "dense" else HC.sbh_hist_radix
        got = fn(codes, heap, stats, int8=int8, **kw)
        want = HC.sbh_hist_plain(codes, heap,
                                 stats if int8 else stats.double(), **kw)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.shape[1] == c_pad
    if int8:
        assert torch.equal(got, want)
    else:
        assert _rel_err(got, want) <= HIST_RTOL


@pytest.mark.gpu
@pytest.mark.parametrize("c_pad", [32, 56])
@pytest.mark.parametrize("L", [256, 512])
def test_depth_10_levels_match_plain(dev, HC, L, c_pad):
    """The dense histogram, f32 and int8, of the left children of 256 and
    512 leaves, and the route (both forms) of 256 and 512 leaves: against
    the plain version as above, heap ids identical, the margin within
    1e-5."""
    (codes, heap, stats), base = _inputs(dev, 100 + L, c_pad=c_pad, L=L)
    kw = dict(base=base, L=L, n_bins=256, half=True)
    got = HC.sbh_hist_dense(codes, heap, stats, **kw)
    want = HC.sbh_hist_plain(codes, heap, stats.double(), **kw)
    assert got.shape == want.shape == (L // 2, c_pad, 4, 256)
    assert _rel_err(got, want) <= HIST_RTOL
    s8 = torch.clamp(torch.round(stats * 40.0), -127, 127).to(torch.int32)
    assert torch.equal(HC.sbh_hist_dense(codes, heap, s8, int8=True, **kw),
                       HC.sbh_hist_plain(codes, heap, s8, **kw))
    tbl, route_f = _tables(dev, 101 + L, L, c_pad)
    nodes_p = -(-(2 * (base + L) + 1) // 128) * 128
    rng = np.random.default_rng(102)
    valtab = torch.zeros((8, nodes_p), device=dev)
    valtab[0] = torch.from_numpy(rng.normal(0, 1, nodes_p).astype(
        np.float32)).to(dev)
    F = torch.from_numpy(rng.normal(0, 1, heap.numel()).astype(
        np.float32)).to(dev)
    for emit_f in (False, True):
        rk = dict(base=base, L=L, eta=0.1, emit_f=emit_f)
        h_k, f_k = HC.sbh_route(codes, heap, tbl, route_f, valtab, F, **rk)
        h_p, f_p = HC.sbh_route_plain(codes, heap, tbl, route_f, valtab, F,
                                      **rk)
        torch.cuda.synchronize()
        assert torch.equal(h_k, h_p) and (h_k != heap).any()
        if emit_f:
            assert (f_k - f_p).abs().max().item() < F_ATOL


def _train_on(device, cls, fr_cols, y, dom, **params):
    """Train on `device` ("cuda" or "cpu") from the same numpy columns;
    returns the predicted probabilities."""
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.core.frame import Frame, T_CAT, Vec
    h2o.init(device=device)
    fr = Frame([f"x{j}" for j in range(fr_cols.shape[1])] + ["y"],
               [Vec.from_numpy(fr_cols[:, j]) for j in range(fr_cols.shape[1])]
               + [Vec.from_numpy(y, type=T_CAT, domain=dom)])
    m = getattr(h2o, cls)(**params)
    m.train(y="y", training_frame=fr)
    return m, m.predict(fr).to_numpy()[:, 1:]


@pytest.mark.gpu
def test_multinomial_gbm_on_the_card_matches_the_cpu(dev, HC):
    """A 4-class GBM at 54 columns (C_pad 56), depth 5: probabilities
    within 1e-4 of the same run on the CPU; per tree the shallow-window
    kernel, 4 fused levels and the terminal route. The depth and min_rows
    keep the leaves large: deeper, the f32 sums of the CPU's plain
    histograms and the kernels' exact sums pick different near-tie splits
    (a CPU run with the plain histograms summed in float64 in place of the
    kernels took another split in 2 of 4 seeds at depth 6, in none of 6 at
    depth 5)."""
    rng = np.random.default_rng(110)
    X = rng.normal(size=(20000, 54)).astype(np.float32)
    y = np.argmax(2 * X[:, :4] + rng.gumbel(size=(20000, 4)), 1) \
        .astype(float)
    kw = dict(ntrees=3, max_depth=5, nbins=64, learn_rate=0.2, min_rows=100,
              seed=3)
    _, cpu = _train_on("cpu", "H2OGradientBoostingEstimator", X, y,
                       list("abcd"), **kw)
    HC.reset_launches()
    m, card = _train_on("cuda", "H2OGradientBoostingEstimator", X, y,
                        list("abcd"), **kw)
    assert m.summary()["number_of_trees"] == 12
    assert HC.LAUNCHES == {"hist": 0, "hist_i8": 0, "radix": 12,
                           "fused": 48, "route": 0, "route_f": 12}
    assert np.abs(card - cpu).max() < 1e-4
    np.testing.assert_allclose(card.sum(1), 1.0, atol=1e-5)


@pytest.mark.gpu
def test_drf_on_the_card_matches_the_cpu(dev, HC):
    """A binomial forest with every row in every bag (sample_rate=1) and
    every column at every node, depth 10: class-1 probabilities within
    1e-4 of the same run on the CPU; per tree the shallow-window kernel,
    5 fused levels, 4 route + dense histogram pairs and the terminal
    route. The stats (w, w*y, w) are 0/1 here, so the CPU's f32 sums are
    exact too and both build the same trees."""
    rng = np.random.default_rng(111)
    X = rng.normal(size=(30000, 8)).astype(np.float32)
    y = (X[:, 0] - X[:, 1] + rng.normal(0, 1, 30000) > 0).astype(float)
    kw = dict(ntrees=3, max_depth=10, sample_rate=1.0, mtries=-2, seed=3)
    _, cpu = _train_on("cpu", "H2ORandomForestEstimator", X, y, ["0", "1"],
                       **kw)
    HC.reset_launches()
    m, card = _train_on("cuda", "H2ORandomForestEstimator", X, y,
                        ["0", "1"], **kw)
    assert HC.LAUNCHES == {"hist": 12, "hist_i8": 0, "radix": 3,
                           "fused": 15, "route": 12, "route_f": 3}
    assert np.abs(card - cpu).max() < 1e-4


# ---------------------------------------------------------------------------
# The adaptive engine (plain PyTorch, no kernel of ops/csrc): the card
# against the CPU. Ranges, bins, routes and the fixed-point histogram sums
# are exact on both; models on 0/1 stats build the same trees, and models
# on real-valued stats (whose exp and sigmoid differ in the last bit
# between the card and the CPU) agree in AUC within 1e-3.
@pytest.mark.gpu
def test_adaptive_building_blocks_on_the_card_match_the_cpu(dev):
    """Ranges, bins and the histogram of 200,000 rows over 64 leaves equal
    on the card and the CPU (the histogram sums in exact fixed point)."""
    from h2o3_tpu_torch.models.tree import engine as E
    rng = np.random.default_rng(120)
    n, C, L, B = 200_000, 12, 64, 20
    X = rng.normal(size=(n, C)).astype(np.float32)
    X[rng.random((n, C)) < 0.03] = np.nan
    lv = rng.integers(0, L, n)
    stats = rng.normal(size=(n, 3)).astype(np.float32)
    out = {}
    for d in ("cpu", dev):
        t = [torch.from_numpy(a).to(d) for a in (X, lv, stats)]
        mn, mx = E._ranges(t[0], t[1], L)
        bins = E.bin_rows(t[0], t[1], mn, mx, B)
        hist = E.build_histograms(bins, t[1], t[2], L, B)
        out[str(d)] = [a.cpu() for a in (mn, mx, bins, hist)]
    cpu, card = out["cpu"], out[str(dev)]
    for k in range(4):
        assert torch.equal(card[k], cpu[k])


def _csv_cols(n=20000, seed=121):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 6)).astype(np.float32)
    X[rng.random((n, 6)) < 0.03] = np.nan
    Xz = np.nan_to_num(X)
    y = (1.2 * Xz[:, 0] - 0.8 * Xz[:, 1] + 0.5 * Xz[:, 2] * Xz[:, 3]
         + rng.logistic(size=n) > 0).astype(float)
    return X, y


@pytest.mark.gpu
@pytest.mark.parametrize("cls,params", [
    ("H2OXGBoostEstimator", dict(ntrees=5, max_depth=6, seed=3)),
    ("H2OGradientBoostingEstimator",
     dict(ntrees=5, max_depth=5, min_rows=100, seed=3,
          histogram_type="UniformAdaptive")),
    ("H2ORandomForestEstimator", dict(ntrees=3, sample_rate=1.0, seed=3)),
])
def test_adaptive_models_on_the_card_match_the_cpu(dev, HC, cls, params):
    """XGBoost (depth 6), a UniformAdaptive GBM and a DRF at its default
    depth 20, on the card and on the CPU from the same columns: no kernel
    launch; for the boosters the training AUC within 1e-3 (the card's exp
    and sigmoid differ from the CPU's in the last bit, and a deeper tree
    flips near ties: at depth 12, min_rows 10, with f32 histogram sums, the
    GBM's AUC moved 1.1e-3);
    the forest, with every row in every bag (so no out-of-bag AUC) and
    every column at every node, grows on exact 0/1 sums: probabilities
    within 1e-5."""
    X, y = _csv_cols()
    m_cpu, cpu = _train_on("cpu", cls, X, y, ["0", "1"], **params)
    HC.reset_launches()
    m, card = _train_on("cuda", cls, X, y, ["0", "1"], **params)
    assert not any(HC.LAUNCHES.values())
    if cls == "H2ORandomForestEstimator":
        assert m.summary()["max_depth"] == 20
        assert np.abs(card - cpu).max() < 1e-5
    else:
        assert abs(m.auc() - m_cpu.auc()) < 1e-3


@pytest.mark.gpu
def test_isolation_forest_on_the_card_matches_the_cpu(dev, HC):
    """An isolation forest with the same draws (a CPU generator's, moved
    to the card): the same trees (col and thr bit for bit: exact ranges,
    the same fused multiply-add; an empty leaf's threshold is NaN on
    both), scores within 1e-5."""
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.core.frame import Frame, Vec
    from h2o3_tpu_torch.models.tree import engine as E
    X, _ = _csv_cols(n=30000)
    res = {}
    for d in ("cpu", "cuda"):
        h2o.init(device=d)
        fr = Frame([f"x{j}" for j in range(6)],
                   [Vec.from_numpy(X[:, j]) for j in range(6)])
        m = h2o.H2OIsolationForestEstimator(ntrees=10, max_depth=8, seed=3)
        m._draws = lambda device: E.Draws(torch.Generator().manual_seed(3),
                                          device)
        m.train(training_frame=fr)
        res[d] = (m._trees.to("cpu"), m.predict(fr).to_numpy())
    (tc, pc), (tg, pg) = res["cpu"], res["cuda"]
    assert torch.equal(tg.col, tc.col)
    assert torch.allclose(tg.thr, tc.thr, rtol=0, atol=0, equal_nan=True)
    assert np.abs(pg - pc).max() < 1e-5


@pytest.mark.gpu
def test_glm_gram_in_f32_against_f64_on_the_card(dev):
    """The IRLS Gram (`glm._gram_pass`) on the card in f32, TF32 off as
    the port leaves it: G and q within 1e-5 of their largest entry of the
    same Gram in float64 on the card, at 200,000 rows x 29 columns."""
    from h2o3_tpu_torch.models import glm
    assert not torch.backends.cuda.matmul.allow_tf32
    g = torch.Generator(device=dev).manual_seed(3)
    X = torch.randn((200_000, 28), generator=g, device=dev)
    Xi = torch.cat([X, torch.ones((X.shape[0], 1), device=dev)], 1)
    w = torch.rand(X.shape[0], generator=g, device=dev) * 0.25
    z = torch.randn(X.shape[0], generator=g, device=dev)
    G, q = glm._gram_pass(Xi, w, z)
    G64, q64 = glm._gram_pass(Xi.double(), w.double(), z.double())
    assert (G.double() - G64).abs().max() <= 1e-5 * G64.abs().max()
    assert (q.double() - q64).abs().max() <= 1e-5 * q64.abs().max()


@pytest.mark.gpu
def test_one_hot_design_on_the_card_matches_the_cpu(dev):
    """The one-hot design matrix (NA and unseen levels, standardised,
    imputed, all three kinds of interaction) built on the card with the
    CPU codec's statistics equals the CPU's bit for bit (the same f32
    elementwise operations); the card's own statistics (float64 sums in
    another order) within 1e-12 of the CPU's."""
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.core.frame import Frame, Vec
    from h2o3_tpu_torch.models.model import DataInfo
    rng = np.random.default_rng(8)
    n = 5000
    a, b = rng.normal(size=(2, n))
    a[rng.random(n) < 0.05] = np.nan
    color = np.array(rng.choice(["r", "g", "b", "t"], n), object)
    color[rng.random(n) < 0.05] = None
    shade = np.array(rng.choice(["d", "l"], n), object)
    test_color = color.copy()
    test_color[::7] = "unseen"
    names = ["a", "b", "color", "shade"]
    out, infos = {}, {}
    for d in ("cpu", "cuda"):
        h2o.init(device=d)
        tr = Frame(names, [Vec.from_numpy(a), Vec.from_numpy(b),
                           Vec.from_numpy(color), Vec.from_numpy(shade)])
        te = Frame(names, [Vec.from_numpy(a), Vec.from_numpy(b),
                           Vec.from_numpy(test_color), Vec.from_numpy(shade)])
        infos[d] = DataInfo.from_frame(tr, names, None, cat_mode="onehot",
                                       standardize=True, interactions=names)
        di = infos["cpu"]
        out[d] = (di.matrix(tr).cpu(), di.matrix(te).cpu())
    for cpu, card in zip(out["cpu"], out["cuda"]):
        assert torch.equal(cpu, card)
    for k, v in infos["cpu"].means.items():
        assert abs(infos["cuda"].means[k] - v) <= 1e-12 * max(abs(v), 1.0)
        assert abs(infos["cuda"].sigmas[k] - infos["cpu"].sigmas[k]) \
            <= 1e-12 * infos["cpu"].sigmas[k]


def _unsup_frame(h2o, d, n=20_000, seed=9):
    """A seeded frame on device `d`: 6 numeric columns around 4 centres,
    3% NA, a 0/1 label from the first two."""
    from h2o3_tpu_torch.core.frame import Frame, Vec
    h2o.init(device=d)
    rng = np.random.default_rng(seed)
    X = rng.normal(0, 3, (4, 6))[rng.integers(0, 4, n)] \
        + rng.normal(size=(n, 6))
    y = (X[:, 0] - X[:, 1] + rng.logistic(size=n) > 0).astype(float)
    X[rng.random(X.shape) < 0.03] = np.nan
    names = [f"x{j}" for j in range(6)]
    return Frame(names + ["y"], [Vec.from_numpy(X[:, j]) for j in range(6)]
                 + [Vec.from_numpy(y.astype(int).astype(str))]), names


@pytest.mark.gpu
def test_deeplearning_on_the_card_matches_the_cpu(dev):
    """DL binomial (hidden [64, 64], 2 epochs) with the same draws (made
    on the CPU, moved to the card): probabilities within 1e-3 of the
    CPU's (f32 sums in another order over 156 steps); a second training
    on the card gives the same weights bit for bit."""
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.models import deeplearning as DL
    out = {}
    for d in ("cpu", "cuda", "cuda"):
        fr, xs = _unsup_frame(h2o, d)
        m = h2o.H2ODeepLearningEstimator(hidden=[64, 64], epochs=2.0, seed=4)
        m._draws = lambda device: DL.Draws(torch.Generator().manual_seed(4),
                                           device)
        m.train(x=xs, y="y", training_frame=fr)
        p = m._score_matrix(m._dinfo.matrix(fr))[:, 1].cpu()
        out.setdefault(d, []).append((p, [t.cpu() for t in
                                          m._net.parameters()]))
    (pc, _), = out["cpu"]
    (p1, w1), (p2, w2) = out["cuda"]
    assert (p1 - pc).abs().max() <= 1e-3
    assert torch.equal(p1, p2)
    assert all(torch.equal(a, b) for a, b in zip(w1, w2))


@pytest.mark.gpu
def test_kmeans_on_the_card_matches_the_cpu(dev):
    """KMeans k 4 (Furthest, standardised): centroids within 1e-4 of the
    CPU's; a second training on the card bit for bit (fixed-point
    sums)."""
    import h2o3_tpu_torch as h2o
    cents = {}
    for d in ("cpu", "cuda", "cuda"):
        fr, xs = _unsup_frame(h2o, d)
        m = h2o.H2OKMeansEstimator(k=4, seed=2)
        m.train(x=xs, training_frame=fr)
        cents.setdefault(d, []).append(m._centroids.cpu())
    (c,), (g1, g2) = cents["cpu"], cents["cuda"]
    assert (g1 - c).abs().max() <= 1e-4
    assert torch.equal(g1, g2)


@pytest.mark.gpu
def test_pca_svd_glrm_on_the_card_match_the_cpu(dev):
    """PCA (STANDARDIZE) eigenvalues and SVD's d within 1e-5 relative of
    the CPU's (f32 Grams summed in another order, TF32 off), their
    rotations within 1e-4 up to sign; GLRM k 3 objectives within 1e-4
    relative, iteration for iteration."""
    import h2o3_tpu_torch as h2o
    assert not torch.backends.cuda.matmul.allow_tf32
    res = {}
    for d in ("cpu", "cuda"):
        fr, xs = _unsup_frame(h2o, d)
        pca = h2o.H2OPrincipalComponentAnalysisEstimator(
            k=3, transform="STANDARDIZE")
        pca.train(x=xs, training_frame=fr)
        svd = h2o.H2OSingularValueDecompositionEstimator(nv=3)
        svd.train(x=xs, training_frame=fr)
        glrm = h2o.H2OGeneralizedLowRankEstimator(k=3, seed=1)
        glrm.train(x=xs, training_frame=fr)
        res[d] = (np.asarray(pca.summary()["std_deviation"]), pca.rotation(),
                  svd.d(), svd.v(),
                  np.asarray([h["objective"]
                              for h in glrm.scoring_history()]))
    (ps, pr, sd, sv, go), (qs, qr, td, tv, ho) = res["cpu"], res["cuda"]
    assert np.abs(ps - qs).max() <= 1e-5 * ps.max()
    assert np.abs(sd - td).max() <= 1e-5 * sd.max()
    assert np.abs(pr - qr).max() <= 1e-4
    assert np.abs(sv - tv * np.sign((sv * tv).sum(0))).max() <= 1e-4
    assert len(go) == len(ho) and np.abs(go - ho).max() <= 1e-4 * go.max()


# ---------------------------------------------------------------------------
# The models on ported estimators (plain PyTorch, no kernel of ops/csrc)
@pytest.mark.gpu
def test_aggregator_batched_admission_on_the_card_matches_plain(dev):
    """The aggregator's batched admission on the card (batches of 4096 and
    of 7) against the plain row-by-row walk on the CPU, on the same f32
    rows: the same exemplar rows and counts, exactly (the distances are
    the same column-by-column f32 sums on both)."""
    from h2o3_tpu_torch.models import aggregator as A
    rng = np.random.default_rng(120)
    X = rng.normal(size=(6000, 6)).astype(np.float32)
    X[3000:] *= 0.25
    Xc = torch.from_numpy(X)
    for radius in (1.0, 2.5):
        pex, pcnt = A._sweep_plain(Xc, radius)
        for batch in (4096, 7):
            ex, cnt = A._sweep(Xc.to(dev), radius, batch=batch)
            assert torch.equal(ex.cpu(), pex) and torch.equal(cnt.cpu(), pcnt)


@pytest.mark.gpu
def test_extended_isolation_forest_on_the_card_matches_the_cpu(dev):
    """An extended isolation forest (extension_level 0 and C-1) with the
    same draws (the CPU generator's, moved to the card): mean lengths
    within 1e-5 of the CPU's."""
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.core.frame import Frame, Vec
    from h2o3_tpu_torch.models import extended_isofor as EIF
    from h2o3_tpu_torch.models.tree import engine as E
    rng = np.random.default_rng(121)
    X = rng.normal(size=(10000, 8))
    X[-100:, :3] += 3.0
    saved = EIF.H2OExtendedIsolationForestEstimator._draws
    try:
        EIF.H2OExtendedIsolationForestEstimator._draws = (
            lambda self, device: E.Draws(torch.Generator().manual_seed(5),
                                         device))
        for ext in (0, 7):
            out = {}
            for d in ("cpu", "cuda"):
                h2o.init(device=d)
                fr = Frame([f"x{j}" for j in range(8)],
                           [Vec.from_numpy(X[:, j]) for j in range(8)])
                m = h2o.H2OExtendedIsolationForestEstimator(
                    ntrees=20, extension_level=ext, seed=1)
                m.train(training_frame=fr)
                out[d] = m.predict(fr).to_numpy()[:, 1]
            assert np.abs(out["cuda"] - out["cpu"]).max() <= 1e-5
    finally:
        EIF.H2OExtendedIsolationForestEstimator._draws = saved


# ---------------------------------------------------------------------------
# The frame data plane on the card: prefetch copies on a side stream, the
# spill ladder of CUDA planes, GLM's sparse path against the CPU.
@pytest.fixture()
def pager_state(tmp_path):
    """The pager's budgets and ice root, restored after the test."""
    from h2o3_tpu_torch.core import tiering
    from h2o3_tpu_torch.core.memory import MANAGER
    P = tiering.PAGER
    saved = (P.hbm_budget, P.host_budget, MANAGER.ice_root)
    MANAGER.ice_root = str(tmp_path)
    yield P
    P.hbm_budget, P.host_budget, MANAGER.ice_root = saved


@pytest.mark.gpu
def test_prefetch_on_a_side_stream_gives_the_same_bits(dev, pager_state):
    """Frame.matrix of a frame demoted to host memory, with the next two
    columns promoted on the side stream while a long kernel keeps the
    consumer's stream busy: the same bits as without prefetch and as the
    host columns, round after round (a consumer that read a half-copied
    plane would differ)."""
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.core import tiering
    from h2o3_tpu_torch.core.frame import Frame, Vec
    from h2o3_tpu_torch.parallel import mrtask
    P = pager_state
    h2o.init()
    rng = np.random.default_rng(131)
    n, k = 1 << 21, 12
    X = rng.normal(size=(n, k)).astype(np.float32)
    fr = Frame([f"x{j}" for j in range(k)],
               [Vec.from_numpy(X[:, j]) for j in range(k)])
    chunks = [v._chunk for v in fr.vecs]
    P.hbm_budget = sum(c.nbytes for c in chunks) // 3
    big = torch.randn(4096, 4096, device=dev)
    saved = mrtask.prefetch_chunks
    try:
        for rnd in range(3):
            got = {}
            for label in ("on", "off"):
                for c in chunks:
                    P.demote(c, tiering.TIER_HOST)
                fr._matrix_cache.clear()
                if label == "off":
                    mrtask.prefetch_chunks = lambda handles: None
                big @ big                      # keep the stream busy
                got[label] = fr.matrix().cpu().numpy()
                mrtask.prefetch_chunks = saved
            assert np.array_equal(got["on"], got["off"]), rnd
            assert np.array_equal(got["on"], X), rnd
        assert P.stats()["prefetch_requests"] > 0
    finally:
        mrtask.prefetch_chunks = saved
        P.hbm_budget = 0


@pytest.mark.gpu
def test_spill_ladder_of_cuda_planes_is_bit_exact(dev, pager_state):
    """Every codec's planes and both SparseVec nz planes: card, host,
    disk and back to the card, bit for bit and on the card."""
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.core import tiering
    from h2o3_tpu_torch.core.frame import Frame, SparseVec
    P = pager_state
    h2o.init()
    i = np.arange(4096, dtype=np.float64)
    fr = Frame.from_dict({
        "const": np.full(4096, 7.0), "i8": np.where(i % 11 == 0, np.nan,
                                                    i % 100),
        "i16": i * 3.0, "i32": i * 70000.0,
        "f32": np.random.default_rng(5).normal(size=4096)})
    sv = SparseVec(np.arange(0, 4096, 7), np.linspace(-1, 1, 586), 4096)
    chunks = [v._chunk for v in fr.vecs] + [sv._nzr_chunk, sv._nzv_chunk]
    before = [[None if t is None else t.clone() for t in c.device()]
              for c in chunks]
    for to in (tiering.TIER_HOST, tiering.TIER_DISK):
        for c in chunks:
            P.demote(c, to)
        assert all(c.tier == to for c in chunks)
    for c, b in zip(chunks, before):
        got = c.device()
        assert c.tier == "hbm"
        for t, u in zip(got, b):
            assert (t is None) == (u is None)
            if t is not None:
                assert t.device.type == "cuda" and t.dtype == u.dtype
                assert torch.equal(t, u)


@pytest.mark.gpu
def test_sparse_glm_on_the_card_matches_the_cpu(dev):
    """GLM binomial on an all-sparse frame: two card fits bit for bit;
    the card's coefficients within 1e-4 of the largest of the CPU's and
    predict_sparse within 1e-5, the tolerances of chip_smoke.py's (al)
    slice (both sum in float64 in a fixed order, but not the same one,
    and L-BFGS carries the last bits to its stop: 8.8e-7 and 1.1e-6
    apart on the card)."""
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.core.frame import Frame, SparseVec, Vec
    rng = np.random.default_rng(141)
    n, C = 20000, 300
    cols = [np.sort(rng.choice(n, int(rng.integers(1, 2000)),
                               replace=False)) for _ in range(C)]
    vals = [rng.normal(size=len(r)).astype(np.float32) for r in cols]
    eta = np.zeros(n)
    for j in range(5):
        eta[cols[j]] += (2.0 - j) * vals[j]
    y = (rng.random(n) < 1 / (1 + np.exp(-eta))).astype(np.float64)
    out = {}
    for d in ("cpu", "cuda", "cuda"):
        h2o.init(device=d)
        fr = Frame(["y"] + [f"c{j}" for j in range(C)],
                   [Vec.from_numpy(y)] + [SparseVec(r, v, n)
                                          for r, v in zip(cols, vals)])
        m = h2o.H2OGeneralizedLinearEstimator(family="binomial",
                                              lambda_=1e-4, alpha=0.0)
        m.train(y="y", training_frame=fr)
        assert m._sparse_fit
        out.setdefault(d, []).append((m._state.beta, m.predict_sparse(fr)))
    (cb, cp), = out["cpu"]
    (g1, p1), (g2, p2) = out["cuda"]
    assert np.array_equal(g1, g2) and np.array_equal(p1, p2)
    assert np.abs(g1 - cb).max() <= 1e-4 * np.abs(cb).max()
    assert np.abs(p1 - cp).max() <= 1e-5


def _csv(path, n=3000, seed=151):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        f.write("a,b,c,y\n")
        for i in range(n):
            a = "NA" if i % 17 == 0 else f"{rng.normal():.6f}"
            c = ["x", "yy", "-0", "1234567.4", '"q""r"'][int(rng.integers(5))]
            f.write(f"{a},{rng.normal():.9g},{c},"
                    f"{'yes' if rng.random() < 0.4 else 'no'}\n")


@pytest.mark.gpu
def test_chunked_parse_on_the_card_matches_the_cpu(dev, tmp_path):
    """A CSV through the native tokenizer, whole and in many chunks on
    the pool: every plane on the card, the same codecs and bits as the
    CPU's parse, every byte counted by the native engine."""
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.io import dparse, fastcsv
    p = str(tmp_path / "m.csv")
    _csv(p)
    out = {}
    for d in ("cpu", "cuda"):
        h2o.init(device=d)
        fastcsv.reset_counts()
        frames = (h2o.import_file(p),
                  dparse.parse_files([p], chunk_bytes=4096, workers=4))
        assert fastcsv.TOKENIZED_BYTES["python"] == 0
        out[d] = [[(v.type, v.levels(), v.codec.kind,
                    v.as_f32().cpu().numpy().view(np.uint32).tolist())
                   for v in fr.vecs] for fr in frames]
        assert all(v.as_f32().device.type == d for fr in frames
                   for v in fr.vecs)
    assert out["cpu"] == out["cuda"]
    assert out["cuda"][0] == out["cuda"][1]


@pytest.mark.gpu
def test_model_saved_on_the_card_loads_on_the_cpu(dev, tmp_path):
    """A GBM trained on the card, saved, and loaded onto the card (the
    same predictions bit for bit) and onto the CPU (within 1e-5)."""
    import h2o3_tpu_torch as h2o
    p = str(tmp_path / "m.csv")
    _csv(p)
    h2o.init()
    fr = h2o.import_file(p)
    m = h2o.H2OGradientBoostingEstimator(ntrees=5, max_depth=4, seed=1)
    m.train(y="y", training_frame=fr)
    want = m.predict(fr).vecs[-1].as_f32()
    path = str(tmp_path / "gbm.bin")
    h2o.save_model(m, path)
    back = h2o.load_model(path)
    assert torch.equal(back.predict(fr).vecs[-1].as_f32().view(torch.int32),
                       want.view(torch.int32))
    h2o.init(device="cpu")
    cpu = h2o.load_model(path)
    got = cpu.predict(h2o.import_file(p)).vecs[-1].as_f32()
    assert got.device.type == "cpu"
    assert float((got - want.cpu()).abs().max()) <= 1e-5
    h2o.init()


@pytest.mark.gpu
def test_device_sort_ties_signed_zeros_on_the_card(dev):
    """A key of -0.0 and +0.0 (and a descending key, whose sign flip makes
    every 0 a -0.0) sorts on the card in the CPU's stable order, which is
    the JAX package's: the zeros tie and keep their rows' order. At 1M rows
    torch sorts on the card by radix over the float's bits."""
    from h2o3_tpu_torch.ops import device_sort as DS
    rng = np.random.default_rng(8)
    z = rng.integers(-2, 3, 1 << 20).astype(np.float32)
    zero = z == 0
    z[zero] = np.where(rng.random(int(zero.sum())) < 0.5, -0.0, 0.0)
    K = torch.from_numpy(z)[:, None]
    for sign in (1.0, -1.0):
        got = DS.lexsort_rows((K * sign).to(dev)).cpu()
        want = DS.lexsort_rows(K * sign)
        assert torch.equal(got, want)
        assert torch.equal(want, torch.from_numpy(
            np.lexsort([np.where(z * sign == 0, 0.0, z * sign)])))


@pytest.mark.gpu
def test_group_sums_bit_identical_twice_on_the_card(dev):
    """group_by_device's sums and means on the card: the same bits from
    two runs (exact fixed point), integer sums equal to numpy's."""
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.core.frame import Frame, Vec
    from h2o3_tpu_torch.ops import device_sort as DS
    h2o.init()
    rng = np.random.default_rng(9)
    n = 1 << 21
    k = rng.integers(0, 1000, n).astype(np.float32)
    v = rng.integers(1, 6, n).astype(np.float32)
    x = np.round(rng.uniform(0, 100, n), 6).astype(np.float32)
    fr = Frame(["k", "v", "x"], [Vec.from_tensor(torch.from_numpy(c)
                                                 .to(dev)) for c in (k, v, x)])
    aggs = [("sum", 1), ("sum", 2), ("mean", 2), ("sd", 2)]
    a = DS.group_by_device(fr, [0], aggs)[1]
    b = DS.group_by_device(fr, [0], aggs)[1]
    for c, d in zip(a, b):
        assert torch.equal(c.view(torch.int32), d.view(torch.int32))
    np.testing.assert_array_equal(
        a[1].cpu().numpy(), np.bincount(k.astype(int), weights=v))
    np.testing.assert_allclose(
        a[2].cpu().numpy(), np.bincount(k.astype(int), weights=x),
        rtol=1e-6)


def _higgs_like(dev, n, seed):
    """A small HIGGS-shaped frame on the card: 28 N(0,1) columns, the
    bench's logit, a 0/1 categorical response."""
    from h2o3_tpu_torch.core.frame import Frame, T_CAT, Vec
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    X = torch.randn((n, 28), generator=g, device=dev)
    logit = (1.2 * X[:, 0] - 0.8 * X[:, 1] + 0.6 * X[:, 2] * X[:, 3]
             + 0.4 * torch.sin(X[:, 4]) + 0.3 * X[:, 5] * X[:, 6])
    y = (torch.rand(n, generator=g, device=dev)
         < torch.sigmoid(logit)).float()
    vecs = [Vec.from_tensor(X[:, j].contiguous()) for j in range(28)]
    vecs.append(Vec.from_tensor(y, type=T_CAT, domain=["0", "1"]))
    return Frame([f"x{j}" for j in range(28)] + ["y"], vecs)


@pytest.mark.gpu
def test_export_import_on_the_card(dev, tmp_path):
    """Run (at) small: a GBM trained on the card to an H2O-3 MOJO and
    back through import_mojo; the imported trees route as the model's
    (col, thr, na_left bit for bit where the tree reaches), each leaf
    f32(value * learn_rate), the generic estimator's probabilities on the
    card within 1e-5 of predict; the native MOJO within 1e-5."""
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.genmodel.mojo import MojoModel
    h2o.init()
    fr = _higgs_like(dev, 20_000, 3)
    m = h2o.H2OGradientBoostingEstimator(ntrees=5, max_depth=5, nbins=64,
                                         seed=1, learn_rate=0.1)
    m.train(y="y", training_frame=fr)
    want = m.predict(fr).vec("p1").as_f32()
    g = h2o.import_mojo(m.download_mojo(str(tmp_path / "m.zip"),
                                        format="h2o3"))
    got = g.predict(fr)
    assert got.vec("p1").device.type == dev.type
    assert float((got.vec("p1").as_f32() - want).abs().max()) <= 1e-5
    imp, own = g._ref.trees_k[0], m._trees
    inner = own.col >= 0
    reach = torch.zeros_like(inner)
    reach[:, 0] = True
    for i in range(own.col.shape[1] // 2):
        reach[:, 2 * i + 1] |= reach[:, i] & inner[:, i]
        reach[:, 2 * i + 2] |= reach[:, i] & inner[:, i]
    node = reach & inner
    assert torch.equal(imp.col[reach], own.col[reach])
    assert torch.equal(imp.thr[node].view(torch.int32),
                       own.thr[node].view(torch.int32))
    assert torch.equal(imp.na_left[node], own.na_left[node])
    leaf = reach & ~inner
    assert torch.equal(imp.value[leaf], own.value[leaf]
                       * torch.tensor(0.1, dtype=torch.float32))
    mm = MojoModel.load(m.download_mojo(str(tmp_path / "n.zip")))
    X = m._dinfo.matrix(fr).cpu().double().numpy()
    p = mm.predict_matrix(X)["probs"][:, 1]
    assert np.abs(p - want.cpu().numpy()).max() <= 1e-5


@pytest.mark.gpu
def test_automl_on_the_card(dev):
    """Run (av) small: GLM and GBM steps with 2 folds on the card; the
    leaderboard sorted, the binned kernels launched, the best base model
    the same trees or coefficients when trained alone."""
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.automl.automl import _steps
    from h2o3_tpu_torch.ops import hist_cuda as HC
    h2o.init()
    fr = _higgs_like(dev, 20_000, 4)
    HC.reset_launches()
    aml = h2o.automl(include_algos=["GLM", "GBM"], max_models=2, nfolds=2,
                     seed=1, project_name="gpu_aml")
    aml.train(y="y", training_frame=fr)
    launches = dict(HC.LAUNCHES)
    assert launches["fused"] > 0 and launches["radix"] > 0
    rows = aml.leaderboard_obj.as_list()
    assert [r["auc"] for r in rows] == sorted((r["auc"] for r in rows),
                                              reverse=True)
    steps = {n: (c, p) for n, c, p in _steps(1)}
    for r, m in aml.leaderboard_obj.rows:
        if r["step"] not in steps:
            continue
        cls, params = steps[r["step"]]
        alone = cls(**{"seed": 1, **params}, nfolds=2,
                    keep_cross_validation_predictions=True)
        alone.train(y="y", training_frame=fr)
        if m.algo == "glm":
            assert np.array_equal(m._state.beta, alone._state.beta)
        else:
            assert torch.equal(m._trees.value, alone._trees.value)
            assert torch.equal(m._trees.col, alone._trees.col)


def _serving_models(dev):
    """A GBM, a GLM and a DL on a small HIGGS-like frame, and KMeans on
    its predictors: the four families of run (ax)."""
    import h2o3_tpu_torch as h2o
    h2o.init()
    fr = _higgs_like(dev, 20_000, 5)
    xs = [c for c in fr.names if c != "y"]
    gbm = h2o.H2OGradientBoostingEstimator(ntrees=10, max_depth=5, nbins=64,
                                           seed=1)
    glm = h2o.H2OGeneralizedLinearEstimator(family="binomial", lambda_=0.0)
    dl = h2o.H2ODeepLearningEstimator(hidden=[32, 32], epochs=1, seed=1)
    km = h2o.H2OKMeansEstimator(k=4, seed=1)
    for m in (gbm, glm, dl):
        m.train(y="y", training_frame=fr)
    km.train(x=xs, training_frame=fr)
    return fr, {"gbm": gbm, "glm": glm, "dl": dl, "km": km}


def _staged(m, fr, n):
    from h2o3_tpu_torch.core.kvstore import DKV
    from h2o3_tpu_torch.models.model import _subframe
    from h2o3_tpu_torch.serving import scorer_cache as SC
    sub = _subframe(fr, torch.arange(n, device=fr.vecs[0].device))
    raw = SC.stage_frame(m._dinfo, m._dinfo.adapt(sub), SC.row_bucket(n))
    DKV.remove(sub.key)
    return raw


@pytest.mark.gpu
def test_scorer_graph_captured_once_a_bucket_and_bit_for_bit(dev):
    """Run (ax) small: each bucket's first dispatch is one CUDA graph
    capture, later ones replay; a replay equals the eager scorer on the
    same padded buffer bit for bit, and the params are one copy."""
    from h2o3_tpu_torch import serving
    from h2o3_tpu_torch.obs import metrics as om
    from h2o3_tpu_torch.serving import scorer_cache as SC
    fr, models = _serving_models(dev)
    SC.CACHE.clear()
    for m in models.values():
        nbytes = set()
        for b in (128, 256, 1024):
            for i, n in enumerate((b // 2 + 1, b)):
                raw = _staged(m, fr, n)
                c0 = om.graph_capture_count()
                out = SC.score_rows(m, raw, n)
                assert om.graph_capture_count() - c0 == (1 if i == 0 else 0)
                prog = SC.CACHE.program(m, b)
                with torch.no_grad():
                    want = prog._fn(serving.PARAMS.placed(
                        m, SC.model_token(m)),
                        torch.from_numpy(raw).to(dev)).cpu().numpy()
                assert np.array_equal(out.view(np.uint8),
                                      want.view(np.uint8)), (m.algo, n)
                nbytes.add(serving.PARAMS.bytes_for(m.key))
        assert len(nbytes) == 1 and nbytes.pop() > 0


@pytest.mark.gpu
def test_scorer_recaptures_after_demote_and_promote(dev):
    """A demote then a promote re-places the params at new addresses: the
    next dispatch captures again (never replays against the freed copy)
    and answers bit for bit, from the host tier and from an npz."""
    from h2o3_tpu_torch import serving
    from h2o3_tpu_torch.obs import metrics as om
    from h2o3_tpu_torch.serving import params as SP
    from h2o3_tpu_torch.serving import scorer_cache as SC
    fr, models = _serving_models(dev)
    for m in models.values():
        raw = _staged(m, fr, 100)
        want = SC.score_rows(m, raw, 100)
        for tier in (SP.TIER_HOST, SP.TIER_DISK):
            serving.PARAMS.demote_key(m.key, tier)
            c0 = om.graph_capture_count()
            got = SC.score_rows(m, raw, 100)
            assert om.graph_capture_count() - c0 == 1
            assert np.array_equal(got.view(np.uint8), want.view(np.uint8))
            c0 = om.graph_capture_count()
            SC.score_rows(m, raw, 100)
            assert om.graph_capture_count() == c0


@pytest.mark.gpu
def test_scorer_threads_match_serial(dev):
    """4 threads score their own frames at once, through one model's
    programs and others': every answer equals its serial run's."""
    import threading
    from h2o3_tpu_torch.serving import scorer_cache as SC
    fr, models = _serving_models(dev)
    ms = list(models.values())
    jobs = [(ms[i % len(ms)], _staged(ms[i % len(ms)], fr, 200 + 50 * i),
             200 + 50 * i) for i in range(4)]
    serial = [SC.score_rows(m, raw, n) for m, raw, n in jobs]
    got = [None] * len(jobs)
    barrier = threading.Barrier(len(jobs))

    def work(i):
        m, raw, n = jobs[i]
        barrier.wait()
        got[i] = [SC.score_rows(m, raw, n) for _ in range(20)]
    ts = [threading.Thread(target=work, args=(i,)) for i in range(len(jobs))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in ts)
    for i, outs in enumerate(got):
        for o in outs:
            assert np.array_equal(o.view(np.uint8), serial[i].view(np.uint8))


@pytest.mark.gpu
def test_warm_dispatch_has_no_hidden_sync(dev):
    """A warm dispatch runs under set_sync_debug_mode("error"): its only
    wait is the event before the host reads the pinned output."""
    from h2o3_tpu_torch.serving import scorer_cache as SC
    fr, models = _serving_models(dev)
    for m in models.values():
        raw = _staged(m, fr, 1)
        SC.score_rows(m, raw, 1)
        torch.cuda.set_sync_debug_mode("error")
        try:
            SC.score_rows(m, raw, 1)
        finally:
            torch.cuda.set_sync_debug_mode(0)


def _rows_of(m, fr, n_total=256):
    """The first n_total rows of `fr` staged for `m` (host, unpadded)."""
    return _staged(m, fr, n_total)[:n_total]


def _alone(m, raw):
    from h2o3_tpu_torch.serving import scorer_cache as SC
    n = raw.shape[0]
    buf = np.full((SC.row_bucket(n), raw.shape[1]), np.nan, np.float32)
    buf[:n] = raw
    return SC.score_rows(m, buf, n)[:n]


def _threads(fn, args, timeout=120):
    import threading
    barrier = threading.Barrier(len(args))
    out = [None] * len(args)

    def run(i):
        barrier.wait()
        try:
            out[i] = fn(*args[i])
        except Exception as e:      # noqa: BLE001 — returned to the test
            import traceback
            e.args = (*e.args, traceback.format_exc())
            out[i] = e
    ts = [threading.Thread(target=run, args=(i,)) for i in range(len(args))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=timeout)
    assert not any(t.is_alive() for t in ts)
    return out


@pytest.mark.gpu
def test_coalesced_dispatch_equals_separate_dispatches(dev, monkeypatch):
    """Run (ay) small: requests of 1, 8 and 64 rows that coalesce into one
    dispatch (one replay of the bucket holding all their rows) get the
    rows each scored alone gets: the GBM and KMeans bit for bit, GLM and
    DL within 1e-6 (cuBLAS may pick another algorithm at another M)."""
    from h2o3_tpu_torch.serving import microbatch as mb
    monkeypatch.setenv("H2O3_SCORE_LINGER_MS", "300")
    fr, models = _serving_models(dev)
    sizes = [1, 8, 64, 1, 8, 1, 64, 3]
    for tag, m in models.items():
        rows = _rows_of(m, fr)
        offs = np.cumsum([0] + sizes[:-1])
        raws = [rows[o:o + k] for o, k in zip(offs, sizes)]
        want = [_alone(m, r) for r in raws]
        d0 = mb.DISPATCHES.value()
        got = _threads(lambda r: mb.BATCHER.score(m, r, r.shape[0]),
                       [(r,) for r in raws])
        assert mb.DISPATCHES.value() - d0 == 1, tag
        for g, w in zip(got, want):
            assert not isinstance(g, Exception), g
            if tag in ("gbm", "km"):
                assert np.array_equal(np.ascontiguousarray(g).view(np.uint8),
                                      np.ascontiguousarray(w).view(np.uint8))
            else:
                assert np.abs(g.astype(np.float64) - w).max() <= 1e-6, tag


@pytest.mark.gpu
def test_capture_concurrent_with_replays_under_the_fair_gate(dev,
                                                             monkeypatch):
    """H2O3_QOS_MAX_INFLIGHT=4: coalesced dispatches of the four models
    replay on several threads while another thread demotes their params
    again and again, so leaders capture again while others replay. With
    lockdep raising: no error, no inversion, every answer its serial
    one's, and recaptures happened."""
    import threading
    import time
    from h2o3_tpu_torch import serving
    from h2o3_tpu_torch.analysis import lockdep
    from h2o3_tpu_torch.obs import metrics as om
    from h2o3_tpu_torch.serving import microbatch as mb
    from h2o3_tpu_torch.serving import params as SP
    monkeypatch.setenv("H2O3_QOS_MAX_INFLIGHT", "4")
    monkeypatch.setenv("H2O3_SCORE_LINGER_MS", "1")
    fr, models = _serving_models(dev)
    tags = list(models)
    rows = {t: _rows_of(models[t], fr) for t in tags}
    work = []
    for i in range(12):
        t = tags[i % len(tags)]
        k = (1, 8, 64)[i % 3]
        work.append((t, rows[t][i:i + k]))
    want = [_alone(models[t], r) for t, r in work]
    c0 = om.graph_capture_count()
    stop = []

    def churn():
        while not stop:
            for m in models.values():
                serving.PARAMS.demote_key(m.key, SP.TIER_HOST)
            time.sleep(0.005)

    ch = threading.Thread(target=churn, daemon=True)
    lockdep.reset()
    lockdep.enable("raise")
    try:
        ch.start()
        got = _threads(
            lambda t, r: [mb.BATCHER.score(models[t], r, r.shape[0])
                          for _ in range(15)],
            work)
    finally:
        stop.append(1)
        ch.join(timeout=30)
        lockdep.disable()
    assert lockdep.counts()["inversions"] == 0
    for (t, _), outs, w in zip(work, got, want):
        assert not isinstance(outs, Exception), outs
        for o in outs:
            assert np.abs(o.astype(np.float64) - w).max() <= \
                (0.0 if t in ("gbm", "km") else 1e-6), t
    assert om.graph_capture_count() - c0 > len(models)


@pytest.mark.gpu
def test_card_side_baseline_counts_equal_numpy(dev):
    """The drift baseline binned on the card (bucketize against the f64
    edges, bincount) equals the numpy path on the same rows exactly, and
    a train() on a frame in HBM stamps that profile."""
    import types
    from h2o3_tpu_torch.core.kvstore import DKV
    from h2o3_tpu_torch.obs import modelmon
    from h2o3_tpu_torch.serving import scorer_cache as SC
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    n = 300_000
    X = torch.randn((n, 5), generator=g, device=dev)
    X[::37, 0] = float("nan")
    X[::101, 1] = float("inf")
    X[:, 2] = torch.round(X[:, 2] * 4)             # ties
    X[:, 3] = torch.floor(torch.rand(n, generator=g, device=dev) * 12)
    X[::53, 3] = float("nan")
    di = types.SimpleNamespace(
        raw_columns=lambda: ["a", "b", "c", "k", "d"], cat_cols=["k"],
        cardinalities={"k": 10}, domains={"k": [str(i) for i in range(10)]},
        response_domain=None)
    got = modelmon.build_baseline(di, X, None)
    want = modelmon.build_baseline(di, X.cpu().numpy(), None)
    for a, b in zip(got.counts, want.counts):
        assert a.tolist() == b.tolist()
    assert got.na.tolist() == want.na.tolist()
    for fa, fb in zip(got.features, want.features):
        assert fa.keys() == fb.keys()
        if "edges" in fa:
            assert fa["edges"].tobytes() == fb["edges"].tobytes()
    # earlier tests' models may fill H2O3_MODELMON_MAX_MODELS
    modelmon.reset()
    fr, models = _serving_models(dev)
    m = models["glm"]
    prof = DKV.get(modelmon.monitor_key(m.key))
    raw = SC.stage_frame(m._dinfo, m._dinfo.adapt(fr), fr.nrows)
    host = modelmon.build_baseline(m._dinfo, raw, None)
    assert [c.tolist() for c in prof.counts] == \
        [c.tolist() for c in host.counts]


@pytest.mark.gpu
def test_stage_split_adds_no_sync(dev):
    """The device/readback split of a warm dispatch comes from CUDA events
    read after the program's one event wait: a warm score_rows — and a
    micro-batched request — under set_sync_debug_mode("error") records
    both stages and synchronises nothing else."""
    from h2o3_tpu_torch.obs import usage
    from h2o3_tpu_torch.serving import microbatch as mb
    from h2o3_tpu_torch.serving import scorer_cache as SC
    fr, models = _serving_models(dev)
    for m in models.values():
        raw = _staged(m, fr, 1)
        SC.score_rows(m, raw, 1)
        mb.BATCHER.score(m, raw[:1], 1)
        torch.cuda.set_sync_debug_mode("error")
        try:
            with usage.capture_stages() as cap:
                SC.score_rows(m, raw, 1)
            usage.begin_request()
            mb.BATCHER.score(m, raw[:1], 1)
            st = usage.finish_request()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert cap["device"] > 0 and cap["readback"] > 0
        assert {"queue", "gate", "device", "readback"} <= set(st)


@pytest.mark.gpu
def test_stage_split_of_capturing_and_eager_dispatches(dev, monkeypatch):
    """A dispatch that captures reports the replay alone as `device` (the
    capture's host time is not device time); a one-shot placement's eager
    dispatch times device and readback with CUDA events, and its answer
    equals the graph's."""
    from h2o3_tpu_torch.obs import usage
    from h2o3_tpu_torch.serving import scorer_cache as SC
    fr, models = _serving_models(dev)
    eager_models = 0
    for m in models.values():
        n = 3000                    # a bucket no other test of m captured
        raw = _staged(m, fr, n)
        c0 = SC.CAPTURE_SECONDS.snapshot()
        with usage.capture_stages() as cap:
            graph = SC.score_rows(m, raw, n)
        c1 = SC.CAPTURE_SECONDS.snapshot()
        assert c1["count"] == c0["count"] + 1
        assert 0 < cap["device"] < c1["sum"] - c0["sum"]
        prog = next(p for p in SC.CACHE.programs(m.key)
                    if p.bucket == raw.shape[0])
        if not prog.shares_params:
            continue
        eager_models += 1
        params, _, _ = prog._params()
        # a one-shot placement: the program scores eagerly
        with monkeypatch.context() as mp:
            mp.setattr(SC._Program, "_params",
                       lambda self: (params, None, 0))
            with usage.capture_stages() as cap:
                eager = prog(raw)
        assert cap["device"] > 0 and cap["readback"] > 0
        np.testing.assert_allclose(eager[:n], graph[:n], rtol=0, atol=1e-6)
    assert eager_models > 0


# ---------------------------------------------------------------------------
# runs (bb)-(bd) small: the REST server on the card
def _rest(port, method, path, body=None, headers=None):
    import http.client
    import json
    hdrs = dict(headers or {})
    if body is not None:
        body = json.dumps(body).encode()
        hdrs["Content-Type"] = "application/json"
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    c.request(method, path, body=body, headers=hdrs)
    r = c.getresponse()
    raw = r.read()
    c.close()
    return r.status, json.loads(raw) if raw else None


def _rest_job(port, key):
    import time
    while True:
        st, js = _rest(port, "GET", f"/3/Jobs/{key}")
        assert st == 200, js
        if js["jobs"][0]["status"] != "RUNNING":
            assert js["jobs"][0]["status"] == "DONE", js
            return
        time.sleep(0.02)


@pytest.mark.gpu
def test_rest_server_on_the_card(dev, tmp_path):
    """Runs (bb)-(bd) small: the server names the card and torch/cuda; a
    GBM built over REST (form-encoded parameters) has train()'s trees
    bit for bit; row predictions equal score_payload's bit for bit; the
    profiler's kind "auto" takes torch.profiler and its trace holds the
    binned kernels as CUDA kernel events."""
    import json
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch import serving
    from h2o3_tpu_torch.api.server import H2OServer
    h2o.init()
    fr = _higgs_like(dev, 20_000, 5)
    srv = H2OServer(port=0).start()
    try:
        st, cl = _rest(srv.port, "GET", "/3/Cloud")
        assert st == 200
        assert cl["nodes"][0]["h2o"] == torch.cuda.get_device_name(0)
        st, ab = _rest(srv.port, "GET", "/3/About")
        assert {"name": "Backend", "value": "torch/cuda"} in ab["entries"]
        st, p = _rest(srv.port, "POST", "/3/Profiler",
                      body={"action": "start", "kind": "auto",
                            "trace_dir": str(tmp_path)})
        assert st == 200 and p["kind"] == "torch", p
        kw = dict(ntrees=3, max_depth=8, nbins=255, seed=1)
        st, b = _rest(srv.port, "POST", "/3/ModelBuilders/gbm",
                      body=dict({k: str(v) for k, v in kw.items()},
                                training_frame=fr.key, response_column="y",
                                model_id="gpu_rest_gbm"))
        assert st == 200, b
        _rest_job(srv.port, b["job"]["key"])
        st, p = _rest(srv.port, "POST", "/3/Profiler",
                      body={"action": "stop"})
        assert st == 200 and "trace" in p, p
        names = {e.get("name", "") for e in json.load(
            open(p["trace"]))["traceEvents"] if e.get("cat") == "kernel"}
        for k in ("fused_kernel", "radix_kernel", "route_kernel"):
            assert any(k in n for n in names), (k, sorted(names)[:20])
        m = h2o.get_model("gpu_rest_gbm")
        ref = h2o.H2OGradientBoostingEstimator(**kw)
        ref.train(y="y", training_frame=fr)
        for f in ("col", "thr", "na_left", "value"):
            assert torch.equal(getattr(m._trees, f), getattr(ref._trees, f))
        xs = [c for c in fr.names if c != "y"]
        rows = [dict(zip(xs, map(float, r))) for r in
                fr.matrix(xs)[:9].cpu().numpy()]
        st, pr = _rest(srv.port, "POST", f"/3/Predictions/models/{m.key}",
                       body={"rows": rows})
        assert st == 200, pr
        assert pr["predictions"] == serving.score_payload(m, rows)
    finally:
        srv.stop()


@pytest.mark.gpu
def test_rest_warm_predict_under_the_transfer_guard(dev, monkeypatch):
    """Run (bd) small: a server started with H2O3_TRANSFER_GUARD=disallow
    (torch's sync debug mode "error", process-wide) answers warm one-row
    predicts; an .item() on a card tensor raises meanwhile."""
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.api.server import H2OServer
    fr, models = _serving_models(dev)
    xs = [c for c in fr.names if c != "y"]
    row = [dict(zip(xs, map(float, fr.matrix(xs)[0].cpu().numpy())))]
    gbm = models["gbm"]
    h2o.DKV.put(gbm.key, gbm)
    warm = H2OServer(port=0).start()
    try:
        st, _ = _rest(warm.port, "POST", f"/3/Predictions/models/{gbm.key}",
                      body={"rows": row})
        assert st == 200
    finally:
        warm.stop()
    monkeypatch.setenv("H2O3_TRANSFER_GUARD", "disallow")
    srv = H2OServer(port=0).start()
    try:
        assert torch.cuda.get_sync_debug_mode() == 2
        for _ in range(10):
            st, js = _rest(srv.port, "POST",
                           f"/3/Predictions/models/{gbm.key}",
                           body={"rows": row})
            assert st == 200, js
        with pytest.raises(RuntimeError):
            torch.ones(1, device=dev).sum().item()
    finally:
        torch.cuda.set_sync_debug_mode(0)
        srv.stop()


@pytest.mark.gpu
@pytest.mark.parametrize("argv", [["-m", "h2o3_tpu_torch.api.server"],
                                  ["-m", "h2o3_tpu_torch", "-port"]])
def test_server_entry_points_serve_on_the_card(dev, argv):
    """`python -m h2o3_tpu_torch.api.server <port>` and `python -m
    h2o3_tpu_torch -port <port>` form the cloud on the card and serve
    /3/Cloud until stopped."""
    import socket
    import subprocess
    import sys
    import time
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    p = subprocess.Popen([sys.executable, *argv, str(port)])
    try:
        deadline = time.monotonic() + 120
        while True:
            assert p.poll() is None, p.returncode
            try:
                st, cl = _rest(port, "GET", "/3/Cloud")
                break
            except OSError:
                assert time.monotonic() < deadline
                time.sleep(0.5)
        assert st == 200
        assert cl["nodes"][0]["h2o"] == torch.cuda.get_device_name(0)
    finally:
        p.terminate()
        p.wait(timeout=60)

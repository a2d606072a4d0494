"""The port's route and histogram passes against the JAX package's.

On the CPU the port's wrappers run their plain PyTorch versions and the JAX
package runs its XLA twins (`sbh_route_xla`, `sbh_hist_xla`, and
`sbh_route_hist` as the sequential pair), since Pallas only runs on a TPU.
Inputs are made from a seed with numpy and handed to both. Tolerances:
routed heap ids are bit-identical (integer arithmetic); the margin update
within 1e-5 (one f32 multiply-add); f32 histograms within 1e-4 of each stat
row's largest magnitude (f32 sums in another order); histograms of int32
stats (the int8 path) exactly equal (integer sums). The dispatch gates are
held against the JAX package's shape gates, with its probe forced on.

The CUDA kernels themselves are held against these plain versions on a
card by tests/test_torch_gpu.py and chip_smoke.py.
"""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h2o3_tpu.ops import hist_pallas as HP
from h2o3_tpu.ops.parity import _route_tables
from h2o3_tpu_torch.ops import hist_cuda as HC

HIST_RTOL = 1e-4
F_ATOL = 1e-5


def _codes_heap_stats(seed, *, n_pad=4096, c_pad=16, b_val=64, L=8):
    """uint8 codes with NA codes, a heap spread over the level's leaves
    plus rows of other levels, and stats with row 3 zero."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, b_val, (c_pad, n_pad)).astype(np.uint8)
    codes[rng.random((c_pad, n_pad)) < 0.05] = b_val
    base = L - 1
    heap = rng.integers(base, base + L, n_pad).astype(np.int32)
    heap[rng.random(n_pad) < 0.1] = max(0, base - 1)     # frozen rows
    stats = rng.normal(0, 1, (HP.S_STATS, n_pad)).astype(np.float32)
    stats[3] = 0.0
    return codes, heap, stats, base


def _hist_rel_err(got, want):
    """max |got - want| over each stat row, over that row's max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    errs = []
    for s in range(HP.S_STATS):
        scale = max(np.abs(want[:, :, s]).max(), 1e-30)
        errs.append(np.abs(got[:, :, s] - want[:, :, s]).max() / scale)
    return max(errs)


@pytest.mark.parametrize("emit_f", [False, True])
@pytest.mark.parametrize("any_cat", [True, False])
def test_route_matches_jax(any_cat, emit_f):
    L, n_bins, b_val = 8, 128, 64
    codes, heap, _, base = _codes_heap_stats(3, L=L, b_val=b_val)
    rng = np.random.default_rng(4)
    tbl, route_cat, route_num = (np.array(a) for a in _route_tables(
        rng, L, n_bins, b_val, codes.shape[0]))
    route_f = route_cat if any_cat else route_num
    valtab = np.concatenate([rng.normal(0, 1, (1, 128)),
                             np.zeros((7, 128))]).astype(np.float32)
    F = rng.normal(0, 1, codes.shape[1]).astype(np.float32)
    kw = dict(base=base, L=L, eta=0.1, emit_f=emit_f)
    h_x, f_x = HP.sbh_route_xla(
        jnp.asarray(codes), jnp.asarray(heap), jnp.asarray(tbl),
        jnp.asarray(route_f), jnp.asarray(valtab), jnp.asarray(F),
        any_cat=any_cat, na_code=b_val, **kw)
    h_t, f_t = HC.sbh_route(
        torch.from_numpy(codes), torch.from_numpy(heap),
        torch.from_numpy(tbl), torch.from_numpy(route_f),
        torch.from_numpy(valtab), torch.from_numpy(F), **kw)
    assert h_t.dtype == torch.int32
    np.testing.assert_array_equal(h_t.numpy(), np.asarray(h_x))
    assert (h_t.numpy() != heap).any()             # some rows did move
    if emit_f:
        assert np.abs(f_t.numpy() - np.asarray(f_x)).max() < F_ATOL
    else:
        assert f_t is None


@pytest.mark.parametrize("half", [False, True])
@pytest.mark.parametrize("L", [1, 2, 8, 128])
def test_hist_matches_jax(L, half):
    n_bins, b_val = 128, 64
    codes, heap, stats, base = _codes_heap_stats(5 + L, L=L, b_val=b_val)
    want = np.asarray(HP.sbh_hist_xla(
        jnp.asarray(codes), jnp.asarray(heap), jnp.asarray(stats),
        base=base, L=L, n_bins=n_bins, half=half))
    got = HC.sbh_hist(torch.from_numpy(codes), torch.from_numpy(heap),
                      torch.from_numpy(stats), base=base, L=L,
                      n_bins=n_bins, half=half)
    assert tuple(got.shape) == want.shape
    _, _, npass, L_pad = HC.hist_layout(L, half)
    assert got.shape[0] == L_pad
    if L == 128 and not half:
        assert npass == 2                          # two 64-leaf windows
    assert not got[:, :, 3].any()                  # spare stat row stays 0
    assert _hist_rel_err(got.numpy(), want) <= HIST_RTOL


def test_wrappers_refuse_other_devices():
    codes = torch.zeros((8, 512), dtype=torch.uint8, device="meta")
    heap = torch.zeros(512, dtype=torch.int32, device="meta")
    stats = torch.zeros((4, 512), device="meta")
    with pytest.raises(ValueError, match="no route/hist implementation"):
        HC.sbh_hist(codes, heap, stats, base=0, L=1, n_bins=128)


def test_kernel_source_notes_and_entry_points():
    """Each kernel carries its note (the TPU kernel it replaces and what
    bounds it) and the C entry points the wrappers bind exist."""
    src = (pathlib.Path(HC.__file__).parent / "csrc" / "hist.cu").read_text()
    for needle in ("replaces hist_pallas.py sbh_route_pallas",
                   "replaces hist_pallas.py sbh_hist_pallas",
                   "sbh_hist_pallas_i8",
                   "replaces hist_pallas.py sbh_hist_radix",
                   "replaces hist_pallas.py\n// sbh_route_hist_fused_pallas",
                   "Bound: bytes", "int h2o3_route(", "int h2o3_hist(",
                   "int h2o3_radix(", "int h2o3_fused(",
                   "cudaGetLastError()"):
        assert needle in src
    tree = ast.parse(pathlib.Path(HC.__file__).read_text())
    names = {n.name for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)}
    assert {"sbh_route", "sbh_route_plain", "sbh_hist", "sbh_hist_plain",
            "sbh_hist_dense", "sbh_hist_i8", "sbh_hist_radix",
            "sbh_route_hist_fused", "sbh_route_hist_plain",
            "sbh_route_hist"} <= names


def _i8_stats(stats):
    """int32 stats in [-127, 127], quantized as the grower does."""
    absmax = np.abs(stats).max(axis=1, keepdims=True)
    q = np.round(stats * (127.0 / np.maximum(absmax, 1e-30)))
    return np.clip(q, -127, 127).astype(np.int32)


@pytest.mark.parametrize("half", [False, True])
@pytest.mark.parametrize("L", [1, 8, 64, 128])
def test_hist_i8_exact(L, half):
    n_bins, b_val = 128, 64
    codes, heap, stats, base = _codes_heap_stats(30 + L, L=L, b_val=b_val)
    st = _i8_stats(stats)
    want = np.asarray(HP.sbh_hist_xla(
        jnp.asarray(codes), jnp.asarray(heap), jnp.asarray(st),
        base=base, L=L, n_bins=n_bins, half=half))
    for radix in (None, False):
        got = HC.sbh_hist_i8(torch.from_numpy(codes), torch.from_numpy(heap),
                             torch.from_numpy(st), base=base, L=L,
                             n_bins=n_bins, half=half, radix=radix)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    assert np.abs(want).max() > 127                 # real multi-row sums


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("L,half", [(1, False), (2, True), (4, True)])
def test_hist_radix_matches_jax(L, half, int8):
    n_bins, b_val = 256, 255
    codes, heap, stats, base = _codes_heap_stats(40 + L, L=L, b_val=b_val)
    st = _i8_stats(stats) if int8 else stats
    want = np.asarray(HP.sbh_hist_xla(
        jnp.asarray(codes), jnp.asarray(heap), jnp.asarray(st),
        base=base, L=L, n_bins=n_bins, half=half))
    got = HC.sbh_hist_radix(torch.from_numpy(codes), torch.from_numpy(heap),
                            torch.from_numpy(st), base=base, L=L,
                            n_bins=n_bins, half=half, int8=int8)
    l_eff = HC.hist_layout(L, half)[0]
    assert tuple(got.shape) == want.shape == (l_eff, codes.shape[0], 4,
                                              n_bins)
    if int8:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        assert _hist_rel_err(got.numpy(), want) <= HIST_RTOL


@pytest.mark.parametrize("fused", [None, False])
@pytest.mark.parametrize("any_cat", [True, False])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("L_h", [2, 8, 64])
def test_route_hist_matches_jax(L_h, int8, any_cat, fused):
    """The level pass, fused (L_h <= 32) or sequential, against the JAX
    package's sbh_route_hist (on the CPU: the XLA route, then the half
    histogram)."""
    n_bins, b_val = 128, 64
    L_r = L_h // 2
    base_r, base_h = L_r - 1, L_h - 1
    codes, heap, stats, _ = _codes_heap_stats(50 + L_h, L=L_r, b_val=b_val)
    st = _i8_stats(stats) if int8 else stats
    rng = np.random.default_rng(51)
    tbl, route_cat, route_num = (np.array(a) for a in _route_tables(
        rng, L_r, n_bins, b_val, codes.shape[0]))
    route_f = route_cat if any_cat else route_num
    kw = dict(base_r=base_r, L_r=L_r, base_h=base_h, L_h=L_h, n_bins=n_bins,
              int8=int8)
    h_x, hist_x = HP.sbh_route_hist(
        jnp.asarray(codes), jnp.asarray(heap), jnp.asarray(tbl),
        jnp.asarray(route_f), jnp.asarray(st), any_cat=any_cat,
        na_code=b_val, fused=None, **kw)
    h_t, hist_t = HC.sbh_route_hist(
        torch.from_numpy(codes), torch.from_numpy(heap),
        torch.from_numpy(tbl), torch.from_numpy(route_f),
        torch.from_numpy(st), fused=fused, **kw)
    np.testing.assert_array_equal(h_t.numpy(), np.asarray(h_x))
    assert (h_t.numpy() != heap).any()
    hist_x = np.asarray(hist_x)
    assert tuple(hist_t.shape) == hist_x.shape
    if int8:
        assert hist_t.dtype == torch.int32
        np.testing.assert_array_equal(hist_t.numpy(), hist_x)
    else:
        assert _hist_rel_err(hist_t.numpy(), hist_x) <= HIST_RTOL


def test_dispatch_gates_match_jax(monkeypatch):
    """The port's gates answer as the JAX package's do once its probes
    pass, over window widths, bin counts and column counts (C_pad > 32
    included, where the packed width 4 * packed_words(C_pad) differs)."""
    monkeypatch.setattr(HP, "fused_supported", lambda: True)
    monkeypatch.setattr(HP, "radix_supported", lambda: True)
    seen_fused = set()
    for c_pad in (8, 16, 32, 40, 96, 200):
        assert HC.packed_words(c_pad) == HP.packed_words(c_pad)
        c_pack = HP.PACK * HP.packed_words(c_pad)
        for n_bins in (64, 128, 256):
            for L in (1, 2, 4, 8, 16, 32, 64, 128):
                assert HC._radix_shape_ok(L, n_bins) == \
                    HP._radix_shape_ok(L, n_bins)
                for half in (False, True):
                    assert HC._radix_applicable(L, n_bins, half) == \
                        HP._radix_applicable(L, n_bins, half)
                got = HC._fused_applicable(
                    L, n_bins, HC.PACK * HC.packed_words(c_pad))
                assert got == HP._fused_applicable(L, n_bins, c_pack)
                seen_fused.add(got)
    assert seen_fused == {True, False}
    # the HIGGS cell: fused for the 1-16 left children of levels 1-5
    assert [HC._fused_applicable(1 << d, 256, 32) for d in range(1, 8)] == \
        [True] * 5 + [False] * 2


def test_int8_wrappers_raise_past_the_row_limit():
    n_pad = HC.I8_MAX_ROWS + 4
    assert 127 * HC.I8_MAX_ROWS < 2 ** 31 <= 127 * (HC.I8_MAX_ROWS + 1)
    codes = torch.zeros((8, n_pad), dtype=torch.uint8, device="meta")
    heap = torch.zeros(n_pad, dtype=torch.int32, device="meta")
    stats = torch.zeros((4, n_pad), dtype=torch.int32, device="meta")
    tbl = torch.zeros((8, 8), device="meta")
    route_f = torch.zeros((8, 256), device="meta")
    for L in (1, 8, 128):
        with pytest.raises(ValueError, match="overflows int32"):
            HC.sbh_hist_i8(codes, heap, stats, base=L - 1, L=L, n_bins=256)
    for fused in (None, False):
        with pytest.raises(ValueError, match="overflows int32"):
            HC.sbh_route_hist(codes, heap, tbl, route_f, stats, base_r=0,
                              L_r=1, base_h=1, L_h=2, n_bins=256, int8=True,
                              fused=fused)


# ---------------------------------------------------------------------------
# Fixed-point sums of the f32 dense and fused kernels. On the CPU the
# wrappers run the plain versions, so what is tested here is the arithmetic
# the kernels rely on: the scale, the exactness of the quantized integer
# sums against f64 sums, the wrapper's cast back, and the launch layout.
FIXED_LIMIT = 2 ** 62


def _adversarial_stats(kind, n, seed):
    """(stats f32 (4, n), bins int (n,)) that stress a fixed-point sum:
    weights up to 1e4, grads in exactly cancelling pairs of alternating
    sign, or every row in one bin."""
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.0, 1e4, n)
    g = w * rng.uniform(0.5, 1.5, n)
    g[1::2] = -g[0::2]                          # pairs that cancel exactly
    h = w * rng.uniform(0.05, 0.25, n)
    bins = rng.integers(0, 256, n)
    if kind == "cancelling":
        bins[1::2] = bins[0::2]                 # each pair in one bin
    elif kind == "one_bin":
        bins[:] = 7
    stats = np.stack([w, g, h, np.zeros(n)]).astype(np.float32)
    return stats, bins


@pytest.mark.parametrize("n_rows", [None, 4096, 11_000_000, 11_000_448,
                                    2 ** 28])
@pytest.mark.parametrize("seed", [0, 1])
def test_hist_scale_is_the_largest_power_of_two(n_rows, seed):
    """scale[s] = 2**e with e the largest integer such that
    n * M_s * 2**e <= 2**62, for magnitudes from 1e-30 to 1e30."""
    rng = np.random.default_rng(seed)
    mags = 10.0 ** rng.uniform(-30, 30, 3)
    stats = np.zeros((4, 4096), np.float32)
    stats[:3] = rng.normal(0, 1, (3, 4096)) * mags[:, None]
    scale = HC.hist_scale(torch.from_numpy(stats), n_rows)
    assert scale.dtype == torch.float64 and tuple(scale.shape) == (3,)
    n = 4096 if n_rows is None else n_rows
    for s in range(3):
        S = float(scale[s])
        mant, _ = np.frexp(S)
        assert mant == 0.5                          # a power of two
        M = float(np.abs(stats[s]).max())
        assert n * M * S <= FIXED_LIMIT < n * M * 2 * S


def test_hist_scale_zero_row_and_non_finite_values():
    stats = np.zeros((4, 512), np.float32)
    stats[1, :] = np.linspace(-2.0, 3.0, 512)
    stats[1, 5], stats[1, 9], stats[1, 11] = np.nan, np.inf, -np.inf
    stats[2, 3] = np.nan                        # a row of zeros and a NaN
    scale = HC.hist_scale(torch.from_numpy(stats), 11_000_000).tolist()
    assert scale[0] == 1.0 and scale[2] == 1.0
    M = float(np.abs(stats[1][np.isfinite(stats[1])]).max())
    assert M == 3.0
    assert 11_000_000 * M * scale[1] <= FIXED_LIMIT \
        < 11_000_000 * M * 2 * scale[1]


@pytest.mark.parametrize("kind", ["heavy", "cancelling", "one_bin"])
@pytest.mark.parametrize("n_rows", [None, 11_000_000])
def test_fixed_point_sums_match_f64(kind, n_rows):
    """int64 sums of round(x * scale) (what the kernels add, rounded half
    to even as __float2int_rn does) over 256 bins equal the f64 sums
    within the stated bound: each value rounds by at most 0.5 / scale, so
    a bin of c rows is off by at most c * 0.5 / scale, below 3e-12 * M
    per row at 11M rows; pairs that cancel sum to exactly 0; the total
    fits int64."""
    n = 20_000
    stats, bins = _adversarial_stats(kind, n, 7)
    st = torch.from_numpy(stats)
    scale = HC.hist_scale(st, n_rows)
    N = n if n_rows is None else n_rows
    idx = torch.from_numpy(bins)
    cnt = torch.zeros(256, dtype=torch.float64).index_add_(
        0, idx, torch.ones(n, dtype=torch.float64))
    for s in range(3):
        x = st[s].double()
        S = float(scale[s])
        q = torch.round(x * S).to(torch.int64)
        assert int(q.abs().sum()) <= FIXED_LIMIT + N // 2
        isum = torch.zeros(256, dtype=torch.int64).index_add_(0, idx, q)
        fsum = torch.zeros(256, dtype=torch.float64).index_add_(0, idx, x)
        asum = torch.zeros(256, dtype=torch.float64).index_add_(
            0, idx, x.abs())
        got = isum.double() / S
        M = float(x.abs().max())
        assert 0.5 / S <= N * M / FIXED_LIMIT
        # the f64 reference rounds too: n * 2**-53 of the absolute sum
        bound = cnt * (0.5 / S) + asum * n * 2.0 ** -53
        assert bool(((got - fsum).abs() <= bound).all()), (kind, s)
        if kind == "cancelling" and s == 1:
            assert not isum.any()               # exact cancellation
    if n_rows == 11_000_000:
        assert float((0.5 / scale).max()) < 3e-12 * float(st.abs().max())


def test_level_result_casts_and_takes_non_finite_bins():
    """The wrappers' finish: fixed-point sums over their scale in f64,
    cast once; bins a NaN or +-inf stat reached take the side sum."""
    scale = torch.tensor([2.0 ** 40, 2.0 ** 20, 1.0], dtype=torch.float64)
    acc = torch.zeros((2, 3, 4, 8), dtype=torch.int64)
    acc[0, 1, 0, 2] = 3 * 2 ** 40 + 1                 # 3 + 2**-40
    acc[1, 2, 1, 5] = -(2 ** 20) * 7                  # -7
    acc[1, 0, 2, 0] = 11
    side = torch.zeros((2, 3, 4, 8), dtype=torch.float32)
    side[1, 0, 2, 0] = float("nan")                   # NaN beats the sum
    side[0, 0, 1, 1] = float("inf")
    side[0, 2, 2, 7] = -float("inf")
    got = HC._level_result(acc, side, scale)
    assert got.dtype == torch.float32 and got.shape == acc.shape
    assert got[0, 1, 0, 2] == np.float32(3.0 + 2.0 ** -40)
    assert got[1, 2, 1, 5] == -7.0
    assert torch.isnan(got[1, 0, 2, 0])
    assert got[0, 0, 1, 1] == float("inf")
    assert got[0, 2, 2, 7] == -float("inf")
    assert int(torch.isfinite(got).logical_not().sum()) == 3
    assert not got[:, :, 3].any()                     # spare row stays 0
    i32 = acc.int()
    assert HC._level_result(i32, None, None) is i32   # int32 sums as they are


@pytest.mark.parametrize("l_eff", [1, 2, 4, 8, 16, 32, 64])
def test_level_grid_fits_shared_memory(l_eff):
    """f32: the widest window the budget holds, then as many columns of it
    as fit, never past 227 KB; a given group narrows the window. int8
    fused: hist_grid's window, and a power-of-two group of as many columns
    as I8_FUSED_BUDGET holds (the int32 fused kernel's compile-time
    groups). int8 dense (dense_i8_grid): the widest window that 227 KB
    holds for one column, in passes of equal width, then a power-of-two
    group of as many columns of it as fit, never past 227 KB (level 6's 32
    slots x 2 columns and level 7's 64 slots x 1 column in one pass); the
    int8 dense wrapper refuses a group the kernel is not built for."""
    n_bins, c_pad = 256, 32
    win, n_win, g, rows = HC.level_grid(l_eff, n_bins, c_pad, False)
    assert win * n_win >= l_eff and win <= l_eff
    assert g * win * 3 * 8 * n_bins <= HC.SMEM_MAX
    assert (g == c_pad) or (g + 1) * win * 3 * 8 * n_bins > HC.SMEM_MAX
    assert n_win == -(-l_eff // win)
    assert rows % 1024 == 0 and rows >= 16384
    w2, n2, g2, _ = HC.level_grid(l_eff, n_bins, c_pad, False, 2)
    assert g2 == 2 and 2 * w2 * 3 * 8 * n_bins <= HC.SMEM_MAX
    win8, nw8, g8, rows8 = HC.level_grid(l_eff, n_bins, c_pad, True)
    assert (win8, nw8, rows8) == HC.hist_grid(l_eff, n_bins, 4)
    assert g8 in HC.GROUPS and g8 <= c_pad
    assert g8 * win8 * 3 * 4 * n_bins <= HC.I8_FUSED_BUDGET
    assert g8 == c_pad or \
        2 * g8 * win8 * 3 * 4 * n_bins > HC.I8_FUSED_BUDGET
    assert HC.level_grid(l_eff, n_bins, c_pad, True, 1) == \
        HC.hist_grid(l_eff, n_bins, 4)[:2] + (1,) + \
        HC.hist_grid(l_eff, n_bins, 4)[2:]
    with pytest.raises(ValueError, match="group"):
        HC.level_grid(l_eff, n_bins, c_pad, False, c_pad + 1)
    with pytest.raises(ValueError, match="group"):
        HC.level_grid(l_eff, n_bins, c_pad, True, 3)
    win, n_win, g, nt, spad, rows = HC.dense_i8_grid(l_eff, n_bins, c_pad)
    slot = (3 * n_bins + spad) * 4
    assert (nt, spad) == (HC.I8_DENSE_THREADS, HC.I8_DENSE_SPAD)
    assert g in HC.GROUPS and g * win * slot <= HC.SMEM_MAX
    assert g in (c_pad, HC.I8_DENSE_GROUPS[-1]) or \
        2 * g * win * slot > HC.SMEM_MAX
    assert win * n_win >= l_eff and (win - 1) * n_win < l_eff
    assert n_win == -(-l_eff // (HC.SMEM_MAX // slot))
    assert {32: (32, 1, 2), 64: (64, 1, 1)}.get(l_eff, (win, n_win, g)) \
        == (win, n_win, g)
    codes, heap, stats, base = _codes_heap_stats(90, L=1, b_val=64)
    for bad in (3, 64):
        with pytest.raises(ValueError, match="group"):
            HC.sbh_hist_dense(torch.from_numpy(codes),
                              torch.from_numpy(heap),
                              torch.from_numpy(_i8_stats(stats)), base=base,
                              L=1, n_bins=128, int8=True, group=bad)


@pytest.mark.parametrize("fused", [None, False])
def test_scale_is_ignored_by_the_plain_versions(fused):
    """A scale handed to the dispatchers changes nothing on the CPU."""
    n_bins, b_val, L_h = 128, 64, 8
    codes, heap, stats, _ = _codes_heap_stats(80, L=L_h // 2, b_val=b_val)
    rng = np.random.default_rng(81)
    tbl, route_cat, _ = (np.array(a) for a in _route_tables(
        rng, L_h // 2, n_bins, b_val, codes.shape[0]))
    args = [torch.from_numpy(a) for a in (codes, heap, tbl, route_cat,
                                          stats)]
    kw = dict(base_r=L_h // 2 - 1, L_r=L_h // 2, base_h=L_h - 1, L_h=L_h,
              n_bins=n_bins, fused=fused)
    h0, hist0 = HC.sbh_route_hist(*args, **kw)
    h1, hist1 = HC.sbh_route_hist(*args, scale=HC.hist_scale(args[4]), **kw)
    assert torch.equal(h0, h1) and torch.equal(hist0, hist1)
    d0 = HC.sbh_hist(args[0], args[1], args[4], base=3, L=4, n_bins=n_bins)
    d1 = HC.sbh_hist(args[0], args[1], args[4], base=3, L=4, n_bins=n_bins,
                     scale=HC.hist_scale(args[4]))
    assert torch.equal(d0, d1)


# ---------------------------------------------------------------------------
# The shallow-window kernel's f32 form sums in the same fixed point, with
# the scale grow() hands it; its launch layout (column group, window copies,
# threads, row chunks) must fit shared memory at every HIGGS level.
def _radix_case(kind, seed, L, n_pad=4096, c_pad=16, b_val=255):
    """Inputs of one shallow-window case: "plain" (NA codes, frozen rows),
    "nonfinite" (a NaN grad and a +-inf hess in rows of the window), or
    "one_bin" (every row in the first slot and every code in one bin)."""
    codes, heap, stats, base = _codes_heap_stats(seed, n_pad=n_pad,
                                                 c_pad=c_pad, b_val=b_val,
                                                 L=L)
    if kind == "nonfinite":
        stats[1, 10], stats[2, 21], stats[2, 40] = np.nan, np.inf, -np.inf
        heap[[10, 21, 40]] = base
    elif kind == "one_bin":
        codes[:] = 7
        heap[:] = base
    return codes, heap, stats, base


@pytest.mark.parametrize("kind,L,half", [
    ("plain", 1, False), ("plain", 1, True), ("plain", 2, False),
    ("plain", 2, True), ("nonfinite", 1, False), ("nonfinite", 2, True),
    ("one_bin", 1, False), ("one_bin", 2, True)])
def test_hist_radix_with_scale_matches_jax(kind, L, half):
    """sbh_hist_radix handed hist_scale(stats), as grow() hands it, equals
    the JAX package's histogram (its XLA path on the CPU): finite bins
    within HIST_RTOL of each stat row's largest finite magnitude, bins a
    NaN or +-inf stat reached NaN or +-inf alike. The port's histogram is
    the kernels' exact fixed-point sum on the CPU too, so the JAX
    package's is taken over float64 stats (x64): its own f32 rounding,
    up to 3e-4 of the scale where 4,096 rows fall in one bin, is not the
    port's."""
    n_bins = 256
    codes, heap, stats, base = _radix_case(kind, 100 + L, L)
    with jax.enable_x64(True):
        want = np.asarray(HP.sbh_hist_xla(
            jnp.asarray(codes), jnp.asarray(heap),
            jnp.asarray(stats.astype(np.float64)), base=base, L=L,
            n_bins=n_bins, half=half))
    st = torch.from_numpy(stats)
    got = HC.sbh_hist_radix(torch.from_numpy(codes), torch.from_numpy(heap),
                            st, base=base, L=L, n_bins=n_bins, half=half,
                            scale=HC.hist_scale(st)).numpy()
    assert got.shape == want.shape == (HC.hist_layout(L, half)[0],
                                       codes.shape[0], 4, n_bins)
    fin = np.isfinite(want)
    assert (kind == "nonfinite") == (not fin.all())
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got[~fin], want[~fin])
    assert _hist_rel_err(np.where(fin, got, 0.0),
                         np.where(fin, want, 0.0)) <= HIST_RTOL
    if kind == "one_bin":
        assert np.count_nonzero(want[:, :, 0]) == codes.shape[0]


def test_sbh_hist_hands_its_scale_to_the_radix_kernel(monkeypatch):
    seen = []
    real = HC.sbh_hist_radix

    def recording(*args, **kw):
        seen.append(kw.get("scale"))
        return real(*args, **kw)

    monkeypatch.setattr(HC, "sbh_hist_radix", recording)
    codes, heap, stats, base = _codes_heap_stats(110, L=1, b_val=255)
    st = torch.from_numpy(stats)
    scale = HC.hist_scale(st)
    HC.sbh_hist(torch.from_numpy(codes), torch.from_numpy(heap), st,
                base=base, L=1, n_bins=256, scale=scale)
    assert len(seen) == 1 and seen[0] is scale


HIGGS_LEVELS = range(8)          # depth 8: levels 0-7, C_pad 32, 256 bins


@pytest.mark.parametrize("depth", HIGGS_LEVELS)
def test_launch_layouts_fit_shared_memory(depth):
    """At every level of the HIGGS tree (level 0 full, the rest half
    windows), each layout the shallow-window and int8 fused launches can
    take fits 232,448 bytes of shared memory per block, with a power-of-two
    group in [1, C_pad], at most one window copy per warp, and row chunks
    of whole 4-row steps that tile the rows."""
    c_pad, n_bins, n_pad = 32, 256, 11_000_448
    assert HC.SMEM_MAX == 232_448
    l_eff = HC.hist_layout(1 << depth, depth > 0)[0]
    if HC._radix_shape_ok(l_eff, n_bins):
        for int8 in (False, True):
            acc = 4 if int8 else 8
            for group in (None,) + HC.RADIX_GROUPS[int8]:
                if group and group * l_eff * 3 * acc * n_bins > HC.SMEM_MAX:
                    with pytest.raises(ValueError, match="shared memory"):
                        HC.radix_grid(l_eff, n_bins, c_pad, int8, group)
                    continue
                for threads in (None, 512, 1024):
                    win, g, ncopy, nt, rows = HC.radix_grid(
                        l_eff, n_bins, c_pad, int8, group, threads, n_pad)
                    assert win == l_eff and g in HC.RADIX_GROUPS[int8]
                    assert g <= c_pad
                    assert 1 <= ncopy <= nt // 32
                    assert ncopy * g * win * 3 * acc * n_bins <= HC.SMEM_MAX
                    assert rows % 4 == 0 and rows >= 4 * nt
                    assert -(-n_pad // rows) * rows >= n_pad
            # the default: the widest group that leaves room for its copies
            win, g, ncopy, _, _ = HC.radix_grid(l_eff, n_bins, c_pad, int8)
            assert ncopy >= HC.RADIX_MIN_COPIES
            assert g in (c_pad, HC.RADIX_GROUPS[int8][-1]) or \
                HC.RADIX_MIN_COPIES * 2 * g * win * 3 * acc * n_bins > \
                HC.SMEM_MAX
    if depth > 0:
        win8 = HC.hist_grid(l_eff, n_bins, 4)[0]
        for group in (None,) + HC.GROUPS:
            if group and group * win8 * 3 * 4 * n_bins > HC.SMEM_MAX:
                with pytest.raises(ValueError, match="shared memory"):
                    HC.level_grid(l_eff, n_bins, c_pad, True, group)
                continue
            win, n_win, g, rows = HC.level_grid(l_eff, n_bins, c_pad, True,
                                                group)
            assert g in HC.GROUPS and g <= c_pad
            assert g * win * 3 * 4 * n_bins <= HC.SMEM_MAX
            assert win * n_win >= l_eff


def test_radix_grid_fills_whole_waves():
    """Row chunks are sized so that the grid is a whole number of waves of
    resident blocks (at 11M rows), and a small input gets one 4-row step
    per thread at least."""
    n_pad = 11_000_448
    for int8 in (False, True):
        for group in HC.RADIX_GROUPS[int8]:
            win, g, ncopy, nt, rows = HC.radix_grid(1, 256, 32, int8, group,
                                                    1024, n_pad, sms=132)
            smem = ncopy * g * 3 * (4 if int8 else 8) * 256
            per_sm = min(2048 // nt, HC._SMEM_SM // (smem + 1024))
            blocks = (32 // g) * -(-n_pad // rows)
            assert blocks % (132 * per_sm) == 0, (int8, group)
    assert HC.radix_grid(1, 256, 32, False, n_pad=4096)[4] == 4 * 1024
    with pytest.raises(ValueError, match="threads"):
        HC.radix_grid(1, 256, 32, False, threads=256)
    with pytest.raises(ValueError, match="group"):
        HC.radix_grid(1, 256, 16, True, group=32)
    with pytest.raises(ValueError, match="group"):
        HC.radix_grid(1, 256, 32, False, group=32)    # f32: 16 at most


@pytest.mark.parametrize("depth", [6, 7])
def test_dense_i8_layouts_fit_shared_memory(depth):
    """Every int8 dense layout chip_smoke.py times at the HIGGS levels the
    kernel runs (6 and 7: 32 and 64 left children, C_pad 32, 256 bins) fits
    232,448 bytes of shared memory per block or raises, with a compile-time
    group, windows that cover the level, and row chunks of whole 4-row
    steps whose grid fills at most `waves` waves of resident blocks and
    tiles the rows."""
    c_pad, n_bins, n_pad, sms = 32, 256, 11_000_448, 132
    l_eff = HC.hist_layout(1 << depth, True)[0]
    fits = 0
    for group in (None,) + HC.I8_DENSE_GROUPS:
        for win in (None, 8, 16, 32, 64):
            for spad in (0, 1):
                kw = dict(group=group, win=win, spad=spad)
                slot = (3 * n_bins + spad) * 4
                if (group or 1) * min(win or 1, l_eff) * slot > HC.SMEM_MAX:
                    with pytest.raises(ValueError, match="shared memory"):
                        HC.dense_i8_grid(l_eff, n_bins, c_pad, **kw)
                    continue
                for threads in (512, 1024):
                    for waves in (1, 2, 4):
                        win_, n_win, g, nt, sp, rows = HC.dense_i8_grid(
                            l_eff, n_bins, c_pad, threads=threads,
                            waves=waves, n_pad=n_pad, sms=sms, **kw)
                        smem = g * win_ * slot
                        assert g in HC.I8_DENSE_GROUPS and g <= c_pad
                        assert (sp, nt) == (spad, threads)
                        assert smem <= HC.SMEM_MAX
                        assert win_ * n_win >= l_eff
                        assert rows % 4 == 0 and rows >= 4 * nt
                        chunks = -(-n_pad // rows)
                        assert chunks * rows >= n_pad
                        per_sm = min(2048 // nt, HC._SMEM_SM // (smem + 1024))
                        blocks = (c_pad // g) * n_win * chunks
                        assert blocks <= max(waves * sms * per_sm,
                                             (c_pad // g) * n_win)
                        fits += 1
    assert fits > 50
    with pytest.raises(ValueError, match="threads"):
        HC.dense_i8_grid(l_eff, n_bins, c_pad, threads=256)
    with pytest.raises(ValueError, match="nband"):
        HC.dense_i8_grid(HC.I8_BAND + 1, n_bins, c_pad)
    with pytest.raises(ValueError, match="group"):
        HC.dense_i8_grid(l_eff, n_bins, c_pad, group=32)   # spilled


def test_route_grid_is_one_wave():
    """The non-terminal route's grid: as many blocks as one wave of SMs
    holds at 2048 threads an SM, fewer for a short input; rows and threads
    only from the kernel's instantiations."""
    assert HC.route_grid(11_000_448, sms=132) == (
        HC.ROUTE_ROWS, HC.ROUTE_THREADS, 132 * 2048 // HC.ROUTE_THREADS)
    for rows in (4, 8):
        for threads in (256, 512, 1024):
            assert HC.route_grid(11_000_448, rows, threads, sms=132) == \
                (rows, threads, 132 * 2048 // threads)
    assert HC.route_grid(4096, 8, 512)[2] == 1
    for bad in (dict(rows=2), dict(rows=16), dict(threads=128)):
        with pytest.raises(ValueError):
            HC.route_grid(4096, **bad)


def test_route_64_leaves_categorical_matches_jax():
    """A non-terminal route at 64 leaves (a level-7 route of a depth-8
    tree) with categorical set splits and NA codes: heap ids identical to
    the JAX twin's, whatever launch layout the wrapper is handed (the
    plain version takes none; a layout the kernel cannot take raises)."""
    L, n_bins, b_val = 64, 256, 255
    codes, heap, _, base = _codes_heap_stats(61, n_pad=8192, c_pad=32, L=L,
                                             b_val=b_val)
    rng = np.random.default_rng(62)
    tbl, route_cat, _ = (np.array(a) for a in _route_tables(
        rng, L, n_bins, b_val, codes.shape[0]))
    h_x, _ = HP.sbh_route_xla(
        jnp.asarray(codes), jnp.asarray(heap), jnp.asarray(tbl),
        jnp.asarray(route_cat), None, None, base=base, L=L, any_cat=True,
        na_code=b_val)
    args = [torch.from_numpy(a) for a in (codes, heap, tbl, route_cat)]
    for rows, threads in ((None, None), (4, 256), (8, 1024)):
        h_t, f_t = HC.sbh_route(*args, base=base, L=L, rows=rows,
                                threads=threads)
        assert f_t is None and h_t.dtype == torch.int32
        np.testing.assert_array_equal(h_t.numpy(), np.asarray(h_x))
    moved = h_t.numpy() != heap
    assert moved.sum() > 1000 and (heap[moved] >= base).all()
    with pytest.raises(ValueError, match="rows"):
        HC.sbh_route(*args, base=base, L=L, rows=3)
    with pytest.raises(ValueError, match="emit_f"):
        HC.sbh_route(*args, base=base, L=L, emit_f=True, rows=8)

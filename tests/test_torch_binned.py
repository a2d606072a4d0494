"""The port's binned tree engine against the JAX package's, on the CPU.

Both packages get the same seeded numpy inputs: a frame with NA values and
one categorical column, its bin spec, code plane and bernoulli stats. The
port runs the plain PyTorch versions of its kernels, the JAX package its
XLA twins. Integer results (codes, split columns and bins, NA directions,
routing tables, heap ids) must be equal; float results within 1e-5
(f32 sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h2o3_tpu.models.tree import binned as JB
from h2o3_tpu_torch.models.tree import binned as TB

ATOL = 1e-5
N, C, CARD, DEPTH, NBINS = 3000, 5, 6, 4, 32


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    X = rng.normal(size=(N, C)).astype(np.float32)
    X[:, 3] = rng.integers(0, CARD, N)                 # categorical level ids
    X[rng.random((N, C)) < 0.05] = np.nan
    is_cat = np.array([False, False, False, True, False])
    logit = (1.5 * np.nan_to_num(X[:, 0]) - np.nan_to_num(X[:, 1])
             + np.isin(X[:, 3], [1, 4]) * 1.2)
    y = (rng.random(N) < 1 / (1 + np.exp(-logit))).astype(np.float32)
    spec = JB.make_bins(X, is_cat, NBINS)
    n_pad = JB.padded_rows(N)
    codes = np.array(JB.quantize(jnp.asarray(X), spec, n_pad=n_pad))
    y1 = np.zeros(n_pad, np.float32)
    y1[:N] = y
    w1 = np.zeros(n_pad, np.float32)
    w1[:N] = 1.0
    f0 = float(np.log(y.mean() / (1 - y.mean())))
    F = np.where(np.arange(n_pad) < N, f0, 0.0).astype(np.float32)
    p = 1 / (1 + np.exp(-F))
    stats = np.stack([w1, w1 * (y1 - p), w1 * p * (1 - p),
                      np.zeros(n_pad)]).astype(np.float32)
    return dict(X=X, is_cat=is_cat, spec=spec, codes=codes, y1=y1, w1=w1,
                F=F, stats=stats, n_pad=n_pad)


def test_make_bins_equal_edges(data):
    ours = TB.make_bins(data["X"], data["is_cat"], NBINS)
    ref = data["spec"]
    np.testing.assert_array_equal(ours.edges, ref.edges)
    assert (ours.b_val, ours.n_bins, ours.c_pad) == \
        (ref.b_val, ref.n_bins, ref.c_pad)
    np.testing.assert_array_equal(ours.is_cat, ref.is_cat)


def test_quantize_equal_codes(data):
    X = data["X"].copy()
    # values exactly on an edge take the lower bin (searchsorted left)
    X[:10, 0] = data["spec"].edges[0, :10]
    want = np.asarray(JB.quantize(jnp.asarray(X), data["spec"],
                                  n_pad=data["n_pad"]))
    got = TB.quantize(torch.from_numpy(X), data["spec"], n_pad=data["n_pad"])
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[:C, :N] == data["spec"].b_val).any()   # NA codes present
    assert TB.padded_rows(N) == JB.padded_rows(N)


def _split_inputs(data, L=4):
    """A level-2 histogram of the seeded data, monotone constraints on two
    columns and a column mask with one hole."""
    rng = np.random.default_rng(12)
    heap = rng.integers(L - 1, 2 * L - 1, data["n_pad"]).astype(np.int32)
    spec = data["spec"]
    hist = np.array(JB.HP.sbh_hist_xla(
        jnp.asarray(data["codes"]), jnp.asarray(heap),
        jnp.asarray(data["stats"]), base=L - 1, L=L,
        n_bins=spec.n_bins))[:L, :spec.c_pad]
    is_cat = np.pad(spec.is_cat, (0, spec.c_pad - C))
    mono = np.zeros(spec.c_pad, np.int32)
    mono[0], mono[2] = 1, -1
    cmask = np.zeros((L, spec.c_pad), bool)
    cmask[:, :C] = True
    cmask[1, 4] = False
    lo = np.full(L, -3e38, np.float32)
    hi = np.full(L, 3e38, np.float32)
    lo[2], hi[3] = -0.05, 0.05
    return hist, is_cat, mono, cmask, lo, hi


def test_find_splits_binned_matches_jax(data):
    args = _split_inputs(data)
    kw = dict(b_val=data["spec"].b_val, min_rows=10.0, msi=1e-5, lam=0.0,
              use_hess=False, any_cat=True)
    ref = {k: np.asarray(v) for k, v in JB.find_splits_binned(
        *(jnp.asarray(a) for a in args), **kw).items()}
    got = TB.find_splits_binned(*(torch.from_numpy(a) for a in args), **kw)
    assert ref["did"].all()
    for k in ("did", "col", "bin", "nal", "route"):
        np.testing.assert_array_equal(got[k].numpy(), ref[k], err_msg=k)
    for k in ("val_l", "val_r", "val_t", "gain", "w_t", "w_l", "wg_l",
              "wh_l"):
        np.testing.assert_allclose(got[k].numpy(), ref[k], rtol=ATOL,
                                   atol=ATOL, err_msg=k)


def test_pack_route_matches_jax():
    rng = np.random.default_rng(13)
    route = rng.random((15, 256)) < 0.5
    want = np.asarray(JB.pack_route(jnp.asarray(route), 256, 40))
    got = TB.pack_route(torch.from_numpy(route), 256, 40)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def _growers(spec):
    ref = JB.BinnedGrower(spec, max_depth=DEPTH, min_rows=10.0,
                          min_split_improvement=1e-5, axis_name=None,
                          int8_stats=False, use_radix_shallow=False,
                          fused_level=False)
    ours = TB.BinnedGrower(spec, max_depth=DEPTH, min_rows=10.0,
                           min_split_improvement=1e-5, device="cpu")
    return ref, ours


def test_grow_one_tree_matches_jax(data):
    ref_g, our_g = _growers(data["spec"])
    # one jitted program: eager dispatch of grow() costs seconds on the CPU
    ref = jax.jit(lambda c, s, f: ref_g.grow(
        c, s, f, eta=0.1, clip_val=19.0, key=jax.random.PRNGKey(0)))(
        jnp.asarray(data["codes"]), jnp.asarray(data["stats"]),
        jnp.asarray(data["F"]))
    got = our_g.grow(torch.from_numpy(data["codes"]),
                     torch.from_numpy(data["stats"]),
                     torch.from_numpy(data["F"]), eta=0.1, clip_val=19.0)
    assert (np.asarray(ref["col"]) >= 0).sum() >= 7      # a real tree
    for k in ("col", "bin", "nal", "route", "heap"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    for k in ("val", "cover", "gains", "F"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=ATOL, atol=ATOL, err_msg=k)



@pytest.mark.parametrize("dist", ["gaussian", "bernoulli", "poisson", "gamma",
                                  "tweedie", "laplace"])
def test_grad_hess_matches_jax(dist):
    rng = np.random.default_rng(14)
    F = rng.normal(0, 1, 512).astype(np.float32)
    y = (rng.random(512) < 0.5).astype(np.float32) if dist == "bernoulli" \
        else rng.gamma(2.0, 1.0, 512).astype(np.float32)
    g_ref, h_ref = JB._grad_hess_binned(dist, jnp.asarray(F), jnp.asarray(y))
    g, h = TB._grad_hess_binned(dist, torch.from_numpy(F),
                                torch.from_numpy(y))
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=ATOL,
                               atol=ATOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), rtol=ATOL,
                               atol=ATOL)

"""The adaptive tree engine of the port and the estimators on it (GBM off
the binned engine, DRF deeper than 10 and multinomial, TreeSHAP) against
the JAX package, on the CPU.

The same numpy inputs, made from a seed, go to both packages: the port on
`init(device="cpu")`, the JAX package through its engine's building
blocks and estimators. Where the JAX package draws from a jax.random key,
the port gets the same draws (`test_torch_draws.JaxDraws`). Tolerances:
- exact (bit for bit) where the arithmetic is exact or in the same f32
  order: ranges, bins, splits chosen on integer-valued histograms and on
  0/1 stats (DRF classification: trees node for node, `col` and `value`
  at every node, `thr` and `na_left` where col >= 0), heap ids;
- 1e-5 for values from real-valued sums in another order (leaf values,
  gains, predictions, metrics, covers) through trees that split alike;
- the JAX package's exp, log and sigmoid differ from torch's in the last
  bit, so real-valued stats (GBM residuals) can flip a near-tie split:
  trees are compared node for node only at depth <= 4 with min_rows 20;
  at depth 12 the trees are compared by training metrics within 2e-3
  and the mean predicted probability or value within 5e-3, and a
  gaussian GBM (no exp) node for node;
- TreeSHAP on the same trees within 1e-5.
"""

import numpy as np
import pytest
import torch

import h2o3_tpu
import h2o3_tpu.models as JMODELS
import h2o3_tpu_torch
import jax
import jax.numpy as jnp
from h2o3_tpu.core.frame import Frame as JFrame
from h2o3_tpu.models.tree import contrib as JC
from h2o3_tpu.models.tree import engine as JE
from h2o3_tpu_torch import convert
from h2o3_tpu_torch.core.frame import Frame, T_CAT, Vec
from h2o3_tpu_torch.models.tree import contrib as TC
from h2o3_tpu_torch.models.tree import engine as TE
from test_torch_draws import replay

TOL = 1e-5


@pytest.fixture(scope="module")
def port_cpu():
    h2o3_tpu_torch.init(device="cpu")
    yield
    h2o3_tpu_torch.shutdown()


def _np(a):
    return np.asarray(a.cpu().numpy() if isinstance(a, torch.Tensor) else a)


def _t(a):
    return torch.from_numpy(np.array(a))


def frames(kind, n=700, seed=2, C=4):
    """One seeded frame in both packages: C N(0,1) columns with 3% NA and
    a response: three classes, two, a numeric one, or counts."""
    rng = np.random.default_rng(seed)
    X = rng.normal(0, 1, (n, C))
    X[rng.random((n, C)) < 0.03] = np.nan
    Xz = np.nan_to_num(X)
    names = [f"x{j}" for j in range(C)]
    cols = [Vec.from_numpy(X[:, j]) for j in range(C)]
    if kind in ("multinomial", "binomial"):
        if kind == "multinomial":
            yc = (Xz[:, 0] > 0.5).astype(int) + (Xz[:, 1] > 0).astype(int)
            dom = ["a", "b", "c"]
        else:
            yc = (Xz[:, 0] - Xz[:, 1] + rng.normal(0, 0.5, n) > 0)
            yc = yc.astype(int)
            dom = ["n", "p"]
        jy = np.array(dom, object)[yc]
        ty = Vec.from_numpy(yc.astype(float), type=T_CAT, domain=dom)
    else:
        jy = (rng.poisson(np.exp(0.5 * Xz[:, 0])).astype(float)
              if kind == "counts" else
              Xz[:, 0] * 2 + np.sin(Xz[:, 1] * 3) + rng.normal(0, 0.1, n))
        ty = Vec.from_numpy(jy)
    jf = JFrame.from_dict({**{c: X[:, j] for j, c in enumerate(names)},
                           "y": jy})
    return jf, Frame(names + ["y"], cols + [ty])


def same_trees(tt, jt, values=TOL):
    """Node for node: col and value everywhere, thr and na_left where a
    node splits (nodes no row reaches may differ in those two)."""
    jc, tc = _np(jt.col), _np(tt.col)
    np.testing.assert_array_equal(tc, jc)
    split = jc >= 0
    np.testing.assert_array_equal(_np(tt.thr)[split], _np(jt.thr)[split])
    np.testing.assert_array_equal(_np(tt.na_left)[split],
                                  _np(jt.na_left)[split])
    np.testing.assert_allclose(_np(tt.value), _np(jt.value), atol=values)


def same_history(th, jh, tol=TOL):
    assert [h["number_of_trees"] for h in th] == \
        [h["number_of_trees"] for h in jh]
    for a, b in zip(th, jh):
        assert sorted(a) == sorted(b)
        for k in a:
            assert abs(a[k] - b[k]) < tol, (k, a[k], b[k])


def both(kind, jcls, tcls, scheme=None, frames_=None, **params):
    """Train one configuration in both packages; with `scheme` the port
    draws the JAX package's draws."""
    jf, tf = frames_ or frames(kind)
    jm = jcls(**params)
    jm.train(y="y", training_frame=jf)
    tm = tcls(**params)
    if scheme:
        replay(tm, params["seed"], jf.padded_len, scheme,
               K=3 if kind == "multinomial" else 1)
    tm.train(y="y", training_frame=tf)
    return jf, tf, jm, tm


# ---------------------------------------------------------------------------
def _level_inputs(seed=4, n=500, C=5, L=4):
    rng = np.random.default_rng(seed)
    X = rng.normal(0, 1, (n, C)).astype(np.float32)
    X[rng.random((n, C)) < 0.05] = np.nan
    X[:40, 2] = np.nan                    # leaf 0 holds some all-NA rows
    lv = rng.integers(0, L + 1, n).astype(np.int32)   # L = not in sample
    lv[lv == 3] = L                       # leaf 3 holds no row
    return X, lv


@pytest.mark.parametrize("sorted_leaves", [128, 2])
def test_leaf_ranges_and_bin_rows_match_jax(monkeypatch, sorted_leaves):
    """Per-(leaf, col) ranges bit for bit, the +-inf of an empty leaf and
    the +-3e38 of an all-NA column included, and every row's bin; through
    rows sorted by leaf (4 leaves) and through the scatter min and max
    (the sorted form only up to 2 leaves)."""
    monkeypatch.setattr(TE, "SORTED_RANGE_LEAVES", sorted_leaves)
    X, lv = _level_inputs()
    L, B = 4, 20
    # compiled, as the JAX package's level program runs them
    jmn, jmx = (np.asarray(a) for a in jax.jit(
        JE.leaf_ranges, static_argnums=2)(jnp.asarray(X), jnp.asarray(lv), L))
    tmn, tmx = (_np(a) for a in TE.leaf_ranges(_t(X), _t(lv).long(), L))
    np.testing.assert_array_equal(tmn, jmn)
    np.testing.assert_array_equal(tmx, jmx)
    assert np.isinf(tmn[3]).all() and (tmn[3] > 0).all()
    jb = np.asarray(jax.jit(JE.bin_rows, static_argnums=4)(
        jnp.asarray(X), jnp.asarray(lv), jnp.asarray(jmn), jnp.asarray(jmx),
        B))
    keep = lv < L
    tb = _np(TE.bin_rows(_t(X)[keep], _t(lv).long()[keep], _t(tmn),
                         _t(tmx), B))
    np.testing.assert_array_equal(tb, jb[keep])
    assert (tb[np.isnan(X[keep])] == B).all()


@pytest.mark.parametrize("reg_lambda", [0.0, 1.0])
def test_find_best_splits_matches_jax(reg_lambda):
    """One integer-valued histogram (exact sums in both packages) with a
    per-leaf column mask: the same split or none per leaf (column, bin via
    its threshold, NA side), gains and leaf sums within 1e-5 (relative)."""
    rng = np.random.default_rng(7)
    L, C, B = 6, 4, 10
    hist = np.zeros((L, C, B + 1, 3), np.float32)
    w = rng.integers(0, 6, (L, 1, B + 1)).astype(np.float32)
    w = np.broadcast_to(w, (L, C, B + 1)).copy()
    for c in range(C):                         # each column its own order
        w[:, c] = w[:, c, rng.permutation(B + 1)]
    wy = np.round(w * rng.normal(0, 2, (L, C, B + 1)))
    hist[..., 0], hist[..., 1], hist[..., 2] = w, wy, wy * wy
    hist[5] = 0                                # an empty leaf
    mn = rng.normal(0, 1, (L, C)).astype(np.float32)
    mx = (mn + rng.uniform(0.5, 3, (L, C))).astype(np.float32)
    cmask = rng.random((L, C)) < 0.7
    cmask[:, 0] = True
    # compiled, as the JAX package's level program runs it
    jfind = jax.jit(lambda *a: JE.find_best_splits(
        *a[:3], 2.0, 1e-5, a[3], B, reg_lambda=reg_lambda))
    j = [np.asarray(a) for a in jfind(jnp.asarray(hist), jnp.asarray(mn),
                                      jnp.asarray(mx), jnp.asarray(cmask))]
    t = [_np(a) for a in TE.find_best_splits(
        _t(hist), _t(mn), _t(mx), 2.0, 1e-5, _t(cmask), B,
        reg_lambda=reg_lambda)]
    did = j[0]
    assert did.sum() >= 3 and not did[5]
    np.testing.assert_array_equal(t[0], did)
    for k in (2, 3, 4):                        # col, thr, na_left
        np.testing.assert_array_equal(t[k][did], j[k][did])
    np.testing.assert_allclose(t[1][did], j[1][did], rtol=TOL)
    np.testing.assert_allclose(t[5], j[5], rtol=TOL)
    np.testing.assert_allclose(t[6], j[6], rtol=TOL)


def test_gamma_pass_and_node_covers_match_jax():
    """Newton leaves (with XGBoost's lambda and alpha, and scale) and node
    covers from the same heap ids, within 1e-5."""
    rng = np.random.default_rng(3)
    n, D = 400, 3
    nodes = 2 ** (D + 1) - 1
    heap = rng.integers(3, nodes, n).astype(np.int32)
    w, res = rng.random(n).astype(np.float32), rng.normal(size=n) \
        .astype(np.float32)
    hess = rng.uniform(0.1, 1, n).astype(np.float32)
    val = rng.normal(size=nodes).astype(np.float32)
    for kw in ({}, {"scale": 2 / 3}, {"reg_lambda": 1.0, "reg_alpha": 0.5}):
        jv = np.asarray(JE.gamma_pass(*(jnp.asarray(a) for a in
                                        (heap, w, res, hess, val)),
                                      nodes=nodes, **kw))
        tv = _np(TE.gamma_pass(_t(heap).long(), _t(w), _t(res), _t(hess),
                               _t(val), nodes=nodes, **kw))
        np.testing.assert_allclose(tv, jv, atol=TOL)
    jc = np.asarray(JE.node_covers(jnp.asarray(heap), jnp.asarray(w),
                                   nodes=nodes, D=D))
    tc = _np(TE.node_covers(_t(heap).long(), _t(w), nodes=nodes, D=D))
    np.testing.assert_allclose(tc, jc, atol=TOL)


def test_level_step_matches_jax():
    """One level (d = 2, mtries 2 of 5 with the JAX package's draws) on
    rows partly out of the sample: every written node and every row's
    leaf, heap id and activity equal; gains within 1e-5."""
    rng = np.random.default_rng(5)
    n, C, d, B, D = 600, 5, 2, 16, 4
    nodes = 2 ** (D + 1) - 1
    X = rng.normal(0, 1, (n, C)).astype(np.float32)
    X[rng.random((n, C)) < 0.04] = np.nan
    w = (rng.random(n) < 0.8).astype(np.float32)
    y = (rng.random(n) < 0.3).astype(np.float32)
    stats = np.stack([w, w * y, w * y * y], 1)
    leaf = rng.integers(0, 4, n).astype(np.int32)
    heap = (leaf + 3).astype(np.int32)
    active = rng.random(n) < 0.9
    key = jax.random.PRNGKey(9)
    state = [np.full(nodes, -1, np.int32), np.zeros(nodes, np.float32),
             np.zeros(nodes, bool), np.zeros(nodes, np.float32),
             np.zeros(C, np.float32)]
    kw = dict(d=d, B=B, mtries=2, min_rows=2.0, min_split_improvement=1e-5)
    j = [np.asarray(a) for a in JE._level_step(
        *(jnp.asarray(a) for a in (X, stats, w, leaf, heap, active,
                                   *state, np.ones(C, bool))), key, **kw)]
    r = np.array(jax.random.uniform(jax.random.fold_in(key, d), (4, C)))
    t = [_np(a) for a in TE._level_step(
        _t(X), _t(stats), _t(w), _t(leaf).long(), _t(heap).long(),
        _t(active), *(_t(a) for a in state), torch.ones(C, dtype=bool),
        _t(r), **kw)]
    for k in range(3):                             # leaf, heap, active
        np.testing.assert_array_equal(t[k], j[k])
    split = j[3] >= 0
    assert split.sum() >= 2
    np.testing.assert_array_equal(t[3], j[3])
    np.testing.assert_array_equal(t[4][split], j[4][split])
    np.testing.assert_array_equal(t[5][split], j[5][split])
    np.testing.assert_allclose(t[6], j[6], atol=TOL)
    np.testing.assert_allclose(t[7], j[7], rtol=TOL)


@pytest.fixture(scope="module")
def grown():
    """A depth-12 tree on 0/1 stats (weights and response), mtries 3 of 6
    with the JAX package's level draws, in both packages."""
    rng = np.random.default_rng(0)
    n, C = 3000, 6
    X = rng.normal(size=(n, C)).astype(np.float32)
    X[rng.random((n, C)) < 0.05] = np.nan
    y = (rng.random(n) < 0.4).astype(np.float32)
    w = (rng.random(n) < 0.7).astype(np.float32)
    key = jax.random.PRNGKey(3)
    args = (20, 12, 1.0, 1e-5)
    jt = [np.asarray(a) for a in JE.TreeGrower(*args).grow(
        jnp.asarray(X), jnp.asarray(w), jnp.asarray(y), key=key, mtries=3)]

    def draw(d, L, C):
        return _t(jax.random.uniform(jax.random.fold_in(key, d), (L, C)))
    grow = (lambda: [_np(a) for a in TE.TreeGrower(*args).grow(
        _t(X), _t(w), _t(y), draw=draw, mtries=3)])
    return jt, grow


def test_tree_grower_on_binary_stats_matches_jax(grown):
    """Node for node to depth 12 (col and value everywhere, thr and
    na_left at split nodes), every row's terminal node, gains 1e-5."""
    jt, grow = grown
    tt = grow()
    split = jt[0] >= 0
    assert split.sum() > 200 and (np.nonzero(split)[0] >= 2 ** 11 - 1).any()
    np.testing.assert_array_equal(tt[0], jt[0])
    np.testing.assert_array_equal(tt[1][split], jt[1][split])
    np.testing.assert_array_equal(tt[2][split], jt[2][split])
    np.testing.assert_array_equal(tt[3], jt[3])
    np.testing.assert_array_equal(tt[4], jt[4][: tt[4].shape[0]])
    np.testing.assert_allclose(tt[5], jt[5], rtol=TOL)


def test_histogram_blocks_give_the_same_tree(grown, monkeypatch):
    """With a histogram budget of 1000 cells (blocks of 7 leaves at 6
    columns and 21 slots) the tree is the same, bit for bit."""
    jt, grow = grown
    whole = grow()
    monkeypatch.setattr(TE, "HIST_CELLS", 1000)
    calls = []
    real = TE.find_best_splits
    monkeypatch.setattr(TE, "find_best_splits",
                        lambda h, *a, **k: calls.append(h.shape[0])
                        or real(h, *a, **k))
    blocked = grow()
    assert max(calls) <= 1000 // (6 * 21) and len(calls) > 20
    for a, b in zip(blocked, whole):
        np.testing.assert_array_equal(a, b)


def test_histogram_sums_are_exact_in_any_order():
    """Real-valued stats: the histogram in 64-bit fixed point comes out
    bit-identical whatever the order of the rows, within 1e-6 of each
    stat's scale of a float64 sum; an inf stat makes its bin inf and a
    NaN its bin NaN, as an f32 sum would, and leaves every other bin as
    the finite stats alone give it."""
    rng = np.random.default_rng(12)
    n, C, L, B = 5000, 3, 4, 10
    bins = _t(rng.integers(0, B + 1, (n, C))).to(torch.int16)
    lv = _t(rng.integers(0, L, n))
    stats = _t(rng.normal(0, 3, (n, 3)).astype(np.float32))
    hist = TE.build_histograms(bins, lv, stats, L, B)
    perm = torch.from_numpy(rng.permutation(n))
    assert torch.equal(TE.build_histograms(bins[perm], lv[perm],
                                           stats[perm], L, B), hist)
    ref = np.zeros((L, C, B + 1, 3))
    b, l, st = bins.numpy(), lv.numpy(), stats.numpy().astype(np.float64)
    for c in range(C):
        np.add.at(ref[:, c], (l, b[:, c]), st)
    scale = np.abs(ref).max(axis=(0, 1, 2))
    assert (np.abs(_np(hist) - ref).max(axis=(0, 1, 2)) <= 1e-6 * scale).all()
    bad = stats.clone()
    bad[0, 1], bad[1, 2] = float("inf"), float("nan")
    got = TE.build_histograms(bins, lv, bad, L, B)
    fin = bad.clone()
    fin[0, 1] = fin[1, 2] = 0.0
    base = TE.build_histograms(bins, lv, fin, L, B)
    for c in range(C):
        assert got[int(lv[0]), c, int(bins[0, c]), 1] == float("inf")
        assert torch.isnan(got[int(lv[1]), c, int(bins[1, c]), 2])
    mask = torch.isfinite(got)
    assert int((~mask).sum()) == 2 * C
    assert torch.equal(got[mask], base[mask])


# ---------------------------------------------------------------------------
KINDS = {"gaussian": "regression", "bernoulli": "binomial",
         "poisson": "counts", "multinomial": "multinomial"}


def _ensembles(m, dist):
    return m._trees_k if dist == "multinomial" else [m._trees]


@pytest.mark.parametrize("dist", list(KINDS))
def test_uniform_adaptive_gbm_matches_jax(port_cpu, dist):
    """histogram_type="UniformAdaptive" at depth 4, min_rows 20, with row
    and per-level column sampling (the same draws): f0, predictions and
    the scoring history within 1e-5; every tree node for node (covers
    within 1e-5). Multinomial residuals come from a softmax whose exp
    differs in the last bit, and a near tie between two columns flips (at
    depth 3 of one class tree here, moving 27 of 700 rows by 1e-3, and
    the later trees grow on those margins): there the probabilities and
    the history are held within 1e-3."""
    kw = dict(ntrees=6, max_depth=4, min_rows=20, seed=1,
              histogram_type="UniformAdaptive", distribution=dist,
              sample_rate=0.8, col_sample_rate=0.75)
    scheme = "iter3" if dist == "multinomial" else "tree4"
    jf, tf, jm, tm = both(KINDS[dist], JMODELS.H2OGradientBoostingEstimator,
                          h2o3_tpu_torch.H2OGradientBoostingEstimator,
                          scheme=scheme, **kw)
    np.testing.assert_allclose(np.ravel(tm._f0), np.ravel(jm._f0), atol=TOL)
    if dist != "multinomial":
        same_trees(tm._trees, jm._trees)
        np.testing.assert_allclose(_np(tm._trees.cover),
                                   _np(jm._trees.cover), atol=TOL)
    tol = 1e-3 if dist == "multinomial" else TOL
    np.testing.assert_allclose(tm.predict(tf).to_numpy()[:, 1:],
                               jm.predict(jf).to_numpy()[:, 1:]
                               .astype(float), atol=tol)
    same_history(tm.scoring_history(), jm.scoring_history(), tol=tol)
    assert tm.summary()["engine"] == "adaptive"


@pytest.mark.parametrize("dist", list(KINDS))
def test_deep_gbm_matches_jax(port_cpu, dist):
    """max_depth 12 (above the binned engine's 10), min_rows 10: the
    gaussian trees node for node; for every distribution the training
    metrics within 2e-3 and the mean prediction within 5e-3 (near-tie
    splits of real-valued residuals may flip: see the module doc)."""
    kw = dict(ntrees=5, max_depth=12, min_rows=10, seed=1,
              distribution=dist)
    jf, tf, jm, tm = both(KINDS[dist], JMODELS.H2OGradientBoostingEstimator,
                          h2o3_tpu_torch.H2OGradientBoostingEstimator, **kw)
    if dist == "gaussian":
        same_trees(tm._trees, jm._trees, values=1e-4)
    tmet, jmet = tm._output.training_metrics, jm._output.training_metrics
    for k in ("rmse", "logloss"):
        if getattr(jmet, k, None) is not None:
            assert abs(getattr(tmet, k) - getattr(jmet, k)) < 2e-3, k
    cols = slice(0, 1) if dist in ("gaussian", "poisson") else slice(1, None)
    tp = tm.predict(tf).to_numpy()[:, cols]
    jp = jm.predict(jf).to_numpy()[:, cols].astype(float)
    assert np.abs(tp.mean(0) - jp.mean(0)).max() < 5e-3
    assert tm._trees_k[0].depth == 12 if dist == "multinomial" \
        else tm._trees.depth == 12


@pytest.mark.parametrize("dist", ["huber", "quantile"])
def test_huber_and_quantile_raise_in_both(port_cpu, dist):
    """Huber and quantile GBM run on no engine of the JAX package: both
    packages raise NotImplementedError."""
    jf, tf = frames("regression", n=200)
    for cls, fr in ((JMODELS.H2OGradientBoostingEstimator, jf),
                    (h2o3_tpu_torch.H2OGradientBoostingEstimator, tf)):
        with pytest.raises(NotImplementedError, match=dist):
            cls(ntrees=2, max_depth=3, distribution=dist).train(
                y="y", training_frame=fr)


def test_adaptive_checkpoint_restart_matches_jax(port_cpu):
    """A bernoulli UniformAdaptive GBM of 3 trees, restarted to 6 in both
    packages, and from the JAX prior carried across by convert.py (no
    engine named: an adaptive prior); the prior without covers rebuilds
    them from the training rows. Trees node for node, predictions and
    history within 1e-5, the validation series included."""
    kw = dict(max_depth=4, min_rows=20, seed=2, distribution="bernoulli",
              histogram_type="UniformAdaptive", score_tree_interval=3)
    jf, tf = frames("binomial")
    vj, vt = frames("binomial", n=300, seed=8)
    j1 = JMODELS.H2OGradientBoostingEstimator(ntrees=3, **kw)
    j1.train(y="y", training_frame=jf)
    j2 = JMODELS.H2OGradientBoostingEstimator(ntrees=6, checkpoint=j1, **kw)
    j2.train(y="y", training_frame=jf, validation_frame=vj)
    t1 = h2o3_tpu_torch.H2OGradientBoostingEstimator(ntrees=3,
                                                     model_id="ad_ck", **kw)
    t1.train(y="y", training_frame=tf)
    ta = j1._trees
    carried = convert.gbm_from_arrays(
        col=_np(ta.col), thr=_np(ta.thr), na_left=_np(ta.na_left),
        value=_np(ta.value), depth=ta.depth, f0=j1._f0,
        distribution="bernoulli", learn_rate=0.1,
        predictors=j1._dinfo.predictors, domains=j1._dinfo.domains,
        response_name="y", response_domain=j1._dinfo.response_domain)
    assert carried._trees.cover is None
    for prior in ("ad_ck", carried):
        t2 = h2o3_tpu_torch.H2OGradientBoostingEstimator(
            ntrees=6, checkpoint=prior, **kw)
        t2.train(y="y", training_frame=tf, validation_frame=vt)
        assert t2.summary()["engine"] == "adaptive"
        same_trees(t2._trees, j2._trees)
        np.testing.assert_allclose(t2.predict(tf).to_numpy()[:, 1:],
                                   j2.predict(jf).to_numpy()[:, 1:]
                                   .astype(float), atol=TOL)
        same_history(t2.scoring_history(), j2.scoring_history())
    # the rebuilt covers: the training rows' weights through each tree
    np.testing.assert_allclose(_np(t2._trees.cover[:3, 0]), tf.nrows)
    with pytest.raises(AssertionError, match="identical max_depth"):
        h2o3_tpu_torch.H2OGradientBoostingEstimator(
            ntrees=6, checkpoint="ad_ck", **dict(kw, max_depth=5)).train(
            y="y", training_frame=tf)
    h2o3_tpu.remove(j1.key)


# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def deep_drf(port_cpu):
    """A binomial DRF at H2O's defaults (depth 20, mtries -1 -> 2 of 4,
    sample_rate 0.632), 3 trees, the same bags and level draws."""
    return both("binomial", JMODELS.H2ORandomForestEstimator,
                h2o3_tpu_torch.H2ORandomForestEstimator, scheme="tree3",
                ntrees=3, seed=3, score_tree_interval=3)


def test_deep_drf_matches_jax(deep_drf):
    """Depth 20 on 0/1 stats: the trees node for node (2^21 - 1 nodes),
    OOB metrics and history within 1e-5, probabilities equal."""
    jf, tf, jm, tm = deep_drf
    assert tm._trees.depth == 20 and tm.summary()["engine"] == "adaptive"
    assert int((_np(tm._trees.col) >= 0).sum()) > 50
    same_trees(tm._trees, jm._trees, values=0.0)
    same_history(tm.scoring_history(), jm.scoring_history())
    for k in ("auc", "logloss", "rmse"):
        assert abs(getattr(tm._output.training_metrics, k)
                   - getattr(jm._output.training_metrics, k)) < TOL
    np.testing.assert_allclose(tm.predict(tf).to_numpy()[:, 1:],
                               jm.predict(jf).to_numpy()[:, 1:]
                               .astype(float), atol=TOL)


def test_multinomial_drf_matches_jax(port_cpu):
    """Three classes, depth 20, 3 iterations with the same bags and draws:
    every class's trees node for node, probabilities within 1e-5; carried
    across by convert.drf_from_arrays it scores the same; stopping_rounds
    raises in both packages."""
    kw = dict(ntrees=3, seed=4)
    jf, tf, jm, tm = both("multinomial", JMODELS.H2ORandomForestEstimator,
                          h2o3_tpu_torch.H2ORandomForestEstimator,
                          scheme="iter2", **kw)
    for t, j in zip(tm._trees_k, jm._trees_k):
        same_trees(t, j, values=0.0)
    jp = jm.predict(jf).to_numpy()[:, 1:].astype(float)
    np.testing.assert_allclose(tm.predict(tf).to_numpy()[:, 1:], jp,
                               atol=TOL)
    assert tm.summary()["number_of_trees"] == 3
    assert tm.summary()["oob_scored"] is False
    carried = convert.drf_from_arrays(
        col=[_np(t.col) for t in jm._trees_k],
        thr=[_np(t.thr) for t in jm._trees_k],
        na_left=[_np(t.na_left) for t in jm._trees_k],
        value=[_np(t.value) for t in jm._trees_k], depth=20,
        predictors=jm._dinfo.predictors, domains=jm._dinfo.domains,
        response_name="y", response_domain=jm._dinfo.response_domain)
    np.testing.assert_allclose(carried.predict(tf).to_numpy()[:, 1:], jp,
                               atol=TOL)
    for cls, fr in ((JMODELS.H2ORandomForestEstimator, jf),
                    (h2o3_tpu_torch.H2ORandomForestEstimator, tf)):
        with pytest.raises(NotImplementedError, match="stopping_rounds"):
            cls(ntrees=2, stopping_rounds=2).train(y="y", training_frame=fr)


def test_deep_drf_carried_across_scores_the_same(deep_drf):
    """The JAX deep forest through convert.drf_from_arrays (an adaptive
    forest, no bin spec): the same probabilities within 1e-5."""
    jf, tf, jm, _ = deep_drf
    t = jm._trees
    model = convert.drf_from_arrays(
        col=_np(t.col), thr=_np(t.thr), na_left=_np(t.na_left),
        value=_np(t.value), cover=_np(t.cover), depth=t.depth,
        predictors=jm._dinfo.predictors, domains=jm._dinfo.domains,
        response_name="y", response_domain=jm._dinfo.response_domain)
    np.testing.assert_allclose(model.predict(tf).to_numpy()[:, 1:],
                               jm.predict(jf).to_numpy()[:, 1:]
                               .astype(float), atol=TOL)


def test_predict_leaf_ids_matches_jax(deep_drf):
    """Every row's terminal node and depth in every tree of the deep
    forest, as the JAX package's leaf-id walk gives them."""
    jf, tf, jm, tm = deep_drf
    X = np.asarray(jm._dinfo.matrix(jf))[: jf.nrows]
    jn, jd = (np.asarray(a) for a in JE.predict_leaf_ids(jnp.asarray(X),
                                                         jm._trees))
    tn, td = (_np(a) for a in TE.predict_leaf_ids(_t(X), tm._trees))
    np.testing.assert_array_equal(tn, jn)
    np.testing.assert_array_equal(td, jd)
    assert td.max() > 8


# ---------------------------------------------------------------------------
def test_treeshap_matches_jax(port_cpu, deep_drf):
    """TreeSHAP of the same carried trees in both packages within 1e-5
    (the port builds native/treeshap.cpp itself); the port's
    predict_contributions of its own adaptive GBM and deep DRF sum to the
    margin and to the probability, within 1e-5."""
    jf, tf = frames("binomial")
    jm = JMODELS.H2OGradientBoostingEstimator(
        ntrees=4, max_depth=5, seed=1, histogram_type="UniformAdaptive")
    jm.train(y="y", training_frame=jf)
    X = np.asarray(jm._dinfo.matrix(jf), np.float64)[: jf.nrows]
    jphi = JC.ensemble_shap(jm._trees, X)
    tt = TE.TreeArrays(col=_t(jm._trees.col), thr=_t(jm._trees.thr),
                       na_left=_t(jm._trees.na_left),
                       value=_t(jm._trees.value), depth=jm._trees.depth,
                       cover=_t(jm._trees.cover))
    np.testing.assert_allclose(TC.ensemble_shap(tt, X), jphi, atol=TOL)
    tm = h2o3_tpu_torch.H2OGradientBoostingEstimator(
        ntrees=4, max_depth=5, seed=1, histogram_type="UniformAdaptive")
    tm.train(y="y", training_frame=tf)
    phi = tm.predict_contributions(tf)
    assert phi.names == [f"x{j}" for j in range(4)] + ["BiasTerm"]
    p1 = tm.predict(tf).to_numpy()[:, 2]
    margin = np.log(p1 / (1 - p1))
    np.testing.assert_allclose(phi.to_numpy().sum(1), margin, atol=1e-4)
    _, tf3, _, drf = deep_drf
    s = drf.predict_contributions(tf3).to_numpy().sum(1)
    np.testing.assert_allclose(s, drf.predict(tf3).to_numpy()[:, 2],
                               atol=TOL)


def test_host_build_raises_on_a_broken_source(tmp_path, monkeypatch):
    """The host build of a native source that does not compile, or that is
    missing, raises BuildError (no fallback); one that compiles loads."""
    from h2o3_tpu_torch.ops import _build
    native = tmp_path / "native"
    native.mkdir()
    (native / "broken.cpp").write_text("this is not C++\n")
    (native / "fine.cpp").write_text('extern "C" int answer() '
                                     "{ return 42; }\n")
    monkeypatch.setattr(_build, "NATIVE", native)
    monkeypatch.setattr(_build, "BUILD", tmp_path / "build")
    with pytest.raises(_build.BuildError, match="build of broken failed"):
        _build.load_host("broken")
    with pytest.raises(_build.BuildError, match="not found"):
        _build.load_host("absent")
    assert _build.load_host("fine").answer() == 42

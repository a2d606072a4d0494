"""KMeans, PCA, SVD and GLRM of the port against the JAX package, on the
CPU.

One seeded frame (five numeric columns drawn around four centres, with NA
values, and a categorical column with NA values) goes to both packages;
GLRM also gets a frame of rank 3 plus N(0, 0.05²) noise with 8% of its
entries NA. Tolerances:
- KMeans: the same numpy draws pick the same initial rows, so the
  assignments are equal and the centroids within 1e-5; tot_withinss,
  totss and each withinss within 1e-5 relative, the sizes and nobs equal
  (the port sums exactly in fixed point, the JAX package in f32; its
  standardising statistics sum in f32 too, ROADMAP.md §3);
- PCA and SVD: eigenvalues (std deviations, d) within 1e-5 relative;
  the rotation and V within 1e-4 (an eigenvector moves by the Gram's f32
  error over the gap to its neighbour's eigenvalue), SVD's V up to each
  column's sign (PCA's sign rule fixes it, SVD has none); projections
  and U within 1e-4 of their largest magnitude;
- GLRM: every objective of the series within 1e-5 relative, the
  archetypes within 1e-4 of their largest, the reconstruction and the
  archetype coefficients within 1e-4 of theirs (batched f32 k×k solves);
- a JAX model carried across by `*_from_arrays`: its scores within 1e-6
  of their largest (one product on the same parameters), GLRM's within
  1e-5 (a batched f32 k×k solve of Grams summed in another order), and
  KMeans' assignments equal.
"""

import numpy as np
import pytest
import torch

import h2o3_tpu.models as JMODELS
import h2o3_tpu_torch
from h2o3_tpu.core.frame import Frame as JFrame
from h2o3_tpu_torch import convert
from h2o3_tpu_torch.core.frame import Frame, Vec
from h2o3_tpu_torch.models import glrm as TGLRM
from h2o3_tpu_torch.models import kmeans as TKM

N = 1500
TOL = 1e-5
TRANSFORMS = ["NONE", "STANDARDIZE", "NORMALIZE", "DEMEAN", "DESCALE"]


def _pair(cols):
    return (JFrame.from_dict(cols),
            Frame(list(cols), [Vec.from_numpy(v) for v in cols.values()]))


@pytest.fixture(scope="module")
def frames():
    h2o3_tpu_torch.init(device="cpu")
    rng = np.random.default_rng(8)
    centres = rng.normal(0, 3, (4, 5))
    X = centres[rng.integers(0, 4, N)] + rng.normal(size=(N, 5))
    X[:, 2] = 4 * X[:, 2] + 1
    X[rng.random((N, 5)) < 0.04] = np.nan
    col = np.array(rng.choice(["r", "g", "b"], N), object)
    col[rng.random(N) < 0.05] = None
    cols = {f"x{j}": X[:, j] for j in range(5)}
    cols["col"] = col
    cols["w"] = rng.uniform(0.5, 2.0, N)
    yield _pair(cols)
    h2o3_tpu_torch.shutdown()


@pytest.fixture(scope="module")
def low_rank(frames):
    rng = np.random.default_rng(12)
    X = rng.normal(size=(N, 3)) @ rng.normal(size=(3, 8)) \
        + rng.normal(0, 0.05, (N, 8))
    X[rng.random(X.shape) < 0.08] = np.nan
    return _pair({f"v{j}": X[:, j] for j in range(8)})


XS = ["x0", "x1", "x2", "x3", "x4", "col"]


def _both(frames, jcls, tcls, x=XS, **params):
    jf, tf = frames
    jm = jcls(**params)
    jm.train(x=x, training_frame=jf)
    tm = tcls(**params)
    tm.train(x=x, training_frame=tf)
    return jm, tm


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


# ---------------------------------------------------------------------------
KM_CASES = {"Random": {}, "PlusPlus": {}, "Furthest": {},
            "user_points": {"user_points": [[0.5] * 8, [-0.5] * 8,
                                            [1.0] + [0.0] * 7,
                                            [0.0] * 7 + [1.0]]}}


@pytest.mark.parametrize("init", list(KM_CASES))
def test_kmeans_matches_jax(frames, init):
    jf, tf = frames
    params = dict(k=4, seed=2, **KM_CASES[init])
    if init != "user_points":
        params["init"] = init
    jm, tm = _both(frames, JMODELS.H2OKMeansEstimator,
                   h2o3_tpu_torch.H2OKMeansEstimator, **params)
    assert np.abs(jm.centers() - tm.centers()).max() <= TOL
    np.testing.assert_array_equal(jm.predict(jf).to_numpy(),
                                  tm.predict(tf).to_numpy())
    a, b = jm.centroid_stats(), tm.centroid_stats()
    for name in ("tot_withinss", "totss", "betweenss", "withinss"):
        assert _rel(getattr(a, name), getattr(b, name)) <= TOL, name
    assert a.size == b.size and a.nobs == b.nobs
    assert len(jm.scoring_history()) == len(tm.scoring_history())
    assert tm.tot_withinss() == b.to_dict()["tot_withinss"]


def test_kmeans_trains_the_same_bits_twice(frames):
    """The Lloyd sums are exact in fixed point: a second training gives
    the same centroids bit for bit, and so does a step over the rows in
    another order."""
    _, tf = frames
    a, b = (h2o3_tpu_torch.H2OKMeansEstimator(k=4, seed=3, init="PlusPlus")
            for _ in range(2))
    for m in (a, b):
        m.train(x=XS, training_frame=tf)
    assert torch.equal(a._centroids, b._centroids)
    X = a._dinfo.matrix(tf)
    w = torch.rand(X.shape[0], generator=torch.Generator().manual_seed(1))
    perm = torch.randperm(X.shape[0], generator=torch.Generator()
                          .manual_seed(2))
    one = TKM._lloyd_step(X, a._centroids, w)
    two = TKM._lloyd_step(X[perm], a._centroids, w[perm])
    assert torch.equal(one[0][perm], two[0])
    for s, t in zip(one[1:], two[1:]):
        assert torch.equal(s, t)


@pytest.mark.parametrize("transform", TRANSFORMS + ["weighted"])
def test_pca_matches_jax(frames, transform):
    jf, tf = frames
    params = dict(k=3, transform=transform)
    if transform == "weighted":
        params = dict(k=3, transform="STANDARDIZE", weights_column="w")
    jm, tm = _both(frames, JMODELS.H2OPrincipalComponentAnalysisEstimator,
                   h2o3_tpu_torch.H2OPrincipalComponentAnalysisEstimator,
                   **params)
    assert _rel(jm.summary()["std_deviation"],
                tm.summary()["std_deviation"]) <= TOL
    assert _rel(jm.summary()["cumulative_proportion"],
                tm.summary()["cumulative_proportion"]) <= TOL
    assert np.abs(jm.rotation() - tm.rotation()).max() <= 1e-4
    jp, tp = jm.predict(jf), tm.predict(tf)
    assert tp.names == jp.names == ["PC1", "PC2", "PC3"]
    assert _rel(jp.to_numpy(), tp.to_numpy()) <= 1e-4


@pytest.mark.parametrize("transform", TRANSFORMS)
def test_svd_matches_jax(frames, transform):
    jf, tf = frames
    jm, tm = _both(frames, JMODELS.H2OSingularValueDecompositionEstimator,
                   h2o3_tpu_torch.H2OSingularValueDecompositionEstimator,
                   nv=3, transform=transform)
    assert _rel(jm.d(), tm.d()) <= TOL
    sign = np.sign((jm.v() * tm.v()).sum(axis=0))
    assert np.abs(jm.v() - tm.v() * sign).max() <= 1e-4
    assert tm.u().names == ["u1", "u2", "u3"]
    assert _rel(jm.u().to_numpy(), tm.u().to_numpy() * sign) <= 1e-4
    assert _rel(jm.predict(jf).to_numpy(),
                tm.predict(tf).to_numpy() * sign) <= 1e-4


# gamma 0 stops by min_step_size at its 5th iteration, far from the
# threshold (the last relative change is 0.07 of it); with the ridges the
# objective falls about min_step_size a step, so that fit is capped at
# 20 iterations instead of stopping within f32 noise of the threshold
GLRM_CASES = {"stops": dict(gamma_x=0.0, gamma_y=0.0),
              "ridges": dict(gamma_x=1.0, gamma_y=0.5, max_iterations=20)}


@pytest.fixture(scope="module")
def glrm_fits(low_rank):
    cache = {}

    def get(case):
        if case not in cache:
            cache[case] = _both(
                low_rank, JMODELS.H2OGeneralizedLowRankEstimator,
                h2o3_tpu_torch.H2OGeneralizedLowRankEstimator,
                x=[f"v{j}" for j in range(8)], k=3, seed=4,
                **GLRM_CASES[case])
        return cache[case]
    return get


@pytest.mark.parametrize("case", list(GLRM_CASES))
def test_glrm_matches_jax(low_rank, glrm_fits, case):
    jf, tf = low_rank
    jm, tm = glrm_fits(case)
    jo = [h["objective"] for h in jm.scoring_history()]
    to = [h["objective"] for h in tm.scoring_history()]
    assert len(jo) == len(to) == {"stops": 5, "ridges": 20}[case]
    assert _rel(jo, to) <= TOL
    assert all(b <= a * (1 + 1e-6) for a, b in zip(to, to[1:]))
    assert _rel(jm.archetypes(), tm.archetypes()) <= 1e-4
    jr, tr = jm.reconstruct(jf), tm.reconstruct(tf)
    assert tr.names == jr.names
    assert _rel(jr.to_numpy(), tr.to_numpy()) <= 1e-4
    assert _rel(jm.predict(jf).to_numpy(), tm.predict(tf).to_numpy()) <= 1e-4


def test_glrm_grams_are_the_einsum():
    """step_A's per-row Grams M·P and step_B's per-column Mᵀ·(A⊗A) are the
    JAX package's einsums; a row with nothing observed solves to 0."""
    g = torch.Generator().manual_seed(5)
    M = (torch.rand((50, 8), generator=g) < 0.8).float()
    M[0] = 0.0
    X = torch.randn((50, 8), generator=g) * M
    B = torch.randn((3, 8), generator=g)
    G = torch.einsum("ki,ni,li->nkl", B, M, B) + 0.1 * torch.eye(3)
    A = TGLRM.step_A(X, M, B, 0.1 - 1e-6)
    torch.testing.assert_close(A, torch.linalg.solve(G, X @ B.T),
                               rtol=1e-5, atol=1e-5)
    assert bool((A[0] == 0).all())
    Gb = torch.einsum("nk,ni,nl->ikl", A, M, A) + 0.2 * torch.eye(3)
    torch.testing.assert_close(TGLRM.step_B(X, M, A, 0.2 - 1e-6),
                               torch.linalg.solve(Gb, (A.T @ X).T).T,
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
def _carried(family, jm):
    di = jm._dinfo
    codec = dict(predictors=di.predictors, domains=di.domains,
                 means=di.means, sigmas=di.sigmas)
    if family == "kmeans":
        return convert.kmeans_from_arrays(
            centroids=np.asarray(jm._centroids),
            standardize=di.standardize, **codec)
    if family == "pca":
        return convert.pca_from_arrays(
            rotation=jm._rotation, mean=jm._mean, sd=jm._sd,
            transform=jm._transform, **codec)
    if family == "svd":
        return convert.svd_from_arrays(
            v=jm._v, d=jm._d, mean=jm._mean, sd=jm._sd,
            transform=jm._transform, **codec)
    return convert.glrm_from_arrays(archetypes=jm._B,
                                    gamma_x=jm.params["gamma_x"], **codec)


@pytest.mark.parametrize("family", ["kmeans", "pca", "svd", "glrm"])
def test_jax_models_carried_across_score_the_same(frames, low_rank,
                                                  glrm_fits, family):
    if family == "glrm":
        (jf, tf), jm = low_rank, glrm_fits("ridges")[0]
    else:
        jf, tf = frames
        jcls = {"kmeans": JMODELS.H2OKMeansEstimator,
                "pca": JMODELS.H2OPrincipalComponentAnalysisEstimator,
                "svd": JMODELS.H2OSingularValueDecompositionEstimator}[family]
        params = {"kmeans": dict(k=4, seed=2),
                  "pca": dict(k=3, transform="STANDARDIZE"),
                  "svd": dict(nv=3, transform="DEMEAN")}[family]
        jm = jcls(**params)
        jm.train(x=XS, training_frame=jf)
    cm = _carried(family, jm)
    jp, cp = jm.predict(jf).to_numpy(), cm.predict(tf).to_numpy()
    if family == "kmeans":
        np.testing.assert_array_equal(jp, cp)
    else:
        assert _rel(jp, cp) <= (1e-5 if family == "glrm" else 1e-6)


@pytest.mark.parametrize("cls,name,value", [
    ("H2OKMeansEstimator", "estimate_k", True),
    ("H2OPrincipalComponentAnalysisEstimator", "use_all_factor_levels", True),
    ("H2OPrincipalComponentAnalysisEstimator", "impute_missing", False),
    ("H2OGeneralizedLowRankEstimator", "loss", "Absolute"),
    ("H2OGeneralizedLowRankEstimator", "regularization_x", "L1"),
    ("H2OGeneralizedLowRankEstimator", "regularization_y", "NonNegative"),
    ("H2OGeneralizedLowRankEstimator", "init", "SVD"),
    ("H2OGeneralizedLowRankEstimator", "transform", "STANDARDIZE"),
    ("H2OGeneralizedLowRankEstimator", "recover_svd", True)])
def test_ignored_unsupervised_options_raise(frames, cls, name, value):
    """What the JAX package accepts and never reads raises. PCA's
    pca_method and SVD's svd_method are taken: every method collapses onto
    GramSVD by design in both packages."""
    _, tf = frames
    with pytest.raises(NotImplementedError, match="not supported"):
        getattr(h2o3_tpu_torch, cls)(**{name: value}).train(
            x=XS, training_frame=tf)


def test_every_method_is_gram_svd(frames):
    _, tf = frames
    base = h2o3_tpu_torch.H2OPrincipalComponentAnalysisEstimator(k=2)
    base.train(x=XS, training_frame=tf)
    for method in ("Power", "Randomized"):
        m = h2o3_tpu_torch.H2OPrincipalComponentAnalysisEstimator(
            k=2, pca_method=method)
        m.train(x=XS, training_frame=tf)
        np.testing.assert_array_equal(m.rotation(), base.rotation())
    s = h2o3_tpu_torch.H2OSingularValueDecompositionEstimator(
        nv=2, svd_method="Power")
    s.train(x=XS, training_frame=tf)
    assert s.summary()["method"] == "GramSVD"

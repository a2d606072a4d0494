"""GLM's sparse path in the port against the JAX package, on the CPU.

A seeded SVMLight file goes through both packages' `import_file`; the
GLM on its all-sparse predictors takes the sparse L-BFGS path in both.
Tolerances:
- `_sparse_path_ok` equal to the JAX package's over a grid of family,
  link, solver, alpha, lambda, intercept, bounds, lambda search and
  non_negative;
- coefficients: the JAX package's L-BFGS stops at 1e-7 relative on its
  f32 objective, the port's at `SPARSE_LBFGS_TOL` on a float64 one (up
  to 6e-4 of the largest apart), so both are held
  against the float64 optimum (a numpy Newton solve of the dense design)
  within 5e-3 of its largest coefficient, the reach of the JAX stop,
  and the port within 1e-6 of a float64 numpy twin of its own L-BFGS;
- `predict_sparse` of the JAX fit's coefficients carried into the port
  within 1e-5 of the JAX package's, and their `model_performance` AUC
  within 1e-5;
- the whole slice, `import_file(svm)` -> `train` -> `model_performance`:
  AUC within 1e-5 of the float64 twin's (its probabilities through the
  port's binned AUC), within 1e-4 of the JAX fit's
  (measured 8e-6 to 3e-5 apart: the stop again);
- no call of `Frame.matrix` over more than one column while training,
  scoring the metrics or `predict_sparse` (the JAX package's own test
  poisons it the same way).
"""

import itertools

import numpy as np
import pytest
import torch

import h2o3_tpu.models as JMODELS
import h2o3_tpu_torch
from h2o3_tpu.core.frame import Vec as JVec
from h2o3_tpu.core.kvstore import DKV as JDKV
from h2o3_tpu.io import parser as JP
from h2o3_tpu_torch import convert
from h2o3_tpu_torch.core.frame import Frame, SparseVec, Vec
from h2o3_tpu_torch.core.kvstore import DKV
from h2o3_tpu_torch.io import parser as TP
from h2o3_tpu_torch.models import glm as TG
from h2o3_tpu_torch.models import metrics as TM

N, C = 1024, 120


def _write_svm(path, seed=2, fam="binomial"):
    rng = np.random.default_rng(seed)
    beta = np.zeros(C)
    beta[:3] = [2.0, -2.0, 1.5]
    lines = []
    for _ in range(N):
        idx = np.nonzero(rng.random(C) < 0.05)[0]
        v = rng.normal(size=len(idx)).astype(np.float32)
        eta = float(v @ beta[idx])
        if fam == "binomial":
            y = int(rng.random() < 1 / (1 + np.exp(-eta)))
        elif fam == "poisson":
            y = int(rng.poisson(np.exp(0.3 * eta)))
        else:
            y = f"{eta + rng.normal(0, 0.5):.6f}"
        lines.append(f"{y} " + " ".join(f"{j}:{x:.9g}"
                                        for j, x in zip(idx, v)))
    path.write_text("\n".join(lines) + "\n")


@pytest.fixture(scope="module")
def cpu():
    h2o3_tpu_torch.init(device="cpu")
    yield
    h2o3_tpu_torch.shutdown()


@pytest.fixture(scope="module")
def frames(cpu, tmp_path_factory):
    out = {}
    for fam in ("binomial", "poisson", "gaussian"):
        p = tmp_path_factory.mktemp("svm") / f"{fam}.svm"
        _write_svm(p, fam=fam)
        out[fam] = (JP.import_file(str(p)), TP.import_file(str(p)))
    return out


@pytest.fixture()
def no_dense(monkeypatch):
    """Frame.matrix over more than one column fails the test."""
    orig = Frame.matrix

    def poisoned(self, cols=None):
        if len(list(cols if cols is not None else self.names)) > 1:
            raise AssertionError("dense design matrix materialised")
        return orig(self, cols)
    monkeypatch.setattr(Frame, "matrix", poisoned)
    monkeypatch.setattr(SparseVec, "as_f32", lambda self: (_ for _ in ())
                        .throw(AssertionError("sparse column densified")))
    return monkeypatch


# ---------------------------------------------------------------------------
_FAMS = {"gaussian": ("identity", "log"), "binomial": ("logit", "log"),
         "quasibinomial": ("logit",), "poisson": ("log", "identity"),
         "gamma": ("inverse",), "tweedie": ("tweedie",)}


@pytest.mark.parametrize("fam", list(_FAMS))
@pytest.mark.parametrize("solver", ["AUTO", "IRLSM", "L_BFGS",
                                    "COORDINATE_DESCENT"])
def test_sparse_path_ok_matches_jax(fam, solver):
    grid = itertools.product(
        _FAMS[fam], (None, 0.0, 0.5, [0.0]), (None, 0.0, 1e-3, [0.01]),
        (True, False), (None, {"C1": (-1.0, 1.0)}), (False, True),
        (False, True))
    n = 0
    for link, alpha, lam, icpt, bounds, search, nonneg in grid:
        params = dict(family=fam, solver=solver, alpha=alpha, lambda_=lam,
                      intercept=icpt, beta_constraints=bounds,
                      lambda_search=search, non_negative=nonneg)
        jm = JMODELS.H2OGeneralizedLinearEstimator(**params)
        tm = h2o3_tpu_torch.H2OGeneralizedLinearEstimator(**params)
        for m in (jm, tm):
            m._family, m._link = fam, link
        assert tm._sparse_path_ok() == jm._sparse_path_ok(), params
        n += tm._sparse_path_ok()
    for extra in ({"interactions": ["C1", "C2"]},
                  {"quadratic_penalty": np.eye(2)}):
        jm = JMODELS.H2OGeneralizedLinearEstimator(family=fam, **extra)
        tm = h2o3_tpu_torch.H2OGeneralizedLinearEstimator(family=fam,
                                                          **extra)
        for m in (jm, tm):
            m._family, m._link = fam, _FAMS[fam][0]
        assert tm._sparse_path_ok() == jm._sparse_path_ok() is False


# ---------------------------------------------------------------------------
def _dense(tf):
    return np.column_stack([tf.vec(c).to_numpy() for c in tf.names[1:]])


def _newton(X, y, fam, l2):
    """The float64 optimum: Newton on the dense design, intercept last and
    unpenalised."""
    Xi = np.c_[X, np.ones(len(y))]
    b = np.zeros(Xi.shape[1])
    if fam == "binomial":
        b[-1] = np.log(y.mean() / (1 - y.mean()))
    elif fam == "poisson":
        b[-1] = np.log(y.mean())
    for _ in range(100):
        eta = Xi @ b
        if fam == "binomial":
            mu = 1 / (1 + np.exp(-eta))
            W = mu * (1 - mu)
        elif fam == "poisson":
            mu = np.exp(eta)
            W = mu
        else:
            mu, W = eta, np.ones(len(y))
        g = Xi.T @ (mu - y)
        g[:-1] += l2 * b[:-1]
        H = Xi.T @ (Xi * W[:, None])
        H[:-1, :-1] += l2 * np.eye(Xi.shape[1] - 1)
        d = np.linalg.solve(H, g)
        b -= d
        if np.abs(d).max() < 1e-13:
            break
    return b


def _twin(X, y, fam, l2, x0):
    """The port's L-BFGS on a float64 numpy objective of the dense
    design: the port's fit must be this one."""
    Xi = np.c_[X, np.ones(len(y))]

    def vg(x):
        eta = Xi @ x
        if fam == "binomial":
            ll = np.logaddexp(0.0, eta) - y * eta
            r = 1 / (1 + np.exp(-eta)) - y
        elif fam == "poisson":
            ll = np.exp(eta) - y * eta
            r = np.exp(eta) - y
        else:
            ll = 0.5 * (y - eta) ** 2
            r = eta - y
        g = Xi.T @ r
        g[:-1] += l2 * x[:-1]
        return float(ll.sum() + 0.5 * l2 * (x[:-1] ** 2).sum()), g
    return TG._lbfgs(vg, x0, max_iter=200, tol=TG.SPARSE_LBFGS_TOL)[0]


@pytest.mark.parametrize("fam,lam", [("binomial", 0.002), ("binomial", None),
                                     ("poisson", 0.001), ("gaussian", None)])
def test_sparse_fit_matches_jax_and_float64(frames, no_dense, fam, lam):
    jf, tf = frames[fam]
    kw = dict(family=fam, alpha=0.0) if lam else dict(family=fam)
    if lam:
        kw["lambda_"] = lam
    jm = JMODELS.H2OGeneralizedLinearEstimator(**kw)
    jm.train(y="target", training_frame=jf)
    tm = h2o3_tpu_torch.H2OGeneralizedLinearEstimator(**kw)
    tm.train(y="target", training_frame=tf)
    assert tm._sparse_fit and jm._sparse_fit
    assert tm._solver == jm._solver == "L_BFGS"
    assert tm._dinfo.standardize is False
    bt, bj = tm._state.beta, np.asarray(jm._state.beta, np.float64)
    no_dense.undo()
    X, y = _dense(tf), tf.vec("target").to_numpy()
    l2 = (lam or 0.0) * N
    opt = _newton(X, y, fam, l2)
    scale = np.abs(opt).max()
    assert np.abs(bt - opt).max() <= 5e-3 * scale
    assert np.abs(bj - opt).max() <= 5e-3 * scale
    x0 = tm._sparse_objective(tf)[1]
    twin = _twin(X, y, fam, l2, x0)
    assert np.abs(bt - twin).max() <= 1e-6 * np.abs(twin).max()
    # the raw-space coefficients are the user's
    assert tm.coef()["C1"] == bt[0]
    assert tm.coef()["Intercept"] == bt[-1]


@pytest.mark.parametrize("fam", ["binomial", "poisson", "gaussian"])
def test_predict_sparse_of_a_carried_jax_fit(frames, no_dense, fam):
    jf, tf = frames[fam]
    jm = JMODELS.H2OGeneralizedLinearEstimator(family=fam)
    jm.train(y="target", training_frame=jf)
    di = jm._dinfo
    tm = convert.glm_from_arrays(
        beta=np.asarray(jm._state.beta), family=jm._state.family,
        link=jm._state.link, predictors=list(di.predictors),
        domains={}, response_name="target", means=dict(di.means),
        sigmas=dict(di.sigmas), standardize=di.standardize,
        sparse_fit=jm._sparse_fit)
    pj = np.asarray(jm.predict_sparse(jf), np.float64)
    pt = tm.predict_sparse(tf)
    assert np.abs(pt - pj).max() <= 1e-5 * max(1.0, np.abs(pj).max())
    mt, mj = tm.model_performance(tf), jm.model_performance(jf)
    assert abs(mt.mse - mj.mse) <= 1e-5 * max(1.0, mj.mse)


@pytest.fixture(scope="module")
def classed(cpu, tmp_path_factory):
    """The binomial file with its target made categorical, in both."""
    p = tmp_path_factory.mktemp("svmc") / "c.svmlight"
    _write_svm(p, seed=5)
    jf, tf = JP.import_file(str(p)), TP.import_file(str(p))
    yc = np.array(["0", "1"], object)[
        tf.vec("target").to_numpy().astype(int)]
    jf["target"] = JVec.from_numpy(yc)
    tf["target"] = Vec.from_numpy(yc)
    return jf, tf


def test_whole_slice_import_train_model_performance(classed, no_dense):
    jf, tf = classed
    jm = JMODELS.H2OGeneralizedLinearEstimator(family="binomial")
    jm.train(y="target", training_frame=jf)
    tm = h2o3_tpu_torch.H2OGeneralizedLinearEstimator(family="binomial")
    tm.train(y="target", training_frame=tf, validation_frame=tf)
    assert tm._sparse_fit
    perf = tm.model_performance(tf)
    assert perf.auc == tm.auc() == tm._output.validation_metrics.auc
    no_dense.undo()
    X = _dense(tf)
    y = (tf.vec("target").to_numpy() == 1).astype(np.float64)
    twin = _twin(X, y, "binomial", 0.0, tm._sparse_objective(tf)[1])
    mu = 1 / (1 + np.exp(-(np.c_[X, np.ones(N)] @ twin)))
    auc_twin = TM.binomial_metrics(torch.tensor(y, dtype=torch.float32),
                                   torch.tensor(mu, dtype=torch.float32)).auc
    assert abs(perf.auc - auc_twin) <= 1e-5
    assert abs(perf.auc - jm.model_performance(jf).auc) <= 1e-4
    # carried: the same coefficients score the same AUC in both
    di = jm._dinfo
    cm = convert.glm_from_arrays(
        beta=np.asarray(jm._state.beta), family="binomial", link="logit",
        predictors=list(di.predictors), domains={}, response_name="target",
        response_domain=["0", "1"], means=dict(di.means),
        sigmas=dict(di.sigmas), standardize=False, sparse_fit=True)
    assert abs(cm.model_performance(tf).auc
               - jm.model_performance(jf).auc) <= 1e-5
    # dense scoring still works (it densifies, as in the JAX package)
    pf = tm.predict(tf)
    assert pf.nrows == N
    DKV.remove(pf.key)


def test_sparse_nas_are_zeros_and_dense_options_leave_the_path(cpu):
    rng = np.random.default_rng(4)
    n = 256
    rows = [np.sort(rng.choice(n, 40, replace=False)) for _ in range(5)]
    vals = [rng.normal(size=40).astype(np.float32) for _ in range(5)]
    y = rng.normal(size=n)
    nan_vals = [v.copy() for v in vals]
    nan_vals[0][3] = np.nan
    zero_vals = [v.copy() for v in vals]
    zero_vals[0][3] = 0.0

    def frame(vs):
        return Frame(["y"] + [f"x{j}" for j in range(5)],
                     [Vec.from_numpy(y)] + [SparseVec(r, v, n)
                                            for r, v in zip(rows, vs)])
    a = h2o3_tpu_torch.H2OGeneralizedLinearEstimator(family="gaussian")
    a.train(y="y", training_frame=frame(nan_vals))
    b = h2o3_tpu_torch.H2OGeneralizedLinearEstimator(family="gaussian")
    b.train(y="y", training_frame=frame(zero_vals))
    assert a._sparse_fit and np.array_equal(a._state.beta, b._state.beta)
    c = h2o3_tpu_torch.H2OGeneralizedLinearEstimator(family="gaussian",
                                                     solver="IRLSM")
    c.train(y="y", training_frame=frame(vals))
    assert not c._sparse_fit and c._solver == "IRLSM"


def test_sparse_objective_gradient_is_the_float64_gradient(frames):
    _, tf = frames["binomial"]
    tm = h2o3_tpu_torch.H2OGeneralizedLinearEstimator(
        family="binomial", lambda_=0.002, alpha=0.0)
    tm.train(y="target", training_frame=tf)
    vg, x0 = tm._sparse_objective(tf)
    X, y = _dense(tf), tf.vec("target").to_numpy()
    Xi = np.c_[X, np.ones(N)]
    x = x0 + np.random.default_rng(1).normal(0, 0.1, len(x0))
    f, g = vg(x)
    eta = Xi @ x
    l2 = 0.002 * N
    want_g = Xi.T @ (1 / (1 + np.exp(-eta)) - y)
    want_g[:-1] += l2 * x[:-1]
    want_f = (np.logaddexp(0, eta) - y * eta).sum() \
        + 0.5 * l2 * (x[:-1] ** 2).sum()
    assert abs(f - want_f) <= 1e-12 * abs(want_f)
    assert np.abs(g - want_g).max() <= 1e-10 * np.abs(want_g).max()
    # the fit's stationarity: its float64 gradient is small
    g_end = vg(tm._state.beta)[1]
    assert np.linalg.norm(g_end) <= 1e-3 * np.linalg.norm(vg(x0 * 0)[1])
    for k in list(JDKV.keys()):
        JDKV.remove(k)

"""The port's scoring artifacts and binomial gains/lift against the JAX
package, on the CPU.

- gains/lift: `binomial_metrics(...).gains_lift` against the JAX function
  on the same labels and scores, with and without weights, and in a port
  GBM's training, validation, CV and model_performance metrics against
  the JAX function on that model's own scores: 1e-6.
- native MOJOs both ways: a JAX-exported artifact of a JAX model loads in
  the port's `MojoModel` and a port-exported one of the same model
  carried across (convert.*_from_arrays) in the JAX `MojoModel`; the two
  payloads hold the same arrays bit for bit and both scorers give the
  same numbers bit for bit (the same numpy code on the same arrays);
  against the port model's `predict`: 1e-5 (f32 scoring against the
  artifact's float64). A GBM with categorical set splits also carries
  their go-right words in the port's artifact: the port's scorer walks
  them (1e-5 of predict), the JAX scorer ignores them (and misroutes).
- port-trained models (GBM with a categorical, DRF, a reduced-design GLM
  on NA and unseen levels, DL, KMeans) scored from their artifact:
  1e-5 of `predict`.
- `H2OGenericEstimator`: the column-wise model-space matrix equals the
  row-dict matrix of `MojoModel._row_to_matrix` exactly (NAs, unseen
  levels, a missing column, standardisation, label and one-hot modes);
  its predictions equal the JAX generic estimator's within 1e-6.
"""

import json

import numpy as np
import pytest
import torch

import h2o3_tpu.models as JMODELS
import h2o3_tpu_torch
from h2o3_tpu.core.frame import Frame as JFrame
from h2o3_tpu.genmodel import mojo as JMJ
from h2o3_tpu.models import metrics as JM
from h2o3_tpu.models.generic import H2OGenericEstimator as JGeneric
from h2o3_tpu_torch import convert
from h2o3_tpu_torch.core.frame import Frame
from h2o3_tpu_torch.genmodel import mojo as TMJ
from h2o3_tpu_torch.models import metrics as TM
from h2o3_tpu_torch.models.generic import H2OGenericEstimator

N = 400
X = ["x0", "x1", "x2", "color"]
NUMS = ["x0", "x1", "x2"]


def columns(n=N, seed=5, levels=("red", "green", "blue"), cat_na=True):
    """Seeded columns: three numbers with 5% NA, a categorical with 5% NA
    (none without `cat_na`), a binary label, a 3-level class, a positive
    and a real target."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(3, n))
    x[rng.random((3, n)) < 0.05] = np.nan
    color = np.array(rng.choice(list(levels), n), object)
    color[(rng.random(n) < 0.05) & cat_na] = None
    logit = 1.3 * np.nan_to_num(x[0]) - 0.7 * np.nan_to_num(x[1]) \
        + 0.8 * (color == "blue")
    y = rng.random(n) < 1 / (1 + np.exp(-logit))
    k = np.clip(np.round(logit / 2 + rng.logistic(size=n)), 0, 2)
    g = 2 * np.nan_to_num(x[0]) - np.nan_to_num(x[1]) + rng.normal(0, .3, n)
    return {"x0": x[0], "x1": x[1], "x2": x[2], "color": color,
            "y": np.array(["n", "p"], object)[y.astype(int)],
            "k": np.array(["lo", "mid", "top"], object)[k.astype(int)],
            "g": g, "pos": np.exp(0.3 * g) + 0.1}


@pytest.fixture(scope="module")
def port_cpu():
    h2o3_tpu_torch.init(device="cpu")
    yield
    h2o3_tpu_torch.shutdown()


@pytest.fixture(scope="module")
def frames(port_cpu):
    cols = columns()
    return JFrame.from_dict(cols), Frame.from_dict(cols), cols


# ---------------------------------------------------------------------------
# JAX models carried across
def carry(jm):
    """The port model of a trained JAX model, from its arrays."""
    di = jm._dinfo
    codec = dict(predictors=di.predictors, domains=di.domains)
    if jm.algo in ("gbm", "drf"):
        ta = jm._trees
        trees = dict(col=np.asarray(ta.col), thr=np.asarray(ta.thr),
                     na_left=np.asarray(ta.na_left),
                     value=np.asarray(ta.value), depth=ta.depth,
                     catbits=(None if ta.catbits is None
                              else np.asarray(ta.catbits)),
                     col_is_cat=(None if ta.col_is_cat is None
                                 else np.asarray(ta.col_is_cat)),
                     response_name=di.response_name,
                     response_domain=di.response_domain, model_id=jm.key,
                     **codec)
        if jm.algo == "drf":
            return convert.drf_from_arrays(**trees)
        return convert.gbm_from_arrays(
            f0=float(jm._f0), distribution=jm._dist,
            learn_rate=float(jm.params["learn_rate"]), **trees)
    stats = dict(means=di.means, sigmas=di.sigmas, **codec)
    if jm.algo == "glm":
        return convert.glm_from_arrays(
            beta=np.asarray(jm._state.beta), family=jm._state.family,
            link=jm._state.link, response_name=di.response_name,
            response_domain=di.response_domain, standardize=di.standardize,
            tweedie_link_power=float(jm.params.get("tweedie_link_power")
                                     or 1.0),
            model_id=jm.key, **stats)
    if jm.algo == "deeplearning":
        return convert.deeplearning_from_arrays(
            weights=[(np.asarray(W), np.asarray(b))
                     for W, b in jm._params_net],
            activation=jm.params["activation"], standardize=di.standardize,
            response_name=di.response_name,
            response_domain=di.response_domain, model_id=jm.key, **stats)
    assert jm.algo == "kmeans"
    return convert.kmeans_from_arrays(
        centroids=np.asarray(jm._centroids), standardize=di.standardize,
        model_id=jm.key, **stats)


JAX_FITS = {
    "gbm": ("H2OGradientBoostingEstimator",
            dict(ntrees=3, max_depth=3, nbins=20, seed=1), X, "y"),
    "glm": ("H2OGeneralizedLinearEstimator",
            dict(family="binomial", lambda_=0.0), X, "y"),
    "deeplearning": ("H2ODeepLearningEstimator",
                     dict(hidden=[5], epochs=2, seed=1), X, "y"),
    "kmeans": ("H2OKMeansEstimator", dict(k=3, seed=1), NUMS, None),
}


@pytest.fixture(scope="module")
def jax_models(frames):
    jf = frames[0]
    out = {}
    for algo, (cls, kw, x, y) in JAX_FITS.items():
        jm = getattr(JMODELS, cls)(model_id=f"jax_{algo}", **kw)
        jm.train(x=x, y=y, training_frame=jf)
        out[algo] = (jm, carry(jm))
    return out


def rows_of(frame, predictors):
    """The dict rows the JAX generic estimator builds from a frame (None
    for NA, a level's name, a string cell, a float)."""
    cols = {}
    for c in predictors:
        if c not in frame.names:
            continue
        v = frame.vec(c)
        cols[c] = (v.type, v.host_data if v.type == "str" else v.to_numpy(),
                   v.domain)
    rows = []
    for i in range(frame.nrows):
        row = {}
        for c in predictors:
            if c not in cols:
                row[c] = None
                continue
            vtype, data, dom = cols[c]
            if vtype == "enum":
                row[c] = None if np.isnan(data[i]) else dom[int(data[i])]
            elif vtype == "str":
                row[c] = data[i]
            else:
                row[c] = None if np.isnan(data[i]) else float(data[i])
        rows.append(row)
    return rows


def scored(out):
    """A MojoModel prediction dict's numbers as one float64 matrix."""
    if "probs" in out:
        return np.asarray(out["probs"], np.float64)
    key = "cluster" if "cluster" in out else "predict"
    return np.asarray(out[key], np.float64).reshape(len(out[key]), -1)


def predicted(model, frame):
    """The port model's predict as a float64 matrix: probabilities of a
    classifier, else its prediction."""
    p = model.predict(frame).to_numpy()
    return p[:, 1:] if model._is_classifier else p[:, :1]


# ---------------------------------------------------------------------------
def _same_gains(got, want, tol=1e-6):
    assert (got == {}) == (want == {})
    for g, w in zip(got.get("groups", []), want.get("groups", []),
                    strict=True):
        assert g.keys() == w.keys()
        for key in w:
            np.testing.assert_allclose(g[key], w[key], rtol=tol, atol=tol,
                                       err_msg=key)


@pytest.mark.parametrize("weighted", [False, True])
def test_gains_lift_matches_jax(weighted):
    import jax.numpy as jnp
    rng = np.random.default_rng(11 + weighted)
    n = 3000
    y = (rng.random(n) < 0.3).astype(np.float32)
    y[:7] = np.nan
    p = np.clip(0.4 * y + 0.6 * rng.random(n), 0, 1).astype(np.float32)
    w = (rng.uniform(0.2, 3.0, n) if weighted else np.ones(n)) \
        .astype(np.float32)
    want = JM.binomial_metrics(jnp.asarray(y), jnp.asarray(p),
                               jnp.asarray(w)).gains_lift
    got = TM.binomial_metrics(torch.tensor(y), torch.tensor(p),
                              torch.tensor(w))
    assert len(want["groups"]) == TM.GAINS_GROUPS == 16
    _same_gains(got.gains_lift, want)
    assert json.loads(json.dumps(got.to_dict()))["gains_lift"] \
        == json.loads(json.dumps(got.gains_lift))
    # no positive: an empty table in both
    zero = np.zeros(50, np.float32)
    assert TM.binomial_metrics(torch.tensor(zero), torch.tensor(zero + .5)) \
        .gains_lift == JM.binomial_metrics(jnp.asarray(zero),
                                           jnp.asarray(zero + .5)) \
        .gains_lift == {}


def test_gains_lift_of_model_metrics_matches_jax(frames):
    """A port GBM's training, validation, CV and model_performance
    gains/lift against the JAX function on the model's own scores."""
    import jax.numpy as jnp
    _, tf, cols = frames
    valid = Frame.from_dict(columns(n=300, seed=6))
    m = h2o3_tpu_torch.H2OGradientBoostingEstimator(
        ntrees=3, max_depth=3, nbins=20, seed=1, nfolds=2,
        keep_cross_validation_predictions=True)
    m.train(x=X, y="y", training_frame=tf, validation_frame=valid)

    def want(frame, p1):
        y = frame.vec("y").to_numpy().astype(np.float32)
        return JM.binomial_metrics(jnp.asarray(y), jnp.asarray(
            np.asarray(p1, np.float32))).gains_lift
    o = m._output
    _same_gains(o.training_metrics.gains_lift,
                want(tf, m.predict(tf).vec("pp").to_numpy()))
    _same_gains(o.validation_metrics.gains_lift,
                want(valid, m.predict(valid).vec("pp").to_numpy()))
    _same_gains(m.model_performance(valid).gains_lift,
                o.validation_metrics.gains_lift, tol=0)
    cvp = h2o3_tpu_torch.get_frame(o.cv_predictions_key)
    _same_gains(o.cross_validation_metrics.gains_lift,
                want(tf, cvp.vecs[-1].to_numpy()))
    d = json.loads(json.dumps(m.to_dict()))
    assert d["training_metrics"]["gains_lift"]["groups"][0]["group"] == 1
    assert len(d["validation_metrics"]["gains_lift"]["groups"]) == 16


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("algo", list(JAX_FITS))
def test_native_mojo_interchanges_with_jax(frames, jax_models, algo,
                                           tmp_path):
    jf, tf, cols = frames
    jm, cm = jax_models[algo]
    rows = rows_of(tf, cm._dinfo.predictors)
    j_path = JMJ.export_mojo(jm, str(tmp_path / "jax.zip"))
    t_path = TMJ.export_mojo(cm, str(tmp_path / "port.zip"))
    jax_in_port = TMJ.MojoModel.load(j_path)
    port_in_jax = JMJ.MojoModel.load(t_path)
    port_in_port = TMJ.MojoModel.load(t_path)
    # the same arrays bit for bit, and the same metadata but the key; the
    # port adds the go-right words of categorical set splits
    extra = {k for k in port_in_port.arrays if k.startswith("cb_")
             or k == "cic"}
    assert port_in_port.arrays.keys() - extra == jax_in_port.arrays.keys()
    for k, a in jax_in_port.arrays.items():
        np.testing.assert_array_equal(port_in_port.arrays[k], a, err_msg=k)
    if extra:
        np.testing.assert_array_equal(port_in_port.arrays["cb_0"],
                                      np.asarray(jm._trees.catbits))
        np.testing.assert_array_equal(port_in_port.arrays["cic"],
                                      np.asarray(jm._trees.col_is_cat))
    jmeta = dict(jax_in_port.meta)
    tmeta = dict(port_in_port.meta)
    for meta in (jmeta, tmeta):
        meta.pop("params")
        if meta["cat_mode"] == "label":
            # no label-mode scorer reads them; a carried model has none
            for k in ("means", "sigmas", "standardize"):
                meta.pop(k)
    assert tmeta == jmeta
    # both scorers, both directions: the same numbers bit for bit (the
    # JAX scorer, and the port's on the JAX artifact, walk no set split)
    ref = scored(JMJ.MojoModel.load(j_path).predict(rows))
    for mm in (jax_in_port, port_in_jax) + (() if extra
                                            else (port_in_port,)):
        np.testing.assert_array_equal(scored(mm.predict(rows)), ref)
    got = scored(port_in_port.predict(rows))
    if algo == "kmeans":
        np.testing.assert_array_equal(got[:, 0], predicted(cm, tf)[:, 0])
    else:
        np.testing.assert_allclose(got, predicted(cm, tf), atol=1e-5)
    if extra:   # without the words the JAX artifact misroutes the splits
        assert np.abs(ref - predicted(cm, tf)).max() > 1e-3


def _reduced_glm_frames():
    cols = columns(seed=8, cat_na=False)
    test = columns(n=120, seed=9, levels=("red", "green", "violet"))
    return Frame.from_dict(cols), Frame.from_dict(test)


@pytest.mark.parametrize("case", ["gbm", "drf", "glm_reduced",
                                  "glm_multinomial", "deeplearning",
                                  "kmeans"])
def test_native_mojo_of_port_models_scores_as_predict(port_cpu, case,
                                                      tmp_path):
    """Port-trained models scored from their artifact on a test frame
    with NAs and an unseen level ("violet"): 1e-5 of predict. The
    reduced-design GLM's artifact holds 0 at each dropped level."""
    tf, test = _reduced_glm_frames()
    cls, kw, x, y = {
        "gbm": ("H2OGradientBoostingEstimator",
                dict(ntrees=4, max_depth=3, nbins=20, seed=2), X, "y"),
        "drf": ("H2ORandomForestEstimator",
                dict(ntrees=4, max_depth=4, nbins=20, seed=2), X, "y"),
        "glm_reduced": ("H2OGeneralizedLinearEstimator",
                        dict(family="binomial", lambda_=0.0), X, "y"),
        "glm_multinomial": ("H2OGeneralizedLinearEstimator",
                            dict(family="multinomial", lambda_=0.0), X,
                            "k"),
        "deeplearning": ("H2ODeepLearningEstimator",
                         dict(hidden=[4], epochs=1, seed=3), X, "y"),
        "kmeans": ("H2OKMeansEstimator", dict(k=3, seed=1), NUMS, None),
    }[case]
    m = getattr(h2o3_tpu_torch, cls)(**kw)
    m.train(x=x, y=y, training_frame=tf)
    path = m.download_mojo(str(tmp_path / "m.zip"))
    mm = TMJ.MojoModel.load(path)
    got = scored(mm.predict(rows_of(test, m._dinfo.predictors)))
    if case == "kmeans":
        np.testing.assert_array_equal(got[:, 0], predicted(m, test)[:, 0])
    else:
        np.testing.assert_allclose(got, predicted(m, test), atol=1e-5)
    if case.startswith("glm"):
        di = m._dinfo
        assert di.drop_first == ["color"]
        names = mm.meta["feature_names"]
        assert names[:3] == ["color.blue", "color.green", "color.red"]
        beta = mm.arrays["beta"]
        if di.drop_first:
            assert np.all(beta[..., 0] == 0.0)
            np.testing.assert_array_equal(
                np.delete(beta, 0, axis=-1), np.asarray(m._state.beta))


# ---------------------------------------------------------------------------
GENERIC_CASES = {
    "label": ("H2OGradientBoostingEstimator",
              dict(ntrees=3, max_depth=3, nbins=20, seed=1)),
    "onehot_standardized": ("H2OGeneralizedLinearEstimator",
                            dict(family="binomial", lambda_=0.0)),
    "onehot_raw": ("H2OGeneralizedLinearEstimator",
                   dict(family="binomial", lambda_=0.0, standardize=False)),
}


@pytest.mark.parametrize("case", list(GENERIC_CASES))
def test_generic_columnwise_matrix_equals_row_path(port_cpu, case, tmp_path):
    """The generic estimator's matrix, built a column at a time, equals
    the row-dict one exactly: a test frame with NAs, an unseen level, a
    missing predictor (x2) and a string column where the model has a
    categorical."""
    tf, _ = _reduced_glm_frames()
    cls, kw = GENERIC_CASES[case]
    m = getattr(h2o3_tpu_torch, cls)(**kw)
    m.train(x=X, y="y", training_frame=tf)
    g = H2OGenericEstimator(m.download_mojo(str(tmp_path / "m.zip")))
    mm = g._scorer
    test = columns(n=150, seed=12, levels=("red", "green", "violet"))
    del test["x2"]
    for frame in (Frame.from_dict(test),
                  Frame.from_dict(test, column_types={"color": "str"})):
        got = mm.columns_to_matrix(g._host_columns(frame), frame.nrows)
        want = mm._row_to_matrix(rows_of(frame, mm.meta["predictors"]))
        np.testing.assert_array_equal(got, want)
        assert got.shape[0] == 150 and not np.isnan(got).all()
    np.testing.assert_allclose(g.predict(Frame.from_dict(test))
                               .to_numpy()[:, 1:],
                               predicted(m, Frame.from_dict(test)),
                               atol=1e-5)


@pytest.mark.parametrize("family", ["native", "h2o3"])
def test_generic_predictions_match_jax(frames, jax_models, family, tmp_path):
    """The JAX GBM's artifact (native and H2O-3), scored by the JAX
    generic estimator and by the port's on the same rows: 1e-6."""
    jf, tf, _ = frames
    jm, _ = jax_models["gbm"]
    path = jm.download_mojo(str(tmp_path / "m.zip"), format=family)
    want = JGeneric(path).predict(jf)
    got = h2o3_tpu_torch.import_mojo(path)
    assert isinstance(got, H2OGenericEstimator)
    assert got.original_algo == "gbm"
    got = got.predict(tf)
    assert got.names == want.names
    w = want.to_numpy()
    np.testing.assert_allclose(got.to_numpy(), w, atol=1e-6)


def test_model_export_surface(frames, jax_models, tmp_path):
    _, tf, _ = frames
    _, cm = jax_models["gbm"]
    assert cm.save_mojo == cm.download_mojo
    p = cm.download_mojo(str(tmp_path / "h.zip"), format="h2o3")
    assert h2o3_tpu_torch.import_mojo(p)._ref is not None
    m = h2o3_tpu_torch.H2OGradientBoostingEstimator(ntrees=2, max_depth=2,
                                                    nbins=20, seed=1)
    m.train(x=X, y="y", training_frame=tf)
    d = json.load(open(m.save_model_details(str(tmp_path / "d.json"))))
    assert d["model_id"] == m.key
    assert len(d["training_metrics"]["gains_lift"]["groups"]) == 16
    java = open(m.download_pojo(str(tmp_path))).read()
    assert f"public class {m.key}" in java

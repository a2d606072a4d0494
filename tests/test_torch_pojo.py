"""POJO export of the port against the JAX package's, on the CPU: the Java
source of a JAX model carried across equals the JAX package's line for
line, but for the lines that name the model key or the class; the arrays
pulled out of the source and replayed (test_pojo.py's way, no JVM) give
the port model's predictions within 1e-6 (trees, KMeans: the same
clusters) or 1e-6 of the largest (GLM, whose replay is float64 against
predict's f32). A reduced-design GLM writes every level, the dropped one
0, and its replay on one-hot rows of every level gives predict.
"""

import numpy as np
import pytest

import h2o3_tpu.models as JMODELS
import h2o3_tpu_torch
from h2o3_tpu.core.frame import Frame as JFrame
from h2o3_tpu.genmodel import pojo as JPJ
from h2o3_tpu_torch.core.frame import Frame
from h2o3_tpu_torch.genmodel import pojo as TPJ
from test_pojo import _extract_array, _java_tree_score
from test_torch_genmodel import NUMS, X, carry, columns


@pytest.fixture(scope="module")
def frames():
    h2o3_tpu_torch.init(device="cpu")
    cols = columns(n=300, seed=31)
    yield JFrame.from_dict(cols), Frame.from_dict(cols), cols
    h2o3_tpu_torch.shutdown()


def _named_lines(src, model):
    cls = TPJ._class_name(model)
    return [ln for ln in src.splitlines()
            if model.model_id not in ln and cls not in ln]


CASES = {
    "gbm": ("H2OGradientBoostingEstimator",
            dict(ntrees=3, max_depth=3, nbins=20, seed=1), X, "y"),
    "glm_binomial": ("H2OGeneralizedLinearEstimator",
                     dict(family="binomial", lambda_=0.0), X, "y"),
    "glm_gaussian": ("H2OGeneralizedLinearEstimator",
                     dict(family="gaussian", lambda_=0.0), X, "g"),
    "glm_multinomial": ("H2OGeneralizedLinearEstimator",
                        dict(family="multinomial", lambda_=0.0), X, "k"),
    "kmeans": ("H2OKMeansEstimator", dict(k=3, seed=1), NUMS, None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_pojo_source_and_replay_match(frames, case, tmp_path):
    jf, tf, _ = frames
    cls, kw, x, y = CASES[case]
    jm = getattr(JMODELS, cls)(model_id=f"pojo_{case}", **kw)
    jm.train(x=x, y=y, training_frame=jf)
    cm = carry(jm)
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jsrc = open(JPJ.export_pojo(jm, str(tmp_path / "j"))).read()
    tsrc = open(cm.download_pojo(str(tmp_path / "t"))).read()
    assert f"public class {TPJ._class_name(cm)}" in tsrc
    assert tsrc.count("{") == tsrc.count("}")
    assert _named_lines(tsrc, cm) == _named_lines(jsrc, jm)
    Xd = cm._dinfo.matrix(tf).numpy().astype(np.float64)
    pred = cm.predict(tf).to_numpy()
    if case == "gbm":
        acc = _java_tree_score(tsrc, "T", Xd[:60])
        lr = float(cm.params["learn_rate"])
        p1 = 1 / (1 + np.exp(-(cm._f0 + lr * acc)))
        np.testing.assert_allclose(p1, pred[:60, 2], atol=1e-6)
    elif case == "kmeans":
        cent = _extract_array(tsrc, "CENTERS").reshape(3, -1)
        mean = _extract_array(tsrc, "MEAN")
        sig = _extract_array(tsrc, "SIGMA")
        raw = tf.to_numpy(NUMS)
        Z = np.nan_to_num((raw - mean) / sig)
        got = ((Z[:, None, :] - cent[None]) ** 2).sum(-1).argmin(1)
        np.testing.assert_array_equal(got, pred[:, 0])
    else:
        _replay_glm(tsrc, cm, tf, pred)


def _raw_design(model, frame):
    """The POJO's input rows: the one-hot indicators of every level, then
    the raw numbers, NAs imputed with the training means."""
    di = model._dinfo
    parts = []
    for c in di.cat_cols:
        codes = frame.vec(c).to_numpy()
        oh = np.zeros((frame.nrows, di.cardinalities[c]))
        ok = ~np.isnan(codes)
        oh[np.flatnonzero(ok), codes[ok].astype(int)] = 1.0
        parts.append(oh)
    for c in di.num_cols:
        v = frame.vec(c).to_numpy()
        parts.append(np.where(np.isnan(v), di.means[c], v)[:, None])
    return np.concatenate(parts, axis=1)


def _replay_glm(src, model, frame, pred):
    beta = _extract_array(src, "BETA")
    D = _raw_design(model, frame)
    fam = model._state.family
    if fam == "multinomial":
        K = len(model._dinfo.response_domain)
        B = beta.reshape(K, -1)
        mean = _extract_array(src, "MEAN")
        sig = _extract_array(src, "SIGMA")
        eta = ((D - mean) / sig) @ B[:, :-1].T + B[:, -1]
        P = np.exp(eta - eta.max(1, keepdims=True))
        got, want = P / P.sum(1, keepdims=True), pred[:, 1:]
    else:
        eta = D @ beta[:-1] + beta[-1]
        got = 1 / (1 + np.exp(-eta)) if fam == "binomial" else eta
        want = pred[:, 2] if fam == "binomial" else pred[:, 0]
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("family,y", [("binomial", "y"), ("gaussian", "g")])
def test_reduced_design_glm_pojo(frames, family, y, tmp_path):
    tr = Frame.from_dict(columns(n=300, seed=32, cat_na=False))
    m = h2o3_tpu_torch.H2OGeneralizedLinearEstimator(family=family,
                                                     lambda_=0.0)
    m.train(x=X, y=y, training_frame=tr)
    assert m._dinfo.drop_first == ["color"]
    src = open(m.download_pojo(str(tmp_path))).read()
    assert '"color.blue", "color.green", "color.red"' in src
    beta = _extract_array(src, "BETA")
    assert beta[0] == 0.0 and len(beta) == 3 + 3 + 1
    _replay_glm(src, m, tr, m.predict(tr).to_numpy())


def test_pojo_refuses_unsupported(frames, tmp_path):
    _, tf, _ = frames
    m = h2o3_tpu_torch.H2ONaiveBayesEstimator()
    m.train(x=X, y="y", training_frame=tf)
    with pytest.raises(NotImplementedError):
        m.download_pojo(str(tmp_path))

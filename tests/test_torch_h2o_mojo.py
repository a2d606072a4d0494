"""Genuine H2O-3 MOJO zips of the port against the JAX package's, on the
CPU.

- trees: `tree_to_h2o_bytes` of a JAX GBM carried across is byte for byte
  the JAX package's (bernoulli with categorical set splits, and gaussian);
  both exports hold the same domain and tree files, and model.ini is the
  same but for its uuid and timestamp lines.
- a port DRF's binomial forest is written with H2O-3's P(class 0) leaves
  and reads back within 1e-5 of predict (the JAX writer leaves P(class 1)
  in them, which its own reader, like genmodel, takes as P(class 0)).
- round trip of port-trained GBMs: the imported trees' col, thr and
  na_left equal the model's bit for bit on every node the tree reaches,
  each leaf is f32(value * learn_rate), each tree scores rows as the
  in-test byte walker `test_h2o_mojo._score_tree_reference` (a port of
  SharedTreeMojoModel.scoreTree) within 1e-6, and the imported model's
  probabilities are within 1e-5 of predict (f32 reassociation: H2O-3
  stores learn-rate-scaled leaves).
- the GLM (every family the writer takes), KMeans and DL oracles: the
  port's against the carried model's predict (GLM 1e-6 of the largest
  prediction, gamma's inverse link 1e-5, tweedie where eta > 1e-10, the
  rest 1e-5; KMeans the same clusters) and against the
  JAX oracles on the same zip (1e-12); a reduced-design GLM on NA and
  unseen levels: 1e-6 of predict.
"""

import zipfile

import numpy as np
import pytest
import torch

import h2o3_tpu.models as JMODELS
import h2o3_tpu_torch
from h2o3_tpu.core.frame import Frame as JFrame
from h2o3_tpu.genmodel import h2o_mojo as JHM
from h2o3_tpu_torch.core.frame import Frame
from h2o3_tpu_torch.genmodel import h2o_mojo as THM
from h2o3_tpu_torch.models.tree import engine as TE
from test_h2o_mojo import _score_tree_reference
from test_torch_genmodel import NUMS, X, carry, columns


@pytest.fixture(scope="module")
def frames():
    h2o3_tpu_torch.init(device="cpu")
    cols = columns(seed=21)
    yield JFrame.from_dict(cols), Frame.from_dict(cols), cols
    h2o3_tpu_torch.shutdown()


def _ini_lines(path):
    with zipfile.ZipFile(path) as z:
        text = z.read("model.ini").decode()
    return [ln for ln in text.splitlines()
            if not ln.startswith(("uuid", "timestamp"))]


def _zip_entries(path):
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist() if n != "model.ini"}


def _oracle_matrix(frame, di):
    """The oracles' rows: categorical level codes, then raw numbers."""
    return np.column_stack([frame.vec(c).to_numpy()
                            for c in di.cat_cols + di.num_cols])


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dist,y", [("bernoulli", "y"), ("gaussian", "g")])
def test_tree_bytes_and_zip_equal_jax(frames, dist, y, tmp_path):
    jf, _, _ = frames
    jm = JMODELS.H2OGradientBoostingEstimator(
        ntrees=3, max_depth=3, nbins=20, seed=1, distribution=dist,
        model_id=f"trees_{dist}")
    jm.train(x=X, y=y, training_frame=jf)
    cm = carry(jm)
    lr = float(jm.params["learn_rate"])
    card = np.array([jm._dinfo.cardinalities.get(c, 0)
                     for c in jm._dinfo.predictors], np.int64)
    for t in range(jm._trees.ntrees):
        assert THM.tree_to_h2o_bytes(cm._trees, t, ncat=card, val_scale=lr) \
            == JHM.tree_to_h2o_bytes(jm._trees, t, ncat=card, val_scale=lr)
    jp = JHM.export_h2o_mojo(jm, str(tmp_path / "jax.zip"))
    tp = THM.export_h2o_mojo(cm, str(tmp_path / "port.zip"))
    assert _ini_lines(tp) == _ini_lines(jp)
    assert _zip_entries(tp) == _zip_entries(jp)


def _reached(col):
    """(T, nodes) bool: the nodes a walk from the root can reach."""
    T, nodes = col.shape
    reach = np.zeros((T, nodes), bool)
    reach[:, 0] = True
    for i in range(nodes):
        kids = 2 * i + 1
        if kids + 1 < nodes:
            go = reach[:, i] & (col[:, i] >= 0)
            reach[:, kids] |= go
            reach[:, kids + 1] |= go
    return reach


@pytest.mark.parametrize("case", ["bernoulli", "gaussian"])
def test_port_gbm_round_trip_routes_exactly(frames, case, tmp_path):
    _, tf, _ = frames
    m = h2o3_tpu_torch.H2OGradientBoostingEstimator(
        ntrees=4, max_depth=4, nbins=20, seed=3, distribution=case,
        learn_rate=0.3)
    m.train(x=X, y="y" if case == "bernoulli" else "g", training_frame=tf)
    path = m.download_mojo(str(tmp_path / "m.zip"), format="h2o3")
    mm = THM.import_h2o_mojo(path)
    got, own = mm.trees_k[0], m._trees
    col = own.col.numpy()
    reach = _reached(col)
    inner = reach & (col >= 0)
    np.testing.assert_array_equal(got.col.numpy()[reach], col[reach])
    num = inner & ~np.isin(col, np.flatnonzero(own.col_is_cat)
                           if own.col_is_cat is not None else [])
    assert np.array_equal(got.thr.numpy()[num].view(np.int32),
                          own.thr.numpy()[num].view(np.int32))
    np.testing.assert_array_equal(got.na_left.numpy()[inner],
                                  own.na_left.numpy()[inner])
    leaf = reach & (col < 0)
    lr32 = np.float32(0.3)
    assert np.array_equal(got.value.numpy()[leaf],
                          own.value.numpy()[leaf] * lr32)
    Xm = m._dinfo.matrix(tf)
    with zipfile.ZipFile(path) as z:
        for t in range(own.ntrees):
            tb = z.read(f"trees/t00_{t:03d}.bin")
            one = TE.predict_ensemble(Xm[:25], TE.TreeArrays(
                col=got.col[t:t + 1], thr=got.thr[t:t + 1],
                na_left=got.na_left[t:t + 1], value=got.value[t:t + 1],
                depth=got.depth, col_is_cat=got.col_is_cat,
                catbits=(None if got.catbits is None
                         else got.catbits[t:t + 1])))
            ref = [_score_tree_reference(tb, Xm[r].double().numpy())
                   for r in range(25)]
            np.testing.assert_allclose(one.numpy(), ref, atol=1e-6)
    pred = m.predict(tf).to_numpy()
    out = mm.predict_raw(Xm.numpy())
    if case == "bernoulli":
        np.testing.assert_allclose(out, pred[:, 1:], atol=1e-5)
    else:
        np.testing.assert_allclose(out, pred[:, 0], atol=1e-5)


# ---------------------------------------------------------------------------
GLM_FAMILIES = {
    "gaussian": ("g", {}), "binomial": ("y", {}), "poisson": ("pos", {}),
    "gamma": ("pos", {}), "tweedie": ("pos", {"tweedie_variance_power": 1.5}),
    "multinomial": ("k", {}),
}


def _same_oracles(path, X_raw):
    """The port's oracle and the JAX one on the same zip: 1e-12."""
    got = THM.import_h2o_mojo_any(path).predict_raw(X_raw)
    want = JHM.import_h2o_mojo_any(path).predict_raw(X_raw)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    return got


@pytest.mark.parametrize("family", list(GLM_FAMILIES))
def test_glm_oracle_matches_predict_and_jax(frames, family, tmp_path):
    jf, tf, _ = frames
    y, extra = GLM_FAMILIES[family]
    jm = JMODELS.H2OGeneralizedLinearEstimator(family=family, lambda_=0.0,
                                               **extra)
    jm.train(x=X, y=y, training_frame=jf)
    cm = carry(jm)
    cm.params.update(extra)
    tp = THM.export_h2o_mojo(cm, str(tmp_path / "port.zip"))
    jp = JHM.export_h2o_mojo(jm, str(tmp_path / "jax.zip"))
    assert _ini_lines(tp) == _ini_lines(jp)
    got = _same_oracles(tp, _oracle_matrix(tf, cm._dinfo))
    pred = cm.predict(tf).to_numpy()
    want = pred[:, 1:] if cm._is_classifier else pred[:, 0]
    # predict sums eta in f32; the inverse link of gamma turns its
    # cancellation into 2e-6 relative error of mu, so 1e-5 there
    tol = 1e-5 if family == "gamma" else 1e-6
    if family == "tweedie":
        # the scorers of both packages clamp eta at 1e-10 before the
        # power; genmodel's GLM_tweedieInv does not: rows above it only
        keep = got > 1e-10
        assert keep.sum() > 300
        got, want = got[keep], want[keep]
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


def test_kmeans_and_dl_oracles(frames, tmp_path):
    jf, tf, _ = frames
    jk = JMODELS.H2OKMeansEstimator(k=3, seed=1)
    jk.train(x=NUMS, training_frame=jf)
    jd = JMODELS.H2ODeepLearningEstimator(hidden=[5], epochs=2, seed=1)
    jd.train(x=X, y="y", training_frame=jf)
    for jm in (jk, jd):
        cm = carry(jm)
        tp = THM.export_h2o_mojo(cm, str(tmp_path / f"{jm.algo}.zip"))
        jp = JHM.export_h2o_mojo(jm, str(tmp_path / f"j{jm.algo}.zip"))
        assert _ini_lines(tp) == _ini_lines(jp)
        got = _same_oracles(tp, _oracle_matrix(tf, cm._dinfo))
        pred = cm.predict(tf).to_numpy()
        if jm.algo == "kmeans":
            np.testing.assert_array_equal(got, pred[:, 0])
        else:
            np.testing.assert_allclose(got, pred[:, 1:], atol=1e-5)


@pytest.mark.parametrize("family,y", [("binomial", "y"),
                                      ("multinomial", "k")])
def test_reduced_design_glm_on_na_and_unseen_levels(frames, family, y,
                                                    tmp_path):
    """A port GLM whose design dropped color's first level: its H2O-3
    MOJO (every level, the dropped one 0) scores NA, unseen and seen
    levels as predict does."""
    tr = Frame.from_dict(columns(seed=22, cat_na=False))
    m = h2o3_tpu_torch.H2OGeneralizedLinearEstimator(family=family,
                                                     lambda_=0.0)
    m.train(x=X, y=y, training_frame=tr)
    assert m._dinfo.drop_first == ["color"]
    test = Frame.from_dict(columns(n=150, seed=23,
                                   levels=("red", "green", "violet")))
    path = m.download_mojo(str(tmp_path / "r.zip"), format="h2o3")
    o = THM.import_h2o_mojo_any(path)
    assert o.use_all and o.beta[0] == 0.0
    # the frame's codes remapped onto the model's domain (violet: NaN)
    codes = test.vec("color").to_numpy()
    dom = test.vec("color").domain
    lut = np.array([m._dinfo.domains["color"].index(v)
                    if v in m._dinfo.domains["color"] else np.nan
                    for v in dom] + [np.nan])
    Xr = _oracle_matrix(test, m._dinfo)
    Xr[:, 0] = lut[np.where(np.isnan(codes), len(dom),
                            np.nan_to_num(codes)).astype(int)]
    assert np.isnan(Xr[:, 0]).sum() > 10
    got = o.predict_raw(Xr)
    pred = m.predict(test).to_numpy()[:, 1:]
    np.testing.assert_allclose(got, pred, atol=1e-6)
    # the same artifact through the JAX oracle
    np.testing.assert_allclose(JHM.import_h2o_mojo_any(path).predict_raw(Xr),
                               got, rtol=1e-12, atol=1e-12)


def test_import_dispatch_and_device(frames, tmp_path):
    _, tf, _ = frames
    m = h2o3_tpu_torch.H2ORandomForestEstimator(ntrees=3, max_depth=4,
                                                nbins=20, seed=1)
    m.train(x=X, y="y", training_frame=tf)
    path = m.download_mojo(str(tmp_path / "drf.zip"), format="h2o3")
    mm = THM.import_h2o_mojo_any(path)
    assert isinstance(mm, THM.H2OMojoModel) and mm.algo == "drf"
    assert mm.device == torch.device("cpu")
    Xm = m._dinfo.matrix(tf)
    np.testing.assert_allclose(mm.predict_tensor(Xm).numpy(),
                               m.predict(tf).to_numpy()[:, 1:], atol=1e-5)

"""The port's main path as a whole against the JAX package's, on the CPU:
a seeded CSV (numeric columns with NA values, one categorical column, a
two-level response) goes through import_file, a bernoulli GBM, predict and
AUC in both packages: the port through its estimator, the JAX package
through its binned chunk trainer under the estimator's setup rules. Also: a JAX-trained GBM carried across as arrays,
the device rule of `init()`, and the rule that the port imports nothing of
JAX or the JAX package.

Tolerances: parsed values equal (both store f32); predictions within 1e-4
and AUC within 1e-3 (f32 sums in another order, through 3 trees); a model
carried across scores within 1e-5 (the same trees walked by both).
"""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import h2o3_tpu
import h2o3_tpu_torch
from h2o3_tpu.models import metrics as JM
from h2o3_tpu.models.model import DataInfo as JaxDataInfo
from h2o3_tpu.models.tree import binned as JB
from h2o3_tpu.models.tree import engine as JE
from h2o3_tpu_torch import convert
from h2o3_tpu_torch.models import metrics as TM

ROOT = pathlib.Path(__file__).resolve().parents[1]
NTREES, DEPTH, NBINS, LR, N = 3, 3, 20, 0.2, 1500
GBM = dict(ntrees=NTREES, max_depth=DEPTH, nbins=NBINS, learn_rate=LR,
           distribution="bernoulli", seed=7)


def _write_csv(path, n=N, seed=21):
    rng = np.random.default_rng(seed)
    X = np.round(rng.normal(size=(n, 3)), 4)
    X[rng.random((n, 3)) < 0.05] = np.nan
    color = rng.choice(["red", "green", "blue", "teal"], n)
    logit = (1.4 * np.nan_to_num(X[:, 0]) - 0.9 * np.nan_to_num(X[:, 1])
             + np.where(color == "blue", 1.0, 0.0))
    y = rng.random(n) < 1 / (1 + np.exp(-logit))
    with open(path, "w") as f:
        f.write("a,b,c,color,label\n")
        for i in range(n):
            nums = ["NA" if np.isnan(v) else repr(float(v)) for v in X[i]]
            f.write(",".join(nums + [color[i], "yes" if y[i] else "no"])
                    + "\n")
    return path


def _jax_reference(jfr):
    """The JAX package's bernoulli GBM on `jfr` through its binned engine,
    at the chunk-trainer level: the estimator's setup rules (label-mode
    DataInfo, b_val = max(nbins, cardinality), f0 = logit of the mean,
    F = 0 on padding rows) with one unsharded jitted trainer, because
    compiling the estimator's 8-shard program costs most of this file's
    time budget. Scored with its engine and metrics."""
    di = JaxDataInfo(jfr, [c for c in jfr.names if c != "label"], "label",
                     cat_mode="label")
    n = jfr.nrows
    X = np.asarray(di.matrix(jfr))[:n]
    y = np.asarray(di.response(jfr))[:n]
    is_cat = np.array([c in di.cat_cols for c in di.predictors])
    b_val = max(NBINS, max(di.cardinalities.values()))
    spec = JB.make_bins(X, is_cat, b_val)
    grower = JB.BinnedGrower(spec, max_depth=DEPTH, min_rows=10.0,
                             min_split_improvement=1e-5, axis_name=None,
                             int8_stats=False, use_radix_shallow=False,
                             fused_level=False)
    n_pad = grower.layout(n)
    f0 = float(np.log(y.mean() / (1 - y.mean())))
    F = np.where(np.arange(n_pad) < n, f0, 0.0).astype(np.float32)
    y1 = np.zeros(n_pad, np.float32)
    y1[:n] = y
    w1 = (np.arange(n_pad) < n).astype(np.float32)
    _, trees = JB.gbm_chunk_trainer(
        grower, n, dist="bernoulli", eta=LR, sample_rate=1.0, mtries=0,
        k_trees=NTREES)(JB.quantize(jnp.asarray(X), spec, n_pad=n_pad),
                        jnp.asarray(y1), jnp.asarray(w1), jnp.asarray(F),
                        jax.random.PRNGKey(0))
    col, bins, nal, words, val, _, cover = (np.asarray(t) for t in trees)
    thr = spec.edges[np.clip(col, 0, X.shape[1] - 1),
                     np.clip(bins, 0, spec.edges.shape[1] - 1)]
    ta = JE.TreeArrays(col=col, thr=thr, na_left=nal, value=val,
                       depth=DEPTH, cover=cover, catbits=words,
                       col_is_cat=np.pad(is_cat, (0, spec.c_pad - len(is_cat))))
    p1 = np.asarray(jax.nn.sigmoid(
        f0 + LR * JE.predict_ensemble(jnp.asarray(X), ta)))
    auc = JM.binomial_metrics(jnp.asarray(y), jnp.asarray(p1)).auc
    return dict(di=di, spec=spec, trees=ta, f0=f0, p1=p1, auc=auc)


@pytest.fixture(scope="module")
def port_cpu():
    h2o3_tpu_torch.init(device="cpu")
    yield
    h2o3_tpu_torch.shutdown()


@pytest.fixture(scope="module")
def slice_run(tmp_path_factory, port_cpu):
    csv = str(_write_csv(tmp_path_factory.mktemp("slice") / "train.csv"))
    jfr = h2o3_tpu.import_file(csv)
    tfr = h2o3_tpu_torch.import_file(csv)
    tm = h2o3_tpu_torch.H2OGradientBoostingEstimator(**GBM)
    tm.train(y="label", training_frame=tfr)
    return dict(jfr=jfr, tfr=tfr, tm=tm, ref=_jax_reference(jfr))


def test_import_file_matches_jax(slice_run):
    jfr, tfr = slice_run["jfr"], slice_run["tfr"]
    assert tfr.names == jfr.names
    assert tfr.types == jfr.types
    for c in tfr.names:
        assert tfr.vec(c).levels() == jfr.vec(c).levels(), c
    np.testing.assert_array_equal(tfr.to_numpy(), jfr.to_numpy())
    assert tfr.matrix().device.type == "cpu"
    r, rj = tfr.vec("a").rollups(), jfr.vec("a").rollups()
    assert r.nas == rj.nas and r.nas > 0
    np.testing.assert_allclose([r.mean, r.sigma, r.min, r.max],
                               [rj.mean, rj.sigma, rj.min, rj.max],
                               rtol=1e-5)


def test_gbm_predict_and_auc_match_jax(slice_run):
    tm, ref = slice_run["tm"], slice_run["ref"]
    tp = tm.predict(slice_run["tfr"]).to_numpy()
    assert tp.shape == (N, 3)
    np.testing.assert_allclose(tp[:, 2], ref["p1"], atol=1e-4)
    assert abs(tm.auc() - ref["auc"]) < 1e-3
    assert tm.auc() > 0.75
    np.testing.assert_array_equal(tm._trees.col.numpy(), ref["trees"].col)
    np.testing.assert_array_equal(tm._bin_spec.edges, ref["spec"].edges)
    assert abs(tm._f0 - ref["f0"]) < 1e-6
    hist = tm.scoring_history()
    assert hist[-1]["number_of_trees"] == NTREES
    assert abs(hist[-1]["training_auc"] - ref["auc"]) < 1e-3


def test_jax_gbm_carried_across_scores_the_same(slice_run):
    ref = slice_run["ref"]
    ta, di, spec = ref["trees"], ref["di"], ref["spec"]
    model = convert.gbm_from_arrays(
        col=ta.col, thr=ta.thr, na_left=ta.na_left, value=ta.value,
        cover=ta.cover, catbits=ta.catbits, col_is_cat=ta.col_is_cat,
        depth=ta.depth, f0=ref["f0"], distribution="bernoulli",
        learn_rate=LR, predictors=di.predictors, domains=di.domains,
        response_name=di.response_name, response_domain=di.response_domain,
        edges=spec.edges, is_cat=spec.is_cat, b_val=spec.b_val,
        n_bins=spec.n_bins, c_pad=spec.c_pad)
    tp = model.predict(slice_run["tfr"]).to_numpy()
    np.testing.assert_allclose(tp[:, 2], ref["p1"], atol=1e-5)
    np.testing.assert_array_equal(tp[:, 0], (tp[:, 2] > tp[:, 1]))
    assert model._bin_spec.b_val == spec.b_val


def test_metrics_match_jax():
    rng = np.random.default_rng(22)
    y = (rng.random(3000) < 0.4).astype(np.float32)
    y[:20] = np.nan                              # missing responses
    p = np.clip(0.4 + 0.3 * (y - 0.4) + rng.normal(0, 0.2, 3000), 0, 1) \
        .astype(np.float32)
    w = rng.uniform(0.5, 2.0, 3000).astype(np.float32)
    ref = JM.binomial_metrics(jnp.asarray(y), jnp.asarray(p), jnp.asarray(w))
    got = TM.binomial_metrics(torch.from_numpy(y), torch.from_numpy(p),
                              torch.from_numpy(w))
    for k in ("auc", "pr_auc", "logloss", "rmse", "f1", "max_f1_threshold",
              "mean_per_class_error", "nobs"):
        np.testing.assert_allclose(getattr(got, k), getattr(ref, k),
                                   rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(got.confusion_matrix, ref.confusion_matrix,
                               rtol=1e-5)
    yr = rng.gamma(2.0, 1.0, 3000).astype(np.float32)
    pr = (yr + rng.normal(0, 0.5, 3000)).astype(np.float32)
    ref = JM.regression_metrics(jnp.asarray(yr), jnp.asarray(pr))
    got = TM.regression_metrics(torch.from_numpy(yr), torch.from_numpy(pr))
    for k in ("mse", "rmse", "mae", "r2", "nobs"):
        np.testing.assert_allclose(getattr(got, k), getattr(ref, k),
                                   rtol=1e-5, err_msg=k)
    assert np.isnan(got.rmsle) and np.isnan(ref.rmsle)   # negative preds


def test_gaussian_gbm_trains(port_cpu):
    rng = np.random.default_rng(23)
    X = rng.normal(size=(2000, 3))
    y = 2.0 * X[:, 0] - X[:, 1] ** 2 + rng.normal(0, 0.1, 2000)
    fr = h2o3_tpu_torch.Frame.from_numpy(np.column_stack([X, y]),
                                         names=["a", "b", "c", "y"])
    m = h2o3_tpu_torch.H2OGradientBoostingEstimator(
        ntrees=10, max_depth=3, learn_rate=0.3, score_tree_interval=5)
    m.train(y="y", training_frame=fr)
    assert m.summary()["distribution"] == "gaussian"
    hist = [h["training_rmse"] for h in m.scoring_history()]
    assert len(hist) == 2 and hist[1] < hist[0] < float(np.std(y))
    pred = m.predict(fr).to_numpy()[:, 0]
    assert abs(np.sqrt(np.mean((pred - y) ** 2)) - m.rmse()) < 1e-4
    assert m.varimp()[0]["variable"] in ("a", "b")


def test_sampling_and_monotone_options(port_cpu):
    from h2o3_tpu_torch.core.frame import Frame, T_CAT, Vec
    rng = np.random.default_rng(24)
    X = rng.normal(size=(3000, 3))
    y = (rng.random(3000) < 1 / (1 + np.exp(-(2 * X[:, 0] - X[:, 1]))))
    fr = Frame(["a", "b", "c", "y"],
               [Vec.from_numpy(X[:, j]) for j in range(3)]
               + [Vec.from_numpy(y.astype(float), type=T_CAT,
                                 domain=["0", "1"])])
    kw = dict(ntrees=4, max_depth=3, sample_rate=0.7, col_sample_rate=0.7,
              col_sample_rate_per_tree=0.8, monotone_constraints={"a": 1},
              balance_classes=True)

    def fit(seed):
        m = h2o3_tpu_torch.H2OGradientBoostingEstimator(seed=seed, **kw)
        return m.train(y="y", training_frame=fr)

    m1, m2, m3 = fit(3), fit(3), fit(4)
    p1, p2, p3 = (m.predict(fr).to_numpy()[:, 2] for m in (m1, m2, m3))
    np.testing.assert_array_equal(p1, p2)      # one seed, one model
    assert not np.array_equal(p1, p3)          # the seed drives the draws
    assert m1.auc() > 0.75
    # monotone in a: sweep a with b and c held
    grid = np.linspace(-3, 3, 50)
    sweep = Frame(["a", "b", "c"],
                  [Vec.from_numpy(grid), Vec.from_numpy(np.full(50, 0.3)),
                   Vec.from_numpy(np.full(50, -0.2))])
    ps = m1.predict(sweep).to_numpy()[:, 2]
    assert (np.diff(ps) >= -1e-7).all() and ps[-1] > ps[0]
    # balance_classes: both classes carry the same total weight
    _, yz, w = m1._prep(fr)
    assert abs(w[yz == 1].sum().item() - w[yz == 0].sum().item()) < 1e-2


def test_unported_options_raise(port_cpu, slice_run):
    for flag in ("int8_hist", "radix_shallow", "fused_level"):
        m = h2o3_tpu_torch.H2OGradientBoostingEstimator(**GBM,
                                                        **{flag: True})
        with pytest.raises(NotImplementedError, match="not ported yet"):
            m.train(y="label", training_frame=slice_run["tfr"])


def test_init_device_rule(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        h2o3_tpu_torch.init()
    c = h2o3_tpu_torch.init(device="cpu")
    assert c.device == torch.device("cpu")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax():
    pkg = ROOT / "h2o3_tpu_torch"
    # ops/build/ holds what the kernels' build writes, not the package
    files = sorted(f for f in pkg.rglob("*.py")
                   if "build" not in f.relative_to(pkg).parts)
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "h2o3_tpu"), (f, mod)

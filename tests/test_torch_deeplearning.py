"""DeepLearning of the port against the JAX package, on the CPU.

One seeded frame (four numeric columns with NA values, a categorical
column, a binomial, a multinomial and a numeric response) goes to both
packages. The port is handed the JAX package's draws (`JaxDLDraws`: its
key chain, PRNGKey(seed), one split a layer for the initial weights, one
split a step and one a dropout mask), so both nets start alike and drop
the same units; the mini-batch rows are the same numpy draws in both.
Tolerances:
- after 4 steps the weights within 1e-6: the same f32 products and
  ADADELTA updates, summed in another order;
- after 32 steps (two epochs of 1,000 rows at the 62-row mini-batch) the
  weights within 1e-5, the predictions within 1e-5 of their largest
  magnitude, every loss of the scoring history within 1e-5 relative and
  the training metric within 1e-5 relative: the order of f32 sums moves
  the last bits of every step, and those drift apart (seen: 1e-7);
- the autoencoder's reconstruction MSE within 1e-5 of its largest;
- a JAX net carried across by `deeplearning_from_arrays`: predictions
  within 1e-6 (the same weights, one forward pass);
- cross-validation over 2 folds: CV metrics within 1e-5 relative.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import h2o3_tpu.models as JMODELS
import h2o3_tpu_torch
from h2o3_tpu.core.frame import Frame as JFrame
from h2o3_tpu_torch import convert
from h2o3_tpu_torch.core.frame import Frame, Vec
from h2o3_tpu_torch.models import deeplearning as TDL

N = 1000
XS = ["x0", "x1", "x2", "x3", "col"]
TOL = 1e-5


@jax.jit
def _split(key):
    return jax.random.split(key)


@partial(jax.jit, static_argnums=1)
def _split_uniform(key, shape):
    key, k = jax.random.split(key)
    return key, jax.random.uniform(k, shape)


class JaxDLDraws:
    """deeplearning.Draws with the JAX package's draws, key for key
    (h2o3_tpu/models/deeplearning.py:109-144); the splits run jitted, as
    in the JAX package's step, so a step's masks cost no dispatch each."""

    def __init__(self, seed):
        self.key = jax.random.PRNGKey(seed if seed > 0 else 0)

    def weights(self, shape, lim):
        self.key, k1 = jax.random.split(self.key)
        return torch.from_numpy(np.array(
            jax.random.uniform(k1, shape, jnp.float32, -lim, lim)))

    def step(self):
        self.key, k = _split(self.key)
        rng = [k]

        def draw(shape):
            rng[0], u = _split_uniform(rng[0], tuple(shape))
            return torch.from_numpy(np.array(u))
        return draw


def replay(model, seed):
    model._draws = lambda device: JaxDLDraws(seed)
    return model


@pytest.fixture(scope="module")
def frames():
    h2o3_tpu_torch.init(device="cpu")
    rng = np.random.default_rng(21)
    X = rng.normal(size=(N, 4))
    X[rng.random((N, 4)) < 0.05] = np.nan
    col = np.array(rng.choice(["r", "g", "b"], N), object)
    col[rng.random(N) < 0.04] = None
    eta = np.nan_to_num(X[:, 0]) - 0.5 * np.nan_to_num(X[:, 1]) \
        + (col == "r")
    cols = {f"x{j}": X[:, j] for j in range(4)}
    cols["col"] = col
    cols["y"] = np.array(["no", "yes"], object)[
        (eta + rng.logistic(size=N) > 0).astype(int)]
    cols["k"] = np.array(["lo", "mid", "top"], object)[
        np.clip(np.round(eta + rng.normal(size=N)), -1, 1).astype(int) + 1]
    cols["g"] = eta + rng.normal(0, 0.5, N)
    jf = JFrame.from_dict(cols)
    tf = Frame(list(cols), [Vec.from_numpy(v) for v in cols.values()])
    yield jf, tf
    h2o3_tpu_torch.shutdown()


def _both(frames, y, **params):
    jf, tf = frames
    jm = JMODELS.H2ODeepLearningEstimator(**params)
    jm.train(x=XS, y=y, training_frame=jf)
    tm = replay(h2o3_tpu_torch.H2ODeepLearningEstimator(**params),
                int(params.get("seed", -1)))
    tm.train(x=XS, y=y, training_frame=tf)
    return jm, tm


def _weight_err(jm, tm):
    return max(float(np.abs(np.asarray(jw) - tw.numpy()).max())
               for pair_j, pair_t in zip(jm._params_net, tm._params_net)
               for jw, tw in zip(pair_j, pair_t))


def _rel(a, b):
    return abs(a - b) / max(abs(a), 1e-30)


CASES = {
    "rectifier_binomial": ("y", {}),
    "tanh_multinomial": ("k", {"activation": "Tanh"}),
    "maxout_regression": ("g", {"activation": "Maxout"}),
    "sgd_momentum_l1_l2": ("y", {"adaptive_rate": False, "rate": 0.01,
                                 "momentum_stable": 0.9, "l1": 1e-4,
                                 "l2": 1e-3}),
    "dropout": ("y", {"activation": "RectifierWithDropout",
                      "input_dropout_ratio": 0.1,
                      "hidden_dropout_ratios": [0.2, 0.3]}),
}


@pytest.fixture(scope="module")
def fits(frames):
    cache = {}

    def get(case):
        if case not in cache:
            y, extra = CASES[case]
            cache[case] = _both(frames, y, hidden=[16, 16], epochs=2.0,
                                seed=3, **extra)
        return cache[case]
    return get


# ---------------------------------------------------------------------------
def test_draws_are_seeded_uniforms():
    """Each draw of deeplearning.Draws has its shape and range, and a
    generator seeded alike draws it again the same."""
    def run():
        d = TDL.Draws(torch.Generator().manual_seed(5))
        step = d.step()
        return d.weights((3, 4), 0.5), step((2, 3)), step((2, 5))
    first, again = run(), run()
    assert [tuple(a.shape) for a in first] == [(3, 4), (2, 3), (2, 5)]
    assert bool((first[0].abs() <= 0.5).all())
    for a, b in zip(first, again):
        assert a.dtype == torch.float32 and torch.equal(a, b)
    assert bool(((first[1] >= 0) & (first[1] < 1)).all())


def test_replayed_draws_follow_the_jax_key_chain():
    """JaxDLDraws takes a layer's weights from split(PRNGKey(seed)) and a
    step's masks from the step key's splits, as the JAX package does."""
    key = jax.random.PRNGKey(7)
    key, k1 = jax.random.split(key)
    key, ks = jax.random.split(key)
    _, kd = jax.random.split(ks)
    d = JaxDLDraws(7)
    np.testing.assert_array_equal(
        d.weights((3, 2), 0.25).numpy(),
        np.array(jax.random.uniform(k1, (3, 2), jnp.float32, -0.25, 0.25)))
    np.testing.assert_array_equal(
        d.step()((4, 3)).numpy(),
        np.array(jax.random.uniform(kd, (4, 3))))


def test_batch_rows_are_the_jax_packages_draws():
    """The rows of each step are one rng.integers call a step, in order,
    also across the chunks copied to the device at once."""
    nsteps = TDL._STEP_CHUNK + 7
    got = [idx.numpy() for _, idx in
           TDL._batches(np.random.default_rng(3), 50, 4, nsteps, "cpu")]
    rng = np.random.default_rng(3)
    want = [rng.integers(0, 50, size=4) for _ in range(nsteps)]
    assert len(got) == nsteps
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_weights_after_a_few_steps_match_jax(frames):
    jm, tm = _both(frames, "y", hidden=[16, 16], epochs=0.25, seed=3)
    assert len(tm.scoring_history()) == 4          # 4 steps of 62 rows
    assert _weight_err(jm, tm) <= 1e-6


@pytest.mark.parametrize("case", list(CASES))
def test_deeplearning_matches_jax(frames, fits, case):
    jf, tf = frames
    jm, tm = fits(case)
    assert tm.summary()["weights"] == jm.summary()["weights"]
    assert _weight_err(jm, tm) <= TOL
    jp, tp = jm.predict(jf).to_numpy(), tm.predict(tf).to_numpy()
    assert jp.shape == tp.shape
    assert np.abs(jp - tp).max() <= TOL * max(1.0, np.abs(jp).max())
    jh, th = jm.scoring_history(), tm.scoring_history()
    assert [h["samples"] for h in jh] == [h["samples"] for h in th]
    for a, b in zip(jh, th):
        assert _rel(a["training_loss"], b["training_loss"]) <= TOL
    metric = {"y": "auc", "k": "logloss", "g": "rmse"}[CASES[case][0]]
    assert _rel(getattr(jm, metric)(), getattr(tm, metric)()) <= TOL


def test_autoencoder_anomaly_matches_jax(frames):
    jf, tf = frames
    params = dict(hidden=[8], epochs=2.0, seed=5, autoencoder=True,
                  activation="Tanh")
    jm = JMODELS.H2ODeepLearningEstimator(**params)
    jm.train(x=XS, training_frame=jf)
    tm = replay(h2o3_tpu_torch.H2ODeepLearningEstimator(**params), 5)
    tm.train(x=XS, training_frame=tf)
    assert not tm.supervised and tm._output.training_metrics is None
    ja, ta = jm.anomaly(jf).to_numpy(), tm.anomaly(tf).to_numpy()
    assert tm.anomaly(tf).names == ["Reconstruction.MSE"]
    assert np.abs(ja - ta).max() <= TOL * np.abs(ja).max()
    # an autoencoder has no prediction frame in either package
    for m, f in ((jm, jf), (tm, tf)):
        with pytest.raises(ValueError):
            m.predict(f)


@pytest.mark.parametrize("case", ["rectifier_binomial", "maxout_regression"])
def test_jax_net_carried_across_scores_the_same(frames, fits, case):
    jf, tf = frames
    jm, _ = fits(case)
    di = jm._dinfo
    cm = convert.deeplearning_from_arrays(
        weights=[(np.asarray(W), np.asarray(b)) for W, b in jm._params_net],
        activation=jm.params["activation"], predictors=di.predictors,
        domains=di.domains, means=di.means, sigmas=di.sigmas,
        standardize=di.standardize, response_name=di.response_name,
        response_domain=di.response_domain)
    jp, cp = jm.predict(jf).to_numpy(), cm.predict(tf).to_numpy()
    assert np.abs(jp - cp).max() <= 1e-6 * max(1.0, np.abs(jp).max())


def test_deeplearning_cv_metrics_match_jax(frames, monkeypatch):
    jf, tf = frames
    monkeypatch.setattr(TDL.H2ODeepLearningEstimator, "_draws",
                        lambda self, device: JaxDLDraws(9))
    params = dict(hidden=[4], epochs=0.5, seed=9, nfolds=2)
    jm = JMODELS.H2ODeepLearningEstimator(**params)
    jm.train(x=XS, y="y", training_frame=jf)
    tm = h2o3_tpu_torch.H2ODeepLearningEstimator(**params)
    tm.train(x=XS, y="y", training_frame=tf)
    jc = jm._output.cross_validation_metrics
    tc = tm._output.cross_validation_metrics
    for name in ("auc", "logloss", "mse"):
        assert _rel(getattr(jc, name), getattr(tc, name)) <= TOL, name


@pytest.mark.parametrize("name,value", [
    ("stopping_rounds", 3), ("stopping_metric", "AUC"),
    ("stopping_tolerance", 0.01), ("max_w2", 10.0),
    ("initial_weight_distribution", "Normal"),
    ("initial_weight_scale", 0.5), ("rate_decay", 0.5),
    ("momentum_start", 0.5), ("momentum_ramp", 100.0),
    ("train_samples_per_iteration", 100), ("shuffle_training_data", True),
    ("reproducible", True), ("loss", "Absolute"), ("loss", "Quadratic")])
def test_ignored_deeplearning_options_raise(frames, name, value):
    """What the JAX package accepts and never reads raises; a loss the
    JAX fit does not use too (a binomial response: cross-entropy)."""
    _, tf = frames
    m = h2o3_tpu_torch.H2ODeepLearningEstimator(hidden=[4], epochs=0.1,
                                                **{name: value})
    with pytest.raises(NotImplementedError, match="not supported"):
        m.train(x=XS, y="y", training_frame=tf)


def test_the_loss_the_jax_fit_uses_is_taken(frames):
    _, tf = frames
    for y, loss in (("y", "CrossEntropy"), ("g", "Quadratic")):
        h2o3_tpu_torch.H2ODeepLearningEstimator(
            hidden=[4], epochs=0.1, loss=loss).train(x=XS, y=y,
                                                     training_frame=tf)
    with pytest.raises(ValueError):
        h2o3_tpu_torch.H2ODeepLearningEstimator(
            hidden=[4], epochs=0.1, activation="Sigmoid").train(
                x=XS, y="y", training_frame=tf)

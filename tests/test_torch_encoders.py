"""Target encoding and Word2Vec of the port against the JAX package, on the
CPU.

Seeded numpy frames go to both packages. Tolerances:
- the target encoder, every mode ("none", "loo", "kfold") with and
  without blending, and noise with the JAX package's numpy draws
  replayed: each encoded column within 1e-12 (relative to 1) of the JAX
  package's per-row loop, the per-level and per-fold sums and counts
  equal. The port's prior is the float64 mean of the response (within
  1e-12 of numpy's); the JAX package takes the mean in f32 (within 1e-6),
  so the encodings are compared with the JAX prior handed to the port;
- Word2Vec with the JAX package's numpy draws replayed: the same pair
  list, in order; the vectors within 1e-5 after 20 steps (f32 SGD whose
  gradients add in another order); `find_synonyms` the same words in the
  same order, similarities within 1e-4; `transform` NONE and AVERAGE
  within 1e-5 of the JAX package's, and AVERAGE within 1e-6 of the mean
  of the port's own vectors.
"""

import numpy as np
import pytest
import torch

import h2o3_tpu.models as JMODELS
import h2o3_tpu_torch
from h2o3_tpu.core.frame import Frame as JFrame
from h2o3_tpu_torch import convert
from h2o3_tpu_torch.core.frame import Frame, Vec, T_STR
from h2o3_tpu_torch.models import word2vec as TW

N = 900


@pytest.fixture(scope="module")
def port_cpu():
    h2o3_tpu_torch.init(device="cpu")
    yield
    h2o3_tpu_torch.shutdown()


@pytest.fixture(scope="module")
def te_frames(port_cpu):
    rng = np.random.default_rng(31)
    a = np.array(rng.choice([f"a{i}" for i in range(12)], N), object)
    a[rng.random(N) < 0.05] = None
    # a level seen once and a rare one: the n <= 0 and blending edges
    b = np.array(rng.choice(["p", "q", "r"], N, p=[0.6, 0.39, 0.01]),
                 object)
    b[7] = "solo"
    ynum = rng.normal(size=N) + (a == "a3")
    ynum[rng.random(N) < 0.03] = np.nan
    ybin = np.array(["n", "y"], object)[(rng.random(N) < 0.3).astype(int)]
    cols = dict(a=a, b=b, ynum=ynum, ybin=ybin,
                fold=rng.integers(0, 4, N).astype(float))
    return JFrame.from_dict(cols), Frame.from_dict(cols)


class _NumpyNoise:
    """The JAX package's noise draws: numpy's default_rng(seed)."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)

    def noise(self, n, amount):
        return torch.from_numpy(self.rng.uniform(-amount, amount, n))


def _encoders(frames, y, **params):
    jf, tf = frames
    params.setdefault("columns_to_encode", ["a", "b"])
    je = JMODELS.H2OTargetEncoderEstimator(**params)
    je.train(y=y, training_frame=jf)
    te = h2o3_tpu_torch.H2OTargetEncoderEstimator(**params)
    te.train(y=y, training_frame=tf)
    yn = tf.vec(y).to_numpy()
    assert te._prior == pytest.approx(np.nanmean(yn), rel=1e-12, abs=0)
    assert te._prior == pytest.approx(je._prior, rel=1e-6)
    te._prior = je._prior           # the formulas, not the f32 mean
    te._draws = lambda device: _NumpyNoise(params.get("seed", -1))
    return je, te


@pytest.mark.parametrize("mode", ["none", "loo", "Leave_One_Out", "kfold"])
@pytest.mark.parametrize("blending", [False, True])
@pytest.mark.parametrize("y", ["ynum", "ybin"])
def test_target_encoder_matches_jax(te_frames, mode, blending, y):
    """Every mode, with and without blending, as training (loo and kfold
    applied) and as a plain transform: each encoded column within 1e-12
    of the JAX package's, and the per-level and per-fold tables equal."""
    jf, tf = te_frames
    je, te = _encoders(te_frames, y, data_leakage_handling=mode,
                       blending=blending, fold_column="fold",
                       inflection_point=5.0, smoothing=3.0)
    assert te._cols == je._cols == ["a", "b"]
    for c in te._cols:
        for k, v in je._encodings[c].items():
            got = te._encodings[c][k]
            if k == "domain":
                assert list(got) == list(v)
            else:
                np.testing.assert_array_equal(got.numpy(), v)
    for as_training in (True, False):
        jo, to = (je.transform(jf, as_training=as_training),
                  te.transform(tf, as_training=as_training))
        assert to.names == jo.names[: len(to.names)]
        for c in te._cols:
            codes = tf.vec(c).as_f32()
            yn = tf.vec(y).as_f32().double() if as_training else None
            folds = te._folds(tf) if as_training else None
            want = je._encode_col(
                c, jf.vec(c).to_numpy()[:N],
                yn=jf.vec(y).to_numpy()[:N] if as_training else None,
                folds=(jf.vec("fold").to_numpy()[:N].astype(int)
                       if as_training and mode == "kfold" else None))
            got = te._encode_col(c, codes, yn=yn, folds=folds)
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=1e-12)
            np.testing.assert_allclose(to.vec(f"{c}_te").to_numpy(), want,
                                       rtol=1e-6)


def test_target_encoder_noise_replays_numpy_draws(te_frames):
    """noise 0.05 with seed 9: the same uniforms as the JAX package's
    default_rng(9), added on training transforms only (within 1e-12)."""
    jf, tf = te_frames
    je, te = _encoders(te_frames, "ynum", data_leakage_handling="loo",
                       noise=0.05, seed=9)
    codes = tf.vec("a").as_f32()
    yn = tf.vec("ynum").as_f32().double()
    want = je._encode_col("a", jf.vec("a").to_numpy()[:N],
                          yn=jf.vec("ynum").to_numpy()[:N])
    got = te._encode_col("a", codes, yn=yn)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    te.params["noise"] = 0.0
    quiet = te._encode_col("a", codes, yn=yn)
    assert float((got - quiet).abs().max()) <= 0.05
    assert float((got - quiet).abs().max()) > 0.01


def test_target_encoder_edges_and_carry(te_frames):
    """A level with no other row (loo) and an NA level take the prior; a
    non-binary categorical response raises; a JAX encoder carried across
    (convert.target_encoder_from_arrays) encodes the same."""
    jf, tf = te_frames
    je, te = _encoders(te_frames, "ynum", data_leakage_handling="loo",
                       fold_column="fold")
    out = te._encode_col("b", tf.vec("b").as_f32(),
                         yn=tf.vec("ynum").as_f32().double())
    assert float(out[7]) == te._prior          # "solo": n - 1 == 0
    na = torch.isnan(tf.vec("a").as_f32())
    assert bool(na.any()) and bool((te._encode_col(
        "a", tf.vec("a").as_f32())[na] == te._prior).all())
    with pytest.raises(ValueError, match="binary"):
        h2o3_tpu_torch.H2OTargetEncoderEstimator().train(
            y="a", training_frame=tf)
    carried = convert.target_encoder_from_arrays(
        encodings=je._encodings, prior=je._prior, response_name=je._y,
        params=je.params)
    for c in ("a", "b"):
        np.testing.assert_allclose(
            carried._encode_col(c, tf.vec(c).as_f32()).numpy(),
            je._encode_col(c, jf.vec(c).to_numpy()[:N]), rtol=0, atol=1e-12)


# ---------------------------------------------------------------------------
# Word2Vec
W2V = dict(vec_size=16, window_size=3, min_word_freq=3, epochs=5,
           negative_samples=4, seed=5)


def _corpus(seed=41, n_topics=6, per_topic=8, n_sent=136):
    """Sentences of 4-10 words of one topic each, NA-terminated, and a
    few rare words (below min_word_freq)."""
    rng = np.random.default_rng(seed)
    words = []
    for _ in range(n_sent):
        t = rng.integers(n_topics)
        k = rng.integers(4, 11)
        words += [f"t{t}w{w}" for w in rng.integers(0, per_topic, k)]
        if rng.random() < 0.1:
            words.append(f"rare{rng.integers(100)}")
        words.append(None)
    return np.array(words, object)


class _NumpyW2VDraws:
    """The JAX package's Word2Vec draws, from numpy's default_rng(seed) in
    its order: the initial vectors, then per step the pairs and the
    negatives (numpy's choice(p=): uniforms searched in the CDF)."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)

    def init(self, V, dim):
        return torch.from_numpy(self.rng.uniform(-0.5 / dim, 0.5 / dim,
                                                 (V, dim))).float()

    def pairs(self, B, npairs):
        return torch.from_numpy(self.rng.integers(0, npairs, B))

    def negatives(self, B, neg, cdf):
        u = self.rng.random((B, neg))
        return torch.from_numpy(np.searchsorted(cdf.numpy(), u,
                                                side="right"))


def _ref_pairs(words, vocab, win):
    """The reference's pair loops (h2o3_tpu/models/word2vec.py:311-327)."""
    sents, cur = [], []
    for w in words:
        if w is None:
            if cur:
                sents.append(cur)
            cur = []
        elif w in vocab:
            cur.append(vocab[w])
    if cur:
        sents.append(cur)
    out = []
    for s in sents:
        for i, c in enumerate(s):
            for j in range(max(0, i - win), min(len(s), i + win + 1)):
                if j != i:
                    out.append((c, s[j]))
    return np.asarray(out)


@pytest.fixture(scope="module")
def w2v(port_cpu):
    words = _corpus()
    jf = JFrame.from_dict({"w": words}, column_types={"w": "str"})
    tf = Frame(["w"], [Vec.from_numpy(words, type=T_STR)])
    jm = JMODELS.H2OWord2vecEstimator(**W2V)
    jm.train(training_frame=jf)
    tm = h2o3_tpu_torch.H2OWord2vecEstimator(**W2V)
    tm._draws = lambda device: _NumpyW2VDraws(W2V["seed"])
    tm.train(training_frame=tf)
    return words, jf, tf, jm, tm


def test_word2vec_pairs_in_reference_order(w2v):
    """The vocabulary most frequent first, and the pair list the
    reference's loops give, in their order; 20 steps of B 1024."""
    words, _, _, jm, tm = w2v
    assert tm._vocab_list == jm._vocab_list
    want = _ref_pairs(list(words), jm._vocab, W2V["window_size"])
    centers, contexts = TW._pairs(list(words), tm._vocab,
                                  W2V["window_size"])
    np.testing.assert_array_equal(centers, want[:, 0])
    np.testing.assert_array_equal(contexts, want[:, 1])
    assert tm._pairs == len(want)
    assert tm._steps == W2V["epochs"] * len(want) // 1024 == 20


def test_word2vec_vectors_and_synonyms_match_jax(w2v):
    """After 20 steps the vectors within 1e-5 of the JAX package's;
    find_synonyms gives the same words in the same order."""
    _, _, _, jm, tm = w2v
    np.testing.assert_allclose(tm._vectors.numpy(), jm._vectors, atol=1e-5)
    for w in ("t0w0", "t3w5", "t5w1"):
        js, ts = jm.find_synonyms(w, 5), tm.find_synonyms(w, 5)
        assert list(ts) == list(js)
        np.testing.assert_allclose(list(ts.values()), list(js.values()),
                                   atol=1e-4)
    assert tm.find_synonyms("nope") == {}


@pytest.mark.parametrize("how", ["NONE", "AVERAGE"])
def test_word2vec_transform_matches_jax(w2v, how):
    """transform NONE (NaN rows for unknown words) and AVERAGE (one row a
    NA-terminated sentence) within 1e-5 of the JAX package's; AVERAGE
    rows within 1e-6 of the mean of the port's own word vectors."""
    words, jf, tf, jm, tm = w2v
    jo = jm.transform(jf, aggregate_method=how).to_numpy()
    to = tm.transform(tf, aggregate_method=how).to_numpy()
    assert to.shape == jo.shape
    np.testing.assert_allclose(to, jo, atol=1e-5)
    if how == "AVERAGE":
        vec = tm._vectors.double().numpy()
        rows, cur = [], []
        for w in words:
            if w is None:
                rows.append(np.mean(cur, axis=0) if cur
                            else np.full(vec.shape[1], np.nan))
                cur = []
            elif w in tm._vocab:
                cur.append(vec[tm._vocab[w]])
        np.testing.assert_allclose(to, np.vstack(rows), atol=1e-6)


def test_word2vec_carried_and_options_that_raise(w2v):
    """convert.word2vec_from_arrays scores the JAX vectors the same;
    norm_model and sent_sample_rate other than their defaults raise (the
    JAX package reads neither)."""
    _, jf, tf, jm, _ = w2v
    carried = convert.word2vec_from_arrays(vectors=jm._vectors,
                                           vocab=jm._vocab_list)
    np.testing.assert_allclose(carried.transform(tf).to_numpy(),
                               jm.transform(jf).to_numpy(), atol=1e-6)
    assert list(carried.find_synonyms("t1w2", 3)) == \
        list(jm.find_synonyms("t1w2", 3))
    assert carried.to_frame().names[:2] == ["Word", "V1"]
    for bad in ({"norm_model": "NegSampling"}, {"sent_sample_rate": 0.0}):
        with pytest.raises(NotImplementedError):
            h2o3_tpu_torch.H2OWord2vecEstimator(**bad).train(
                training_frame=tf)

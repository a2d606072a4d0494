"""The port's scorer cache and param store against the JAX package's, on
the CPU (where the port's program runs its scorer eagerly, so these
tests hold the cache's logic; tests/test_torch_gpu.py holds the CUDA
graphs). Mirrors tests/test_scoring_cache.py and tests/test_mesh_scoring.py.

- `row_bucket`, hits and misses (3 row counts in one bucket: 1 build),
  LRU eviction and each entry's param reference released, the
  stale-generation purge on a DKV overwrite, `invalidate_key`, the
  broken strikes and their cool-down, the fallback reasons: each the
  same sequence of counters in both packages;
- predictions: the fast path of every family that exports serving
  params equals the eager scorer on the same padded buffer bit for bit
  and `predict`'s eager path within 1e-6 without padding (the CPU's
  vectorised transcendentals treat a vector's tail elementwise, so a
  link function can move a last bit with the row count); JAX models
  carried across score the same frames within 1e-5 of the JAX package;
- param tiers: a demote and a promote are bit-exact (the trees' catbits
  included), the HBM budget is never exceeded under concurrent faults,
  a pinned model is never a victim, an npz spill is freed exactly once.
"""

import threading

import numpy as np
import pytest
import torch

import h2o3_tpu_torch
from h2o3_tpu import models as JE
from h2o3_tpu.core.frame import Frame as JFrame
from h2o3_tpu.core.kvstore import DKV as JDKV
from h2o3_tpu.obs import metrics as JM
from h2o3_tpu.serving import scorer_cache as JSC
from h2o3_tpu_torch.core.frame import Frame
from h2o3_tpu_torch.core.kvstore import DKV
from h2o3_tpu_torch.obs import metrics as TM
from h2o3_tpu_torch.serving import params as SP
from h2o3_tpu_torch.serving import scorer_cache as TSC
from test_torch_genmodel import carry

COUNTERS = ("h2o3_scorer_cache_hits_total", "h2o3_scorer_cache_misses_total",
            "h2o3_scorer_cache_evictions_total")


@pytest.fixture(scope="module")
def port_cpu():
    h2o3_tpu_torch.init(device="cpu")
    yield
    h2o3_tpu_torch.shutdown()


def _cols(n, seed):
    rng = np.random.default_rng(seed)
    a, b = rng.normal(size=n), rng.normal(size=n)
    c = rng.choice(["x", "y", "z"], size=n)
    y = (a - b + (c == "x") + rng.normal(0, 0.5, n)) > 0
    return {"a": a, "b": b, "c": c,
            "resp": np.array(["no", "yes"], object)[y.astype(int)]}


def _pair(n, seed):
    cols = _cols(n, seed)
    return JFrame.from_dict(cols), Frame.from_dict(cols)


@pytest.fixture(scope="module")
def glms(port_cpu):
    """A binomial GLM in each package on the same frame."""
    jf, tf = _pair(300, 7)
    jm = JE.ESTIMATORS["glm"](family="binomial")
    jm.train(x=["a", "b", "c"], y="resp", training_frame=jf)
    tm = h2o3_tpu_torch.H2OGeneralizedLinearEstimator(family="binomial")
    tm.train(x=["a", "b", "c"], y="resp", training_frame=tf)
    return jm, tm


def _snap(M):
    return {n: (M.REGISTRY.get(n).value() if M.REGISTRY.get(n) else 0.0)
            for n in COUNTERS}


def _delta(before, M):
    after = _snap(M)
    return {n: after[n] - before[n] for n in COUNTERS}


def _fallbacks(M, reason):
    m = M.REGISTRY.get("h2o3_scorer_fallbacks_total")
    return m.value(reason=reason) if m is not None else 0.0


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [1, 127, 128, 129, 1000, 70_000])
def test_row_bucket_matches_jax(n, port_cpu):
    assert TSC.row_bucket(n) == JSC.row_bucket(n)


def test_three_row_counts_in_one_bucket_build_once(glms):
    jm, tm = glms
    JSC.CACHE.clear()
    TSC.CACHE.clear()
    got = {}
    for name, m, F, SC, M in (("jax", jm, JFrame, JSC, JM),
                              ("port", tm, Frame, TSC, TM)):
        before = _snap(M)
        for n in (70, 100, 128):
            f = F.from_dict({k: v[:n] for k, v in _cols(300, 8).items()
                             if k != "resp"})
            m.predict(f)
        m.predict(F.from_dict({k: v[:200] for k, v in _cols(300, 9).items()
                               if k != "resp"}))
        got[name] = _delta(before, M)
    assert got["port"] == got["jax"]
    assert got["port"]["h2o3_scorer_cache_misses_total"] == 2
    assert got["port"]["h2o3_scorer_cache_hits_total"] == 2


def test_lru_eviction_releases_the_param_reference(glms, monkeypatch):
    jm, tm = glms
    monkeypatch.setenv("H2O3_SCORER_CACHE_SIZE", "2")
    got = {}
    for name, m, F, SC, M in (("jax", jm, JFrame, JSC, JM),
                              ("port", tm, Frame, TSC, TM)):
        SC.CACHE.clear()
        before = _snap(M)
        for n in (100, 200, 400):
            m.predict(F.from_dict({k: v[:n] for k, v in
                                   _cols(400, 10).items()}))
        refs = SC.PARAMS._placements[(m.key, SC.model_token(m))].refs
        got[name] = (_delta(before, M), len(SC.CACHE._entries), refs)
    assert got["port"] == got["jax"]
    assert got["port"][1:] == (2, 2)


def test_dkv_overwrite_purges_the_old_generation(port_cpu):
    """A retrained model under the same key: the old generation's
    programs and placement go, in both packages."""
    got = {}
    for name, est, F, SC, store in (
            ("jax", JE.ESTIMATORS["glm"], JFrame, JSC, JDKV),
            ("port", h2o3_tpu_torch.H2OGeneralizedLinearEstimator, Frame,
             TSC, DKV)):
        SC.CACHE.clear()
        fr = F.from_dict(_cols(300, 11))
        m1 = est(family="binomial", model_id="serve_m")
        m1.train(x=["a", "b"], y="resp", training_frame=fr)
        m1.predict(fr)
        t1 = SC.model_token(m1)
        had = (("serve_m", t1) in SC.PARAMS._placements,
               len([k for k in SC.CACHE._entries if k[1] == t1]))
        m2 = est(family="binomial", model_id="serve_m")
        m2.train(x=["a", "b", "c"], y="resp", training_frame=fr)
        gone = (("serve_m", t1) in SC.PARAMS._placements,
                len([k for k in SC.CACHE._entries if k[1] == t1]))
        p2 = m2.predict(fr)
        t2 = SC.model_token(m2)
        now = len([k for k in SC.CACHE._entries if k[1] == t2])
        store.remove("serve_m")
        after = (len([k for k in SC.CACHE._entries if k[0] == "serve_m"]),
                 SC.PARAMS.bytes_for("serve_m"))
        got[name] = (had, gone, now, after, p2.nrows)
    assert got["port"] == got["jax"]
    assert got["port"][1] == (False, 0) and got["port"][3] == (0, 0)


def test_invalidate_key_and_fallback_reasons_match_jax(glms, monkeypatch):
    jm, tm = glms
    got = {}
    for name, m, F, SC, M in (("jax", jm, JFrame, JSC, JM),
                              ("port", tm, Frame, TSC, TM)):
        SC.CACHE.clear()
        f = F.from_dict({k: v[:50] for k, v in _cols(300, 12).items()})
        m.predict(f)
        n_in = len(SC.CACHE._entries)
        SC.CACHE.invalidate_key(m.key)
        n_out = (len(SC.CACHE._entries), SC.PARAMS.bytes_for(m.key))
        r0 = _fallbacks(M, "too-large")
        monkeypatch.setenv("H2O3_SCORE_FASTPATH_MAX_ROWS", "10")
        assert SC.score_frame(m, f) is None
        monkeypatch.delenv("H2O3_SCORE_FASTPATH_MAX_ROWS")
        reasons = (_fallbacks(M, "too-large") - r0,
                   SC._fastpath_reason(m, 0))
        key = m.key
        m.key = None
        nodinfo = SC._fastpath_reason(m, 10)
        m.key = key
        m._serving_fastpath = False
        optout = SC._fastpath_reason(m, 10)
        del m._serving_fastpath
        got[name] = (n_in, n_out, reasons, nodinfo, optout)
    assert got["port"] == got["jax"]
    assert got["port"][3:] == ("no-dinfo", "model-opt-out")


def test_broken_strikes_and_cool_down_match_jax(glms, monkeypatch):
    """Three failing dispatches park the model on the eager path (each a
    trace-error fallback, the answer still right within 1e-6: the eager
    path scores the unpadded rows); after the cool-down one probe runs,
    and a success clears the strikes."""
    jm, tm = glms
    got = {}
    for name, m, F, SC, M in (("jax", jm, JFrame, JSC, JM),
                              ("port", tm, Frame, TSC, TM)):
        SC.CACHE.clear()
        f = F.from_dict({k: v[:40] for k, v in _cols(300, 13).items()})
        want = np.asarray(m.predict(f).vec("pyes").to_numpy())
        cls = type(m)
        orig = cls._score_with_params

        def boom(self, params, X):
            raise RuntimeError("scorer broke")
        monkeypatch.setattr(cls, "_score_with_params", boom)
        # the next build (a JAX trace) or dispatch (the port's program)
        # runs the broken scorer
        SC.CACHE.clear()
        r0 = _fallbacks(M, "trace-error")
        answers = []
        key = (m.key, SC.model_token(m))
        for _ in range(4):
            got_p = np.asarray(m.predict(f).vec("pyes").to_numpy())
            answers.append(bool(np.abs(got_p - want).max() <= 1e-6))
        parked = SC._is_broken(key)
        strikes = _fallbacks(M, "trace-error") - r0
        monkeypatch.setattr(cls, "_score_with_params", orig)
        monkeypatch.setattr(SC, "_BROKEN_COOLDOWN_S", 0.0)
        m.predict(f)
        cleared = not SC._is_broken(key) and key not in SC._BROKEN
        monkeypatch.setattr(SC, "_BROKEN_COOLDOWN_S", 60.0)
        got[name] = (answers, parked, strikes, cleared)
    assert got["port"] == got["jax"]
    assert got["port"][1:] == (True, 4.0, True)


# ---------------------------------------------------------------------------
# predictions of every family that exports serving params
def _num_cols(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(4, n))
    y = (x[0] - x[1] + rng.normal(0, 0.5, n)) > 0
    return {"x0": x[0], "x1": x[1], "x2": x[2], "x3": x[3],
            "c": rng.choice(["u", "v", "w"], size=n),
            "y": np.array(["n", "p"], object)[y.astype(int)]}


FAMILIES = {
    "gbm": ("H2OGradientBoostingEstimator", dict(ntrees=4, max_depth=3,
                                                 seed=1), True),
    "drf": ("H2ORandomForestEstimator", dict(ntrees=3, max_depth=4,
                                             seed=1), True),
    "xgboost": ("H2OXGBoostEstimator", dict(ntrees=3, max_depth=3,
                                            seed=1), True),
    "glm": ("H2OGeneralizedLinearEstimator", dict(family="binomial"), True),
    "deeplearning": ("H2ODeepLearningEstimator",
                     dict(hidden=[6], epochs=1, seed=1), True),
    "naivebayes": ("H2ONaiveBayesEstimator", {}, True),
    "psvm": ("H2OSupportVectorMachineEstimator", {}, True),
    "coxph": None,
    "kmeans": ("H2OKMeansEstimator", dict(k=3, seed=1), False),
    "pca": ("H2OPrincipalComponentAnalysisEstimator", dict(k=2), False),
    "svd": ("H2OSingularValueDecompositionEstimator", dict(nv=2), False),
    "isolationforest": ("H2OIsolationForestEstimator",
                        dict(ntrees=4, seed=1), False),
    "extendedisolationforest": ("H2OExtendedIsolationForestEstimator",
                                dict(ntrees=4, seed=1), False),
}
TREES = ("gbm", "drf", "xgboost", "isolationforest")


@pytest.fixture(scope="module")
def serve_frame(port_cpu):
    return Frame.from_dict(_num_cols(500, 21))


def _train_family(algo, fr):
    if algo == "coxph":
        rng = np.random.default_rng(3)
        n = fr.nrows
        cols = {"x0": rng.normal(size=n), "x1": rng.normal(size=n),
                "t": rng.exponential(1.0, n) + 0.01,
                "e": (rng.random(n) < 0.7).astype(float)}
        f = Frame.from_dict(cols)
        m = h2o3_tpu_torch.H2OCoxProportionalHazardsEstimator(
            stop_column="t")
        m.train(x=["x0", "x1"], y="e", training_frame=f)
        return m, f
    cls, params, sup = FAMILIES[algo]
    m = getattr(h2o3_tpu_torch, cls)(**params)
    if sup:
        m.train(y="y", training_frame=fr)
    else:
        m.train(x=["x0", "x1", "x2", "x3"], training_frame=fr)
    return m, fr


@pytest.mark.parametrize("algo", sorted(FAMILIES))
def test_fast_path_equals_the_eager_scorer(algo, serve_frame):
    m, fr = _train_family(algo, serve_frame)
    assert m._serving_params() is not None
    di = m._dinfo
    n = fr.nrows
    bucket = TSC.row_bucket(n)
    raw = TSC.stage_frame(di, di.adapt(fr), bucket)
    fast = TSC.score_rows(m, raw, n)
    placed = TSC.PARAMS.placed(m, TSC.model_token(m))
    with torch.no_grad():
        padded = m._score_with_params(
            placed, di.assemble_design(torch.from_numpy(raw))).numpy()
        eager = m._score_matrix(di.matrix(fr)).numpy()
    assert np.array_equal(fast.view(np.uint8), padded.view(np.uint8))
    if algo in TREES + ("kmeans",):
        tol = 0.0 if algo in ("gbm", "drf", "isolationforest",
                              "kmeans") else 1e-6
    else:
        tol = 1e-6
    assert np.abs(fast[:n].astype(np.float64) - eager).max() <= tol
    DKV.remove(m.key)


@pytest.mark.parametrize("algo", ["gbm", "glm", "deeplearning", "kmeans"])
def test_carried_jax_models_score_as_the_jax_package(algo, port_cpu):
    """A JAX model carried across: the port's fast path on the same
    frame within 1e-5 of the JAX package's (its fast path too)."""
    cols = _num_cols(300, 22)
    jf, tf = JFrame.from_dict(cols), Frame.from_dict(cols)
    cls, params, sup = FAMILIES[algo]
    jm = JE.ESTIMATORS[algo](**params)
    if sup:
        jm.train(x=["x0", "x1", "x2", "x3", "c"], y="y", training_frame=jf)
    else:
        jm.train(x=["x0", "x1", "x2", "x3"], training_frame=jf)
    tm = carry(jm)
    DKV.put(tm.key, tm)
    want = np.asarray(JSC.score_frame(jm, jf))[:300]
    got = TSC.score_frame(tm, tf)[:300]
    assert np.abs(got.astype(np.float64) - want).max() <= 1e-5
    DKV.remove(tm.key)
    JDKV.remove(jm.key)


# ---------------------------------------------------------------------------
# param tiers
def test_demote_promote_is_bit_exact_with_catbits(port_cpu, tmp_path):
    """A GBM with categorical set splits (int64-held uint32 catbits): the
    placement demoted to the host and to an npz and promoted back holds
    every leaf bit for bit and the same dtype, and scores the same."""
    rng = np.random.default_rng(31)
    n = 600
    lv = np.array([f"l{i}" for i in range(40)])
    codes = rng.integers(0, 40, n)
    y = np.isin(codes, rng.choice(40, 20, replace=False))
    fr = Frame.from_dict({"cat": lv[codes], "x": rng.normal(size=n),
                          "y": np.array(["n", "p"], object)[y.astype(int)]})
    m = h2o3_tpu_torch.H2OGradientBoostingEstimator(ntrees=3, max_depth=3,
                                                    seed=1)
    m.train(y="y", training_frame=fr)
    assert m._trees.catbits is not None
    want = TSC.score_frame(m, fr)
    key = (m.key, TSC.model_token(m))
    p = TSC.PARAMS._placements[key]
    leaves0, _ = SP.tree_flatten(p.placed)
    snap = [(t.dtype, t.clone()) for t in leaves0]
    for tier in (SP.TIER_HOST, SP.TIER_DISK):
        TSC.PARAMS.demote_key(m.key, tier)
        assert p.tier == tier
        got = TSC.score_frame(m, fr)
        assert np.array_equal(got.view(np.uint8), want.view(np.uint8))
        leaves, _ = SP.tree_flatten(p.placed)
        assert [t.dtype for t in leaves] == [d for d, _ in snap]
        assert all(torch.equal(a, b) for a, (_, b) in zip(leaves, snap))
        assert p.placed["_trees"].catbits.dtype == torch.int64
    DKV.remove(m.key)


def _small_models(n_models):
    rng = np.random.default_rng(41)
    out = []
    for i in range(n_models):
        cols = {f"x{j}": rng.normal(size=200) for j in range(3)}
        cols["y"] = rng.normal(size=200)
        fr = Frame.from_dict(cols)
        m = h2o3_tpu_torch.H2OGradientBoostingEstimator(
            ntrees=1 + i, max_depth=2, seed=1, distribution="gaussian",
            histogram_type="UniformAdaptive")
        m.train(y="y", training_frame=fr)
        out.append((m, fr))
    return out


def test_budget_is_never_exceeded_under_concurrent_faults(port_cpu,
                                                          monkeypatch):
    """Four models, a budget that holds two of the largest, eight threads
    scoring them at once: the admitted bytes never exceed the budget and
    every answer is its serial one."""
    TSC.CACHE.clear()
    models = _small_models(4)
    serial = [TSC.score_frame(m, f) for m, f in models]
    sizes = [TSC.PARAMS.bytes_for(m.key) for m, _ in models]
    budget = 2 * max(sizes)
    monkeypatch.setenv("H2O3_SERVE_HBM_BUDGET_MB", repr(budget / 2**20))
    for m, _ in models:
        TSC.PARAMS.demote_key(m.key)
    over, errors, wrong = [], [], []
    stop = threading.Event()

    def sample():
        while not stop.wait(1e-4):
            over.append(TSC.PARAMS.admitted_bytes() > budget)

    def work(i):
        try:
            for r in range(8):
                m, f = models[(i + r) % len(models)]
                out = TSC.score_frame(m, f)
                if not np.array_equal(out, serial[(i + r) % len(models)]):
                    wrong.append(i)
        except Exception as e:      # noqa: BLE001 — reported below
            errors.append(repr(e))
    sampler = threading.Thread(target=sample)
    sampler.start()
    ts = [threading.Thread(target=work, args=(i,)) for i in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    stop.set()
    sampler.join(timeout=10)
    assert not any(t.is_alive() for t in ts)
    assert not errors and not wrong
    assert over and not any(over)
    assert TSC.PARAMS.stats()["faults"] > 0
    for m, _ in models:
        DKV.remove(m.key)


def test_pinned_model_is_never_a_victim(port_cpu, monkeypatch):
    TSC.CACHE.clear()
    models = _small_models(3)
    for m, f in models:
        TSC.score_frame(m, f)
    sizes = [TSC.PARAMS.bytes_for(m.key) for m, _ in models]
    monkeypatch.setenv("H2O3_SERVE_HBM_BUDGET_MB",
                       repr((sizes[0] + max(sizes[1:])) / 2**20))
    pinned = models[0][0]
    TSC.PARAMS.pin(pinned.key)
    for _ in range(3):
        for m, f in models[1:]:
            TSC.score_frame(m, f)
            tiers = TSC.PARAMS.by_model_tier()[pinned.key]
            assert tiers["hbm"] == sizes[0]
    TSC.PARAMS.pin(pinned.key, False)
    for m, _ in models:
        DKV.remove(m.key)


def test_npz_spill_is_freed_exactly_once(port_cpu, monkeypatch):
    from h2o3_tpu_torch.io import spill
    TSC.CACHE.clear()
    (m, f), = _small_models(1)
    TSC.score_frame(m, f)
    TSC.PARAMS.demote_key(m.key, SP.TIER_DISK)
    p = TSC.PARAMS._placements[(m.key, TSC.model_token(m))]
    path = p.path
    assert path is not None and spill.os.path.exists(path)
    deleted = []
    orig = spill.delete_params
    monkeypatch.setattr(spill, "delete_params",
                        lambda q: (deleted.append(q), orig(q)))
    DKV.remove(m.key)
    TSC.CACHE.invalidate_key(m.key)       # a second sweep frees nothing
    assert deleted == [path] and not spill.os.path.exists(path)
    assert TSC.PARAMS.bytes_for(m.key) == 0


def test_a_cloud_on_another_device_replaces_the_params(port_cpu):
    """The placement records its device; with the cloud on another one
    the next dispatch re-places the params there (the JAX package's
    epoch re-place), bit for bit."""
    (m, f), = _small_models(1)
    want = TSC.score_frame(m, f)
    p = TSC.PARAMS._placements[(m.key, TSC.model_token(m))]
    gen = p.gen
    p.device = torch.device("meta")     # as if placed on another device
    got = TSC.score_frame(m, f)
    assert np.array_equal(got, want)
    assert p.device == torch.device("cpu") and p.gen == gen + 1
    DKV.remove(m.key)

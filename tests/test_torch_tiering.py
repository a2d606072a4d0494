"""The port's chunk pager against the JAX package's, on the CPU.

Each package gets the same frames and the same sequence of reads, budget
changes and demotions; after each step every chunk must sit in the same
tier in both. Chunks alive before a test (other tests' frames) are
pinned for its length in both pagers and the budgets set above their
bytes, so that only the test's own chunks move. At 512 rows neither
package pads, so the chunks' bytes are equal; at 500 rows the JAX
package pads each plane to 512 rows and always keeps an NA plane (its
padding rows are NA), and the byte counts differ by exactly that.

The spill ladder (HBM, host, disk and back) must return every codec's
planes and both SparseVec nz planes bit for bit, and a GBM trained on a
frame parsed under a small HBM budget must predict bit for bit as one
trained without a budget (tests/test_tiering.py:209 for the JAX
package).
"""

import gc
import time

import numpy as np
import pytest

import h2o3_tpu_torch
from h2o3_tpu.core import frame as JF
from h2o3_tpu.core import tiering as JT
from h2o3_tpu.core.kvstore import DKV as JDKV
from h2o3_tpu.core.memory import MANAGER as JMANAGER
from h2o3_tpu_torch.core import frame as TF
from h2o3_tpu_torch.core import tiering as TT
from h2o3_tpu_torch.core.kvstore import DKV
from h2o3_tpu_torch.core.memory import MANAGER
from h2o3_tpu_torch.parallel import mrtask

N = 512


def _isolate(pager, ice, mgr):
    """Pin every chunk alive now; returns the undo."""
    gc.collect()
    with pager._lock:
        pager._reap_locked()
        old = pager._live_locked()
    for c in old:
        c.pinned += 1
    saved = (pager.hbm_budget, pager.host_budget, mgr.ice_root)
    mgr.ice_root = ice

    def undo():
        pager.hbm_budget, pager.host_budget, mgr.ice_root = saved
        for c in old:
            c.pinned -= 1
    return undo


@pytest.fixture()
def pagers(tmp_path):
    h2o3_tpu_torch.init(device="cpu")
    undo_j = _isolate(JT.PAGER, str(tmp_path / "jax"), JMANAGER)
    undo_t = _isolate(TT.PAGER, str(tmp_path / "port"), MANAGER)
    yield JT.PAGER, TT.PAGER
    for k in list(JDKV.keys()):
        if isinstance(JDKV.raw_get(k), JF.Frame):
            JDKV.remove(k)
    undo_j()
    undo_t()
    h2o3_tpu_torch.shutdown()
    gc.collect()


def _cols(n, seed=3):
    rng = np.random.default_rng(seed)
    i = np.arange(n, dtype=np.float64)
    return {
        "const": np.full(n, 7.0),
        "i8": np.where(i % 11 == 0, np.nan, i % 100),
        "i16": i % 30000 * 3.0,
        "i32": i * 70000.0,
        "f32": np.where(i % 7 == 0, np.nan, rng.normal(size=n)),
        "f32b": rng.normal(size=n),
    }


def _tiers(f):
    return [v._chunk.tier for v in f.vecs]


def _base(pager):
    tb = pager.tier_bytes()
    return tb["hbm"], tb["host"]


def test_pager_decisions_match_jax(pagers):
    jp, tp = pagers
    jb, tb = _base(jp), _base(tp)
    jf = JF.Frame.from_dict(_cols(N))
    tf = TF.Frame.from_dict(_cols(N))
    assert [v._chunk.nbytes for v in jf.vecs] == \
        [v._chunk.nbytes for v in tf.vecs]
    per = sum(v._chunk.nbytes for v in tf.vecs)
    trace = []

    def step(what, fn_j, fn_t):
        fn_j()
        fn_t()
        assert _tiers(jf) == _tiers(tf), (what, _tiers(jf), _tiers(tf))
        trace.append(_tiers(tf))

    def budgets(hbm, host):
        def setter(pager, base):
            def f():
                pager.hbm_budget = base[0] + hbm if hbm else 0
                pager.host_budget = base[1] + host if host else 0
                pager.maybe_demote()
            return f
        return setter(jp, jb), setter(tp, tb)

    step("hbm budget", *budgets(per // 2, 0))
    for order in ([0, 3, 5], [1, 2, 4, 0], [5, 4, 3, 2, 1, 0]):
        for j in order:
            step(f"read {j}", jf.vecs[j].to_numpy, tf.vecs[j].to_numpy)
    step("touch frame", lambda: JDKV.get(jf.key), lambda: DKV.get(tf.key))
    step("host budget", *budgets(per // 3, per // 3))
    for j in (2, 0, 4):
        step(f"read {j}", jf.vecs[j].to_numpy, tf.vecs[j].to_numpy)
    step("spill", lambda: JMANAGER.spill(jf.key),
         lambda: MANAGER.spill(tf.key))
    step("budgets off", *budgets(0, 0))
    step("get spilled frame", lambda: JDKV.get(jf.key),
         lambda: DKV.get(tf.key))
    for j in range(6):
        step(f"read {j}", jf.vecs[j].to_numpy, tf.vecs[j].to_numpy)
    assert {t for tiers in trace for t in tiers} == {"hbm", "host", "disk"}
    assert np.array_equal(jf.to_numpy(), tf.to_numpy(), equal_nan=True)
    DKV.remove(tf.key)


def test_padding_is_the_only_byte_difference(pagers):
    n = 500
    jf = JF.Frame.from_dict(_cols(n))
    tf = TF.Frame.from_dict(_cols(n))
    pad = JF._mesh.cloud().padded_rows(n)
    assert pad == 512
    total = 0
    for jv, tv in zip(jf.vecs, tf.vecs):
        item = np.dtype(tv.codec.np_dtype).itemsize
        has_mask = tv._chunk._dev[1] is not None
        # the padding rows of the codec plane, and of the NA plane, which
        # the JAX package keeps for its padding even without an NA
        diff = (pad - n) * item + ((pad - n) if has_mask else pad)
        assert jv._chunk.nbytes - tv._chunk.nbytes == diff
        total += diff
    assert JMANAGER.frame_bytes(jf) - MANAGER.frame_bytes(tf) == total
    DKV.remove(tf.key)


def test_spill_ladder_is_bit_exact_for_every_codec_and_nz_plane(pagers):
    tf = TF.Frame.from_dict(_cols(N))
    rows = np.sort(np.random.default_rng(7).choice(5000, 321,
                                                   replace=False))
    vals = np.random.default_rng(8).normal(0, 3, 321).astype(np.float32)
    vals[5] = np.nan
    sv = TF.SparseVec(rows, vals, 5000)
    assert {v.codec.kind for v in tf.vecs} == \
        {"const", "i8", "i16", "i32", "f32"}
    chunks = [v._chunk for v in tf.vecs] + [sv._nzr_chunk, sv._nzv_chunk]
    before = [tuple(None if p is None else p.numpy().copy()
                    for p in c.device()) for c in chunks]
    decoded = tf.to_numpy()
    for to in (TT.TIER_HOST, TT.TIER_DISK):
        for c in chunks:
            TT.PAGER.demote(c, to)
        assert all(c.tier == to for c in chunks)
        assert sv.nnz == 321                   # metadata: no fault
        assert sv._nzr_chunk.tier == to
    assert MANAGER.is_spilled(tf.key)
    for c, b in zip(chunks, before):
        got = c.device()
        assert c.tier == "hbm"
        for p, q in zip(got, b):
            assert (p is None) == (q is None)
            if p is not None:
                assert p.dtype == TT._host_tensor(q).dtype
                assert np.array_equal(p.numpy().view(np.uint8),
                                      q.view(np.uint8))
    assert np.array_equal(tf.to_numpy(), decoded, equal_nan=True)
    DKV.remove(tf.key)


def test_hbm_budget_bounded_throughout_and_counted(pagers):
    _, tp = pagers
    base = tp.tier_bytes()["hbm"]
    tf = TF.Frame.from_dict({f"x{j}": np.random.default_rng(j).normal(
        size=20000) for j in range(6)})
    per = tf.vecs[0]._chunk.nbytes
    s0 = tp.stats()
    tp.hbm_budget = base + per * 2 + 128
    tp.maybe_demote()
    tp.reset_peak()
    for _ in range(2):
        for v in tf.vecs:
            v.to_numpy()
            assert tp.tier_bytes()["hbm"] <= tp.hbm_budget
    s1 = tp.stats()
    assert tp.peak_hbm_bytes() <= tp.hbm_budget
    assert s1["faults_by_tier"]["host"] > s0["faults_by_tier"]["host"]
    assert s1["evictions_by_tier"]["host"] > s0["evictions_by_tier"]["host"]
    assert MANAGER.stats()["faults"] == s1["faults"]
    DKV.remove(tf.key)


def test_budgeted_ingest_is_born_cold(pagers):
    _, tp = pagers
    tp.hbm_budget = tp.tier_bytes()["hbm"] + 10**9
    tf = TF.Frame.from_dict({"a": np.arange(N, dtype=float),
                             "s": np.array(["p", "q"] * (N // 2), object)},
                            column_types={"s": "str"})
    assert tf.vecs[0]._chunk.tier == "host"
    assert tf.vec("s")._codes_chunk.tier == "host"
    assert tf.vecs[0].device.type == "cpu"          # metadata: no fault
    assert np.array_equal(tf.vec("a").to_numpy(), np.arange(N))
    assert tf.vecs[0]._chunk.tier == "hbm"
    DKV.remove(tf.key)


def test_prefetch_runs_ahead_and_its_failure_raises(pagers, monkeypatch):
    _, tp = pagers
    tf = TF.Frame.from_dict({f"x{j}": np.arange(N) * (j + 1.5)
                             for j in range(5)})
    tp.hbm_budget = 0
    for v in tf.vecs:
        tp.demote(v._chunk, TT.TIER_HOST)
    s0 = tp.stats()
    out = mrtask.map_chunked(lambda v: v.to_numpy().sum(), tf.vecs,
                             lookahead=2)
    assert out == [float((np.arange(N) * (j + 1.5)).sum()) for j in range(5)]
    s1 = tp.stats()
    assert s1["prefetch_requests"] - s0["prefetch_requests"] == 4
    assert all(v._chunk.tier == "hbm" for v in tf.vecs)
    # a prefetch that fails leaves its error for the consumer's read
    v = tf.vecs[0]
    tp.demote(v._chunk, TT.TIER_HOST)

    def broken(ch):
        raise OSError("spill read failed")
    monkeypatch.setattr(tp, "_host_planes", broken)
    tp.prefetch([v])
    for _ in range(500):                 # the worker records the error
        if v._chunk._err is not None:
            break
        time.sleep(0.01)
    with pytest.raises(RuntimeError, match="prefetch"):
        v.as_f32()
    monkeypatch.undo()
    assert v._chunk.tier == "host"
    assert np.array_equal(v.to_numpy(), np.arange(N) * 1.5)
    DKV.remove(tf.key)


def test_host_budget_spills_to_disk_and_reload_on_get(pagers):
    _, tp = pagers
    hbm0, host0 = _base(tp)
    tf = TF.Frame.from_dict({f"x{j}": np.random.default_rng(j).normal(
        size=4000) for j in range(4)})
    per = tf.vecs[0]._chunk.nbytes
    tp.hbm_budget = hbm0 + 1
    tp.host_budget = host0 + 2 * per + 1
    tp.maybe_demote()
    tiers = _tiers(tf)
    assert "disk" in tiers and "hbm" not in tiers
    tp.hbm_budget = tp.host_budget = 0
    key = tf.key
    MANAGER.spill(key)
    assert MANAGER.is_spilled(key)
    g = DKV.get(key)
    assert not MANAGER.is_spilled(key) and not MANAGER.is_hbm_resident(key)
    assert g.vec("x0").to_numpy()[0] == \
        np.float32(np.random.default_rng(0).normal(size=4000)[0])
    assert MANAGER.is_hbm_resident(key)
    DKV.remove(key)


def test_small_budget_parse_and_gbm_identical_to_unconstrained(pagers,
                                                               tmp_path):
    _, tp = pagers
    rng = np.random.default_rng(47)
    n, csv = 3000, tmp_path / "train.csv"
    cols = {f"x{j}": rng.normal(size=n) for j in range(6)}
    y = (cols["x0"] - cols["x1"] + 0.3 * rng.normal(size=n)) > 0
    with open(csv, "w") as fh:
        fh.write(",".join(cols) + ",y\n")
        for i in range(n):
            fh.write(",".join(f"{cols[c][i]:.6f}" for c in cols)
                     + f",{'yes' if y[i] else 'no'}\n")

    def parse_train():
        fr = h2o3_tpu_torch.import_file(str(csv))
        m = h2o3_tpu_torch.H2OGradientBoostingEstimator(
            ntrees=4, max_depth=3, seed=7)
        m.train(x=list(cols), y="y", training_frame=fr)
        p = m.predict(fr).vec("pyes").to_numpy()
        DKV.remove(fr.key)
        return p

    p_full = parse_train()
    base = tp.tier_bytes()["hbm"]
    tp.hbm_budget = base + n * 7 * 4 // 3
    tp.maybe_demote()
    tp.reset_peak()
    f0 = tp.stats()["faults"]
    p_tiered = parse_train()
    assert tp.stats()["faults"] > f0, "the budgeted run never paged"
    assert tp.peak_hbm_bytes() <= tp.hbm_budget
    assert np.array_equal(p_full, p_tiered)


def test_concurrent_faults_demotions_and_prefetch_keep_the_books(pagers):
    """Threads reading, demoting and prefetching the same chunks under a
    budget, with a short switch interval: every read is right, the
    budget holds, and the per-tier byte totals equal a recount of the
    live chunks afterwards (a lost update would break it). The budget
    holds 8 chunks, more than the 7 faults that can be in flight (6
    readers and the prefetch worker): with fewer, a fault that finds
    every other chunk reserved is admitted over the budget, as in the
    JAX package, so that out-of-core work always progresses."""
    import sys
    import threading
    _, tp = pagers
    hbm0 = tp.tier_bytes()["hbm"]
    cols = {f"x{j}": np.arange(N) * (j + 0.5) for j in range(16)}
    tf = TF.Frame.from_dict(cols)
    per = tf.vecs[0]._chunk.nbytes
    tp.hbm_budget = hbm0 + 8 * per
    tp.maybe_demote()
    tp.reset_peak()
    errors = []

    def reader(seed):
        rng = np.random.default_rng(seed)
        try:
            for _ in range(60):
                j = int(rng.integers(0, 16))
                got = tf.vecs[j].to_numpy()
                if not np.array_equal(got, cols[f"x{j}"]):
                    errors.append(("value", j))
                if rng.random() < 0.3:
                    tp.demote(tf.vecs[int(rng.integers(0, 16))]._chunk,
                              TT.TIER_HOST if rng.random() < 0.7
                              else TT.TIER_DISK)
                if rng.random() < 0.3:
                    mrtask.prefetch_chunks(tf.vecs[j:j + 2])
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=reader, args=(s,))
                   for s in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    for _ in range(500):                 # let the prefetch worker drain
        if tp._pf_q.empty():
            break
        time.sleep(0.01)
    time.sleep(0.2)
    assert not errors, errors[:3]
    assert tp.peak_hbm_bytes() <= tp.hbm_budget
    with tp._lock:
        tp._reap_locked()
        recount = {t: 0 for t in ("hbm", "host", "disk")}
        for c in tp._live_locked():
            for tier, has in zip(("hbm", "host", "disk"),
                                 (c._dev is not None, c._host is not None,
                                  c._path is not None)):
                recount[tier] += c.nbytes if has else 0
        assert recount == tp._bytes
    DKV.remove(tf.key)

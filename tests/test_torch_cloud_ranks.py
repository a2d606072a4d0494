"""The port's cloud of several processes on the CPU: the sharded binned GBM
over a 2-rank gloo group, and a real 2-process REST cloud
(h2o3_tpu_torch/parallel/, deploy/multihost.py, models/tree/binned.py,
models/tree/shared_tree.py, api/server.py, __main__.py).

- the sharded grower: 2 ranks, each on its own row block, train the trees
  of one process bit for bit (the histograms of each are the kernels'
  fixed-point function on every device) — f32
  and int8 histograms, multinomial and DRF with its out-of-bag metrics, at
  depth 8 with row and column sampling; both ranks hold the same model;
  at depth 5 with min_rows 100 the port's sharded grower grows the JAX
  package's sharded grower's trees on a 2-device CPU mesh, tree for tree
  (tests/test_binned_sharded.py's comparison);
- a real 2-process cloud (`python -m h2o3_tpu_torch` twice over gloo):
  /3/ParseDistributed of a CSV equals import_file's frame; /3/Frames/load,
  a GBM over REST and its predictions equal the port's one process bit
  for bit and the JAX package's one process within the tolerance of
  tests/test_torch_slice.py; the divergence sanitizer counts no mismatch
  over the run and a seeded host-divergent handler (an extension route
  writing its process id) trips it; a worker killed under a scoring load
  costs no request, a replacement joins and answers as before, and
  /3/Cloud/drain takes it out;
- a process given an unreachable coordinator raises within
  H2O3_CLOUD_FORM_TIMEOUT_S.

The module imports only the port at its top: the rank processes import it.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, C = 3000, 6


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def _rest_port():
    """A free port whose replay channel (the port + 2) is free too."""
    import socket
    while True:
        port = _free_port()
        s = socket.socket()
        try:
            s.bind(("0.0.0.0", port + 2))
            return port
        except OSError:
            continue
        finally:
            s.close()


def _data(n=N, seed=0, k=2):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, C)).astype(np.float32)
    X[rng.random((n, C)) < 0.02] = np.nan
    z = np.nan_to_num(X[:, 0]) + 0.5 * np.nan_to_num(X[:, 1]) ** 2 \
        + rng.normal(size=n)
    y = np.digitize(z, np.quantile(z, np.linspace(0, 1, k + 1)[1:-1]))
    return X, y


def _frame(X, y, lo, hi, levels):
    from h2o3_tpu_torch.core.frame import Frame, Vec
    vecs = [Vec.from_numpy(X[lo:hi, j].astype(np.float64)) for j in range(C)]
    vecs.append(Vec.from_numpy(np.asarray(levels, object)[y[lo:hi]]))
    return Frame([f"x{j}" for j in range(C)] + ["y"], vecs)


CASES = {
    "f32": dict(algo="gbm", k=2, ntrees=4, sample_rate=0.8,
                col_sample_rate=0.7),
    "int8": dict(algo="gbm", k=2, ntrees=4, sample_rate=0.8, int8_hist=True),
    "multinomial": dict(algo="gbm", k=3, ntrees=2),
    "drf": dict(algo="drf", k=2, ntrees=3),
}


def _train_case(name):
    """One case on the formed cloud: this rank's block (all rows in a
    world of one). Returns the model's trees, history and metrics."""
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.core.kvstore import DKV
    from h2o3_tpu_torch.parallel import mesh
    kw = dict(CASES[name])
    algo, k = kw.pop("algo"), kw.pop("k")
    c = mesh.cloud()
    X, y = _data(k=k)
    lo, hi = c.row_block(N)
    f = _frame(X, y, lo, hi, ["a", "b", "c"][:k])
    if c.world > 1:
        f.shard = (lo, hi, N)
    cls = h2o.H2OGradientBoostingEstimator if algo == "gbm" \
        else h2o.H2ORandomForestEstimator
    m = cls(max_depth=8, min_rows=5, nbins=64, seed=3, **kw)
    m.train(y="y", training_frame=f)
    ens = m._trees_k if getattr(m, "_trees_k", None) else [m._trees]
    out = {"trees": [[t.col.numpy(), t.thr.numpy(), t.na_left.numpy(),
                      t.value.numpy()] for t in ens],
           "history": m._output.scoring_history,
           "train": m._output.training_metrics.to_dict()}
    DKV.remove(m.key)
    DKV.remove(f.key)
    return out


def _grow_direct(X, y, spec, block):
    """The port's binned chunk trainer on `block` = (lo, hi) of the rows:
    depth 5, min_rows 100, 3 bernoulli trees."""
    from h2o3_tpu_torch.models.tree import binned as BN
    lo, hi = block
    n = hi - lo
    sharded = n != X.shape[0]
    g = BN.BinnedGrower(spec, max_depth=5, min_rows=100.0,
                        min_split_improvement=1e-5,
                        rows=BN.RowBlock(lo, n, X.shape[0]) if sharded
                        else None)
    n_pad = g.layout(n)
    codes = BN.quantize(torch.from_numpy(X[lo:hi]), spec, n_pad=n_pad)
    y1 = BN.pad_rows(torch.from_numpy(y[lo:hi].astype(np.float32)), n_pad)
    w1 = BN.pad_rows(torch.ones(n), n_pad)
    F = torch.zeros(n_pad)
    tr = BN.gbm_chunk_trainer(g, n, dist="bernoulli", eta=0.1,
                              sample_rate=1.0, mtries=0, k_trees=3)
    F2, trees = tr(codes, y1, w1, F, torch.Generator().manual_seed(0))
    return F2[:n].numpy(), [t.numpy() for t in trees]


def _rank_main(rank, world, port, q):
    import torch.distributed as dist
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.models.tree import binned as BN
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        c = h2o.init(device="cpu", rank=rank, world=world,
                     group=dist.group.WORLD)
        out = {name: _train_case(name) for name in CASES}
        X, y = _data(seed=1)
        spec = BN.make_bins(X, np.zeros(C, bool), 32)
        out["direct"] = _grow_direct(X, y.astype(np.float32), spec,
                                     c.row_block(N))
        q.put((rank, out))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks():
    """Both ranks' results of a 2-rank gloo world on the CPU."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, 2, port, q),
                         daemon=True) for r in range(2)]
    for p in procs:
        p.start()
    try:
        got = dict(q.get(timeout=240) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    return got


def _same_trees(a, b):
    return len(a) == len(b) and all(
        len(x) == len(y) and all(np.array_equal(u, v, equal_nan=True)
                                 for u, v in zip(x, y))
        for x, y in zip(a, b))


# metric values that come from float sums (models/metrics.py `sharded`):
# a world adds its ranks' f32 partials in another order than one process
SUMMED = ("logloss", "mse", "rmse", "mae", "r2", "deviance", "MSE", "RMSE",
          "MAE")
SUM_RTOL = 1e-6


def _same_metrics(a, b, key=""):
    """Equal, except that a value from a float sum may differ by SUM_RTOL
    (relative); the AUC, the counts, thresholds and gains/lift exactly."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _same_metrics(a[k], b[k], str(k)) for k in a)
    if isinstance(a, (list, tuple)):
        return isinstance(b, (list, tuple)) and len(a) == len(b) and all(
            _same_metrics(u, v, key) for u, v in zip(a, b))
    if isinstance(a, float) and any(key.endswith(s) for s in SUMMED):
        return isinstance(b, float) and (
            a == b or abs(a - b) <= SUM_RTOL * max(abs(a), abs(b)))
    return a == b or (a != a and b != b)


@pytest.mark.parametrize("name", list(CASES))
def test_two_ranks_grow_the_one_process_trees(ranks, name):
    import h2o3_tpu_torch as h2o
    h2o.init(device="cpu")
    ref = _train_case(name)
    for rank in (0, 1):
        got = ranks[rank][name]
        assert _same_trees(got["trees"], ref["trees"]), (name, rank)
        assert _same_metrics(got["history"], ref["history"]), (name, rank)
        assert _same_metrics(json.loads(json.dumps(got["train"],
                                                   default=str)),
                             json.loads(json.dumps(ref["train"],
                                                   default=str))), \
            (name, rank)
    # both ranks hold the same model, history and metrics bit for bit
    assert json.dumps(ranks[0][name], sort_keys=True, default=str) == \
        json.dumps(ranks[1][name], sort_keys=True, default=str)


def _jax_trees(X, y, spec, shards):
    """The JAX package's binned chunk trainer at _grow_direct's setting,
    on a mesh of `shards` CPU devices (1: unsharded)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    import h2o3_tpu
    from h2o3_tpu.models.tree import binned as JBN
    from h2o3_tpu.parallel import mesh as JMESH
    cl = h2o3_tpu.init(n_rows_shards=shards)
    try:
        multi = shards > 1
        g = JBN.BinnedGrower(spec, max_depth=5, min_rows=100.0,
                             min_split_improvement=1e-5,
                             axis_name=JMESH.ROWS if multi else None)
        n_pad = g.layout(N, shards=shards)
        args = [JBN.quantize(jnp.asarray(X), spec, n_pad=n_pad),
                JBN.pad_rows(jnp.asarray(y), n_pad),
                JBN.pad_rows(jnp.ones(N, jnp.float32), n_pad),
                jnp.zeros(n_pad, jnp.float32)]
        if multi:
            args = [jax.device_put(args[0], cl.sharding(P(None, JMESH.ROWS)))
                    ] + [jax.device_put(a, cl.rows_sharding(1))
                         for a in args[1:]]
        tr = JBN.gbm_chunk_trainer(g, N, dist="bernoulli", eta=0.1,
                                   sample_rate=1.0, mtries=0, k_trees=3,
                                   mesh=cl.mesh if multi else None)
        F, trees = tr(*args, jax.random.PRNGKey(0))
        return np.asarray(F)[:N], [np.asarray(t) for t in trees]
    finally:
        h2o3_tpu.init()


def test_sharded_grower_matches_the_jax_sharded_grower(ranks):
    """tests/test_binned_sharded.py's comparison, held against the port:
    the port's grower on 2 ranks grows the JAX package's trees on a
    2-device CPU mesh, tree for tree (the same column and bin at every
    node, leaf values within 1e-5). Its level sums are exact, so its NA
    directions and margins are those of the JAX package's unsharded
    trainer (whose sharded f32 sums break a near tie of an NA direction
    differently)."""
    from h2o3_tpu.models.tree import binned as JBN
    X, y = _data(seed=1)
    y = y.astype(np.float32)
    spec = JBN.make_bins(X, np.zeros(C, bool), 32)
    jF2, jt2 = _jax_trees(X, y, spec, 2)
    jF1, jt1 = _jax_trees(X, y, spec, 1)
    F0, t0 = ranks[0]["direct"]
    F1, t1 = ranks[1]["direct"]
    assert all(np.array_equal(a, b) for a, b in zip(t0, t1))
    pF = np.concatenate([F0, F1])
    for jt in (jt2, jt1):
        assert np.array_equal(t0[0], jt[0])              # columns
        assert np.array_equal(t0[1], jt[1])              # bins
        np.testing.assert_allclose(t0[4], jt[4], rtol=1e-5, atol=1e-6)
    assert np.array_equal(t0[2], jt1[2])                 # NA directions
    np.testing.assert_allclose(pF, jF1, rtol=1e-5, atol=1e-6)
    # and the port's 2 ranks = its one process, bit for bit
    import h2o3_tpu_torch as h2o
    h2o.init(device="cpu")
    rF, rt = _grow_direct(X, y, spec, (0, N))
    assert np.array_equal(pF, rF)
    assert all(np.array_equal(a, b) for a, b in zip(t0, rt))


# ---------------------------------------------------------------------------
# a real 2-process cloud over REST
_EXT = '''
import os
from h2o3_tpu_torch.core.kvstore import DKV
from h2o3_tpu_torch.ext import H2OExtension, register_extension


def _h_seed(h):
    # the process id: a host-divergent value reaching replicated state
    DKV.put("cloud_div_seed", {"pid": os.getpid()})
    h._send({"ok": True})


register_extension(H2OExtension(
    name="cloud_div_seed", routes=[(r"/3/CloudDivSeed", "POST", _h_seed)]))
'''


def _http(port, method, path, data=None):
    body = None if data is None else urllib.parse.urlencode(
        {k: (json.dumps(v) if isinstance(v, (list, dict)) else str(v))
         for k, v in data.items()}).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=body, method=method)
    if body is not None:
        req.add_header("Content-Type", "application/x-www-form-urlencoded")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            raw = r.read()
            st = r.status
    except urllib.error.HTTPError as e:
        raw, st = e.read(), e.code
    try:
        return st, json.loads(raw)
    except ValueError:
        return st, raw


def _job(port, key):
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        st, js = _http(port, "GET", f"/3/Jobs/{key}")
        j = js["jobs"][0]
        if j["status"] in ("DONE", "FAILED", "CANCELLED"):
            assert j["status"] == "DONE", j
            return j
        time.sleep(0.05)
    raise AssertionError(f"job {key} did not finish")


def _series(text, name):
    for line in text.splitlines():
        if line.startswith(name + " ") or line.startswith(name + "{"):
            return float(line.rsplit(" ", 1)[1])
    return 0.0


def _start(env, pid, rest, log, join=False):
    e = dict(env, H2O3_PROCESS_ID=str(pid))
    if join:
        e["H2O3_JOIN_CLOUD"] = "1"
    return subprocess.Popen(
        [sys.executable, "-m", "h2o3_tpu_torch", "-port", str(rest)],
        env=e, stdout=open(log, "w"), stderr=subprocess.STDOUT)


@pytest.fixture()
def rest_cloud(tmp_path):
    """Two `python -m h2o3_tpu_torch` processes on the CPU over gloo; the
    divergence sanitizer raising; yields (rest port, env, processes)."""
    (tmp_path / "cloud_div_ext.py").write_text(_EXT)
    rest, store = _rest_port(), _free_port()
    env = dict(os.environ, H2O3_COORDINATOR_ADDRESS=f"127.0.0.1:{store}",
               H2O3_NUM_PROCESSES="2", H2O3_CLUSTER_SECRET="cloud-secret",
               H2O3_DEVICE="cpu", H2O3_INSECURE_BIND_ALL="1",
               H2O3_DIVERGENCE="1", H2O3_HEARTBEAT_S="0",
               H2O3_TPU_EXTENSIONS="cloud_div_ext",
               H2O3_CLOUD_FORM_TIMEOUT_S="180",
               PYTHONPATH=os.pathsep.join([ROOT, str(tmp_path)]),
               OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    procs = [_start(env, r, rest, tmp_path / f"p{r}.log") for r in range(2)]
    try:
        deadline = time.monotonic() + 180
        while True:
            try:
                st, js = _http(rest, "GET", "/3/Cloud")
                if st == 200:
                    break
            except OSError:
                pass
            assert time.monotonic() < deadline, \
                (tmp_path / "p0.log").read_text()[-2000:]
            time.sleep(0.2)
        yield rest, env, procs, tmp_path
    finally:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for p in procs:
            try:
                p.wait(15)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(5)


def test_rest_cloud_equals_one_process(rest_cloud):
    import h2o3_tpu
    import h2o3_tpu_torch as h2o
    import test_torch_slice as TS
    from h2o3_tpu_torch.core.kvstore import DKV
    from h2o3_tpu_torch.io.persist import export_frame, import_frame
    rest, env, procs, tmp = rest_cloud
    h2o.init(device="cpu")
    st, cl = _http(rest, "GET", "/3/Cloud")
    assert cl["cloud_size"] == 2 and cl["epoch"] == 1 \
        and cl["locked"] is False
    assert [w["state"] for w in cl["workers"]] == ["active"]
    # /3/ParseDistributed of test_torch_slice's CSV: the coordinator's
    # frame = import_file's, bit for bit
    csv = str(TS._write_csv(tmp / "train.csv"))
    st, p = _http(rest, "POST", "/3/ParseDistributed",
                  {"source_frames": [csv], "destination_frame": "pd.hex"})
    assert st == 200, p
    _job(rest, p["job"]["key"])
    st, sv = _http(rest, "POST", "/3/Frames/pd.hex/save",
                   {"dir": str(tmp)})
    assert st == 200, sv
    pd_frame = import_frame(str(tmp / "pd.hex.h2o3frame"), key="pd_back")
    f = h2o.import_file(csv)
    assert pd_frame.names == f.names and pd_frame.types == f.types
    for va, vb in zip(pd_frame.vecs, f.vecs):
        assert va.levels() == vb.levels()
        assert torch.equal(va.as_f32().view(torch.int32),
                           vb.as_f32().view(torch.int32))
    # /3/Frames/load (each rank keeps its block), the GBM over REST, its
    # predictions: the port's one process bit for bit
    export_frame(f, str(tmp / "train.h2o3frame"))
    st, ld = _http(rest, "POST", "/3/Frames/load",
                   {"dir": str(tmp), "frame_id": "train"})
    assert st == 200, ld
    st, b = _http(rest, "POST", "/3/ModelBuilders/gbm",
                  dict(TS.GBM, training_frame="train",
                       response_column="label", model_id="cloud_gbm"))
    assert st == 200, b
    _job(rest, b["job"]["key"])
    st, pr = _http(rest, "POST",
                   "/3/Predictions/models/cloud_gbm/frames/train",
                   {"predictions_frame": "cloud_pred"})
    assert st == 200, pr
    st, sv = _http(rest, "POST", "/3/Frames/cloud_pred/save",
                   {"dir": str(tmp)})
    assert st == 200, sv
    got = import_frame(str(tmp / "cloud_pred.h2o3frame"), key="cp_back")
    ref = h2o.H2OGradientBoostingEstimator(**TS.GBM)
    ref.train(y="label", training_frame=f)
    want = ref.predict(f)
    assert got.names == want.names
    for va, vb in zip(got.vecs, want.vecs):
        assert torch.equal(va.as_f32().view(torch.int32),
                           vb.as_f32().view(torch.int32))
    assert pr["model_metrics"][0]["auc"] == ref.model_performance(f).auc
    # the JAX package's one process, at test_torch_slice's tolerance
    jref = TS._jax_reference(h2o3_tpu.import_file(csv))
    np.testing.assert_allclose(got.vec("pyes").as_f32().numpy(),
                               jref["p1"], atol=1e-4)
    for k in (pd_frame.key, f.key, got.key, want.key, ref.key):
        DKV.remove(k)
    # divergence: every replayed request compared, none diverged; then a
    # host-divergent handler trips it (raise mode: the NEXT request 500s)
    st, text = _http(rest, "GET", "/metrics")
    text = text.decode()
    assert _series(text, "h2o3_divergence_checks_total") >= 8
    assert _series(text, "h2o3_divergence_mismatches_total") == 0
    st, _ = _http(rest, "POST", "/3/CloudDivSeed", {})
    assert st == 200
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline:
        st, text = _http(rest, "GET", "/metrics")
        if _series(text.decode(), "h2o3_divergence_mismatches_total") >= 1:
            break
        time.sleep(0.1)
    st, err = _http(rest, "GET", "/3/Cloud")
    assert st == 500 and b"cloud_div_seed" in json.dumps(err).encode()


def test_rest_cloud_kill_replace_drain(rest_cloud):
    """A worker killed under a scoring load: excised, the epoch up, no
    request failed; a replacement joins, syncs the snapshot and answers
    every request as the coordinator does (the sanitizer's answer
    digests); /3/Cloud/drain takes it out cleanly."""
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.core.kvstore import DKV
    from h2o3_tpu_torch.io.persist import export_frame
    rest, env, procs, tmp = rest_cloud
    h2o.init(device="cpu")
    X, y = _data(n=2000, seed=6)
    f = _frame(X, y, 0, len(y), ["a", "b"])
    export_frame(f, str(tmp / "kr.h2o3frame"))
    DKV.remove(f.key)
    assert _http(rest, "POST", "/3/Frames/load",
                 {"dir": str(tmp), "frame_id": "kr"})[0] == 200
    st, b = _http(rest, "POST", "/3/ModelBuilders/gbm",
                  dict(ntrees=3, max_depth=5, nbins=32, seed=1,
                       training_frame="kr", response_column="y",
                       model_id="kr_gbm"))
    _job(rest, b["job"]["key"])
    rows = [{f"x{j}": float(np.nan_to_num(X[i, j])) for j in range(C)}
            for i in range(64)]
    fails, oks, stop = [], [0], [False]

    def client(k):
        i = 0
        while not stop[0]:
            r = rows[(7 * k + i) % 60: (7 * k + i) % 60 + 1 + i % 4]
            i += 1
            st, js = _http(rest, "POST", "/3/Predictions/models/kr_gbm",
                           {"rows": r})
            if st == 200 and len(js["predictions"]) == len(r):
                oks[0] += 1
            else:
                fails.append((st, str(js)[:200]))

    ts = [threading.Thread(target=client, args=(k,)) for k in range(6)]
    for t in ts:
        t.start()
    try:
        time.sleep(0.5)
        procs[1].kill()
        deadline = time.monotonic() + 10
        while _http(rest, "GET", "/3/Cloud")[1]["epoch"] < 2:
            assert time.monotonic() < deadline
            time.sleep(0.05)
        time.sleep(0.3)
        n_before = oks[0]
        procs.append(_start(env, 1, rest, tmp / "p2.log", join=True))
        deadline = time.monotonic() + 60
        while _http(rest, "GET", "/3/Cloud")[1]["epoch"] < 3:
            assert time.monotonic() < deadline, \
                (tmp / "p2.log").read_text()[-2000:]
            time.sleep(0.1)
        time.sleep(1.0)
    finally:
        stop[0] = True
        for t in ts:
            t.join(timeout=60)
    assert not fails, fails[:3]
    assert n_before > 0 and oks[0] > n_before
    st, cl = _http(rest, "GET", "/3/Cloud")
    assert [(w["pid"], w["state"]) for w in cl["workers"]] == \
        [(1, "active")] and cl["cloud_healthy"] is True
    st, text = _http(rest, "GET", "/metrics")
    text = text.decode()
    assert _series(text, "h2o3_divergence_mismatches_total") == 0
    assert _series(text, "h2o3_cloud_joins_total") == 1
    st, dr = _http(rest, "POST", "/3/Cloud/drain", {"node": 1})
    assert st == 200 and dr["left_cleanly"] is True and dr["epoch"] == 4
    assert procs[2].wait(30) == 0


def test_unreachable_coordinator_raises_within_the_form_timeout():
    port = _free_port()
    env = dict(os.environ, H2O3_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
               H2O3_NUM_PROCESSES="2", H2O3_PROCESS_ID="1",
               H2O3_CLUSTER_SECRET="s", H2O3_DEVICE="cpu",
               H2O3_CLOUD_FORM_TIMEOUT_S="3", PYTHONPATH=ROOT)
    t0 = time.monotonic()
    r = subprocess.run([sys.executable, "-m", "h2o3_tpu_torch", "-port",
                        str(_free_port())], env=env, capture_output=True,
                       text=True, timeout=120)
    took = time.monotonic() - t0
    assert r.returncode != 0
    assert "H2O3_CLOUD_FORM_TIMEOUT_S" in r.stderr, r.stderr[-2000:]
    assert took < 30

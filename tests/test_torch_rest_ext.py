"""Every handler of the port's `api/routes_ext*.py` and `api/flow.py`
against the JAX package's, on the CPU: one parametrised test over a table
of (method, path, params) cases, each sent to the JAX `H2OServer(port=0)`
and to the port's (after `h2o3_tpu_torch.init(device="cpu")`) in this
one process. The cases run in the table's order; a case may first send
set-up requests of its own.

Each case compares the status, `__meta.schema_type` and the keys of the
answer, and the values where they are deterministic ("all": every value,
the volatile ones of VOLATILE dropped; a check function where a value is
a float: its tolerance is stated there). The data: a CSV made from a seed
with numpy, 600 rows of six numeric columns, one categorical of four
levels and a binary response; a GBM (3 trees, depth 3, min_rows 50) and a
binomial GLM trained on it in each package.

The deliberate differences, named in the table (`differs=`):
  cloud_size 1 against 8 (/3/Cloud, /3/steam/instances, /3/SteamMetrics,
  /99/Sample); /3/About's backend (torch for jax); the padding's bytes (/3/Frames/{id}/light counts the
  unpadded rows, /3/FrameChunks one chunk); the Capabilities entry of the
  backend (CUDA for TPU); NetworkTest (a device reduction, no collective)
  and GarbageCollect (the card's allocated bytes for jax.live_arrays());
  the product name in the 501 texts and in Flow's HTML.
"""

import gc
import io
import os
import re
import urllib.parse
import zipfile

import numpy as np
import pytest

import h2o3_tpu
import h2o3_tpu_torch
from h2o3_tpu.api import server as JS
from h2o3_tpu_torch.api import server as TS
from h2o3_tpu_torch.obs import watchdog as TWD

from test_torch_rest import jax_extension_parts, req, wait_job, write_csv

NROWS = 600
# values that change from call to call (clocks, counters, host paths)
VOLATILE = {"cloud_uptime_millis", "timestamp_millis", "micros", "msec",
            "phases", "key", "seconds", "stacktrace", "timestamp",
            "cpu_ticks", "persist_stats", "job", "dir", "path", "files",
            "destination_frames", "nodes", "threads", "traces"}


def _strip(o, drop=VOLATILE):
    if isinstance(o, dict):
        return {k: _strip(v, drop) for k, v in o.items() if k not in drop}
    if isinstance(o, list):
        return [_strip(v, drop) for v in o]
    return o


def _frames_close(jname, tname, rtol=1e-6, atol=1e-6):
    fa = h2o3_tpu.get_frame(jname)
    fb = h2o3_tpu_torch.get_frame(tname)
    assert fa.names == fb.names
    assert fa.nrows == fb.nrows
    for c in fa.names:
        va, vb = fa.vec(c), fb.vec(c)
        assert va.type == vb.type, c
        if va.type in ("enum", "str"):
            assert list(va.levels() or []) == list(vb.levels() or []), c
        a = np.asarray(va.to_numpy()[:fa.nrows], float) \
            if va.type != "str" else va.to_numpy()
        b = np.asarray(vb.to_numpy(), float) \
            if vb.type != "str" else vb.to_numpy()
        if va.type == "str":
            assert list(a) == list(b), c
        else:
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                                       err_msg=c)


class C:
    """One case. `path`, `data` and `body` may be functions of the side
    ("j" or "t") and the context; `setup` is a list of (method, path,
    kwargs) sent first; `check(a, b, ctx)` compares the two JSON bodies
    beyond status, schema type and keys; `values="all"` compares every
    value but VOLATILE ones."""

    def __init__(self, cid, method, path, data=None, body=None, raw=None,
                 headers=None, setup=(), values="all", check=None,
                 differs=None, keys=True, jax=True):
        self.id, self.method, self.path = cid, method, path
        self.data, self.body, self.raw = data, body, raw
        self.headers, self.setup = headers, setup
        self.values, self.check, self.differs = values, check, differs
        self.keys, self.jax = keys, jax


def _v(x, side, ctx):
    return x(side, ctx) if callable(x) else x


def _send(ctx, side, case):
    port = ctx[side]
    for m, p, kw in case.setup:
        kw = {k: _v(v, side, ctx) for k, v in kw.items()}
        st, _, js = req(port, m, _v(p, side, ctx), **kw)
        assert st == 200, (case.id, p, js)
        if isinstance(js, dict) and isinstance(js.get("job"), dict):
            wait_job(port, js["job"]["key"])
    kw = {}
    if case.data is not None:
        kw["data"] = _v(case.data, side, ctx)
    if case.body is not None:
        kw["body"] = _v(case.body, side, ctx)
    if case.raw is not None:
        kw["body"] = _v(case.raw, side, ctx)
    if case.headers is not None:
        kw["headers"] = case.headers
    st, h, js = req(port, case.method, _v(case.path, side, ctx), **kw)
    if isinstance(js, dict) and isinstance(js.get("job"), dict) \
            and js["job"].get("key"):
        j = wait_job(port, js["job"]["key"])
        assert j["status"] == "DONE", (case.id, j)
    return st, h, js


# ---------------------------------------------------------------------------
# checks
def _approx_tree(a, b, ctx):
    for k in ("left_children", "right_children", "features", "nas"):
        assert a[k] == b[k], k
    np.testing.assert_allclose(a["thresholds"], b["thresholds"], atol=1e-5)
    np.testing.assert_allclose(a["predictions"], b["predictions"],
                               atol=1e-5)


def _close(a, b, tol, path="$"):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _close(a[k], b[k], tol, f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, tol, f"{path}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        if a is None or b is None:
            assert a == b, path
        elif np.isnan(a):
            assert np.isnan(b), path
        else:
            assert abs(a - b) <= tol * max(1.0, abs(a)), (path, a, b)
    else:
        assert a == b, (path, a, b)


def _frame_result(jkey, tkey=None, rtol=1e-6, atol=1e-6):
    def check(a, b, ctx):
        _frames_close(jkey, tkey or jkey, rtol=rtol, atol=atol)
    return check


def _same_names_of(listkey, namekey):
    """The same names of this file's keys; a generated key (prefix_NNNN,
    minted from each store's own counter) counts only."""
    def check(a, b, ctx):
        def names(d):
            ns = [x[namekey]["name"] for x in d[listkey]
                  if x[namekey]["name"] not in ctx["before"]]
            return (sorted(n for n in ns if not re.search(r"_\d{4}$", n)),
                    sum(1 for n in ns if re.search(r"_\d{4}$", n)))
        assert names(a) == names(b)
    return check


def _job_key(side, ctx):
    port = ctx[side]
    _, _, js = req(port, "GET", "/3/Jobs")
    return sorted(j["key"] for j in js["jobs"])[0]


def _upload_csv(side, ctx):
    return b"a,b\n1,x\n2,y\n3,x\n"


def _gbm_bin(side, ctx):
    _, _, raw = req(ctx[side], "GET", "/3/Models.fetch.bin/ext_gbm")
    return raw


def _retained(side, ctx):
    keys = (h2o3_tpu.ls() if side == "j" else h2o3_tpu_torch.ls())
    return [k for k in keys if k != "dkv_gone"]


def _flow_same(a, b, ctx):
    assert b.replace(b"h2o3-tpu-torch", b"h2o3-tpu") == a


def _zip_names(a, b, ctx):
    za = zipfile.ZipFile(io.BytesIO(a))
    zb = zipfile.ZipFile(io.BytesIO(b))
    assert za.namelist() and zb.namelist()


def _nps_value(a, b, ctx):
    assert a["value"] == b["value"] == "clip-1"


def _metrics_maker(a, b, ctx):
    ma, mb = a["model_metrics"][0], b["model_metrics"][0]
    for k in ("auc", "logloss", "MSE"):
        if k in ma:
            assert ma[k] == pytest.approx(mb[k], abs=1e-5), k


def _tabulate(a, b, ctx):
    _close(_strip(a), _strip(b), 1e-6)


def _fairness(a, b, ctx):
    assert a["reference_group"] == b["reference_group"]
    _close(a["groups"], b["groups"], 1e-6)


def _h_stat(a, b, ctx):
    assert a["h"] == pytest.approx(b["h"], abs=1e-4)


def _varimp(a, b, ctx):
    va = sorted(r["variable"] for r in a["varimp"])
    vb = sorted(r["variable"] for r in b["varimp"])
    assert va == vb


def _rapids_help(a, b, ctx):
    from h2o3_tpu import ext as JEXT
    ext = {p for e in JEXT.extensions() for p in e.rapids}
    syntax = [p for p in a["syntax"] if p not in ext]
    assert syntax == b["syntax"] and len(syntax) == b["n_prims"]


def _endpoints_v4(a, b, ctx):
    ext_routes, _ = jax_extension_parts()
    ext = {f"{m} {p}" for p, m in ext_routes}
    assert [e for e in a["endpoints"] if e["url"] not in ext] == \
        b["endpoints"]


def _models_info(a, b, ctx):
    _, ext_algos = jax_extension_parts()
    assert [m for m in a["models"] if m["algo"] not in ext_algos] == \
        b["models"]


def _gram(a, b, ctx):
    _frames_close(a["destination_frame"]["name"],
                  b["destination_frame"]["name"], rtol=1e-5, atol=1e-3)


def _dct(a, b, ctx):
    _frames_close(a["dest"]["name"], b["dest"]["name"], rtol=1e-5,
                  atol=1e-5)


def _feature_interaction(a, b, ctx):
    fa = {r["feature_pair"]: r["fscore"] for r in a["feature_interaction"]}
    fb = {r["feature_pair"]: r["fscore"] for r in b["feature_interaction"]}
    assert fa == fb


def _model_json(a, b, ctx):
    ka = set(a["models"][0])
    kb = set(b["models"][0])
    assert ka == kb


def _pdp(a, b, ctx):
    _close(a["partial_dependence_data"], b["partial_dependence_data"],
           1e-5)


def _te(a, b, ctx):
    _frames_close(a["name"], b["name"], rtol=1e-5, atol=1e-5)


def _light(a, b, ctx):
    fa, fb = a["frames"][0], b["frames"][0]
    padded = h2o3_tpu.get_frame("ext.hex").padded_len
    assert fa["byte_size"] == padded * 4 * fa["columns"]
    assert fb["byte_size"] == NROWS * 4 * fb["columns"]
    assert _strip(fa, {"byte_size"}) == _strip(fb, {"byte_size"})


def _chunks(a, b, ctx):
    assert sum(c["row_count"] for c in a["chunks"]) == NROWS
    assert len(a["chunks"]) == 8
    assert b["chunks"] == [{"chunk_id": 0, "node_idx": 0,
                            "row_count": NROWS}]


def _capabilities(a, b, ctx):
    assert a["capabilities"][:-1] == b["capabilities"][:-1]
    assert (a["capabilities"][-1]["name"],
            b["capabilities"][-1]["name"]) == ("TPU", "CUDA")


def _network(a, b, ctx):
    assert (a["nodes"], b["nodes"]) == (8, 1)
    assert [r["bytes"] for r in a["results"]] == \
        [r["bytes"] for r in b["results"]]
    assert {r["collective"] for r in b["results"]} == {"none"}
    assert all(r["micros"] >= 0 for r in b["results"])


def _gc(a, b, ctx):
    assert "live_device_arrays" in a
    assert b["device_bytes_before"] is None      # a CPU cloud
    assert b["device_bytes_after"] is None


def _steam(a, b, ctx):
    assert (a["instances"][0]["size"], b["instances"][0]["size"]) == (8, 1)


def _steam_metrics(a, b, ctx):
    assert (a["cluster_size"], b["cluster_size"]) == (8, 1)


def _sample(a, b, ctx):
    assert (a["cloud_size"], b["cloud_size"]) == (8, 1)


def _cloud(a, b, ctx):
    assert (a["cloud_size"], b["cloud_size"]) == (8, 1)
    assert b["nodes"] == [{"h2o": "cpu", "healthy": True}]
    assert _strip(a, {"cloud_size", "nodes", "cloud_name"}) == \
        _strip(b, {"cloud_size", "nodes", "cloud_name"})


def _about(a, b, ctx):
    ja = {e["name"]: e["value"] for e in a["entries"]}
    tb = {e["name"]: e["value"] for e in b["entries"]}
    assert ja == {"Build version": "0.5.0", "Backend": "jax/tpu"}
    assert tb == {"Build version": "0.5.0", "Backend": "torch/cpu",
                  "Device": "cpu"}


def _summary(a, b, ctx):
    _close(_strip(a), _strip(b), 1e-6)


def _svm(a, b, ctx):
    _frames_close("svm1", "svm1")


def _split(a, b, ctx):
    assert a == b
    for d in ("sp_a", "sp_b"):
        _frames_close(d, d)


def _dedup(src, cols, keep, dest):
    """The rows pandas' drop_duplicates keeps (NAs equal, row order),
    from the JAX frame, against the port's answer."""
    def check(a, b, ctx):
        f = h2o3_tpu.get_frame(src)
        vals = {}
        for c in f.names:
            v = f.vec(c)
            x = np.asarray(v.to_numpy()[:f.nrows], float)
            if v.type == "enum":
                dom = v.levels()
                x = np.asarray([None if u != u else dom[int(u)] for u in x],
                               object)
            vals[c] = x
        order = range(f.nrows) if keep == "first" \
            else range(f.nrows - 1, -1, -1)
        seen = {}
        for i in order:
            k = tuple(None if (isinstance(vals[c][i], float)
                               and vals[c][i] != vals[c][i])
                      else vals[c][i] for c in cols)
            seen.setdefault(k, i)
        idx = sorted(seen.values())
        out = h2o3_tpu_torch.get_frame(dest)
        assert b["rows"] == out.nrows == len(idx)
        for c in f.names:
            v = out.vec(c)
            got = np.asarray(v.to_numpy(), float)
            if v.type == "enum":
                dom = v.levels()
                got = [None if u != u else dom[int(u)] for u in got]
                assert got == list(vals[c][idx]), c
            else:
                np.testing.assert_array_equal(got, vals[c][idx], c)
    return check


def _reg_path(a, b, ctx):
    assert a["lambdas"] == b["lambdas"]
    assert [n for n in a["coefficient_names"] if n != "color.blue"] == \
        b["coefficient_names"]
    assert len(a["coefficients"]) == len(b["coefficients"])
    # the same fit in another basis: the numeric columns' coefficients
    ja = dict(zip(a["coefficient_names"], a["coefficients"][0]))
    tb = dict(zip(b["coefficient_names"], b["coefficients"][0]))
    for c in ("x0", "x1", "x2", "x3", "x4", "x5"):
        assert ja[c] == pytest.approx(tb[c], abs=1e-3), c


def _dkv_gone(a, b, ctx):
    assert "dkv_gone" not in h2o3_tpu.ls()
    assert "dkv_gone" not in h2o3_tpu_torch.ls()
    assert "ext.hex" in h2o3_tpu.ls() and "ext.hex" in h2o3_tpu_torch.ls()


def _no_models():
    from h2o3_tpu_torch.models.model import ModelBase
    assert not any(isinstance(h2o3_tpu_torch.get_model(k), ModelBase)
                   for k in h2o3_tpu_torch.ls())


def _no_frames():
    assert not any(isinstance(h2o3_tpu_torch.get_frame(k),
                              h2o3_tpu_torch.Frame)
                   for k in h2o3_tpu_torch.ls())


J_LAMBDA = {"lambda_": 0, "family": "binomial"}
CASES = [
    # ---- two core routes whose answers differ by design
    C("cloud", "GET", "/3/Cloud", values=None, check=_cloud,
      differs="cloud_size 1 against 8, the devices' names"),
    C("about", "GET", "/3/About", values=None, check=_about,
      differs="the backend torch/cpu for jax/tpu, the device"),
    # ---- routes_ext: diagnostics
    C("ping", "GET", "/3/Ping"),
    C("capabilities", "GET", "/3/Capabilities", values=None,
      check=_capabilities, differs="backend entry"),
    C("capabilities_core", "GET", "/3/Capabilities/Core"),
    C("network_test", "GET", "/3/NetworkTest", values=None, keys=False,
      check=_network, differs="no collective on one device"),
    C("water_meter_ticks", "GET", "/3/WaterMeterCpuTicks/0"),
    C("water_meter_pct", "GET", "/3/WaterMeter/percentiles"),
    C("log_and_echo", "POST", "/3/LogAndEcho", data={"message": "hi"}),
    C("gc", "POST", "/3/GarbageCollect", data={}, values=None, keys=False,
      check=_gc, differs="device bytes for live arrays"),
    C("unlock_get", "GET", "/3/UnlockKeys"),
    C("unlock_post", "POST", "/3/UnlockKeys", data={}),
    C("dkv_remove", "DELETE", "/3/DKV/dkv_gone",
      setup=[("POST", "/99/Rapids",
              {"data": {"ast": "(tmp= dkv_gone (cols ext.hex [0]))"}})]),
    C("typeahead99", "GET", lambda s, c: "/99/Typeahead/files?src="
      + c["tmp"] + "/"),
    C("typeahead3", "GET", lambda s, c: "/3/Typeahead/files?src="
      + c["tmp"] + "/t"),
    C("sessions_post", "POST", "/4/sessions", data={}),
    C("sessions_delete", "DELETE", "/4/sessions/_sid1"),
    # ---- frame munging
    C("create_frame", "POST", "/3/CreateFrame",
      data={"rows": 50, "cols": 6, "seed": 3, "dest": "cf1",
            "categorical_fraction": 0.2, "missing_fraction": 0.1},
      check=_frame_result("cf1")),
    C("split_frame", "POST", "/3/SplitFrame",
      data={"dataset": "ext.hex", "ratios": [0.7],
            "destination_frames": ["sp_a", "sp_b"], "seed": 1},
      values=None, check=_split),
    C("interaction", "POST", "/3/Interaction",
      data={"source_frame": "ext.hex", "factor_columns": ["color", "y"],
            "dest": "inter1"}, check=_frame_result("inter1")),
    C("missing_inserter", "POST", "/3/MissingInserter",
      setup=[("POST", "/99/Rapids",
              {"data": {"ast": "(tmp= mi1 (cols ext.hex [0 1 6]))"}})],
      data={"dataset": "mi1", "fraction": 0.2, "seed": 1},
      check=_frame_result("mi1")),
    C("download_dataset", "GET", "/3/DownloadDataset?frame_id=cf1",
      values=None, keys=False,
      check=lambda a, b, c: _frames_close("cf1", "cf1")),
    C("download_dataset_bin", "GET", "/3/DownloadDataset.bin?frame_id=sp_b",
      values=None, keys=False),
    C("frame_summary", "GET", "/3/Frames/ext.hex/summary", values=None,
      check=_summary),
    C("frame_columns", "GET", "/3/Frames/ext.hex/columns"),
    C("frame_col_summary", "GET", "/3/Frames/ext.hex/columns/x0/summary",
      values=None, check=_summary),
    C("frame_export", "POST", "/3/Frames/cf1/export",
      data=lambda s, c: {"path": os.path.join(c["tmp"], s, "cf1.csv")}),
    # ---- builders
    C("builder_info", "GET", "/3/ModelBuilders/gbm"),
    C("validate_params", "POST", "/3/ModelBuilders/gbm/parameters",
      data={"training_frame": "ext.hex", "ntrees": "abc", "bogus": "1",
            "max_depth": "3"}),
    # ---- artifacts
    C("model_mojo", "GET", "/3/Models/ext_gbm/mojo", values=None,
      keys=False, check=_zip_names),
    C("model_pojo", "GET", "/3/Models.java/ext_gbm", values=None,
      keys=False),
    C("model_save_bin", "POST", "/99/Models.bin/ext_gbm",
      data=lambda s, c: {"dir": os.path.join(c["tmp"], s)}),
    C("model_load_bin", "POST", "/99/Models.bin",
      data=lambda s, c: {"dir": os.path.join(c["tmp"], s, "ext_gbm")}),
    C("tree", "GET", "/3/Tree?model=ext_gbm&tree_number=1", values=None,
      check=_approx_tree),
    C("pdp_build", "POST", "/3/PartialDependence",
      data={"model_id": "ext_gbm", "frame_id": "ext.hex", "cols": ["x0"],
            "nbins": 5, "destination_key": "pdp1"}),
    C("pdp_build_slash", "POST", "/3/PartialDependence/",
      data={"model_id": "ext_gbm", "frame_id": "ext.hex", "cols": ["x1"],
            "nbins": 4, "destination_key": "pdp2"}),
    C("pdp_fetch", "GET", "/3/PartialDependence/pdp1", values=None,
      check=_pdp),
    C("w2v_synonyms", "POST", "/3/Word2VecSynonyms",
      data={"model": "no_w2v", "word": "a"}),
    C("w2v_synonyms_get", "GET", "/3/Word2VecSynonyms?model=no_w2v"),
    C("w2v_transform", "POST", "/3/Word2VecTransform",
      data={"model": "no_w2v", "words_frame": "ext.hex"}),
    C("w2v_transform_get", "GET", "/3/Word2VecTransform?model=no_w2v"),
    C("compute_gram", "POST", "/3/ComputeGram",
      data={"X": "ext.hex", "destination_frame": "gram1"}, values=None,
      check=_gram),
    C("compute_gram_get", "GET", "/3/ComputeGram?X=sp_b", values=None,
      check=_gram),
    C("grid_build", "POST", "/99/Grid/glm",
      data={"training_frame": "ext.hex", "response_column": "y",
            "hyper_parameters": {"standardize": [True, False]},
            "grid_id": "g1", "family": "binomial", "lambda_": 0}),
    C("recovery_resume", "POST", "/99/Recovery/resume",
      data={"recovery_dir": "/nonexistent/recovery"}),
    C("recovery_resume3", "POST", "/3/Recovery/resume",
      data={"recovery_dir": "/nonexistent/recovery"}),
    C("import_sql", "POST", "/86/ImportSQLTable", data={}, values=None,
      differs="the runtime's name in the text"),
    C("import_sql_99", "POST", "/99/ImportSQLTable", data={}, values=None,
      differs="the runtime's name in the text"),
    C("parse_svmlight", "POST", "/3/ParseSvmLight",
      data=lambda s, c: {"source_frames": c["svm"],
                         "destination_frame": "svm1"},
      values=None, check=_svm),
    C("parse_svmlight_caps", "POST", "/3/ParseSVMLight",
      data=lambda s, c: {"source_frames": c["svm"],
                         "destination_frame": "svm2"},
      values=None),
    C("model_metrics_list", "GET", "/3/ModelMetrics", values=None,
      check=lambda a, b, c: _close(
          sorted([m["model"]["name"], m["auc"]] for m in a["model_metrics"]
                 if m["model"]["name"] not in c["before"]),
          sorted([m["model"]["name"], m["auc"]] for m in b["model_metrics"]
                 if m["model"]["name"] not in c["before"]),
          1e-5)),
    # ---- routes_ext2
    C("frame_light", "GET", "/3/Frames/ext.hex/light", values=None,
      check=_light, differs="unpadded rows"),
    C("frame_col_domain", "GET", "/3/Frames/ext.hex/columns/color/domain"),
    C("frame_chunks", "GET", "/3/FrameChunks/ext.hex", values=None,
      check=_chunks, differs="one chunk on one device"),
    C("rebalance", "POST", "/3/Rebalance",
      data={"dataset": "ext.hex", "dest": "rb1"},
      check=_frame_result("rb1")),
    C("find_enum", "GET", "/3/Find?key=ext.hex&column=color&match=blue"),
    C("find_num", "GET", "/3/Find?key=cf1&column=C1&row=3"),
    C("job_cancel", "POST", lambda s, c: f"/3/Jobs/{_job_key(s, c)}/cancel",
      data={}, values=None),
    C("make_glm_model", "POST", "/3/MakeGLMModel",
      data={"model": "ext_glm", "names": ["x0", "x1"], "beta": [0.5, -0.2],
            "dest": "glm_custom"}),
    C("glm_reg_path", "GET", "/3/GetGLMRegPath?model=ext_glm",
      values=None, check=_reg_path,
      differs="the reduced one-hot design drops color's first level"),
    C("data_info_frame", "POST", "/99/DataInfoFrame",
      data={"frame": "ext.hex", "response_column": "y", "dest": "dif1"},
      check=_frame_result("dif1")),
    C("data_info_frame3", "POST", "/3/DataInfoFrame",
      data={"frame": "ext.hex", "response_column": "y", "dest": "dif2",
            "standardize": "true"},
      check=_frame_result("dif2", rtol=1e-5, atol=1e-5)),
    C("mojo_export", "POST", "/99/Models.mojo/ext_gbm",
      data=lambda s, c: {"dir": os.path.join(c["tmp"], s)}),
    C("mojo_alias", "GET", "/3/Models.mojo/ext_gbm", values=None,
      keys=False, check=_zip_names),
    C("mojo_99_get", "GET", "/99/Models.mojo/ext_gbm", values=None,
      keys=False, check=_zip_names),
    C("pojo_preview", "GET", "/3/Models.java/ext_gbm/preview",
      values=None),
    C("metrics_maker", "POST",
      "/3/ModelMetrics/predictions_frame/mm_pred/actuals_frame/mm_act",
      setup=[("POST", "/3/Predictions/models/ext_gbm/frames/ext.hex",
              {"data": {"predictions_frame": "mm_pred"}}),
             ("POST", "/99/Rapids",
              {"data": {"ast": "(tmp= mm_act (cols ext.hex [7]))"}})],
      data={}, values=None, check=_metrics_maker),
    C("nps_configured", "GET", "/3/NodePersistentStorage/configured"),
    C("nps_put", "POST", "/3/NodePersistentStorage/notebook/clip1",
      data={"value": "clip-1"}),
    C("nps_get", "GET", "/3/NodePersistentStorage/notebook/clip1",
      values=None, check=_nps_value),
    C("nps_list", "GET", "/3/NodePersistentStorage/notebook", values=None,
      check=lambda a, b, c: _close(
          [e["name"] for e in a["entries"]],
          [e["name"] for e in b["entries"]], 0)),
    C("nps_category_exists", "GET",
      "/3/NodePersistentStorage/categories/notebook/exists"),
    C("nps_name_exists", "GET",
      "/3/NodePersistentStorage/categories/notebook/names/clip1/exists"),
    C("nps_put_auto", "POST", "/3/NodePersistentStorage/auto",
      data={"value": "v"}, values=None),
    C("nps_delete", "DELETE", "/3/NodePersistentStorage/notebook/clip1"),
    C("segment_build", "POST", "/99/SegmentModelsBuilders/glm",
      data={"training_frame": "ext.hex", "segment_columns": ["color"],
            "response_column": "y", "dest": "seg1", "family": "binomial",
            "lambda_": 0}),
    C("segment_build3", "POST", "/3/SegmentModelsBuilders/nope",
      data={"training_frame": "ext.hex"}),
    C("segment_get", "GET", "/99/SegmentModels/seg1", values=None,
      check=lambda a, b, c: _close(
          [sorted(r) for r in a["segments"]],
          [sorted(r) for r in b["segments"]], 0)),
    C("segment_models_list", "GET", "/99/SegmentModels"),
    C("tabulate", "POST", "/99/Tabulate",
      data={"dataset": "ext.hex", "predictor": "x0", "response": "x1",
            "nbins_predictor": 5}, values=None, check=_tabulate),
    C("leaderboards", "GET", "/99/Leaderboards"),
    C("leaderboards_missing", "GET", "/99/Leaderboards/no_aml"),
    C("import_files_multi", "GET",
      lambda s, c: "/3/ImportFilesMulti?paths=" + c["csv"]),
    C("import_files_multi_post", "POST", "/3/ImportFilesMulti",
      data=lambda s, c: {"paths": [c["csv"]]}),
    C("decryption_setup", "POST", "/3/DecryptionSetup", data={},
      values=None, differs="product name in the text"),
    C("import_hive", "POST", "/3/ImportHiveTable", data={}),
    C("export_hive", "POST", "/3/SaveToHiveTable", data={}),
    C("persist_s3", "POST", "/3/PersistS3",
      data={"secret_key_id": "k", "secret_access_key": "s"}),
    C("steam_instances", "GET", "/3/steam/instances", values=None,
      check=_steam, differs="cloud_size 1 against 8"),
    C("kill_minus3", "GET", "/3/KillMinus3"),
    C("metadata_schemas", "GET", "/3/Metadata/schemas"),
    C("metadata_schema", "GET", "/3/Metadata/schemas/CloudV3"),
    C("metadata_schema_missing", "GET", "/3/Metadata/schemas/NopeV3"),
    C("metadata_endpoint_num", "GET", "/3/Metadata/endpoints/0"),
    C("metadata_endpoint_name", "GET", "/3/Metadata/endpoints/h_parse"),
    C("rapids_help", "GET", "/99/Rapids/help", values=None,
      check=_rapids_help),
    C("session_get", "GET", "/4/sessions/s1"),
    C("models_info_v4", "GET", "/4/modelsinfo", values=None,
      check=_models_info),
    C("frames_v4", "GET", "/4/frames", values=None,
      check=_same_names_of("frames", "frame_id")),
    C("models_v4", "GET", "/4/models", values=None,
      check=_same_names_of("models", "model_id")),
    C("automl_list", "GET", "/99/AutoML"),
    # the JAX handler calls pandas, whose pyarrow strings crash beside
    # torch in one process: the port's answer is held to pandas'
    # drop_duplicates semantics computed from the JAX frame here
    C("drop_duplicates", "POST", "/3/DropDuplicates",
      data={"dataset": "ext.hex", "compare_columns": ["color", "y"],
            "dest": "dd1"}, jax=False,
      check=_dedup("ext.hex", ["color", "y"], "first", "dd1")),
    C("drop_duplicates_last", "POST", "/3/DropDuplicates",
      data={"dataset": "cf1", "compare_columns": ["C6"], "keep": "last",
            "dest": "dd2"}, jax=False,
      check=_dedup("cf1", ["C6"], "last", "dd2")),
    C("permutation_varimp", "POST", "/3/PermutationVarImp",
      data={"model": "ext_gbm", "frame": "ext.hex", "seed": 42},
      values=None, check=_varimp),
    # ---- routes_ext3
    C("post_file", "POST", "/3/PostFile?destination_frame=up1.csv",
      raw=_upload_csv, headers={"Content-Type": "text/csv"}),
    C("post_file_parse", "POST", "/3/Parse",
      data={"source_frames": "up1.csv", "destination_frame": "up1.hex"},
      values=None, check=_frame_result("up1.hex")),
    C("post_file_bin", "POST", "/3/PostFile.bin", raw=b"",
      values=None),
    C("dct", "POST", "/3/DCTTransformer",
      data={"dataset": "sp_b", "destination_frame": "dct1"}, values=None,
      check=_dct),
    C("dct99", "POST", "/99/DCTTransformer",
      data={"dataset": "no_frame"}),
    C("feature_interaction", "POST", "/3/FeatureInteraction",
      data={"model": "ext_gbm"}, values=None, check=_feature_interaction),
    C("fairness", "POST", "/99/FairnessMetrics",
      data={"model": "ext_gbm", "frame": "ext.hex",
            "protected_columns": ["color"]}, values=None, check=_fairness),
    C("assembly", "POST", "/99/Assembly",
      data={"frame": "ext.hex", "steps": ["(cols {frame} [0 1 6])",
                                           "(rows {frame} [0:10])"],
            "dest": "asm1", "assembly_id": "asm_def"},
      check=_frame_result("asm1")),
    C("assembly_pojo", "GET", "/99/Assembly.java/asm_def/Pipe"),
    C("scala_int", "POST", "/3/scalaint", data={}),
    C("scala_int_id", "POST", "/3/scalaint/7", data={}),
    C("steam_metrics", "GET", "/3/SteamMetrics", values=None,
      check=_steam_metrics, differs="cloud_size 1 against 8"),
    C("builder_params_get", "GET", "/3/ModelBuilders/glm/parameters"),
    C("ping99", "GET", "/99/Ping"),
    C("job_delete", "DELETE", lambda s, c: f"/3/Jobs/{_job_key(s, c)}",
      values=None),
    # ---- routes_ext4
    C("metrics_frame", "GET", "/3/ModelMetrics/frames/ext.hex",
      values=None),
    C("metrics_frame_model", "GET",
      "/3/ModelMetrics/frames/ext.hex/models/ext_gbm", values=None),
    C("frame_column", "GET", "/3/Frames/ext.hex/columns/x2", values=None,
      check=_summary),
    C("frame_export_get", "GET",
      lambda s, c: "/3/Frames/cf1/export/" + os.path.join(
          c["tmp"], s, "cf1_get.hex").replace("/", "%2F")
      + "/overwrite/true"),
    C("frame_save", "POST", "/3/Frames/cf1/save",
      data=lambda s, c: {"dir": os.path.join(c["tmp"], s, "frames")}),
    C("frame_load", "POST", "/3/Frames/load",
      data=lambda s, c: {"dir": os.path.join(c["tmp"], s, "frames"),
                         "frame_id": "cf1"},
      check=_frame_result("cf1")),
    C("model_fetch_bin", "GET", "/3/Models.fetch.bin/ext_gbm",
      values=None, keys=False),
    C("model_fetch_bin_99", "GET", "/99/Models.bin/ext_gbm", values=None,
      keys=False),
    C("model_json", "GET", "/99/Models/ext_gbm/json", values=None,
      check=_model_json),
    C("model_upload_bin", "POST", "/99/Models.upload.bin/up_gbm",
      raw=_gbm_bin, headers={"Content-Type": "application/octet-stream"}),
    C("builder_model_id", "POST", "/3/ModelBuilders/gbm/model_id",
      data={}, values=None),
    C("profiler_get", "GET", "/3/Profiler?depth=3", values=None),
    C("watermeter_io", "GET", "/3/WaterMeterIo"),
    C("watermeter_io_node", "GET", "/3/WaterMeterIo/0"),
    C("schemaclass", "GET", "/3/Metadata/schemaclasses/JobsV3"),
    C("cloud_lock", "POST", "/3/CloudLock", data={"reason": "t"}),
    C("sample", "GET", "/99/Sample", values=None, check=_sample,
      differs="cloud_size 1 against 8"),
    C("endpoints_v4", "GET", "/4/endpoints", values=None,
      check=_endpoints_v4),
    C("job_v4", "GET", lambda s, c: f"/4/jobs/{_job_key(s, c)}",
      values=None),
    C("frames_simple_v4", "POST", "/4/Frames/$simple",
      data={"rows": 20, "cols": 4, "seed": 4, "dest": "cf2"},
      check=_frame_result("cf2")),
    C("predict_v4", "POST", "/4/Predictions/models/ext_gbm/frames/ext.hex",
      data={"predictions_frame": "p_v4"}, values=None,
      check=lambda a, b, c: _frames_close("p_v4", "p_v4", atol=1e-5)),
    C("te_transform", "POST", "/3/TargetEncoderTransform",
      data={"model": "ext_te", "frame": "ext.hex"}, values=None,
      check=_te),
    C("te_transform_get", "GET",
      "/3/TargetEncoderTransform?model=ext_te&frame=nope"),
    C("friedmans_h", "POST", "/3/FriedmansPopescusH",
      data={"model": "ext_gbm", "frame": "ext.hex",
            "variables": ["x0", "x1"]}, values=None, check=_h_stat),
    C("grid_export", "POST", "/3/Grid.bin/g1/export",
      data=lambda s, c: {"grid_directory": os.path.join(c["tmp"], s,
                                                        "grid")}),
    C("grid_import", "POST", "/3/Grid.bin/import",
      data=lambda s, c: {"grid_path": os.path.join(c["tmp"], s, "grid")}),
    C("grid_resume", "POST", "/99/Grid/glm/resume",
      data={"grid_id": "g1"}),
    C("xgb_init", "POST", "/3/XGBoostExecutor.init", data={}, values=None,
      differs="the text names the port's in-process XGBoost"),
    C("xgb_setup", "POST", "/3/XGBoostExecutor.setup", data={},
      values=None),
    C("xgb_update", "POST", "/3/XGBoostExecutor.update", data={},
      values=None),
    C("xgb_booster", "POST", "/3/XGBoostExecutor.getBooster", data={},
      values=None),
    C("xgb_cleanup", "POST", "/3/XGBoostExecutor.cleanup", data={},
      values=None),
    # ---- the DELETE-all family last: it empties the stores
    C("metrics_delete_mf", "DELETE",
      "/3/ModelMetrics/models/ext_gbm/frames/ext.hex"),
    C("metrics_delete_fm", "DELETE",
      "/3/ModelMetrics/frames/ext.hex/models/ext_gbm"),
    C("metrics_delete_m", "DELETE", "/3/ModelMetrics/models/ext_gbm"),
    C("metrics_delete_f", "DELETE", "/3/ModelMetrics/frames/ext.hex"),
    C("metrics_delete", "DELETE", "/3/ModelMetrics"),
    C("dkv_remove_all", "DELETE", "/3/DKV",
      setup=[("POST", "/99/Rapids",
              {"data": {"ast": "(tmp= dkv_gone (cols ext.hex [0]))"}})],
      data=lambda s, c: {"retained_keys": _retained(s, c)},
      check=_dkv_gone),
    C("models_delete_all", "DELETE", "/3/Models", values=None,
      check=lambda a, b, c: _no_models()),
    C("frames_delete_all", "DELETE", "/3/Frames", values=None,
      check=lambda a, b, c: _no_frames()),
    # ---- flow
    C("flow_root", "GET", "/", values=None, keys=False, check=_flow_same,
      differs="product name"),
    C("flow_index", "GET", "/flow/index.html", values=None, keys=False,
      check=_flow_same, differs="product name"),
    C("flow_notebook", "GET", "/flow/notebook.html", values=None,
      keys=False, check=_flow_same, differs="product name"),
]


def _write_svmlight(path, n=40, seed=9):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for _ in range(n):
            feats = sorted(rng.choice(np.arange(1, 9), 3, replace=False))
            f.write(str(int(rng.integers(0, 2))) + " " + " ".join(
                f"{j}:{rng.normal():.4f}" for j in feats) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def ctx(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("rest_ext")
    home = os.environ.get("HOME")
    # keys other files of this process left in the stores
    before = set(h2o3_tpu.ls()) | set(h2o3_tpu_torch.ls())
    os.environ["HOME"] = str(tmp / "home")   # the NPS store lives there
    for side in ("j", "t"):
        (tmp / side).mkdir()
    h2o3_tpu_torch.init(device="cpu")
    csv = write_csv(tmp / "ext.csv", n=NROWS, seed=11)
    svm = _write_svmlight(tmp / "s.svm")
    js = JS.H2OServer(port=0).start()
    ts = TS.H2OServer(port=0).start()
    c = {"j": js.port, "t": ts.port, "csv": csv, "svm": svm,
         "tmp": str(tmp), "before": before}
    for port in (js.port, ts.port):
        _, _, p = req(port, "POST", "/3/Parse",
                      data={"source_frames": csv,
                            "destination_frame": "ext.hex"})
        assert wait_job(port, p["job"]["key"])["status"] == "DONE"
        for algo, kw in (("gbm", dict(ntrees=3, max_depth=3, min_rows=50,
                                      seed=1, model_id="ext_gbm")),
                         ("glm", dict(J_LAMBDA, model_id="ext_glm"))):
            _, _, b = req(port, "POST", f"/3/ModelBuilders/{algo}",
                          data=dict(kw, training_frame="ext.hex",
                                    response_column="y"))
            j = wait_job(port, b["job"]["key"])
            assert j["status"] == "DONE", j
    # a target encoder has no REST builder in either package (its class
    # lacks the builders' _COMMON table): trained in process
    for pkg in (h2o3_tpu, h2o3_tpu_torch):
        from importlib import import_module
        te = import_module(pkg.__name__ + ".models").ESTIMATORS[
            "targetencoder"]()
        te.train(x=["color"], y="y", training_frame=pkg.get_frame("ext.hex"))
        pkg.DKV.put("ext_te", te)
    yield c
    js.stop()
    ts.stop()
    TWD.reset()
    # leave no key (frames, models, jobs holding their results) and no
    # garbage holding frame chunks behind for later tests in this process
    for pkg in (h2o3_tpu, h2o3_tpu_torch):
        for k in set(pkg.ls()) - before:
            pkg.remove(k)
    h2o3_tpu_torch.shutdown()
    gc.collect()
    if home is None:
        os.environ.pop("HOME", None)
    else:
        os.environ["HOME"] = home


def test_table_covers_every_route(ctx):
    """Every (pattern, method) of routes_ext*.py and flow.py is matched by
    a case of the table."""
    sent = {(c.method, urllib.parse.urlparse(_v(c.path, "t", ctx)).path)
            for c in CASES}
    ext = [(p, m) for p, m, fn in TS.ROUTES
           if fn.__module__.rsplit(".", 1)[-1].startswith(("routes_ext",
                                                           "flow"))]
    missing = [(m, p.pattern) for p, m in ext
               if not any(sm == m and p.fullmatch(sp) for sm, sp in sent)]
    assert not missing


@pytest.mark.parametrize("case", CASES, ids=[c.id for c in CASES])
def test_route(ctx, case):
    if not case.jax:
        sb, _, b = _send(ctx, "t", case)
        assert sb == 200, (case.id, b)
        case.check(None, b, ctx)
        return
    (sa, ha, a), (sb, hb, b) = _send(ctx, "j", case), _send(ctx, "t", case)
    assert sa == sb, (case.id, a, b)
    if isinstance(a, dict) and isinstance(b, dict):
        assert a.get("__meta") == b.get("__meta"), case.id
        if case.keys:
            assert a.keys() == b.keys(), case.id
        if case.values == "all":
            assert _strip(a) == _strip(b), case.id
    else:
        assert ha.get("content-type") == hb.get("content-type"), case.id
    if case.check is not None and sa == 200:
        case.check(a, b, ctx)

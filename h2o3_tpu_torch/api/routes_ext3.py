"""REST long tail, part 3 — upload, transforms, model insight and
pipeline routes from RequestServer.java's registry: PostFile (the
h2o.upload_file channel), DCTTransformer, FeatureInteraction,
fairness metrics, Assembly (munging pipelines), SteamMetrics, plus the
remaining alias/loud-reject entries."""

from __future__ import annotations

import json
import os
import re
import tempfile

import numpy as np

from h2o3_tpu_torch.core.frame import Frame
from h2o3_tpu_torch.core.kvstore import DKV


# ---------------------------------------------------------------------------
def _h_post_file(h):
    """POST /3/PostFile (PostFileHandler): upload a file body and stage it
    server-side; h2o.upload_file then parses the staged key. Accepts raw
    bodies and single-part multipart/form-data."""
    ln = int(h.headers.get("Content-Length") or 0)
    if ln <= 0:
        return h._error("empty upload", 400)
    body = h.rfile.read(ln)
    ctype = h.headers.get("Content-Type", "")
    if "multipart/form-data" in ctype and b"\r\n\r\n" in body:
        # strip the (single) part envelope: headers end at CRLFCRLF, the
        # trailing boundary starts at the last CRLF--
        start = body.index(b"\r\n\r\n") + 4
        end = body.rfind(b"\r\n--")
        body = body[start:end if end > start else len(body)]
    import urllib.parse
    q = urllib.parse.parse_qs(urllib.parse.urlparse(h.path).query)
    dest = (q.get("destination_frame") or [None])[0] or \
        DKV.make_key("upload")
    fd, path = tempfile.mkstemp(prefix="h2o3_upload_",
                                suffix=os.path.splitext(dest)[1] or ".csv")
    with os.fdopen(fd, "wb") as fh:
        fh.write(body)
    # remember the staged path under the destination key; /3/Parse with
    # source_frames=<dest> then parses (and deletes) it (h2o-py upload
    # flow); the table is bounded against never-parsed uploads
    _evict_stale_uploads()
    _UPLOADS[dest] = path
    h._send({"__meta": {"schema_type": "PostFileV3"},
             "destination_frame": dest, "total_bytes": len(body)})


_UPLOADS: dict = {}
_UPLOADS_MAX = 64


def staged_upload_path(key: str):
    """/3/Parse hook: resolve an uploaded pseudo-key to its temp file."""
    return _UPLOADS.get(key)


def consume_upload(key: str) -> None:
    """Delete the staged temp file once its parse consumed it."""
    path = _UPLOADS.pop(key, None)
    if path:
        try:
            os.unlink(path)
        except OSError:
            pass


def _evict_stale_uploads() -> None:
    """Bound the staging table: never-parsed uploads are dropped
    oldest-first once the cap is hit (insertion-ordered dict)."""
    while len(_UPLOADS) >= _UPLOADS_MAX:
        consume_upload(next(iter(_UPLOADS)))


# ---------------------------------------------------------------------------
def _h_dct(h):
    """POST /3/DCTTransformer (util/DCTTransformer.java): DCT-II of the
    numeric columns (the deep-learning image-preprocessing transform)."""
    try:
        from scipy.fft import dct
    except ImportError:
        return h._error("DCTTransformer requires scipy, which this "
                        "deployment does not ship", 501)
    p = h._params()
    f = DKV.get(p.get("dataset") or p.get("frame"))
    if not isinstance(f, Frame):
        return h._error("dataset not found", 404)
    num_cols = [c for c in f.names if f.vec(c).type == "num"]
    X = np.column_stack([f.vec(c).to_numpy() for c in num_cols])
    Y = dct(np.nan_to_num(X), axis=1, norm="ortho")
    dest = p.get("destination_frame") or DKV.make_key("dct")
    out = Frame.from_dict(
        {f"DCT_{j}": Y[:, j] for j in range(Y.shape[1])}, key=dest)
    DKV.put(dest, out)
    h._send({"__meta": {"schema_type": "DCTTransformerV3"},
             "dest": {"name": dest}})


# ---------------------------------------------------------------------------
def _h_feature_interaction(h):
    """POST /3/FeatureInteraction (xgboost FeatureInteractions): ranked
    feature pairs from parent→child split adjacency over the ensemble,
    reporting FScore (path count) and cover; the reference additionally
    integrates per-node gain, which the packed tree arrays don't retain."""
    from h2o3_tpu_torch.models.model import ModelBase
    p = h._params()
    m = DKV.get(p.get("model") or p.get("model_id"))
    if not isinstance(m, ModelBase):
        return h._error("model not found", 404)
    ta = getattr(m, "_trees", None)
    if ta is None:
        return h._error("model has no tree arrays", 400)
    from h2o3_tpu_torch.api.routes_ext import _host
    col = _host(ta.col)
    cover = _host(ta.cover) if ta.cover is not None else \
        np.ones_like(col, np.float32)
    names = m._dinfo.feature_names
    pairs: dict = {}
    T, nodes = col.shape
    for t in range(T):
        for n in range((nodes - 1) // 2):
            cp = col[t, n]
            if cp < 0:
                continue
            for child in (2 * n + 1, 2 * n + 2):
                if child < nodes and col[t, child] >= 0:
                    key = (int(cp), int(col[t, child]))
                    f_cnt, c_sum = pairs.get(key, (0, 0.0))
                    pairs[key] = (f_cnt + 1,
                                  c_sum + float(cover[t, child]))
    rows = sorted(
        ({"feature_pair": f"{names[a]}|{names[b]}",
          "fscore": cnt, "cover": cov}
         for (a, b), (cnt, cov) in pairs.items()),
        key=lambda r: -r["fscore"])
    h._send({"__meta": {"schema_type": "FeatureInteractionV3"},
             "feature_interaction": rows[:int(p.get("max_interactions")
                                              or 100)]})


# ---------------------------------------------------------------------------
def _h_fairness(h):
    """POST /99/FairnessMetrics (the h2o.inspect_model_fairness surface):
    per-protected-group confusion/selection metrics + adverse impact
    ratios against a reference group."""
    from h2o3_tpu_torch.models.model import ModelBase
    p = h._params()
    m = DKV.get(p.get("model"))
    f = DKV.get(p.get("frame"))
    if not isinstance(m, ModelBase) or not isinstance(f, Frame):
        return h._error("model/frame not found", 404)
    prot = p.get("protected_columns")
    prot = json.loads(prot) if isinstance(prot, str) else prot
    if not prot:
        return h._error("protected_columns required", 400)
    pred = m.predict(f)
    pp = pred.vecs[-1].to_numpy()          # p(positive) / prediction
    DKV.remove(pred.key)                   # scratch frame: don't leak
    di = m._dinfo
    y = np.asarray(f.vec(di.response_name).to_numpy())
    if di.response_domain is not None and y.dtype.kind == "f":
        pos = y == 1.0
    else:
        pos = y > 0.5
    groups = {}
    for c in prot:
        v = f.vec(c)
        dom = v.levels() or []
        codes = v.to_numpy()[: f.nrows]
        for li, lvl in enumerate(dom):
            mask = codes == li
            n = int(mask.sum())
            if n == 0:
                continue
            sel = pp[mask] > 0.5
            acc = float((sel == pos[mask]).mean())
            groups[f"{c}.{lvl}"] = {
                "n": n, "selection_rate": float(sel.mean()),
                "accuracy": acc,
                "tpr": float(sel[pos[mask]].mean())
                if pos[mask].any() else float("nan")}
    ref = max(groups, key=lambda g: groups[g]["n"]) if groups else None
    for g, row in groups.items():
        base = groups[ref]["selection_rate"] if ref else 0.0
        row["air"] = (row["selection_rate"] / base) if base else float("nan")
    h._send({"__meta": {"schema_type": "FairnessMetricsV99"},
             "reference_group": ref, "groups": groups})


# ---------------------------------------------------------------------------
def _h_assembly(h):
    """POST /99/Assembly (water/rapids/Assembly.java): a named pipeline of
    munging steps applied in order — steps is a JSON list of Rapids ASTs
    where `{frame}` substitutes the current frame key."""
    p = h._params()
    f = DKV.get(p.get("frame"))
    if not isinstance(f, Frame):
        return h._error("frame not found", 404)
    steps = p.get("steps")
    steps = json.loads(steps) if isinstance(steps, str) else (steps or [])
    from h2o3_tpu_torch.rapids.rapids import rapids_exec
    cur = f
    inter: list = []
    for i, ast in enumerate(steps):
        out = rapids_exec(ast.replace("{frame}", cur.key))
        if not isinstance(out, Frame):
            return h._error(f"assembly step {i} did not produce a frame",
                            400)
        if cur is not f:
            inter.append(cur.key)     # superseded intermediate
        cur = out                     # rapids already registered its key
    dest = p.get("dest") or DKV.make_key("assembly")
    if cur is f:
        # identity pipeline: register a fresh handle under dest instead of
        # stealing the source frame's key (the old DKV binding would still
        # point at the re-keyed object)
        cur = Frame(list(f.names), list(f.vecs), key=dest)
    else:
        DKV.remove(cur.key)           # re-key the final frame cleanly
        cur.key = dest
        DKV.put(dest, cur)
    for k in inter:                   # drop step intermediates
        DKV.remove(k)
    aid = p.get("assembly_id") or DKV.make_key("assembly_def")
    DKV.put(aid, {"steps": steps})
    h._send({"__meta": {"schema_type": "AssemblyV99"},
             "assembly": {"name": aid}, "result": {"name": dest}})


def _h_assembly_pojo(h, aid, name):
    h._error(
        "Assembly-to-POJO codegen (MungeTask java emission) is not "
        "implemented; score assemblies server-side via POST /99/Assembly "
        "or export the resulting frame", 501)


def _h_scala_int(h, *_):
    h._error("the Scala REPL (h2o-scala scalaint) requires a JVM, which "
             "this runtime does not ship; use the Rapids console or the "
             "Python client", 501)


def _h_steam_metrics(h):
    """GET /3/SteamMetrics: the Enterprise-Steam keepalive metric set."""
    import time
    import h2o3_tpu_torch
    info = h2o3_tpu_torch.cluster_info()
    h._send({"__meta": {"schema_type": "SteamMetricsV3"},
             "cluster_size": info["cloud_size"],
             "healthy": True, "timestamp_millis": int(time.time() * 1000)})


def _h_builder_params_get(h, algo):
    """GET /3/ModelBuilders/{algo}/parameters: the builder's parameter
    schema (codegen clients read this)."""
    from h2o3_tpu_torch.models import ESTIMATORS
    cls = ESTIMATORS.get(algo)
    if cls is None:
        return h._error(f"unknown algo {algo}", 404)
    defaults = getattr(cls, "_defaults", {})
    h._send({"__meta": {"schema_type": "ModelParametersSchemaV3"},
             "parameters": [{"name": k, "default_value": v,
                             "type": type(v).__name__}
                            for k, v in sorted(defaults.items())]})


def _h_ping99(h):
    import time
    h._send({"__meta": {"schema_type": "PingV3"},
             "status": "running",
             "timestamp_millis": int(time.time() * 1000)})


def _h_job_delete(h, key):
    """DELETE /3/Jobs/{id}: cancel alias (JobsHandler)."""
    from h2o3_tpu_torch.core.jobs import Job
    j = DKV.get(key)
    if not isinstance(j, Job):
        return h._error(f"job {key} not found", 404)
    j.stop()
    h._send({"__meta": {"schema_type": "JobsV3"}, "jobs": [j.to_dict()]})


# ---------------------------------------------------------------------------
def build_routes():
    R = re.compile
    return [
        (R(r"/3/PostFile"), "POST", _h_post_file),
        (R(r"/3/PostFile\.bin"), "POST", _h_post_file),
        (R(r"/3/DCTTransformer"), "POST", _h_dct),
        (R(r"/3/FeatureInteraction"), "POST", _h_feature_interaction),
        (R(r"/99/FairnessMetrics"), "POST", _h_fairness),
        (R(r"/99/Assembly"), "POST", _h_assembly),
        (R(r"/99/Assembly\.java/([^/]+)/([^/]+)"), "GET",
         _h_assembly_pojo),
        (R(r"/3/scalaint"), "POST", _h_scala_int),
        (R(r"/3/scalaint/([^/]+)"), "POST", _h_scala_int),
        (R(r"/3/SteamMetrics"), "GET", _h_steam_metrics),
        (R(r"/3/ModelBuilders/([^/]+)/parameters"), "GET",
         _h_builder_params_get),
        (R(r"/99/Ping"), "GET", _h_ping99),
        (R(r"/3/Jobs/([^/]+)"), "DELETE", _h_job_delete),
    ]

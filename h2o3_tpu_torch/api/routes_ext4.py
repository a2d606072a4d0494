"""REST long tail, part 4 — the final route-diff closure against
water/api/RegisterV3Api.java + RegisterV4Api.java + RegisterAlgos.java.

Round-4 verdict asked for zero unexplained absences vs the reference
registry; this module adds every remaining route as either a real
implementation, a same-handler alias (method/path variants), or an
explicit 501 loud-reject with guidance (JVM/external-cluster-only
surfaces). The diff table lives in ROUND5_NOTES.md.
"""

from __future__ import annotations

import json
import os
import re
import sys
import time

import numpy as np

from h2o3_tpu_torch.core.frame import Frame
from h2o3_tpu_torch.core.kvstore import DKV


# ---------------------------------------------------------------------------
# ModelMetrics: frame-scoped listing + DELETE family
# (water/api/ModelMetricsHandler list/delete endpoints)
def _metrics_rows(model_id=None, frame_id=None):
    from h2o3_tpu_torch.models.model import ModelBase
    rows = []
    for k in DKV.keys():
        m = DKV.get(k)
        if not isinstance(m, ModelBase) or m._output is None:
            continue
        if model_id is not None and m.key != model_id:
            continue
        for kind in ("training_metrics", "validation_metrics",
                     "cross_validation_metrics"):
            mm = getattr(m._output, kind, None)
            if mm is None:
                continue
            fr = getattr(mm, "frame_id", None)
            if frame_id is not None and fr != frame_id:
                continue
            rows.append(dict(mm.to_dict(), model={"name": m.key},
                             frame={"name": fr} if fr else None,
                             kind=kind))
    return rows


def _h_metrics_frame(h, fid, mid=None):
    """GET /3/ModelMetrics/frames/{f}[/models/{m}]."""
    rows = _metrics_rows(model_id=mid, frame_id=fid)
    h._send({"__meta": {"schema_type": "ModelMetricsListSchemaV3"},
             "model_metrics": rows})


def _h_metrics_delete(h, *ids):
    """DELETE /3/ModelMetrics[...]: metrics live inside their model's
    output here (no standalone DKV entries), so deletion clears the
    validation/CV metric slots of the matching models."""
    from h2o3_tpu_torch.models.model import ModelBase
    model_id = frame_id = None
    # route variants bind (frame, model) or (model, frame) — resolve by key
    for i in ids:
        if isinstance(DKV.get(i), ModelBase):
            model_id = i
        else:
            frame_id = i
    n = 0
    for k in list(DKV.keys()):
        m = DKV.get(k)
        if not isinstance(m, ModelBase) or m._output is None:
            continue
        if model_id is not None and m.key != model_id:
            continue
        for kind in ("validation_metrics", "cross_validation_metrics"):
            mm = getattr(m._output, kind, None)
            if mm is None:
                continue
            if frame_id is not None and \
                    getattr(mm, "frame_id", None) != frame_id:
                continue
            setattr(m._output, kind, None)
            n += 1
    h._send({"__meta": {"schema_type": "ModelMetricsListSchemaV3"},
             "model_metrics": [], "deleted": n})


# ---------------------------------------------------------------------------
# Frames: single-column schema, GET export variant, binary save/load
def _h_frame_column(h, fid, col):
    f = DKV.get(fid)
    if not isinstance(f, Frame):
        return h._error(f"frame {fid} not found", 404)
    if col not in f.names:
        return h._error(f"column {col} not in {fid}", 404)
    from h2o3_tpu_torch.api.server import _frame_schema
    sch = _frame_schema(f, with_summary=True)
    cols = [c for c in sch["columns"] if c["label"] == col]
    h._send({"__meta": {"schema_type": "FramesV3"},
             "frames": [{"frame_id": {"name": fid}, "columns": cols}]})


def _h_frame_export_get(h, fid, path, force):
    """GET /3/Frames/{id}/export/{path}/overwrite/{force} — the legacy
    path-segment spelling of POST /3/Frames/{id}/export."""
    f = DKV.get(fid)
    if not isinstance(f, Frame):
        return h._error(f"frame {fid} not found", 404)
    import urllib.parse
    dest = urllib.parse.unquote(path)
    if os.path.exists(dest) and force.lower() not in ("true", "1"):
        return h._error(f"{dest} exists and overwrite is false", 412)
    from h2o3_tpu_torch.io.persist import export_frame
    export_frame(f, dest)
    h._send({"__meta": {"schema_type": "FramesV3"}, "path": dest})


def _h_frame_save(h, fid):
    """POST /3/Frames/{id}/save (FramesHandler.save): binary frame
    artifact under {dir}/{frame_id}."""
    p = h._params()
    f = DKV.get(fid)
    if not isinstance(f, Frame):
        return h._error(f"frame {fid} not found", 404)
    d = p.get("dir")
    if not d:
        return h._error("dir is required", 400)
    from h2o3_tpu_torch.io.persist import export_frame
    os.makedirs(d, exist_ok=True)
    dest = os.path.join(d, fid + ".h2o3frame")
    export_frame(f, dest)
    h._send({"__meta": {"schema_type": "FramesV3"}, "dir": d,
             "frames": [{"frame_id": {"name": fid}}]})


def _h_frame_load(h):
    """POST /3/Frames/load: re-import a saved binary frame."""
    p = h._params()
    d, fid = p.get("dir"), p.get("frame_id")
    if not d or not fid:
        return h._error("dir and frame_id are required", 400)
    src = os.path.join(d, fid + ".h2o3frame")
    if not os.path.exists(src):
        return h._error(f"{src} not found", 404)
    from h2o3_tpu_torch.io.persist import import_frame
    f = import_frame(src, key=fid)
    h._send({"__meta": {"schema_type": "FramesV3"},
             "job": None, "frames": [{"frame_id": {"name": f.key}}]})


# ---------------------------------------------------------------------------
# Model artifacts: fetch.bin / 99-scoped bin+mojo+json, upload.bin
def _h_model_fetch_bin(h, mid):
    """GET /3/Models.fetch.bin/{id} (+ /99/Models.bin/{id}): the binary
    model stream h2o.load_model round-trips."""
    m = DKV.get(mid)
    if m is None:
        return h._error(f"model {mid} not found", 404)
    import tempfile
    from h2o3_tpu_torch.genmodel.mojo import save_model
    from h2o3_tpu_torch.api.routes_ext import _send_bytes
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, mid)
        save_model(m, path)
        with open(path, "rb") as fh:
            body = fh.read()
    _send_bytes(h, body, "application/octet-stream", mid)


def _h_model_upload_bin(h, mid):
    """POST /99/Models.upload.bin/{id}: raw binary model body → registry."""
    ln = int(h.headers.get("Content-Length") or 0)
    if ln <= 0:
        return h._error("empty upload", 400)
    body = h.rfile.read(ln)
    import tempfile
    from h2o3_tpu_torch.genmodel.mojo import load_model
    # load_model registers under the artifact's EMBEDDED key — snapshot
    # bindings so an upload can't clobber a live model with the same id
    prev = {k: DKV.get(k) for k in DKV.keys()}
    fd, path = tempfile.mkstemp(prefix="h2o3_model_")
    try:
        with os.fdopen(fd, "wb") as fh:
            fh.write(body)
        m = load_model(path)
    finally:
        os.unlink(path)
    if mid and mid != m.key:
        old_key = m.key
        m.key = mid
        DKV.put(mid, m)
        if old_key in prev:                 # restore the clobbered binding
            DKV.put(old_key, prev[old_key])
        else:
            DKV.remove(old_key)
    h._send({"__meta": {"schema_type": "ModelsV3"},
             "models": [{"model_id": {"name": m.key}}]})


def _h_model_json(h, mid):
    from h2o3_tpu_torch.api.server import _h_model
    return _h_model(h, mid)


def _h_builder_model_id(h, algo):
    """POST /3/ModelBuilders/{algo}/model_id (CalcModelId): a fresh
    default model key for the Flow builder form."""
    h._send({"__meta": {"schema_type": "ModelIdV3"},
             "model_id": {"name": DKV.make_key(algo)}})


# ---------------------------------------------------------------------------
# NodePersistentStorage existence probes + category-level POST
def _h_nps_category_exists(h, categ):
    from h2o3_tpu_torch.api.routes_ext2 import _nps_dir
    h._send({"__meta": {"schema_type": "NodePersistentStorageV3"},
             "category": categ,
             "exists": os.path.isdir(os.path.join(_nps_dir(), categ))})


def _h_nps_name_exists(h, categ, name):
    from h2o3_tpu_torch.api.routes_ext2 import _nps_dir
    h._send({"__meta": {"schema_type": "NodePersistentStorageV3"},
             "category": categ, "name": name,
             "exists": os.path.isfile(
                 os.path.join(_nps_dir(), categ, name))})


def _h_nps_put_auto(h, categ):
    """POST /3/NodePersistentStorage/{categ}: auto-named value put."""
    from h2o3_tpu_torch.api.routes_ext2 import _h_nps_put
    name = f"clip_{int(time.time() * 1000)}"
    return _h_nps_put(h, categ, name)


# ---------------------------------------------------------------------------
# Diagnostics: Profiler, WaterMeterIo
def _h_profiler(h):
    """GET /3/Profiler (water/util/JProfile): stack samples aggregated
    across this runtime's threads — the py analog of the JVM profile.
    Also reports the on-demand session state (obs/profiler, driven by
    POST /3/Profiler): active/kind/dir ride alongside nodes[]."""
    p = h._params()
    depth = int(p.get("depth") or 10)
    import traceback
    counts: dict = {}
    for _ in range(5):
        for tid, frm in sys._current_frames().items():
            stack = traceback.format_stack(frm)[-depth:]
            key = "".join(stack)
            counts[key] = counts.get(key, 0) + 1
        time.sleep(0.02)
    nodes = [{"node_name": "this", "entries": [
        {"stacktrace": k, "count": v}
        for k, v in sorted(counts.items(), key=lambda kv: -kv[1])[:25]]}]
    from h2o3_tpu_torch.obs import profiler as _prof
    h._send({"__meta": {"schema_type": "ProfilerV3"}, "nodes": nodes,
             **_prof.PROFILER.status()})


def _h_watermeter_io(h, node=None):
    """GET /3/WaterMeterIo[/{node}] (water/util/WaterMeterIo): persist-
    layer IO counters; here real process IO from /proc."""
    stats = {}
    try:
        with open("/proc/self/io") as fh:
            for line in fh:
                k, v = line.split(":")
                stats[k.strip()] = int(v)
    except OSError:
        pass
    h._send({"__meta": {"schema_type": "WaterMeterIoV3"},
             "persist_stats": [{
                 "backend": "file",
                 "store_count": stats.get("syscw", 0),
                 "store_bytes": stats.get("write_bytes", 0),
                 "load_count": stats.get("syscr", 0),
                 "load_bytes": stats.get("read_bytes", 0)}]})


def _h_metadata_schemaclass(h, classname):
    """GET /3/Metadata/schemaclasses/{classname} — resolve by schema
    name through the same metadata table as /3/Metadata/schemas."""
    from h2o3_tpu_torch.api.routes_ext2 import _h_metadata_schemas
    return _h_metadata_schemas(h, classname)


# ---------------------------------------------------------------------------
# CloudLock + Sample + v4 surface
def _h_cloud_lock(h):
    """POST /3/CloudLock: the cloud is immutable after init — honor
    the call and echo the (already) locked state."""
    p = h._params()
    h._send({"__meta": {"schema_type": "CloudLockV3"}, "locked": True,
             "reason": p.get("reason") or "api"})


def _h_sample(h):
    from h2o3_tpu_torch.api.server import _h_cloud
    return _h_cloud(h)


def _h_endpoints_v4(h):
    from h2o3_tpu_torch.api.server import ROUTES
    eps = [{"url": f"{m} {p.pattern}", "name": fn.__name__}
           for p, m, fn in ROUTES]
    h._send({"__meta": {"schema_type": "EndpointsListV4"},
             "endpoints": eps, "__http_status": 200})


def _h_job_v4(h, jid):
    from h2o3_tpu_torch.api.server import _h_job
    return _h_job(h, jid)


def _h_frames_simple_v4(h):
    """POST /4/Frames/$simple (CreateFrameSimpleIV4)."""
    from h2o3_tpu_torch.api.routes_ext import _h_create_frame
    return _h_create_frame(h)


def _h_predict_v4(h, mid, fid):
    from h2o3_tpu_torch.api.server import _h_predict
    return _h_predict(h, mid, fid)


# ---------------------------------------------------------------------------
# TargetEncoderTransform (h2o-extensions/target-encoder REST surface)
def _h_te_transform(h):
    """GET/POST /3/TargetEncoderTransform?model=...&frame=... → encoded
    frame (TargetEncoderHandler.transform)."""
    p = h._params()
    m = DKV.get(p.get("model"))
    f = DKV.get(p.get("frame"))
    if m is None or not hasattr(m, "transform"):
        return h._error("target encoder model not found", 404)
    if not isinstance(f, Frame):
        return h._error("frame not found", 404)
    out = m.transform(f, as_training=str(
        p.get("as_training") or "false").lower() == "true")
    h._send({"__meta": {"schema_type": "TargetEncoderTransformV3"},
             "name": out.key})


# ---------------------------------------------------------------------------
# Friedman-Popescu H statistic (hex/tree/FriedmansPopescusH.java):
# H²(j,k) = Σ[pd_jk - pd_j - pd_k]² / Σ pd_jk²  over joint grid values,
# PDs centered, evaluated at the observed (sampled) rows.
def _h_friedmans_h(h):
    p = h._params()
    m = DKV.get(p.get("model"))
    f = DKV.get(p.get("frame"))
    if m is None or not isinstance(f, Frame):
        return h._error("model and frame are required", 404)
    variables = p.get("variables")
    variables = json.loads(variables) if isinstance(variables, str) \
        else (variables or [])
    if len(variables) < 2:
        return h._error("need >= 2 variables", 400)
    hval = friedmans_h(m, f, variables)
    h._send({"__meta": {"schema_type": "FriedmansPopescusHV3"},
             "h": hval})


def friedmans_h(model, frame: Frame, variables, sample: int = 500,
                grid: int = 8, seed: int = 42):
    """H statistic over the joint grid of the given variables."""
    di = model._dinfo
    n = min(frame.nrows, sample)
    sampled = None
    if n < frame.nrows:
        # sample ONCE before the grid loops: the cross-grid scores the
        # design matrix len(grid)^k times — full-frame passes would do
        # millions of discarded predictions on big frames. A seeded
        # uniform draw over ALL rows, not the first n: sorted/clustered
        # frames (by time, by class) would otherwise bias the PDs.
        from h2o3_tpu_torch.rapids.rapids import rapids_exec
        rng = np.random.default_rng(seed)
        ridx = np.sort(rng.choice(frame.nrows, size=n, replace=False))
        idx = " ".join(str(i) for i in ridx)
        frame = sampled = rapids_exec(f"(rows {frame.key} [{idx}])")
    X = di.matrix(frame)
    from h2o3_tpu_torch.explain_data import _grid_for, _set_feature, _score_col

    def pd_over(cols_vals):
        """Mean prediction with the listed (col, value) pins applied."""
        Xg = X
        for c, g, is_cat in cols_vals:
            Xg = _set_feature(di, Xg, c, g, is_cat)
        pr = _score_col(model, Xg)
        if pr.ndim > 1:
            pr = pr[:, 1] if pr.shape[1] == 2 else pr[:, 0]
        return float(np.asarray(pr)[:n].mean())

    grids = {}
    for c in variables:
        g, is_cat = _grid_for(frame, c, grid)
        grids[c] = [(c, gv, is_cat) for gv in g]
    # joint and marginal PDs on the cross grid (centered)
    import itertools
    joint, marg = [], {c: [] for c in variables}
    for combo in itertools.product(*grids.values()):
        joint.append(pd_over(list(combo)))
    for c in variables:
        for pin in grids[c]:
            marg[c].append(pd_over([pin]))
    joint = np.array(joint) - np.mean(joint)
    margs = {c: np.array(v) - np.mean(v) for c, v in marg.items()}
    # broadcast marginals onto the cross grid
    shape = [len(grids[c]) for c in variables]
    J = joint.reshape(shape)
    S = np.zeros(shape)
    for ax, c in enumerate(variables):
        sh = [1] * len(shape)
        sh[ax] = shape[ax]
        S = S + margs[c].reshape(sh)
    if sampled is not None:
        DKV.remove(sampled.key)        # drop the sampled temp frame
    denom = float((J ** 2).sum())
    if denom <= 0:
        return 0.0
    return float(np.sqrt(max(0.0, ((J - S) ** 2).sum() / denom)))


# ---------------------------------------------------------------------------
# Grid binary import/export + resume
def _h_grid_export(h, gid):
    """POST /3/Grid.bin/{id}/export {grid_directory}: every member model
    + the grid manifest as binary artifacts."""
    p = h._params()
    g = DKV.get(gid)
    if g is None:
        return h._error(f"grid {gid} not found", 404)
    d = p.get("grid_directory") or p.get("dir")
    if not d:
        return h._error("grid_directory is required", 400)
    os.makedirs(d, exist_ok=True)
    from h2o3_tpu_torch.genmodel.mojo import save_model
    ids = []
    for m in g.models:
        save_model(m, os.path.join(d, m.key))
        ids.append(m.key)
    with open(os.path.join(d, f"{gid}.grid.json"), "w") as fh:
        json.dump({"grid_id": gid, "model_ids": ids,
                   "hyper_params": {k: list(map(str, v))
                                    for k, v in g.hyper_params.items()}},
                  fh)
    h._send({"__meta": {"schema_type": "GridsV99"}, "grid_id": gid,
             "dir": d})


def _h_grid_import(h):
    """POST /3/Grid.bin/import {grid_path}: reload an exported grid."""
    p = h._params()
    d = p.get("grid_path") or p.get("dir")
    if not d or not os.path.isdir(d):
        return h._error("grid_path directory not found", 404)
    man_files = [x for x in os.listdir(d) if x.endswith(".grid.json")]
    if not man_files:
        return h._error("no .grid.json manifest in directory", 404)
    with open(os.path.join(d, man_files[0])) as fh:
        man = json.load(fh)
    from h2o3_tpu_torch.genmodel.mojo import load_model
    models = []
    for mid in man["model_ids"]:
        mp = os.path.join(d, mid)
        if os.path.exists(mp):
            models.append(load_model(mp))
    from h2o3_tpu_torch.models.grid import H2OGridSearch
    g = H2OGridSearch.__new__(H2OGridSearch)
    g.grid_id = man["grid_id"]
    g.hyper_params = man.get("hyper_params", {})
    g.models = models
    DKV.put(g.grid_id, g)
    h._send({"__meta": {"schema_type": "GridsV99"},
             "grid_id": man["grid_id"], "n_models": len(models)})


def _h_grid_resume(h, algo):
    """POST /99/Grid/{algo}/resume (GridSearchHandler.resume): re-enter
    an EXISTING recoverable grid's train loop — finished combos reload
    from recovery_dir and are skipped; only unfinished ones build."""
    p = h._params()
    gid = p.get("grid_id")
    rd = p.get("recovery_dir")
    if not gid or not rd:
        return h._error("grid_id and recovery_dir are required", 400)
    g = DKV.get(gid)
    from h2o3_tpu_torch.models.grid import H2OGridSearch
    if not isinstance(g, H2OGridSearch):
        return h._error(
            f"grid {gid} not found; import its models first "
            "(POST /3/Grid.bin/import) or rebuild via POST /99/Grid", 404)
    g.recovery_dir = rd
    frame = DKV.get(p.get("training_frame") or "")
    if not isinstance(frame, Frame):
        return h._error("training_frame is required for resume", 400)
    from h2o3_tpu_torch.core.jobs import Job
    job = Job(description=f"resume grid {gid}", dest=gid)

    def work(job):
        g.train(x=None, y=p.get("response_column") or p.get("y"),
                training_frame=frame)
        return g

    job.start(work)
    h._send({"__meta": {"schema_type": "GridSearchV99"},
             "job": job.to_dict(), "grid_id": gid})


# ---------------------------------------------------------------------------
# Loud rejects: external-cluster / JVM-only surfaces
def _h_xgb_executor(h, *_):
    h._error(
        "XGBoostExecutor.* is the reference's RPC seam to an external "
        "XGBoost cluster (hex/tree/xgboost/exec). This runtime trains "
        "its XGBoost in-process on the card (the adaptive tree engine) "
        "— use "
        "POST /3/ModelBuilders/xgboost", 501)


def _h_import_sql_99(h):
    from h2o3_tpu_torch.api.routes_ext import _h_import_sql
    return _h_import_sql(h)


# ===========================================================================

# handlers that start a background Job — quota-prepaid at the REST
# edge before the replay broadcast (see api/server.starts_job)
_h_grid_resume._starts_job = True
# scoring handler — QoS admission at the REST edge before the replay
# broadcast (see api/server.scores)
_h_predict_v4._scores = True

def build_routes():
    R = re.compile
    from h2o3_tpu_torch.api import routes_ext as E1
    from h2o3_tpu_torch.api import routes_ext2 as E2
    from h2o3_tpu_torch.api import routes_ext3 as E3
    from h2o3_tpu_torch.api import server as S
    return [
        # ModelMetrics family
        (R(r"/3/ModelMetrics/frames/([^/]+)"), "GET", _h_metrics_frame),
        (R(r"/3/ModelMetrics/frames/([^/]+)/models/([^/]+)"), "GET",
         _h_metrics_frame),
        (R(r"/3/ModelMetrics"), "DELETE", _h_metrics_delete),
        (R(r"/3/ModelMetrics/models/([^/]+)"), "DELETE", _h_metrics_delete),
        (R(r"/3/ModelMetrics/frames/([^/]+)"), "DELETE", _h_metrics_delete),
        (R(r"/3/ModelMetrics/models/([^/]+)/frames/([^/]+)"), "DELETE",
         _h_metrics_delete),
        (R(r"/3/ModelMetrics/frames/([^/]+)/models/([^/]+)"), "DELETE",
         _h_metrics_delete),
        # Frames
        (R(r"/3/Frames/([^/]+)/columns/([^/]+)"), "GET", _h_frame_column),
        (R(r"/3/Frames/([^/]+)/export/(.+)/overwrite/([^/]+)"), "GET",
         _h_frame_export_get),
        (R(r"/3/Frames/([^/]+)/save"), "POST", _h_frame_save),
        (R(r"/3/Frames/load"), "POST", _h_frame_load),
        # Model artifacts
        (R(r"/3/Models\.fetch\.bin/([^/]+)"), "GET", _h_model_fetch_bin),
        (R(r"/99/Models\.bin/([^/]+)"), "GET", _h_model_fetch_bin),
        (R(r"/99/Models\.mojo/([^/]+)"), "GET", E1._h_model_mojo),
        (R(r"/99/Models/([^/]+)/json"), "GET", _h_model_json),
        (R(r"/99/Models\.upload\.bin/([^/]*)"), "POST",
         _h_model_upload_bin),
        (R(r"/3/ModelBuilders/([^/]+)/model_id"), "POST",
         _h_builder_model_id),
        # NPS
        (R(r"/3/NodePersistentStorage/categories/([^/]+)/exists"), "GET",
         _h_nps_category_exists),
        (R(r"/3/NodePersistentStorage/categories/([^/]+)/names/([^/]+)/"
           r"exists"), "GET", _h_nps_name_exists),
        (R(r"/3/NodePersistentStorage/([^/]+)"), "POST", _h_nps_put_auto),
        # Diagnostics
        (R(r"/3/Profiler"), "GET", _h_profiler),
        (R(r"/3/WaterMeterIo"), "GET", _h_watermeter_io),
        (R(r"/3/WaterMeterIo/([^/]+)"), "GET", _h_watermeter_io),
        (R(r"/3/Metadata/schemaclasses/([^/]+)"), "GET",
         _h_metadata_schemaclass),
        # Cloud / misc
        (R(r"/3/CloudLock"), "POST", _h_cloud_lock),
        (R(r"/3/Cloud"), "HEAD", S._h_cloud),
        (R(r"/99/Sample"), "GET", _h_sample),
        (R(r"/3/UnlockKeys"), "POST", E1._h_unlock),
        # v4 API
        (R(r"/4/endpoints"), "GET", _h_endpoints_v4),
        (R(r"/4/jobs/([^/]+)"), "GET", _h_job_v4),
        (R(r"/4/Frames/\$simple"), "POST", _h_frames_simple_v4),
        (R(r"/4/Predictions/models/([^/]+)/frames/([^/]+)"), "POST",
         _h_predict_v4),
        # target encoding + H statistic
        (R(r"/3/TargetEncoderTransform"), "GET", _h_te_transform),
        (R(r"/3/TargetEncoderTransform"), "POST", _h_te_transform),
        (R(r"/3/FriedmansPopescusH"), "POST", _h_friedmans_h),
        # grid binary + resume
        (R(r"/3/Grid\.bin/import"), "POST", _h_grid_import),
        (R(r"/3/Grid\.bin/([^/]+)/export"), "POST", _h_grid_export),
        (R(r"/99/Grid/([^/]+)/resume"), "POST", _h_grid_resume),
        # method/path aliases of existing handlers
        (R(r"/3/ImportFiles"), "POST", S._h_import),
        (R(r"/3/ImportFilesMulti"), "POST", E2._h_import_files_multi),
        (R(r"/3/ParseSVMLight"), "POST", E1._h_parse_svmlight),
        (R(r"/3/PartialDependence/"), "POST", E1._h_pdp_build),
        (R(r"/3/Recovery/resume"), "POST", E1._h_recovery_resume),
        (R(r"/99/DCTTransformer"), "POST", E3._h_dct),
        (R(r"/99/ImportSQLTable"), "POST", _h_import_sql_99),
        (R(r"/3/DataInfoFrame"), "POST", E2._h_data_info_frame),
        (R(r"/3/SegmentModelsBuilders/([^/]+)"), "POST",
         E2._h_segment_build),
        (R(r"/3/ComputeGram"), "GET", E1._h_compute_gram),
        (R(r"/3/Word2VecSynonyms"), "GET", E1._h_w2v_synonyms),
        (R(r"/3/Word2VecTransform"), "GET", E1._h_w2v_transform),
        # external-cluster loud-rejects
        (R(r"/3/XGBoostExecutor\.init"), "POST", _h_xgb_executor),
        (R(r"/3/XGBoostExecutor\.setup"), "POST", _h_xgb_executor),
        (R(r"/3/XGBoostExecutor\.update"), "POST", _h_xgb_executor),
        (R(r"/3/XGBoostExecutor\.getBooster"), "POST", _h_xgb_executor),
        (R(r"/3/XGBoostExecutor\.cleanup"), "POST", _h_xgb_executor),
    ]

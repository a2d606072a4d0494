"""REST long tail, part 2 — closing toward RequestServer.java's ~150-route
surface (water/api/RequestServer.java:75-80). Families here: frame
introspection (light/domain/chunks), job control, model-artifact and
model-construction routes (MakeGLMModel, GLMRegPath, DataInfoFrame),
NodePersistentStorage (Flow's clip store), segment-model builders,
Tabulate, leaderboards, metrics-from-predictions, v4 experimental info
routes, and the loud-reject Hadoop/Hive/decryption surface.

Handlers duck-type routes_ext.py's contract (h._send/_error/_params)."""

from __future__ import annotations

import json
import os
import re

import numpy as np

from h2o3_tpu_torch.core.frame import Frame, Vec, rebalance_frame
from h2o3_tpu_torch.core.jobs import Job
from h2o3_tpu_torch.core.kvstore import DKV


# ===========================================================================
# Frames family
def _h_frame_light(h, key):
    """FramesHandler.fetchLight (GET /3/Frames/{id}/light): metadata only —
    no column data, the cheap poll Flow uses. `byte_size` counts each
    column's f32 view: the JAX server counts its padded rows, the port
    pads none."""
    f = DKV.get(key)
    if not isinstance(f, Frame):
        return h._error(f"frame {key} not found", 404)
    h._send({"__meta": {"schema_type": "FramesListV3"},
             "frames": [{"frame_id": {"name": key}, "rows": f.nrows,
                         "columns": f.ncols,
                         "byte_size": f.nrows * 4 * f.ncols,
                         "is_text": False}]})


def _h_frame_col_domain(h, key, col):
    """GET /3/Frames/{id}/columns/{col}/domain (FramesHandler.columnDomain)."""
    f = DKV.get(key)
    if not isinstance(f, Frame):
        return h._error(f"frame {key} not found", 404)
    if col not in f.names:
        return h._error(f"column {col} not found", 404)
    v = f.vec(col)
    h._send({"__meta": {"schema_type": "FrameV3"},
             "domain": [v.levels()],
             "cardinality": v.cardinality if v.type == "enum" else 0})


def _h_frame_chunks(h, key):
    """GET /3/FrameChunks/{id} (FrameChunksHandler): per-shard row layout —
    the chunk-distribution view. The JAX server lists one chunk a mesh
    shard; one device holds the whole frame as one chunk of its rows."""
    f = DKV.get(key)
    if not isinstance(f, Frame):
        return h._error(f"frame {key} not found", 404)
    chunks = [{"chunk_id": 0, "node_idx": 0, "row_count": f.nrows}]
    h._send({"__meta": {"schema_type": "FrameChunksV3"},
             "frame_id": {"name": key}, "chunks": chunks})


def _h_frames_delete_all(h):
    """DELETE /3/Frames (FramesHandler.deleteAll)."""
    n = 0
    for k in list(DKV.keys()):
        if isinstance(DKV.get(k), Frame):
            DKV.remove(k)
            n += 1
    h._send({"__meta": {"schema_type": "FramesListV3"}, "deleted": n})


def _h_models_delete_all(h):
    """DELETE /3/Models (ModelsHandler.deleteAll)."""
    from h2o3_tpu_torch.models.model import ModelBase
    n = 0
    for k in list(DKV.keys()):
        if isinstance(DKV.get(k), ModelBase):
            DKV.remove(k)
            n += 1
    h._send({"__meta": {"schema_type": "ModelsV3"}, "deleted": n})


def _h_rebalance(h):
    """POST /3/Rebalance (RebalanceDataSet.java): re-shard a frame against
    the current cloud layout."""
    p = h._params()
    f = DKV.get(p.get("dataset") or p.get("frame"))
    if not isinstance(f, Frame):
        return h._error("dataset not found", 404)
    dest = p.get("dest") or DKV.make_key("rebalanced")
    out = rebalance_frame(f, key=dest)
    DKV.put(dest, out)
    h._send({"__meta": {"schema_type": "RebalanceV3"},
             "dest": {"name": dest}})


def _h_find(h):
    """GET /3/Find (FindHandler): locate a value in a frame column."""
    p = h._params()
    f = DKV.get(p.get("key") or p.get("frame"))
    if not isinstance(f, Frame):
        return h._error("frame not found", 404)
    col = p.get("column")
    if col not in f.names:
        return h._error(f"column {col} not found", 404)
    row = int(p.get("row") or 0)
    match = p.get("match")
    v = f.vec(col)
    n = f.nrows
    if v.type == "enum":
        dom = v.levels() or []
        x = v.to_numpy()[:n]
        vals = [None if xx != xx else dom[int(xx)] for xx in x]
        hits = [i for i in range(row, n) if vals[i] == match]
    elif v.type == "str":
        vals = v.host_data[:n]
        hits = [i for i in range(row, n) if vals[i] == match]
    else:
        x = v.to_numpy()[:n]
        if match is None or match in ("", "NA", "nan"):
            hits = np.nonzero(np.isnan(x[row:]))[0] + row
        else:
            hits = np.nonzero(x[row:] == float(match))[0] + row
        hits = hits.tolist()
    h._send({"__meta": {"schema_type": "FindV3"},
             "prev": -1, "next": int(hits[0]) if len(hits) else -1})


# ===========================================================================
# Jobs
def _h_job_cancel(h, key):
    """POST /3/Jobs/{id}/cancel (JobsHandler.cancel): cooperative stop."""
    j = DKV.get(key)
    if not isinstance(j, Job):
        return h._error(f"job {key} not found", 404)
    j.stop()
    h._send({"__meta": {"schema_type": "JobsV3"}, "jobs": [j.to_dict()]})


# ===========================================================================
# Model construction / artifacts
def _h_make_glm_model(h):
    """POST /3/MakeGLMModel (MakeGLMModelHandler): build a scoring-only GLM
    from an existing model's structure + user-supplied coefficients."""
    p = h._params()
    src = DKV.get(p.get("model"))
    from h2o3_tpu_torch.models.glm import H2OGeneralizedLinearEstimator
    if not isinstance(src, H2OGeneralizedLinearEstimator):
        return h._error("model must be an existing GLM", 400)
    names = p.get("names")
    names = json.loads(names) if isinstance(names, str) else names
    beta = p.get("beta")
    beta = json.loads(beta) if isinstance(beta, str) else beta
    import copy
    dst = copy.copy(src)
    dst._coefficients = dict(src._coefficients)
    for nm, b in zip(names or [], beta or []):
        if nm in dst._coefficients or nm == "Intercept":
            dst._coefficients[nm] = float(b)
    # rebuild the packed beta in feature order
    feats = src._dinfo.feature_names
    dst._beta = np.array([dst._coefficients.get(f, 0.0) for f in feats]
                         + [dst._coefficients.get("Intercept", 0.0)])
    dest = p.get("dest") or DKV.make_key("glm_custom")
    dst.key = dest
    DKV.put(dest, dst)
    h._send({"__meta": {"schema_type": "GLMModelV3"},
             "model_id": {"name": dest}})


def _h_glm_reg_path(h):
    """GET /3/GetGLMRegPath (GLMRegularizationPath): the lambda-search
    path of a trained GLM."""
    p = h._params()
    m = DKV.get(p.get("model"))
    path = getattr(m, "_lambda_path", None)
    if path is None:
        return h._error(
            "model has no regularization path (train with "
            "lambda_search=True)", 400)
    feats = m._dinfo.feature_names + ["Intercept"]
    h._send({"__meta": {"schema_type": "GLMRegularizationPathV3"},
             "lambdas": [float(lam) for lam, _ in path],
             "coefficient_names": feats,
             "coefficients": [[float(b) for b in beta]
                              for _, beta in path]})


def _h_data_info_frame(h):
    """POST /99/DataInfoFrame (hex/schemas DataInfoFrame): materialize the
    expanded (one-hot / standardized / interactions) design matrix as a
    frame — what the GLM MOJO pipeline tests consume."""
    p = h._params()
    f = DKV.get(p.get("frame"))
    if not isinstance(f, Frame):
        return h._error("frame not found", 404)
    from h2o3_tpu_torch.models.model import DataInfo
    inter = p.get("interactions")
    inter = json.loads(inter) if isinstance(inter, str) else inter
    std = str(p.get("standardize", "false")).lower() == "true"
    use_all = str(p.get("use_all", "true")).lower() == "true"
    y = p.get("response_column")
    x = [c for c in f.names if c != y]
    di = DataInfo.from_frame(f, x, y, cat_mode="onehot", standardize=std,
                             interactions=inter)
    M = di.matrix(f).cpu().numpy()
    dest = p.get("dest") or DKV.make_key("datainfo")
    out = Frame(di.feature_names,
                [Vec.from_numpy(M[:, j])
                 for j in range(M.shape[1])], key=dest)
    DKV.put(dest, out)
    h._send({"__meta": {"schema_type": "DataInfoFrameV3"},
             "result": {"name": dest},
             "num_features": di.n_features})


def _h_mojo_export(h, key):
    """POST /99/Models.mojo/{id} (ModelsHandler.exportMojo): write the
    MOJO artifact to a server-side path."""
    from h2o3_tpu_torch.models.model import ModelBase
    m = DKV.get(key)
    if not isinstance(m, ModelBase):
        return h._error(f"model {key} not found", 404)
    p = h._params()
    d = p.get("dir") or "."
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"{key}.zip")
    from h2o3_tpu_torch.genmodel import mojo as MJ
    MJ.export_mojo(m, path)
    h._send({"__meta": {"schema_type": "ModelExportV3"},
             "dir": path})


def _h_pojo_preview(h, key):
    """GET /3/Models.java/{id}/preview: first lines of the POJO source."""
    from h2o3_tpu_torch.models.model import ModelBase
    m = DKV.get(key)
    if not isinstance(m, ModelBase):
        return h._error(f"model {key} not found", 404)
    import tempfile
    from h2o3_tpu_torch.genmodel import pojo as PJ
    with tempfile.TemporaryDirectory() as td:
        src = open(PJ.export_pojo(m, td)).read()
    h._send({"__meta": {"schema_type": "ModelPreviewV3"},
             "preview": "\n".join(src.split("\n")[:64])})


# ===========================================================================
# metrics from external predictions (ModelMetricsMakerHandler)
def _h_metrics_maker(h, pred_key, act_key):
    """POST /3/ModelMetrics/predictions_frame/{p}/actuals_frame/{a}:
    compute metrics from a predictions frame + actuals frame (the
    h2o.make_metrics API)."""
    pf, af = DKV.get(pred_key), DKV.get(act_key)
    if not isinstance(pf, Frame) or not isinstance(af, Frame):
        return h._error("predictions/actuals frame not found", 404)
    import torch
    from h2o3_tpu_torch.models import metrics as M
    y = af.vecs[0]
    p = h._params()
    domain = p.get("domain")
    domain = json.loads(domain) if isinstance(domain, str) else domain
    # the frames' planes decode on the cloud's device; no padded rows,
    # so every weight is 1
    yt = torch.nan_to_num(y.as_f32())
    w = torch.ones_like(yt)
    if y.type == "enum" or domain:
        dom = domain or y.levels()
        # predictions frame: p1 column (binomial convention: last col)
        pt = torch.clamp(torch.nan_to_num(pf.vecs[-1].as_f32()), 1e-10,
                         1 - 1e-10)
        mm = M.binomial_metrics(yt, pt, w, domain=dom)
    else:
        mm = M.regression_metrics(yt, torch.nan_to_num(pf.vecs[0].as_f32()),
                                  w)
    h._send({"__meta": {"schema_type": "ModelMetricsListSchemaV3"},
             "model_metrics": [mm.to_dict()]})


# ===========================================================================
# NodePersistentStorage (Flow's named-clip store)
def _nps_dir():
    d = os.path.join(os.path.expanduser("~"), ".h2o3_tpu_torch", "nps")
    os.makedirs(d, exist_ok=True)
    return d


_NPS_SAFE = re.compile(r"[^A-Za-z0-9_.-]")


def _nps_path(categ, name=None):
    categ = _NPS_SAFE.sub("_", categ)
    d = os.path.join(_nps_dir(), categ)
    if name is None:
        return d
    return os.path.join(d, _NPS_SAFE.sub("_", name))


def _h_nps_configured(h):
    h._send({"__meta": {"schema_type": "NodePersistentStorageV3"},
             "configured": True})


def _h_nps_put(h, categ, name):
    """POST /3/NodePersistentStorage/{categ}/{name}."""
    p = h._params()
    os.makedirs(_nps_path(categ), exist_ok=True)
    with open(_nps_path(categ, name), "w") as fh:
        fh.write(p.get("value", ""))
    h._send({"__meta": {"schema_type": "NodePersistentStorageV3"},
             "category": categ, "name": name})


def _h_nps_get(h, categ, name):
    path = _nps_path(categ, name)
    if not os.path.exists(path):
        return h._error(f"NPS {categ}/{name} not found", 404)
    with open(path) as fh:
        val = fh.read()
    h._send({"__meta": {"schema_type": "NodePersistentStorageV3"},
             "category": categ, "name": name, "value": val})


def _h_nps_list(h, categ):
    d = _nps_path(categ)
    entries = []
    if os.path.isdir(d):
        for nm in sorted(os.listdir(d)):
            st = os.stat(os.path.join(d, nm))
            entries.append({"name": nm, "size": st.st_size,
                            "timestamp_millis": int(st.st_mtime * 1000)})
    h._send({"__meta": {"schema_type": "NodePersistentStorageV3"},
             "category": categ, "entries": entries})


def _h_nps_delete(h, categ, name):
    path = _nps_path(categ, name)
    if os.path.exists(path):
        os.unlink(path)
    h._send({"__meta": {"schema_type": "NodePersistentStorageV3"},
             "category": categ, "name": name})


# ===========================================================================
# Segment models (POST /99/SegmentModelsBuilders/{algo})
def _h_segment_build(h, algo):
    from h2o3_tpu_torch.models import segments as SEG
    from h2o3_tpu_torch.models import ESTIMATORS
    if algo not in ESTIMATORS:
        return h._error(f"unknown algo {algo}", 404)
    p = h._params()
    f = DKV.get(p.get("training_frame"))
    if not isinstance(f, Frame):
        return h._error("training_frame not found", 404)
    seg_cols = p.get("segment_columns") or p.get("segments")
    seg_cols = json.loads(seg_cols) if isinstance(seg_cols, str) else seg_cols
    y = p.get("response_column")
    params = {k: _coerce(v) for k, v in p.items()
              if k not in ("training_frame", "segment_columns", "segments",
                           "response_column", "dest")}
    sm = SEG.train_segments(ESTIMATORS[algo], params, seg_cols,
                            y=y, training_frame=f)
    dest = p.get("dest") or DKV.make_key("segment_models")
    DKV.put(dest, sm)
    h._send({"__meta": {"schema_type": "SegmentModelsV3"},
             "key": {"name": dest}, "n_segments": len(sm)})


def _h_segment_get(h, key):
    from h2o3_tpu_torch.models import segments as SEG
    sm = DKV.get(key)
    if not isinstance(sm, SEG.SegmentModels):
        return h._error(f"segment models {key} not found", 404)
    h._send({"__meta": {"schema_type": "SegmentModelsV3"},
             "key": {"name": key},
             "segments": [
                 {k: (v if not hasattr(v, "key") else str(v.key))
                  for k, v in row.items()} for row in sm.as_list()]})


def _coerce(v):
    if isinstance(v, str):
        low = v.lower()
        if low in ("true", "false"):
            return low == "true"
        try:
            return int(v)
        except ValueError:
            pass
        try:
            return float(v)
        except ValueError:
            pass
        if v.startswith(("[", "{")):
            try:
                return json.loads(v)
            except json.JSONDecodeError:
                pass
    return v


# ===========================================================================
# Tabulate (POST /99/Tabulate — hex/Tabulate.java: 2-D preview aggregation)
def _h_tabulate(h):
    p = h._params()
    f = DKV.get(p.get("dataset") or p.get("frame"))
    if not isinstance(f, Frame):
        return h._error("dataset not found", 404)
    cp, cr = p.get("predictor"), p.get("response")
    if cp not in f.names or cr not in f.names:
        return h._error("predictor/response column not found", 400)
    nbins = int(p.get("nbins_predictor") or 20)
    n = f.nrows
    vx, vy = f.vec(cp), f.vec(cr)
    x = vx.to_numpy()[:n]
    y = vy.to_numpy()[:n]
    ok = ~(np.isnan(x) | np.isnan(y))
    x, y = x[ok], y[ok]
    if vx.type == "enum":
        edges = None
        codes = x.astype(int)
        labels = vx.levels()
    else:
        lo, hi = float(x.min()), float(x.max())
        edges = np.linspace(lo, hi, nbins + 1)
        codes = np.clip(np.digitize(x, edges) - 1, 0, nbins - 1)
        labels = [f"[{edges[i]:.4g},{edges[i+1]:.4g})"
                  for i in range(nbins)]
    counts = np.bincount(codes, minlength=len(labels)).astype(float)
    sums = np.bincount(codes, weights=y, minlength=len(labels))
    means = np.divide(sums, counts, out=np.zeros_like(sums),
                      where=counts > 0)
    h._send({"__meta": {"schema_type": "TabulateV3"},
             "count_table": {"labels": list(labels),
                             "counts": counts.tolist()},
             "response_table": {"labels": list(labels),
                                "means": means.tolist()}})


# ===========================================================================
# Leaderboards (GET /99/Leaderboards[/{automl_id}])
def _h_leaderboards(h, aml_id=None):
    from h2o3_tpu_torch.automl.automl import H2OAutoML
    boards = []
    for k in DKV.keys():
        o = DKV.get(k)
        if isinstance(o, H2OAutoML) and (aml_id is None or k == aml_id):
            lb = o.leaderboard_obj
            boards.append({"project_name": getattr(o, "project_name", k),
                           "models": lb.as_list() if lb is not None
                           else []})
    if aml_id is not None and not boards:
        return h._error(f"AutoML {aml_id} not found", 404)
    h._send({"__meta": {"schema_type": "LeaderboardsV99"},
             "leaderboards": boards})


# ===========================================================================
# import/infra long tail
def _h_import_files_multi(h):
    """GET /3/ImportFilesMulti (ImportFilesMultiHandler): import a list of
    paths/folders through the distributed parse path."""
    p = h._params()
    paths = p.get("paths") or p.get("path")
    paths = json.loads(paths) if isinstance(paths, str) and \
        paths.startswith("[") else paths
    from h2o3_tpu_torch.io import dparse
    try:
        files = dparse.expand_paths(paths)
    except FileNotFoundError as ex:
        return h._error(str(ex), 404)
    h._send({"__meta": {"schema_type": "ImportFilesMultiV3"},
             "files": files, "destination_frames": files})


def _h_decryption_setup(h):
    """POST /3/DecryptionSetup: encrypted-ingest keystore registration —
    fidelity loud-reject (water/parser/DecryptionTool.java)."""
    h._error("encrypted dataset ingest (DecryptionTool keystores) is not "
             "implemented in h2o3-tpu-torch; decrypt files before import",
             501)


def _h_import_hive(h):
    h._error("Hive table import requires a Hadoop/Hive deployment "
             "(h2o-hive); use JDBC-staged CSV/Parquet exports instead", 501)


def _h_export_hive(h):
    h._error("Hive table export requires a Hadoop/Hive deployment "
             "(h2o-hive); export to CSV/Parquet via /3/Frames/{id}/export "
             "instead", 501)


def _h_persist_s3(h):
    """POST /3/PersistS3 (PersistS3Handler): register S3 credentials for
    the URI loader."""
    p = h._params()
    from h2o3_tpu_torch.utils import config as _cfg
    if p.get("secret_key_id"):
        _cfg.set_property("persist.s3.access_key", p["secret_key_id"])
    if p.get("secret_access_key"):
        _cfg.set_property("persist.s3.secret_key", p["secret_access_key"])
    if p.get("session_token"):
        _cfg.set_property("persist.s3.session_token", p["session_token"])
    h._send({"__meta": {"schema_type": "PersistS3V3"}, "status": "ok"})


def _h_steam_instances(h):
    """GET /3/steam/instances: Enterprise-Steam discovery stub — reports
    this cloud as the only instance (SteamHandler parity surface)."""
    import h2o3_tpu_torch
    info = h2o3_tpu_torch.cluster_info()
    h._send({"__meta": {"schema_type": "SteamV3"},
             "instances": [{"name": info["cloud_name"],
                            "status": "running",
                            "size": info["cloud_size"]}]})


def _h_kill_minus3(h):
    """GET /3/KillMinus3 (the SIGQUIT thread-dump analog): dump all stacks
    to the server log)."""
    import sys
    import threading
    import traceback
    from h2o3_tpu_torch.utils import log as _log
    frames = sys._current_frames()
    for t in threading.enumerate():
        fr = frames.get(t.ident)
        if fr is not None:
            _log.info(f"--- thread {t.name} ---\n"
                      + "".join(traceback.format_stack(fr)))
    h._send({"__meta": {"schema_type": "KillMinus3V3"}, "dumped": True})


# ===========================================================================
# metadata / rapids / sessions / v4
def _h_metadata_schemas(h, name=None):
    """GET /3/Metadata/schemas[/{name}] (SchemaServer metadata)."""
    schemas = sorted({"CloudV3", "FrameV3", "FramesListV3", "JobsV3",
                      "ModelsV3", "ModelMetricsListSchemaV3", "RapidsV99",
                      "GridSearchV99", "AutoMLV99", "LeaderboardsV99",
                      "ParseV3", "ParseSetupV3", "SegmentModelsV3",
                      "TabulateV3", "H2OError"})
    if name:
        if name not in schemas:
            return h._error(f"schema {name} not found", 404)
        h._send({"__meta": {"schema_type": "MetadataV3"},
                 "schemas": [{"name": name, "version": 3}]})
    else:
        h._send({"__meta": {"schema_type": "MetadataV3"},
                 "schemas": [{"name": s, "version": 3} for s in schemas]})


def _h_metadata_endpoint(h, idx):
    """GET /3/Metadata/endpoints/{num-or-name}: by list index or by the
    handler name (the reference also resolves by route name)."""
    from h2o3_tpu_torch.api import server as _srv
    if idx.isdigit():
        i = int(idx)
        if not (0 <= i < len(_srv.ROUTES)):
            return h._error(f"endpoint {i} out of range", 404)
    else:
        hits = [k for k, (p0, m0, f0) in enumerate(_srv.ROUTES)
                if f0.__name__.lstrip("_") == idx.lstrip("_")]
        if not hits:
            return h._error(f"endpoint {idx} not found", 404)
        i = hits[0]
    pat, m, fn = _srv.ROUTES[i]
    h._send({"__meta": {"schema_type": "EndpointV3"},
             "url_pattern": pat.pattern, "http_method": m,
             "handler_method": fn.__name__,
             "summary": (fn.__doc__ or "").strip().split("\n")[0]})


def _h_rapids_help(h):
    """GET /99/Rapids/help: the registered primitive table (AstRoot doc)."""
    from h2o3_tpu_torch.rapids import rapids as _rap
    prims = sorted(_rap.PRIMS.keys())
    h._send({"__meta": {"schema_type": "RapidsHelpV99"},
             "syntax": prims, "n_prims": len(prims)})


def _h_session_get(h, sid):
    h._send({"__meta": {"schema_type": "SessionIdV4"},
             "session_key": sid})


def _h_models_info_v4(h):
    """GET /4/modelsinfo (the v4 experimental API's model catalog)."""
    from h2o3_tpu_torch.models import ESTIMATORS
    h._send({"__meta": {"schema_type": "ModelsInfoV4"},
             "models": [{"algo": a, "maturity": "stable"}
                        for a in sorted(ESTIMATORS)]})


def _h_frames_v4(h):
    """GET /4/frames: the v4 lightweight frame listing."""
    out = [{"frame_id": {"name": k}, "rows": o.nrows, "columns": o.ncols}
           for k in DKV.keys()
           if isinstance((o := DKV.get(k)), Frame)]
    h._send({"__meta": {"schema_type": "FramesV4"}, "frames": out})


def _h_models_v4(h):
    """GET /4/models: the v4 lightweight model listing."""
    from h2o3_tpu_torch.models.model import ModelBase
    out = [{"model_id": {"name": k}, "algo": o.algo}
           for k in DKV.keys()
           if isinstance((o := DKV.get(k)), ModelBase)]
    h._send({"__meta": {"schema_type": "ModelsV4"}, "models": out})


def _h_automl_list(h):
    """GET /99/AutoML: every AutoML run in the registry."""
    from h2o3_tpu_torch.automl.automl import H2OAutoML
    out = [{"automl_id": {"name": k}}
           for k in DKV.keys() if isinstance(DKV.get(k), H2OAutoML)]
    h._send({"__meta": {"schema_type": "AutoMLsV99"}, "automls": out})


def _h_segment_models_list(h):
    """GET /99/SegmentModels: registry listing."""
    from h2o3_tpu_torch.models import segments as SEG
    out = [{"key": {"name": k}, "n_segments": len(DKV.get(k))}
           for k in DKV.keys()
           if isinstance(DKV.get(k), SEG.SegmentModels)]
    h._send({"__meta": {"schema_type": "SegmentModelsListV99"},
             "segment_models": out})


def _h_drop_duplicates(h):
    """POST /3/DropDuplicates (DropDuplicateRowsHandler): de-dup rows by
    the chosen comparison columns, keeping the first (or last) of each
    set of equal rows in row order; NAs compare equal, as in pandas'
    drop_duplicates, which the JAX server calls (the port's hosts may
    have no pandas)."""
    p = h._params()
    f = DKV.get(p.get("dataset") or p.get("frame"))
    if not isinstance(f, Frame):
        return h._error("dataset not found", 404)
    cols = p.get("compare_columns") or p.get("columns")
    cols = json.loads(cols) if isinstance(cols, str) else (cols or f.names)
    keep = str(p.get("keep", "first")).lower()
    values = {c: _col_as_values(f, c) for c in f.names}

    def norm(x):
        if x is None or (isinstance(x, float) and x != x):
            return None       # every NA is one value
        return x.item() if isinstance(x, np.generic) else x

    rows = range(f.nrows) if keep != "last" else range(f.nrows - 1, -1, -1)
    seen: dict = {}
    for i in rows:
        seen.setdefault(tuple(norm(values[c][i]) for c in cols), i)
    idx = np.sort(np.fromiter(seen.values(), np.int64, len(seen)))
    dest = p.get("dest") or DKV.make_key("dedup")
    cols_out = {}
    for c in f.names:
        a = values[c][idx]
        if f.vec(c).type in ("enum", "str"):
            a = np.asarray(a, object)
        cols_out[c] = a
    out = Frame.from_dict(cols_out, key=dest)
    DKV.put(dest, out)
    h._send({"__meta": {"schema_type": "DropDuplicatesV3"},
             "result": {"name": dest}, "rows": out.nrows})


def _col_as_values(f, c):
    v = f.vec(c)
    if v.type == "enum":
        dom = v.levels() or []
        return np.asarray([None if x != x else dom[int(x)]
                           for x in v.to_numpy()], object)
    if v.type == "str":
        return v.host_data
    return v.to_numpy()


def _h_permutation_varimp(h):
    """POST /3/PermutationVarImp (PermutationVarImpHandler): permutation
    feature importance of a model on a frame."""
    from h2o3_tpu_torch.models.model import ModelBase
    p = h._params()
    m = DKV.get(p.get("model"))
    f = DKV.get(p.get("frame"))
    if not isinstance(m, ModelBase) or not isinstance(f, Frame):
        return h._error("model/frame not found", 404)
    from h2o3_tpu_torch.explain_data import permutation_varimp
    rows = permutation_varimp(m, f,
                              metric=p.get("metric", "AUTO"),
                              n_repeats=int(p.get("n_repeats") or 1),
                              seed=int(p.get("seed") or 42))
    h._send({"__meta": {"schema_type": "PermutationVarImpV3"},
             "varimp": rows})


# ===========================================================================
def build_routes():
    R = re.compile
    return [
        (R(r"/3/Frames/([^/]+)/light"), "GET", _h_frame_light),
        (R(r"/3/Frames/([^/]+)/columns/([^/]+)/domain"), "GET",
         _h_frame_col_domain),
        (R(r"/3/FrameChunks/([^/]+)"), "GET", _h_frame_chunks),
        (R(r"/3/Frames"), "DELETE", _h_frames_delete_all),
        (R(r"/3/Models"), "DELETE", _h_models_delete_all),
        (R(r"/3/Rebalance"), "POST", _h_rebalance),
        (R(r"/3/Find"), "GET", _h_find),
        (R(r"/3/Jobs/([^/]+)/cancel"), "POST", _h_job_cancel),
        (R(r"/3/MakeGLMModel"), "POST", _h_make_glm_model),
        (R(r"/3/GetGLMRegPath"), "GET", _h_glm_reg_path),
        (R(r"/99/DataInfoFrame"), "POST", _h_data_info_frame),
        (R(r"/99/Models\.mojo/([^/]+)"), "POST", _h_mojo_export),
        (R(r"/3/Models\.mojo/([^/]+)"), "GET",
         _alias("/3/Models/{}/mojo")),
        (R(r"/3/Models\.java/([^/]+)/preview"), "GET", _h_pojo_preview),
        (R(r"/3/ModelMetrics/predictions_frame/([^/]+)/actuals_frame/"
           r"([^/]+)"), "POST", _h_metrics_maker),
        (R(r"/3/NodePersistentStorage/configured"), "GET",
         _h_nps_configured),
        (R(r"/3/NodePersistentStorage/([^/]+)/([^/]+)"), "POST",
         _h_nps_put),
        (R(r"/3/NodePersistentStorage/([^/]+)/([^/]+)"), "GET", _h_nps_get),
        (R(r"/3/NodePersistentStorage/([^/]+)"), "GET", _h_nps_list),
        (R(r"/3/NodePersistentStorage/([^/]+)/([^/]+)"), "DELETE",
         _h_nps_delete),
        (R(r"/99/SegmentModelsBuilders/([^/]+)"), "POST", _h_segment_build),
        (R(r"/99/SegmentModels/([^/]+)"), "GET", _h_segment_get),
        (R(r"/99/Tabulate"), "POST", _h_tabulate),
        (R(r"/99/Leaderboards"), "GET", _h_leaderboards),
        (R(r"/99/Leaderboards/([^/]+)"), "GET", _h_leaderboards),
        (R(r"/3/ImportFilesMulti"), "GET", _h_import_files_multi),
        (R(r"/3/DecryptionSetup"), "POST", _h_decryption_setup),
        (R(r"/3/ImportHiveTable"), "POST", _h_import_hive),
        (R(r"/3/SaveToHiveTable"), "POST", _h_export_hive),
        (R(r"/3/PersistS3"), "POST", _h_persist_s3),
        (R(r"/3/steam/instances"), "GET", _h_steam_instances),
        (R(r"/3/KillMinus3"), "GET", _h_kill_minus3),
        (R(r"/3/Metadata/schemas"), "GET", _h_metadata_schemas),
        (R(r"/3/Metadata/schemas/([^/]+)"), "GET", _h_metadata_schemas),
        (R(r"/3/Metadata/endpoints/([^/]+)"), "GET", _h_metadata_endpoint),
        (R(r"/99/Rapids/help"), "GET", _h_rapids_help),
        (R(r"/4/sessions/([^/]+)"), "GET", _h_session_get),
        (R(r"/4/modelsinfo"), "GET", _h_models_info_v4),
        (R(r"/4/frames"), "GET", _h_frames_v4),
        (R(r"/4/models"), "GET", _h_models_v4),
        (R(r"/99/AutoML"), "GET", _h_automl_list),
        (R(r"/99/SegmentModels"), "GET", _h_segment_models_list),
        (R(r"/3/DropDuplicates"), "POST", _h_drop_duplicates),
        (R(r"/3/PermutationVarImp"), "POST", _h_permutation_varimp),
    ]


def _alias(target_fmt):
    """Delegate an alias pattern to the canonical handler via the route
    table (reference registers several spelling variants per endpoint)."""
    def handler(h, *groups):
        from h2o3_tpu_torch.api import server as _srv
        path = target_fmt.format(*groups)
        for pat, m, fn in _srv.ROUTES:
            if m == "GET" and pat.fullmatch(path):
                return fn(h, *pat.fullmatch(path).groups())
        h._error(f"alias target {path} unresolved", 500)
    handler.__doc__ = f"alias of GET {target_fmt}"
    return handler

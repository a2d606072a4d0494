"""Extended REST routes — the RequestServer.java surface beyond the core
(water/api/RequestServer.java:76 registers ~150 routes; this module carries
the frame-munging, diagnostics, artifact-download, validation and codegen
routes that the core server.py doesn't).

Handlers receive the live request handler `h` (duck-typed: _send/_error/
_params) plus regex groups, exactly like server.py's own handlers.
"""

from __future__ import annotations

import json
import os
import re
import time

import numpy as np

from h2o3_tpu_torch.core.frame import Frame, Vec
from h2o3_tpu_torch.core.jobs import Job
from h2o3_tpu_torch.core.kvstore import DKV

_T0 = time.time()


def _host(x) -> np.ndarray:
    """A model array on the host: a tensor (perhaps on the card) or an
    array-like."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# ===========================================================================
# diagnostics
def _h_ping(h):
    """water/api/PingHandler: cloud liveness + uptime."""
    h._send({"__meta": {"schema_type": "PingV3"},
             "cloud_uptime_millis": int((time.time() - _T0) * 1000),
             "cloud_healthy": True})


def _h_capabilities(h, categ=None):
    """CapabilitiesHandler: registered extensions by category."""
    caps = [{"name": "Algos", "version": "3"},
            {"name": "AutoML", "version": "99"},
            {"name": "Core V3", "version": "3"},
            {"name": "Core V4", "version": "4"},
            {"name": "Rapids", "version": "99"},
            {"name": "CUDA", "version": "1"}]
    if categ:
        caps = [c for c in caps if c["name"].lower().startswith(categ.lower())]
    h._send({"__meta": {"schema_type": "CapabilitiesV3"},
             "capabilities": caps})


# (GET /3/JStack lives in api/server._h_jstack: all-thread stacks per
# node, plus the watchdog's stalled-operation report.)


def _h_network_test(h):
    """NetworkTestHandler (water/init/NetworkBench.java analog). The JAX
    server times a round of mesh collectives; one device has no
    collective to time, so this times a sum reduction of each size on
    the cloud's device (selfbench.network_bench: CUDA events on the card)
    and says so in `collective` ("none") and `op` ("device_reduce")."""
    from h2o3_tpu_torch.parallel import mesh as MESH
    from h2o3_tpu_torch.utils import selfbench
    cl = MESH.cloud()
    results = [{"bytes": r["payload_bytes_per_device"],
                "collective": r["collective"], "op": r["op"],
                "micros": r["latency_us"]}
               for r in selfbench.network_bench(
                   sizes=(1 << 10, 1 << 16, 1 << 20), repeats=1)]
    h._send({"__meta": {"schema_type": "NetworkTestV3"},
             "nodes": cl.n_devices, "results": results})


def _h_water_meter(h, node=None):
    """WaterMeterCpuTicksHandler: per-core cpu ticks."""
    try:
        la = os.getloadavg()
    except OSError:
        la = (0.0, 0.0, 0.0)
    ncpu = os.cpu_count() or 1
    h._send({"__meta": {"schema_type": "WaterMeterCpuTicksV3"},
             "cpu_ticks": [[la[0], la[1], la[2], 0.0]] * ncpu})


def _h_log_and_echo(h):
    from h2o3_tpu_torch.utils import log as _log
    p = h._params()
    msg = p.get("message", "")
    _log.info(f"LogAndEcho: {msg}")
    h._send({"__meta": {"schema_type": "LogAndEchoV3"}, "message": msg})


def _h_gc(h):
    """GarbageCollectHandler: host GC + device buffer stats.

    The caching allocator's free blocks go back to the card after the
    host GC; the card's allocated bytes before and after
    (torch.cuda.memory_allocated; None on a CPU cloud). The JAX server
    counts jax.live_arrays() instead."""
    import gc

    import torch
    from h2o3_tpu_torch.parallel import mesh as MESH
    dev = MESH.cloud().device
    cuda = dev.type == "cuda"
    before = torch.cuda.memory_allocated(dev) if cuda else None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    h._send({"__meta": {"schema_type": "GarbageCollectV3"},
             "device_bytes_before": before,
             "device_bytes_after": (torch.cuda.memory_allocated(dev)
                                    if cuda else None)})


def _h_unlock(h):
    """UnlockKeysHandler: single-controller registry has no write locks to
    break — reply OK for client compatibility."""
    h._send({"__meta": {"schema_type": "UnlockKeysV3"}})


def _h_dkv_remove(h, key):
    DKV.remove(key)
    h._send({"__meta": {"schema_type": "RemoveV3"}})


def _h_dkv_remove_all(h):
    p = h._params()
    retained = p.get("retained_keys")
    keep = set(json.loads(retained)) if retained else set()
    for k in list(DKV.keys()):
        if k not in keep:
            DKV.remove(k)
    h._send({"__meta": {"schema_type": "RemoveAllV3"}})


def _h_typeahead(h):
    """TypeaheadHandler: filesystem path completion for the import UI."""
    p = h._params()
    src = p.get("src") or "/"
    limit = int(p.get("limit") or 100)
    base = os.path.dirname(src) if not os.path.isdir(src) else src
    prefix = "" if os.path.isdir(src) else os.path.basename(src)
    matches = []
    try:
        for name in sorted(os.listdir(base or "/")):
            if name.startswith(prefix):
                matches.append(os.path.join(base, name))
            if len(matches) >= limit:
                break
    except OSError:
        pass
    h._send({"__meta": {"schema_type": "TypeaheadV3"}, "matches": matches})


# ===========================================================================
# sessions (v4)
_SID_COUNTER = [0]


def _h_sessions_post(h):
    from h2o3_tpu_torch.rapids import Session
    from h2o3_tpu_torch.api import server as _srv
    # monotonic counter only — a deleted session's id is never reissued
    # within a cloud lifetime, and the id is deterministic (a replayed
    # POST must mint the same sid on every host)
    _SID_COUNTER[0] += 1
    sid = f"_sid{_SID_COUNTER[0]}"
    _srv._sessions[sid] = Session(sid)
    h._send({"__meta": {"schema_type": "SessionIdV4"}, "session_key": sid})


def _h_sessions_delete(h, sid):
    from h2o3_tpu_torch.api import server as _srv
    s = _srv._sessions.pop(sid, None)
    if s is not None:
        s.end()
    h._send({"__meta": {"schema_type": "SessionIdV4"}, "session_key": sid})


# ===========================================================================
# frame munging (CreateFrame / SplitFrame / Interaction / MissingInserter)
def _h_create_frame(h):
    """CreateFrameHandler (hex/createframe): random frame generation."""
    p = h._params()
    rows = int(p.get("rows") or 10000)
    cols = int(p.get("cols") or 10)
    seed = int(p.get("seed") or -1)
    cat_frac = float(p.get("categorical_fraction") or 0.2)
    int_frac = float(p.get("integer_fraction") or 0.2)
    bin_frac = float(p.get("binary_fraction") or 0.1)
    factors = int(p.get("factors") or 100)
    real_range = float(p.get("real_range") or 100.0)
    missing = float(p.get("missing_fraction") or 0.0)
    has_resp = str(p.get("has_response", "false")).lower() == "true"
    dest = p.get("dest") or p.get("destination_frame") or DKV.make_key("cf")
    rng = np.random.default_rng(seed if seed > 0 else None)
    n_cat = int(cols * cat_frac)
    n_int = int(cols * int_frac)
    n_bin = int(cols * bin_frac)
    n_real = max(0, cols - n_cat - n_int - n_bin)
    names, vecs = [], []

    def maybe_na(a):
        if missing > 0:
            a = a.astype(np.float64)
            a[rng.random(rows) < missing] = np.nan
        return a

    j = 0
    for _ in range(n_real):
        names.append(f"C{j+1}")
        vecs.append(Vec.from_numpy(
            maybe_na(rng.uniform(-real_range, real_range, rows))))
        j += 1
    for _ in range(n_int):
        names.append(f"C{j+1}")
        vecs.append(Vec.from_numpy(
            maybe_na(rng.integers(-100, 100, rows).astype(np.float64))))
        j += 1
    for _ in range(n_bin):
        names.append(f"C{j+1}")
        vecs.append(Vec.from_numpy(
            maybe_na((rng.random(rows) < 0.5).astype(np.float64))))
        j += 1
    for _ in range(n_cat):
        names.append(f"C{j+1}")
        lv = [f"c{int(v)}" for v in range(factors)]
        codes = rng.integers(0, factors, rows)
        vecs.append(Vec._from_strings(          # strings default to enum
            np.asarray([lv[c] for c in codes], object)))
        j += 1
    if has_resp:
        names.append("response")
        vecs.append(Vec.from_numpy(rng.normal(0, 1, rows)))
    f = Frame(names, vecs, key=dest)
    DKV.put(dest, f)
    job = Job(description="CreateFrame", dest=dest)
    job.start(lambda job: f)
    h._send({"__meta": {"schema_type": "CreateFrameV3"},
             "job": job.to_dict(), "dest": {"name": dest}})


def _h_split_frame(h):
    """SplitFrameHandler (hex/splitframe/ShuffleSplitFrame.java)."""
    p = h._params()
    f = DKV.get(p.get("dataset"))
    if not isinstance(f, Frame):
        return h._error("dataset not found", 404)
    ratios = p.get("ratios")
    ratios = json.loads(ratios) if isinstance(ratios, str) else ratios
    dests = p.get("destination_frames")
    if isinstance(dests, str):
        dests = json.loads(dests)
    seed = int(p.get("seed") or 1)
    n = f.nrows
    rng = np.random.default_rng(seed)
    u = rng.random(n)
    edges = np.cumsum(np.asarray(list(ratios) + [1.0 - sum(ratios)]))
    dests = dests or [f"{f.key}_part{i}" for i in range(len(edges))]
    out = []
    prev = 0.0
    for i, e in enumerate(edges):
        mask = (u >= prev) & (u < e)
        prev = e
        idx = np.nonzero(mask)[0]
        cols = {}
        for nm in f.names:
            v = f.vec(nm)
            a = v.to_numpy()[:n][idx]
            if v.type == "enum":
                dom = v.levels() or []
                a = np.asarray(
                    [dom[int(x)] if x == x and int(x) < len(dom) else None
                     for x in a], object)
            cols[nm] = a
        sub = Frame.from_dict(cols, key=dests[i])
        DKV.put(dests[i], sub)
        out.append(dests[i])
    h._send({"__meta": {"schema_type": "SplitFrameV3"},
             "destination_frames": [{"name": d} for d in out]})


def _h_interaction(h):
    """InteractionHandler (hex/Interaction.java): pairwise categorical
    interaction column."""
    p = h._params()
    f = DKV.get(p.get("source_frame"))
    if not isinstance(f, Frame):
        return h._error("source_frame not found", 404)
    factors = p.get("factor_columns")
    factors = json.loads(factors) if isinstance(factors, str) else factors
    max_factors = int(p.get("max_factors") or 100)
    dest = p.get("dest") or DKV.make_key("interaction")
    n = f.nrows
    vals = []
    for c in factors:
        v = f.vec(c)
        dom = v.levels() or []
        codes = v.to_numpy()[:n]
        vals.append([dom[int(x)] if x == x and int(x) < len(dom) else "NA"
                     for x in codes])
    combo = ["_".join(parts) for parts in zip(*vals)]
    # cap cardinality like the reference (top max_factors by frequency)
    from collections import Counter
    top = {k for k, _ in Counter(combo).most_common(max_factors)}
    combo = [c if c in top else "other" for c in combo]
    vec = Vec._from_strings(np.asarray(combo, object), force_type="enum")
    out = Frame(["_".join(factors)], [vec], key=dest)
    DKV.put(dest, out)
    job = Job(description="Interaction", dest=dest)
    job.start(lambda job: out)
    h._send({"__meta": {"schema_type": "InteractionV3"},
             "job": job.to_dict(), "dest": {"name": dest}})


def _h_missing_inserter(h):
    """MissingInserterHandler: inject NAs at a fraction (test utility the
    reference ships as a REST route)."""
    p = h._params()
    f = DKV.get(p.get("dataset"))
    if not isinstance(f, Frame):
        return h._error("dataset not found", 404)
    fraction = float(p.get("fraction") or 0.1)
    seed = int(p.get("seed") or 1)
    rng = np.random.default_rng(seed)
    n = f.nrows
    vecs, names = [], []
    for nm in f.names:
        v = f.vec(nm)
        if v.type == "str":
            vecs.append(v)
            names.append(nm)
            continue
        a = v.to_numpy()[:n].astype(np.float64)
        a[rng.random(n) < fraction] = np.nan
        nv = Vec.from_numpy(a)
        if v.type == "enum":
            nv.type = "enum"
            nv.domain = np.asarray(v.levels(), object)
        vecs.append(nv)
        names.append(nm)
    out = Frame(names, vecs, key=f.key)
    DKV.put(f.key, out)
    job = Job(description="MissingInserter", dest=f.key)
    job.start(lambda job: out)
    h._send({"__meta": {"schema_type": "MissingInserterV3"},
             "job": job.to_dict()})


# ===========================================================================
# frame details / export / download
def _frame_csv(f: Frame) -> bytes:
    n = f.nrows
    cols = []
    for nm in f.names:
        v = f.vec(nm)
        if v.type in ("str",):
            cols.append(np.asarray(v.to_numpy()[:n], object))
        elif v.type == "enum":
            dom = v.levels() or []
            codes = v.to_numpy()[:n]
            cols.append(np.asarray(
                [dom[int(x)] if x == x and int(x) < len(dom) else ""
                 for x in codes], object))
        else:
            cols.append(v.to_numpy()[:n])
    def esc(s: str) -> str:
        # RFC-4180 quoting: values with separators/quotes/newlines must be
        # quoted and inner quotes doubled, or the file re-imports shifted
        if any(ch in s for ch in ",\"\n\r"):
            return '"' + s.replace('"', '""') + '"'
        return s

    lines = [",".join(f'"{nm}"' for nm in f.names)]
    for i in range(n):
        row = []
        for c in cols:
            x = c[i]
            if isinstance(x, float) and x != x:
                row.append("")
            elif isinstance(x, str):
                row.append(esc(x))
            else:
                row.append(str(x))
        lines.append(",".join(row))
    return ("\n".join(lines) + "\n").encode()


def _send_bytes(h, body: bytes, ctype="application/octet-stream",
                filename=None):
    h.send_response(200)
    h.send_header("Content-Type", ctype)
    if filename:
        h.send_header("Content-Disposition",
                      f'attachment; filename="{filename}"')
    h.send_header("Content-Length", str(len(body)))
    h.end_headers()
    if getattr(h, "command", "") != "HEAD":      # RFC 9110: no body
        h.wfile.write(body)


def _h_download_dataset(h):
    """DownloadDataHandler: frame as CSV."""
    p = h._params()
    f = DKV.get(p.get("frame_id"))
    if not isinstance(f, Frame):
        return h._error("frame_id not found", 404)
    _send_bytes(h, _frame_csv(f), "text/csv", f"{f.key}.csv")


def _h_frame_summary(h, fid):
    f = DKV.get(fid)
    if not isinstance(f, Frame):
        return h._error(f"frame {fid} not found", 404)
    from h2o3_tpu_torch.api.server import _frame_schema
    h._send({"__meta": {"schema_type": "FrameSummaryV3"},
             "frames": [_frame_schema(f, with_summary=True)]})


def _h_frame_columns(h, fid):
    f = DKV.get(fid)
    if not isinstance(f, Frame):
        return h._error(f"frame {fid} not found", 404)
    h._send({"__meta": {"schema_type": "FrameColumnsV3"},
             "columns": [{"label": n, "type": v.type,
                          "domain": v.levels()}
                         for n, v in zip(f.names, f.vecs)]})


def _h_frame_col_summary(h, fid, col):
    f = DKV.get(fid)
    if not isinstance(f, Frame):
        return h._error(f"frame {fid} not found", 404)
    if col not in f.names:
        return h._error(f"column {col} not found", 404)
    s = f.summary()
    h._send({"__meta": {"schema_type": "FrameColumnSummaryV3"},
             "column": col, "summary": s.get(col, {})})


def _h_frame_export(h, fid):
    """FramesHandler.export: persist a frame to a URI."""
    p = h._params()
    f = DKV.get(fid)
    if not isinstance(f, Frame):
        return h._error(f"frame {fid} not found", 404)
    path = p.get("path")
    job = Job(description=f"Export {fid}", dest=path)

    def work(job):
        if path.endswith(".hex"):
            from h2o3_tpu_torch.io.persist import export_frame
            export_frame(f, path)
        else:
            from h2o3_tpu_torch.io import uri as _uri
            if _uri.is_remote(path):
                import tempfile
                with tempfile.NamedTemporaryFile(delete=False) as tf:
                    tf.write(_frame_csv(f))
                _uri.push_from_local(tf.name, path)
                os.unlink(tf.name)
            else:
                with open(path, "wb") as fh:
                    fh.write(_frame_csv(f))
        return path

    job.start(work)
    h._send({"__meta": {"schema_type": "FramesV3"}, "job": job.to_dict()})


# ===========================================================================
# model builders: parameter metadata + validation
def _param_schema(cls):
    """Per-algo parameter metadata (ModelParameterSchemaV3 analog), built
    live from the estimator's defaults — the codegen input."""
    out = []
    merged = {}
    merged.update(getattr(cls, "_COMMON", {}))
    merged.update(cls._defaults)
    for name, default in sorted(merged.items()):
        t = ("boolean" if isinstance(default, bool) else
             "int" if isinstance(default, int) else
             "double" if isinstance(default, float) else
             "string[]" if isinstance(default, (list, tuple)) else
             "string")
        out.append({"name": name, "default_value": default, "type": t,
                    "level": "critical" if name in
                    ("ntrees", "max_depth", "learn_rate", "alpha", "lambda_",
                     "k", "epochs", "family") else "secondary"})
    return out


def _h_builder_info(h, algo):
    from h2o3_tpu_torch.models import ESTIMATORS
    cls = ESTIMATORS.get(algo)
    if cls is None:
        return h._error(f"unknown algo {algo}", 404)
    h._send({"__meta": {"schema_type": "ModelBuildersV3"},
             "model_builders": {algo: {
                 "algo": algo, "algo_full_name": cls.__name__,
                 "visibility": "Stable",
                 "parameters": _param_schema(cls)}}})


def _h_validate_params(h, algo):
    """POST /3/ModelBuilders/{algo}/parameters — the validation surface
    (ModelBuilderHandler.validate_parameters): type-check + unknown-param
    detection WITHOUT training."""
    from h2o3_tpu_torch.models import ESTIMATORS
    from h2o3_tpu_torch.api.server import _coerce_param
    cls = ESTIMATORS.get(algo)
    if cls is None:
        return h._error(f"unknown algo {algo}", 404)
    p = h._params()
    p.pop("_rest_version", None)
    messages = []
    known = set(cls._defaults) | set(getattr(cls, "_COMMON", ()))
    special = {"training_frame", "validation_frame", "response_column", "x",
               "model_id", "ignored_columns"}
    for k, v in p.items():
        if k in special:
            if k == "training_frame" and not isinstance(DKV.get(v), Frame):
                messages.append({"message_type": "ERRR", "field_name": k,
                                 "message": f"frame {v} not found"})
            continue
        if k not in known:
            messages.append({"message_type": "ERRR", "field_name": k,
                             "message": f"unknown parameter {k}"})
            continue
        default = cls._defaults.get(k)
        cv = _coerce_param(v)
        if isinstance(default, bool) and not isinstance(cv, bool):
            messages.append({"message_type": "ERRR", "field_name": k,
                             "message": "expected boolean"})
        elif isinstance(default, (int, float)) and not isinstance(
                cv, (int, float, bool)) and default is not None:
            messages.append({"message_type": "ERRR", "field_name": k,
                             "message": "expected numeric"})
    errs = [m for m in messages if m["message_type"] == "ERRR"]
    h._send({"__meta": {"schema_type": "ModelParametersSchemaV3"},
             "messages": messages,
             "error_count": len(errs),
             "validation_error_count": len(errs)})


# ===========================================================================
# artifacts: mojo / pojo / binary save-load; tree introspection
def _h_model_mojo(h, mid):
    m = DKV.get(mid)
    if m is None:
        return h._error(f"model {mid} not found", 404)
    import tempfile
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, f"{mid}.zip")
        m.download_mojo(path)
        with open(path, "rb") as fh:
            body = fh.read()
    _send_bytes(h, body, "application/zip", f"{mid}.zip")


def _h_model_pojo(h, mid):
    m = DKV.get(mid)
    if m is None:
        return h._error(f"model {mid} not found", 404)
    import tempfile
    from h2o3_tpu_torch.genmodel.pojo import export_pojo
    with tempfile.TemporaryDirectory() as td:
        path = export_pojo(m, os.path.join(td, f"{mid}.java"))
        with open(path) as fh:
            src = fh.read()
    _send_bytes(h, src.encode(), "text/x-java-source", f"{mid}.java")


def _h_model_save_bin(h, mid):
    p = h._params()
    m = DKV.get(mid)
    if m is None:
        return h._error(f"model {mid} not found", 404)
    path = p.get("dir") or p.get("path")
    from h2o3_tpu_torch.genmodel.mojo import save_model
    dest = os.path.join(path, mid) if os.path.isdir(path) else path
    save_model(m, dest)
    h._send({"__meta": {"schema_type": "ModelsV3"}, "dir": dest})


def _h_model_load_bin(h):
    p = h._params()
    path = p.get("dir") or p.get("path")
    from h2o3_tpu_torch.genmodel.mojo import load_model
    m = load_model(path)
    h._send({"__meta": {"schema_type": "ModelsV3"},
             "models": [{"model_id": {"name": m.key}}]})


def _h_tree(h):
    """TreeHandler (hex/schemas/TreeV3): fetch one tree of a tree model as
    node arrays (heap order: children of i at 2i+1/2i+2)."""
    p = h._params()
    m = DKV.get(p.get("model"))
    if m is None:
        return h._error("model not found", 404)
    tn = int(p.get("tree_number") or 0)
    cls_name = p.get("tree_class")
    ta = getattr(m, "_trees", None)
    if ta is None and getattr(m, "_trees_k", None) is not None:
        dom = m._dinfo.response_domain or []
        ci = dom.index(cls_name) if cls_name in dom else 0
        ta = m._trees_k[ci]
    if ta is None:
        return h._error("not a tree model", 400)
    col = _host(ta.col[tn])
    thr = _host(ta.thr[tn])
    val = _host(ta.value[tn])
    nal = _host(ta.na_left[tn])
    names = m._dinfo.feature_names
    nodes = col.shape[0]
    h._send({"__meta": {"schema_type": "TreeV3"},
             "tree_number": tn,
             "left_children": [(2 * i + 1 if 2 * i + 1 < nodes and
                                col[i] >= 0 else -1)
                               for i in range(nodes)],
             "right_children": [(2 * i + 2 if 2 * i + 2 < nodes and
                                 col[i] >= 0 else -1)
                                for i in range(nodes)],
             "features": [names[c] if 0 <= c < len(names) else ""
                          for c in col],
             "thresholds": thr.tolist(),
             "nas": ["LEFT" if x else "RIGHT" for x in nal],
             "predictions": val.tolist()})


# ===========================================================================
# algo utility routes: PDP, Word2Vec, Gram, grid build
_PDP_RESULTS: dict = {}


def _h_pdp_build(h):
    """PartialDependenceHandler: compute PD profiles as a Job."""
    p = h._params()
    m = DKV.get(p.get("model_id") or p.get("model"))
    f = DKV.get(p.get("frame_id"))
    if m is None or f is None:
        return h._error("model or frame not found", 404)
    cols = p.get("cols")
    cols = json.loads(cols) if isinstance(cols, str) else (
        cols or m._dinfo.feature_names[:2])
    nbins = int(p.get("nbins") or 20)
    dest = p.get("destination_key") or DKV.make_key("pdp")
    job = Job(description="PartialDependence", dest=dest)

    def work(job):
        from h2o3_tpu_torch.explain_data import partial_dependence
        out = []
        for c in cols:
            pd = partial_dependence(m, f, c, nbins=nbins)
            out.append({"column": c,
                        "values": np.asarray(pd["grid"]).tolist(),
                        "mean_response":
                            np.asarray(pd["mean_response"]).tolist()})
        _PDP_RESULTS[dest] = out
        return out

    job.start(work)
    h._send({"__meta": {"schema_type": "PartialDependenceV3"},
             "job": job.to_dict(), "destination_key": dest})


def _h_pdp_fetch(h, key):
    out = _PDP_RESULTS.get(key)
    if out is None:
        return h._error(f"pdp {key} not found", 404)
    h._send({"__meta": {"schema_type": "PartialDependenceV3"},
             "partial_dependence_data": out})


def _h_w2v_synonyms(h):
    p = h._params()
    m = DKV.get(p.get("model"))
    if m is None:
        return h._error("model not found", 404)
    word = p.get("word")
    count = int(p.get("count") or 20)
    syn = m.find_synonyms(word, count)
    h._send({"__meta": {"schema_type": "Word2VecSynonymsV3"},
             "synonyms": list(syn.keys()) if isinstance(syn, dict)
             else [s[0] for s in syn],
             "scores": list(syn.values()) if isinstance(syn, dict)
             else [s[1] for s in syn]})


def _h_w2v_transform(h):
    p = h._params()
    m = DKV.get(p.get("model"))
    f = DKV.get(p.get("words_frame"))
    if m is None or f is None:
        return h._error("model or frame not found", 404)
    agg = p.get("aggregate_method") or "NONE"
    out = m.transform(f, aggregate_method=agg)
    DKV.put(out.key, out)
    h._send({"__meta": {"schema_type": "Word2VecTransformV3"},
             "vectors_frame": {"name": out.key}})


def _h_compute_gram(h):
    """GramHandler (hex/api/MakeGLMModelHandler.computeGram): X'X on the
    frame's device (a plain product, torch.matmul)."""
    p = h._params()
    f = DKV.get(p.get("X") or p.get("frame"))
    if not isinstance(f, Frame):
        return h._error("frame not found", 404)
    import torch
    num = [n for n, v in zip(f.names, f.vecs) if v.type == "real"
           or v.type == "int" or v.type == "num"]
    num = num or f.names
    X = f.matrix(num)[: f.nrows]
    G = torch.matmul(X.T, X).cpu().numpy()
    dest = p.get("destination_frame") or DKV.make_key("gram")
    out = Frame(num, [Vec.from_numpy(G[:, j].astype(np.float64))
                      for j in range(G.shape[1])], key=dest)
    DKV.put(dest, out)
    h._send({"__meta": {"schema_type": "GramV3"},
             "destination_frame": {"name": dest}})


def _h_grid_build(h, algo):
    """POST /99/Grid/{algo} — GridSearchHandler: hyper-param search build."""
    from h2o3_tpu_torch.models import ESTIMATORS
    from h2o3_tpu_torch.models.grid import H2OGridSearch
    from h2o3_tpu_torch.api.server import _coerce_param
    cls = ESTIMATORS.get(algo)
    if cls is None:
        return h._error(f"unknown algo {algo}", 404)
    p = h._params()
    hyper = p.pop("hyper_parameters", None)
    hyper = json.loads(hyper) if isinstance(hyper, str) else (hyper or {})
    crit = p.pop("search_criteria", None)
    crit = json.loads(crit) if isinstance(crit, str) else crit
    gid = p.pop("grid_id", None)
    tf = DKV.get(p.pop("training_frame", None))
    y = p.pop("response_column", None)
    p.pop("_rest_version", None)
    kw = {k: _coerce_param(v) for k, v in p.items()
          if k in cls._defaults or k in getattr(cls, "_COMMON", ())}
    grid = H2OGridSearch(cls, hyper, grid_id=gid, search_criteria=crit)
    job = Job(description=f"Grid {algo}", dest=grid.grid_id)

    def work(job):
        grid.train(y=y, training_frame=tf, **kw)
        return grid

    job.start(work)
    h._send({"__meta": {"schema_type": "GridSearchV99"},
             "job": job.to_dict(), "grid_id": {"name": grid.grid_id}})


def _h_recovery_resume(h):
    """POST /99/Recovery/resume — Recovery.autoRecover over a recovery dir."""
    p = h._params()
    d = p.get("recovery_dir")
    if not d or not os.path.isdir(d):
        return h._error("recovery_dir not found", 404)
    from h2o3_tpu_torch.io.persist import Recovery
    out = Recovery(d).resume()
    h._send({"__meta": {"schema_type": "RecoveryV99"},
             "frames": [f.key for f in out["frames"]],
             "models": [m.key for m in out["models"]]})


def _h_import_sql(h):
    """ImportSQLTableHandler: JDBC import — explicitly unsupported on the
    runtime (no JVM); fails loudly instead of pretending."""
    h._error("ImportSQLTable requires a JDBC driver; this runtime has "
             "no JVM. Export your table to parquet/csv and import_file it.",
             501)


def _h_parse_svmlight(h):
    p = h._params()
    src = p.get("source_frames")
    if isinstance(src, str):
        src = json.loads(src) if src.startswith("[") else [src]
    path = src[0].strip('"')
    dest = p.get("destination_frame") or None
    from h2o3_tpu_torch.io import parser as io_parser
    job = Job(description=f"ParseSvmLight {path}", dest=dest or "parsed")

    def work(job):
        f = io_parser.import_file(path, destination_frame=dest)
        job.dest = f.key
        return f

    job.start(work)
    h._send({"__meta": {"schema_type": "ParseV3"}, "job": job.to_dict()})


def _h_model_metrics_list(h):
    """GET /3/ModelMetrics — every stored model's metrics."""
    from h2o3_tpu_torch.models.model import ModelBase
    ms = [DKV.get(k) for k in DKV.keys()]
    out = []
    for m in ms:
        # registry may hold constructed-but-untrained builders
        # (_output is None) — list only scored models
        if isinstance(m, ModelBase) and m._output is not None \
                and m._output.training_metrics:
            out.append(dict(m._output.training_metrics.to_dict(),
                            model={"name": m.key}))
    h._send({"__meta": {"schema_type": "ModelMetricsListSchemaV3"},
             "model_metrics": out})


# ===========================================================================

# handlers that start a background Job — quota-prepaid at the REST
# edge (see api/server.starts_job)
_h_create_frame._starts_job = True
_h_interaction._starts_job = True
_h_missing_inserter._starts_job = True
_h_frame_export._starts_job = True
_h_pdp_build._starts_job = True
_h_grid_build._starts_job = True
_h_parse_svmlight._starts_job = True

def build_routes():
    """(pattern, method, handler) rows appended to server.ROUTES."""
    R = re.compile
    return [
        (R(r"/3/Ping"), "GET", _h_ping),
        (R(r"/3/Capabilities"), "GET", _h_capabilities),
        (R(r"/3/Capabilities/([^/]+)"), "GET", _h_capabilities),
        (R(r"/3/NetworkTest"), "GET", _h_network_test),
        (R(r"/3/WaterMeterCpuTicks/([^/]+)"), "GET", _h_water_meter),
        (R(r"/3/WaterMeter/percentiles"), "GET", _h_water_meter),
        (R(r"/3/LogAndEcho"), "POST", _h_log_and_echo),
        (R(r"/3/GarbageCollect"), "POST", _h_gc),
        (R(r"/3/UnlockKeys"), "GET", _h_unlock),
        (R(r"/3/DKV/([^/]+)"), "DELETE", _h_dkv_remove),
        (R(r"/3/DKV"), "DELETE", _h_dkv_remove_all),
        (R(r"/99/Typeahead/files"), "GET", _h_typeahead),
        (R(r"/3/Typeahead/files"), "GET", _h_typeahead),
        (R(r"/4/sessions"), "POST", _h_sessions_post),
        (R(r"/4/sessions/([^/]+)"), "DELETE", _h_sessions_delete),
        (R(r"/3/CreateFrame"), "POST", _h_create_frame),
        (R(r"/3/SplitFrame"), "POST", _h_split_frame),
        (R(r"/3/Interaction"), "POST", _h_interaction),
        (R(r"/3/MissingInserter"), "POST", _h_missing_inserter),
        (R(r"/3/DownloadDataset"), "GET", _h_download_dataset),
        (R(r"/3/DownloadDataset\.bin"), "GET", _h_download_dataset),
        (R(r"/3/Frames/([^/]+)/summary"), "GET", _h_frame_summary),
        (R(r"/3/Frames/([^/]+)/columns"), "GET", _h_frame_columns),
        (R(r"/3/Frames/([^/]+)/columns/([^/]+)/summary"), "GET",
         _h_frame_col_summary),
        (R(r"/3/Frames/([^/]+)/export"), "POST", _h_frame_export),
        (R(r"/3/ModelBuilders/([^/]+)"), "GET", _h_builder_info),
        (R(r"/3/ModelBuilders/([^/]+)/parameters"), "POST",
         _h_validate_params),
        (R(r"/3/Models/([^/]+)/mojo"), "GET", _h_model_mojo),
        (R(r"/3/Models\.java/([^/]+)"), "GET", _h_model_pojo),
        (R(r"/99/Models\.bin/([^/]+)"), "POST", _h_model_save_bin),
        (R(r"/99/Models\.bin"), "POST", _h_model_load_bin),
        (R(r"/3/Tree"), "GET", _h_tree),
        (R(r"/3/PartialDependence"), "POST", _h_pdp_build),
        (R(r"/3/PartialDependence/([^/]+)"), "GET", _h_pdp_fetch),
        (R(r"/3/Word2VecSynonyms"), "POST", _h_w2v_synonyms),
        (R(r"/3/Word2VecTransform"), "POST", _h_w2v_transform),
        (R(r"/3/ComputeGram"), "POST", _h_compute_gram),
        (R(r"/99/Grid/([^/]+)"), "POST", _h_grid_build),
        (R(r"/99/Recovery/resume"), "POST", _h_recovery_resume),
        (R(r"/86/ImportSQLTable"), "POST", _h_import_sql),
        (R(r"/3/ParseSvmLight"), "POST", _h_parse_svmlight),
        (R(r"/3/ModelMetrics"), "GET", _h_model_metrics_list),
    ]

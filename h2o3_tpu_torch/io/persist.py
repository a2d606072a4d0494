"""Frame snapshots and job recovery of the port (h2o3_tpu/io/persist.py;
water/fvec/persist/FramePersist.java, hex/faulttolerance/Recovery.java).

A `.hex` file is the JAX package's: a zip of `header.json` (key, names,
nrows, and a column's type, codec, bias, constant, domain and flags) and
`columns.npz` (a dense column's packed plane `d<j>` and NA plane `m<j>`,
a string column's `s<j>`/`sm<j>`, a sparse column's `zr<j>`/`zv<j>`).
Files move between the two packages both ways:
  * the JAX package pads each dense plane to its cloud's row granule (a
    multiple of 64 on its 8-shard CPU cloud) and masks the padding rows;
    the port writes the same padded layout (`HEX_ROW_GRANULE`), and cuts
    the planes back to `nrows` on import, dropping an NA plane that holds
    no NA in those rows (the port keeps one only where a value is NA);
  * a UUID column is written as its words `u<j>` and NA lane `um<j>`
    (`is_uuid`): the JAX package cannot export one, and cannot import the
    port's.
Export reads each plane from the cheapest tier that holds it
(`staging_view`): a demoted frame is never faulted back to the card. The
port deflates at level 1 (the JAX package at zlib's default, 6), much
faster for a slightly larger file; either package reads either.
URIs go through io/uri.py (a remote target is written locally, then
pushed).

`Recovery` checkpoints a multi-model job (a grid) into a directory: every
frame it was given (`.hex`) and every finished model (a binary model,
genmodel/mojo.py), with a `manifest.json`; `resume` loads what the store
does not hold.
"""

from __future__ import annotations

import io
import json
import os
import tempfile
import time
import zipfile

import numpy as np

from h2o3_tpu_torch.core.frame import (Codec, Frame, SparseVec, StrVec,
                                       T_STR, UuidVec, Vec)
from h2o3_tpu_torch.core.kvstore import DKV
from h2o3_tpu_torch.io import uri as _uri

# the JAX package's row granule on its 8-shard CPU cloud (8 shards of 8
# rows, parallel/mesh.py `padded_rows`)
HEX_ROW_GRANULE = 64


def _padded_rows(n: int) -> int:
    g = HEX_ROW_GRANULE
    return max(g, -(-n // g) * g)


def _pad(data: np.ndarray, mask, n: int):
    """A column's planes in the JAX layout: padded to `_padded_rows(n)`
    with 0, the padding rows NA."""
    pad = _padded_rows(n)
    if pad == n:
        return data, mask
    d = np.zeros(pad, data.dtype)
    d[:n] = data[:n]
    m = np.ones(pad, np.uint8)
    m[:n] = 0 if mask is None else mask[:n]
    return d, m


def _write_hex(frame: Frame, out, compress: bool = True):
    """`frame` as a .hex zip into `out` (a path or a binary file), its
    members deflated at level 1, or stored with `compress=False` (the
    same layout: a reader takes either)."""
    n = frame.nrows
    header = {"key": frame.key, "names": frame.names, "nrows": n,
              "cols": []}
    arrays = {}
    for j, v in enumerate(frame.vecs):
        is_sparse = isinstance(v, SparseVec)
        c = {"type": v.type, "codec": v.codec.kind, "bias": v.codec.bias,
             "const": None if v.codec.const_val != v.codec.const_val
             else v.codec.const_val,
             "domain": v.levels(), "has_mask": False,
             "is_str": v.type == T_STR, "is_sparse": is_sparse}
        header["cols"].append(c)
        if is_sparse:
            arrays[f"zr{j}"] = np.asarray(v._nzr_chunk.staging_view()[0])
            arrays[f"zv{j}"] = np.asarray(v._nzv_chunk.staging_view()[0])
        elif isinstance(v, StrVec):
            codes = np.asarray(v._codes_chunk.staging_view()[0])[:n]
            na = codes < 0
            s = np.empty(n, object)
            s[na] = ""
            s[~na] = v.levels_arr[codes[~na]]
            arrays[f"s{j}"] = np.array(s.tolist(), dtype=str)
            arrays[f"sm{j}"] = na
        elif isinstance(v, UuidVec):
            c["is_uuid"] = True
            words, na = v._uuid_chunk.staging_view()
            arrays[f"u{j}"] = np.asarray(words)[:n]
            arrays[f"um{j}"] = np.asarray(na)[:n]
        else:
            data_h, mask_h = v._chunk.staging_view()
            data_h, mask_h = _pad(np.asarray(data_h), None if mask_h is None
                                  else np.asarray(mask_h), n)
            c["has_mask"] = mask_h is not None
            arrays[f"d{j}"] = data_h
            if mask_h is not None:
                arrays[f"m{j}"] = mask_h
    with zipfile.ZipFile(out, "w", zipfile.ZIP_DEFLATED if compress
                         else zipfile.ZIP_STORED,
                         compresslevel=1 if compress else None) as zf:
        zf.writestr("header.json", json.dumps(header, default=float))
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        zf.writestr("columns.npz", buf.getvalue())


def _gathered(frame: Frame) -> Frame:
    """A frame of a cloud of several ranks, gathered whole on every rank:
    each column's decoded values (NA as NaN) in rank order, packed again
    by the codecs on the host. Dense columns only."""
    from h2o3_tpu_torch.parallel import mrtask as _mr
    vecs = []
    for v in frame.vecs:
        if type(v) is not Vec:
            raise NotImplementedError(
                f"saving a {type(v).__name__} column of a frame of a cloud "
                "of several ranks is not ported")
        col = _mr.host_fetch(v.as_f32()).astype(np.float64)
        vecs.append(Vec._from_floats(col, np.isnan(col), v.type, v.domain,
                                     cold=True))
    whole = Frame(frame.names, vecs, key=frame.key + "__whole")
    DKV.remove(whole.key)
    whole.key = frame.key
    return whole


def export_frame(frame: Frame, path: str, compress: bool = True) -> str:
    """FramePersist.saveTo: the frame's packed columns, exactly. A frame
    that holds one row block on each rank of a cloud is gathered whole
    (a collective: every rank calls this); the coordinator alone writes
    (a worker replaying the request writes nothing)."""
    from h2o3_tpu_torch.deploy import multihost as _mh
    from h2o3_tpu_torch.parallel import compat as _compat
    from h2o3_tpu_torch.parallel import mrtask as _mr
    if _mr.sharded(frame):
        # the column gathers as one region of the collective guard
        frame = _compat.guard_collective(_gathered)(frame)
    if not _mh.writes_artifacts():
        # a worker replaying the request: the coordinator writes the file
        return _uri.local_path(path)
    local = path = _uri.local_path(path)
    if _uri.is_remote(path):
        fd, local = tempfile.mkstemp(suffix=".hex")
        os.close(fd)
    _write_hex(frame, local, compress=compress)
    if local != path:
        _uri.push_from_local(local, path)
    return path


def _read_hex(src, key=None, device=None, rows=None) -> Frame:
    """A Frame from a .hex zip (a path or a binary file). `rows` = (lo, hi)
    keeps that block of the rows only (a rank's block of a frame of a
    cloud of several ranks; dense, string and uuid columns)."""
    with zipfile.ZipFile(src) as zf:
        header = json.loads(zf.read("header.json"))
        npz = np.load(io.BytesIO(zf.read("columns.npz")), allow_pickle=False)
        n_all = int(header["nrows"])
        lo, hi = (0, n_all) if rows is None else rows
        n = hi - lo
        vecs = []
        for j, c in enumerate(header["cols"]):
            if c.get("is_sparse"):
                if rows is not None:
                    raise NotImplementedError(
                        "a sparse column of a frame of a cloud of several "
                        "ranks is not ported")
                vecs.append(SparseVec(npz[f"zr{j}"], npz[f"zv{j}"], n,
                                      type=c["type"], device=device))
            elif c["is_str"]:
                s = npz[f"s{j}"][lo:hi].astype(object)
                na = npz[f"sm{j}"][lo:hi].astype(bool)
                levels, inv = np.unique(s[~na], return_inverse=True)
                codes = np.full(n, -1, np.int32)
                codes[~na] = inv.reshape(-1)
                vecs.append(StrVec.from_codes(codes, levels, device))
            elif c.get("is_uuid"):
                vecs.append(UuidVec(npz[f"u{j}"][lo:hi],
                                    npz[f"um{j}"][lo:hi], n, device=device))
            else:
                codec = Codec(c["codec"], bias=c["bias"] or 0.0,
                              const_val=(c["const"] if c["const"] is not None
                                         else float("nan")))
                data_h = np.array(npz[f"d{j}"][lo:hi])
                mask_h = np.array(npz[f"m{j}"][lo:hi]) if c["has_mask"] \
                    else None
                if mask_h is not None and not mask_h.any():
                    mask_h = None        # only the padding rows were NA
                dom = (np.asarray(c["domain"], object)
                       if c["domain"] is not None else None)
                vecs.append(Vec._from_packed(data_h, codec, mask_h, n,
                                             c["type"], dom, device))
    fr = Frame(header["names"], vecs, key or header["key"])
    if rows is not None:
        fr.shard = (lo, hi, n_all)
    return fr


def _hex_nrows(path: str) -> int:
    with zipfile.ZipFile(path) as zf:
        return int(json.loads(zf.read("header.json"))["nrows"])


def import_frame(path: str, key=None) -> Frame:
    """A .hex file (local or a URI) back into a Frame in the store. In a
    cloud of several ranks each rank keeps its own block of the rows
    (parallel/mesh.Cloud.row_block)."""
    from h2o3_tpu_torch.parallel import mesh as _mesh
    path = _uri.local_path(path)
    local = _uri.fetch_to_local(path)
    try:
        c = _mesh.cloud()
        if c.world > 1:
            return _read_hex(local, key,
                             rows=c.row_block(_hex_nrows(local)))
        return _read_hex(local, key)
    finally:
        if local != path:
            try:
                os.unlink(local)
            except OSError:
                pass


# ===========================================================================
class Recovery:
    """Recovery.java: checkpoints of a multi-model job in `recovery_dir`,
    so that a restarted job resumes instead of starting over."""

    def __init__(self, recovery_dir: str):
        self.dir = recovery_dir
        os.makedirs(recovery_dir, exist_ok=True)
        self._manifest_path = os.path.join(recovery_dir, "manifest.json")

    def _manifest(self) -> dict:
        if os.path.exists(self._manifest_path):
            with open(self._manifest_path) as f:
                return json.load(f)
        return {"frames": {}, "models": [], "updated": 0}

    def _write(self, man):
        man["updated"] = time.time()
        with open(self._manifest_path, "w") as f:
            json.dump(man, f)

    def checkpoint_frame(self, frame: Frame):
        man = self._manifest()
        if frame.key not in man["frames"]:
            p = os.path.join(self.dir, f"frame_{frame.key}.hex")
            export_frame(frame, p)
            man["frames"][frame.key] = p
            self._write(man)

    def checkpoint_model(self, model):
        from h2o3_tpu_torch.genmodel.mojo import save_model
        man = self._manifest()
        p = os.path.join(self.dir, f"model_{model.key}.bin")
        save_model(model, p)
        if model.key not in [m["key"] for m in man["models"]]:
            man["models"].append({"key": model.key, "path": p})
            self._write(man)

    def resume(self) -> dict:
        """Recovery.autoRecover: load every checkpointed frame and model
        the store does not hold."""
        from h2o3_tpu_torch.genmodel.mojo import load_model
        man = self._manifest()
        out = {"frames": [], "models": []}
        for key, p in man["frames"].items():
            if key not in DKV:
                out["frames"].append(import_frame(p, key))
        for m in man["models"]:
            if m["key"] not in DKV:
                out["models"].append(load_model(m["path"]))
        return out

    def recovered_model_keys(self) -> list:
        return [m["key"] for m in self._manifest()["models"]]

"""Storage by URI scheme for the port (h2o3_tpu/io/uri.py,
water/persist/PersistManager.java).

  * bare paths and file:// -> the local file system;
  * http(s)://             -> HEAD for the size, Range requests for byte
                              ranges, a whole GET to stage; read-only;
  * gs:// s3:// s3a:// hdfs:// memory:// -> fsspec, imported when such a
                              path is used (without fsspec the import
                              raises, as in the JAX package).

The JAX package has no file:// branch (a file:// path is not found
there); the port reads it as the local path after the prefix.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import urllib.request

_REMOTE_SCHEMES = ("http://", "https://", "gs://", "s3://", "s3a://",
                   "hdfs://", "memory://")
_HTTP = ("http://", "https://")


def is_remote(path: str) -> bool:
    return path.startswith(_REMOTE_SCHEMES)


def local_path(path):
    """A file:// URI as its local path; anything else as it is."""
    if isinstance(path, str) and path.startswith("file://"):
        return path[len("file://"):]
    return path


def _fs_for(path: str):
    import fsspec
    norm = path.replace("s3a://", "s3://")
    try:
        fs, rel = fsspec.core.url_to_fs(norm)
    except ImportError as e:
        raise NotImplementedError(
            f"persist backend for {path.split('://')[0]}:// needs an fsspec "
            f"implementation that is not installed ({e})") from e
    return fs, rel


def _head(path: str):
    req = urllib.request.Request(path, method="HEAD")
    with urllib.request.urlopen(req) as r:
        return r.headers


def path_size(path: str) -> int:
    """Bytes of a local path or a remote URI (Content-Length of a HEAD for
    http(s), `fs.size` through fsspec)."""
    path = local_path(path)
    if not is_remote(path):
        return os.path.getsize(path)
    if path.startswith(_HTTP):
        ln = _head(path).get("Content-Length")
        if ln is None:
            raise OSError(f"no Content-Length for {path}")
        return int(ln)
    fs, rel = _fs_for(path)
    return int(fs.size(rel))


def supports_ranges(path: str) -> bool:
    """Whether `path` serves byte ranges, the chunked parse's need: local
    files and fsspec backends do; an http(s) server must give a
    Content-Length and not refuse ranges (Accept-Ranges: none)."""
    path = local_path(path)
    if not is_remote(path) or not path.startswith(_HTTP):
        return True
    try:
        h = _head(path)
        return h.get("Content-Length") is not None and \
            (h.get("Accept-Ranges") or "").lower() != "none"
    except Exception:   # noqa: BLE001 - a failed probe stages the file
        return False


def read_range(path: str, start: int, end: int) -> bytes:
    """Bytes [start, end) of a local path or remote URI (a Range request,
    or fsspec's cat_file)."""
    if end <= start:
        return b""
    path = local_path(path)
    if not is_remote(path):
        with open(path, "rb") as f:
            f.seek(start)
            return f.read(end - start)
    if path.startswith(_HTTP):
        req = urllib.request.Request(
            path, headers={"Range": f"bytes={start}-{end - 1}"})
        with urllib.request.urlopen(req) as r:
            body = r.read()
            if r.status == 200 and start != 0:
                # the server ignored the Range header: cut the slice
                return body[start:end]
            return body[: end - start]
    fs, rel = _fs_for(path)
    return fs.cat_file(rel, start=start, end=end)


def fetch_to_local(path: str, suffix: str = "") -> str:
    """A local copy of a remote URI (a temporary file the caller removes);
    a local path as it is."""
    path = local_path(path)
    if not is_remote(path):
        return path
    fd, tmp = tempfile.mkstemp(suffix=suffix or os.path.splitext(path)[1])
    os.close(fd)
    if path.startswith(_HTTP):
        with urllib.request.urlopen(path) as r, open(tmp, "wb") as out:
            shutil.copyfileobj(r, out)
        return tmp
    fs, rel = _fs_for(path)
    fs.get_file(rel, tmp)
    return tmp


def push_from_local(local: str, path: str) -> str:
    """Move a local staging file to `path` (an upload for a remote URI)."""
    path = local_path(path)
    if not is_remote(path):
        if local != path:
            shutil.move(local, path)
        return path
    if path.startswith(_HTTP):
        raise NotImplementedError(
            "http persist is read-only (PersistEagerHTTP); export to a "
            "file or an fsspec scheme instead")
    fs, rel = _fs_for(path)
    fs.put_file(local, rel)
    os.unlink(local)
    return path


def exists(path: str) -> bool:
    path = local_path(path)
    if not is_remote(path):
        return os.path.exists(path)
    if path.startswith(_HTTP):
        try:
            _head(path)
            return True
        except Exception:   # noqa: BLE001 - any failure reads as absent
            return False
    fs, rel = _fs_for(path)
    return fs.exists(rel)

"""Shared append-only segment-directory discipline of the port
(h2o3_tpu/obs/segments.py).

Both durable observability tiers — the flight recorder's trace segments
(obs/recorder.py) and the structured log's JSONL segments (utils/log.py)
— follow the same rules over a directory under the ice root:

  * per-process file names (writers sharing an ice root never clobber);
  * append-only JSON lines, crash-safe (a torn trailing line from a
    crashed writer is skipped on read);
  * size-triggered roll + oldest-first GC against a byte budget, where
    GC may delete OTHER processes' files — so every writer must detect
    its open segment being unlinked out from under it and roll;
  * readers scan the WHOLE directory (any process, including a fresh
    one after a restart, can read a dead one's segments).

The subtle pieces live here exactly once so the two tiers cannot drift:
the overlayfs-safe liveness check, the listing order, the GC sweep, and
the torn-line-tolerant JSONL iterator.
"""

from __future__ import annotations

import json
import os


def alive(path, fh) -> bool:
    """True while `path` still names the open file `fh` — checked by
    PATH + inode, not fstat st_nlink: overlayfs (the usual container
    fs) keeps nlink at 1 on an fd whose upper-layer file was unlinked.
    False means another process's GC deleted the segment: appends would
    land in a dead inode invisible to every reader — roll immediately."""
    if path is None or fh is None:
        return False
    try:
        return os.stat(path).st_ino == os.fstat(fh.fileno()).st_ino
    except OSError:
        return False


def list_segments(d: str, suffix: str = ".jsonl") -> list:
    """(mtime, path, size) for every segment under `d`, oldest first
    (mtime, then name for stability) — every process's files."""
    try:
        names = [n for n in os.listdir(d) if n.endswith(suffix)]
    except OSError:
        return []
    out = []
    for n in names:
        p = os.path.join(d, n)
        try:
            st = os.stat(p)
        except OSError:
            continue
        out.append((st.st_mtime, p, st.st_size))
    out.sort()
    return out


def gc(d: str, budget: int, keep_path=None, suffix: str = ".jsonl"):
    """Delete oldest segments first until the directory fits `budget`
    bytes. `keep_path` (the caller's ACTIVE segment) is never deleted;
    undeletable files (perms/ro-fs) still count — their bytes are on
    disk either way. Racing GCs are fine: a FileNotFoundError means the
    other one won."""
    segs = list_segments(d, suffix)
    total = sum(sz for _, _, sz in segs)
    for _, p, sz in segs:
        if total <= budget:
            break
        if p == keep_path:
            continue
        try:
            os.unlink(p)
        except FileNotFoundError:
            pass
        except OSError:
            continue
        total -= sz


def iter_jsonl(segs: list, newest_first: bool = True,
               contains: str | None = None):
    """Yield parsed JSON objects from (mtime, path, size) segments,
    tolerating torn trailing lines (a crashed writer's last append).
    `contains` prefilters raw lines by substring before the (much
    costlier) JSON parse — exact for ids that appear literally in the
    line."""
    if newest_first:
        segs = list(reversed(segs))
    for _, p, _sz in segs:
        try:
            with open(p, encoding="utf-8") as fh:
                lines = fh.readlines()
        except OSError:
            continue
        if newest_first:
            lines = reversed(lines)
        for line in lines:
            if contains is not None and contains not in line:
                continue
            try:
                yield json.loads(line)
            except (json.JSONDecodeError, ValueError):
                continue        # torn append from a crashed writer

"""The chunked multi-file parse of the port (h2o3_tpu/io/dparse.py,
water/parser/ParseDataset.java MultiFileParseTask and EnumUpdateTask).

  phase A  a plan of byte ranges of about `chunk_bytes` over every source
           (local files and ranged http(s) or fsspec URIs), each range
           owning the lines that start in it (the chunk contract);
  phase B  each range tokenized by the native tokenizer (io/fastcsv.py)
           on a bounded pool of host threads, in order, at most
           `workers + readahead` ranges in flight; a gzip or zip member
           is inflated in one pass into line-aligned windows that join
           the same pool;
  phase C  the merge: numeric columns concatenate; a categorical column's
           levels are the sorted union of each chunk's, and each chunk's
           codes are renumbered by one searchsorted table; a time
           column's string cells parse once a distinct token. The merged
           host arrays are packed by the codecs into Vecs on the cloud's
           device on the calling thread, so only it touches the card.

With `broadcaster=` (a live replay-channel coordinator) the plan fans
out cloud-wide, the MultiFileParseTask shape: `_assign_chunks` maps each
range to a member by a consistent hash of (path, start) over the live
set, `_fan_out_parse` sends each worker its share in waves over the
channel's collect op (`parse:`), each worker tokenizes its share
(`worker_parse_chunks`) and answers with compact codec-byte planes (the
DKV re-home wire form, lossless: the merge sees the doubles a local
tokenize gives), while the coordinator tokenizes its own share. A share
a worker forfeits (timeout, excision) is re-parsed locally, so the frame
always completes, equal row for row to a one-process parse.

Variables (the JAX package's): H2O3_PARSE_CHUNK_MB, the plan's chunk size
(default 64); H2O3_PARSE_WORKERS, the pool's threads (0: one a core);
H2O3_PARSE_READAHEAD, ranges in flight beyond the pool (default 4);
H2O3_PARSE_FANOUT_TIMEOUT_S, the whole-wave deadline of the worker
shares (default 30).
"""

from __future__ import annotations

import base64
import csv
import glob as _glob
import gzip
import io
import itertools
import os
import tempfile
import threading
import zipfile
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np

from h2o3_tpu_torch.core.frame import (Frame, StrVec, T_CAT, T_NUM, T_STR,
                                       T_TIME, T_UUID, UuidVec, Vec)
from h2o3_tpu_torch.io import fastcsv
from h2o3_tpu_torch.io import uri as _uri
from h2o3_tpu_torch.io.fastcsv import StrCells
from h2o3_tpu_torch.io.parser import (NA_TOKENS, ParseSetup, _num_token,
                                      _parse_time_ms, parse_setup, pack_span)
from h2o3_tpu_torch.obs.timeline import span as _span
from h2o3_tpu_torch.obs import metrics as _om
from h2o3_tpu_torch.utils.env import env_float, env_int

# per-stage ingest volume: read (remote range bytes fetched), decompress
# (bytes inflated out of gzip/zip members), tokenize (bytes handed to a
# tokenizer), pack (packed codec bytes landing in Vec planes), wire
# (codec-byte planes shipped back by fan-out workers)
INGEST_BYTES = _om.counter(
    "h2o3_ingest_bytes_total",
    "distributed-ingest pipeline volume by stage "
    "(read/decompress/tokenize/pack/wire)")
INGEST_ROWS = _om.counter(
    "h2o3_ingest_rows_total",
    "rows materialized into Frames by the distributed ingest pipeline")

_COMPRESSED = (".gz", ".zip")


def _fanout_timeout_s() -> float:
    """WHOLE-WAVE deadline for the worker parse shares; a host that
    blows its slice forfeits the wave AND its remaining shares (the
    coordinator re-parses locally). The collect grants each worker its
    slice SEQUENTIALLY while holding the broadcast lock, so the per-
    worker slice is this value divided by the wave's host count —
    replayed REST traffic stalls at most ~this long per wave even when
    every worker is wedged."""
    return env_float("H2O3_PARSE_FANOUT_TIMEOUT_S", 30.0)


# wave budget: source bytes per worker per collect round, bounded so the
# base64 codec-plane ack stays well under the replay channel's 64MB
# frame cap. Worst case wire ≈ 2× source (incompressible f64 planes ≈
# 8B per ~9B token, plus the string planes of a text-heavy share ≈ its
# source bytes), ×4/3 base64 → 16MB source ≤ ~43MB ack
_WAVE_BUDGET = 16 << 20


def _chunk_bytes_default() -> int:
    return env_int("H2O3_PARSE_CHUNK_MB", 64) << 20


def _pool_workers(n_units: int) -> int:
    w = env_int("H2O3_PARSE_WORKERS", 0) or (os.cpu_count() or 1)
    return max(1, min(32, w, n_units))


def _readahead() -> int:
    return max(1, env_int("H2O3_PARSE_READAHEAD", 4))


# ---------------------------------------------------------------------------
def expand_paths(paths) -> list:
    """A path, directory, glob, URI or a list of them, as files in order: a
    directory's visible files and a glob's matches sorted, a list in the
    caller's order (duplicates kept)."""
    if isinstance(paths, (str, os.PathLike)):
        paths = [paths]
    out = []
    for p in paths:
        p = _uri.local_path(os.fspath(p))
        if _uri.is_remote(p):
            out.append(p)
        elif os.path.isdir(p):
            out.extend(sorted(
                os.path.join(p, f) for f in os.listdir(p)
                if not f.startswith(".")
                and os.path.isfile(os.path.join(p, f))))
        elif any(ch in p for ch in "*?["):
            out.extend(sorted(_glob.glob(p)))
        else:
            out.append(p)
    if not out:
        raise FileNotFoundError(f"no files match {paths!r}")
    return out


def plan_chunks(paths: Sequence[str],
                chunk_bytes: Optional[int] = None) -> list:
    """Phase A: [(path, start, end, is_file_head)] over every source."""
    chunk_bytes = chunk_bytes or _chunk_bytes_default()
    plan = []
    for p in paths:
        size = _uri.path_size(p)
        n_chunks = max(1, -(-size // chunk_bytes))
        step = -(-size // n_chunks)
        for i in range(n_chunks):
            plan.append((p, i * step, min((i + 1) * step, size), i == 0))
    return plan


# ---------------------------------------------------------------------------
# phase B: the tokenizers, native and plain
def _rows_to_cols(rows, skip_header) -> list:
    """csv-module rows to [(float64 values, StrCells)] a column."""
    if skip_header and rows:
        rows = rows[1:]
    ncol = max((len(r) for r in rows), default=0)
    cols = []
    for j in range(ncol):
        num = np.empty(len(rows), np.float64)
        smap = {}
        for i, r in enumerate(rows):
            t = r[j].strip() if j < len(r) else ""
            if t in NA_TOKENS:
                num[i] = np.nan
            else:
                try:
                    num[i] = float(t)
                except ValueError:
                    num[i] = np.nan
                    smap[i] = t
        cols.append((num, StrCells.from_dict(smap)))
    return cols


def _tokenize_bytes_py(buf: bytes, sep: str, skip_header: bool,
                       skip_partial_first: bool = False) -> list:
    """The plain tokenizer over staged bytes, with the native
    `fastcsv_parse_bytes` contract (Python's csv module)."""
    fastcsv.count_bytes("python", len(buf))
    if skip_partial_first:
        nl = buf.find(b"\n")
        buf = buf[nl + 1:] if nl >= 0 else b""
        skip_header = False
    text = buf.decode("utf-8", "replace")
    rows = [r for r in csv.reader(io.StringIO(text), delimiter=sep) if r]
    return _rows_to_cols(rows, skip_header)


def _tokenize_range_py(path: str, sep: str, skip_header: bool,
                       start: int, end: int) -> list:
    """The plain tokenizer over one byte range, with the native
    `fastcsv_parse_range` contract."""
    size = os.path.getsize(path)
    end = size if end < 0 else min(end, size)
    with open(path, "rb") as f:
        f.seek(end)
        ext = end
        while ext < size:
            b = f.read(1 << 16)
            if not b:
                break
            nl = b.find(b"\n")
            if nl >= 0:
                ext += nl + 1
                break
            ext += len(b)
        f.seek(start)
        buf = f.read(ext - start)
    return _tokenize_bytes_py(buf, sep, skip_header and start == 0,
                              skip_partial_first=start > 0)


def _tokenize_range(path, sep, skip_header, start, end) -> list:
    if fastcsv.available():
        return fastcsv.parse_columns(path, sep, skip_header, start=start,
                                     end=end)
    return _tokenize_range_py(path, sep, skip_header, start, end)


def _tokenize_bytes(buf, sep, skip_header, skip_partial_first=False) -> list:
    if fastcsv.available():
        return fastcsv.parse_bytes_columns(
            buf, sep, skip_header, skip_partial_first=skip_partial_first)
    return _tokenize_bytes_py(buf, sep, skip_header,
                              skip_partial_first=skip_partial_first)


def _read_remote_chunk(path: str, start: int, end: int) -> bytes:
    """One remote range and enough more to end the line straddling `end`,
    fetched in growing Range requests; a short read is the end of the
    source."""
    slack = 1 << 16
    buf = b""
    while True:
        lo, hi = start + len(buf), end + slack
        with _span("parse.read", start=lo, end=hi):
            part = _uri.read_range(path, lo, hi)
        INGEST_BYTES.inc(len(part), stage="read")
        eof = len(part) < hi - lo
        buf += part
        if len(buf) > end - start:
            nl = buf.find(b"\n", end - start)
            if nl >= 0:
                return buf[:nl + 1]
        if eof:
            return buf
        slack *= 4


def _tokenize_chunk(chunk, setup: ParseSetup) -> list:
    """One plan entry, local or remote, to [(values, StrCells)]."""
    path, start, end, head = chunk
    header = bool(setup.header and head)
    if _uri.is_remote(path):
        buf = _read_remote_chunk(path, start, end)
        return _tokenize_bytes(buf, setup.separator, header,
                               skip_partial_first=start > 0)
    return _tokenize_range(path, setup.separator, header, start, end)


def _pipelined(units, fn, workers: int):
    """`fn` over `units` on `workers` threads, yielding the results in
    order with at most `workers + readahead` units in flight."""
    if workers <= 1:
        for u in units:
            yield fn(u)
        return
    window = workers + _readahead()
    with ThreadPoolExecutor(workers) as ex:
        it = iter(units)
        pending = deque(ex.submit(fn, u)
                        for u in itertools.islice(it, window))
        while pending:
            res = pending.popleft().result()
            nxt = next(it, None)
            if nxt is not None:
                pending.append(ex.submit(fn, nxt))
            yield res


def _compressed_units(path: str, chunk_bytes: int):
    """A gzip or zip member (its first) inflated into windows of about
    `chunk_bytes` that end at a newline: (bytes, is_first)."""
    if path.endswith(".gz"):
        stream = gzip.open(path, "rb")
    else:
        zf = zipfile.ZipFile(path)
        stream = zf.open(zf.namelist()[0])
    carry = b""
    first = True
    with stream:
        while True:
            with _span("parse.decompress", file=os.path.basename(path)):
                blk = stream.read(chunk_bytes)
            if not blk:
                break
            INGEST_BYTES.inc(len(blk), stage="decompress")
            buf = carry + blk
            nl = buf.rfind(b"\n")
            if nl < 0:
                carry = buf
                continue
            yield buf[:nl + 1], first
            first = False
            carry = buf[nl + 1:]
    if carry:
        yield carry, first


def _parse_compressed(path: str, setup: ParseSetup, chunk_bytes: int,
                      workers) -> list:
    """Tokenize one local gzip or zip member through the pool."""
    return list(_pipelined(
        _compressed_units(path, chunk_bytes),
        lambda u: _tokenize_bytes(u[0], setup.separator,
                                  bool(setup.header and u[1])),
        workers or _pool_workers(8)))


def _setup_for(path: str) -> ParseSetup:
    """parse_setup; for a remote URI on a local copy of its head (cut at
    its last newline unless the head is the whole source)."""
    if not _uri.is_remote(path):
        return parse_setup(path)
    want = 1 << 18
    head = _uri.read_range(path, 0, want)
    if len(head) >= want:
        nl = head.rfind(b"\n")
        if nl >= 0:
            head = head[:nl + 1]
    fd, tmp = tempfile.mkstemp(suffix=".csv")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(head)
        return parse_setup(tmp)
    finally:
        os.unlink(tmp)


# ---------------------------------------------------------------------------
# fan-out: ship chunk shares over the replay channel (collect op
# "parse:<json>"), workers answer with compact codec-byte planes — the
# DKV re-home wire format (core/kvstore._plane_payload), never decoded
# f32, bit-exact by construction.
def _wire_pack_col(num: np.ndarray, smap: dict) -> dict:
    """Pack one chunk column for the wire — `_choose_codec` (the one
    narrowing-logic owner) with a LOSSLESS float policy layered on top:
    its f32 downgrade ships only when every value round-trips, raw f64
    otherwise, so the coordinator's merge sees bit-identical doubles to
    a local tokenize."""
    from h2o3_tpu_torch.core.frame import _choose_codec
    from h2o3_tpu_torch.core.kvstore import _plane_payload
    mask = np.isnan(num)
    has_na = bool(mask.any())
    packed, codec = _choose_codec(num, mask)
    kind, bias, cval = codec.kind, float(codec.bias), 0.0
    if kind in ("const", "i8", "i16", "i32") and bool(
            np.any((num == 0.0) & np.signbit(num) & ~mask)):
        # negative zero doesn't survive the integer/const round trip
        # (-0.0 - bias + bias = +0.0), and the merge keeps "-0" a
        # DISTINCT categorical level — ship raw f64 for these rare
        # columns so fanned-out parses stay bit-identical to local
        packed = num
        kind = "f64"
        bias = 0.0     # raw doubles carry no bias (the JAX packer keeps it)
    if kind == "const":
        cval = float(codec.const_val)
        packed = np.zeros(0, np.int8)        # value rides in `c`
    elif kind == "f32" and not np.array_equal(
            packed.astype(np.float64), np.where(mask, 0.0, num),
            equal_nan=True):
        packed = num                         # f32 would lose bits
        kind = "f64"
        bias = 0.0
    payload = _plane_payload(packed,
                             mask.astype(np.uint8) if has_na else None)
    out = {"p": base64.b64encode(payload).decode("ascii"),
           "k": kind, "b": bias, "c": cval, "n": int(len(num))}
    wire_len = len(payload)
    if smap:
        # string cells ship as npz planes too (rows/lens/utf-8 bytes) —
        # a JSON dict per cell would inflate text-heavy shares several×
        # past the replay channel's frame cap and get the worker
        # wrongly excised for answering with an oversized ack
        import io as _io
        rows = np.fromiter(smap.keys(), np.int64, len(smap))
        vals = [s.encode("utf-8") for s in smap.values()]
        lens = np.asarray([len(v) for v in vals], np.int32)
        blob = np.frombuffer(b"".join(vals), np.uint8)
        buf = _io.BytesIO()
        np.savez(buf, rows=rows, lens=lens, blob=blob)
        spay = buf.getvalue()
        out["s"] = base64.b64encode(spay).decode("ascii")
        wire_len += len(spay)
    INGEST_BYTES.inc(wire_len, stage="wire")
    return out


def _wire_restore_col(w: dict):
    """Inverse of _wire_pack_col → (float64 ndarray, {row: str})."""
    import io as _io
    from h2o3_tpu_torch.core.kvstore import _plane_restore
    data, mask = _plane_restore(base64.b64decode(w["p"]))
    n = int(w["n"])
    kind = w["k"]
    if kind == "const":
        num = np.full(n, float(w.get("c", float("nan"))))
    else:
        num = data.astype(np.float64)
        if w.get("b"):
            num += float(w["b"])
    if mask is not None:
        num[mask.astype(bool)] = np.nan
    smap = {}
    if w.get("s"):
        with np.load(_io.BytesIO(base64.b64decode(w["s"])),
                     allow_pickle=False) as z:
            rows, lens = z["rows"], z["lens"]
            blob = z["blob"].tobytes()
        offs = np.concatenate([[0], np.cumsum(lens)])
        for i in range(len(rows)):
            smap[int(rows[i])] = blob[offs[i]:offs[i + 1]].decode(
                "utf-8", "replace")
    return num, smap


# hard bound on one parse ack's wire payload: whatever the wave-budget
# heuristic predicted, the ENCODED ack must stay under the replay
# channel's 64MB frame cap with headroom for JSON/HMAC framing — chunks
# that don't fit are simply left out of the answer and the coordinator
# re-parses them locally (the protocol already tolerates partial acks)
_ACK_WIRE_CAP = 44 << 20


def worker_parse_chunks(spec: dict) -> dict:
    """Worker side of the parse fan-out (multihost._collect_local
    `parse:` op): tokenize this host's chunk share — entries are
    [path, start, end, is_head, plan_index] — through the local pipeline
    and return wire-packed codec planes per plan index, truncated at
    _ACK_WIRE_CAP so a worst-case column mix (short f64 tokens) can
    never produce an oversized frame that gets this worker excised."""
    setup = ParseSetup(separator=spec.get("sep", ","),
                       header=bool(spec.get("header", True)))
    chunks = [tuple(c) for c in spec.get("chunks") or []]
    if not chunks:
        return {"chunks": {}}
    out = {}
    wire = 0
    for idx, cols in zip(
            [c[4] for c in chunks],
            _pipelined([c[:4] for c in chunks],
                       lambda c: _tokenize_chunk(c, setup),
                       _pool_workers(len(chunks)))):
        if wire >= _ACK_WIRE_CAP:
            continue            # drained, not returned: local fallback
        packed = [_wire_pack_col(num, cells.to_dict())
                  for num, cells in cols]
        wire += sum(len(w["p"]) + len(w.get("s") or "") for w in packed)
        out[str(idx)] = packed
    return {"chunks": out}


def _assign_chunks(plan, nodes):
    """Deterministic chunk → node map: consistent hash over
    (path, start) against the sorted live node set (the Key.java home
    hash reused for parse work) — replay-safe (R016): same plan + same
    membership ⇒ same assignment on every host, no RNG, no wall clock."""
    from h2o3_tpu_torch.core.kvstore import HashRing
    ring = HashRing(nodes)
    return [ring.node_for(f"{c[0]}:{c[1]}") for c in plan]


def _fan_out_parse(bc, plan, assign, setup, results, done_flags):
    """Coordinator side: wave the worker shares over the replay channel
    (bounded per-wave payload so the base64 codec-plane acks stay under
    the frame cap), restoring codec planes into `results`. A worker that
    times out, errors or was excised mid-wave simply leaves its chunks
    unparsed — the caller re-runs them locally."""
    import json as _json
    pids = sorted(set(a for a in assign if a != 0))
    shares = {p: [i for i, a in enumerate(assign) if a == p]
              for p in pids}
    waves = []
    while any(shares.values()):
        wave = {}
        for p, idxs in shares.items():
            take, budget = [], 0
            while idxs:
                size = plan[idxs[0]][2] - plan[idxs[0]][1]
                if take and budget + size > _WAVE_BUDGET:
                    break      # bound holds: never overshoot by a chunk
                take.append(idxs.pop(0))
                budget += size
            if take:
                wave[p] = take
        waves.append(wave)
    forfeited: set = set()
    for wave in waves:
        wave = {p: idxs for p, idxs in wave.items()
                if p not in forfeited}
        if not wave:
            continue
        spec_shares = {str(p): [list(plan[i][:4]) + [i] for i in idxs]
                       for p, idxs in wave.items()}
        op = "parse:" + _json.dumps(
            {"sep": setup.separator, "header": bool(setup.header),
             "shares": spec_shares})
        with _span("parse.fanout", chunks=sum(map(len, wave.values())),
                   hosts=len(wave)):
            acks = bc.collect(
                op, timeout=_fanout_timeout_s() / max(1, len(wave)))
        answered = set()
        for ack in acks:
            if not ack or not isinstance(ack.get("parse"), dict):
                continue
            answered.add(ack.get("host"))
            for sidx, cols in (ack["parse"].get("chunks") or {}).items():
                i = int(sidx)
                results[i] = [
                    (num, StrCells.from_dict(smap))
                    for num, smap in map(_wire_restore_col, cols)]
                done_flags[i] = True
        # a worker that blew the wave deadline (or died) would stall
        # every later wave for the full timeout again while holding the
        # broadcast lock — drop its remaining shares to the local
        # fallback instead
        forfeited.update(p for p in wave if p not in answered)


# ---------------------------------------------------------------------------
def parse_files(paths, setup: Optional[ParseSetup] = None,
                destination_frame: Optional[str] = None,
                col_types: Optional[dict] = None,
                chunk_bytes: Optional[int] = None,
                workers: Optional[int] = None,
                broadcaster=None) -> Frame:
    """Phases B and C: the sources (`expand_paths`) parsed chunk-parallel
    into one Frame, their rows in the order of the paths. With
    `broadcaster` the plan fans out over the cloud's live workers."""
    paths = expand_paths(paths)
    # a remote gzip or zip is staged whole first: the inflate and the
    # setup sniff need its local bytes
    staged: list = []
    try:
        for i, p in enumerate(paths):
            if p.endswith(_COMPRESSED) and _uri.is_remote(p):
                paths[i] = _uri.fetch_to_local(p)
                staged.append(paths[i])
        return _parse_files_inner(paths, setup, destination_frame,
                                  col_types, chunk_bytes, workers,
                                  broadcaster)
    finally:
        for lp in staged:
            try:
                os.unlink(lp)
            except OSError:
                pass


def _parse_files_inner(paths, setup, destination_frame, col_types,
                       chunk_bytes, workers, broadcaster=None) -> Frame:
    setup = setup or _setup_for(paths[0])
    chunk_bytes = chunk_bytes or _chunk_bytes_default()
    if setup.parse_type != "CSV":
        # ARFF, SVMLight: each file parsed whole, then row-bound
        from h2o3_tpu_torch.io.parser import parse as _parse1
        frames = [_parse1(p, None if i else setup, None, col_types)
                  for i, p in enumerate(paths)]
        return _rbind_frames(frames, destination_frame)
    # the live-worker set read ONCE: the chunk-size cap and the
    # assignment must see the same membership
    pids = broadcaster.live_pids() if broadcaster is not None else []
    if pids:
        # a chunk's codec-plane ack has to stay under the replay
        # channel's frame cap
        chunk_bytes = min(chunk_bytes, _WAVE_BUDGET)
    plain = [p for p in paths if not p.endswith(_COMPRESSED)]
    plan = plan_chunks(plain, chunk_bytes) if plain else []
    results: dict = {}
    if plan:
        done = [False] * len(plan)
        assign = [0] * len(plan)
        fan_thread = None
        if pids:
            assign = _assign_chunks(plan, [0] + pids)
            fan_thread = threading.Thread(
                target=_fan_out_parse,
                args=(broadcaster, plan, assign, setup, results, done),
                daemon=True, name="h2o3-parse-fanout")
            fan_thread.start()
        mine = [i for i, a in enumerate(assign) if a == 0]
        for i, cols in zip(
                mine, _pipelined([plan[i] for i in mine],
                                 lambda c: _tokenize_chunk(c, setup),
                                 workers or _pool_workers(len(mine) or 1))):
            results[i] = cols
            done[i] = True
        if fan_thread is not None:
            fan_thread.join()
            # a share a worker forfeited (timeout, excision) re-parses
            # locally so the frame always completes
            missing = [i for i in range(len(plan)) if not done[i]]
            for i, cols in zip(
                    missing,
                    _pipelined([plan[i] for i in missing],
                               lambda c: _tokenize_chunk(c, setup),
                               workers or _pool_workers(
                                   len(missing) or 1))):
                results[i] = cols
        for _p, start, end, _h in plan:
            INGEST_BYTES.inc(end - start, stage="tokenize")
    # the chunks in the order of the paths: each occurrence of a plain
    # path is its plan entries from one is_file_head on, and a compressed
    # member is tokenized in its place
    occ: dict = {}
    for i, entry in enumerate(plan):
        if entry[3]:
            occ.setdefault(entry[0], deque()).append([])
        occ[entry[0]][-1].append(i)
    chunks: list = []
    for p in paths:
        if p.endswith(_COMPRESSED):
            chunks.extend(_parse_compressed(p, setup, chunk_bytes, workers))
        else:
            chunks.extend(results[i] for i in occ[p].popleft())
    return _merge_chunks(chunks, setup, destination_frame, col_types)


# ---------------------------------------------------------------------------
# phase C: the merge
def _merge_chunks(chunks, setup, destination_frame, col_types) -> Frame:
    """Tokenized chunks, in row order, to one Frame: the columns merge on
    a pool of host threads, then pack into Vecs on this thread."""
    ncol = max((len(c) for c in chunks), default=0)
    names = list(setup.column_names)
    types = list(setup.column_types)
    while len(names) < ncol:
        names.append(f"C{len(names) + 1}")
        types.append(T_CAT)
    for k, v in (col_types or {}).items():
        if k in names:
            types[names.index(k)] = v
    rows_per = [len(c[0][0]) if c else 0 for c in chunks]
    n = int(sum(rows_per))
    offs = np.concatenate([[0], np.cumsum(rows_per)]).astype(np.int64)

    def merge_col(j):
        parts = [c[j] if j < len(c) else
                 (np.full(r, np.nan), StrCells.empty())
                 for c, r in zip(chunks, rows_per)]
        t = types[j]
        if t == T_NUM:
            return t, (np.concatenate([p[0] for p in parts]) if parts
                       else np.empty(0))
        if t == T_TIME:
            return t, _merge_time(parts, offs)
        if t == T_UUID:
            return t, (np.concatenate([_chunk_tokens(*p) for p in parts])
                       if parts else np.empty(0, object))
        # categorical, and string (a StrVec's sorted levels and codes are
        # the merged domain and codes)
        return (T_STR if t == T_STR else T_CAT,
                _merge_categorical(parts, n, offs))

    mw = _pool_workers(ncol or 1)
    with _span("parse.merge", cols=ncol, chunks=len(chunks), rows=n):
        if mw > 1:
            with ThreadPoolExecutor(mw) as ex:
                merged = list(ex.map(merge_col, range(ncol)))
        else:
            merged = [merge_col(j) for j in range(ncol)]
    with pack_span(cols=ncol):
        fr = _pack_merged(merged, names, ncol, destination_frame)
    for v in fr.vecs:
        ch = getattr(v, "_chunk", None)
        if ch is not None:
            INGEST_BYTES.inc(ch.nbytes, stage="pack")
    INGEST_ROWS.inc(n)
    return fr


def _pack_merged(merged, names, ncol, destination_frame) -> Frame:
    """The merged host columns packed into Vecs on the cloud's device."""
    vecs = []
    for kind, payload in merged:
        if kind in (T_NUM, T_TIME):
            vecs.append(Vec.from_numpy(payload, type=kind))
        elif kind == T_UUID:
            vecs.append(UuidVec.encode(payload))
        elif kind == T_STR:
            codes, mask, domain = payload
            vecs.append(StrVec.from_codes(
                np.where(mask, -1, codes).astype(np.int32), domain))
        else:
            codes, mask, domain = payload
            vecs.append(Vec._from_floats(codes, mask, T_CAT, domain))
    return Frame(names[:ncol], vecs, destination_frame)


def _merge_time(parts, offs: np.ndarray) -> np.ndarray:
    """A time column: the numeric cells concatenate, and each distinct
    string token parses once, then scatters to its rows."""
    num = np.concatenate([p[0] for p in parts]) if parts \
        else np.empty(0, np.float64)
    for k, (_num, cells) in enumerate(parts):
        if not len(cells):
            continue
        parsed = np.empty(len(cells.levels), np.float64)
        for i, s in enumerate(cells.levels):
            try:
                parsed[i] = _parse_time_ms(s)
            except ValueError:
                parsed[i] = np.nan
        num[cells.rows + offs[k]] = parsed[cells.codes]
    return num


def _chunk_level_codes(num: np.ndarray, cells: StrCells):
    """One chunk column to (sorted distinct tokens, int64 codes with -1
    for NA). A number's token is rebuilt by `_num_token` from its value,
    once a distinct value; -0 is its own token."""
    codes = np.full(len(num), -1, np.int64)
    nn = ~np.isnan(num)
    # np.unique folds -0.0 into 0.0, but "-0" and "0" are two tokens
    nz = nn & (num == 0.0) & np.signbit(num)
    if nz.any():
        nn &= ~nz
    u_num, inv = (np.unique(num[nn], return_inverse=True)
                  if nn.any() else (np.empty(0), np.empty(0, np.int64)))
    num_toks = np.asarray([_num_token(v) for v in u_num], dtype=object)
    parts = [num_toks, cells.levels]
    if nz.any():
        parts.append(np.asarray([_num_token(-0.0)], dtype=object))
    levels = np.unique(np.concatenate(parts)) \
        if any(len(p) for p in parts) else np.empty(0, object)
    if nn.any():
        codes[nn] = np.searchsorted(levels, num_toks)[inv.reshape(-1)]
    if len(cells):
        codes[cells.rows] = np.searchsorted(levels, cells.levels)[cells.codes]
    if nz.any():
        codes[nz] = int(np.searchsorted(levels, _num_token(-0.0)))
    return levels, codes


def _chunk_tokens(num: np.ndarray, cells: StrCells) -> np.ndarray:
    """The token strings of a chunk column (None for NA)."""
    levels, codes = _chunk_level_codes(num, cells)
    toks = np.empty(len(num), object)
    ok = codes >= 0
    toks[ok] = levels[codes[ok]]
    return toks


def _merge_categorical(parts, n: int, offs: np.ndarray):
    """EnumUpdateTask: each chunk's levels union into one sorted domain,
    each chunk's codes renumbered through a searchsorted table. Returns
    (float64 codes, NA mask, domain)."""
    per_chunk = [_chunk_level_codes(*p) for p in parts]
    all_levels = [lv for lv, _c in per_chunk if len(lv)]
    domain = np.unique(np.concatenate(all_levels)) if all_levels \
        else np.empty(0, object)
    codes = np.zeros(n, np.float64)
    mask = np.zeros(n, bool)
    for k, (levels, ccodes) in enumerate(per_chunk):
        o, e = int(offs[k]), int(offs[k]) + len(ccodes)
        na = ccodes < 0
        if len(levels):
            remap = np.searchsorted(domain, levels).astype(np.float64)
            codes[o:e][~na] = remap[ccodes[~na]]
        mask[o:e] = na
    return codes, mask, domain


def _rbind_frames(frames, dest) -> Frame:
    """Row-bind whole-file frames, categorical domains merged and codes
    renumbered as in the chunked merge."""
    if len(frames) == 1:
        f = frames[0]
        return Frame(f.names, f.vecs, dest) if dest else f
    base = frames[0]
    vecs = []
    for j in range(base.ncols):
        vts = [f.vecs[j] for f in frames]
        if vts[0].type == T_STR:
            vecs.append(Vec.from_numpy(
                np.concatenate([v.host_data for v in vts]), type=T_STR))
        elif vts[0].type == T_CAT:
            doms = [np.asarray(v.levels() or [], dtype=object) for v in vts]
            nonempty = [d for d in doms if len(d)]
            dom = np.unique(np.concatenate(nonempty)) if nonempty \
                else np.empty(0, object)
            cols = []
            for v, d in zip(vts, doms):
                c_np = v.to_numpy()
                out = np.full(len(c_np), np.nan)
                ok = ~np.isnan(c_np)
                if len(d):
                    remap = np.searchsorted(dom, d).astype(np.float64)
                    out[ok] = remap[c_np[ok].astype(np.int64)]
                cols.append(out)
            merged = np.concatenate(cols)
            mask = np.isnan(merged)
            vecs.append(Vec._from_floats(np.where(mask, 0.0, merged), mask,
                                         T_CAT, dom))
        else:
            vecs.append(Vec.from_numpy(
                np.concatenate([v.to_numpy() for v in vts]),
                type=vts[0].type))
    return Frame(list(base.names), vecs, dest)


def import_files(paths, destination_frame: Optional[str] = None,
                 col_types: Optional[dict] = None,
                 chunk_bytes: Optional[int] = None,
                 workers: Optional[int] = None,
                 broadcaster=None) -> Frame:
    """h2o.import_file of a folder, pattern, list or URI on the chunked
    parse."""
    return parse_files(paths, None, destination_frame, col_types,
                       chunk_bytes, workers, broadcaster=broadcaster)

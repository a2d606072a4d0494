"""Structured logging of the port (h2o3_tpu/utils/log.py) — water/util/Log.java
rebuilt as JSON lines. The JAX package's module, with the logger root
"h2o3_tpu_torch" so that both packages can log in one process.

Reference: Log.java keeps log4j-backed per-node rolling files plus an
in-memory buffer that GET /3/Logs serves; every node owns its own files
and the REST layer routes `/3/Logs/nodes/{node}/files/{name}` to the
node that has them. Here the same pillar is structured from the start:

  * every record is a JSON object carrying host rank, thread, level,
    logger, message, source site, and the active **trace/span ids** from
    obs/tracing + obs/timeline TLS — so a log line correlates to the
    distributed trace that produced it with zero parsing;
  * records land in a bounded in-memory ring (the GET /3/Logs working
    set) AND in durable per-process JSONL segment files under
    `<ice_root>/obs/logs` — the obs/recorder.py segment discipline:
    append-only, per-process file names prefixed with the host rank
    (processes sharing an ice root never clobber each other and the
    node-file surface stays exact), torn trailing lines skipped on
    read, GC'd oldest-first against H2O3_LOG_RETAIN_MB;
  * an ERROR-level record marks its trace for flight-recorder retention
    (a keep-rule producer: the trace of a request that logged an error
    is never lost to the downsample lottery, even when every span in it
    closed fast and 2xx);
  * `search()` answers the GET /3/Logs filters (level/since/trace/grep)
    over ring + disk, and `read_file()`/`list_files()` back the
    node-routed file download.

Hot-path design (the log4j2 async-appender analog — Log.java buffers
too): the EMITTING thread only builds the record dict, appends it to the
ring, registers the error keep-rule, and enqueues — all rendering
(stderr console line, durable JSONL, the optional H2O3_LOG_DIR rotating
text file) and the per-level counter run on one daemon drain thread, so
a record on the warm scoring path costs microseconds, not a disk flush.
WARNING-and-above records drain SYNCHRONOUSLY on the emitting thread
(they are the crash-postmortem tier: durable before the next statement
runs); `flush()` drains everything.

Env surface:
  H2O3_LOG_LEVEL         root level (default INFO)
  H2O3_LOG_STDERR_LEVEL  console line threshold (default = root level)
  H2O3_LOG_DIR           also write a classic rotating text log here
  H2O3_LOG_RING          in-memory record ring size (default 2000)
  H2O3_LOG_RETAIN_MB     durable JSONL budget under <ice_root>/obs/logs
                         (default 32; 0 disables the durable tier)
  H2O3_LOG_SEGMENT_MB    roll the active segment past this (default 4)
"""

from __future__ import annotations

import atexit
import itertools
import json
import logging
import logging.handlers
import os
import random
import sys
import threading
import time
from collections import deque

# the shared append-only segment-directory discipline (liveness check,
# listing, GC, torn-line-tolerant reads) — one implementation for the
# flight recorder and this module (json/os only: no import cycle)
from h2o3_tpu_torch.obs import segments as _segments_mod
from h2o3_tpu_torch.utils import env as _uenv

_LOGGER = None
_INIT_LOCK = threading.Lock()

_LEVELS = {"DEBUG": 10, "INFO": 20, "WARN": 30, "WARNING": 30,
           "ERROR": 40, "CRITICAL": 50}
# cached effective levels (refreshed by reinit): the fast-path shims
# must not pay an os.environ read per call
_LEVEL = 20
_STDERR_LEVEL = 20


def _retain_bytes() -> int:
    return int(_uenv.env_float("H2O3_LOG_RETAIN_MB", 32.0) * 1e6)


def _segment_bytes() -> int:
    return int(_uenv.env_float("H2O3_LOG_SEGMENT_MB", 4.0) * 1e6)


_HOST = None


def _host_id() -> int:
    global _HOST
    if _HOST is None:
        _HOST = _uenv.process_id()
    return _HOST


def log_root() -> str:
    """Durable log directory under the ice root — computed per call so a
    test repointing the ice root (io/spill.set_ice_root) takes effect on
    the next record, same as the flight recorder's default_root()."""
    from h2o3_tpu_torch.io import spill as _spill
    return os.path.join(_spill.get_ice_root(), "obs", "logs")


# ---------------------------------------------------------------------------
# in-memory ring of structured records (the GET /3/Logs working set)
_RING: deque = deque(maxlen=_uenv.env_int("H2O3_LOG_RING", 2000))

# per-record ids start at a random per-process base (the obs/timeline
# span-id discipline): ring records are usually ALSO on disk, and the
# (host, id) dedup in search() must not collide a fresh process's ids
# 1..N with a dead process's durable records
_IDS = itertools.count((random.getrandbits(31) << 20) + 1)

# records emitted while a handler itself is emitting (a callee of the
# drain that logs) must not recurse through the chain. (The hot-path
# shims below bypass stdlib LogRecord construction entirely — we do NOT
# flip logging.logProcesses globally, which would blank %(process)d for
# every other library in an embedding application.)
_TLS = threading.local()

_COUNTER = None


def _records_counter():
    """h2o3_log_records_total{level} — declared lazily (the metrics
    registry is a much later import than this module) and cached."""
    global _COUNTER
    if _COUNTER is None:
        from h2o3_tpu_torch.obs import metrics as _om
        _COUNTER = _om.counter(
            "h2o3_log_records_total",
            "structured log records emitted, labeled by level — the "
            "Grafana log-rate-by-level panel reads this")
    return _COUNTER


_DROPPED = None


def _dropped_counter():
    global _DROPPED
    if _DROPPED is None:
        from h2o3_tpu_torch.obs import metrics as _om
        _DROPPED = _om.counter(
            "h2o3_log_dropped_records_total",
            "structured log records dropped by sink-queue overload (the "
            "drain thread fell >65536 records behind) — nonzero means "
            "the durable tier and console have gaps the ring may not")
    return _DROPPED


class _DurableWriter:
    """Per-process JSONL segment writer + oldest-first retention GC —
    the obs/recorder.py segment discipline applied to log records.
    Driven by the sink's drain thread (plus synchronous urgent drains),
    serialized by the sink lock; internal state needs no lock of its
    own."""

    def __init__(self):
        self._fh = None
        self._path = None
        self._dir = None
        self._seq = 0
        self._written = 0

    def _open(self):
        d = log_root()
        os.makedirs(d, exist_ok=True)
        self._seq += 1
        self._dir = d
        # host rank leads the name: on a SHARED ice root (dev clouds,
        # tests) every process writes into one dir, and the node-routed
        # file surface (list_files/read_file) must serve only the files
        # this node owns
        self._path = os.path.join(
            d, f"h{_host_id()}-p{os.getpid()}"
               f"-{int(time.time())}-{self._seq:06d}.jsonl")
        self._fh = open(self._path, "a", encoding="utf-8")
        self._written = 0

    def _close(self):
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError:
                pass
        self._fh = None
        self._path = None
        self._written = 0

    def begin_batch(self) -> bool:
        """Per-DRAIN-BATCH validity check (not per record: the liveness
        probe is two stat() syscalls and log_root() resolves the ice
        root — a 65k-record backlog must not pay that 65k times): roll
        when the ice root was repointed (tests) or a sibling process's
        GC unlinked our open segment (appends to the dead inode would be
        invisible to every reader). Returns False when the durable tier
        is disabled (H2O3_LOG_RETAIN_MB <= 0)."""
        if _retain_bytes() <= 0:
            return False
        if self._fh is not None and \
                (self._dir != log_root()
                 or not _segments_mod.alive(self._path, self._fh)):
            self._close()
        return True

    def append(self, rec: dict):
        line = json.dumps(rec, separators=(",", ":"), default=str) + "\n"
        try:
            if self._fh is None:
                self._open()
            self._fh.write(line)
            self._written += len(line)
            if self._written >= _segment_bytes():
                self._close()
                self._gc()
        except OSError:
            # full/read-only disk must never take down the caller —
            # drop the durable tier, keep the ring + stderr alive
            self._close()

    def flush(self):
        if self._fh is not None:
            try:
                self._fh.flush()
            except OSError:
                pass

    def _segments(self) -> list:
        """(mtime, path, size) for every segment under the root, oldest
        first — every process's files, not just ours."""
        return _segments_mod.list_segments(log_root())

    def _gc(self):
        _segments_mod.gc(log_root(), _retain_bytes(),
                         keep_path=self._path)

    def disk_bytes(self) -> int:
        return sum(sz for _, _, sz in self._segments())


class _Sink:
    """Async record pipeline: enqueue() is the (cheap) hot-path entry;
    one daemon drain thread renders the console line, the durable JSONL
    append, the optional rotating text file, and the level counter.
    WARNING+ records drain synchronously."""

    _Q_CAP = 65536

    def __init__(self):
        self._q: deque = deque()
        self._lock = threading.Lock()   # serializes drains (thread +
        #                                 urgent/flush callers)
        self._thread = None
        self._started = False           # fast-path flag: is_alive() per
        #                                 record is measurable on a
        #                                 saturated host
        self._writer = _DurableWriter()
        self._rotating = None           # H2O3_LOG_DIR handler (reinit)
        self._dropped = 0

    # ---- hot path -------------------------------------------------------
    def enqueue(self, rec: dict, urgent: bool):
        _RING.append(rec)
        if rec["level"] in ("ERROR", "CRITICAL") and rec.get("trace"):
            # keep-rule producer, SYNCHRONOUS on purpose: the recorder
            # may finalize this trace before the drain thread runs
            try:
                from h2o3_tpu_torch.obs import recorder as _rec
                _rec.RECORDER.mark_error(rec["trace"])
            except Exception:   # noqa: BLE001 — best-effort correlation
                pass
        # deque append/popleft are atomic (CPython GIL): the hot path
        # must not take the drain lock per record
        self._q.append(rec)   # h2o3-ok: R003 deque ops are GIL-atomic; the drain lock serializes RENDERING, not the queue
        if len(self._q) > self._Q_CAP:
            try:
                self._q.popleft()   # h2o3-ok: R003 deque ops are GIL-atomic; worst case a drop statistic races
                self._dropped += 1   # h2o3-ok: R003 rare overload path; a lost count under race is acceptable for a drop STATISTIC
            except IndexError:
                pass
        if urgent:
            self.drain()
            with self._lock:
                self._writer.flush()
        else:
            # no per-record wake: on a CPU-saturated host, signaling the
            # drain thread per record costs two scheduler round-trips
            # that steal cycles from the device dispatch it rode along
            # with — the drain's own 0.5s poll batches instead (flush()
            # and urgent records still drain immediately)
            if not self._started:
                self._ensure_thread()

    # ---- drain side -----------------------------------------------------
    def _ensure_thread(self):
        t = self._thread
        if t is not None and t.is_alive():
            return
        with self._lock:
            t = self._thread
            if t is not None and t.is_alive():
                return
            t = threading.Thread(target=self._run, daemon=True,
                                 name="h2o3-log-drain")
            self._thread = t
            self._started = True   # under self._lock (the with-block above)
        t.start()

    def _run(self):
        # plain sleep, not an event wait: enqueue() deliberately never
        # signals this thread (per-record wakes thrash the scheduler on
        # saturated hosts); urgent records and flush() drain INLINE on
        # the caller, so nothing ever needs to wake us early
        while True:
            time.sleep(0.5)
            if self._thread is not threading.current_thread():
                return              # reinit started a newer drain
            try:
                self.drain()
                with self._lock:
                    self._writer.flush()
            except Exception:   # noqa: BLE001 — the drain must survive
                pass

    def drain(self):
        """Render every queued record (console + durable + counter).
        Callable from any thread; serialized by the sink lock."""
        with self._lock:
            stderr_lines = []
            durable = self._writer.begin_batch()
            if self._dropped:
                # overload drops must not be silent (the ring-overflow
                # lesson): publish, then reset the running count
                n, self._dropped = self._dropped, 0
                try:
                    _dropped_counter().inc(n)
                except Exception:   # noqa: BLE001 — metrics optional here
                    pass
            while True:
                try:
                    rec = self._q.popleft()
                except IndexError:
                    break
                if durable:
                    self._writer.append(rec)
                try:
                    # emit on the module-level var (not the helper's
                    # return value) so R005 sees the `level` label set
                    # and the census gates drift on it
                    _records_counter()
                    _COUNTER.inc(level=rec["level"])
                except Exception:   # noqa: BLE001 — metrics optional here
                    pass
                if _LEVELS.get(rec["level"], 0) >= _STDERR_LEVEL:
                    stderr_lines.append(_fmt(rec))
                if self._rotating is not None:
                    try:
                        self._rotating.emit(logging.makeLogRecord({
                            "name": rec.get("logger", "h2o3_tpu_torch"),
                            "levelname": rec["level"],
                            "levelno": _LEVELS.get(rec["level"], 20),
                            "msg": rec.get("msg", ""),
                            "created": rec.get("t", 0.0)}))
                    except Exception:   # noqa: BLE001
                        pass
            if stderr_lines:
                try:
                    sys.stderr.write("\n".join(stderr_lines) + "\n")
                    sys.stderr.flush()
                except (OSError, ValueError):
                    pass

    def flush(self):
        self.drain()
        with self._lock:
            self._writer.flush()


_SINK = _Sink()
atexit.register(lambda: _SINK.flush())


def _src(pathname: str, lineno) -> str:
    return f"{os.path.basename(pathname)}:{lineno}"


# cached module references for the record hot path: a `from h2o3_tpu_torch.obs
# import tracing` per record costs a sys.modules lookup + binding that a
# CPU-saturated host turns into real microseconds
_TR = None      # h2o3_tpu_torch.obs.tracing
_TL = None      # h2o3_tpu_torch.obs.timeline


def _context():
    """(trace_id, span_id) from the calling thread's obs TLS."""
    global _TR, _TL
    trace = span_id = None
    try:
        if _TR is None:
            from h2o3_tpu_torch.obs import tracing as _tracing
            _TR = _tracing
        trace = getattr(_TR._TLS, "trace_id", None)
        if trace is not None:
            if _TL is None:
                from h2o3_tpu_torch.obs import timeline as _timeline
                _TL = _timeline
            st = getattr(_TL.SPANS._tls, "stack", None)
            if st:
                span_id = st[-1].span_id
    except Exception:   # noqa: BLE001 — context is best-effort
        pass
    return trace, span_id


def _thread_name() -> str:
    name = getattr(_TLS, "tname", None)
    if name is None:
        name = _TLS.tname = threading.current_thread().name
    return name


def _make_rec(level: str, logger: str, msg: str, src: str,
              exc: str | None = None) -> dict:
    trace, span_id = _context()
    rec = {"t": time.time(), "id": next(_IDS), "host": _host_id(),
           "level": level, "logger": logger,
           "thread": _thread_name(),
           "src": src, "msg": msg}
    if exc:
        rec["exc"] = exc[-4000:]
    if trace:
        rec["trace"] = trace
    if span_id:
        rec["span"] = span_id
    return rec


class _StructuredHandler(logging.Handler):
    """Bridges stdlib-logging records (named child loggers, third-party
    emitters on the h2o3_tpu_torch tree) into the sink."""

    def emit(self, record):
        if getattr(_TLS, "emitting", False):
            return                    # a callee of ours logged: drop, do
        _TLS.emitting = True          # not recurse through the chain
        try:
            exc = None
            if record.exc_info and record.exc_info[0] is not None:
                import traceback as _tb
                exc = "".join(_tb.format_exception(*record.exc_info))
            rec = _make_rec(record.levelname, record.name,
                            record.getMessage(),
                            _src(record.pathname, record.lineno), exc)
            rec["t"] = record.created
            _SINK.enqueue(rec, urgent=record.levelno >= logging.WARNING)
        except Exception:   # noqa: BLE001 — logging must never raise
            pass
        finally:
            _TLS.emitting = False


def _build_logger() -> logging.Logger:
    global _LEVEL, _STDERR_LEVEL
    lg = logging.getLogger("h2o3_tpu_torch")   # h2o3-ok: R012 the structured logger's own root: every other module goes through get_logger()
    level = _uenv.env_str("H2O3_LOG_LEVEL", "INFO").upper()
    lg.setLevel(level)
    _LEVEL = _LEVELS.get(level, 20)
    _STDERR_LEVEL = _LEVELS.get(
        (_uenv.env_str("H2O3_LOG_STDERR_LEVEL", "") or level).upper(),
        _LEVEL)
    for h in list(lg.handlers):          # reinit(): drop stale handlers
        lg.removeHandler(h)
    lg.addHandler(_StructuredHandler())
    # classic rotating text log (-log_dir analog), rendered by the sink
    # drain so shim-path records land in it too
    rotating = None
    log_dir = _uenv.env_str("H2O3_LOG_DIR", "")
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        rotating = logging.handlers.RotatingFileHandler(
            os.path.join(log_dir, "h2o3_tpu_torch.log"),
            maxBytes=50 << 20, backupCount=3)
        rotating.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(name)s: %(message)s"))
    with _SINK._lock:
        old = _SINK._rotating
        _SINK._rotating = rotating   # under _SINK._lock — the with-block above
        if old is not None:
            try:
                old.close()
            except Exception:   # noqa: BLE001
                pass
    return lg


def get_logger(name: str | None = None) -> logging.Logger:
    """The package logger (or a named child: `get_logger("serving")` →
    "h2o3_tpu_torch.serving"). Children propagate into the structured
    handler, so per-subsystem loggers cost nothing to adopt."""
    global _LOGGER
    if _LOGGER is None:
        with _INIT_LOCK:
            if _LOGGER is None:
                _LOGGER = _build_logger()
    return _LOGGER.getChild(name) if name else _LOGGER


def reinit():
    """Rebuild the handler chain + cached levels from the current env
    (tests flip H2O3_LOG_DIR/H2O3_LOG_LEVEL and need the change to
    take)."""
    global _LOGGER, _HOST
    with _INIT_LOCK:
        _HOST = None
        _LOGGER = _build_logger()
    return _LOGGER


# ---------------------------------------------------------------------------
# fast-path shims: build the record directly (no stdlib LogRecord, no
# findCaller frame walk) — this is what hot paths and the bench pay
def _shim(level: str, lvl_no: int, msg, args):
    if _LOGGER is None:
        get_logger()                  # ensure handlers/levels configured
    if lvl_no < _LEVEL:
        return
    if args:
        try:
            msg = str(msg) % args
        except (TypeError, ValueError):
            msg = f"{msg} {args!r}"
    f = sys._getframe(2)
    _SINK.enqueue(_make_rec(level, "h2o3_tpu_torch", str(msg),
                           _src(f.f_code.co_filename, f.f_lineno)),
                 urgent=lvl_no >= 30)


def info(msg, *a):
    _shim("INFO", 20, msg, a)


def warn(msg, *a):
    _shim("WARNING", 30, msg, a)


def err(msg, *a):
    _shim("ERROR", 40, msg, a)


def debug(msg, *a):
    _shim("DEBUG", 10, msg, a)


def flush():
    _SINK.flush()


def disk_bytes() -> int:
    return _SINK._writer.disk_bytes()


# ---------------------------------------------------------------------------
# reading — ring + durable segments (GET /3/Logs and friends)
def _fmt(rec: dict) -> str:
    ts = time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(rec.get("t", 0)))
    return (f"{ts} {rec.get('level', '?')} {rec.get('logger', '?')} "
            f"[{rec.get('thread', '?')}]"
            + (f" trace={rec['trace']}" if rec.get("trace") else "")
            + f": {rec.get('msg', '')}")


def recent(n: int = 200) -> list:
    """Last n formatted log lines (water/util/GetLogsFromNode analog —
    the legacy GET /3/Logs/download body)."""
    return [_fmt(r) for r in list(_RING)[-n:]]


def records(n: int = 200) -> list:
    """Last n structured records from the ring, oldest first."""
    return [dict(r) for r in list(_RING)[-n:]]


def _iter_disk_records(newest_first: bool = True,
                       contains: str | None = None,
                       min_mtime: float | None = None):
    """Structured records from every durable segment under the log root
    — including other processes' — torn trailing lines tolerated.
    `contains` prefilters raw lines by substring before the JSON parse
    (exact for trace ids: a record carrying one contains it literally);
    `min_mtime` skips whole segments last written before it — a segment
    holds only records with t <= its mtime, so a `since` query never
    parses segments that cannot match."""
    _SINK.flush()
    segs = _SINK._writer._segments()
    if min_mtime is not None:
        segs = [s for s in segs if s[0] >= min_mtime]
    yield from _segments_mod.iter_jsonl(segs, newest_first=newest_first,
                                        contains=contains)


def search(level=None, since=None, trace=None, grep=None,
           limit: int = 200) -> list:
    """Records matching the GET /3/Logs filters, newest first, deduped
    by (host, id) across ring + disk. `level` is a minimum severity
    ("WARN" matches WARN+ERROR), `since` a unix-seconds lower bound,
    `trace` an exact trace id, `grep` a substring over the message."""
    min_lvl = _LEVELS.get(str(level).upper(), None) if level else None

    def _match(r: dict) -> bool:
        if min_lvl is not None and \
                _LEVELS.get(str(r.get("level", "")).upper(), 0) < min_lvl:
            return False
        if since is not None and float(r.get("t") or 0) < float(since):
            return False
        if trace and r.get("trace") != trace:
            return False
        if grep and grep not in str(r.get("msg", "")):
            return False
        return True

    out = []
    seen = set()
    for r in reversed(list(_RING)):
        if _match(r):
            seen.add((r.get("host"), r.get("id")))
            out.append(dict(r))
            if len(out) >= limit:
                return out
    for r in _iter_disk_records(contains=trace or None,
                                min_mtime=since):
        key = (r.get("host"), r.get("id"))
        if key in seen or not _match(r):
            continue
        seen.add(key)
        out.append(r)
        if len(out) >= limit:
            break
    return out


def trace_records(trace_id: str, limit: int = 256) -> list:
    """All records correlated to one trace, oldest first — what
    GET /3/Trace/{id} interleaves into the span view."""
    out = search(trace=trace_id, limit=limit)
    out.sort(key=lambda r: r.get("t") or 0.0)
    return out


# ---------------------------------------------------------------------------
# node-local file surface (GET /3/Logs/nodes/{node}/files/{name})
def _own_segments() -> list:
    """(mtime, path, size) of THIS node's files only: on a shared ice
    root the dir holds every host's segments, but the node-file surface
    must serve only what this node wrote."""
    prefix = f"h{_host_id()}-"
    return [(mt, p, sz) for mt, p, sz in _SINK._writer._segments()
            if os.path.basename(p).startswith(prefix)]


def list_files() -> list:
    """This node's durable log files: [{name, bytes, mtime}], newest
    first — the names `read_file` accepts."""
    _SINK.flush()
    out = [{"name": os.path.basename(p), "bytes": sz, "mtime": mt}
           for mt, p, sz in _own_segments()]
    out.reverse()
    return out


def read_file(name: str, max_bytes: int = 4 << 20) -> str | None:
    """One durable log file's content by basename ("default" = the
    newest). The name is resolved against the log dir's own listing —
    never joined from caller input — so a hostile {name} path segment
    cannot escape the directory. Returns None when absent."""
    _SINK.flush()
    segs = _own_segments()
    if not segs:
        return None
    if name in ("default", "LOG", ""):
        path = segs[-1][1]
    else:
        by_name = {os.path.basename(p): p for _, p, _sz in segs}
        path = by_name.get(os.path.basename(str(name)))
        if path is None:
            return None
    try:
        with open(path, encoding="utf-8") as fh:
            return fh.read()[-max_bytes:]
    except OSError:
        return None

"""Flight recorder of the port (h2o3_tpu/obs/recorder.py) — durable trace
retention with tail-based sampling. Segments go under the port's ice
root (io/spill.py).

The span timeline (obs/timeline) is the water.TimeLine analog: a fixed
ring that forgets everything under load, so the one trace you need after
an incident — the slow or failed request — is exactly the one that's
gone. The recorder closes that gap the Dapper way (Sigelman et al.):
completed spans stream into bounded on-disk SEGMENT files under the ice
root, and the keep/drop decision is made at TRACE COMPLETION (tail-based
sampling), when the outcome is known:

  * error traces (a span with an `error` attr, or a 5xx `status`),
  * slow traces (any span over H2O3_OBS_SLOW_MS),
  * explicitly-sampled traces (`X-H2O3-Sample: 1` → a `sampled` attr)

are ALWAYS retained; everything else is probabilistically downsampled
(H2O3_OBS_SAMPLE) so a flood of fast-OK traffic cannot evict the
interesting tail. Segments are append-only JSON lines (crash-safe: a
torn final line is skipped on read), written into a per-process file —
the io/spill.py discipline, so two processes sharing an ice root never
clobber each other — and garbage-collected oldest-first against the
H2O3_OBS_RETAIN_MB budget. Any process (including a FRESH one after a
restart) can search the shared segment directory: GET /3/Traces and the
GET /3/Trace/{id} disk read-through both land here.

Env surface:
  H2O3_OBS_RECORDER        "0" disables the recorder (default on)
  H2O3_OBS_RETAIN_MB       total on-disk segment budget (default 64)
  H2O3_OBS_SEGMENT_MB      roll the active segment past this (default 4)
  H2O3_OBS_SLOW_MS         always retain traces with a span over this
                           (default 1000)
  H2O3_OBS_SAMPLE          retention probability for fast-OK traces
                           (default 0.01)
  H2O3_OBS_TRACE_LINGER_S  finalize traces IDLE this long with the root
                           span still open (default 30) — a leaked span
                           or a thread that died mid-request; a trace
                           still streaming spans never expires
  H2O3_OBS_TRACE_MAX_SPANS finalize a trace early once it buffers this
                           many spans (default 512) — a traced training
                           loop cannot grow an unbounded buffer

Fragments: a trace can be finalized in PIECES — the buffer overflows
max-spans mid-request, or the linger timer expires while the root span is
still open. A fragment's outcome is unknowable (the `status`/`sampled`
attrs live on the still-open root), so overflow and linger-expired
fragments are always retained, explicitly-pinned traces are registered
with pin() at request ENTRY (before any outcome exists), and once any
fragment of a trace is durable the rest of that trace is kept too — the
head of an error trace must never lose the downsample lottery that its
tail would have won. The reverse ordering is covered as well: a fast-OK
fragment that DID lose the lottery (the request root closes 200 before
its background job errors) is stashed in a bounded in-memory buffer and
written retroactively — disposition "healed" — when a later fragment of
its trace is retained.
"""

from __future__ import annotations

import json
import os
import random
import time

from h2o3_tpu_torch.analysis.lockdep import make_lock
from h2o3_tpu_torch.obs import metrics as _om
from h2o3_tpu_torch.obs import segments as _segs
from h2o3_tpu_torch.utils.env import env_bool, env_float, env_int

SPANS_SEEN = _om.counter(
    "h2o3_recorder_spans_total",
    "spans reaching the flight recorder at trace completion, labeled by "
    "disposition (retained = written to a durable segment, downsampled = "
    "dropped by tail-based sampling, healed = downsampled earlier but "
    "written retroactively when a later fragment of the trace was "
    "retained — healed spans were also counted downsampled)")


def enabled() -> bool:
    return env_bool("H2O3_OBS_RECORDER", True)


def _slow_ms() -> float:
    return env_float("H2O3_OBS_SLOW_MS", 1000.0)


def _sample_rate() -> float:
    return min(1.0, max(0.0, env_float("H2O3_OBS_SAMPLE", 0.01)))


def _retain_bytes() -> int:
    return int(env_float("H2O3_OBS_RETAIN_MB", 64.0) * 1e6)


def _segment_bytes() -> int:
    return int(env_float("H2O3_OBS_SEGMENT_MB", 4.0) * 1e6)


def _linger_s() -> float:
    return env_float("H2O3_OBS_TRACE_LINGER_S", 30.0)


def _max_trace_spans() -> int:
    return env_int("H2O3_OBS_TRACE_MAX_SPANS", 512)


def default_root() -> str:
    """Shared segment directory under the ice root. Every process READS
    the whole directory; each process WRITES only its own p<pid>-* files
    (the io/spill.py per-process discipline, relaxed to a name prefix so
    a fresh process can still search a dead one's segments)."""
    from h2o3_tpu_torch.io import spill as _spill
    return os.path.join(_spill.get_ice_root(), "obs", "segments")


def _must_retain(spans: list) -> str | None:
    """The tail-sampling keep reasons, checked over the COMPLETED trace:
    returns "error" | "slow" | "sampled", or None (downsample lottery)."""
    slow = _slow_ms()
    reason = None
    for s in spans:
        attrs = s.get("attrs") or {}
        if attrs.get("error"):
            return "error"
        try:
            if int(attrs.get("status") or 0) >= 500:
                return "error"
        except (TypeError, ValueError):
            pass
        if attrs.get("sampled"):
            reason = "sampled"
        d = s.get("duration_ms")
        if reason is None and d is not None and d >= slow:
            reason = "slow"
    return reason


class FlightRecorder:
    """Per-trace span buffer + segment writer + retention GC."""

    def __init__(self, root: str | None = None):
        # one leaf lock: buffer mutations and segment appends are both
        # small host-side operations (json dumps + file write), never a
        # device sync or a network wait
        self._lock = make_lock("recorder")
        self._root = root
        self._buf: dict = {}        # trace_id -> {"spans": [...], "t0": mono}
        # FIFO-bounded id sets (insertion-ordered dicts): traces pinned
        # keep-always before their outcome exists, and traces with a
        # fragment already durable (the rest must follow it to disk)
        self._pinned: dict = {}
        self._sticky: dict = {}
        # traces a structured ERROR log record was correlated to (the
        # utils/log keep-rule producer): retained like error spans even
        # when every span in them closed fast and 2xx
        self._errored: dict = {}
        # recently-downsampled fragments, kept briefly in memory: a
        # LATER fragment of the same trace may yet error (fast-OK
        # request root closes before its background job fails) and must
        # be able to resurrect the head it would otherwise have lost
        self._dropped: dict = {}    # trace_id -> [span dicts]
        self._dropped_n = 0         # total stashed spans (bounds memory)
        self._fh = None             # active segment file handle
        self._path = None
        self._seq = 0
        self._last_scan = 0.0       # last ingest-path expiry scan (mono)
        self._written = 0           # bytes in the active segment

    # ---- wiring ---------------------------------------------------------
    def root(self) -> str:
        return self._root or default_root()

    def set_root(self, root: str | None):
        """Point the recorder elsewhere (tests use tmp dirs); closes the
        active segment so the next retained trace opens under the new
        root."""
        with self._lock:
            self._close_locked()
            self._root = root
            self._buf.clear()
            self._pinned.clear()
            self._sticky.clear()
            self._errored.clear()
            self._dropped.clear()
            self._dropped_n = 0

    def _close_locked(self):
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError:
                pass
        self._fh = None
        self._path = None
        self._written = 0

    _ID_SET_CAP = 4096

    @staticmethod
    def _remember(store: dict, tid):
        store[tid] = True
        while len(store) > FlightRecorder._ID_SET_CAP:
            store.pop(next(iter(store)))

    def pin(self, trace_id):
        """Mark a trace keep-always BEFORE its outcome is known
        (X-H2O3-Sample at request entry; the flag also rides the replay
        broadcast for worker fragments). Without this, a fragment
        finalized early — buffer overflow, linger expiry — enters the
        downsample lottery because the `sampled` attr lives on the
        still-open root span."""
        if trace_id is None or not enabled():
            return
        with self._lock:
            self._remember(self._pinned, trace_id)

    def mark_error(self, trace_id):
        """Mark a trace errored from OUTSIDE the span path — the
        structured logger calls this for every ERROR-level record that
        carries a trace id, so "request logged an error" is a keep rule
        even when no span recorded a 5xx status or an `error` attr.
        Fragments of the trace already downsampled are healed to disk
        immediately (the ERROR may arrive after a fast-OK root closed)."""
        if trace_id is None or not enabled():
            return
        with self._lock:
            self._remember(self._errored, trace_id)
            prior = self._dropped.pop(trace_id, None)
            if prior:
                self._dropped_n -= len(prior)   # under self._lock — the with-block two lines up
                SPANS_SEEN.inc(len(prior), disposition="healed")
                self._remember(self._sticky, trace_id)
                self._append_locked(prior)

    # ---- ingest (called by SpanTimeline.end, outside the ring lock) -----
    def on_span_end(self, sp):
        """Buffer one completed span under its trace; when the trace's
        ROOT span closes, the whole trace is finalized (tail decision +
        optional durable write). Untraced spans cost one attribute read."""
        tid = getattr(sp, "trace", None)
        if tid is None or not enabled():
            return
        done = []
        with self._lock:
            ent = self._buf.get(tid)
            if ent is None:
                ent = self._buf[tid] = {"spans": [], "t0": 0.0}
            ent["spans"].append(sp.to_dict())
            # t0 = LAST activity: linger expires idle traces (leaked
            # span, thread died mid-request), never one still streaming
            ent["t0"] = time.monotonic()
            if sp.parent_id == 0:
                self._buf.pop(tid, None)
                done.append((tid, ent["spans"], False))
            elif len(ent["spans"]) >= _max_trace_spans():
                self._buf.pop(tid, None)
                done.append((tid, ent["spans"], True))
            # the expiry scan is O(live traces) under this lock: gate it
            # to a fraction of the linger window so a hot span path with
            # thousands of in-flight traces doesn't pay it per span end
            # (sweep() on the read paths / metrics scrape also expires)
            now_m = time.monotonic()
            if now_m - self._last_scan >= min(1.0, _linger_s() / 4):
                self._last_scan = now_m
                for k in self._expired_locked():
                    done.append((k, self._buf.pop(k)["spans"], True))
            for t, spans, overflow in done:
                self._finalize_locked(t, spans, overflow)

    def _expired_locked(self) -> list:
        """Trace ids idle past the linger window. Idle-expired traces
        are FRAGMENTS (the root never closed), so like overflow their
        outcome is unknowable: finalize retains them."""
        cutoff = time.monotonic() - _linger_s()
        return [k for k, e in self._buf.items() if e["t0"] < cutoff]

    def sweep(self):
        """Finalize idle-expired fragments. Span ingest sweeps on every
        end; the read paths and the h2o3_recorder_bytes gauge call this
        too, so a dead thread's open-rooted fragment becomes durable
        even if no traced span ever ends again in this process."""
        if not enabled():
            return
        with self._lock:
            for k in self._expired_locked():
                self._finalize_locked(k, self._buf.pop(k)["spans"], True)

    def _finalize_locked(self, tid, spans: list, overflow: bool = False):
        reason = _must_retain(spans)
        if reason is None and tid in self._errored:
            reason = "error"        # an ERROR log record named this trace
        if reason is None and tid in self._pinned:
            reason = "sampled"
        if reason is None and tid in self._sticky:
            reason = "sticky"       # a fragment is already durable: the
            #                         rest of the trace follows it
        if reason is None and overflow:
            reason = "overflow"     # mid-trace fragment, outcome
            #                         unknowable: never drop the head
        if reason is None and random.random() >= _sample_rate():
            SPANS_SEEN.inc(len(spans), disposition="downsampled")
            self._stash_dropped_locked(tid, spans)
            return
        SPANS_SEEN.inc(len(spans), disposition="retained")
        self._remember(self._sticky, tid)
        # heal the head: fragments of THIS trace dropped earlier (their
        # own roots closed fast-OK before this one erred) go to disk too
        prior = self._dropped.pop(tid, None)   # _locked helper — every caller holds self._lock
        if prior:
            self._dropped_n -= len(prior)   # _locked helper — every caller holds self._lock
            SPANS_SEEN.inc(len(prior), disposition="healed")
            self._append_locked(prior)
        self._append_locked(spans)

    _DROPPED_SPAN_CAP = 4096

    def _stash_dropped_locked(self, tid, spans: list):
        """Remember a downsampled fragment for a while (bounded FIFO by
        total span count) so a later error fragment can resurrect it."""
        self._dropped.setdefault(tid, []).extend(spans)   # _locked helper — every caller holds self._lock
        self._dropped_n += len(spans)   # _locked helper — every caller holds self._lock
        while self._dropped_n > self._DROPPED_SPAN_CAP and self._dropped:
            old = self._dropped.pop(next(iter(self._dropped)))   # _locked helper — every caller holds self._lock
            self._dropped_n -= len(old)   # _locked helper — every caller holds self._lock

    # ---- segment writing ------------------------------------------------
    def _open_segment_locked(self):
        d = self.root()
        os.makedirs(d, exist_ok=True)
        self._seq += 1
        self._path = os.path.join(
            d, f"p{os.getpid()}-{int(time.time())}-{self._seq:06d}.jsonl")
        self._fh = open(self._path, "a", encoding="utf-8")
        self._written = 0

    def _segment_alive_locked(self) -> bool:
        """True while the active segment path still names our open file
        (obs/segments.alive — the shared overlayfs-safe inode check)."""
        return _segs.alive(self._path, self._fh)

    def _append_locked(self, spans: list):
        try:
            if self._fh is None:
                self._open_segment_locked()
            elif not self._segment_alive_locked():
                # another process's GC unlinked our open segment (oldest
                # mtime wins regardless of owner): appends to the dead
                # inode would be invisible to every reader, silently
                # losing retained traces until the size roll — roll now
                self._close_locked()
                self._open_segment_locked()
            for s in spans:
                line = json.dumps(s, separators=(",", ":"),
                                  default=str) + "\n"
                self._fh.write(line)
                self._written += len(line)
            # flush per trace: a process crash loses at most the trace
            # being appended (torn lines are skipped on read)
            self._fh.flush()
            if self._written >= _segment_bytes():
                self._close_locked()
                self._gc_locked()
        except OSError:
            # a full/readonly disk must never take down the span path —
            # drop the active segment and keep serving from memory
            self._close_locked()

    def _segments(self) -> list:
        """All segment files under the root, oldest first."""
        return _segs.list_segments(self.root())

    def _gc_locked(self):
        _segs.gc(self.root(), _retain_bytes(), keep_path=self._path)

    def disk_bytes(self) -> int:
        # gauge callback: every /metrics scrape doubles as the periodic
        # linger sweep, so idle fragments drain on scrape cadence
        self.sweep()
        return sum(sz for _, _, sz in self._segments())

    def flush(self):
        """Close the active segment (tests; also makes its bytes visible
        to other processes' GC accounting immediately)."""
        with self._lock:
            self._close_locked()

    # ---- reading --------------------------------------------------------
    def _iter_disk_spans(self, newest_first: bool = True,
                         contains: str | None = None):
        """Yield span dicts from every segment under the root — including
        other processes' — tolerating torn trailing lines. `contains`
        prefilters raw lines by substring before the (much costlier)
        JSON parse: any span carrying a trace id as its own or a link
        contains it literally, so the filter is exact for that use."""
        segs = self._segments()
        with self._lock:
            fh = self._fh
            if fh is not None:
                try:
                    fh.flush()
                except OSError:
                    pass
        yield from _segs.iter_jsonl(segs, newest_first=newest_first,
                                    contains=contains)

    def load_trace(self, trace_id: str, limit: int = 2048) -> list:
        """Every durably-retained span of one trace (the GET /3/Trace/{id}
        disk read-through), including spans that LINK the trace."""
        self.sweep()
        out = []
        for s in self._iter_disk_spans(contains=trace_id):
            if s.get("trace") == trace_id \
                    or trace_id in ((s.get("attrs") or {}).get("links")
                                    or ()):
                out.append(s)
                if len(out) >= limit:
                    break
        out.sort(key=lambda s: s.get("start") or 0.0)
        return out

    def read_through(self, trace_id: str, ring_spans: list,
                     limit: int = 2048) -> tuple:
        """Ring → disk read-through for one trace: `ring_spans` plus
        every durably-retained span not already among them, deduped by
        (host, id) — the ONE definition of span identity both the
        GET /3/Trace/{id} handler and the worker's trace: collect op
        use. Returns (spans, n_from_disk)."""
        spans = list(ring_spans)
        seen = {(s.get("host"), s.get("id")) for s in spans}
        n_disk = 0
        for s in self.load_trace(trace_id, limit=limit):
            key = (s.get("host"), s.get("id"))
            if key not in seen:
                seen.add(key)
                spans.append(s)
                n_disk += 1
        return spans, n_disk

    def search(self, name=None, route=None, status=None, min_ms=None,
               since=None, until=None, limit=50, extra_spans=()) -> list:
        """Trace summaries matching the filters, newest first — the
        GET /3/Traces body. Scans the in-memory extras (the caller passes
        the timeline ring) plus the durable segments, newest first,
        stopping once the bounded working set fills. Worst case (few
        huge traces) this parses the whole retention dir — acceptable
        for an ops endpoint bounded by H2O3_OBS_RETAIN_MB, not a hot
        path; a per-segment trace index is the upgrade if it ever is.

        Filters: `name` substring on span names; `route` substring on the
        rest.request route attr; `status` "error" (5xx / error attr) or an
        exact status code; `min_ms` minimum span duration inside the
        trace; `since`/`until` bound the trace start (unix seconds)."""
        self.sweep()
        traces: dict = {}
        order: list = []
        bound = max(limit * 8, 256)

        def _match(t) -> bool:
            if name and not any(name in n for n in t["names"]):
                return False
            if route and not (t["route"] and route in t["route"]):
                return False
            if status == "error":
                if not t["error"]:
                    return False
            elif status not in (None, "", "all"):
                if str(t["status"]) != str(status):
                    return False
            if min_ms is not None and t["max_ms"] < float(min_ms):
                return False
            if since is not None and (t["start"] or 0) < float(since):
                return False
            if until is not None and (t["start"] or 0) > float(until):
                return False
            return True

        saturated = False           # every working-set slot matches the
        #                             filters: scanning further is futile

        def _feed(s):
            nonlocal saturated
            tid = s.get("trace")
            if not tid:
                return
            t = traces.get(tid)
            if t is None:
                if len(traces) >= bound:
                    # working set full: evict a non-matching candidate —
                    # a flood of fast-OK traces must not lock a durable
                    # error trace out of a filtered search
                    victim = next((v for v in order
                                   if not _match(traces[v])), None)
                    if victim is None:
                        saturated = True
                        return
                    order.remove(victim)
                    del traces[victim]
                t = traces[tid] = {"trace": tid, "n_spans": 0,
                                   "start": None, "end": None,
                                   "root": None, "route": None,
                                   "status": None, "max_ms": 0.0,
                                   "error": False, "names": set(),
                                   "seen": set()}
                order.append(tid)
            # a retained trace's spans are usually ALSO still in the ring
            # — count each (host, id) once, not once per source
            key = (s.get("host"), s.get("id"))
            if key in t["seen"]:
                return
            t["seen"].add(key)
            t["n_spans"] += 1
            t["names"].add(s.get("name") or "")
            st, en = s.get("start"), s.get("end")
            if st is not None and (t["start"] is None or st < t["start"]):
                t["start"] = st
            if en is not None and (t["end"] is None or en > t["end"]):
                t["end"] = en
            d = s.get("duration_ms")
            if d is not None:
                t["max_ms"] = max(t["max_ms"], d)
            attrs = s.get("attrs") or {}
            if s.get("parent") == 0 and t["root"] is None:
                t["root"] = s.get("name")
            if attrs.get("route"):
                t["route"] = attrs["route"]
            if attrs.get("status"):
                t["status"] = attrs["status"]
            if attrs.get("error") or \
                    str(attrs.get("status") or "").startswith("5"):
                t["error"] = True

        # the timeline ring snapshot arrives oldest-first; admit newest
        # traces into the bounded working set first, or under load the
        # ring alone fills it and the most recent incident never matches
        for s in reversed(list(extra_spans)):
            _feed(s)
        # keep scanning disk while eviction can still admit candidates —
        # a full working set of ring traces must not end the scan before
        # an on-disk (ring-evicted) trace matching the filters is read;
        # stop only when every slot already matches (more can't rank in)
        for s in self._iter_disk_spans():
            _feed(s)
            if saturated:
                break

        out = []
        for tid in order:
            t = traces[tid]
            if not _match(t):
                continue
            dur = None
            if t["start"] is not None and t["end"] is not None:
                dur = 1000.0 * (t["end"] - t["start"])
            out.append({"trace": tid, "n_spans": t["n_spans"],
                        "root": t["root"], "route": t["route"],
                        "status": t["status"], "start": t["start"],
                        "duration_ms": dur, "max_span_ms": t["max_ms"],
                        "error": t["error"]})
        out.sort(key=lambda t: t.get("start") or 0.0, reverse=True)
        return out[:limit]


RECORDER = FlightRecorder()

_om.gauge("h2o3_recorder_bytes",
          "durable trace segment bytes on disk under the ice root "
          "(bounded by H2O3_OBS_RETAIN_MB)",
          fn=lambda: float(RECORDER.disk_bytes()))

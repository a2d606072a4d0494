"""Scorer cache of the port (h2o3_tpu/serving/scorer_cache.py) — the
serving fast path, with a CUDA graph per row bucket.

Eager `predict` launches every op of a family's scorer on every call: a
50-tree GBM walks its trees in batches of 16, hundreds of small launches
even for one row. The JAX package compiles one program per row bucket;
on the card the counterpart of a compiled program is a captured CUDA
graph:

  * Rows are padded up to POWER-OF-TWO buckets (from
    H2O3_SCORE_MIN_BUCKET; one card, so no mesh granule), so any row
    count inside a bucket replays one resident program. Padded rows carry
    NaN raw values; predictions for them are trimmed host-side, and the
    metrics path stages a weight vector that is 0 on padding.
  * ONE program per cache key runs the whole pipeline: raw staged columns
    → DataInfo.assemble_design → the family's scorer
    (`model._score_with_params(params, X)`).
  * Model params ride as a SHARED placement (serving/params.py), placed
    once per model generation; every bucket program of the model reads
    the same copy.
  * Cache key = (model key, model-object generation token, raw column
    signature, dtype, bucket). The token is minted per model OBJECT, so
    overwriting a DKV key with a retrained model can never hit the old
    program.
  * Staging: a frame whose columns are all in HBM is staged on the card
    (its own `Frame.matrix`, padded with NaN rows in the program's input);
    any other is decoded HOST-side (numpy over the packed Vec codecs, read
    in place through the pager's `staging_view`) into a bucket-sized
    buffer, as the JAX package stages every frame.

`_Program` on the card: a static (bucket, C) input on the card, a pinned
host staging buffer and a pinned output. The first dispatch runs warm-up
runs on a side stream (again on each thread's first capture of the
program: torch keeps cuBLAS handles per thread), then captures the
scorer into a CUDA graph against the params' current placement. A
dispatch copies the staged rows in without blocking, replays the graph,
copies the output back without
blocking and waits on one event — all under the program's own lock (a
graph's buffers are fixed, so two replays of one graph must not overlap;
each graph has its own memory pool). A graph bakes in the addresses it
was captured with, so the program records the (placement, gen) it was
captured against and captures again when a demote→promote, a DELETE or
an eviction re-placed the params; it never replays against freed
storage. On the CPU the program calls the same function eagerly.
`h2o3_cuda_graph_captures_total` counts the captures and
`h2o3_cuda_graph_capture_seconds` their time.

Every dispatch is metered (`obs/usage.py`: `meter("score", model,
rows)` charges its wall seconds to the request's principal) and feeds
the request's stage waterfall: on the card `device` is the time between
CUDA events recorded before the copy-in and after the replay, and
`readback` the copy-out's, read after the program's one event wait (no
second synchronize); on the CPU both are host time. After the readback
the drift tap (`obs/modelmon.py` `observe`) folds the batch into the
model's live sketch.

Env knobs:
  H2O3_SCORER_CACHE_SIZE      max resident programs (LRU; default 64)
  H2O3_SCORE_MIN_BUCKET       smallest row bucket (default 128)
  H2O3_SCORE_FASTPATH_MAX_ROWS  row-count ceiling for the fast path
                              (default 1<<20); larger batches (and 0 for
                              every batch) take the eager path
  H2O3_SCORER_PREWARM         1 → capture the smallest bucket (and place
                              params) on model publish
  H2O3_SERVE_HBM_BUDGET_MB    byte budget for device-resident model
                              params (serving/params.py)
  H2O3_SERVE_HOST_BUDGET_MB   byte budget for the host tier of demoted
                              params; overflow spills to ice_root
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
import weakref
from collections import OrderedDict

import numpy as np
import torch

from h2o3_tpu_torch.analysis.lockdep import make_lock, make_rlock
from h2o3_tpu_torch.obs import metrics as _om
from h2o3_tpu_torch.obs import modelmon as _modelmon
from h2o3_tpu_torch.obs import tracing as _tracing
from h2o3_tpu_torch.obs import usage as _usage
from h2o3_tpu_torch.obs.timeline import span as _span
from h2o3_tpu_torch.parallel import mesh as _mesh
from h2o3_tpu_torch.serving.params import PARAMS
from h2o3_tpu_torch.utils.env import env_bool, env_int

HITS = _om.counter("h2o3_scorer_cache_hits_total",
                   "scorer cache hits (no build, no capture)")
MISSES = _om.counter("h2o3_scorer_cache_misses_total",
                     "scorer cache misses (one program build each)")
EVICTIONS = _om.counter("h2o3_scorer_cache_evictions_total",
                        "scorer programs dropped by the LRU bound")
FALLBACKS = _om.counter("h2o3_scorer_fallbacks_total",
                        "scoring requests that took the eager path, "
                        "labeled by reason")
ROWS_SCORED = _om.counter("h2o3_score_rows_total",
                          "real (unpadded) rows scored via the fast path")
CAPTURES, CAPTURE_SECONDS = _om._capture_series()

# eager runs on a side stream before a capture: they create what the
# scorer's first launch creates lazily (cuBLAS handles and workspaces).
# torch keeps cuBLAS handles per thread, so each thread warms a program up
# before its first capture of it (a micro-batch leader on another thread
# recaptures after a re-placement): a handle created inside a capture
# fails it (CUBLAS_STATUS_NOT_INITIALIZED)
_WARMUP_RUNS = 2
_WARM_TLS = threading.local()       # .progs: programs this thread warmed
# one capture at a time, process-wide, on one side stream a device
_CAPTURE_LOCK = make_lock("scorer_cache.capture")
_SIDE_STREAMS: dict = {}


def _side_stream(dev):
    """The capture stream of `dev` (caller holds _CAPTURE_LOCK)."""
    s = _SIDE_STREAMS.get(dev)
    if s is None:
        s = _SIDE_STREAMS[dev] = torch.cuda.Stream(dev)
    return s


def _cache_size() -> int:
    return env_int("H2O3_SCORER_CACHE_SIZE", 64)


def _min_bucket() -> int:
    return env_int("H2O3_SCORE_MIN_BUCKET", 128)


def _max_rows() -> int:
    return env_int("H2O3_SCORE_FASTPATH_MAX_ROWS", 1 << 20)


# The card memory the resident programs' graphs may hold together. Each
# graph keeps a private pool of its scorer's intermediates, about one
# eager run's peak: a 1<<20-row bucket holds hundreds of MB to GBs. Past
# it the least recently used programs are evicted (the JAX package's
# programs hold no such pool).
GRAPH_BUDGET_BYTES = 4 << 30


def row_bucket(n: int) -> int:
    """Power-of-two bucket ≥ n (≥ the min bucket)."""
    b = _min_bucket()
    while b < n:
        b <<= 1
    return b


# ---------------------------------------------------------------------------
# host-side decode of the packed Vec planes (no device programs)
class Ineligible(Exception):
    """Raised during staging when a column cannot ride the fast path."""


def _decode_host(vec) -> np.ndarray:
    """(nrows,) f32 with NaN NAs decoded from a Vec's packed planes: the
    pager's `staging_view` reads resident host codec bytes in place (no
    copy), copies an HBM-only chunk to the host once, and loads a disk
    chunk to the host without faulting it into HBM; the codec math runs
    in numpy."""
    from h2o3_tpu_torch.core.frame import SparseVec
    n = vec.nrows
    if isinstance(vec, SparseVec):
        out = np.zeros(n, np.float32)
        rows = np.asarray(vec._nzr_chunk.staging_view()[0])
        vals = np.asarray(vec._nzv_chunk.staging_view()[0], np.float32)
        keep = rows < n
        out[rows[keep]] = vals[keep]
        return out
    ch = getattr(vec, "_chunk", None)
    if ch is None:
        raise Ineligible(f"column type {vec.type!r} has no numeric staging")
    data_h, mask_h = ch.staging_view()
    data = np.asarray(data_h)[:n]
    c = vec.codec
    if c.kind == "const":
        out = np.full(n, np.float32(c.const_val), np.float32)
    else:
        out = data.astype(np.float32)
        if c.bias:
            out = out + np.float32(c.bias)
    if mask_h is not None:
        m = np.asarray(mask_h)[:n]
        out = np.where(m != 0, np.float32(np.nan), out)
    return out


def stage_frame(dinfo, frame, rows: int) -> np.ndarray:
    """(rows, C_raw) f32 staging buffer: the ADAPTED frame's raw predictor
    columns in dinfo.raw_columns() order, NaN beyond frame.nrows."""
    cols = dinfo.raw_columns()
    raw = np.full((rows, len(cols)), np.nan, np.float32)
    n = frame.nrows
    for j, c in enumerate(cols):
        raw[:n, j] = _decode_host(frame.vec(c))
    return raw


def stage_frame_device(dinfo, frame):
    """(n, C_raw) f32 on the card — the ADAPTED frame's raw predictor
    columns decoded where they live (`Frame.matrix`, the eager path's own
    matrix) — when every one is a dense column resident in HBM; else None
    and the caller stages on the host. A frame made on the card then
    costs no copy to the host a column (the JAX package stages every
    frame on the host); the values are the host decode's bit for bit."""
    cols = dinfo.raw_columns()
    if not cols:
        return None
    for c in cols:
        ch = getattr(frame.vec(c), "_chunk", None)
        if ch is None or ch.target.type != "cuda" or ch.tier != "hbm":
            return None
    return frame.matrix(cols)


def stage_response(dinfo, frame, rows: int):
    """(y, w) host vectors at bucket size: y NaN beyond n; w is 0 on
    padding rows AND rows with missing response (the BigScore skip-NA
    contract) so padded rows drop out of every weighted aggregate."""
    n = frame.nrows
    y = np.full(rows, np.nan, np.float32)
    y[:n] = _decode_host(frame.vec(dinfo.response_name))
    w = np.zeros(rows, np.float32)
    if dinfo.weights_name and dinfo.weights_name in frame.names:
        wv = _decode_host(frame.vec(dinfo.weights_name))
        w[:n] = np.where(np.isnan(wv), 0.0, wv)
    else:
        w[:n] = 1.0
    return y, np.where(np.isnan(y), 0.0, w)


# ---------------------------------------------------------------------------
# Per-model-object generation tokens: the cache key pins the EXACT model
# object a program scores with; an overwritten DKV key maps to a
# different object, hence a different token, and the stale program can
# never be hit again.
_TOKENS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_TOKEN_COUNTER = itertools.count(1)
_TOKEN_LOCK = make_lock("scorer_cache.tokens")


def model_token(model) -> int:
    with _TOKEN_LOCK:
        t = _TOKENS.get(model)
        if t is None:
            t = _TOKENS[model] = next(_TOKEN_COUNTER)
        return t


class _Program:
    """One resident scorer program for one (model, bucket): a CUDA graph
    on the card, the same function called eagerly on the CPU.
    Param-sharing programs look up the CURRENT placement on every
    dispatch and hold one param-store reference, released exactly once
    when the entry leaves the cache — however it leaves."""

    __slots__ = ("model_key", "token", "shares_params", "_model",
                 "placement", "bucket", "ncols", "_lock", "_graph",
                 "_cap", "_static_in", "_static_out", "_stage",
                 "_host_out", "_event", "_ev_in", "_ev_run", "graph_bytes",
                 "captures", "__weakref__")

    def __init__(self, model, token, bucket: int, ncols: int,
                 placement=None, shares_params: bool = False):
        self._model = model
        self.model_key = model.key
        self.token = token
        self.shares_params = shares_params
        self.placement = placement
        self.bucket = bucket
        self.ncols = ncols
        # one replay at a time: the graph's input and output are fixed
        self._lock = make_lock("scorer_cache.program")
        self._graph = None
        self._cap = None            # (Placement, gen) captured against
        self._static_in = self._static_out = None
        self._stage = self._host_out = self._event = None
        self._ev_in = self._ev_run = None   # stage-split timing events
        self.graph_bytes = 0        # reserved bytes the last capture took
        self.captures = 0

    def _fn(self, params, raw_dev):
        di = self._model._dinfo
        X = di.assemble_design(raw_dev)
        if self.shares_params:
            return self._model._score_with_params(params, X)
        return self._model._score_matrix(X)

    def _params(self):
        if self.shares_params:
            return PARAMS.placed_ex(self._model, self.token)
        return None, None, 0

    def __call__(self, raw) -> np.ndarray:
        """Score staged rows — a (bucket, C) f32 host buffer, or the
        (n, C) rows on the card (`stage_frame_device`), padded here with
        NaN rows — and return the host result at bucket length."""
        with self._lock:
            # hold the placed params for the whole dispatch: a concurrent
            # demote cannot free them under a replay
            # h2o3-ok: R008 the params stay placed for the whole dispatch (a demote cannot free them under a replay); a fault's wait is a 0.1 ms poll while another fault's reservation commits or releases in its finally
            params, pl, gen = self._params()
            dev = _mesh.cloud().device
            if dev.type != "cuda" or (self.shares_params and pl is None):
                # the CPU, or a one-shot placement (the entry was
                # invalidated mid-flight): eager, never captured
                # h2o3-ok: R008,R015 one dispatch at a time: the readback into the program's buffers is the dispatch's work, and the lock keeps the next staging off them
                return self._eager(params, raw, dev)
            self._stage_in(raw, dev)
            if self._graph is None or self._cap != (pl, gen):
                # h2o3-ok: R008,R015 captures run under the program's lock: its static input and output buffers belong to the graph being captured
                self._capture(params, dev)
                self._cap = (pl, gen)
                # the capture's host time is no device time: on this
                # dispatch `device` is the replay alone
                self._ev_in.record()
            self._graph.replay()
            self._ev_run.record()
            self._host_out.copy_(self._static_out, non_blocking=True)
            self._event.record()
            # h2o3-ok: R008 the readback of the replay's fixed output buffer completes before the lock lets the next dispatch stage into the graph's input
            self._event.synchronize()
            if _usage.stage_active():
                # the events before it completed with the one wait above:
                # reading them adds no synchronize
                _usage.add_stage(
                    "device", self._ev_in.elapsed_time(self._ev_run) / 1e3)
                _usage.add_stage(
                    "readback", self._ev_run.elapsed_time(self._event) / 1e3)
            return self._host_out.numpy().copy()

    def _eager(self, params, raw, dev) -> np.ndarray:
        """The scorer called eagerly. On the card its device and readback
        stages come from CUDA events read after the one wait on the
        pinned copy, as a replay's do; on the CPU from the host clock."""
        cuda = dev.type == "cuda"
        if cuda:
            evs = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            evs[0].record()
        t0 = time.perf_counter()
        if torch.is_tensor(raw):
            x = torch.full((self.bucket, self.ncols), float("nan"),
                           dtype=torch.float32, device=dev)
            x[:raw.shape[0]] = raw
        else:
            x = torch.from_numpy(raw).to(dev)
        with torch.no_grad():
            out = self._fn(params, x)
        if not cuda:
            t1 = time.perf_counter()
            host = out.numpy()
            if _usage.stage_active():
                _usage.add_stage("device", t1 - t0)
                _usage.add_stage("readback", time.perf_counter() - t1)
            return host
        evs[1].record()
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        evs[2].record()
        evs[2].synchronize()
        if _usage.stage_active():
            _usage.add_stage("device", evs[0].elapsed_time(evs[1]) / 1e3)
            _usage.add_stage("readback", evs[1].elapsed_time(evs[2]) / 1e3)
        return host.numpy()

    def _stage_in(self, raw, dev):
        if self._static_in is not None and self._static_in.device != dev:
            # the cloud moved to another card: buffers and graph anew
            self._static_in = self._graph = self._static_out = None
            # h2o3-ok: R003 the only caller, __call__, holds self._lock
            self._cap = None
        if self._static_in is None:
            shape = (self.bucket, self.ncols)
            self._static_in = torch.empty(shape, dtype=torch.float32,
                                          device=dev)
            self._event, self._ev_in, self._ev_run = (
                torch.cuda.Event(enable_timing=True) for _ in range(3))
        if torch.is_tensor(raw):
            n = raw.shape[0]
            self._ev_in.record()
            self._static_in[:n].copy_(raw)
            self._static_in[n:].fill_(float("nan"))
            return
        if self._stage is None:
            self._stage = torch.empty((self.bucket, self.ncols),
                                      dtype=torch.float32, pin_memory=True)
        self._stage.numpy()[...] = raw
        self._ev_in.record()
        self._static_in.copy_(self._stage, non_blocking=True)

    def _capture(self, params, dev):
        """Warm-up runs on the side stream (this thread's first capture
        of the program only: a recapture after a re-placement runs the
        same kernels again), then one capture of the scorer against
        `params` (the staged rows are already in the input).
        torch.cuda.graph's context would also run gc.collect() and empty
        the allocator's
        cache at each capture; the program calls capture_begin and
        capture_end itself, on the process's one capture stream (whose
        cuBLAS workspace the first warm-up creates), in thread-local mode
        (other threads keep launching)."""
        t0 = time.perf_counter()
        self._graph = None          # the old graph's pool is freed first
        self._static_out = None
        cur = torch.cuda.current_stream(dev)
        warmed = getattr(_WARM_TLS, "progs", None)
        if warmed is None:
            warmed = _WARM_TLS.progs = weakref.WeakSet()
        with _CAPTURE_LOCK, torch.no_grad():
            side = _side_stream(dev)
            side.wait_stream(cur)
            if self not in warmed:
                with torch.cuda.stream(side):
                    for _ in range(_WARMUP_RUNS):
                        self._fn(params, self._static_in)
                warmed.add(self)
            # h2o3-ok: R008 captures are serialised on the one side stream: the warm-up must finish before capture_begin
            side.synchronize()
            before = torch.cuda.memory_reserved(dev)
            g = torch.cuda.CUDAGraph()
            with torch.cuda.stream(side):
                g.capture_begin(capture_error_mode="thread_local")
                try:
                    out = self._fn(params, self._static_in)
                finally:
                    g.capture_end()
            cur.wait_stream(side)
            self.graph_bytes = torch.cuda.memory_reserved(dev) - before
        self._graph = g
        self._static_out = out
        if self._host_out is None or self._host_out.shape != out.shape \
                or self._host_out.dtype != out.dtype:
            self._host_out = torch.empty(out.shape, dtype=out.dtype,
                                         pin_memory=True)
        self.captures += 1
        CAPTURES.inc()
        CAPTURE_SECONDS.observe(time.perf_counter() - t0)
        CACHE.trim_graphs(keep=self)

    def release(self):
        if self.shares_params:
            PARAMS.release(self.model_key, self.token)


class ScorerCache:
    """LRU of scorer programs, keyed by
    (model key, model-object token, raw column signature, dtype, bucket).
    """

    def __init__(self):
        self._lock = make_rlock("scorer_cache")
        self._entries: OrderedDict = OrderedDict()
        self._building: dict = {}   # key → per-key build lock
        _om.gauge("h2o3_scorer_cache_entries",
                  "scorer programs currently resident",
                  fn=lambda: float(len(self._entries)))

    def program(self, model, bucket: int):
        return self.program_ex(model, bucket)[0]

    def program_ex(self, model, bucket: int):
        """(program, warm_hit) — warm_hit distinguishes the
        "scorer.warm_hit" vs "scorer.compile" span the dispatch records."""
        di = model._dinfo
        key = (model.key, model_token(model),
               tuple(di.raw_columns()), "float32", bucket)
        with self._lock:
            fn = self._entries.get(key)
            if fn is not None:
                self._entries.move_to_end(key)
                HITS.inc()
                return fn, True
            # per-key build lock: concurrent cold misses for the same
            # program build it ONCE; one lockdep class for all of them
            build_lock = self._building.setdefault(
                key, make_lock("scorer_cache.build"))
        with build_lock:
            with self._lock:
                fn = self._entries.get(key)
                if fn is not None:
                    self._entries.move_to_end(key)
                    HITS.inc()
                    return fn, True
            MISSES.inc()
            try:
                fn = self._build(model, bucket)
            except Exception:
                with self._lock:
                    self._building.pop(key, None)
                raise
            # publish while STILL holding the build lock: a queued
            # cold-miss thread must find the entry on its double-check
            with self._lock:
                self._building.pop(key, None)
                # purge other generations of this DKV key now: entries
                # hold the model object, so a retrain loop would
                # otherwise pin dead models (and their graphs) in memory
                stale = [k for k in self._entries
                         if k[0] == key[0] and k[1] != key[1]]
                for k in stale:
                    self._entries.pop(k).release()
                    EVICTIONS.inc()
                with _BROKEN_LOCK:
                    for k in [b for b in _BROKEN
                              if b[0] == key[0] and b[1] != key[1]]:
                        _BROKEN.pop(k, None)
                self._entries[key] = fn
                if fn.shares_params and fn.placement is not None:
                    # an invalidate_key that raced this build swept the
                    # placement the entry references — re-install it
                    PARAMS.reattach(key[0], key[1], fn.placement)
                while len(self._entries) > _cache_size():
                    _, old = self._entries.popitem(last=False)
                    old.release()
                    EVICTIONS.inc()
        return fn, False

    @staticmethod
    def _build(model, bucket: int) -> "_Program":
        di = model._dinfo
        token = model_token(model)
        ncols = len(di.raw_columns())
        placement = PARAMS.acquire(model, token)
        if placement is not None:
            return _Program(model, token, bucket, ncols,
                            placement=placement, shares_params=True)
        # families without a param export score with their own state,
        # captured as it is
        return _Program(model, token, bucket, ncols)

    def programs(self, model_key: str | None = None) -> list:
        """The resident programs (of one DKV key)."""
        with self._lock:
            return [p for k, p in self._entries.items()
                    if model_key is None or k[0] == model_key]

    def trim_graphs(self, keep=None):
        """Evict least recently used programs (never `keep`) until the
        graphs fit GRAPH_BUDGET_BYTES."""
        budget = GRAPH_BUDGET_BYTES
        with self._lock:
            total = sum(p.graph_bytes for p in self._entries.values())
            for k in list(self._entries):
                if total <= budget:
                    break
                p = self._entries[k]
                if p is keep or not p.graph_bytes:
                    continue
                self._entries.pop(k).release()
                EVICTIONS.inc()
                total -= p.graph_bytes

    def invalidate_key(self, model_key: str):
        """Drop every resident program (and failure strikes) for a DKV
        model key — model deletion or retrain — releasing each entry's
        param-store reference, then sweeping any placement left."""
        with self._lock:
            for k in [k for k in self._entries if k[0] == model_key]:
                self._entries.pop(k).release()
                EVICTIONS.inc()
            with _BROKEN_LOCK:
                for b in [b for b in _BROKEN if b[0] == model_key]:
                    _BROKEN.pop(b, None)
            PARAMS.invalidate_key(model_key)

    def clear(self):
        with self._lock:
            for entry in self._entries.values():
                entry.release()
            self._entries.clear()
            PARAMS.clear()


CACHE = ScorerCache()

# (model key, token) → (consecutive failure count, last failure time).
# Three consecutive strikes PARK the model on the eager path for a
# cooldown window; after it one probe attempt is allowed — success clears
# the record, failure re-arms the window. A retrain mints a new token and
# starts clean; stale tokens are pruned on the next build for the key.
_BROKEN: dict = {}
_BROKEN_LOCK = make_lock("scorer_cache.broken")
_BROKEN_STRIKES = 3
_BROKEN_COOLDOWN_S = 60.0


def _note_failure(key: tuple):
    with _BROKEN_LOCK:
        count = _BROKEN.get(key, (0, 0.0))[0] + 1
        _BROKEN[key] = (count, time.monotonic())


def _note_success(key: tuple):
    with _BROKEN_LOCK:
        _BROKEN.pop(key, None)


def _is_broken(key: tuple) -> bool:
    with _BROKEN_LOCK:
        count, last = _BROKEN.get(key, (0, 0.0))
    if count < _BROKEN_STRIKES:
        return False
    return time.monotonic() - last < _BROKEN_COOLDOWN_S


def _fastpath_reason(model, nrows: int):
    """None when the fast path applies, else a fallback-counter label.
    One process, so the JAX package's "multihost" reason never applies."""
    di = getattr(model, "_dinfo", None)
    if di is None or not getattr(model, "key", None):
        return "no-dinfo"
    if nrows <= 0:
        return "empty"
    if nrows > _max_rows():
        return "too-large"
    if getattr(model, "_serving_fastpath", True) is False:
        return "model-opt-out"
    return None


def score_rows(model, raw, n: int, links=()) -> np.ndarray:
    """Dispatch staged rows — a (bucket, C) host buffer, or (n, C) rows
    on the card — through the cached program. Returns the HOST result
    still at bucket length (rows beyond n are garbage; callers trim).
    `links` are additional trace ids served by this dispatch."""
    bucket = row_bucket(n) if torch.is_tensor(raw) else raw.shape[0]
    fn, warm = CACHE.program_ex(model, bucket)
    # build spans ALWAYS record (rare, expensive); warm-hit spans only
    # under an active trace — the steady-state hot path pays nothing
    # when nobody is looking
    if not warm or _tracing.current() is not None or links:
        attrs = {"bucket": bucket, "rows": n, "model": model.key}
        if links:
            attrs["links"] = list(links)
        ctx = _span("scorer.warm_hit" if warm else "scorer.compile",
                    **attrs)
    else:
        ctx = contextlib.nullcontext()
    # usage attribution: the scorer is the funnel layer that knows the
    # MODEL and row count, so its meter owns the charge (kind `score`);
    # the program itself feeds the device/readback stage splits
    with ctx, _usage.meter("score", model=model.key, rows=n):
        host = fn(raw)
        ROWS_SCORED.inc(n)
    # drift tap: fold the batch into the model's live sketch (a no-op for
    # unmonitored models, and guaranteed never to break scoring)
    _modelmon.observe(model, raw, host, n)
    return host


def _fast_scored(model, frame, with_response: bool):
    """Shared eligibility + strike accounting + staged dispatch for the
    two frame entry points. Returns the fast-path result or None (eager
    path)."""
    reason = _fastpath_reason(model, frame.nrows)
    if reason is not None:
        FALLBACKS.inc(reason=reason)
        return None
    key = (model.key, model_token(model))
    if _is_broken(key):
        FALLBACKS.inc(reason="trace-error")
        return None
    try:
        di = model._dinfo
        af = di.adapt(frame)
        bucket = row_bucket(frame.nrows)
        raw = stage_frame_device(di, af)
        if raw is None:
            raw = stage_frame(di, af, bucket)
        yw = stage_response(di, af, bucket) if with_response else None
        out = score_rows(model, raw, frame.nrows)
        _note_success(key)
        return (out, *yw) if with_response else out
    except Exception:   # noqa: BLE001 — fast path must never break scoring
        _note_failure(key)
        FALLBACKS.inc(reason="trace-error")
        from h2o3_tpu_torch.utils import log as _log
        import traceback
        _log.warn(f"serving fast path failed for {key}: "
                  f"{traceback.format_exc(limit=3)}")
        return None


def score_frame(model, frame):
    """Fast-path scoring of a Frame: host result at bucket length, or
    None when the caller must take the eager path."""
    return _fast_scored(model, frame, with_response=False)


def score_frame_with_response(model, frame):
    """(out, y, w) at bucket length for the metrics path, or None for the
    eager path. w is 0 on padding and missing-response rows."""
    di = getattr(model, "_dinfo", None)
    if di is None or not di.response_name \
            or di.response_name not in frame.names:
        return None
    return _fast_scored(model, frame, with_response=True)


# ---------------------------------------------------------------------------
# Pre-warm on model publish: with H2O3_SCORER_PREWARM=1 the publish path
# builds and captures the minimum row bucket in the background, so a
# first request records a warm hit.
PREWARMS = _om.counter(
    "h2o3_scorer_prewarm_total",
    "background scorer-cache pre-warm captures completed on model "
    "publish (H2O3_SCORER_PREWARM=1)")


def prewarm_enabled() -> bool:
    return env_bool("H2O3_SCORER_PREWARM", False)


def prewarm(model, wait: bool = False):
    """Build `model`'s minimum-bucket program in a background thread —
    placing the params first — and run it once, which captures its
    graph on the card. Returns the Thread, or None when the model is
    fast-path ineligible. Failures are logged and never break the
    publish."""
    if _fastpath_reason(model, 1) is not None:
        return None
    bucket = row_bucket(1)

    def _run():
        try:
            di = model._dinfo
            raw = np.zeros((bucket, len(di.raw_columns())), np.float32)
            CACHE.program(model, bucket)(raw)
            PREWARMS.inc()
        except Exception:   # noqa: BLE001 — prewarm must never break publish
            import traceback
            from h2o3_tpu_torch.utils import log as _log
            _log.warn(f"scorer prewarm failed for {model.key}: "
                      f"{traceback.format_exc(limit=2)}")

    t = threading.Thread(target=_run, daemon=True,
                         name=f"scorer-prewarm-{model.key}")
    t.start()
    if wait:
        t.join(timeout=120.0)
    return t


def prewarm_all(wait: bool = False) -> int:
    """Prewarm every DKV-resident model's smallest-bucket program.
    Returns how many prewarms were started."""
    from h2o3_tpu_torch.core.kvstore import DKV
    threads = []
    for key in DKV.keys():
        # raw_get: a whole-registry scan must not fault spilled frames in
        m = DKV.raw_get(key)
        if getattr(m, "_dinfo", None) is None \
                or getattr(m, "key", None) != key:
            continue        # frames, vecs, misc DKV values — not models
        t = prewarm(m)
        if t is not None:
            threads.append(t)
    if wait:
        for t in threads:
            t.join(timeout=120.0)
    return len(threads)

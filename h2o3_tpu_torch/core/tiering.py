"""The chunk pager of the port: H2O's Cleaner rebuilt at chunk granularity
(h2o3_tpu/core/tiering.py, water/Cleaner.java:11, water/Value.java).

The unit of paging is one chunk: a Vec's packed codec plane and its
optional uint8 NA plane (or a StrVec's code plane, a SparseVec's nz
plane, a UuidVec's word and NA lanes). A chunk lives in up to three
tiers:

  * HBM  - CUDA tensors on the cloud's card (on the CPU cloud of the
           tests, CPU tensors): what `Vec.data` and `Vec.mask` return;
  * host - the packed numpy planes the codec produced, kept at ingest
           while tiering is on, so that a demotion frees the card's
           memory without a device-to-host copy;
  * disk - one spill file a chunk under the ice root (io/spill.py).

Demotion is least-recently-used, against `H2O3_TPU_HBM_BUDGET_MB` and
`H2O3_TPU_HOST_BUDGET_MB`. The pager counts its own chunks' bytes, as
the JAX package does, so a budget bounds the pager's planes only, and
not what consumers make of them: the decoded matrix that `Frame.matrix`
caches, or a plane a caller still holds, stays outside it. On the card
the one device gauge the pager reads is `torch.cuda.memory_allocated()`
(the caching allocator keeps freed blocks reserved, so
`memory_reserved()` would never fall): above the budget, one more LRU
chunk is demoted on each pass, as in the JAX package.

A fault copies the packed planes to the card in one transfer per plane
and decodes nothing on the host. The prefetch worker promotes the next
chunks of a `map_chunked` pass while the consumer computes: on the card
its copies run on a side stream from pinned host memory, and record a
CUDA event that the consumer's stream waits on before it reads the
planes, which it also marks with `record_stream`, so that a demotion
cannot hand their memory back while the consumer's kernels still read
it. A prefetch that fails keeps its error, and the consumer's next read
of that chunk raises it. A fault never leaves a chunk on the host in
place of the card.

Locks, in this order: a chunk's transfer lock (`_io`), then the pager's
residency lock (`_lock`). Neither is held while the key-value store's
lock is taken: frames resolve to chunks before the pager is entered.
There is no mesh, so every chunk is placed whole on the cloud's device
(the JAX package's "rows" and "flat" placements coincide), and a
chunk's rows are the frame's rows: the JAX package pads them to its
mesh (ROADMAP.md §3). The JAX package's Prometheus series and span
events wait for the obs port; `stats()` returns their counts.
"""

from __future__ import annotations

import itertools
import queue
import threading
import weakref
from collections import deque

import numpy as np
import torch

from h2o3_tpu_torch.io import spill as _spill
from h2o3_tpu_torch.utils.env import env_bool, env_int

TIER_HBM = "hbm"
TIER_HOST = "host"
TIER_DISK = "disk"
_TIERS = (TIER_HBM, TIER_HOST, TIER_DISK)


def _hbm_budget_bytes() -> int:
    return env_int("H2O3_TPU_HBM_BUDGET_MB", 0) * 2**20


def _host_budget_bytes() -> int:
    return env_int("H2O3_TPU_HOST_BUDGET_MB", 0) * 2**20


def _plane_bytes(a) -> int:
    if isinstance(a, torch.Tensor):
        return a.numel() * a.element_size()
    return int(np.prod(a.shape)) * a.dtype.itemsize


def _host_tensor(a: np.ndarray) -> torch.Tensor:
    """A CPU tensor over a host plane (shared where numpy allows it)."""
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a) if a.flags.writeable else torch.tensor(a)


def _wait_ready(ch, ev, dev):
    """Make the calling thread's stream wait for a prefetch copy, and
    mark the planes as used by it (the side stream allocated them)."""
    stream = torch.cuda.current_stream(ch.target)
    stream.wait_event(ev)
    for t in dev:
        if t is not None:
            t.record_stream(stream)
    ch._ready = None


def _fetch_dev_planes(ch, dev):
    """(data, mask or None) as numpy: the device-to-host copy shared by
    demotion and the host views. Waits for a prefetch copy in flight."""
    ev = ch._ready
    if ev is not None:
        torch.cuda.current_stream(ch.target).wait_event(ev)
    data, mask = dev
    return (data.detach().cpu().numpy(),
            None if mask is None else mask.detach().cpu().numpy())


class TierChunk:
    """One pageable plane bundle. Its planes are written once (a Vec is
    immutable after ingest), so the tiers never diverge and any copy can
    go once a colder one exists."""

    __slots__ = ("key", "nbytes", "rows", "pinned", "target", "_dev",
                 "_host", "_path", "_io", "_last", "_prefetched", "_ready",
                 "_err", "__weakref__")

    def __init__(self, key: str, dev=None, host=None, device=None):
        self.key = key
        data, mask = dev if dev is not None else host
        self.rows = int(data.shape[0])
        self.nbytes = _plane_bytes(data) + (
            _plane_bytes(mask) if mask is not None else 0)
        # the card a fault promotes to: the planes' own, or the cloud's
        # for a chunk born cold
        self.target = data.device if dev is not None else torch.device(
            device)
        self.pinned = 0
        self._dev = dev            # None: born cold, or demoted
        self._host = host          # (packed np, mask np or None) or None
        self._path = None          # the spill file while disk-resident
        self._io = threading.Lock()
        self._last = 0
        self._prefetched = False
        self._ready = None         # CUDA event of a prefetch copy
        self._err = None           # the exception of a failed prefetch

    @property
    def tier(self) -> str:
        """The warmest tier that holds the planes."""
        if self._dev is not None:
            return TIER_HBM
        if self._host is not None:
            return TIER_HOST
        return TIER_DISK

    def device(self):
        """(data, mask) tensors on the card, the read path of `Vec.data`
        and `Vec.mask`: a resident chunk costs an LRU stamp, a colder one
        faults."""
        err = self._err
        if err is not None:
            self._err = None
            raise RuntimeError(f"prefetch of {self.key} failed") from err
        dev = self._dev
        if dev is None:
            dev = PAGER.fault(self)
        else:
            self._last = PAGER.tick()
            if self._prefetched:
                self._prefetched = False
                PAGER.count_prefetch_hit()
        ev = self._ready
        if ev is not None:
            _wait_ready(self, ev, dev)
        return dev

    def host_view(self):
        """(data, mask) packed numpy planes without promoting to the
        card: a disk-resident chunk is loaded to the host tier, a
        card-resident one without a host copy is fetched."""
        host = self._host
        if host is not None:
            self._last = PAGER.tick()
            return host
        return PAGER.fault_host(self)

    def staging_view(self):
        """The packed numpy planes from the cheapest resident copy;
        never promotes."""
        dev = self._dev
        if self._host is None and dev is not None:
            return _fetch_dev_planes(self, dev)
        return self.host_view()

    def __repr__(self):
        return f"<TierChunk {self.key} {self.tier} {self.nbytes}B>"


class ChunkPager:
    """The three-tier LRU pager; one a process, like the Cleaner."""

    def __init__(self):
        self._lock = threading.Lock()
        self._chunks: dict[str, weakref.ref] = {}
        self._dead: deque = deque()   # keys of collected chunks, appended
        #                               without the lock by weakref callbacks
        self._dead_paths: dict[str, str] = {}
        # O(1) accounting: the last (presence, nbytes) of each chunk and
        # running byte totals a tier, adjusted at every transition
        self._acct: dict[str, tuple] = {}
        self._bytes = {t: 0 for t in _TIERS}
        self._ids = itertools.count(1)
        self._ticks = itertools.count(1)
        self.hbm_budget = _hbm_budget_bytes()
        self.host_budget = _host_budget_bytes()
        self._reserved = 0       # bytes admitted but not landed yet
        self._peak_hbm = 0
        self._faults = {TIER_HOST: 0, TIER_DISK: 0}
        self._evictions = {TIER_HOST: 0, TIER_DISK: 0}
        self._prefetch_hits = 0
        self._prefetch_requests = 0
        self._pf_q: queue.Queue = queue.Queue()
        self._pf_thread = None
        self._pf_streams: dict = {}

    # ---- config ----------------------------------------------------------
    @property
    def enabled(self) -> bool:
        """Tiering is on: a budget is set, or `H2O3_TPU_TIERING` asks for
        it (host copies are then kept at ingest, so demotion is free)."""
        return bool(self.hbm_budget or self.host_budget
                    or env_bool("H2O3_TPU_TIERING", False))

    @property
    def ingest_cold(self) -> bool:
        """New planes are born in the host tier (no copy to the card at
        ingest): always under an HBM budget, which an eager copy would
        overshoot before the pager could act, and on request through
        `H2O3_TPU_INGEST_COLD`."""
        return bool(self.hbm_budget
                    or env_bool("H2O3_TPU_INGEST_COLD", False))

    def tick(self) -> int:
        return next(self._ticks)

    def count_prefetch_hit(self):
        with self._lock:
            self._prefetch_hits += 1

    # ---- registration ----------------------------------------------------
    def new_chunk(self, data, mask, host=None, label: str = "",
                  pinned: int = 0, device=None) -> TierChunk:
        """Register fresh planes. `data` is None when only the packed host
        planes exist (born cold); `device` is then the card to fault to.
        `pinned` pins before registration, so that the budget pass below
        cannot pick the new chunk."""
        key = f"{label or 'chunk'}#{next(self._ids)}"
        dev = (data, mask) if data is not None else None
        ch = TierChunk(key, dev,
                       host=host if (self.enabled or dev is None) else None,
                       device=device)
        ch.pinned = pinned
        ch._last = self.tick()

        def _on_gc(_ref, _key=key, _pager=self):
            _pager._dead.append(_key)

        with self._lock:
            self._reap_locked()
            self._chunks[key] = weakref.ref(ch, _on_gc)
            self._account_locked(ch)
        self._enforce_budgets()
        return ch

    def _enforce_budgets(self):
        """The budget pass of every registration, without maybe_demote's
        snapshot of every chunk."""
        if self.hbm_budget:
            self._make_room(0)
        if self.host_budget:
            self._demote_host_tier()

    def _account_locked(self, ch: TierChunk):
        """Refresh the byte totals for `ch` (caller holds _lock). A chunk
        counts in every tier that holds a copy: an HBM-resident chunk with
        its host mirror counts in both."""
        present = (ch._dev is not None, ch._host is not None,
                   ch._path is not None)
        prev = self._acct.get(ch.key)
        if prev is not None:
            for tier, had in zip(_TIERS, prev[0]):
                if had:
                    self._bytes[tier] -= prev[1]
        self._acct[ch.key] = (present, ch.nbytes)
        for tier, has in zip(_TIERS, present):
            if has:
                self._bytes[tier] += ch.nbytes
        if present[0] and self._bytes[TIER_HBM] > self._peak_hbm:
            self._peak_hbm = self._bytes[TIER_HBM]

    def _reap_locked(self):
        while self._dead:
            key = self._dead.popleft()
            self._chunks.pop(key, None)
            acct = self._acct.pop(key, None)
            if acct is not None:
                for tier, had in zip(_TIERS, acct[0]):
                    if had:
                        self._bytes[tier] -= acct[1]
            path = self._dead_paths.pop(key, None)
            if path is not None:
                _spill.delete_chunk(path)

    def _live_locked(self) -> list:
        return [c for c in (r() for r in list(self._chunks.values()))
                if c is not None]

    # ---- accounting ------------------------------------------------------
    def tier_bytes(self) -> dict:
        with self._lock:
            self._reap_locked()
            return dict(self._bytes)

    def peak_hbm_bytes(self) -> int:
        return self._peak_hbm

    def reset_peak(self):
        """Restart the HBM high-water mark at the present occupancy."""
        with self._lock:
            self._peak_hbm = self._bytes[TIER_HBM]

    def stats(self) -> dict:
        """Occupancy, budgets and the counts the JAX package exports as
        metrics: faults by the tier faulted from, evictions by the tier
        evicted to, prefetch requests and hits, the HBM peak."""
        tb = self.tier_bytes()
        with self._lock:
            return {"tier_bytes": tb, "hbm_budget": self.hbm_budget,
                    "host_budget": self.host_budget,
                    "reserved": self._reserved,
                    "peak_hbm_bytes": self._peak_hbm,
                    "faults": sum(self._faults.values()),
                    "faults_by_tier": dict(self._faults),
                    "evictions_by_tier": dict(self._evictions),
                    "prefetch_requests": self._prefetch_requests,
                    "prefetch_hits": self._prefetch_hits}

    def _device_in_use(self, device):
        """Bytes the caching allocator has handed out on the card; None
        on the CPU, whose heap is no paging target."""
        if device is None or device.type != "cuda":
            return None
        return torch.cuda.memory_allocated(device) or None

    # ---- the ladder ------------------------------------------------------
    def _try_reserve(self, nbytes: int, force: bool = False) -> bool:
        """Admit `nbytes` of incoming HBM occupancy against the budget and
        every other promotion in flight; `force` admits regardless."""
        with self._lock:
            if force or not self.hbm_budget or \
                    self._bytes[TIER_HBM] + self._reserved + nbytes \
                    <= self.hbm_budget:
                self._reserved += nbytes
                return True
        return False

    def _release_reservation(self, nbytes: int):
        with self._lock:
            self._reserved -= nbytes

    def _side_stream(self, device):
        s = self._pf_streams.get(device)
        if s is None:
            s = self._pf_streams[device] = torch.cuda.Stream(device)
        return s

    def _to_device(self, ch, data, mask, side: bool):
        """The planes on the chunk's device; on the card, from the side
        stream with pinned memory when `side` (the prefetch worker), with
        the event the consumer waits on."""
        planes = (data, mask)
        if ch.target.type != "cuda":
            return tuple(None if a is None else _host_tensor(a)
                         for a in planes), None
        if not side:
            return tuple(None if a is None else
                         _host_tensor(a).to(ch.target) for a in planes), None
        stream = self._side_stream(ch.target)
        with torch.cuda.stream(stream):
            dev = tuple(None if a is None else _host_tensor(a).pin_memory()
                        .to(ch.target, non_blocking=True) for a in planes)
            ev = torch.cuda.Event()
            ev.record(stream)
        return dev, ev

    def fault(self, ch: TierChunk, _mark_prefetch: bool = False):
        """Promote a chunk to the card: one copy a plane, after loading
        the spill file when the chunk is on disk. The HBM bytes are
        reserved before the copy, so a consumer and the prefetch worker
        faulting together cannot overshoot the budget; the spill file
        goes only after the promotion landed."""
        src = ch.tier
        forced = False
        while True:
            with ch._io:
                dev = ch._dev
                if dev is not None:        # another thread promoted it
                    return dev
                if self._try_reserve(ch.nbytes, force=forced):
                    path = None
                    try:
                        data, mask = self._host_planes(ch)
                        dev, ev = self._to_device(ch, data, mask,
                                                  _mark_prefetch)
                        with self._lock:
                            ch._ready = ev
                            ch._dev = dev
                            ch._last = self.tick()
                            ch._host = (data, mask) if self.enabled else None
                            path, ch._path = ch._path, None
                            self._dead_paths.pop(ch.key, None)
                            self._account_locked(ch)
                            if _mark_prefetch:
                                ch._prefetched = True
                    finally:
                        self._release_reservation(ch.nbytes)
                    if path is not None:
                        _spill.delete_chunk(path)
                    break
            # over budget: demote outside the transfer lock, then retry; a
            # pass that freed nothing forces admission, so a chunk larger
            # than the whole budget still faults
            forced = not self._make_room(ch.nbytes, exclude=ch)
        self._note_fault(src)
        self._demote_host_tier()
        return dev

    def fault_host(self, ch: TierChunk):
        """Make the packed host planes exist (disk to host, or a fetch of
        a chunk born on the card) without touching HBM."""
        with ch._io:
            host = ch._host
            if host is not None:
                return host
            dev = ch._dev
            if dev is not None:
                host = _fetch_dev_planes(ch, dev)
            else:
                host = _spill.read_chunk(ch._path)
            stale = None
            with self._lock:
                ch._host = host
                if ch._dev is None:
                    stale, ch._path = ch._path, None
                    self._dead_paths.pop(ch.key, None)
                ch._last = self.tick()
                self._account_locked(ch)
            if stale is not None:
                _spill.delete_chunk(stale)
        if ch._dev is None:
            self._note_fault(TIER_DISK)
        self._demote_host_tier()
        return host

    def demote(self, ch: TierChunk, to_tier: str):
        """Push a chunk down: HBM to host drops every reference to its
        tensors (their memory returns to the caching allocator); host to
        disk writes the spill file and frees the host planes."""
        if to_tier not in (TIER_HOST, TIER_DISK):
            raise ValueError(f"demote target {to_tier!r}")
        moved = False
        with ch._io:
            if ch._dev is not None:
                if ch._host is None:
                    ch._host = _fetch_dev_planes(ch, ch._dev)
                with self._lock:
                    ch._dev = None
                    ch._ready = None
                    self._account_locked(ch)
                moved = True
            if to_tier == TIER_DISK and ch._host is not None:
                data, mask = ch._host
                path = _spill.write_chunk(ch.key, data, mask)
                with self._lock:
                    ch._path = path
                    ch._host = None
                    self._dead_paths[ch.key] = path
                    self._account_locked(ch)
                moved = True
        if moved:
            with self._lock:
                self._evictions[to_tier] += 1

    def _host_planes(self, ch: TierChunk):
        """The packed host planes for a fault (caller holds ch._io); reads
        only, so a failed copy leaves the chunk recoverable."""
        if ch._host is not None:
            return ch._host
        return _spill.read_chunk(ch._path)

    def _note_fault(self, src: str):
        if src != TIER_HBM:
            with self._lock:
                self._faults[src] += 1

    # ---- budget enforcement ---------------------------------------------
    def _victims_locked(self, tier: str, exclude) -> list:
        """Live unpinned chunks on `tier`, coldest first."""
        out = [c for c in self._live_locked()
               if c.tier == tier and not c.pinned and c is not exclude]
        out.sort(key=lambda c: c._last)
        return out

    def _make_room(self, incoming: int, exclude=None) -> bool:
        """Demote LRU HBM chunks until `incoming` more bytes (and every
        reservation) fit the budget, before the promotion lands. False
        when a pass demoted nothing: the caller then forces admission."""
        if not self.hbm_budget:
            return True
        # memory the pager does not own (models, matrices) over the
        # budget: relieved by one LRU demotion a pass, never by draining
        # the working set, which that memory may outweigh for good
        used = self._device_in_use(exclude.target if exclude is not None
                                   else None)
        if used is not None and used > self.hbm_budget:
            with self._lock:
                vic = next(iter(self._victims_locked(TIER_HBM, exclude)),
                           None)
            if vic is not None:
                self.demote(vic, TIER_HOST)
        demoted = False
        while True:
            with self._lock:
                self._reap_locked()
                if self._bytes[TIER_HBM] + self._reserved + incoming \
                        <= self.hbm_budget:
                    return True
                vic = next(iter(self._victims_locked(TIER_HBM, exclude)),
                           None)
            if vic is None:
                return demoted
            self.demote(vic, TIER_HOST)
            demoted = True

    def _demote_host_tier(self):
        """Spill LRU host-tier chunks to disk while over the host budget;
        the host mirror of an HBM-resident chunk is dropped instead."""
        if not self.host_budget:
            return
        while True:
            with self._lock:
                self._reap_locked()
                if self._bytes[TIER_HOST] <= self.host_budget:
                    return
                cands = [c for c in self._live_locked()
                         if c._host is not None and not c.pinned]
                cands.sort(key=lambda c: c._last)
                vic = cands[0] if cands else None
            if vic is None:
                return
            if vic._dev is not None:
                self._drop_host_mirror(vic)
            else:
                self.demote(vic, TIER_DISK)

    def _drop_host_mirror(self, ch: TierChunk):
        with ch._io:
            if ch._dev is None or ch._host is None:
                return
            with self._lock:
                ch._host = None
                self._account_locked(ch)

    def maybe_demote(self) -> list:
        """Enforce both budgets (the Cleaner's wake-up); returns the keys
        of the chunks demoted. Free without a budget."""
        if not (self.hbm_budget or self.host_budget):
            return []
        with self._lock:
            self._reap_locked()
            before = {c.key: (c, c.tier) for c in self._live_locked()}
        self._make_room(0)
        self._demote_host_tier()
        return [k for k, (c, t) in before.items() if c.tier != t]

    # ---- frame-level hooks -----------------------------------------------
    def touch_chunks(self, chunks):
        for ch in chunks:
            if ch is not None:
                ch._last = self.tick()

    def on_frame_get(self, chunks):
        """DKV.get hook: LRU-touch, and when every chunk is on disk (a
        spilled frame) load the planes back to host memory; HBM faults
        stay lazy."""
        chunks = [c for c in chunks if c is not None]
        if not chunks:
            return
        self.touch_chunks(chunks)
        if all(c.tier == TIER_DISK for c in chunks):
            for c in chunks:
                c.host_view()

    # ---- prefetch (the MRTask lookahead) ---------------------------------
    def prefetch(self, handles):
        """Queue promotions on the worker thread, so the next chunk's copy
        overlaps the current chunk's compute. Takes TierChunks or Vecs
        (their `_chunk`)."""
        started = False
        for h in handles:
            ch = getattr(h, "_chunk", h)
            if not isinstance(ch, TierChunk) or ch._dev is not None:
                continue
            with self._lock:
                self._prefetch_requests += 1
            self._pf_q.put(weakref.ref(ch))
            started = True
        if started:
            self._ensure_worker()

    def _ensure_worker(self):
        with self._lock:
            if self._pf_thread is not None and self._pf_thread.is_alive():
                return
            t = threading.Thread(target=self._pf_loop, daemon=True,
                                 name="h2o3-tier-prefetch")
            self._pf_thread = t
            t.start()       # inside the lock: a racing caller sees it alive

    def _pf_loop(self):
        while True:
            ch = self._pf_q.get()()
            if ch is None or ch._dev is not None:
                continue
            try:
                # the hit flag is set only when this call did the
                # promotion, not when it lost the race to the consumer
                self.fault(ch, _mark_prefetch=True)
            except Exception as e:  # noqa: BLE001 - raised at the next read
                ch._err = e


PAGER = ChunkPager()

"""Minimal distributed-key-value store of the port (h2o3_tpu/core/kvstore.py).

One process, one dictionary: frames and models register under a key so
`model_id` and frame keys resolve. `get` runs a value's `_tier_on_get`
hook (a Frame's chunks are touched, and loaded back from disk when the
whole frame was spilled) outside the registry lock, so pager I/O never
nests under it; `raw_get` skips the hook; `remove` runs `_on_remove`, and
`put` over another value runs the old value's `_on_replace` (a retrained
model frees its predecessor's serving residency), both outside the lock.
The registry lock is the lockdep class `dkv`.
`put` and `remove` report each mutation to `_div_hook` when the
divergence sanitizer is on (analysis/divergence.py).

Homes and re-home (the JAX package's): every key has a home node on a
consistent-hash ring (`HashRing`, Key.java:169's home hash rebuilt so a
membership change moves a bounded key set). The elastic layer
(deploy/membership) calls `set_membership` on every epoch bump; the keys
whose ring arc moved are re-homed by a background worker that packs each
chunk's codec planes into the compact wire form (`_plane_payload`: an
npz of the packed data and the u8 mask, never decoded floats), restores
them, checks them bit for bit and installs the shipped copy, while reads
go on answering from the old home. `atomic` waits for a caller, as
before.
"""

from __future__ import annotations

import bisect
import hashlib
import io as _io
import threading
from typing import Any

import numpy as np

from h2o3_tpu_torch.analysis.lockdep import make_rlock
from h2o3_tpu_torch.obs import metrics as _om
from h2o3_tpu_torch.obs.timeline import span as _span

REHOMED_KEYS = _om.counter(
    "h2o3_dkv_rehome_keys_total",
    "DKV keys re-homed after a membership change (consistent-hash ring "
    "moved their home node)")
REHOMED_BYTES = _om.counter(
    "h2o3_dkv_rehome_bytes_total",
    "compact codec bytes shipped by DKV re-home migrations (packed "
    "data+mask planes via the tier pager, never device arrays)")

class HashRing:
    """Consistent-hash key→home-node map — the Key.java:169 home-node
    hash rebuilt so membership changes move a BOUNDED key set.

    The reference hashes `key % cloud_size`: adding or losing one node
    re-homes nearly every key. A ring of `vnodes` virtual points per node
    moves only the keys whose arc changed — on average 1/n of them for a
    single node join/leave."""

    def __init__(self, nodes, vnodes: int = 64):
        self.nodes = sorted(set(int(n) for n in nodes))
        self.vnodes = int(vnodes)
        points = []
        for n in self.nodes:
            for v in range(self.vnodes):
                points.append((self._hash(f"node:{n}:{v}"), n))
        points.sort()
        self._points = points
        self._keys = [p[0] for p in points]

    @staticmethod
    def _hash(s: str) -> int:
        return int.from_bytes(
            hashlib.md5(s.encode()).digest()[:8], "big")

    def node_for(self, key: str) -> int:
        if not self._points:
            return 0
        h = self._hash(key)
        i = bisect.bisect_right(self._keys, h)
        if i == len(self._points):
            i = 0
        return self._points[i][1]


def _plane_payload(data: np.ndarray, mask) -> bytes:
    """Serialize packed codec planes to the compact wire form a re-home
    move ships (npz of the dtype-packed data + optional u8 mask — the
    tier pager's host-tier representation, never decoded f32, never a
    device array)."""
    buf = _io.BytesIO()
    if mask is None:
        np.savez(buf, data=data)
    else:
        np.savez(buf, data=data, mask=mask)
    return buf.getvalue()


def _plane_restore(payload: bytes):
    with np.load(_io.BytesIO(payload)) as z:
        return z["data"], (z["mask"] if "mask" in z.files else None)


# replay-divergence sanitizer seam (analysis/divergence.py): its _record
# function while H2O3_DIVERGENCE is on, else None (one global load a
# mutation)
_div_hook = None


class _DKV:
    def __init__(self):
        self._mutex = make_rlock("dkv")
        self._store: dict[str, Any] = {}
        self._counter = 0
        # elastic membership: home-node map + background re-home state.
        # A cloud of one process homes everything on node 0 and none of
        # this moves.
        self._ring = HashRing([0])
        self._homes: dict[str, int] = {}
        self._migrating: set = set()
        self._rehome_epoch = 1
        self._rehome_keys_moved = 0
        self._rehome_bytes_moved = 0
        self._rehome_thread = None
        self._rehome_queue: list = []
        self._rehome_hook = None    # test seam: called per migrated key

    def put(self, key: str, value: Any) -> str:
        with self._mutex:
            old = self._store.get(key)
            self._store[key] = value
            # an existing home stays until its planes moved (the
            # read-through contract); a new key takes the ring's answer
            if key not in self._homes:
                self._homes[key] = self._ring.node_for(key)
        # outside the mutex like _on_remove, so cache and pager locks
        # never nest under `dkv`
        if old is not None and old is not value \
                and hasattr(old, "_on_replace"):
            old._on_replace()
        hk = _div_hook
        if hk is not None:
            hk("put", key, value)
        return key

    def get(self, key: str, default=None):
        with self._mutex:
            v = self._store.get(key, default)
        hook = getattr(v, "_tier_on_get", None)
        if hook is not None:
            hook()
        return v

    def raw_get(self, key: str, default=None):
        """The stored value without the tier hook: accounting and cleaning
        must not fault demoted chunks back in."""
        with self._mutex:
            return self._store.get(key, default)

    def __contains__(self, key) -> bool:
        with self._mutex:
            return key in self._store

    def keys(self) -> list[str]:
        with self._mutex:
            return sorted(self._store.keys())

    def remove(self, key: str):
        with self._mutex:
            v = self._store.pop(key, None)
            self._homes.pop(key, None)
            self._migrating.discard(key)
        if v is not None and hasattr(v, "_on_remove"):
            v._on_remove()
        hk = _div_hook
        if hk is not None:
            hk("remove", key, None)

    def clear(self):
        with self._mutex:
            self._store.clear()
            self._homes.clear()
            self._migrating.clear()
            self._rehome_queue.clear()

    def stats(self) -> dict:
        """Registry census: live keys, frames and their bytes, without
        faulting spilled frames back in (raw_get). The port has no write
        locks, so `write_locked` is 0."""
        with self._mutex:
            keys = list(self._store.keys())
        from h2o3_tpu_torch.core.frame import Frame
        from h2o3_tpu_torch.core.memory import MANAGER
        nframes = 0
        fbytes = 0
        for k in keys:
            v = self.raw_get(k)
            if isinstance(v, Frame):
                nframes += 1
                try:
                    fbytes += MANAGER.frame_bytes(v)
                except Exception:   # noqa: BLE001 — census must never raise
                    pass
        return {"keys": len(keys), "frames": nframes,
                "frame_bytes": fbytes, "write_locked": 0}

    # ---- elastic membership: homes + background re-home -----------------
    def home_of(self, key: str) -> int:
        """The node currently SERVING this key. During a migration the
        old home keeps answering (read-through) — home_of flips to the
        ring's new assignment only once the key's planes landed."""
        with self._mutex:
            if key in self._homes:
                return self._homes[key]
            return self._ring.node_for(key)

    def ring_nodes(self) -> list:
        with self._mutex:
            return list(self._ring.nodes)

    def set_membership(self, nodes, epoch: int = None):
        """Rebuild the consistent-hash ring for a new membership epoch
        and queue the BOUNDED set of keys whose home moved for
        background re-home. Returns the list of keys that will move.
        Called by the deploy/membership listener on every epoch bump."""
        ring = HashRing(nodes)
        with self._mutex:
            if epoch is not None:
                self._rehome_epoch = epoch
            self._ring = ring
            moved = [k for k, home in self._homes.items()
                     if ring.node_for(k) != home
                     and k not in self._migrating]
            self._migrating.update(moved)
            self._rehome_queue.extend(moved)
            if moved:
                self._ensure_rehome_worker_locked()
        return moved

    def _ensure_rehome_worker_locked(self):
        # a live _rehome_thread is still inside its drain loop and will
        # observe the keys just queued (retirement happens under this
        # mutex); None means retired or never started — spawn
        if self._rehome_thread is not None:
            return
        t = threading.Thread(target=self._rehome_loop, daemon=True,
                             name="h2o3-dkv-rehome")
        self._rehome_thread = t   # h2o3-ok: R003 _locked helper — every caller holds self._mutex (retirement in _rehome_loop is mutex-held too)
        t.start()

    def _rehome_loop(self):
        """Background DKV re-home: drain the moved-key queue, shipping
        each key's compact codec-byte planes to its new home. Read
        serving is untouched while this runs — DKV.get answers from the
        registry and home_of() keeps naming the old home until the
        per-key swap below."""
        while True:
            with self._mutex:
                if not self._rehome_queue:
                    # retire UNDER the mutex: set_membership's spawn
                    # check is serialized against this, so an enqueue
                    # either lands before this check (we keep draining)
                    # or sees _rehome_thread cleared and spawns a fresh
                    # worker — queued keys can never strand
                    self._rehome_thread = None
                    return
                key = self._rehome_queue.pop(0)
            try:
                self._migrate_key(key)
            except Exception as ex:   # noqa: BLE001 — a failed move must
                from h2o3_tpu_torch.utils import log as _ulog  # not kill the loop
                _ulog.err("dkv re-home of %r failed: %r", key, ex)
                with self._mutex:
                    self._migrating.discard(key)

    def _migrate_key(self, key: str):
        """Move one key to its ring home: pack each chunk's codec-byte
        planes (the tier pager's host-tier form — compact bytes, not
        device arrays), round-trip them through the wire encoding, verify
        bit-exactness per plane, install the shipped copies, then flip
        home_of. Values without packed chunks (models, jobs) move as
        zero-byte control records. A chunk of a frame of several ranks
        holds this rank's rows, and those are the bytes that move."""
        v = self.raw_get(key)
        if v is None:                     # removed while queued
            with self._mutex:
                self._migrating.discard(key)
            return
        hook = self._rehome_hook
        if hook is not None:
            hook(key)                     # test seam: pause mid-migration
        moved_bytes = 0
        with _span("membership.rehome", key=key):
            for ch in self._value_chunks(v):
                data, mask = ch.staging_view()
                payload = _plane_payload(data, mask)
                rdata, rmask = _plane_restore(payload)
                if rdata.tobytes() != data.tobytes() or (
                        (mask is None) != (rmask is None)) or (
                        mask is not None
                        and rmask.tobytes() != mask.tobytes()):
                    raise RuntimeError(
                        f"re-home payload of {key!r} not bit-exact")
                moved_bytes += len(payload)
                # install the SHIPPED copy as the chunk's host planes —
                # the new home serves exactly the bytes that moved
                with ch._io:
                    if ch._host is not None:
                        ch._host = (rdata,
                                    None if rmask is None else rmask)
        with self._mutex:
            self._homes[key] = self._ring.node_for(key)
            self._migrating.discard(key)
            self._rehome_keys_moved += 1
            self._rehome_bytes_moved += moved_bytes
        REHOMED_KEYS.inc()
        if moved_bytes:
            REHOMED_BYTES.inc(moved_bytes)

    @staticmethod
    def _value_chunks(v):
        """The tier chunks backing a DKV value (a Frame's Vec planes);
        empty for plain control objects."""
        out = []
        for vec in getattr(v, "vecs", []) or []:
            ch = getattr(vec, "_chunk", None)
            if ch is not None:
                out.append(ch)
            codes = getattr(vec, "_codes_chunk", None)
            if codes is not None:   # StrVec dictionary code plane
                out.append(codes)
            for attr in ("_nzr_chunk", "_nzv_chunk", "_uuid_chunk"):
                nz = getattr(vec, attr, None)
                if nz is not None:  # SparseVec nz planes / UuidVec lanes
                    out.append(nz)
        return out

    def rehome_status(self) -> dict:
        """GET /3/Cloud's re-home view (and the test harness's barrier)."""
        with self._mutex:
            return {"epoch": self._rehome_epoch,
                    "pending": len(self._migrating),
                    "keys_moved": self._rehome_keys_moved,
                    "bytes_moved": self._rehome_bytes_moved,
                    "nodes": list(self._ring.nodes)}

    def make_key(self, prefix: str = "obj") -> str:
        """Deterministic keys, as in the JAX package: prefix + counter."""
        with self._mutex:
            self._counter += 1
            return f"{prefix}_{self._counter:04d}"


DKV = _DKV()

# module-level registration reading the module global (the microbatch
# pattern: survives a test harness swapping DKV out)
_om.gauge("h2o3_dkv_rehome_pending",
          "DKV keys queued or mid-flight in the background re-home "
          "worker (reads serve through the old home until this drains)",
          fn=lambda: float(len(DKV._migrating)))

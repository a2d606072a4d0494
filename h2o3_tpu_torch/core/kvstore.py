"""Minimal distributed-key-value store of the port (h2o3_tpu/core/kvstore.py).

One process, one dictionary: frames and models register under a key so
`model_id` and frame keys resolve. `get` runs a value's `_tier_on_get`
hook (a Frame's chunks are touched, and loaded back from disk when the
whole frame was spilled) outside the registry lock, so pager I/O never
nests under it; `raw_get` skips the hook; `remove` runs `_on_remove`, and
`put` over another value runs the old value's `_on_replace` (a retrained
model frees its predecessor's serving residency), both outside the lock.
The registry lock is the lockdep class `dkv`.
Replication and homes are the JAX package's and wait for the
compute-substrate item of ROADMAP.md; `rehome_status` answers for the one
process. `put` and `remove` report each mutation to `_div_hook`
when the divergence sanitizer is on (analysis/divergence.py).
"""

from __future__ import annotations

from typing import Any

from h2o3_tpu_torch.analysis.lockdep import make_rlock

# replay-divergence sanitizer seam (analysis/divergence.py): its _record
# function while H2O3_DIVERGENCE is on, else None (one global load a
# mutation)
_div_hook = None


class _DKV:
    def __init__(self):
        self._mutex = make_rlock("dkv")
        self._store: dict[str, Any] = {}
        self._counter = 0

    def put(self, key: str, value: Any) -> str:
        with self._mutex:
            old = self._store.get(key)
            self._store[key] = value
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
        if v is not None and hasattr(v, "_on_remove"):
            v._on_remove()
        hk = _div_hook
        if hk is not None:
            hk("remove", key, None)

    def clear(self):
        with self._mutex:
            self._store.clear()

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

    def rehome_status(self) -> dict:
        """GET /3/Cloud's re-home view. One process is one home (node 0):
        nothing is ever queued or moved."""
        return {"epoch": 1, "pending": 0, "keys_moved": 0,
                "bytes_moved": 0, "nodes": [0]}

    def make_key(self, prefix: str = "obj") -> str:
        """Deterministic keys, as in the JAX package: prefix + counter."""
        with self._mutex:
            self._counter += 1
            return f"{prefix}_{self._counter:04d}"


DKV = _DKV()

"""Minimal distributed-key-value store of the port (h2o3_tpu/core/kvstore.py).

One process, one dictionary: frames and models register under a key so
`model_id` and frame keys resolve. `get` runs a value's `_tier_on_get`
hook (a Frame's chunks are touched, and loaded back from disk when the
whole frame was spilled) outside the registry lock, so pager I/O never
nests under it; `raw_get` skips the hook; `remove` runs `_on_remove`.
Replication, homes and divergence checks are the JAX package's and wait
for the compute-substrate item of ROADMAP.md.
"""

from __future__ import annotations

import threading
from typing import Any


class _DKV:
    def __init__(self):
        self._mutex = threading.Lock()
        self._store: dict[str, Any] = {}
        self._counter = 0

    def put(self, key: str, value: Any) -> str:
        with self._mutex:
            self._store[key] = value
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

    def clear(self):
        with self._mutex:
            self._store.clear()

    def make_key(self, prefix: str = "obj") -> str:
        """Deterministic keys, as in the JAX package: prefix + counter."""
        with self._mutex:
            self._counter += 1
            return f"{prefix}_{self._counter:04d}"


DKV = _DKV()

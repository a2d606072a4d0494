"""Minimal distributed-key-value store of the port (h2o3_tpu/core/kvstore.py).

One process, one dictionary: frames and models register under a key so
`model_id` and frame keys resolve. Replication, homes, tiering and
divergence checks are the JAX package's and wait for later slices.
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
            return self._store.get(key, default)

    def keys(self) -> list[str]:
        with self._mutex:
            return sorted(self._store.keys())

    def remove(self, key: str):
        with self._mutex:
            self._store.pop(key, None)

    def clear(self):
        with self._mutex:
            self._store.clear()

    def make_key(self, prefix: str = "obj") -> str:
        """Deterministic keys, as in the JAX package: prefix + counter."""
        with self._mutex:
            self._counter += 1
            return f"{prefix}_{self._counter:04d}"


DKV = _DKV()

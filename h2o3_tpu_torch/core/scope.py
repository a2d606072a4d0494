"""Temporary keys freed on exit (h2o3_tpu/core/scope.py, water/Scope.java).

`with scope(keep=[model.key]):` removes from the key-value store every key
created inside the block, and every key `track()`ed there, except those
kept, so intermediate frames release their chunks.
"""

from __future__ import annotations

import contextlib
import threading

from h2o3_tpu_torch.core.kvstore import DKV

_tls = threading.local()


def _stack():
    if not hasattr(_tls, "stack"):
        _tls.stack = []
    return _tls.stack


def track(key: str) -> str:
    if _stack():
        _stack()[-1].add(key)
    return key


def untrack(key: str):
    for fr in _stack():
        fr.discard(key)


@contextlib.contextmanager
def scope(keep=()):
    """Everything created inside, and not kept, is removed on exit."""
    before = set(DKV.keys())
    frame: set = set()
    _stack().append(frame)
    try:
        yield frame
    finally:
        _stack().pop()
        created = (set(DKV.keys()) - before) | frame
        keepset = set(keep if not isinstance(keep, str) else [keep])
        for k in created - keepset:
            DKV.remove(k)

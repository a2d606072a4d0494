"""Runtime replay-divergence sanitizer, its local half (H2O3_DIVERGENCE=1|log).

While a routed request executes, every replicated-state mutation (DKV
put/remove, hooked through `kvstore._div_hook`, installed only when
enabled; the port's store has no `atomic` until a caller needs one) folds `(op, key, value-digest)` into a per-request digest, kept
under the request's sequence number (`local_begin`/`local_end`).

The JAX package also digests each worker's replay and compares it with the
coordinator's (the riders on the replay channel's acks). The port has one
process and no broadcaster, so nothing is compared yet: that half waits
for the multi-device item of ROADMAP.md (with DivergenceError and
`raise_if_pending`).

Digest caveat: tensors, frames and models are digested by type only (no
device sync on the mutation path; a sanitizer must not perturb what it
observes).
"""

from __future__ import annotations

import hashlib
import threading

from h2o3_tpu_torch.utils.env import env_str

_MAX_TRACK = 512        # per-seq summaries kept before dropping oldest
_MAX_ENTRIES = 128      # per-request mutation entries kept verbatim

_mode = ""              # "" (off) | "log" | "raise"
_lock = threading.Lock()
_tls = threading.local()
_local: dict = {}       # seq -> coordinator summary


def env_mode() -> str:
    raw = env_str("H2O3_DIVERGENCE", "").strip().lower()
    if raw in ("", "0", "off", "false"):
        return ""
    return "log" if raw == "log" else "raise"


def enable(mode: str = "raise"):
    global _mode
    from h2o3_tpu_torch.core import kvstore
    _mode = mode
    kvstore._div_hook = _record


def disable():
    global _mode
    from h2o3_tpu_torch.core import kvstore
    kvstore._div_hook = None
    _mode = ""
    _tls.scope = None
    with _lock:
        _local.clear()


def active() -> bool:
    return bool(_mode)


# ---------------------------------------------------------------------------
# digests
def _value_digest(v, depth: int = 0) -> str:
    try:
        if v is None or isinstance(v, (bool, int, float, str, bytes)):
            r = repr(v) if not isinstance(v, bytes) else v
            if isinstance(r, str):
                r = r.encode("utf-8", "replace")
            return hashlib.sha1(r).hexdigest()[:8]
        import numpy as np
        if isinstance(v, np.ndarray):
            h = hashlib.sha1(f"{v.shape}{v.dtype}".encode())
            h.update(np.ascontiguousarray(v).tobytes())
            return h.hexdigest()[:8]
        if depth < 2 and isinstance(v, dict):
            parts = [f"{k!r}:{_value_digest(v[k], depth + 1)}"
                     for k in sorted(v, key=repr)[:32]]
            return hashlib.sha1(
                f"dict{len(v)}|{'|'.join(parts)}".encode()).hexdigest()[:8]
        if depth < 2 and isinstance(v, (list, tuple)):
            parts = [_value_digest(x, depth + 1) for x in v[:32]]
            return hashlib.sha1(
                f"seq{len(v)}|{'|'.join(parts)}".encode()).hexdigest()[:8]
        # tensors, frames, models: digest by TYPE — hashing device
        # payloads would force a host sync on the mutation path
        return f"t:{type(v).__name__}"
    except Exception:   # noqa: BLE001 — a digest must never break a put
        return "t:?"


def _record(op: str, key, value):
    """kvstore._div_hook: fold one replicated-state mutation into the
    thread's active request scope (no-op between requests)."""
    scope = getattr(_tls, "scope", None)
    if scope is None:
        return
    entry = f"{op}|{key}|{_value_digest(value)}"
    scope["n"] += 1
    scope["h"] = hashlib.sha1(
        (scope["h"] + "\n" + entry).encode()).hexdigest()[:16]
    if len(scope["e"]) < _MAX_ENTRIES:
        scope["e"].append(entry)


def _new_scope(seq: int, path: str) -> dict:
    return {"seq": int(seq), "path": path, "n": 0, "h": "", "e": []}


# ---------------------------------------------------------------------------
# coordinator side
def local_begin(seq: int, path: str):
    _tls.scope = _new_scope(seq, path)


def local_end():
    scope = getattr(_tls, "scope", None)
    _tls.scope = None
    if scope is None or not _mode:
        return
    with _lock:
        _local[scope["seq"]] = scope
        while len(_local) > _MAX_TRACK:
            _local.pop(next(iter(_local)))


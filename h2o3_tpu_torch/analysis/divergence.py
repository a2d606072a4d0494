"""Runtime replay-divergence sanitizer of the port (H2O3_DIVERGENCE=1|log;
h2o3_tpu/analysis/divergence.py).

While a broadcast request executes, every replicated-state mutation (DKV
put/remove — hooked via `kvstore._div_hook`, installed only when enabled;
the port's store has no `atomic` until a caller needs one) folds `(op,
key, value-digest)` into a per-request digest. The worker's digest rides
the ack frames it already sends (`_replay_session` attaches pending
riders to the next ack, the coordinator's `_recv_frame_at` peels them
off), and the coordinator compares each worker's digest against its own
for the same seq. First mismatch names the request path, seq, the first
differing (key, op) entry and the worker — `raise` mode turns the NEXT
dispatched request into a DivergenceError (raising inside the
broadcaster's ack loop would be swallowed as a worker excision, so the
error is deferred to `raise_if_pending()` in server dispatch); `log`
mode only counts.

Beyond the JAX package: a scoring route's ANSWER is digested too
(`note_answer`: the full JSON of the predictions, so a worker that
scores a replayed request differently, bit for bit, is a mismatch).

Metrics: h2o3_divergence_checks_total / h2o3_divergence_mismatches_total.

Digest caveat: tensors, frames and models are digested by type only (no
device sync on the mutation path — a sanitizer must not perturb what it
observes); the (key, op) sequence plus host-side payload bytes is the
divergence signal.
"""

from __future__ import annotations

import hashlib
import threading

from h2o3_tpu_torch.utils.env import env_str

_MAX_TRACK = 512        # per-seq summaries kept before dropping oldest
_MAX_ENTRIES = 128      # per-request mutation entries kept verbatim
_MAX_RIDERS = 64        # worker-side digests queued for the next ack

_mode = ""              # "" (off) | "log" | "raise"
_lock = threading.Lock()
_tls = threading.local()
_local: dict = {}       # seq -> coordinator summary
_remote: dict = {}      # seq -> {pid: worker summary} (rider beat local)
_rider_q: list = []     # worker side: summaries awaiting an ack frame
_pending = None         # first mismatch message awaiting raise_if_pending


class DivergenceError(RuntimeError):
    """Coordinator and a worker disagreed on the replicated-state
    mutations of one replayed request."""


def _counters():
    from h2o3_tpu_torch.obs import metrics as _om
    return (_om.counter("h2o3_divergence_checks_total",
                        "replay divergence digest comparisons"),
            _om.counter("h2o3_divergence_mismatches_total",
                        "replay divergence digest mismatches"))


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
    global _mode, _pending
    from h2o3_tpu_torch.core import kvstore
    kvstore._div_hook = None
    _mode = ""
    _pending = None
    _tls.scope = None
    with _lock:
        _local.clear()
        _remote.clear()
        del _rider_q[:]


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


def note_answer(obj):
    """Fold a scoring route's answer into the thread's active request
    scope: its full JSON (every prediction's repr), not a truncated
    digest."""
    scope = getattr(_tls, "scope", None)
    if scope is None or not _mode:
        return
    import json
    try:
        blob = json.dumps(obj, sort_keys=True, default=str).encode()
    except (TypeError, ValueError):
        blob = repr(obj).encode()
    _record("answer", scope["path"], hashlib.sha1(blob).hexdigest())


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
        stashed = _remote.pop(scope["seq"], None)
    if stashed:
        for pid, summary in sorted(stashed.items(), key=lambda kv: repr(kv)):
            _compare(scope, pid, summary)


# ---------------------------------------------------------------------------
# worker side
def replay_begin(seq: int, path: str):
    _tls.scope = _new_scope(seq, path)


def replay_end():
    scope = getattr(_tls, "scope", None)
    _tls.scope = None
    if scope is None or not _mode:
        return
    with _lock:
        _rider_q.append({"seq": scope["seq"], "path": scope["path"],
                         "n": scope["n"], "h": scope["h"],
                         "e": scope["e"]})
        while len(_rider_q) > _MAX_RIDERS:
            _rider_q.pop(0)


def take_riders() -> list:
    with _lock:
        out, _rider_q[:] = _rider_q[:], []
    return out


def attach_riders(frame: dict) -> dict:
    """Piggyback pending replay digests on an outgoing ack frame —
    called by the worker's frame sends; a no-op when off or drained."""
    if _mode:
        riders = take_riders()
        if riders:
            frame["div"] = riders
    return frame


# ---------------------------------------------------------------------------
# comparison (coordinator, on ack receipt)
def note_remote(pid, riders):
    """Compare each rider against the coordinator's summary for that
    seq, or stash it if the local handler hasn't finished yet (the
    worker acks request N while the coordinator may still be executing
    it — both arrival orders are normal)."""
    if not _mode or not riders:
        return
    for summary in riders:
        try:
            seq = int(summary.get("seq"))
        except (TypeError, ValueError):
            continue
        with _lock:
            local = _local.get(seq)
            if local is None:
                _remote.setdefault(seq, {})[pid] = summary
                while len(_remote) > _MAX_TRACK:
                    _remote.pop(next(iter(_remote)))
        if local is not None:
            _compare(local, pid, summary)


def _compare(local: dict, pid, remote: dict):
    global _pending
    checks, mismatches = _counters()
    checks.inc()
    if local["h"] == remote.get("h", "") and \
            local["n"] == remote.get("n", -1):
        return
    mismatches.inc()
    le, re_ = local["e"], list(remote.get("e", ()))
    detail = "mutation counts differ"
    for i in range(max(len(le), len(re_))):
        a = le[i] if i < len(le) else "<none>"
        b = re_[i] if i < len(re_) else "<none>"
        if a != b:
            ao, ak = (a.split("|") + ["", ""])[:2]
            bo, bk = (b.split("|") + ["", ""])[:2]
            detail = (f"first differing mutation #{i}: coordinator "
                      f"{ao} key={ak!r} vs worker {bo} key={bk!r}")
            break
    msg = (f"replicated-state divergence on {local['path']!r} "
           f"(seq {local['seq']}) between coordinator and worker "
           f"pid={pid}: {detail} — coordinator ran "
           f"{local['n']} mutation(s) [digest {local['h'] or '-'}], "
           f"worker {remote.get('n', '?')} "
           f"[digest {remote.get('h', '') or '-'}]")
    from h2o3_tpu_torch.utils import log as _ulog
    _ulog.err("%s", msg)
    if _mode == "raise" and _pending is None:
        _pending = msg


def raise_if_pending():
    """Surface the first recorded mismatch as DivergenceError — called
    from server dispatch BEFORE starting the next request, never from
    inside the broadcaster's send/ack loops (a raise there reads as a
    dead worker and excises it)."""
    global _pending
    if _pending is not None:
        msg, _pending = _pending, None
        raise DivergenceError(msg)

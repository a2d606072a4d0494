"""The collective guard of the port (h2o3_tpu/parallel/compat.py).

The JAX package serializes multi-replica programs on host meshes, where
XLA's CPU client shares one collective thread pool and two in-flight
programs starve each other. The port's cloud is a world of processes
joined by a `torch.distributed` process group (gloo), and gloo has a
stricter rule: it pairs the collectives of the ranks by their order. Two
request threads of one rank that interleave their collectives pair them
with the wrong calls of the other rank, which hangs or returns another
call's data. So every program that issues a collective runs here:

  * under ONE process-wide lock, and
  * in the order of its ticket. A ticket is taken while the request that
    starts the program is dispatched (`reserve`), and requests are
    dispatched in the replay channel's sequence order on every rank (the
    coordinator holds `dispatch_order()` across the broadcast and the
    handler; a worker replays one request at a time). Tickets are
    therefore handed out in the same order everywhere, and the lock
    admits them in that order, so every rank issues the same collectives
    in the same order.

A handler that changes no replicated state and issues no collective
(payload scoring, marked `stateless` in api/server.py) runs outside the
dispatch order, so that concurrent scoring requests run, and batch,
together; it runs in `collective_free()`, where taking a ticket raises
rather than pairing a collective out of order.

A job started by a request (a model build) takes its ticket when it
starts, on the request's thread, and runs its whole body as one guarded
region on the job's thread (`train_guard`); a collective issued inside a
guarded region by the thread that holds it passes straight through. In a
world of one rank nothing is guarded: `needs_host_serialization()` is
False and every entry here is a no-op. H2O3_HOST_SERIALIZE=0|1
overrides.

Differences from the JAX package: there is no `shard_map` shim and no
`guarded_jit` (no jit); `run_host_serialized` does not block on device
results (a gloo collective returns when its data has arrived).
"""

from __future__ import annotations

import contextlib
import functools
import threading

from h2o3_tpu_torch.utils import env as _uenv

# the region lock and its ticket queue; RLock semantics are given by the
# per-thread depth below (a guarded region may call guarded code)
_COND = threading.Condition()
_queue: list = []            # tickets reserved and not yet finished
_next_ticket = [0]
_holder = [None]             # thread ident inside a region, or None
_tls = threading.local()
# the coordinator's dispatch order: broadcast + handler of one request at
# a time (the worker's replay loop is serial by construction)
_DISPATCH = threading.RLock()


def needs_host_serialization() -> bool:
    """True when this process is one rank of a world of more than one
    (its collectives must pair with the other ranks' in order)."""
    env = _uenv.env_str("H2O3_HOST_SERIALIZE", "")
    if env in ("0", "1"):
        return env == "1"
    from h2o3_tpu_torch.parallel import mesh as _mesh
    c = _mesh._CLOUD
    return c is not None and c.world > 1


def dispatch_order():
    """Context manager for the coordinator's routed dispatch: the replay
    broadcast and the local handler of one request run before the next
    request's, so the handlers take their tickets in sequence order."""
    if needs_host_serialization():
        return _DISPATCH
    return contextlib.nullcontext()


@contextlib.contextmanager
def collective_free():
    """Run the block as code that issues no collective (a handler outside
    the dispatch order): a ticket taken in it raises RuntimeError."""
    prev = getattr(_tls, "free", False)
    _tls.free = True
    try:
        yield
    finally:
        _tls.free = prev


def reserve():
    """Take the next ticket (on the dispatching thread). Returns the
    ticket, or None when nothing needs guarding."""
    if not needs_host_serialization():
        return None
    if getattr(_tls, "free", False):
        raise RuntimeError(
            "a collective from a handler that runs outside the dispatch "
            "order (api/server.py `stateless`): its ticket would pair "
            "with the other ranks' collectives out of order")
    with _COND:
        t = _next_ticket[0]
        _next_ticket[0] += 1
        _queue.append(t)
        return t


def release(ticket):
    """Give back a ticket that will never run (its job failed to start)."""
    if ticket is None:
        return
    with _COND:
        if ticket in _queue:
            _queue.remove(ticket)
        _COND.notify_all()


@contextlib.contextmanager
def region(ticket=None):
    """Run the block as one guarded region: wait until `ticket` (reserved
    now when None) is the oldest outstanding ticket and no other thread
    holds the region, then hold it. Re-entrant on the holding thread."""
    depth = getattr(_tls, "depth", 0)
    if depth > 0 or (ticket is None and not needs_host_serialization()):
        _tls.depth = depth + 1
        try:
            yield
        finally:
            _tls.depth = depth
        return
    if ticket is None:
        ticket = reserve()
    me = threading.get_ident()
    with _COND:
        # h2o3-ok: R008 waiting for the turn IS the guard's contract: the collectives of the ranks pair by order, and the watchdog's device watch diagnoses a turn that never comes
        while not (_queue and _queue[0] == ticket and _holder[0] is None):
            _COND.wait(1.0)
        _holder[0] = me
    _tls.depth = 1
    try:
        yield
    finally:
        _tls.depth = 0
        with _COND:
            _holder[0] = None
            if ticket in _queue:
                _queue.remove(ticket)
            _COND.notify_all()


def in_region() -> bool:
    """True on a thread inside a guarded region."""
    return getattr(_tls, "depth", 0) > 0


def host_collective_guard():
    """Context manager around code that issues collectives: a guarded
    region in a world of more than one rank, a no-op otherwise."""
    if needs_host_serialization() or getattr(_tls, "depth", 0) > 0:
        return region()
    return contextlib.nullcontext()


def run_host_serialized(fn):
    """Run `fn()` (code that issues collectives) as one guarded region."""
    if not needs_host_serialization():
        return fn()
    with region():
        return fn()


_usage_mod = None


def _usage():
    """Lazy obs/usage handle (the metrics registry imports usage at its
    own import, so a module-level import here would cycle)."""
    global _usage_mod
    if _usage_mod is None:
        from h2o3_tpu_torch.obs import usage
        _usage_mod = usage
    return _usage_mod


def guard_collective(fn):
    """Wrap `fn` so every call runs as a guarded region, metered to the
    ambient principal under kind `jit` unless an outer meter owns it."""

    @functools.wraps(fn)
    def _guarded(*a, **k):
        with _usage().meter("jit"):
            return run_host_serialized(lambda: fn(*a, **k))

    _guarded.__wrapped__ = fn
    return _guarded


def train_guard(ticket=None):
    """Context manager for one whole model-train body: a guarded region
    (with the ticket its starting request reserved) in a world of more
    than one rank; a no-op otherwise."""
    if ticket is None and not needs_host_serialization():
        return contextlib.nullcontext()
    return region(ticket)

"""Runtime paired-protocol leak sanitizer (H2O3_LEAKTRACK=1|log), the
port of h2o3_tpu/analysis/leaktrack.py.

When armed, the registered openers (FairGate.acquire,
qos.acquire_job_slot) hand out tracked _Token proxies that record their
acquisition site, and the matching closers unwrap them. A token that
DIES unreleased (its weakref finalizer fires with the release flag
still down) is a proven leak — reported with the file:line that opened
it (the site the JAX package's static lifecycle rules R022/R024
fingerprint). The request-scoped pairs (edge_admit/end_request, usage
begin/finish, watchdog watch entries) are swept count-wise at end of
request instead: `sweep_request()` in server dispatch asserts every
thread-local count returned to zero.

Modes mirror the other runtime sanitizers: `log` counts and logs;
`raise` (the default for `=1`) defers the failure to
`raise_if_pending()` in server dispatch — a finalizer runs on the GC's
schedule, often on an unrelated thread, so raising in place would be
swallowed; failing the NEXT request is loud and attributable.

Metrics: h2o3_leaktrack_open{pair} (live tracked tokens + swept
request-scope entries) / h2o3_leaktrack_leaks_total{pair}.

Overhead caveat: only registered openers are wrapped, each costing one
stack walk per acquisition — the pairs guard admission and placement,
not per-row work, so the tax is per-request, not per-element.
"""

from __future__ import annotations

import functools
import threading
import traceback
import weakref

from h2o3_tpu_torch.utils.env import env_str

_MAX_REPORTS = 64       # recent leak reports kept for tests / the log

_mode = ""              # "" (off) | "log" | "raise"
_lock = threading.Lock()
_tls = threading.local()
_wrapped: list = []     # (owner, attr, orig) for disable()
_open: dict = {}        # pair -> live tracked-token count
_pending = None         # first leak message awaiting raise_if_pending
_reports: list = []     # [(pair, site)] recent leaks (bounded)

# request-scoped pairs swept count-wise (opener attr -> pair label)
_SCOPED_PAIRS = ("qos.edge_admit", "usage.request", "watchdog.watch")


class LeakError(RuntimeError):
    """A tracked paired-protocol token died unreleased (or a
    request-scoped pair survived its request)."""


def _counter():
    from h2o3_tpu_torch.obs import metrics as _om
    return _om.counter("h2o3_leaktrack_leaks_total",
                       "paired-protocol leaks proven at runtime")


def _open_series():
    with _lock:
        out = [({"pair": p}, float(n)) for p, n in sorted(_open.items())
               if n]
    return out


def env_mode() -> str:
    raw = env_str("H2O3_LEAKTRACK", "").strip().lower()
    if raw in ("", "0", "off", "false"):
        return ""
    return "log" if raw == "log" else "raise"


def active() -> bool:
    return bool(_mode)


# ---------------------------------------------------------------------------
# tracked tokens
class _Token:
    """Proxy for an opener's return value. Truthiness delegates (the
    `if not took:` guards keep working); the wrapped closer unwraps
    .value before calling the original. The mutable `state` cell (not
    the token) is shared with the finalizer: a finalize callback must
    not hold its own referent."""
    __slots__ = ("value", "pair", "site", "state", "__weakref__")

    def __init__(self, value, pair: str, site: str):
        self.value = value
        self.pair = pair
        self.site = site
        self.state = {"released": False}

    def __bool__(self):
        return bool(self.value)

    def __repr__(self):
        return f"<leaktrack token {self.pair} @ {self.site}>"


def _acq_site() -> str:
    """file:line of the frame that called the wrapped opener — the
    first frame below us that is not this module."""
    for fr in reversed(traceback.extract_stack()[:-1]):
        if "leaktrack" not in fr.filename.replace("\\", "/"):
            return f"{fr.filename}:{fr.lineno}"
    return "<unknown>"


def _report(pair: str, site: str, what: str):
    global _pending
    msg = (f"leaktrack: {what} for pair {pair!r} opened at {site} — "
           "the closer never ran (H2O3_LEAKTRACK)")
    try:
        _counter().inc(pair=pair)
    except Exception:   # noqa: BLE001 — a leak report must never crash GC
        pass
    with _lock:
        _reports.append((pair, site))
        del _reports[:-_MAX_REPORTS]
        if _mode == "raise" and _pending is None:
            _pending = msg
    from h2o3_tpu_torch.utils.log import get_logger
    get_logger("leaktrack").warning("%s", msg)


def _on_token_dead(pair: str, site: str, state: dict):
    if state.get("released"):
        return
    state["released"] = True       # a finalizer fires at most once, but
    #                                keep the flag honest for inspection
    with _lock:
        _open[pair] = max(0, _open.get(pair, 0) - 1)
    if _mode:
        _report(pair, site, "tracked token died unreleased")


def _release_token(tok: "_Token"):
    if not tok.state.get("released"):
        tok.state["released"] = True
        with _lock:
            _open[tok.pair] = max(0, _open.get(tok.pair, 0) - 1)


def _opener_factory(pair: str):
    def deco(orig):
        @functools.wraps(orig)
        def w(*a, **k):
            v = orig(*a, **k)
            if not _mode or not v:
                return v           # falsy return == nothing acquired
            site = _acq_site()
            tok = _Token(v, pair, site)
            with _lock:
                _open[pair] = _open.get(pair, 0) + 1
            weakref.finalize(tok, _on_token_dead, pair, site, tok.state)
            return tok
        return w
    return deco


def _closer_factory(pair: str):
    def deco(orig):
        @functools.wraps(orig)
        def w(*a, **k):
            a = tuple(_unwrap(x) for x in a)
            k = {key: _unwrap(x) for key, x in k.items()}
            return orig(*a, **k)
        return w
    return deco


def _unwrap(x):
    if isinstance(x, _Token):
        _release_token(x)
        return x.value
    return x


# ---------------------------------------------------------------------------
# request-scoped count pairs (swept at end of request)
def _counts() -> dict:
    c = getattr(_tls, "counts", None)
    if c is None:
        c = _tls.counts = {}
    return c


def _scoped_inc(pair: str):
    c = _counts()
    c[pair] = c.get(pair, 0) + 1
    with _lock:
        _open[pair] = _open.get(pair, 0) + 1


def _scoped_dec(pair: str, floor_zero: bool = True):
    c = _counts()
    n = c.get(pair, 0)
    if n <= 0 and floor_zero:
        return
    c[pair] = n - 1
    with _lock:
        _open[pair] = max(0, _open.get(pair, 0) - 1)


def _scoped_open_factory(pair: str):
    def deco(orig):
        @functools.wraps(orig)
        def w(*a, **k):
            out = orig(*a, **k)
            if _mode:
                _scoped_inc(pair)
            return out
        return w
    return deco


def _scoped_close_factory(pair: str, clears: bool = False):
    def deco(orig):
        @functools.wraps(orig)
        def w(*a, **k):
            out = orig(*a, **k)
            if _mode:
                if clears:      # idempotent clearer: zero the count
                    c = _counts()
                    n = c.pop(pair, 0)
                    if n:
                        with _lock:
                            _open[pair] = max(0, _open.get(pair, 0) - n)
                else:
                    _scoped_dec(pair)
            return out
        return w
    return deco


def sweep_request():
    """End-of-request assertion: every request-scoped pair this thread
    opened is closed. Wired into server dispatch right after
    qos.end_request() — the one instant the counts MUST be zero."""
    if not _mode:
        return
    c = getattr(_tls, "counts", None)
    if not c:
        return
    for pair, n in list(c.items()):
        if n > 0:
            _report(pair, "<request scope>",
                    f"request finished with {n} open entr"
                    f"{'y' if n == 1 else 'ies'}")
        if n:
            with _lock:
                _open[pair] = max(0, _open.get(pair, 0) - n)
        c.pop(pair, None)


def raise_if_pending():
    """Surface a deferred leak (raise mode): called from server
    dispatch, failing the NEXT request — a finalizer on a GC thread
    cannot fail the request that leaked."""
    global _pending
    if _pending is None:
        return
    with _lock:
        msg, _pending = _pending, None
    raise LeakError(msg)


def reports() -> list:
    with _lock:
        return list(_reports)


def open_counts() -> dict:
    with _lock:
        return {p: n for p, n in _open.items() if n}


# ---------------------------------------------------------------------------
def _wrap(owner, attr: str, factory):
    orig = getattr(owner, attr)
    if getattr(orig, "_leaktrack_wrapped", False):
        return
    new = factory(orig)
    new._leaktrack_wrapped = True
    setattr(owner, attr, new)
    _wrapped.append((owner, attr, orig))


def enable(mode: str = "raise"):
    """Arm the sanitizer: wrap the registered openers/closers in place
    (the runtime half of the static rules' pair registry). Idempotent."""
    global _mode
    _mode = mode
    from h2o3_tpu_torch.obs import metrics as _om
    from h2o3_tpu_torch.obs import usage as _usage
    from h2o3_tpu_torch.obs import watchdog as _wd
    from h2o3_tpu_torch.serving import qos as _qos
    _om.gauge("h2o3_leaktrack_open",
              "live tracked paired-protocol tokens", fn=_open_series)
    # token pairs: opener returns proxy, closer unwraps
    _wrap(_qos.FairGate, "acquire", _opener_factory("qos.gate"))
    _wrap(_qos.FairGate, "release", _closer_factory("qos.gate"))
    _wrap(_qos, "acquire_job_slot", _opener_factory("qos.job_slot"))
    _wrap(_qos, "release_job_slot", _closer_factory("qos.job_slot"))
    # request-scoped count pairs: swept by sweep_request()
    _wrap(_qos, "edge_admit", _scoped_open_factory("qos.edge_admit"))
    _wrap(_qos, "end_request",
          _scoped_close_factory("qos.edge_admit", clears=True))
    _wrap(_usage, "begin_request", _scoped_open_factory("usage.request"))
    _wrap(_usage, "finish_request",
          _scoped_close_factory("usage.request", clears=True))
    _wrap(_usage, "clear_request",
          _scoped_close_factory("usage.request", clears=True))
    _wrap(_wd._Watch, "__enter__",
          _scoped_open_factory("watchdog.watch"))
    _wrap(_wd._Watch, "__exit__",
          _scoped_close_factory("watchdog.watch"))


def disable():
    global _mode, _pending
    _mode = ""
    _pending = None
    for owner, attr, orig in reversed(_wrapped):
        setattr(owner, attr, orig)
    del _wrapped[:]
    with _lock:
        _open.clear()
        del _reports[:]
    _tls.counts = {}

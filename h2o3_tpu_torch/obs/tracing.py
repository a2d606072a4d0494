"""Request tracing of the port (h2o3_tpu/obs/tracing.py) — Dapper-style
trace ids for the cloud.

A trace id is minted at the REST boundary (`X-H2O3-Trace-Id` request
header, auto-generated when absent) and carried in a per-thread context:
every `timeline.span` opened while a trace is current tags itself with
the id, jobs inherit the trace of the thread that started them, and the
deploy/multihost replay channel forwards the id so remote hosts tag their
replayed spans with the ORIGINATING request's trace. `GET /3/Trace/{id}`
stitches the fragments back together cloud-wide.

This module is intentionally dependency-free (stdlib only): it is
imported by the span timeline, the REST layer, the micro-batcher, mrtask
and the jobs, and must never pull torch or the metrics registry in.

Env surface:
  H2O3_TRACING  "0" disables trace-id minting at the REST layer (spans
                still record, untagged). Default on.
"""

from __future__ import annotations

import contextlib
import re
import secrets
import threading

from h2o3_tpu_torch.utils.env import env_bool

_TLS = threading.local()

# ids cross the REST boundary and the replay channel as free text: bound
# the charset + length so a hostile header can't smuggle exposition-format
# or JSON structure into merged outputs
_SAFE_ID = re.compile(r"[0-9a-zA-Z_.\-]{1,64}")


def enabled() -> bool:
    """Trace-id minting at the REST layer (H2O3_TRACING, default on)."""
    return env_bool("H2O3_TRACING", True)


def new_trace_id() -> str:
    return secrets.token_hex(8)


def current():
    """The calling thread's current trace id, or None."""
    return getattr(_TLS, "trace_id", None)


def set_current(trace_id):
    """Set the thread's trace id; returns the previous value so callers
    can restore it (prefer the `trace()` context manager)."""
    prev = getattr(_TLS, "trace_id", None)
    _TLS.trace_id = trace_id
    return prev


@contextlib.contextmanager
def trace(trace_id):
    """Run a block under `trace_id` (None = explicitly untraced)."""
    prev = set_current(trace_id)
    try:
        yield trace_id
    finally:
        set_current(prev)


def sanitize(trace_id):
    """A caller-supplied id, validated — or None when unusable."""
    if not trace_id:
        return None
    tid = str(trace_id).strip()
    return tid if _SAFE_ID.fullmatch(tid) else None


# ---------------------------------------------------------------------------
# Request context beyond the trace id (multi-tenant QoS, serving/qos.py):
# the REST layer resolves every request to a PRINCIPAL (authenticated
# user, else the stable "anonymous" bucket) and an optional DEADLINE
# (X-H2O3-Deadline-Ms, stored as an absolute time.monotonic() instant),
# and stamps both here alongside the trace id — the micro-batcher, the
# job system and the QoS admission layer all read them from the same TLS
# the spans already use. Kept in this module so the context stays
# dependency-free (core/jobs and parallel/mrtask must not import the
# serving package just to read who is asking).

def principal():
    """The calling thread's resolved principal, or None (no request
    context — internal work, tests, library use)."""
    return getattr(_TLS, "principal", None)


def set_principal(name):
    """Set the thread's principal; returns the previous value."""
    prev = getattr(_TLS, "principal", None)
    _TLS.principal = name
    return prev


def deadline():
    """The request's absolute deadline (time.monotonic() seconds), or
    None when the caller sent no X-H2O3-Deadline-Ms."""
    return getattr(_TLS, "deadline", None)


def set_deadline(when):
    """Set the thread's deadline instant; returns the previous value."""
    prev = getattr(_TLS, "deadline", None)
    _TLS.deadline = when
    return prev


@contextlib.contextmanager
def request_context(principal_name, deadline_at=None):
    """Run a block as `principal_name` with an optional absolute
    deadline — the REST dispatch wraps every handler in this; Job.start
    re-enters it on the worker thread (principal only: a build outlives
    its launching request's deadline)."""
    prev_p = set_principal(principal_name)
    prev_d = set_deadline(deadline_at)
    try:
        yield
    finally:
        set_principal(prev_p)
        set_deadline(prev_d)

"""Typed environment accessors of the port (h2o3_tpu/utils/env.py).

A copy of the JAX package's `env_str`, `env_int`, `env_float` and
`env_bool`, so that the port reads the same `H2O3_*` variables (the
pager's budgets, the ice root, the parse's chunk size and workers) with
the same semantics and a deployment's settings carry over: unset and
empty both give the default, and an unparseable value warns
once per (name, value) and gives the default instead of raising.
"""

from __future__ import annotations

import os
import warnings

_TRUE = {"1", "true", "yes", "on"}
_FALSE = {"0", "false", "no", "off"}
_warned: set = set()


def _raw(name: str):
    return os.environ.get(name)


def _bad(name: str, raw: str, kind: str, default):
    key = (name, raw)
    if key in _warned:
        return
    _warned.add(key)
    warnings.warn(
        f"{name}={raw!r} is not a valid {kind}; using default {default!r}",
        RuntimeWarning, stacklevel=3)


def env_str(name: str, default: str = "") -> str:
    """String variable; unset or empty gives the default."""
    v = _raw(name)
    if v is None or v == "":
        return default
    return v


def env_int(name: str, default: int) -> int:
    v = _raw(name)
    if v is None or v.strip() == "":
        return default
    try:
        return int(v.strip())
    except ValueError:
        _bad(name, v, "int", default)
        return default


def env_float(name: str, default: float) -> float:
    v = _raw(name)
    if v is None or v.strip() == "":
        return default
    try:
        return float(v.strip())
    except ValueError:
        _bad(name, v, "float", default)
        return default


def env_bool(name: str, default: bool = False) -> bool:
    """1/true/yes/on and 0/false/no/off, in any case; anything else warns
    and gives the default."""
    v = _raw(name)
    if v is None or v.strip() == "":
        return default
    s = v.strip().lower()
    if s in _TRUE:
        return True
    if s in _FALSE:
        return False
    _bad(name, v, "bool", default)
    return default


def is_set(name: str) -> bool:
    """Presence check (set to a non-blank value) — for call sites whose
    failure mode must stay LOUD when a variable is missing (the explicit
    multi-host bootstrap). Value reads still go through the typed
    accessors and their one declaration site; this never parses."""
    return bool((_raw(name) or "").strip())


def process_id() -> int:
    """This process' rank in the cloud (H2O3_PROCESS_ID, 0 on one card):
    the timeline's span host and the structured logger's record host."""
    return env_int("H2O3_PROCESS_ID", 0)

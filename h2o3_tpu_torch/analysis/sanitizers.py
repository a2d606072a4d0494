"""Runtime sanitizers of the port (h2o3_tpu/analysis/sanitizers.py).

The transfer guard proves the runtime does no stray host<->device copy:
under `transfer_guard("disallow")` a synchronising copy or `.item()` on a
card tensor raises. The warm scoring path is held to it: the scorer
cache stages rows through a pinned buffer and waits on one event, so a
warm request runs under "disallow".

Env gates (read by install_from_env, called at server start):
  H2O3_DEBUG_NANS=1          debug_nans for every request and job thread
                             of the process: an op whose floating output
                             holds a NaN raises FloatingPointError naming
                             the op
  H2O3_TRANSFER_GUARD=LEVEL  the transfer guard for the whole process
                             (disallow | log | allow)
  H2O3_LOCKDEP=1|raise|log   runtime lock-order checking (lockdep.py)
  H2O3_DIVERGENCE=1|log      replicated-state mutation digests a request
                             (divergence.py)
  H2O3_LEAKTRACK=1|log       paired-protocol leak tracking
                             (leaktrack.py)

Two differences from the JAX package's, both of torch:
  * `jax.transfer_guard` as a context is per thread; torch's sync debug
    mode (`torch.cuda.set_sync_debug_mode`) is process-wide, so the
    scoped guard below holds every thread while it is open.
  * A NaN check reads the output back, which synchronises: under
    debug_nans a scorer's CUDA graph capture fails and the scorer cache
    scores eagerly (a fallback counted with its reason).
"""

from __future__ import annotations

import contextlib
import threading

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from h2o3_tpu_torch.utils.env import env_bool, env_str

# jax transfer-guard level -> torch sync debug mode
_SYNC_MODES = {"disallow": "error", "log": "warn", "allow": "default"}

_guard_lock = threading.Lock()
# debug_nans for the whole process (install_from_env): torch keeps its
# dispatch modes per thread, so request and job threads enter
# `thread_scope()` to take part
_process_nans = False


def _sync_mode(level: str) -> str:
    mode = _SYNC_MODES.get(str(level).strip().lower())
    if mode is None:
        raise ValueError(f"unknown transfer guard level {level!r} "
                         f"(want {'|'.join(_SYNC_MODES)})")
    return mode


def _swap_sync_mode(mode: str) -> str:
    """Set the sync debug mode; the previous one back. A process without
    a card has no device to copy from, so nothing to guard."""
    if not torch.cuda.is_available():
        return mode
    with _guard_lock:
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(mode)
    return {0: "default", 1: "warn", 2: "error"}.get(prev, prev)


@contextlib.contextmanager
def transfer_guard(level: str = "disallow"):
    """Inside the block a synchronising device copy raises ("disallow")
    or warns ("log"). Explicit non-blocking copies through pinned memory
    stay allowed, which is the point: intended transfers are spelled out,
    stray ones fail. Process-wide while open (see the module's notes)."""
    prev = _swap_sync_mode(_sync_mode(level))
    try:
        yield
    finally:
        _swap_sync_mode(prev)


class _NaNMode(TorchDispatchMode):
    """Raise FloatingPointError at the first op whose floating output
    holds a NaN, naming the op."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor) and t.is_floating_point() \
                    and t.numel() and bool(torch.isnan(t).any()):
                raise FloatingPointError(
                    f"invalid value (nan) encountered in {func}")
        return out


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Scoped NaN checking on this thread: every op's floating output is
    checked (a read back each op), so scoped rather than global by
    default."""
    if not enable:
        yield
        return
    with _NaNMode():
        yield


@contextlib.contextmanager
def thread_scope():
    """Enter the process-wide per-thread sanitizers on this thread (the
    REST server's request threads and jobs' threads): debug_nans when
    install_from_env armed it, else nothing."""
    if not _process_nans:
        yield
        return
    with _NaNMode():
        yield


def install_from_env() -> dict:
    """Apply env-gated sanitizers process-wide; returns what was enabled.
    Called by H2OServer.start() so a deployment can flip them without a
    code change; a no-op when the env vars are unset."""
    global _process_nans
    enabled = {}
    from h2o3_tpu_torch.analysis import lockdep
    lockdep_mode = lockdep.env_mode()
    if lockdep_mode:
        lockdep.enable(lockdep_mode)
        enabled["lockdep"] = lockdep_mode
    from h2o3_tpu_torch.analysis import divergence
    divergence_mode = divergence.env_mode()
    if divergence_mode:
        divergence.enable(divergence_mode)
        enabled["divergence"] = divergence_mode
    from h2o3_tpu_torch.analysis import leaktrack
    leaktrack_mode = leaktrack.env_mode()
    if leaktrack_mode:
        leaktrack.enable(leaktrack_mode)
        enabled["leaktrack"] = leaktrack_mode
    if env_bool("H2O3_DEBUG_NANS", False):
        _process_nans = True
        enabled["debug_nans"] = True
    guard = env_str("H2O3_TRANSFER_GUARD", "").strip()
    if guard:
        _swap_sync_mode(_sync_mode(guard))
        enabled["transfer_guard"] = guard
    return enabled


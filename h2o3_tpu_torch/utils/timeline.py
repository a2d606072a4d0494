"""Dispatch recorder of the port (h2o3_tpu/utils/timeline.py) —
water/TimeLine + MRTask.profile for a single-controller device runtime.

A ring buffer of device-work launches (name, argument bytes, enqueue
time, completion time when measured). Where the JAX package blocks on the
result to learn the completion time, the port records a CUDA event
before and after the work and reads the completion from the events: the
snapshot resolves an event once it has completed (`query()`, which never
waits), and `profile(fn, sync=True)` waits on its end event only — never
on the stream or the device. On the CPU the work is synchronous and the
host clock is the completion time. `profiler_trace(logdir)` is the deep
trace, through `torch.profiler` (a Chrome trace in `logdir`).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import deque
from dataclasses import dataclass


@dataclass
class DispatchEvent:
    name: str
    t_enqueue: float
    t_done: float | None = None
    arg_bytes: int = 0
    note: str = ""
    # CUDA events (start, end) whose elapsed time gives t_done
    _events: tuple | None = None

    def resolve(self):
        """Fill t_done from the CUDA events once the end event has
        completed; never waits."""
        if self.t_done is None and self._events is not None:
            ev0, ev1 = self._events
            if ev1.query():
                self.t_done = self.t_enqueue + ev0.elapsed_time(ev1) / 1e3
                self._events = None
        return self.t_done


def _cuda_events():
    """A (start, end) pair of timing events on the current stream when a
    card is in use, else None."""
    import torch
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return None
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    ev0.record()
    return ev0, ev1


class Timeline:
    """Ring buffer of device dispatches (TimeLine's 2048-event ring)."""

    CAPACITY = 2048

    def __init__(self):
        self._ring: deque = deque(maxlen=self.CAPACITY)
        self._lock = threading.Lock()

    def record(self, name: str, arg_bytes: int = 0,
               note: str = "") -> DispatchEvent:
        ev = DispatchEvent(name=name, t_enqueue=time.time(),
                           arg_bytes=arg_bytes, note=note)
        with self._lock:
            self._ring.append(ev)
        return ev

    def snapshot(self) -> list:
        """Most-recent dispatches, oldest first."""
        with self._lock:
            evs = list(self._ring)
        out = []
        for e in evs:
            done = e.resolve()
            out.append({"name": e.name, "enqueue": e.t_enqueue,
                        "done": done,
                        "duration_ms": None if done is None
                        else 1000 * (done - e.t_enqueue),
                        "arg_bytes": e.arg_bytes, "note": e.note})
        return out

    def clear(self):
        with self._lock:
            self._ring.clear()


TIMELINE = Timeline()


def _finish(ev: DispatchEvent, events):
    if events is None:
        ev.t_done = time.time()
    else:
        events[1].record()
        ev._events = events


@contextlib.contextmanager
def span(name: str, note: str = ""):
    """Record one controller-side span into the timeline; on the card its
    completion comes from the CUDA events around the block."""
    ev = TIMELINE.record(name, note=note)
    events = _cuda_events()
    try:
        yield ev
    finally:
        _finish(ev, events)


def profile(fn, *args, sync=True, name=None, **kwargs):
    """MRTask.profile analog: run a step, return (result, timing).

    Timing splits enqueue (the host's launch of the work) from completion
    (the device's execution). With `sync` the call waits on the step's end
    event — the stream runs on — and reports `total_ms`; without it
    `total_ms` is None and the timeline resolves it later."""
    nm = name or getattr(fn, "__name__", "step")
    ev = TIMELINE.record(nm)
    events = _cuda_events()
    t0 = time.time()
    out = fn(*args, **kwargs)
    t_enq = time.time()
    _finish(ev, events)
    if sync and events is not None:
        events[1].synchronize()
        ev.resolve()
    total = None if ev.t_done is None else 1000 * (ev.t_done - t0)
    return out, {"name": nm, "enqueue_ms": 1000 * (t_enq - t0),
                 "total_ms": total}


@contextlib.contextmanager
def profiler_trace(logdir: str):
    """Deep tracing through torch.profiler (CPU and CUDA activity),
    written as a Chrome trace into `logdir`."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace-p{os.getpid()}-{int(time.time())}.json"))

"""On-demand profiling — POST /3/Profiler start/stop (port of
h2o3_tpu/obs/profiler.py).

The reference exposes /3/Profiler (water/api/ProfilerHandler.java): every
node stack-samples itself and ships the hot stacks back over REST. The
port drives `torch.profiler` with the CPU activity and, where the process
has a card, the CUDA activity (CUPTI: every kernel the process launches,
the hand-written ones included), and writes a Chrome trace
(`torch-trace.json`) into the artifact dir. Where the JAX package takes
`jax.profiler`, kind "torch" stands for its "jax". `kind="sampling"` is
the pure-Python stack sampler: a daemon thread samples every live
thread's stack via `sys._current_frames()` and writes a flamegraph-ready
collapsed-stack file — the ProfilerHandler behavior, minus the JVM.

"auto" takes torch.profiler and never falls back to sampling: a capture
that cannot start answers an error. Without a card it profiles the CPU
only, as the JAX one does without a device backend.

At most ONE session runs at a time (the profiler is process-global and
two overlapping captures corrupt both); a second start answers 409.

Env surface:
  H2O3_PROFILE_DIR  default artifact directory (else a fresh tempdir)
"""

from __future__ import annotations

import os
import sys
import threading
import time

from h2o3_tpu_torch.analysis.lockdep import make_lock
from h2o3_tpu_torch.obs import metrics as _om
from h2o3_tpu_torch.utils.env import env_str

SESSIONS = _om.counter(
    "h2o3_profiler_sessions_total",
    "profiler sessions started via /3/Profiler, labeled by kind "
    "(torch = torch.profiler device trace, sampling = pure-Python "
    "stack sampler)")


class ProfilerBusy(RuntimeError):
    """A session is already running — the profiler is process-global,
    so concurrent captures are refused (HTTP 409)."""


class ProfilerIdle(RuntimeError):
    """stop() without a running session (HTTP 400)."""


class _SamplingProfiler:
    """Stack sampler: every `interval_s`, collapse each live thread's
    frame stack to "file:func;file:func;..." and count it. stop() writes
    the counts in flamegraph collapsed-stack format."""

    def __init__(self, interval_s: float = 0.01, max_depth: int = 64):
        self.interval_s = interval_s
        self.max_depth = max_depth
        self.samples: dict = {}
        self.n_samples = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="h2o3-pyprof")

    def start(self):
        self._thread.start()

    def _run(self):
        me = threading.get_ident()
        while not self._stop.wait(self.interval_s):
            for tid, frame in list(sys._current_frames().items()):
                if tid == me:
                    continue
                stack = []
                f = frame
                while f is not None and len(stack) < self.max_depth:
                    code = f.f_code
                    fname = code.co_filename.rsplit("/", 1)[-1]
                    stack.append(f"{fname}:{code.co_name}")
                    f = f.f_back
                key = ";".join(reversed(stack))
                self.samples[key] = self.samples.get(key, 0) + 1
            self.n_samples += 1

    def stop(self, out_dir: str) -> str:
        self._stop.set()
        self._thread.join(timeout=2.0)
        # snapshot: if a huge sampling pass outlives the bounded join,
        # the thread may still be inserting — iterate a copy, never the
        # live dict
        samples = dict(self.samples)
        path = os.path.join(out_dir, "pyprof.collapsed")
        with open(path, "w") as fh:
            for stack, cnt in sorted(samples.items(),
                                     key=lambda kv: -kv[1]):
                fh.write(f"{stack} {cnt}\n")
        return path


class _TorchSession:
    """torch.profiler on a thread of its own. The profiler's state is
    per thread (a session stopped on another thread than the one that
    started it does not stop), and REST start and stop arrive on two
    request threads, so the session's thread enters and leaves it; the
    CPU ops of every thread are recorded where torch offers it
    (`profile_all_threads`), and the CUDA activity (CUPTI) holds every
    kernel of the process either way."""

    def __init__(self, path: str):
        self.path = path
        self.error: BaseException | None = None
        self._ready = threading.Event()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="h2o3-torchprof")

    def start(self):
        self._thread.start()
        self._ready.wait()
        if self.error is not None:
            raise self.error

    def _run(self):
        import torch
        try:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            kw = {}
            try:
                from torch._C._profiler import _ExperimentalConfig
                kw["experimental_config"] = _ExperimentalConfig(
                    profile_all_threads=True)
            except (ImportError, TypeError):
                pass        # an older torch: this thread's CPU ops only
            prof = torch.profiler.profile(activities=acts, **kw)
            prof.__enter__()
        except BaseException as ex:     # noqa: BLE001 — raised by start()
            self.error = ex
            self._ready.set()
            return
        self._ready.set()
        self._stop.wait()
        try:
            prof.__exit__(None, None, None)
            prof.export_chrome_trace(self.path)
        except BaseException as ex:     # noqa: BLE001 — reported by stop()
            self.error = ex

    def stop(self):
        """Leave the session and write its trace; the error, if any."""
        self._stop.set()
        self._thread.join()
        return self.error


class ProfilerManager:
    """One-session-at-a-time gate around the two capture backends."""

    def __init__(self):
        self._lock = make_lock("profiler")
        self._active: dict | None = None

    def _artifact_dir(self, trace_dir) -> str:
        d = trace_dir or env_str("H2O3_PROFILE_DIR", "")
        if not d:
            import tempfile
            d = tempfile.mkdtemp(prefix="h2o3-profile-")
        os.makedirs(d, exist_ok=True)
        return d

    def start(self, trace_dir=None, kind: str = "auto") -> dict:
        """Start a capture. kind: "auto" or "torch" (torch.profiler; an
        error when it cannot start), "sampling" (the stack sampler)."""
        if kind not in ("auto", "torch", "sampling"):
            raise ValueError(f"profiler kind {kind!r} "
                             "(want auto|torch|sampling)")
        with self._lock:
            if self._active is not None:
                raise ProfilerBusy(
                    f"a {self._active['kind']} profiler session is already "
                    f"running (dir {self._active['dir']}) — stop it first")
            d = self._artifact_dir(trace_dir)
            sampler = prof = None
            if kind in ("auto", "torch"):
                prof = _TorchSession(os.path.join(d, "torch-trace.json"))
                prof.start()
                used = "torch"
            else:
                sampler = _SamplingProfiler()
                sampler.start()
                used = "sampling"
            self._active = {"kind": used, "dir": d, "sampler": sampler,
                            "prof": prof, "t_start": time.time()}
            SESSIONS.inc(kind=used)
            return {"status": "started", "kind": used, "dir": d}

    def stop(self) -> dict:
        with self._lock:
            if self._active is None:
                raise ProfilerIdle("no profiler session is running")
            sess = self._active
            self._active = None
            out = {"status": "stopped", "kind": sess["kind"],
                   "dir": sess["dir"],
                   "seconds": round(time.time() - sess["t_start"], 3)}
            if sess["kind"] == "torch":
                err = sess["prof"].stop()
                if err is None:
                    out["trace"] = sess["prof"].path
                else:                     # report, don't 500
                    out["error"] = repr(err)
            else:
                out["artifact"] = sess["sampler"].stop(sess["dir"])
                out["samples"] = sess["sampler"].n_samples
            return out

    def status(self) -> dict:
        with self._lock:
            if self._active is None:
                return {"active": False}
            return {"active": True, "kind": self._active["kind"],
                    "dir": self._active["dir"],
                    "seconds": round(time.time()
                                     - self._active["t_start"], 3)}


PROFILER = ProfilerManager()


# ---------------------------------------------------------------------------
# Cluster-wide capture (ISSUE 7). POST /3/Profiler?cluster=1 fans
# start/stop over the replay channel's collect op; each worker runs its
# own PROFILER session and ships its sampling flamegraph back as text
# (bounded), and the coordinator merges every host's collapsed stacks —
# each line prefixed host<N>; — into ONE flamegraph-ready file.
_MAX_COLLAPSED_BYTES = 256 * 1024


def read_collapsed(path: str, max_bytes: int = _MAX_COLLAPSED_BYTES) -> str:
    """A pyprof.collapsed artifact as text, truncated at a line boundary
    so it can ride a JSON collect ack without blowing the frame bound."""
    try:
        with open(path, encoding="utf-8") as fh:
            text = fh.read(max_bytes + 1)
    except OSError:
        return ""
    if len(text) > max_bytes:
        text = text[:max_bytes]
        text = text[: text.rfind("\n") + 1]
    return text


def collect_op(op: str):
    """Worker-side handler for the profiler collect ops
    ("profiler:start:<kind>" / "profiler:stop") — runs inside
    _collect_local on the replay channel, so errors answer as data, never
    as a dead worker slot."""
    try:
        if op.startswith("profiler:start:"):
            kind = op[len("profiler:start:"):] or "auto"
            return PROFILER.start(kind=kind)
        if op == "profiler:stop":
            out = PROFILER.stop()
            if out.get("artifact"):
                out["collapsed"] = read_collapsed(out["artifact"])
            return out
    except (ProfilerBusy, ProfilerIdle, ValueError) as ex:
        return {"status": "error", "error": str(ex)}
    return {"status": "error", "error": f"unknown profiler op {op!r}"}


def merge_collapsed(parts, out_dir: str) -> str | None:
    """[(host, collapsed_text)] → one host-prefixed flamegraph file
    (`pyprof.merged.collapsed` under out_dir — a distinct name, so the
    coordinator's raw `pyprof.collapsed` capture survives): every stack
    line becomes
    `host<N>;<stack> <count>`, so one flamegraph shows where each host
    spent its samples side by side. Returns the path, or None when no
    host produced sampling output (torch captures have no collapsed
    text — their Chrome traces stay host-local)."""
    merged: dict = {}
    for host, text in parts:
        for line in (text or "").splitlines():
            stack, _, cnt = line.rpartition(" ")
            if not stack or not cnt.isdigit():
                continue
            key = f"host{host};{stack}"
            merged[key] = merged.get(key, 0) + int(cnt)
    if not merged:
        return None
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "pyprof.merged.collapsed")
    with open(path, "w", encoding="utf-8") as fh:
        for stack, cnt in sorted(merged.items(), key=lambda kv: -kv[1]):
            fh.write(f"{stack} {cnt}\n")
    return path

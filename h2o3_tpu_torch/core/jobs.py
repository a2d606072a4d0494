"""Jobs of the port (h2o3_tpu/core/jobs.py): a unit of work with progress,
cooperative cancellation, a deadline and its failure captured.

A job runs `work(job)` in the caller's thread or on a daemon thread; the
work calls `update()` between device steps, which marks the deadline
(`budget_exhausted`) and raises `JobCancelled` once `stop()` was asked.
`ModelBase.train` runs every model build through one.

A job inherits the trace id and the principal of the thread that
started it, and its work runs inside a `job.run` span (tagged `error` on
a failure, which the flight recorder keeps). Multi-tenant QoS: starting a
job charges the launching request's principal against its
concurrent-job quota (H2O3_QOS_MAX_JOBS → QuotaExceeded) before the job
is RUNNING; the worker runs in `qos.job_context` (so nested jobs are not
charged again and its dispatches ride the batch lane), and the slot is
released when the job ends — or when its thread cannot start.
"""

from __future__ import annotations

import contextlib
import threading
import time
import traceback
from typing import Callable, Optional

from h2o3_tpu_torch.core.kvstore import DKV

RUNNING = "RUNNING"
DONE = "DONE"
FAILED = "FAILED"
CANCELLED = "CANCELLED"
CREATED = "CREATED"


class JobCancelled(Exception):
    pass


class Job:
    """A job keyed in the DKV (water/Job.java)."""

    def __init__(self, description: str = "", dest: Optional[str] = None):
        self.key = DKV.make_key("job")
        self.description = description
        self.dest = dest              # key of the object being built
        self.status = CREATED
        self.progress = 0.0
        self.progress_msg = ""
        # max_runtime_secs: an absolute deadline; update() sets
        # budget_exhausted once it has passed, and the builders stop at
        # their next check, keeping the partial model
        self.deadline: Optional[float] = None
        self.budget_exhausted = False
        # wall time (ms) of each `with job.phase(name)` block
        self.phases: dict[str, float] = {}
        self.exception: Optional[BaseException] = None
        self.traceback: Optional[str] = None
        self.start_time = 0.0
        self.end_time = 0.0
        self._stop_requested = threading.Event()
        self._done = threading.Event()
        self._thread: Optional[threading.Thread] = None
        DKV.put(self.key, self)

    def __getstate__(self):
        """A finished job is pickled with its model (genmodel/mojo.py
        save_model): its events as flags, without its thread."""
        state = dict(self.__dict__)
        state["_stop_requested"] = self._stop_requested.is_set()
        state["_done"] = self._done.is_set()
        state["_thread"] = None
        return state

    def __setstate__(self, state):
        for name in ("_stop_requested", "_done"):
            ev = threading.Event()
            if state[name]:
                ev.set()
            state[name] = ev
        self.__dict__.update(state)

    # ---- lifecycle ------------------------------------------------------
    def start(self, work: Callable[["Job"], object],
              background: bool = True) -> "Job":
        """Run `work(job)`; its return value is put in the DKV under
        `dest`. A failure is kept on the job and raised again by join().
        Raises QuotaExceeded when the principal already runs
        H2O3_QOS_MAX_JOBS jobs."""
        from h2o3_tpu_torch.obs import tracing as _tracing
        from h2o3_tpu_torch.serving import qos as _qos
        # a REST job-route request may have pre-paid its quota charge
        # (qos.prepay_job_slot); adopt it — only job starts outside that
        # flow charge here
        qos_slot = _qos.adopt_prepaid_job_slot()
        if qos_slot is None:
            qos_slot = _qos.acquire_job_slot()
        parent_principal = _tracing.principal()
        self.status = RUNNING
        self.start_time = time.time()
        # jobs inherit the starting thread's trace, so job.run and its
        # nested spans stitch into that trace although the work may run
        # on its own thread
        parent_trace = _tracing.current()

        def _run():
            from h2o3_tpu_torch.analysis import sanitizers
            from h2o3_tpu_torch.obs.timeline import span
            try:
                # the process-wide sanitizers that torch keeps per thread
                # (debug_nans) hold on the job's thread too
                with sanitizers.thread_scope(), \
                        _tracing.trace(parent_trace), \
                        _qos.job_context(parent_principal), \
                        span("job.run", job=self.key,
                             description=self.description) as _sp:
                    try:
                        result = work(self)
                    except JobCancelled:
                        raise
                    except BaseException as e:
                        # the `error` attr is what the flight recorder's
                        # tail sampler keys on
                        _sp.attrs["error"] = repr(e)
                        raise
                if result is not None and self.dest:
                    DKV.put(self.dest, result)
                self.progress = 1.0
                self.status = DONE
            except JobCancelled:
                self.status = CANCELLED
            except BaseException as e:  # kept for join(), as MRThrow
                self.exception = e
                self.traceback = traceback.format_exc()
                self.status = FAILED
            finally:
                _qos.release_job_slot(qos_slot)
                self.end_time = time.time()
                self._done.set()

        if background:
            try:
                self._thread = threading.Thread(target=_run, daemon=True,
                                                name=f"job-{self.key}")
                self._thread.start()
            except BaseException as e:
                # the worker that would release the slot in its finally
                # never runs: release it here, or the charge leaks
                self.exception = e
                self.status = FAILED
                _qos.release_job_slot(qos_slot)
                self._done.set()
                raise
        else:
            _run()
        return self

    def join(self, timeout: Optional[float] = None):
        """Block until done; raise the job's failure (Job.get())."""
        self._done.wait(timeout)
        if self.exception is not None:
            raise self.exception
        if self.dest:
            return DKV.get(self.dest)
        return None

    @contextlib.contextmanager
    def phase(self, name: str):
        """Time one builder phase into to_dict()["phases"]."""
        t0 = time.time()
        try:
            yield
        finally:
            dt = 1000.0 * (time.time() - t0)
            self.phases[name] = self.phases.get(name, 0.0) + dt

    # ---- progress and cancellation --------------------------------------
    def update(self, progress: float, msg: str = ""):
        self.progress = float(progress)
        if msg:
            self.progress_msg = msg
        if self.deadline is not None and time.time() > self.deadline:
            self.budget_exhausted = True
        if self._stop_requested.is_set():
            raise JobCancelled()

    def stop(self):
        """Ask for cooperative cancellation (Job.stop())."""
        self._stop_requested.set()

    @property
    def stop_requested(self) -> bool:
        return self._stop_requested.is_set()

    @property
    def is_done(self) -> bool:
        return self._done.is_set()

    @property
    def run_time_ms(self) -> int:
        end = self.end_time or time.time()
        return int(1000 * (end - self.start_time)) if self.start_time else 0

    def to_dict(self) -> dict:
        """The REST /3/Jobs schema."""
        return {
            "key": self.key, "description": self.description,
            "status": self.status, "progress": self.progress,
            "progress_msg": self.progress_msg, "dest": self.dest,
            "msec": self.run_time_ms,
            "phases": {k: round(v, 3)
                       for k, v in list(self.phases.items())},
            "exception": repr(self.exception) if self.exception else None,
            "stacktrace": self.traceback,
        }


def jobs_list() -> list[dict]:
    return [DKV.get(k).to_dict() for k in DKV.keys() if k.startswith("job_")]

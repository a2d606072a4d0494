"""The compute substrate of the port: H2O's MRTask over a world of ranks
(h2o3_tpu/parallel/mrtask.py).

Reference: water/MRTask.java:65 — fan a task out over the nodes, run
`map(Chunk[])` on each node's rows, `reduce` the partial results back.

In the port a frame of a world of several ranks holds a contiguous block
of its rows on each rank (mesh.Cloud.row_block), so:

  * map_reduce(fn, ...)  — `fn` runs on this rank's rows and its partial
    result is summed over the world (one all-reduce a tensor); the
    result equals `fn` over the whole frame wherever the partials add
    exactly (integer counts, fixed-point sums).
  * map_chunks(fn, ...)  — `fn` runs on this rank's rows and may reduce
    over the world itself (`shard_sum`, `shard_max`).
  * host_fetch(x)        — gather every rank's rows of `x` in rank order,
    to a numpy array on every rank (through CPU tensors: gloo cannot
    gather CUDA tensors).

Every all-reduce adds its calls, bytes and host seconds to `ALLREDUCE`,
every row gather to `GATHER` (read per host as the h2o3_allreduce_* and
h2o3_gather_* gauges of /metrics).

Every dispatch goes through `_traced_dispatch`: it yields a batch (Job)
dispatch to pending interactive scoring (serving/qos.batch_yield), is
watched by the stall watchdog (kind "device"), meters its wall seconds to
the ambient principal, records an mrtask span inside a trace, retries
once across an epoch bump (deploy/membership.retry_once) and runs as one
guarded region of the collective guard (parallel/compat.py), so the
world's collectives pair in order. A world of one reduces nothing and
guards nothing.

The JAX module's `cached_jit` and `jit_rows` have no torch counterpart:
there is no trace to cache (an eager call runs the kernels of its
tensors' device). Its `device_put_rows`, `device_put_replicated` and
`row_mask` have none either: a rank's block of a loaded frame is cut
from the `.hex` planes before the codecs place them (io/persist.py), a
whole copy is a plain `torch.as_tensor` on the rank's device, and no
rank pads its rows to a common length. The chunk lookahead (`prefetch_chunks`,
`map_chunked`) overlaps the pager's promotion of the next chunks with
the compute of the current one.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

_qos_mod = None
_usage_mod = None
ALLREDUCE = {"calls": 0, "bytes": 0, "seconds": 0.0}
GATHER = {"calls": 0, "bytes": 0, "seconds": 0.0}


def _qos():
    """Lazy serving/qos handle: the serving package imports the frame
    module, which imports this one, so a module-level import would cycle;
    by the first dispatch the import graph is settled."""
    global _qos_mod
    if _qos_mod is None:
        from h2o3_tpu_torch.serving import qos
        _qos_mod = qos
    return _qos_mod


def _usage():
    """Lazy obs/usage handle — same cycle-avoidance shape as _qos()."""
    global _usage_mod
    if _usage_mod is None:
        from h2o3_tpu_torch.obs import usage
        _usage_mod = usage
    return _usage_mod


def _cloud():
    from h2o3_tpu_torch.parallel import mesh as _mesh
    return _mesh.cloud()


def world() -> int:
    """Ranks in the formed cloud (1 before one is formed)."""
    from h2o3_tpu_torch.parallel import mesh as _mesh
    c = _mesh._CLOUD
    return 1 if c is None else c.world


def frame_block(frame):
    """(lo, hi, global nrows) of a frame that holds one block of its rows
    on each rank of a cloud of several, or None for a whole frame."""
    sh = getattr(frame, "shard", None)
    return sh if sh is not None and world() > 1 else None


def sharded(frame) -> bool:
    return frame_block(frame) is not None


def reset_allreduce_stats():
    for d in (ALLREDUCE, GATHER):
        d.update(calls=0, bytes=0, seconds=0.0)


# ---------------------------------------------------------------------------
# collectives
def _group():
    """The world's process group, or WorldBroken when a membership change
    left it short of a rank."""
    from h2o3_tpu_torch.parallel import mesh as _mesh
    c = _cloud()
    if c.broken:
        raise _mesh.WorldBroken(c.broken)
    return c.group


def _all_reduce(t: torch.Tensor, op) -> torch.Tensor:
    import torch.distributed as dist
    g = _group()
    t0 = time.perf_counter()
    with _guarded():
        # a card's tensor is reduced through one host copy each way
        h = t.cpu() if t.is_cuda else t
        dist.all_reduce(h, op=op, group=g)
        if h is not t:
            t.copy_(h)
    ALLREDUCE["calls"] += 1
    ALLREDUCE["bytes"] += t.numel() * t.element_size()
    ALLREDUCE["seconds"] += time.perf_counter() - t0
    return t


def _guarded():
    from h2o3_tpu_torch.parallel import compat as _compat
    return _compat.host_collective_guard()


def shard_sum(x: torch.Tensor) -> torch.Tensor:
    """x summed over the world's ranks (a new tensor; `x` itself in a
    world of one). Exact for integer dtypes."""
    if world() == 1:
        return x
    import torch.distributed as dist
    return _all_reduce(x.contiguous().clone(), dist.ReduceOp.SUM)


def shard_max(x: torch.Tensor) -> torch.Tensor:
    """The elementwise maximum of x over the world's ranks."""
    if world() == 1:
        return x
    import torch.distributed as dist
    return _all_reduce(x.contiguous().clone(), dist.ReduceOp.MAX)


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of `x` (dim 0) concatenated in rank order, on x's
    device; `x` itself in a world of one. The blocks may differ in length
    by a row (mesh.Cloud.row_block): each is padded to the longest for the
    gather and trimmed after."""
    if world() == 1:
        return x
    import torch.distributed as dist
    c = _cloud()
    g = _group()
    t0 = time.perf_counter()
    host = x.detach().contiguous().cpu()
    n = torch.tensor([host.shape[0]], dtype=torch.int64)
    with _guarded():
        sizes = [torch.zeros(1, dtype=torch.int64) for _ in range(c.world)]
        dist.all_gather(sizes, n, group=g)
        sizes = [int(s) for s in sizes]
        m = max(sizes)
        pad = torch.zeros((m,) + tuple(host.shape[1:]), dtype=host.dtype)
        pad[: host.shape[0]] = host
        parts = [torch.empty_like(pad) for _ in range(c.world)]
        dist.all_gather(parts, pad, group=g)
    out = torch.cat([p[:s] for p, s in zip(parts, sizes)]).to(x.device)
    GATHER["calls"] += 1
    GATHER["bytes"] += out.numel() * out.element_size()
    GATHER["seconds"] += time.perf_counter() - t0
    return out


def host_fetch(x) -> np.ndarray:
    """np.asarray of a row-sharded tensor: every rank's rows, gathered to
    the host in rank order (the MRTask result-collection hop). A world of
    one takes the plain copy."""
    if isinstance(x, torch.Tensor):
        if world() == 1:
            return x.detach().cpu().numpy()
        from h2o3_tpu_torch.obs import tracing as _tracing
        from h2o3_tpu_torch.obs.timeline import span as _span
        ctx = _span("mrtask.host_fetch", shape=[int(d) for d in x.shape]) \
            if _tracing.current() is not None else contextlib.nullcontext()
        with ctx:
            return gather_rows(x).cpu().numpy()
    return np.asarray(x)


# ---------------------------------------------------------------------------
# the dispatch funnel
def _dispatch_once(fn, arrays):
    """One dispatch. The chaos hook lets the fault harness fail a seeded
    dispatch with EpochChanged."""
    from h2o3_tpu_torch.deploy import chaos as _chaos
    from h2o3_tpu_torch.deploy import membership as _mb
    _chaos.maybe_raise("mrtask.dispatch", exc=_mb.EpochChanged)
    return fn(*arrays)


def _dispatch_retrying(fn, arrays, retryable: bool):
    """Membership-aware dispatch: a dispatch that straddles a cloud epoch
    bump retries ONCE against the new epoch (a world that lost a rank then
    raises WorldBroken at its first collective)."""
    from h2o3_tpu_torch.deploy import membership as _mb
    if retryable and _mb.MEMBERSHIP.multi:
        return _mb.retry_once(lambda: _dispatch_once(fn, arrays),
                              op="mrtask")
    return _dispatch_once(fn, arrays)


def _traced_dispatch(name: str, fn, arrays, retryable=True):
    """Dispatch `fn(*arrays)` (see the module docstring): the priority
    lane's yield, the watchdog's device watch, the usage meter, a span
    inside an active trace, the epoch retry, the collective guard."""
    from h2o3_tpu_torch.obs import tracing as _tracing
    from h2o3_tpu_torch.obs import watchdog as _wd
    from h2o3_tpu_torch.obs.timeline import span as _span
    _qos().batch_yield()
    fname = getattr(fn, "__name__", "<fn>")
    with _wd.watch("device", desc=f"{name}:{fname}"), \
            _usage().meter(name), _guarded():
        if _tracing.current() is not None:
            with _span(name, fn=fname):
                return _dispatch_retrying(fn, arrays, retryable)
        return _dispatch_retrying(fn, arrays, retryable)


def map_reduce(fn, *arrays, prefetch=()):
    """`fn` over this rank's rows of `arrays`, its tensor result (or tuple
    of tensors) summed over the world. `prefetch` takes chunk handles
    whose promotion should overlap this dispatch."""
    prefetch_chunks(prefetch)

    def run(*arrs):
        out = fn(*arrs)
        if isinstance(out, tuple):
            return tuple(shard_sum(o) for o in out)
        return shard_sum(out)
    run.__name__ = getattr(fn, "__name__", "<fn>")
    return _traced_dispatch("mrtask.map_reduce", run, arrays)


def map_chunks(fn, *arrays, prefetch=()):
    """`fn` once on this rank's rows ("node"); it may reduce over the
    world itself (shard_sum / shard_max / gather_rows)."""
    prefetch_chunks(prefetch)
    return _traced_dispatch("mrtask.map_chunks", fn, arrays)


# ---------------------------------------------------------------------------
# the chunk lookahead
def prefetch_chunks(handles):
    """Start the promotion of chunk handles (Vecs or TierChunks) on the
    pager's worker; a later fault finds them on the card."""
    if not handles:
        return
    from h2o3_tpu_torch.core import tiering as _tiering
    _tiering.PAGER.prefetch(handles)


def map_chunked(fn, chunks, *, lookahead: int = 1):
    """`fn(chunk)` for each handle in order, each next `lookahead` handles
    queued once for prefetch while the current one computes. Returns the
    results; the reduction is the caller's."""
    seq = list(chunks)
    out = []
    queued = 0          # windows overlap: queue each handle once
    for i, c in enumerate(seq):
        if lookahead > 0 and i + 1 < len(seq):
            lo = max(queued, i + 1)
            hi = i + 1 + lookahead
            if hi > lo:
                prefetch_chunks(seq[lo:hi])
                queued = hi
        out.append(fn(c))
    return out

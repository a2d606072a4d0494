"""The chunk lookahead of MRTask in the port (h2o3_tpu/parallel/mrtask.py
`prefetch_chunks` and `map_chunked`).

A pass over out-of-core chunk handles runs `fn` on each in turn while the
pager's worker promotes the next `lookahead` handles, so a copy to the
card overlaps the compute of the chunk before it. The rest of the JAX
module (device dispatch, sharded puts, the jit cache) waits for the
compute-substrate item of ROADMAP.md.
"""

from __future__ import annotations


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

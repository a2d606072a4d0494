"""The memory manager of the port (h2o3_tpu/core/memory.py,
water/MemoryManager.java and water/Cleaner.java).

Paging is chunk-granular and lives in core/tiering.py. This is the
frame-level face of it: the bytes a frame holds in memory, the Cleaner's
wake-up when a frame registers, an explicit spill and load of a whole
frame, and pinning. A spilled frame is one whose every chunk is on disk;
`DKV.get` brings its planes back to host memory and faults to the card
stay lazy, one chunk at a time.
"""

from __future__ import annotations

from h2o3_tpu_torch.core import tiering as _tiering
from h2o3_tpu_torch.io import spill as _spill

_CHUNK_ATTRS = ("_chunk", "_codes_chunk", "_nzr_chunk", "_nzv_chunk",
                "_uuid_chunk")


def frame_chunks(frame) -> list:
    """Every pageable chunk of a frame's Vecs: dense planes, StrVec code
    planes, SparseVec nz planes and UuidVec lanes."""
    out = []
    for v in frame.vecs:
        for attr in _CHUNK_ATTRS:
            c = getattr(v, attr, None)
            if c is not None:
                out.append(c)
    return out


class MemoryManager:
    def __init__(self):
        self.pager = _tiering.PAGER

    # ---- config ---------------------------------------------------------
    @property
    def budget(self) -> int:
        """The HBM budget in bytes (0: none)."""
        return self.pager.hbm_budget

    @budget.setter
    def budget(self, value: int):
        self.pager.hbm_budget = int(value)

    @property
    def ice_root(self) -> str:
        return _spill.get_ice_root()

    @ice_root.setter
    def ice_root(self, path: str):
        _spill.set_ice_root(path)

    # ---- accounting -----------------------------------------------------
    def frame_bytes(self, frame) -> int:
        """Packed bytes of the frame's chunks held in memory (card or
        host); a chunk whose only copy is a spill file counts 0. The JAX
        package pads each chunk to its mesh's rows, the port does not, so
        the two differ by the padding (ROADMAP.md §3)."""
        return sum(c.nbytes for c in frame_chunks(frame)
                   if c.tier != _tiering.TIER_DISK)

    def _chunks_of(self, key: str):
        from h2o3_tpu_torch.core.frame import Frame
        from h2o3_tpu_torch.core.kvstore import DKV
        f = DKV.raw_get(key)         # accounting never faults a chunk
        return frame_chunks(f) if isinstance(f, Frame) else []

    def touch(self, key: str):
        self.pager.touch_chunks(self._chunks_of(key))

    def pin(self, key: str):
        for c in self._chunks_of(key):
            c.pinned += 1

    def unpin(self, key: str):
        for c in self._chunks_of(key):
            if c.pinned:
                c.pinned -= 1

    # ---- the Cleaner ----------------------------------------------------
    def maybe_clean(self):
        """Enforce the budgets, demoting cold chunks (free without one)."""
        return self.pager.maybe_demote()

    def spill(self, key: str, frame=None):
        """Demote every chunk of the frame to disk; returns the spill
        directory."""
        from h2o3_tpu_torch.core.kvstore import DKV
        frame = frame if frame is not None else DKV.raw_get(key)
        for c in frame_chunks(frame):
            self.pager.demote(c, _tiering.TIER_DISK)
        return _spill.chunk_dir()

    def load(self, key: str):
        """Fault every chunk of the frame back to the card."""
        from h2o3_tpu_torch.core.kvstore import DKV
        f = DKV.raw_get(key)
        if f is not None:
            for c in frame_chunks(f):
                c.device()
        return f

    def is_spilled(self, key: str) -> bool:
        chunks = self._chunks_of(key)
        return bool(chunks) and all(
            c.tier == _tiering.TIER_DISK for c in chunks)

    def is_hbm_resident(self, key: str) -> bool:
        return any(c.tier == _tiering.TIER_HBM
                   for c in self._chunks_of(key))

    def stats(self) -> dict:
        from h2o3_tpu_torch.core.frame import Frame
        from h2o3_tpu_torch.core.kvstore import DKV
        spilled = [k for k in DKV.keys()
                   if isinstance(DKV.raw_get(k), Frame)
                   and self.is_spilled(k)]
        st = self.pager.stats()
        return {"ice_root": self.ice_root, "budget_bytes": self.budget,
                "resident_bytes": st["tier_bytes"][_tiering.TIER_HBM],
                "tier_bytes": st["tier_bytes"],
                "faults": st["faults"], "spilled": sorted(spilled)}


MANAGER = MemoryManager()

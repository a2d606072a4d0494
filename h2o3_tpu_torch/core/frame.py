"""Columnar Frame/Vec of the port (h2o3_tpu/core/frame.py).

A numeric, time or categorical Vec is one f32 tensor of `nrows` values on
the cloud's device, NaN marking NA; a categorical Vec stores level ids and
its `domain` (level names in sorted order, as the JAX parser assigns them).
`Frame.matrix()` stacks columns into an (nrows, k) f32 device tensor with
the same values the JAX package's `matrix()` returns for the real rows.

Not in this slice: the dtype codecs, the tier pager, StrVec, UuidVec and
SparseVec. A string column is kept on the host only (`type == "str"`): the
tree models skip it like the JAX package does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch

from h2o3_tpu_torch.core.kvstore import DKV
from h2o3_tpu_torch.parallel import mesh as _mesh

T_NUM = "num"
T_CAT = "enum"
T_TIME = "time"
T_STR = "str"
T_UUID = "uuid"


@dataclasses.dataclass
class Rollups:
    """RollupStats: per-Vec min/max/mean/sigma/NA count, cached."""
    min: float
    max: float
    mean: float
    sigma: float
    nas: int
    zeros: int
    is_int: bool


class Vec:
    """A typed column: f32 device tensor with NaN NAs (or host strings)."""

    def __init__(self, data: Optional[torch.Tensor], nrows: int,
                 type: str = T_NUM, domain=None, host_data=None):
        self.data = data
        self.nrows = int(nrows)
        self.type = type
        self.domain = (np.asarray(domain, dtype=object)
                       if domain is not None else None)
        self.host_data = host_data
        self._rollups: Optional[Rollups] = None

    # ---- construction ---------------------------------------------------
    @staticmethod
    def from_numpy(col: np.ndarray, type: Optional[str] = None, domain=None,
                   device=None) -> "Vec":
        """One host column; strings become categorical (sorted levels)."""
        col = np.asarray(col)
        if col.dtype == object or col.dtype.kind in "US":
            return Vec._from_strings(col, force_type=type, domain=domain,
                                     device=device)
        if col.dtype == bool:
            col = col.astype(np.float64)
        vtype = type or (T_CAT if domain is not None else T_NUM)
        x = torch.from_numpy(np.asarray(col, np.float64).astype(np.float32))
        dev = device or _mesh.cloud().device
        return Vec(x.to(dev), len(col), vtype, domain)

    @staticmethod
    def from_tensor(col: torch.Tensor, type: str = T_NUM,
                    domain=None) -> "Vec":
        """A device-resident column (f32, NaN = NA): no host round trip."""
        if col.dim() != 1:
            raise ValueError("a Vec is one-dimensional")
        return Vec(col.to(torch.float32).contiguous(), col.shape[0], type,
                   domain)

    @staticmethod
    def _from_strings(col, force_type=None, domain=None, device=None):
        sarr = np.asarray(col, dtype=object)
        na = np.array([s is None or (isinstance(s, float) and math.isnan(s))
                       or (isinstance(s, str) and s == "") for s in sarr],
                      bool)
        if force_type == T_STR:
            return Vec(None, len(sarr), T_STR,
                       host_data=np.where(na, None, sarr))
        if force_type == T_UUID:
            raise NotImplementedError(
                "uuid columns are not ported yet (UuidVec, a later slice)")
        if domain is None:
            domain = sorted({str(s) for s, bad in zip(sarr, na) if not bad})
        lookup = {s: i for i, s in enumerate(domain)}
        codes = np.array([np.nan if bad else lookup.get(str(s), np.nan)
                          for s, bad in zip(sarr, na)], np.float64)
        return Vec.from_numpy(codes, type=T_CAT, domain=domain,
                              device=device)

    # ---- access ---------------------------------------------------------
    @property
    def device(self):
        return self.data.device if self.data is not None else None

    def as_f32(self) -> torch.Tensor:
        if self.data is None:
            raise TypeError("string Vec has no numeric view")
        return self.data

    def to_numpy(self) -> np.ndarray:
        if self.type == T_STR:
            return self.host_data.copy()
        return self.data.detach().cpu().numpy().astype(np.float64)

    def levels(self):
        return list(self.domain) if self.domain is not None else None

    # ---- rollups (lazy, cached) -----------------------------------------
    def rollups(self) -> Rollups:
        if self._rollups is None:
            self._rollups = self._compute_rollups()
        return self._rollups

    def _compute_rollups(self) -> Rollups:
        if self.type == T_STR:
            na = sum(1 for s in self.host_data if s is None)
            return Rollups(math.nan, math.nan, math.nan, math.nan, na, 0,
                           False)
        x = self.data.to(torch.float64)
        isna = torch.isnan(x)
        xz = torch.where(isna, torch.zeros_like(x), x)
        inf = torch.full_like(x, math.inf)
        stats = torch.stack([
            (~isna).sum().to(torch.float64), xz.sum(), (xz * xz).sum(),
            torch.where(isna, inf, x).min(), torch.where(isna, -inf, x).max(),
            isna.sum().to(torch.float64),
            ((xz == 0) & ~isna).sum().to(torch.float64),
            (xz - torch.round(xz)).abs().sum()]).cpu().tolist()
        cnt, s, s2, mn, mx, nas, zeros, frac = stats
        mean = s / cnt if cnt else math.nan
        var = max(0.0, s2 / cnt - mean * mean) if cnt > 1 else 0.0
        sigma = math.sqrt(var * cnt / (cnt - 1)) if cnt > 1 else 0.0
        return Rollups(mn if cnt else math.nan, mx if cnt else math.nan,
                       mean, sigma, int(nas), int(zeros), frac == 0.0)

    def is_const(self) -> bool:
        """No NA and one distinct value (the JAX "const" codec with no NAs),
        the test behind `ignore_const_cols`."""
        if self.type == T_STR:
            return False
        r = self.rollups()
        return r.nas == 0 and r.min == r.max


class Frame:
    """A named, ordered set of equal-length Vecs, registered in the DKV."""

    def __init__(self, names: Sequence[str], vecs: Sequence[Vec],
                 key: Optional[str] = None):
        if len(names) != len(vecs):
            raise ValueError("names and vecs differ in length")
        ns = {v.nrows for v in vecs}
        if len(ns) > 1:
            raise ValueError(f"ragged frame: row counts {ns}")
        self.names = list(names)
        self.vecs = list(vecs)
        self.key = key or DKV.make_key("frame")
        self._matrix_cache: dict = {}
        DKV.put(self.key, self)

    @staticmethod
    def from_numpy(mat: np.ndarray, names: Optional[Sequence[str]] = None,
                   key: Optional[str] = None) -> "Frame":
        mat = np.asarray(mat)
        if mat.ndim == 1:
            mat = mat[:, None]
        names = list(names) if names else [f"C{i+1}"
                                           for i in range(mat.shape[1])]
        return Frame(names, [Vec.from_numpy(mat[:, j])
                             for j in range(mat.shape[1])], key)

    @property
    def nrows(self) -> int:
        return self.vecs[0].nrows if self.vecs else 0

    @property
    def ncols(self) -> int:
        return len(self.vecs)

    @property
    def types(self) -> dict:
        return {n: v.type for n, v in zip(self.names, self.vecs)}

    def vec(self, name) -> Vec:
        if isinstance(name, (int, np.integer)):
            return self.vecs[int(name)]
        return self.vecs[self.names.index(name)]

    def matrix(self, cols: Optional[Sequence[str]] = None) -> torch.Tensor:
        """(nrows, k) f32 device tensor, NaN for NA. Cached per columns."""
        cols = tuple(cols if cols is not None else self.names)
        hit = self._matrix_cache.get(cols)
        if hit is None:
            hit = torch.stack([self.vec(c).as_f32() for c in cols], dim=1)
            self._matrix_cache[cols] = hit
        return hit

    def to_numpy(self, cols=None) -> np.ndarray:
        cols = cols if cols is not None else self.names
        return np.column_stack([self.vec(c).to_numpy() for c in cols])

    def __repr__(self):
        return f"<Frame {self.key} {self.nrows}x{self.ncols} {self.names[:8]}>"

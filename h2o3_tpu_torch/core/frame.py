"""Columnar Frame/Vec of the port (h2o3_tpu/core/frame.py, water/fvec).

A Vec is one packed plane on the cloud's device, its dtype chosen at
ingest by the JAX package's codec (`_choose_codec`: const, int8 and int16
with an integer bias, int32, or float32), with an optional uint8 NA
plane. Both planes live behind one `TierChunk` of the pager
(core/tiering.py), so `Vec.data` and `Vec.mask` may fault a demoted
chunk back to the card. `as_f32` decodes as the JAX package does, in
f32: `f32(stored) + f32(bias)`, then NaN where the mask is set; the f32
codec without NAs returns its plane itself, with no copy. Unlike the JAX
package, the port pads no rows: a plane holds `nrows` values.

The other layouts, each paged like a dense plane:
  * StrVec - int32 dictionary codes on the card (-1 for NA) and the
    level table on the host; string munging maps the levels, then
    gathers codes on the card;
  * UuidVec - four int32 words a row and an int32 NA lane;
  * SparseVec - the rows and values of the nonzeros (two chunks); GLM's
    sparse path reads them through `Frame.sparse_coo` and never
    densifies.

Dense rollups are summed in float64 on the device; a SparseVec's come
from its host value plane as in the JAX package. `from_pandas`,
`as_data_frame` and `head` import pandas when they are called.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch

from h2o3_tpu_torch.core import tiering as _tiering
from h2o3_tpu_torch.core.kvstore import DKV
from h2o3_tpu_torch.core.memory import MANAGER, frame_chunks
from h2o3_tpu_torch.parallel import mesh as _mesh
from h2o3_tpu_torch.parallel import mrtask as _mr

T_NUM = "num"
T_CAT = "enum"
T_TIME = "time"
T_STR = "str"
T_UUID = "uuid"
T_BAD = "bad"  # all-NA column

PAGER = _tiering.PAGER


# ---------------------------------------------------------------------------
# Codecs (NewChunk's choice of the narrowest storage on close)
@dataclasses.dataclass(frozen=True)
class Codec:
    kind: str           # "const" | "i8" | "i16" | "i32" | "f32"
    bias: float = 0.0   # value = stored + bias (the integer kinds)
    const_val: float = float("nan")  # for kind == "const"

    @property
    def np_dtype(self):
        return {"i8": np.int8, "i16": np.int16, "i32": np.int32,
                "f32": np.float32, "const": np.int8}[self.kind]


def _choose_codec(col: np.ndarray, mask: np.ndarray):
    """(packed ndarray, Codec) for a float64 host column: the JAX
    package's choice, NAs stored as 0 with the mask authoritative."""
    has_na = bool(mask.any())
    valid = col[mask == 0] if has_na else col
    if valid.size == 0:
        return np.zeros(col.shape, np.int8), Codec("const",
                                                   const_val=float("nan"))
    vmin, vmax = float(valid.min()), float(valid.max())
    if vmin == vmax:  # constant; NAs live in the mask
        return np.zeros(col.shape, np.int8), Codec("const", const_val=vmin)
    filled = np.where(mask, 0.0, col) if has_na else col
    is_int = math.isfinite(vmin) and math.isfinite(vmax) \
        and math.floor(vmin) == vmin and math.floor(vmax) == vmax \
        and bool(np.all(np.floor(valid) == valid))
    if is_int:
        span = vmax - vmin
        for kind, lim, dt in (("i8", 254, np.int8), ("i16", 65534, np.int16)):
            if span <= lim:
                bias = math.floor(vmin + span // 2 + 1)  # centre the range
                packed = np.where(mask, 0, filled - bias).astype(dt)
                return packed, Codec(kind, bias=bias)
        if -2**31 < vmin and vmax < 2**31 - 1:
            packed = np.where(mask, 0, filled).astype(np.int32)
            return packed, Codec("i32")
    return filled.astype(np.float32), Codec("f32")


def _decode_f32(data: torch.Tensor, codec: Codec,
                mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Packed plane to f32 with NaN NAs, in f32 as the JAX package does
    (an integer column far from zero can differ by an ulp from its
    float64 value rounded once). The f32 plane without a mask is returned
    as it is."""
    if codec.kind == "const":
        x = torch.full(data.shape, codec.const_val, dtype=torch.float32,
                       device=data.device)
    else:
        x = data if data.dtype == torch.float32 else data.to(torch.float32)
        if codec.bias:
            # f32(bias) exactly, so the add rounds once in f32
            x = x + float(np.float32(codec.bias))
    if mask is not None:
        x = torch.where(mask != 0, torch.full_like(x, math.nan), x)
    return x


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


def _device(device=None) -> torch.device:
    return torch.device(device) if device is not None \
        else _mesh.cloud().device


def _put(a: np.ndarray, device) -> torch.Tensor:
    """A host plane on `device` (shared with numpy on the CPU)."""
    return _tiering._host_tensor(a).to(device)


class Vec:
    """A typed column: a packed plane and NA plane behind one TierChunk."""

    def __init__(self, data, codec: Codec, mask, nrows: int,
                 type: str = T_NUM, domain=None, host_data=None,
                 packed_host=None, packed_mask=None, device=None):
        # data None with packed_host: born cold, parked in the host tier
        if data is not None or packed_host is not None:
            host = (packed_host, packed_mask) \
                if packed_host is not None else None
            self._chunk = PAGER.new_chunk(data, mask, host=host, label=type,
                                          device=_device(device))
        else:
            self._chunk = None
        self.codec = codec
        self.nrows = int(nrows)
        self.type = type
        self.domain = (np.asarray(domain, dtype=object)
                       if domain is not None else None)
        self.host_data = host_data
        self._rollups: Optional[Rollups] = None

    @property
    def data(self):
        """The packed plane on the card; faults the chunk."""
        ch = self._chunk
        return ch.device()[0] if ch is not None else None

    @property
    def mask(self):
        """The uint8 NA plane or None; faults with the data plane."""
        ch = self._chunk
        return ch.device()[1] if ch is not None else None

    @property
    def device(self):
        """The device the Vec's planes live on (read without a fault)."""
        ch = self._home_chunk()
        return ch.target if ch is not None else None

    def _home_chunk(self):
        return self._chunk

    # ---- construction ---------------------------------------------------
    @staticmethod
    def from_numpy(col: np.ndarray, type: Optional[str] = None, domain=None,
                   device=None) -> "Vec":
        """One host column, typed as ParseSetup types it: strings become
        categorical (sorted levels) unless `type` says str or uuid."""
        col = np.asarray(col)
        if col.dtype == object or col.dtype.kind in "US":
            return Vec._from_strings(col, force_type=type, domain=domain,
                                     device=device)
        if np.issubdtype(col.dtype, np.datetime64):
            ms = col.astype("datetime64[ms]")
            nat = np.isnat(ms)
            vals = ms.astype(np.int64).astype(np.float64)
            return Vec._from_floats(np.where(nat, 0.0, vals), nat, T_TIME,
                                    device=device)
        if col.dtype == bool:
            col = col.astype(np.float64)
        col = col.astype(np.float64, copy=False)
        vtype = type or (T_CAT if domain is not None else T_NUM)
        return Vec._from_floats(col, np.isnan(col), vtype, domain, device)

    @staticmethod
    def _from_floats(col, mask, vtype, domain=None, device=None) -> "Vec":
        n = len(col)
        has_na = bool(mask.any())
        packed, codec = _choose_codec(
            np.where(mask, 0.0, col) if has_na else col, mask)
        mask_np = mask.astype(np.uint8) if has_na else None
        return Vec._from_packed(packed, codec, mask_np, n, vtype, domain,
                                device)

    @staticmethod
    def _from_packed(packed, codec, mask_np, n, vtype, domain=None,
                     device=None) -> "Vec":
        """A Vec over host planes already packed by `codec`."""
        dev = _device(device)
        if PAGER.ingest_cold:
            # budgeted ingest: a copy to the card now would overshoot the
            # budget before the pager could act
            return Vec(None, codec, None, n, vtype, domain,
                       packed_host=packed, packed_mask=mask_np, device=dev)
        return Vec(_put(packed, dev), codec,
                   None if mask_np is None else _put(mask_np, dev), n,
                   vtype, domain, packed_host=packed, packed_mask=mask_np)

    @staticmethod
    def from_tensor(col: torch.Tensor, type: str = T_NUM,
                    domain=None, has_na=None) -> "Vec":
        """A column already on the device (f32, NaN = NA), stored with the
        f32 codec (the JAX package's `from_device_floats`): no host round
        trip, and without NaNs the tensor itself is the plane. A caller
        that knows whether the column holds a NaN passes `has_na`, and
        the column is not tested on the device (which waits on it)."""
        if col.dim() != 1:
            raise ValueError("a Vec is one-dimensional")
        x = col.to(torch.float32).contiguous()
        if has_na is None:
            has_na = bool(torch.isnan(x).any())
        if has_na:
            isna = torch.isnan(x)
            return Vec(torch.where(isna, torch.zeros_like(x), x),
                       Codec("f32"), isna.to(torch.uint8), x.shape[0], type,
                       domain)
        return Vec(x, Codec("f32"), None, x.shape[0], type, domain)

    @staticmethod
    def _from_strings(col, force_type=None, domain=None, device=None):
        """Strings are categorical by default (sorted levels); str keeps
        them as dictionary codes (StrVec), uuid as words (UuidVec)."""
        sarr = np.asarray(col, dtype=object)
        if force_type == T_STR:
            return StrVec.encode(sarr, device=device)
        if force_type == T_UUID:
            return UuidVec.encode(sarr, device=device)
        na = np.array([s is None or (isinstance(s, float) and math.isnan(s))
                       or (isinstance(s, str) and s == "") for s in sarr],
                      bool)
        if domain is None:
            domain = sorted({str(s) for s, bad in zip(sarr, na) if not bad})
        lookup = {s: i for i, s in enumerate(domain)}
        codes = np.array([-1 if bad else lookup.get(str(s), -1)
                          for s, bad in zip(sarr, na)], np.float64)
        mask = codes < 0
        return Vec._from_floats(np.where(mask, 0.0, codes), mask, T_CAT,
                                domain, device)

    # ---- access ---------------------------------------------------------
    def as_f32(self) -> torch.Tensor:
        """The decoded f32 column, NaN for NA (one fault for both
        planes)."""
        if self.type == T_STR:
            raise TypeError("string Vec has no numeric view")
        data, mask = self._chunk.device()
        return _decode_f32(data, self.codec, mask)

    def to_numpy(self) -> np.ndarray:
        return self.as_f32().detach().cpu().numpy().astype(np.float64)

    def levels(self):
        return list(self.domain) if self.domain is not None else None

    @property
    def cardinality(self) -> int:
        return len(self.domain) if self.domain is not None else 0

    def __len__(self):
        return self.nrows

    # ---- rollups (lazy, cached) -----------------------------------------
    def rollups(self) -> Rollups:
        if self._rollups is None:
            self._rollups = self._compute_rollups()
        return self._rollups

    def _compute_rollups(self) -> Rollups:
        x = self.as_f32().to(torch.float64)
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

    def min(self) -> float:
        return self.rollups().min

    def max(self) -> float:
        return self.rollups().max

    def mean(self) -> float:
        return self.rollups().mean

    def na_cnt(self) -> int:
        return self.rollups().nas

    def is_int(self) -> bool:
        return self.rollups().is_int

    def sigma(self) -> float:
        """Sample standard deviation (n - 1), as RollupStats."""
        return self.rollups().sigma

    def is_const(self) -> bool:
        """No NA and one distinct value (the "const" codec with no NAs),
        the test behind `ignore_const_cols`."""
        r = self.rollups()
        return r.nas == 0 and r.min == r.max


# ---------------------------------------------------------------------------
class StrVec(Vec):
    """A string column as dictionary codes (CStrChunk): int32 codes on
    the card, -1 for NA, behind their own chunk, and the sorted level
    table on the host. Value transforms map the levels (O(unique) host
    calls), then remap the codes by one gather on the card; the n-sized
    object array exists only when `host_data` or `to_numpy` asks."""

    def __init__(self, codes_dev, levels, nrows: int, host_codes=None,
                 device=None):
        host = (host_codes, None) if host_codes is not None else None
        self._codes_chunk = PAGER.new_chunk(
            codes_dev, None, host=host, label="strcodes",
            device=_device(device))
        self._levels = np.asarray(levels, dtype=object)
        super().__init__(None, Codec("const"), None, nrows, T_STR)

    def _home_chunk(self):
        return self._codes_chunk

    @property
    def codes(self) -> torch.Tensor:
        """(nrows,) int32 codes on the card; faults the plane."""
        return self._codes_chunk.device()[0]

    @staticmethod
    def encode(col: np.ndarray, device=None) -> "StrVec":
        """Dictionary-encode a host object array (None or NaN is NA)."""
        n = len(col)
        na = np.array([s is None or (isinstance(s, float) and math.isnan(s))
                       for s in col], bool)
        strs = np.asarray(["" if bad else str(s)
                           for s, bad in zip(col, na)], dtype=object)
        levels, inv = np.unique(strs[~na], return_inverse=True)
        codes = np.full(n, -1, np.int32)
        codes[~na] = inv
        return StrVec.from_codes(codes, levels, device)

    @staticmethod
    def from_codes(codes: np.ndarray, levels, device=None) -> "StrVec":
        """int32 host codes (-1 for NA) into sorted `levels`."""
        codes = np.ascontiguousarray(codes, np.int32)
        dev = _device(device)
        if PAGER.ingest_cold:
            return StrVec(None, levels, len(codes), host_codes=codes,
                          device=dev)
        return StrVec(_put(codes, dev), levels, len(codes),
                      host_codes=codes)

    # ---- Vec surface -----------------------------------------------------
    @property
    def levels_arr(self) -> np.ndarray:
        return self._levels

    @property
    def host_data(self):
        """The n-sized object array, decoded on demand."""
        codes = self.codes.cpu().numpy()[: self.nrows]
        out = np.empty(self.nrows, object)
        ok = codes >= 0
        out[ok] = self._levels[codes[ok]]
        return out

    @host_data.setter
    def host_data(self, v):  # Vec.__init__ assigns None
        if v is not None:
            raise AttributeError("StrVec host_data is derived")

    def to_numpy(self) -> np.ndarray:
        return self.host_data

    def is_const(self) -> bool:
        return False

    # ---- string ops through the dictionary -------------------------------
    def map_values(self, fn) -> "StrVec":
        """Map every level by `fn` (levels may merge), then remap the
        codes by one gather."""
        mapped = np.asarray([fn(s) for s in self._levels], dtype=object)
        new_levels, remap = (np.unique(mapped, return_inverse=True)
                             if len(mapped) else (mapped, mapped))
        tbl = np.asarray(remap, np.int32).reshape(-1) if len(mapped) \
            else np.zeros(1, np.int32)
        codes = self.codes
        return StrVec(_remap_codes(codes, _put(tbl, codes.device)),
                      new_levels, self.nrows)

    def map_values_opt(self, fn) -> "StrVec":
        """As map_values, where `fn` may return None (NA)."""
        mapped = [fn(s) for s in self._levels]
        keep = [m for m in mapped if m is not None]
        new_levels = np.unique(np.asarray(keep, object)) if keep \
            else np.asarray([], object)
        lut = {s: i for i, s in enumerate(new_levels)}
        remap = np.asarray([-1 if m is None else lut[m] for m in mapped]
                           or [-1], np.int32)
        codes = self.codes
        return StrVec(_remap_codes(codes, _put(remap, codes.device)),
                      new_levels, self.nrows)

    def per_level_f32(self, fn) -> torch.Tensor:
        """(nrows,) f32 measure: a host table a level, gathered on the
        card (NaN at NA rows)."""
        tbl = np.asarray([float(fn(s)) for s in self._levels] or [0.0],
                         np.float32)
        codes = self.codes
        return _gather_level_f32(codes, _put(tbl, codes.device))

    def level_mask(self, pred) -> torch.Tensor:
        """(nrows,) f32 0/1 predicate through the dictionary."""
        return self.per_level_f32(lambda s: 1.0 if pred(s) else 0.0)

    def _compute_rollups(self) -> Rollups:
        nas = int((self.codes < 0).sum())
        return Rollups(min=math.nan, max=math.nan, mean=math.nan,
                       sigma=math.nan, nas=nas, zeros=0, is_int=False)


def _remap_codes(codes, tbl):
    safe = torch.clamp(codes, 0, tbl.shape[0] - 1).long()
    return torch.where(codes >= 0, tbl[safe], torch.full_like(codes, -1))


def _gather_level_f32(codes, tbl):
    safe = torch.clamp(codes, 0, tbl.shape[0] - 1).long()
    return torch.where(codes >= 0, tbl[safe], torch.full_like(tbl[safe],
                                                              math.nan))


# ---------------------------------------------------------------------------
class UuidVec(Vec):
    """A UUID column (C16Chunk): the 128 bits of a row as four int32 words
    (most significant first) and an int32 NA lane (1 = NA), both in one
    chunk. Equality and the NA predicate run on the card; arithmetic
    raises, as in the reference."""

    def __init__(self, words, na, nrows: int, device=None):
        words_host = np.ascontiguousarray(np.asarray(words, np.int32))
        na_host = np.ascontiguousarray(np.asarray(na, np.int32))
        dev = _device(device)
        if PAGER.ingest_cold:
            words_dev = na_dev = None
        else:
            words_dev, na_dev = _put(words_host, dev), _put(na_host, dev)
        self._uuid_chunk = PAGER.new_chunk(
            words_dev, na_dev, host=(words_host, na_host),
            label="uuid_words", device=dev)
        super().__init__(None, Codec("const"), None, nrows, T_UUID)

    def _home_chunk(self):
        return self._uuid_chunk

    @property
    def words(self) -> torch.Tensor:
        """(nrows, 4) int32 words on the card; faults the chunk."""
        return self._uuid_chunk.device()[0]

    @property
    def na(self) -> torch.Tensor:
        """(nrows,) int32 NA lane; faults with the words."""
        return self._uuid_chunk.device()[1]

    @staticmethod
    def encode(col: np.ndarray, device=None) -> "UuidVec":
        """Host UUID strings or uuid.UUID objects to words; a malformed
        token is NA."""
        import uuid as _uuidlib
        n = len(col)
        words = np.zeros((n, 4), np.int32)
        na = np.ones(n, np.int32)
        for i, s in enumerate(col):
            if s is None or (isinstance(s, float) and math.isnan(s)) \
                    or (isinstance(s, str) and not s.strip()):
                continue
            try:
                v = (s.int if isinstance(s, _uuidlib.UUID)
                     else _uuidlib.UUID(str(s).strip()).int)
            except (ValueError, AttributeError):
                continue
            for w in range(4):
                u = (v >> (32 * (3 - w))) & 0xFFFFFFFF
                words[i, w] = u - (1 << 32) if u >= (1 << 31) else u
            na[i] = 0
        return UuidVec(words, na, n, device=device)

    # ---- Vec surface -----------------------------------------------------
    @property
    def host_data(self):
        """uuid.UUID objects (None for NA), decoded from the cheapest
        resident copy without promoting a demoted chunk."""
        import uuid as _uuidlib
        words_np, na_np = self._uuid_chunk.staging_view()
        W = np.asarray(words_np)[: self.nrows]
        na = np.asarray(na_np)[: self.nrows]
        out = np.empty(self.nrows, object)
        for i in range(self.nrows):
            if na[i]:
                continue
            v = 0
            for w in range(4):
                v = (v << 32) | (int(W[i, w]) & 0xFFFFFFFF)
            out[i] = _uuidlib.UUID(int=v)
        return out

    @host_data.setter
    def host_data(self, v):
        if v is not None:
            raise AttributeError("UuidVec host_data is derived")

    def to_numpy(self) -> np.ndarray:
        return self.host_data

    def as_f32(self):
        raise TypeError("UUID Vec has no numeric view (C16Chunk atd "
                        "throws in the reference too)")

    def eq(self, other: "UuidVec") -> torch.Tensor:
        """(nrows,) f32 0/1 row equality, on the card."""
        same = (self.words == other.words).all(dim=1)
        ok = (self.na == 0) & (other.na == 0)
        return (ok & same).to(torch.float32)

    def isna_f32(self) -> torch.Tensor:
        return self.na.to(torch.float32)

    def na_cnt(self) -> int:
        na_np = self._uuid_chunk.staging_view()[1]
        return int(np.asarray(na_np)[: self.nrows].sum())

    def is_const(self) -> bool:
        """The "const" codec without NAs, as the JAX package tests it:
        a UUID column with no NA counts as constant."""
        return self.na_cnt() == 0

    def _compute_rollups(self) -> Rollups:
        return Rollups(min=math.nan, max=math.nan, mean=math.nan,
                       sigma=math.nan, nas=self.na_cnt(), zeros=0,
                       is_int=False)


# ---------------------------------------------------------------------------
class SparseVec(Vec):
    """A sparse numeric column (CXIChunk): the sorted rows (int32) and
    values (f32) of its nonzeros, each behind its own chunk; an NA is an
    explicit NaN value. `as_f32` densifies on demand; GLM's sparse path
    reads the planes through `Frame.sparse_coo` and never does."""

    def __init__(self, nz_rows, nz_vals, nrows: int, type: str = T_NUM,
                 device=None):
        rows_host = np.ascontiguousarray(np.asarray(nz_rows, np.int32))
        vals_host = np.ascontiguousarray(np.asarray(nz_vals, np.float32))
        dev = _device(device)
        if PAGER.ingest_cold:
            rows_dev = vals_dev = None
        else:
            rows_dev, vals_dev = _put(rows_host, dev), _put(vals_host, dev)
        self._nzr_chunk = PAGER.new_chunk(
            rows_dev, None, host=(rows_host, None), label="sparse_rows",
            device=dev)
        self._nzv_chunk = PAGER.new_chunk(
            vals_dev, None, host=(vals_host, None), label="sparse_vals",
            device=dev)
        super().__init__(None, Codec("const", const_val=0.0), None, nrows,
                         type)

    def _home_chunk(self):
        return self._nzr_chunk

    @property
    def nz_rows(self) -> torch.Tensor:
        """(nnz,) int32 rows on the card; faults the plane."""
        return self._nzr_chunk.device()[0]

    @property
    def nz_vals(self) -> torch.Tensor:
        """(nnz,) f32 values on the card; faults the plane."""
        return self._nzv_chunk.device()[0]

    @property
    def nnz(self) -> int:
        return self._nzr_chunk.rows      # metadata: never faults

    def as_f32(self) -> torch.Tensor:
        rows, vals = self.nz_rows, self.nz_vals
        out = torch.zeros(self.nrows, dtype=torch.float32,
                          device=vals.device)
        out[rows.long()] = vals
        return out

    def is_const(self) -> bool:
        """Constant only without any nonzero, as the JAX package tests
        it (the implicit zeros share the "const" codec)."""
        return self.nnz == 0

    def _compute_rollups(self) -> Rollups:
        # the JAX package's numpy reductions over the host value plane;
        # a demoted column is not promoted
        v = np.asarray(self._nzv_chunk.staging_view()[0])
        ok = v[~np.isnan(v)]
        n = self.nrows
        nas = int(np.isnan(v).sum())
        implicit_zeros = n - len(v)
        zeros = implicit_zeros + int((ok == 0).sum())
        cnt = max(n - nas, 1)
        mean = ok.sum() / cnt
        var = (ok * ok).sum() / cnt - mean * mean
        var *= cnt / max(cnt - 1, 1)
        if len(ok) == 0:
            mn = mx = 0.0
        elif implicit_zeros > 0:
            mn = float(min(ok.min(), 0.0))
            mx = float(max(ok.max(), 0.0))
        else:
            mn, mx = float(ok.min()), float(ok.max())
        return Rollups(
            min=mn, max=mx, mean=float(mean),
            sigma=float(math.sqrt(max(var, 0.0))), nas=nas,
            zeros=int(zeros),
            is_int=bool(len(ok) == 0 or np.all(ok == np.floor(ok))))


# ---------------------------------------------------------------------------
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
        self._pos: Optional[dict] = None
        self.key = key or DKV.make_key("frame")
        self._matrix_cache: dict = {}
        DKV.put(self.key, self)
        # the Cleaner's wake-up: account the frame, demote cold chunks
        # when a budget is exceeded
        MANAGER.touch(self.key)
        MANAGER.maybe_clean()

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

    @staticmethod
    def from_dict(cols: dict, key: Optional[str] = None,
                  column_types: Optional[dict] = None) -> "Frame":
        """One column a dict entry, typed as `Vec.from_numpy` types it
        unless `column_types` names a type."""
        types = column_types or {}
        return Frame([str(n) for n in cols],
                     [Vec.from_numpy(np.asarray(c), type=types.get(n))
                      for n, c in cols.items()], key)

    @staticmethod
    def from_pandas(df, key: Optional[str] = None) -> "Frame":
        return Frame.from_dict({c: df[c].to_numpy() for c in df.columns},
                               key)

    @property
    def nrows(self) -> int:
        return self.vecs[0].nrows if self.vecs else 0

    @property
    def ncols(self) -> int:
        return len(self.vecs)

    @property
    def shape(self):
        return (self.nrows, self.ncols)

    @property
    def types(self) -> dict:
        return {n: v.type for n, v in zip(self.names, self.vecs)}

    def vec(self, name) -> Vec:
        if isinstance(name, (int, np.integer)):
            return self.vecs[int(name)]
        return self.vecs[self.col_idx(name)]

    def col_idx(self, name: str) -> int:
        """The first column of that name, through a dict rebuilt when the
        names changed (a wide frame has tens of thousands of columns)."""
        pos = self._pos
        i = pos.get(name) if pos is not None else None
        if i is None or i >= len(self.names) or self.names[i] != name:
            self._pos = pos = {n: k for k, n in
                               reversed(list(enumerate(self.names)))}
            i = pos.get(name)
            if i is None:
                raise ValueError(f"{name!r} is not a column")
        return i

    # ---- column select and mutation -------------------------------------
    def __getitem__(self, sel) -> "Frame":
        """A name, a list of names or a list of positions: a new frame
        sharing the Vecs."""
        if isinstance(sel, str):
            return Frame([sel], [self.vec(sel)])
        if isinstance(sel, (list, tuple)):
            names = [s if isinstance(s, str) else self.names[s] for s in sel]
            return Frame(names, [self.vec(n) for n in names])
        raise KeyError(sel)

    def __setitem__(self, name: str, value):
        """Add or replace a column: a Vec, a one-column Frame, or values."""
        if isinstance(value, Frame):
            value = value.vecs[0]
        if not isinstance(value, Vec):
            value = Vec.from_numpy(np.asarray(value))
        if self.ncols and value.nrows != self.nrows:
            raise ValueError(f"column {name!r} has {value.nrows} rows, the "
                             f"frame {self.nrows}")
        if name in self.names:
            self.vecs[self.names.index(name)] = value
        else:
            self.names.append(name)
            self.vecs.append(value)
        self._matrix_cache.clear()

    def drop(self, names) -> "Frame":
        if isinstance(names, str):
            names = [names]
        return self[[n for n in self.names if n not in names]]

    # ---- the dense matrix (the DataInfo feed) ---------------------------
    def matrix(self, cols: Optional[Sequence[str]] = None) -> torch.Tensor:
        """(nrows, k) f32 device tensor, NaN for NA, cached per columns.
        The columns decode one at a time while the pager's worker
        promotes the next two; the cached matrix is the consumer's
        memory, outside the pager's budget."""
        cols = tuple(cols if cols is not None else self.names)
        hit = self._matrix_cache.get(cols)
        if hit is None:
            vs = [self.vec(c) for c in cols]
            hit = torch.empty((self.nrows, len(vs)), dtype=torch.float32,
                              device=self.vecs[0].device)

            pos = iter(range(len(vs)))

            def fill(v):
                # one column at a time: no plane outlives its copy, so a
                # demoted chunk's memory returns while the matrix fills
                hit[:, next(pos)] = v.as_f32()
            _mr.map_chunked(fill, vs, lookahead=2)
            self._matrix_cache[cols] = hit
        return hit

    def is_sparse(self, cols=None) -> bool:
        cols = cols if cols is not None else self.names
        return all(isinstance(self.vec(c), SparseVec) for c in cols)

    def sparse_coo(self, cols=None):
        """(rows, cols, vals, (n, C)) of the sparse columns on the card,
        column after column (each column's rows sorted): the hand-off to
        GLM's sparse path. NaN values are NAs; the consumer chooses its
        NA policy."""
        cols = list(cols if cols is not None else self.names)
        vs = [self.vec(c) for c in cols]
        for c, v in zip(cols, vs):
            if not isinstance(v, SparseVec):
                raise ValueError(f"{c} is not sparse")
        rows = torch.cat([v.nz_rows for v in vs])
        vals = torch.cat([v.nz_vals for v in vs])
        nnz = torch.tensor([v.nnz for v in vs], dtype=torch.int64)
        ci = torch.repeat_interleave(
            torch.arange(len(vs), dtype=torch.int32), nnz).to(rows.device)
        return rows, ci, vals, (self.nrows, len(cols))

    # ---- host round trip --------------------------------------------------
    def to_numpy(self, cols=None) -> np.ndarray:
        cols = cols if cols is not None else self.names
        return np.column_stack([self.vec(c).to_numpy() for c in cols])

    def as_data_frame(self):
        """A pandas DataFrame: level names for categorical columns, f32
        numbers for numeric ones (the JAX package's dtypes)."""
        import pandas as pd
        out = {}
        for n, v in zip(self.names, self.vecs):
            x = v.to_numpy()
            if v.type not in (T_STR, T_UUID):
                x = x.astype(np.float32)
            if v.type == T_CAT:
                x = np.array([None if np.isnan(c) else v.domain[int(c)]
                              for c in x], dtype=object)
            out[n] = x
        return pd.DataFrame(out)

    def head(self, n: int = 10):
        return self.as_data_frame().head(n)

    def summary(self) -> dict:
        """Each column's rollups (the REST /3/Frames summary), the next
        two columns promoted while one rolls up."""
        rolls = _mr.map_chunked(
            lambda v: None if v.type == T_STR else v.rollups(),
            self.vecs, lookahead=2)
        out = {}
        for n, v, r in zip(self.names, self.vecs, rolls):
            if r is None:
                out[n] = {"type": v.type}
                continue
            out[n] = {"type": v.type, "min": r.min, "max": r.max,
                      "mean": r.mean, "sigma": r.sigma, "missing": r.nas,
                      "zeros": r.zeros, "cardinality": v.cardinality}
        return out

    # ---- DKV hooks ---------------------------------------------------------
    def _tier_on_get(self):
        """DKV.get: LRU-touch every chunk; a frame spilled whole comes
        back to host memory (faults to the card stay lazy)."""
        PAGER.on_frame_get(frame_chunks(self))

    def _on_remove(self):
        # the Vecs may be shared with other frames: drop only our cache;
        # the chunks and their spill files go with the last reference
        self._matrix_cache.clear()

    def __repr__(self):
        return f"<Frame {self.key} {self.nrows}x{self.ncols} {self.names[:8]}>"


# ---------------------------------------------------------------------------
def rebalance_frame(frame: Frame, key: Optional[str] = None) -> Frame:
    """RebalanceDataSet: every Vec rebuilt, each dense one through the
    codec chooser again (defragmenting after slicing, or moving a frame
    to the present cloud's device). Sparse and UUID columns keep their
    layout (the JAX package densifies a sparse one)."""
    vecs = []
    for v in frame.vecs:
        if isinstance(v, StrVec):
            vecs.append(StrVec.encode(v.host_data))
        elif isinstance(v, UuidVec):
            vecs.append(UuidVec.encode(v.host_data))
        elif isinstance(v, SparseVec):
            vecs.append(SparseVec(v._nzr_chunk.staging_view()[0],
                                  v._nzv_chunk.staging_view()[0], v.nrows,
                                  v.type))
        else:
            col = v.to_numpy()
            mask = np.isnan(col)
            vecs.append(Vec._from_floats(np.where(mask, 0.0, col), mask,
                                         v.type, v.domain))
    return Frame(list(frame.names), vecs, key)

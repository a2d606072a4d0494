"""ctypes binding of the port's native CSV tokenizer (h2o3_tpu/io/fastcsv.py).

The tokenizer is `io/csrc/fastcsv.cpp`, the port's copy of the JAX
package's `native/fastcsv.cpp`, compiled at first use by
`ops/_build.load_host` with native/Makefile's command

    g++ -O3 -fPIC -std=c++17 -Wall -shared -o ops/build/libfastcsv-<hash>.so \
        io/csrc/fastcsv.cpp

into the git-ignored `ops/build/`; the committed `native/libfastcsv.so` is
never loaded. The copy reads a doubled quote inside a quoted field as one
quote (RFC 4180) and exports each column's string cells as a dictionary.

Two entry points feed the parse (io/parser.py, io/dparse.py):
`parse_columns` for byte ranges of local files (the native code reads
them itself, so pool threads overlap reading with tokenizing) and
`parse_bytes_columns` for bytes the caller staged (a decompressed
gzip/zip window, an HTTP range). Each returns, a column, the float64
values (NaN where a cell is NA or not a number) and a `StrCells` of the
cells that are not numbers. The ctypes calls release the GIL.

`TOKENIZED_BYTES` counts the bytes handed to each engine, "fastcsv" here
and "python" for the plain tokenizers of io/dparse.py and io/parser.py
(the JAX package's `h2o3_fastcsv_bytes_total` counter and the `engine`
attribute of its tokenize span).
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from h2o3_tpu_torch.obs import metrics as _om
from h2o3_tpu_torch.obs.timeline import span as _span
from h2o3_tpu_torch.ops import _build

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                      "fastcsv.cpp")

_LIB = None
_LIB_LOCK = threading.Lock()
_UNAVAILABLE: list = []          # the BuildError, once the build failed

# bytes handed to the native tokenizer (per byte-range call: the sum over
# ranges equals the file bytes), fed by count_bytes
FASTCSV_BYTES = _om.counter("h2o3_fastcsv_bytes_total",
                            "bytes tokenized by the native CSV parser")

TOKENIZED_BYTES = {"fastcsv": 0, "python": 0}
_COUNT_LOCK = threading.Lock()


def count_bytes(engine: str, nbytes: int):
    """Add `nbytes` handed to tokenizer `engine` ("fastcsv" or "python");
    the native engine's also feed `h2o3_fastcsv_bytes_total`."""
    with _COUNT_LOCK:
        TOKENIZED_BYTES[engine] += int(max(nbytes, 0))
    if engine == "fastcsv":
        FASTCSV_BYTES.inc(max(nbytes, 0))


def reset_counts():
    with _COUNT_LOCK:
        for k in TOKENIZED_BYTES:
            TOKENIZED_BYTES[k] = 0


class StrCells:
    """The cells of one tokenized column that are not numbers: their rows
    (int64, ascending), the distinct tokens as sorted str `levels`, and a
    code a cell into them. The JAX package keeps the same cells as a
    {row: str} dict; `to_dict` gives that form."""

    __slots__ = ("rows", "levels", "codes")

    def __init__(self, rows, levels, codes):
        self.rows = rows
        self.levels = levels
        self.codes = codes

    def __len__(self):
        return len(self.rows)

    def to_dict(self) -> dict:
        return {int(r): self.levels[c] for r, c in zip(self.rows, self.codes)}

    @staticmethod
    def empty() -> "StrCells":
        return StrCells(np.empty(0, np.int64), np.empty(0, object),
                        np.empty(0, np.int64))

    @staticmethod
    def from_dict(smap: dict) -> "StrCells":
        if not smap:
            return StrCells.empty()
        rows = np.fromiter(smap.keys(), np.int64, len(smap))
        levels, codes = np.unique(np.asarray(list(smap.values()), object),
                                  return_inverse=True)
        return StrCells(rows, levels, codes.reshape(-1).astype(np.int64))

    @staticmethod
    def from_tokens(rows, codes, tokens) -> "StrCells":
        """Cells coded into distinct tokens in any order (the native
        dictionary's first-seen order): sort the tokens, merge any that
        decode alike, and renumber the codes."""
        levels, remap = np.unique(np.asarray(tokens, object),
                                  return_inverse=True)
        remap = remap.reshape(-1).astype(np.int64)
        return StrCells(np.asarray(rows, np.int64), levels,
                        remap[np.asarray(codes, np.int64)])


def _lib():
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        if _UNAVAILABLE:
            raise _UNAVAILABLE[0]
        try:
            lib = _build.load_host("fastcsv", SOURCE)
        except _build.BuildError as e:
            _UNAVAILABLE.append(e)
            raise
        c_long, c_i64, c_vp = ctypes.c_long, ctypes.c_int64, ctypes.c_void_p
        lib.fastcsv_parse_range.restype = c_vp
        lib.fastcsv_parse_range.argtypes = [ctypes.c_char_p, ctypes.c_char,
                                            c_long, c_long, ctypes.c_int]
        lib.fastcsv_parse_bytes.restype = c_vp
        lib.fastcsv_parse_bytes.argtypes = [ctypes.c_char_p, c_long,
                                            ctypes.c_char, ctypes.c_int,
                                            ctypes.c_int]
        for name in ("fastcsv_nrows", "fastcsv_ncols"):
            getattr(lib, name).restype = c_i64
            getattr(lib, name).argtypes = [c_vp]
        lib.fastcsv_col_data.restype = ctypes.POINTER(ctypes.c_double)
        lib.fastcsv_col_data.argtypes = [c_vp, c_i64]
        for name, res in (("fastcsv_col_nstr", c_i64),
                          ("fastcsv_dict_nlevels", c_i64),
                          ("fastcsv_dict_bytes_len", c_i64),
                          ("fastcsv_dict_rows_ptr",
                           ctypes.POINTER(ctypes.c_int64)),
                          ("fastcsv_dict_codes_ptr",
                           ctypes.POINTER(ctypes.c_int32)),
                          ("fastcsv_dict_lens_ptr",
                           ctypes.POINTER(ctypes.c_int32)),
                          ("fastcsv_dict_bytes_ptr",
                           ctypes.POINTER(ctypes.c_char))):
            getattr(lib, name).restype = res
            getattr(lib, name).argtypes = [c_vp, c_i64]
        lib.fastcsv_free.argtypes = [c_vp]
        _LIB = lib
    return _LIB


def available() -> bool:
    """Whether the tokenizer builds and loads here (a host C++ compiler is
    present); the parse takes the plain Python tokenizer only where it
    does not."""
    try:
        _lib()
        return True
    except _build.BuildError:
        return False


def _view(ptr, n, dtype):
    return np.ctypeslib.as_array(ptr, shape=(n,)).astype(dtype, copy=True) \
        if n else np.empty(0, dtype)


def _extract_columns(lib, h) -> list:
    """[(float64 values, StrCells)] a column from a parse handle. The
    string cells come through the dictionary export: two planes of a
    cell (row, code) and the distinct tokens, so no Python string is made
    a cell."""
    nrows = lib.fastcsv_nrows(h)
    out = []
    for j in range(lib.fastcsv_ncols(h)):
        num = _view(lib.fastcsv_col_data(h, j), nrows, np.float64)
        nstr = lib.fastcsv_col_nstr(h, j)
        if not nstr:
            out.append((num, StrCells.empty()))
            continue
        rows = _view(lib.fastcsv_dict_rows_ptr(h, j), nstr, np.int64)
        codes = _view(lib.fastcsv_dict_codes_ptr(h, j), nstr, np.int64)
        nlev = lib.fastcsv_dict_nlevels(h, j)
        lens = _view(lib.fastcsv_dict_lens_ptr(h, j), nlev, np.int64)
        raw = ctypes.string_at(lib.fastcsv_dict_bytes_ptr(h, j),
                               lib.fastcsv_dict_bytes_len(h, j))
        offs = np.concatenate([[0], np.cumsum(lens)])
        tokens = [raw[offs[i]:offs[i + 1]].decode("utf-8", "replace")
                  for i in range(nlev)]
        out.append((num, StrCells.from_tokens(rows, codes, tokens)))
    return out


def parse_columns(path: str, sep: str, header: bool,
                  start: int = 0, end: int = -1) -> list:
    """The byte range [start, end) of a local file, with the chunk
    contract: a range at start > 0 begins after its first newline and
    runs through the line straddling `end`, so each line is tokenized
    once across adjacent ranges."""
    lib = _lib()
    size = os.path.getsize(path)
    span = (size if end < 0 else min(end, size)) - start
    with _span("parse.tokenize", engine="fastcsv", start=start, end=end):
        h = lib.fastcsv_parse_range(os.fsencode(path), sep.encode(), start,
                                    end, 1 if header else 0)
    if not h:
        raise IOError(f"fastcsv failed on {path}")
    count_bytes("fastcsv", span)
    try:
        return _extract_columns(lib, h)
    finally:
        lib.fastcsv_free(h)


def parse_bytes_columns(buf: bytes, sep: str, header: bool,
                        skip_partial_first: bool = False) -> list:
    """Bytes the caller staged, with the same contract: with
    `skip_partial_first` the head up to the first newline belongs to the
    previous chunk; otherwise `buf` holds whole lines."""
    lib = _lib()
    with _span("parse.tokenize", engine="fastcsv_bytes", nbytes=len(buf)):
        h = lib.fastcsv_parse_bytes(buf, len(buf), sep.encode(),
                                    1 if header else 0,
                                    1 if skip_partial_first else 0)
    if not h:
        raise IOError("fastcsv failed on a byte buffer")
    count_bytes("fastcsv", len(buf))
    try:
        return _extract_columns(lib, h)
    finally:
        lib.fastcsv_free(h)

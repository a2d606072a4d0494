"""Ingest of the port (h2o3_tpu/io/parser.py, water/parser): phase-1 setup
guess, phase-2 tokenize and type, then columns onto the cloud's device.

The separator, header and column-type guesses and the categorical level
order (sorted distinct tokens) are those of the JAX package, kept as a
copy here. `import_file` routes as the JAX package does:
  * a path list, a directory or a glob, a compressed CSV and a remote CSV
    whose server takes byte ranges go to the chunked parse (io/dparse.py);
    another remote file is staged locally first (io/uri.py);
  * Parquet, ORC, Feather, Avro and xlsx files go to io/columnar.py (by
    extension, then by magic bytes);
  * one plain local CSV is tokenized whole by the native tokenizer
    (io/fastcsv.py), its columns rebuilt by the chunked parse's merge;
    the plain Python tokenizer takes it only where the native library is
    unavailable (no host compiler). A native error raises: the JAX
    package's `except Exception: return None` re-parsed it in Python;
  * ARFF (ARFFParser) and SVMLight (SVMLightParser, every feature column
    a SparseVec, never densified) files, plain, gzip or zip.
`fastcsv.TOKENIZED_BYTES` counts the bytes each engine tokenized, and
`h2o3_fastcsv_bytes_total` the native engine's. A string column becomes
a StrVec and a uuid column a UuidVec. The JAX package's series
`h2o3_parse_bytes_total` and `h2o3_parse_rows_total` count each parsed
file, and its spans `parse.setup`, `parse.file`, `parse.tokenize` and
`parse.pack` mark the stages (the native path's columns are packed by
the chunked parse's merge, which adds `parse.merge`, as the JAX
package's chunked parse does).
"""

from __future__ import annotations

import csv
import gzip
import io
import math
import os
import re
import warnings
import zipfile
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from h2o3_tpu_torch.core.frame import (Frame, SparseVec, T_CAT, T_NUM,
                                       T_STR, T_TIME, T_UUID, UuidVec, Vec)
from h2o3_tpu_torch.obs import metrics as _om
from h2o3_tpu_torch.obs.timeline import span as _span

# source bytes ingested, labeled by parse type (CSV/ARFF/SVMLight); the
# python-vs-native engine split is in h2o3_fastcsv_bytes_total and the
# parse.tokenize span's engine attr
PARSE_BYTES = _om.counter("h2o3_parse_bytes_total",
                          "source bytes ingested by the 2-phase parser")
PARSE_ROWS = _om.counter("h2o3_parse_rows_total",
                         "rows materialized into Frames by the parser")


def pack_span(**attrs):
    """The `parse.pack` stage span, shared by the single-file path here
    and the chunked merge (io/dparse)."""
    return _span("parse.pack", **attrs)

NA_TOKENS = {"", "NA", "N/A", "na", "NaN", "nan", "null", "NULL", "None", "?"}
_SEPARATORS = [",", "\t", ";", "|", " "]
_UUID_RE = re.compile(r"[0-9a-fA-F]{8}-[0-9a-fA-F]{4}-[0-9a-fA-F]{4}-"
                      r"[0-9a-fA-F]{4}-[0-9a-fA-F]{12}$")


@dataclass
class ParseSetup:
    """Result of phase-1 guessing (water/parser/ParseSetup.java)."""
    separator: str = ","
    header: bool = True
    column_names: list = field(default_factory=list)
    column_types: list = field(default_factory=list)
    parse_type: str = "CSV"  # CSV | ARFF | SVMLight


def _open_text(path: str) -> io.TextIOBase:
    """Transparent gzip and zip (the zip's first member), ZipUtil."""
    if path.endswith(".gz"):
        return io.TextIOWrapper(gzip.open(path, "rb"), encoding="utf-8",
                                newline="")
    if path.endswith(".zip"):
        zf = zipfile.ZipFile(path)
        return io.TextIOWrapper(zf.open(zf.namelist()[0]), encoding="utf-8",
                                newline="")
    return open(path, "r", encoding="utf-8", newline="")


def _num_token(v: float) -> str:
    """The source token of a number in a categorical or string column: an
    integral value without a trailing '.0', anything else (and -0) by its
    shortest round-trip repr, so distinct values never share a token."""
    v = float(v)
    if math.isfinite(v) and v == int(v) and abs(v) < 2 ** 53 \
            and not (v == 0.0 and math.copysign(1.0, v) < 0):
        return str(int(v))
    return repr(v)


def _is_num(tok: str) -> bool:
    try:
        float(tok)
        return True
    except ValueError:
        return False


def _looks_uuid(tok: str) -> bool:
    return bool(_UUID_RE.match(tok.strip()))


def _looks_time(tok: str) -> bool:
    if len(tok) < 8 or not tok[:4].isdigit():
        return False
    return ("-" in tok or "/" in tok) and any(c.isdigit() for c in tok)


def _split(line: str, sep: str) -> list:
    """Quote-aware split (embedded separators inside quotes)."""
    if '"' not in line:
        return line.split(sep)
    out, cur, q = [], [], False
    for ch in line:
        if ch == '"':
            q = not q
        elif ch == sep and not q:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    out.append("".join(cur))
    return out


def _guess_types(rows: Sequence[Sequence[str]], ncol: int) -> list:
    types = []
    for j in range(ncol):
        vals = [t for t in (r[j].strip() for r in rows if j < len(r))
                if t not in NA_TOKENS]
        if not vals or all(_is_num(t) for t in vals):
            types.append(T_NUM)
        elif all(_looks_time(t) for t in vals[:20]):
            types.append(T_TIME)
        elif all(_looks_uuid(t) for t in vals[:20]):
            types.append(T_UUID)
        else:
            types.append(T_CAT)
    return types


def parse_setup(path: str, sample_lines: int = 200) -> ParseSetup:
    """Phase 1: sniff the format, separator, header and column types from
    a sample."""
    with _span("parse.setup", file=os.path.basename(path)), \
            _open_text(path) as f:
        sample = [line.rstrip("\r\n") for _, line in zip(range(sample_lines), f)]
    sample = [ln for ln in sample if ln]
    if not sample:
        raise ValueError(f"empty file: {path}")
    if sample[0].lstrip().startswith("@relation") \
            or path.lower().endswith(".arff"):
        return _arff_setup(path)
    if path.lower().endswith((".svm", ".svmlight")):
        return ParseSetup(parse_type="SVMLight")
    best_sep, best_cols = ",", 1
    for sep in _SEPARATORS:
        counts = {len(_split(ln, sep)) for ln in sample[:50]}
        if len(counts) == 1:
            (c,) = counts
            if c > best_cols:
                best_sep, best_cols = sep, c
    rows = [_split(ln, best_sep) for ln in sample]
    ncol = max(len(r) for r in rows)
    first_nonnum = all(not _is_num(t) for t in rows[0] if t not in NA_TOKENS)
    later_num = any(_is_num(t) for r in rows[1:] for t in r)
    header = first_nonnum and later_num and len(rows) > 1
    names = ([t.strip('"') for t in rows[0]] if header
             else [f"C{i+1}" for i in range(ncol)])
    types = _guess_types(rows[1:] if header else rows, ncol)
    return ParseSetup(separator=best_sep, header=header, column_names=names,
                      column_types=types)


def _tokenize_csv(path: str, setup: ParseSetup) -> list:
    """Per-column lists of token strings."""
    cols: list[list] = []
    with _open_text(path) as f:
        it = iter(csv.reader(f, delimiter=setup.separator))
        if setup.header:
            next(it, None)
        for row in it:
            if not row:
                continue
            if len(cols) < len(row):
                depth = len(cols[0]) if cols else 0
                cols.extend([""] * depth for _ in range(len(row) - len(cols)))
            for j in range(len(cols)):
                cols[j].append(row[j].strip() if j < len(row) else "")
    return cols


def _parse_time_ms(tok: str) -> float:
    from datetime import datetime
    for fmt in ("%Y-%m-%d %H:%M:%S", "%Y-%m-%d", "%Y/%m/%d", "%m/%d/%Y",
                "%Y-%m-%dT%H:%M:%S"):
        try:
            return datetime.strptime(tok, fmt).timestamp() * 1000.0
        except ValueError:
            continue
    raise ValueError(tok)


def _column_to_vec(tokens: list, vtype: str) -> Vec:
    n = len(tokens)
    if vtype in (T_NUM, T_TIME):
        out = np.empty(n, np.float64)
        for i, t in enumerate(tokens):
            if t in NA_TOKENS:
                out[i] = np.nan
                continue
            try:
                out[i] = float(t) if vtype == T_NUM else _parse_time_ms(t)
            except ValueError:
                out[i] = np.nan
        return Vec.from_numpy(out, type=vtype)
    if vtype == T_UUID:
        return UuidVec.encode(np.array(
            [None if t in NA_TOKENS or not _looks_uuid(t) else t
             for t in tokens], object))
    arr = np.array([None if t in NA_TOKENS else t for t in tokens], object)
    if vtype == T_STR:
        return Vec.from_numpy(arr, type=T_STR)
    # categorical; promoted to string when nearly unique (CsvParser rule)
    uniq = {t for t in tokens if t not in NA_TOKENS}
    if n > 100 and len(uniq) > 0.95 * n:
        return Vec.from_numpy(arr, type=T_STR)
    return Vec.from_numpy(arr)


# ---------------------------------------------------------------------------
# ARFF (water/parser/ARFFParser.java)
def _arff_setup(path: str) -> ParseSetup:
    names, types = [], []
    with _open_text(path) as f:
        for line in f:
            ln = line.strip()
            if ln.lower().startswith("@attribute"):
                parts = ln.split(None, 2)
                names.append(parts[1].strip("'\""))
                t = parts[2].strip()
                if t.startswith("{"):
                    types.append(T_CAT)
                elif t.lower() in ("numeric", "real", "integer"):
                    types.append(T_NUM)
                elif t.lower() == "date":
                    types.append(T_TIME)
                else:
                    types.append(T_STR)
            elif ln.lower().startswith("@data"):
                break
    return ParseSetup(separator=",", header=False, column_names=names,
                      column_types=types, parse_type="ARFF")


def _parse_arff(path: str, setup: ParseSetup, dest) -> Frame:
    rows = []
    with _open_text(path) as f:
        in_data = False
        for line in f:
            ln = line.strip()
            if not in_data:
                in_data = ln.lower().startswith("@data")
                continue
            if ln and not ln.startswith("%"):
                rows.append(_split(ln, ","))
    ncol = len(setup.column_names)
    cols = [[r[j].strip() if j < len(r) else "" for r in rows]
            for j in range(ncol)]
    vecs = [_column_to_vec(cols[j], setup.column_types[j])
            for j in range(ncol)]
    return Frame(setup.column_names, vecs, dest)


# ---------------------------------------------------------------------------
# SVMLight (water/parser/SVMLightParser.java)
def _parse_svmlight(path: str, dest) -> Frame:
    """A `target` column, then one SparseVec a feature index from 0 to the
    largest, holding only its (row, value) pairs: a wide sparse file stays
    the size of its nonzeros on the card. The JAX package's parse, with
    the numbers converted in one pass (`np.fromstring`, correctly
    rounded as `float()` is) instead of one `float()` a token."""
    targets, pairs, counts = [], [], []
    with _open_text(path) as f:
        for line in f:
            if "#" in line:
                line = line.split("#")[0]
            parts = line.split()
            if not parts:
                continue
            targets.append(parts[0])
            pairs.extend(parts[1:])
            counts.append(len(parts) - 1)
    n = len(targets)
    kv = _numbers(" ".join(pairs).replace(":", " "), 2 * len(pairs))
    ci = kv[0::2]
    if np.any(ci != np.floor(ci)) or np.any(ci < 0):
        raise ValueError(f"{path}: feature indices must be integers >= 0")
    ci = ci.astype(np.int64)
    vv = kv[1::2].astype(np.float32)
    ri = np.repeat(np.arange(n, dtype=np.int64), counts)
    max_idx = int(ci.max()) if len(ci) else 0
    order = np.lexsort((ri, ci))          # by column, rows sorted
    ri, ci, vv = ri[order], ci[order], vv[order]
    starts = np.searchsorted(ci, np.arange(max_idx + 2))
    names = ["target"] + [f"C{j+1}" for j in range(max_idx + 1)]
    vecs = [Vec.from_numpy(_numbers(" ".join(targets), n))]
    for j in range(max_idx + 1):
        s, e = starts[j], starts[j + 1]
        vecs.append(SparseVec(ri[s:e].astype(np.int32), vv[s:e], n))
    return Frame(names, vecs, dest)


def _numbers(text: str, count: int) -> np.ndarray:
    """`count` float64 numbers from whitespace-separated text; raises
    ValueError on a token that is no number."""
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        try:
            out = np.fromstring(text, dtype=np.float64, sep=" ") \
                if count else np.zeros(0)
        except (ValueError, DeprecationWarning) as e:
            raise ValueError(f"malformed SVMLight token: {e}") from None
    if len(out) != count:
        raise ValueError(f"malformed SVMLight line: {count} numbers "
                         f"expected, {len(out)} read")
    return out


def parse(path: str, setup: Optional[ParseSetup] = None,
          destination_frame: Optional[str] = None,
          col_types: Optional[dict] = None) -> Frame:
    """Phase 2: tokenize, type and load the columns of one file."""
    setup = setup or parse_setup(path)
    with _span("parse.file", file=os.path.basename(path),
               parse_type=setup.parse_type):
        f = _parse_dispatch(path, setup, destination_frame, col_types)
    try:
        PARSE_BYTES.inc(os.path.getsize(path), type=setup.parse_type)
    except OSError:
        pass
    PARSE_ROWS.inc(f.nrows)
    return f


def _parse_dispatch(path, setup, destination_frame, col_types) -> Frame:
    if setup.parse_type == "ARFF":
        return _parse_arff(path, setup, destination_frame)
    if setup.parse_type == "SVMLight":
        return _parse_svmlight(path, destination_frame)
    from h2o3_tpu_torch.io import fastcsv
    if not path.endswith((".gz", ".zip")) and fastcsv.available():
        return _native_parse(path, setup, destination_frame, col_types)
    fastcsv.count_bytes("python", os.path.getsize(path))
    with _span("parse.tokenize", engine="python_csv"):
        cols = _tokenize_csv(path, setup)
    names = list(setup.column_names)
    types = list(setup.column_types)
    while len(names) < len(cols):
        names.append(f"C{len(names)+1}")
        types.append(T_CAT)
    for k, v in (col_types or {}).items():
        if k in names:
            types[names.index(k)] = v
    with pack_span(cols=len(cols)):
        vecs = [_column_to_vec(cols[j], types[j]) for j in range(len(cols))]
        return Frame(names[: len(vecs)], vecs, destination_frame)


def _native_parse(path: str, setup: ParseSetup, dest, col_types) -> Frame:
    """The whole file through the native tokenizer as one chunk: numeric
    columns from its doubles; categorical, string, time and uuid columns
    rebuilt from its string cells by the chunked parse's merge (the
    JAX package's `_native_parse` builds the same columns)."""
    from h2o3_tpu_torch.io import dparse, fastcsv
    cols = fastcsv.parse_columns(path, setup.separator, setup.header)
    return dparse._merge_chunks([cols], setup, dest, col_types)


_COLUMNAR = (".parquet", ".orc", ".feather", ".avro", ".xlsx")


def import_file(path, destination_frame: Optional[str] = None,
                col_types: Optional[dict] = None,
                header: Optional[bool] = None,
                sep: Optional[str] = None) -> Frame:
    """h2o.import_file: a setup guess, then the parse, routed as the JAX
    package routes it (the module's docstring)."""
    from h2o3_tpu_torch.io import uri as _uri
    path = _uri.local_path(path) if isinstance(path, str) else path
    if isinstance(path, (list, tuple)) or (
            isinstance(path, str) and not _uri.is_remote(path)
            and (os.path.isdir(path) or any(c in path for c in "*?["))):
        from h2o3_tpu_torch.io import dparse
        setup = None
        if header is not None or sep is not None:
            setup = parse_setup(dparse.expand_paths(path)[0])
            if header is not None:
                setup.header = header
            if sep is not None:
                setup.separator = sep
        return dparse.parse_files(path, setup, destination_frame,
                                  col_types)
    staged = None
    if _uri.is_remote(path):
        # a remote CSV whose server takes ranges joins the chunked plan;
        # a columnar file, or a server without ranges, is staged whole
        if header is None and sep is None and _uri.supports_ranges(path) \
                and not path.endswith(_COLUMNAR):
            from h2o3_tpu_torch.io import dparse
            try:
                return dparse.parse_files([path], None, destination_frame,
                                          col_types)
            except (OSError, NotImplementedError):
                # only a failed transfer stages the file; a parse error
                # raises
                pass
        path = staged = _uri.fetch_to_local(path)
    try:
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        from h2o3_tpu_torch.io import columnar
        colparser = columnar.sniff(path)
        if colparser is not None:
            return colparser(path, destination_frame)
        setup = parse_setup(path)
        if header is not None:
            setup.header = header
        if sep is not None:
            setup.separator = sep
        if path.endswith((".gz", ".zip")) and setup.parse_type == "CSV":
            from h2o3_tpu_torch.io import dparse
            return dparse.parse_files([path], setup, destination_frame,
                                      col_types)
        return parse(path, setup, destination_frame, col_types)
    finally:
        if staged is not None:
            try:
                os.unlink(staged)
            except OSError:
                pass


def upload_frame(data, destination_frame: Optional[str] = None) -> Frame:
    """h2o.H2OFrame(python_obj): a Frame, a dict of columns, a numpy
    matrix or a pandas DataFrame into a Frame."""
    if isinstance(data, Frame):
        return data
    if isinstance(data, dict):
        return Frame.from_dict(data, destination_frame)
    if isinstance(data, np.ndarray):
        return Frame.from_numpy(data, key=destination_frame)
    try:
        import pandas as pd
    except ImportError:
        pd = None
    if pd is not None and isinstance(data, pd.DataFrame):
        return Frame.from_pandas(data, destination_frame)
    raise TypeError(f"cannot ingest {type(data)}")

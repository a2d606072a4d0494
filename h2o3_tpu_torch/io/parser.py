"""CSV ingest of the port (h2o3_tpu/io/parser.py): phase-1 setup guess,
phase-2 tokenize and type, then columns onto the cloud's device.

The separator, header and column-type guesses and the categorical level
order (sorted distinct tokens) are those of the JAX package, kept as a copy
here. Single local files only: ARFF, SVMLight, compressed, columnar,
remote and multi-file (dparse) ingest wait for later slices, as does the
native tokenizer.
"""

from __future__ import annotations

import csv
import os
import re
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from h2o3_tpu_torch.core.frame import (Frame, T_CAT, T_NUM, T_STR, T_TIME,
                                       T_UUID, Vec)

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
    """Phase 1: sniff separator, header and column types from a sample."""
    with open(path, "r", encoding="utf-8", newline="") as f:
        sample = [line.rstrip("\r\n") for _, line in zip(range(sample_lines), f)]
    sample = [ln for ln in sample if ln]
    if not sample:
        raise ValueError(f"empty file: {path}")
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
    with open(path, "r", encoding="utf-8", newline="") as f:
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
    arr = np.array([None if t in NA_TOKENS else t for t in tokens], object)
    if vtype in (T_STR, T_UUID):
        return Vec.from_numpy(arr, type=vtype)
    # categorical; promoted to string when nearly unique (CsvParser rule)
    uniq = {t for t in tokens if t not in NA_TOKENS}
    if n > 100 and len(uniq) > 0.95 * n:
        return Vec.from_numpy(arr, type=T_STR)
    return Vec.from_numpy(arr)


def parse(path: str, setup: Optional[ParseSetup] = None,
          destination_frame: Optional[str] = None,
          col_types: Optional[dict] = None) -> Frame:
    """Phase 2: tokenize, type and load the columns."""
    setup = setup or parse_setup(path)
    cols = _tokenize_csv(path, setup)
    names = list(setup.column_names)
    types = list(setup.column_types)
    while len(names) < len(cols):
        names.append(f"C{len(names)+1}")
        types.append(T_CAT)
    for k, v in (col_types or {}).items():
        if k in names:
            types[names.index(k)] = v
    vecs = [_column_to_vec(cols[j], types[j]) for j in range(len(cols))]
    return Frame(names[: len(vecs)], vecs, destination_frame)


def import_file(path: str, destination_frame: Optional[str] = None,
                col_types: Optional[dict] = None,
                header: Optional[bool] = None,
                sep: Optional[str] = None) -> Frame:
    """h2o.import_file analog for one local CSV file."""
    if not isinstance(path, str) or not os.path.isfile(path):
        raise FileNotFoundError(path)
    if path.endswith((".gz", ".zip", ".parquet", ".orc", ".feather", ".avro",
                      ".arff", ".svm", ".svmlight")):
        raise NotImplementedError(
            f"{os.path.basename(path)}: only plain CSV is ported so far")
    setup = parse_setup(path)
    if header is not None:
        setup.header = header
    if sep is not None:
        setup.separator = sep
    return parse(path, setup, destination_frame, col_types)

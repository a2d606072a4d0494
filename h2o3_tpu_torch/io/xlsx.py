"""XLSX ingest of the port (h2o3_tpu/io/xlsx.py; the reference's
XlsParser): an .xlsx file is a zip of XML parts, read with the standard
library alone.

The first worksheet, shared and inline strings, numeric and boolean
cells, blank cells as NA, and the first row as the header when it is all
strings and a later row has a number (the CSV setup's rule). A legacy
binary .xls (BIFF) raises NotImplementedError, as in the JAX package.
"""

from __future__ import annotations

import re
import zipfile
import xml.etree.ElementTree as ET
from typing import Optional

import numpy as np

_NS = "{http://schemas.openxmlformats.org/spreadsheetml/2006/main}"
_CELL_REF = re.compile(r"([A-Z]+)(\d+)")


def _col_index(ref: str) -> int:
    """'A'→0, 'Z'→25, 'AA'→26 …"""
    n = 0
    for ch in ref:
        n = n * 26 + (ord(ch) - 64)
    return n - 1


def _shared_strings(zf: zipfile.ZipFile) -> list:
    try:
        data = zf.read("xl/sharedStrings.xml")
    except KeyError:
        return []
    out = []
    for si in ET.fromstring(data).iter(f"{_NS}si"):
        out.append("".join(t.text or "" for t in si.iter(f"{_NS}t")))
    return out


def _first_sheet_name(zf: zipfile.ZipFile) -> str:
    names = [n for n in zf.namelist()
             if re.fullmatch(r"xl/worksheets/sheet\d+\.xml", n)]
    if not names:
        raise ValueError("xlsx contains no worksheets")
    return sorted(names, key=lambda n: int(re.findall(r"\d+", n)[0]))[0]


def read_xlsx_rows(path: str) -> list:
    """[[cell, …], …] with None for blanks; strings stay str, numbers
    float."""
    with zipfile.ZipFile(path) as zf:
        strings = _shared_strings(zf)
        sheet = ET.fromstring(zf.read(_first_sheet_name(zf)))
    rows = []
    for row in sheet.iter(f"{_NS}row"):
        cells: dict = {}
        for c in row.iter(f"{_NS}c"):
            ref = c.get("r", "")
            m = _CELL_REF.fullmatch(ref)
            ci = _col_index(m.group(1)) if m else len(cells)
            ctype = c.get("t", "n")
            v = c.find(f"{_NS}v")
            ist = c.find(f"{_NS}is")
            if ctype == "s" and v is not None:
                cells[ci] = strings[int(v.text)]
            elif ctype == "inlineStr" and ist is not None:
                cells[ci] = "".join(t.text or ""
                                    for t in ist.iter(f"{_NS}t"))
            elif ctype == "str" and v is not None:   # formula cached string
                cells[ci] = v.text
            elif ctype == "b" and v is not None:     # boolean
                cells[ci] = float(int(v.text))
            elif v is not None and v.text not in (None, ""):
                cells[ci] = float(v.text)
        if cells:
            width = max(cells) + 1
            rows.append([cells.get(j) for j in range(width)])
    return rows


def parse_xlsx(path: str, destination_frame: Optional[str] = None):
    """XLSX → Frame with the CSV path's typing rules (numeric / enum /
    NA), header detected when the first row is all-strings and a later
    row has a number."""
    from h2o3_tpu_torch.core.frame import Frame, Vec
    rows = read_xlsx_rows(path)
    if not rows:
        raise ValueError(f"empty xlsx: {path}")
    ncol = max(len(r) for r in rows)
    rows = [r + [None] * (ncol - len(r)) for r in rows]
    first_all_str = all(isinstance(c, str) or c is None for c in rows[0])
    later_num = any(isinstance(c, float) for r in rows[1:] for c in r)
    header = first_all_str and later_num and len(rows) > 1
    names = ([str(c) if c is not None else f"C{j + 1}"
              for j, c in enumerate(rows[0])] if header
             else [f"C{j + 1}" for j in range(ncol)])
    body = rows[1:] if header else rows
    vecs = []
    for j in range(ncol):
        col = [r[j] for r in body]
        if any(isinstance(c, str) for c in col):
            vecs.append(Vec.from_numpy(np.asarray(
                [None if c is None else str(c) for c in col], object)))
        else:
            vecs.append(Vec.from_numpy(np.asarray(
                [np.nan if c is None else float(c) for c in col],
                np.float64)))
    return Frame(names, vecs, destination_frame)


def reject_legacy_xls(path: str, destination_frame=None):
    raise NotImplementedError(
        f"{path}: legacy binary .xls (BIFF) needs the reference's POI "
        "stack, which has no standard-library equivalent; save the "
        "workbook as .xlsx or export it to CSV")

"""Columnar ingest of the port (h2o3_tpu/io/columnar.py; the reference's
Parquet, ORC and Avro parser plugins): Parquet, ORC and Feather through
pyarrow, Avro through fastavro.

`available_formats` gates each as the JAX package does; without pyarrow
(or fastavro for Avro) a reader raises RuntimeError, as there. Arrow
dictionary and string columns become categorical, numbers and booleans
float64 with NA, timestamps and dates epoch milliseconds. `sniff` picks a
reader by extension, then by magic bytes; xlsx goes to io/xlsx.py.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from h2o3_tpu_torch.core.frame import Frame


def available_formats():
    out = {"parquet": False, "orc": False, "feather": False, "avro": False}
    try:
        import pyarrow  # noqa: F401
        out["parquet"] = True
        out["feather"] = True
        try:
            from pyarrow import orc  # noqa: F401
            out["orc"] = True
        except ImportError:
            pass
    except ImportError:
        pass
    try:
        import fastavro  # noqa: F401
        out["avro"] = True
    except ImportError:
        pass
    return out


def _table_to_frame(table, key: Optional[str]) -> Frame:
    """Arrow table → Frame columns. Dictionary/string → categorical,
    numeric → float64 + NA mask, bool → 0/1, timestamps → epoch ms."""
    import pyarrow as pa
    cols = {}
    for name in table.column_names:
        arr = table.column(name)
        t = arr.type
        if pa.types.is_dictionary(t):
            arr = arr.cast(pa.string())
            t = arr.type
        if pa.types.is_timestamp(t) or pa.types.is_date(t):
            ms = arr.cast(pa.timestamp("ms")).cast(pa.int64())
            np_col = ms.to_numpy(zero_copy_only=False).astype(np.float64)
            null = np.asarray(arr.is_null())
            np_col[null] = np.nan
            cols[name] = np_col
        elif pa.types.is_boolean(t) or pa.types.is_integer(t) or \
                pa.types.is_floating(t) or pa.types.is_decimal(t):
            np_col = arr.cast(pa.float64()).to_numpy(zero_copy_only=False)
            cols[name] = np.asarray(np_col, np.float64)
        else:  # strings and everything else → object (→ categorical Vec)
            py = arr.to_pylist()
            cols[name] = np.array([None if v is None else str(v) for v in py],
                                  object)
    return Frame.from_dict(cols, key)


def parse_parquet(path: str, key: Optional[str] = None) -> Frame:
    try:
        import pyarrow.parquet as pq
    except ImportError as e:
        raise RuntimeError("parquet ingest requires pyarrow") from e
    return _table_to_frame(pq.read_table(path), key)


def parse_orc(path: str, key: Optional[str] = None) -> Frame:
    try:
        from pyarrow import orc
    except ImportError as e:
        raise RuntimeError("ORC ingest requires pyarrow.orc") from e
    return _table_to_frame(orc.ORCFile(path).read(), key)


def parse_feather(path: str, key: Optional[str] = None) -> Frame:
    try:
        import pyarrow.feather as feather
    except ImportError as e:
        raise RuntimeError("feather ingest requires pyarrow") from e
    return _table_to_frame(feather.read_table(path), key)


def parse_avro(path: str, key: Optional[str] = None) -> Frame:
    try:
        import fastavro
    except ImportError as e:
        raise RuntimeError(
            "Avro ingest requires fastavro; convert to parquet or csv, or "
            "install fastavro") from e
    with open(path, "rb") as fh:
        records = list(fastavro.reader(fh))
    cols: dict = {}
    for r in records:
        for k, v in r.items():
            cols.setdefault(k, []).append(v)
    np_cols = {}
    for k, vs in cols.items():
        if all(v is None or isinstance(v, (int, float, bool)) for v in vs):
            np_cols[k] = np.array([np.nan if v is None else float(v)
                                   for v in vs], np.float64)
        else:
            np_cols[k] = np.array([None if v is None else str(v)
                                   for v in vs], object)
    return Frame.from_dict(np_cols, key)


def _parse_xlsx(path, destination_frame=None):
    from h2o3_tpu_torch.io.xlsx import parse_xlsx
    return parse_xlsx(path, destination_frame)


def _reject_xls(path, destination_frame=None):
    from h2o3_tpu_torch.io.xlsx import reject_legacy_xls
    return reject_legacy_xls(path, destination_frame)


_EXT = {".parquet": parse_parquet, ".pqt": parse_parquet,
        ".orc": parse_orc, ".feather": parse_feather, ".avro": parse_avro,
        ".xlsx": _parse_xlsx, ".xls": _reject_xls}

_MAGIC = [(b"PAR1", parse_parquet), (b"ORC", parse_orc),
          (b"Obj\x01", parse_avro), (b"ARROW1", parse_feather)]


def sniff(path: str):
    """Return the columnar parser for this file, or None (→ text parsers).
    Extension first, then magic bytes (ParserService provider ranking)."""
    import os
    ext = os.path.splitext(path)[1].lower()
    if ext in _EXT:
        return _EXT[ext]
    try:
        with open(path, "rb") as fh:
            head = fh.read(8)
        for magic, fn in _MAGIC:
            if head.startswith(magic):
                return fn
    except OSError:
        pass
    return None

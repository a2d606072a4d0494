"""The port's ingest against the JAX package, on the CPU: the native CSV
tokenizer (io/fastcsv.py over io/csrc/fastcsv.cpp, built with g++ at
first use), its plain Python twin, the chunked multi-file parse
(io/dparse.py), URIs (io/uri.py), xlsx and the columnar readers.

Inputs are seeded numpy-made files handed to both packages. Tolerances:
- tokenizers: every column's doubles bit for bit (NaN where NA or not a
  number) and the same string cells, row for row;
- parsed frames: names, types and domains (in order) equal, every value
  bit for bit (the decoded f32 planes; string and UUID columns by
  value), the port's codecs those the JAX package chose;
- the one deliberate difference: a doubled quote inside a quoted field
  is one quote in the port's native engine (RFC 4180, as the csv module
  and the port's Python twin read it); the JAX native engine keeps both.
"""

import functools
import gzip
import http.server
import math
import os
import shutil
import threading
import uuid
import zipfile

import numpy as np
import pytest

import h2o3_tpu
import h2o3_tpu_torch
from h2o3_tpu.core.kvstore import DKV as JDKV
from h2o3_tpu.io import dparse as JD
from h2o3_tpu.io import fastcsv as JFC
from h2o3_tpu.io import parser as JP
from h2o3_tpu_torch.core.kvstore import DKV
from h2o3_tpu_torch.io import dparse as TD
from h2o3_tpu_torch.io import fastcsv as TFC
from h2o3_tpu_torch.io import parser as TP
from h2o3_tpu_torch.io import uri as TURI


@pytest.fixture(scope="module", autouse=True)
def cpu_cloud():
    h2o3_tpu.init()
    h2o3_tpu_torch.init(device="cpu")
    assert TFC.available() and JFC.available()
    yield
    h2o3_tpu_torch.shutdown()


def _bits32(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


def _str_list(vals):
    return [None if v is None else str(v) for v in vals]


def _same_frame(tf, jf, codecs=True):
    """The port's frame against the JAX package's (or the port's own)."""
    assert list(tf.names) == list(jf.names)
    assert tf.nrows == jf.nrows
    for n in tf.names:
        a, b = tf.vec(n), jf.vec(n)
        assert a.type == b.type, n
        assert a.levels() == b.levels(), n
        if a.type in ("str", "uuid"):
            assert _str_list(a.to_numpy()) == \
                _str_list(b.to_numpy()[:tf.nrows]), n
            continue
        if codecs:
            assert (a.codec.kind, a.codec.bias) == \
                (b.codec.kind, b.codec.bias), n
        np.testing.assert_array_equal(
            _bits32(a.to_numpy()), _bits32(b.to_numpy()[:tf.nrows]),
            err_msg=n)


def _same_tokens(got, want):
    """[(doubles, cells)] of the port against [(doubles, {row: str})]."""
    assert len(got) == len(want)
    for (gn, gc), (wn, wc) in zip(got, want):
        np.testing.assert_array_equal(np.isnan(gn), np.isnan(wn))
        ok = ~np.isnan(gn)
        np.testing.assert_array_equal(gn[ok].view(np.uint64),
                                      wn[ok].view(np.uint64))
        got_cells = gc.to_dict() if hasattr(gc, "to_dict") else gc
        want_cells = wc.to_dict() if hasattr(wc, "to_dict") else wc
        assert got_cells == want_cells


def _mixed_csv(path, n=400, seed=3, trailing_newline=True, header=True):
    """Numbers with NA tokens, a categorical, numbers and words mixed,
    time, a near-unique string, UUIDs, -0 and long numeric tokens."""
    rng = np.random.default_rng(seed)
    cats = ["alpha", "beta", "gamma", "delta", "epsilon-long-level"]
    nas = ["NA", "", "N/A", "null", "?", "NaN"]
    lines = ["num,cat,mixed,t,s,u,z,long"] if header else []
    for i in range(n):
        num = (f"{rng.normal():.6f}" if rng.random() > 0.1
               else nas[int(rng.integers(0, len(nas)))])
        cat = cats[int(rng.integers(0, len(cats)))]
        mixed = (cat if rng.random() < 0.4
                 else str(int(rng.integers(0, 120))))
        t = f"2024-0{int(rng.integers(1, 9))}-1{int(rng.integers(0, 9))}"
        s = f"tok-{int(rng.integers(0, 10_000_000))}"
        # a leading hex letter: a token of four digits and a dash reads
        # as time in both packages' setup guess
        u = str(uuid.UUID(int=(0xA << 124) | int(rng.integers(1, 2**62))))
        z = ["0", "-0", "7", "-0.0", "0.5"][int(rng.integers(0, 5))]
        long = ["12345678901234567890", "1234567", "1234567.4",
                "99999999999999999999999"][int(rng.integers(0, 4))]
        lines.append(f"{num},{cat},{mixed},{t},{s},{u},{z},{long}")
    body = "\n".join(lines)
    if trailing_newline:
        body += "\n"
    with open(path, "w") as f:
        f.write(body)


TYPES = {"z": "enum", "long": "enum", "s": "str"}


def _rm(*frames):
    for f in frames:
        (JDKV if type(f).__module__.startswith("h2o3_tpu.") else DKV
         ).remove(f.key)


# ---------------------------------------------------------------------------
# the tokenizer
@pytest.mark.parametrize("ranges", [1, 3, 7])
def test_native_tokenizer_matches_jax_and_the_python_twin(tmp_path,
                                                          ranges):
    """Byte ranges of a mixed file through the port's native tokenizer,
    the JAX package's native tokenizer and the port's Python twin: the
    same doubles and string cells, range by range."""
    p = str(tmp_path / "m.csv")
    _mixed_csv(p, n=300, seed=ranges)
    size = os.path.getsize(p)
    cuts = [size * k // ranges for k in range(ranges + 1)]
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        got = TFC.parse_columns(p, ",", True, lo, hi)
        _same_tokens(got, JFC.parse_columns(p, ",", True, lo, hi))
        _same_tokens(got, JD._tokenize_range_py(p, ",", True, lo, hi))
        _same_tokens(TD._tokenize_range_py(p, ",", True, lo, hi),
                     JD._tokenize_range_py(p, ",", True, lo, hi))
    with open(p, "rb") as f:
        buf = f.read()
    for skip in (False, True):
        _same_tokens(TFC.parse_bytes_columns(buf, ",", True, skip),
                     JFC.parse_bytes_columns(buf, ",", True, skip))
        _same_tokens(TD._tokenize_bytes_py(buf, ",", True, skip),
                     JD._tokenize_bytes_py(buf, ",", True, skip))


def test_doubled_quote_is_one_quote(tmp_path):
    """The deliberate difference: "q""r" tokenizes as q"r in the port's
    native engine and in both Python tokenizers; the JAX native engine
    keeps q""r. The cells without a doubled quote are the same in all
    four."""
    p = str(tmp_path / "q.csv")
    with open(p, "w") as f:
        f.write('a,b,c\n')
        f.write('1,"q""r","plain"\n')
        f.write('2,"x,""y"",z","""lead"\n')
        f.write('3,"""""",""\n')
    port = TFC.parse_columns(p, ",", True)
    twin = TD._tokenize_range_py(p, ",", True, 0, -1)
    jax_py = JD._tokenize_range_py(p, ",", True, 0, -1)
    jax_native = JFC.parse_columns(p, ",", True)
    want_b = {0: 'q"r', 1: 'x,"y",z', 2: '""'}
    for cols in (port, twin):
        assert cols[1][1].to_dict() == want_b
    assert jax_py[1][1] == want_b
    assert jax_native[1][1] == {0: 'q""r', 1: 'x,""y"",z', 2: '""""'}
    assert port[2][1].to_dict() == jax_py[2][1] == {0: "plain",
                                                   1: '"lead'}
    assert jax_native[2][1] == {0: "plain", 1: '""lead'}
    _same_tokens([port[0]], [jax_native[0]])
    _same_tokens(port, twin)
    fr = h2o3_tpu_torch.import_file(p)
    assert fr.vec("b").levels() == sorted(want_b.values())
    assert fr.vec("c").levels() == ['"lead', "plain"]
    _rm(fr)


def test_engine_counter_and_errors_surface(tmp_path, monkeypatch):
    """Every byte of a native parse counts under "fastcsv"; without the
    library the Python tokenizer takes the parse and counts under
    "python", with the same frame; a native failure raises (no silent
    re-parse)."""
    p = str(tmp_path / "m.csv")
    _mixed_csv(p, n=200, seed=5)
    size = os.path.getsize(p)
    TFC.reset_counts()
    native = TP.import_file(p, col_types=TYPES)
    chunked = h2o3_tpu_torch.import_file([p], col_types=TYPES)
    assert TFC.TOKENIZED_BYTES == {"fastcsv": 2 * size, "python": 0}
    _same_frame(native, chunked)
    TFC.reset_counts()
    monkeypatch.setattr(TFC, "available", lambda: False)
    monkeypatch.setattr(JFC, "available", lambda: False)
    plain = TP.import_file(p, col_types=TYPES)
    plain_chunked = TD.parse_files([p], chunk_bytes=999, col_types=TYPES)
    assert TFC.TOKENIZED_BYTES["fastcsv"] == 0
    assert TFC.TOKENIZED_BYTES["python"] >= 2 * size
    _same_frame(native, plain_chunked)
    # the whole-file Python path keeps the source tokens ("-0" and
    # "-0.0" two levels), as the JAX package's does
    jplain = JP.import_file(p, col_types=TYPES)
    _same_frame(plain, jplain)
    monkeypatch.undo()

    class Broken:
        def __getattr__(self, name):
            return getattr(TFC._lib(), name)

        @staticmethod
        def fastcsv_parse_range(*a):
            return None
    monkeypatch.setattr(TFC, "_lib", lambda: Broken())
    with pytest.raises(IOError, match="fastcsv failed"):
        TP.import_file(p)
    _rm(native, chunked, plain, plain_chunked, jplain)


@pytest.mark.parametrize("chunk", [None, 777, 4096])
def test_import_file_matches_jax(tmp_path, chunk):
    """One file, whole (native) and chunked, against the JAX package's
    import_file and its chunked parse."""
    p = str(tmp_path / "m.csv")
    _mixed_csv(p, n=500)
    if chunk is None:
        tf = h2o3_tpu_torch.import_file(p, col_types=TYPES)
        jf = JP.import_file(p, col_types=TYPES)
    else:
        tf = TD.parse_files([p], chunk_bytes=chunk, col_types=TYPES)
        jf = JD.parse_files([p], chunk_bytes=chunk, col_types=TYPES)
    _same_frame(tf, jf)
    assert tf.vec("z").levels() == ["-0.0", "0", "0.5", "7"]
    assert "12345678901234567890" not in tf.vec("long").levels()
    assert {"1234567", "1234567.4"} <= set(tf.vec("long").levels())
    assert tf.vec("u").type == "uuid" and tf.vec("t").type == "time"
    _rm(tf, jf)


# ---------------------------------------------------------------------------
# the chunked parse's edge cases, each against the JAX package
def _both(paths, **kw):
    return TD.parse_files(paths, **kw), JD.parse_files(paths, **kw)


def test_boundaries_on_a_newline_and_quoted_fields(tmp_path):
    pb = str(tmp_path / "bl.csv")
    with open(pb, "w") as f:
        f.write("x,y\n")
        for i in range(100):
            f.write(f"{i},{i * 2}\n")
    pq = str(tmp_path / "q.csv")
    with open(pq, "w") as f:
        f.write("a,b\n")
        for i in range(60):
            f.write(f'{i},"x{i},with,commas,{"z" * (i % 13)}"\n')
    whole = TP.import_file(pb)
    for cb in (7, 8, 12, 16, 24):
        tf, jf = _both([pb], chunk_bytes=cb)
        _same_frame(tf, jf)
        _same_frame(tf, whole)
        _rm(tf, jf)
    for cb in (17, 31, 64):
        tf, jf = _both([pq], chunk_bytes=cb)
        _same_frame(tf, jf)
        _rm(tf, jf)
    _rm(whole)


def test_no_trailing_newline_header_only_and_empty(tmp_path):
    p = str(tmp_path / "nt.csv")
    _mixed_csv(p, n=97, trailing_newline=False)
    tf, jf = _both([p], chunk_bytes=512, col_types=TYPES)
    _same_frame(tf, jf)
    _same_frame(tf, h2o3_tpu_torch.import_file(p, col_types=TYPES))
    ph = str(tmp_path / "h.csv")
    with open(ph, "w") as f:
        f.write("a,b,c\n")
    th, jh = _both([ph], chunk_bytes=2)
    _same_frame(th, jh)
    whole, jwhole = TP.import_file(ph), JP.import_file(ph)
    _same_frame(whole, jwhole)
    _same_frame(whole, th)
    pe = str(tmp_path / "e.csv")
    open(pe, "w").close()
    for fn in (TP.import_file, lambda q: TD.parse_files([q])):
        with pytest.raises(ValueError):
            fn(pe)
    _rm(tf, jf, th, jh, whole, jwhole)


def test_multifile_merge_rbind_and_path_order(tmp_path):
    """Categorical domains merged across files (and across chunks), the
    rbind renumbering of whole-file frames, duplicate paths and mixed
    plain and gzip paths in the caller's order, a directory and a glob."""
    pa, pb = str(tmp_path / "a.csv"), str(tmp_path / "b.csv")
    with open(pa, "w") as f:
        f.write("x,c\n1,zz\n2,aa\n3,mm\n")
    with open(pb, "w") as f:
        f.write("x,c\n4,bb\n5,zz\n6,qq\n")
    ga = str(tmp_path / "a.csv.gz")
    with open(pa, "rb") as fi, gzip.open(ga, "wb") as fo:
        shutil.copyfileobj(fi, fo)
    for paths in ([pa, pb], [pa, pb, pa], [ga, pb], [pb, ga, pb],
                  str(tmp_path / "*.csv")):
        tf, jf = _both(paths, chunk_bytes=8)
        _same_frame(tf, jf)
        _rm(tf, jf)
    tf = h2o3_tpu_torch.import_file([ga, pb, pa])
    np.testing.assert_array_equal(tf.vec("x").to_numpy(),
                                  [1, 2, 3, 4, 5, 6, 1, 2, 3])
    ta, tb = TP.import_file(pa), TP.import_file(pb)
    ja, jb = JP.import_file(pa), JP.import_file(pb)
    rb, jrb = TD._rbind_frames([ta, tb], None), JD._rbind_frames([ja, jb],
                                                               None)
    _same_frame(rb, jrb)
    assert rb.vec("c").levels() == ["aa", "bb", "mm", "qq", "zz"]
    d = tmp_path / "dir"
    d.mkdir()
    for q in (pa, pb):
        shutil.copy(q, d / os.path.basename(q))
    td_, jd_ = h2o3_tpu_torch.import_file(str(d)), JP.import_file(str(d))
    _same_frame(td_, jd_)
    tg = h2o3_tpu_torch.import_file("file://" + str(tmp_path / "[ab].csv"))
    _same_frame(tg, td_)
    _rm(tf, ta, tb, ja, jb, rb, jrb, td_, jd_, tg)


def test_time_fixups_and_compressed_members(tmp_path):
    p = str(tmp_path / "t.csv")
    with open(p, "w") as f:
        f.write("t,v\n")
        for i in range(200):
            f.write(f"2024-03-{(i % 27) + 1:02d},{i}\n")
        f.write("not-a-time,1\n")
    tf, jf = _both([p], chunk_bytes=256)
    assert tf.vec("t").type == "time"
    _same_frame(tf, jf)
    pm = str(tmp_path / "c.csv")
    _mixed_csv(pm, n=800, seed=9)
    gz = pm + ".gz"
    with open(pm, "rb") as fi, gzip.open(gz, "wb") as fo:
        shutil.copyfileobj(fi, fo)
    zp = str(tmp_path / "c.zip")
    with zipfile.ZipFile(zp, "w") as zf:
        zf.write(pm, "c.csv")
    plain = TD.parse_files([pm], chunk_bytes=4096, col_types=TYPES)
    for comp in (gz, zp):
        tc = h2o3_tpu_torch.import_file(comp, col_types=TYPES)
        jc = JP.import_file(comp, col_types=TYPES)
        _same_frame(tc, plain)
        _same_frame(tc, jc)
        _rm(tc, jc)
    _rm(tf, jf, plain)


def test_broadcaster_is_not_ported(tmp_path):
    """The name predates the port of the fan-out (tests/test_torch_cloud.py
    holds the fan-out against the sequential parse): a broadcaster with no
    live worker leaves every chunk to this process, and the frame is the
    sequential parse's."""
    p = str(tmp_path / "a.csv")
    with open(p, "w") as f:
        f.write("x,y\n1,a\n2.5,b\n,a\n")

    class _Alone:
        def live_pids(self):
            return []

    want = TD.parse_files([p])
    for fn in (TD.parse_files, TD.import_files):
        got = fn([p], broadcaster=_Alone())
        assert got.names == want.names and got.types == want.types
        np.testing.assert_array_equal(got.to_numpy(), want.to_numpy())
        _rm(got)
    _rm(want)


# ---------------------------------------------------------------------------
# URIs
class _RangeHandler(http.server.SimpleHTTPRequestHandler):
    """A static file server that answers Range requests with 206."""

    def log_message(self, *a):
        pass

    def send_head(self):
        rng = self.headers.get("Range")
        path = self.translate_path(self.path)
        if not rng or not os.path.isfile(path):
            return super().send_head()
        size = os.path.getsize(path)
        lo, hi = rng.split("=")[1].split("-")
        lo, hi = int(lo), min(int(hi or size - 1), size - 1)
        f = open(path, "rb")
        f.seek(lo)
        self.send_response(206)
        self.send_header("Content-Range", f"bytes {lo}-{hi}/{size}")
        self.send_header("Content-Length", str(max(hi - lo + 1, 0)))
        self.send_header("Accept-Ranges", "bytes")
        self.end_headers()
        return _Limited(f, max(hi - lo + 1, 0))


class _Limited:
    def __init__(self, f, n):
        self.f, self.n = f, n

    def read(self, k=-1):
        k = self.n if k < 0 else min(k, self.n)
        b = self.f.read(k)
        self.n -= len(b)
        return b

    def close(self):
        self.f.close()


def _serve(directory):
    httpd = http.server.ThreadingHTTPServer(
        ("127.0.0.1", 0), functools.partial(_RangeHandler,
                                            directory=directory))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


def test_http_range_ingest(tmp_path):
    """A CSV over a localhost server that takes ranges: the chunked parse
    of the URI is the local file's bit for bit, and so is import_file's;
    a remote gzip is staged, then inflated."""
    p = str(tmp_path / "web.csv")
    _mixed_csv(p, n=300, seed=13)
    with open(p, "rb") as fi, gzip.open(p + ".gz", "wb") as fo:
        shutil.copyfileobj(fi, fo)
    httpd = _serve(str(tmp_path))
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}/web.csv"
        assert TURI.path_size(url) == os.path.getsize(p)
        assert TURI.supports_ranges(url) and TURI.exists(url)
        with open(p, "rb") as f:
            assert TURI.read_range(url, 5, 25) == f.read()[5:25]
        local = TD.parse_files([p], chunk_bytes=4096, col_types=TYPES)
        for fr in (TD.parse_files([url], chunk_bytes=4096,
                                  col_types=TYPES),
                   h2o3_tpu_torch.import_file(url, col_types=TYPES),
                   TD.parse_files([url + ".gz"], chunk_bytes=4096,
                                  col_types=TYPES)):
            _same_frame(fr, local)
            _rm(fr)
        jr = JD.parse_files([url], chunk_bytes=4096, col_types=TYPES)
        _same_frame(local, jr)
        _rm(local, jr)
    finally:
        httpd.shutdown()


def test_fsspec_memory_uri(tmp_path):
    """A memory:// CSV through fsspec in both packages (the card's
    machine has no fsspec: there the import raises, as in the JAX
    package)."""
    fsspec = pytest.importorskip("fsspec")
    p = str(tmp_path / "m.csv")
    _mixed_csv(p, n=120, seed=17)
    with open(p, "rb") as f:
        fsspec.filesystem("memory").pipe("/ingest/m.csv", f.read())
    url = "memory://ingest/m.csv"
    tf = h2o3_tpu_torch.import_file(url, col_types=TYPES)
    jf = JP.import_file(url, col_types=TYPES)
    _same_frame(tf, jf)
    _rm(tf, jf)


# ---------------------------------------------------------------------------
# xlsx and the columnar readers
def _write_xlsx(path, header, rows):
    """A minimal xlsx: a zip of the workbook's XML parts."""
    def ref(r, c):
        s = ""
        c += 1
        while c:
            c, rem = divmod(c - 1, 26)
            s = chr(65 + rem) + s
        return f"{s}{r + 1}"
    strings = []

    def cell(r, c, v):
        if isinstance(v, str):
            if v not in strings:
                strings.append(v)
            return f'<c r="{ref(r, c)}" t="s"><v>{strings.index(v)}</v></c>'
        if v is None:
            return f'<c r="{ref(r, c)}"/>'
        return f'<c r="{ref(r, c)}"><v>{v}</v></c>'
    body = [f'<row r="{i + 1}">'
            + "".join(cell(i, j, v) for j, v in enumerate(row)) + "</row>"
            for i, row in enumerate([header] + rows)]
    ns = 'xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main"'
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("[Content_Types].xml", "<Types/>")
        z.writestr("xl/workbook.xml", f"<workbook {ns}/>")
        z.writestr("xl/worksheets/sheet1.xml",
                   f'<?xml version="1.0"?><worksheet {ns}><sheetData>'
                   + "".join(body) + "</sheetData></worksheet>")
        z.writestr("xl/sharedStrings.xml",
                   f'<?xml version="1.0"?><sst {ns}>'
                   + "".join(f"<si><t>{s}</t></si>" for s in strings)
                   + "</sst>")


def test_xlsx_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    rows = [[f"n{i % 7}", float(np.round(rng.normal(), 4)) if i % 9 else
             None, ["a", "b", "c"][i % 3], i] for i in range(60)]
    p = str(tmp_path / "t.xlsx")
    _write_xlsx(p, ["name", "score", "grade", "i"], rows)
    tf, jf = h2o3_tpu_torch.import_file(p), JP.import_file(p)
    _same_frame(tf, jf)
    assert tf.names == ["name", "score", "grade", "i"]
    x = str(tmp_path / "t.xls")
    with open(x, "wb") as f:
        f.write(b"\xd0\xcf\x11\xe0junk")
    with pytest.raises(NotImplementedError, match="xlsx"):
        h2o3_tpu_torch.import_file(x)
    _rm(tf, jf)


@pytest.mark.parametrize("fmt", ["parquet", "orc", "feather"])
def test_columnar_formats_match_jax(tmp_path, fmt):
    pa = pytest.importorskip("pyarrow")
    rng = np.random.default_rng(4)
    n = 250
    t = pa.table({
        "num": pa.array(np.where(rng.random(n) < 0.1, np.nan,
                                 rng.normal(size=n))),
        "int": pa.array(rng.integers(0, 100, n)),
        "cat": pa.array(np.array(["a", "b", "c", None], object)[
            rng.integers(0, 4, n)]),
        "flag": pa.array(rng.random(n) > 0.5),
        "ts": pa.array((1_700_000_000_000 + rng.integers(0, 10**9, n))
                       .astype("datetime64[ms]")),
    })
    p = str(tmp_path / f"data.{fmt}")
    if fmt == "parquet":
        import pyarrow.parquet as pq
        pq.write_table(t, p)
    elif fmt == "orc":
        from pyarrow import orc
        orc.write_table(t, p)
    else:
        import pyarrow.feather as feather
        feather.write_feather(t, p)
    tf, jf = h2o3_tpu_torch.import_file(p), JP.import_file(p)
    _same_frame(tf, jf)
    # by magic bytes, without the extension
    q = str(tmp_path / f"noext_{fmt}")
    shutil.copy(p, q)
    tq = h2o3_tpu_torch.import_file(q)
    _same_frame(tq, tf)
    _rm(tf, jf, tq)


def test_avro_is_gated_as_in_jax(tmp_path):
    from h2o3_tpu.io import columnar as JC
    from h2o3_tpu_torch.io import columnar as TC
    assert TC.available_formats() == JC.available_formats()
    if TC.available_formats()["avro"]:
        pytest.skip("fastavro present; the gate is not exercised")
    p = str(tmp_path / "data.avro")
    with open(p, "wb") as fh:
        fh.write(b"Obj\x01rest")
    with pytest.raises(RuntimeError, match="fastavro"):
        h2o3_tpu_torch.import_file(p)


def test_num_token_is_the_jax_packages():
    for v in (0.0, -0.0, 7.0, 1234567.4, 1e300, -2.5, math.inf, 2.0**53,
              12345678901234567890.0):
        assert TP._num_token(v) == JP._num_token(v)

"""Genuine H2O-3 MOJO zips of the port, read and written
(h2o3_tpu/genmodel/h2o_mojo.py).

Format sources (all verified against the reference implementation):
  * container/model.ini: hex/genmodel/AbstractMojoWriter.java
    (writeModelInfo :150, writelnkv "key = value", [columns], [domains]
    "idx: count dNNN.txt", domains/dNNN.txt one level per line)
  * per-algo info keys: hex/tree/SharedTreeMojoWriter.java:32 (n_trees,
    n_trees_per_class, trees/tCC_TTT.bin blobs),
    hex/tree/gbm/GbmMojoWriter.java:29 (distribution, link_function,
    init_f, mojo_version 1.40)
  * tree byte format: hex/genmodel/algos/tree/SharedTreeMojoModel.java:129
    (scoreTree) — little-endian (ByteBufferWrapper nativeOrder):
      node  := nodeType:u8 colId:u16 [leaf if colId==0xFFFF: f32]
               naSplitDir:u8 (NaSplitDir.java: NAvsREST=1 NALeft=2
               NARight=3 Left=4 Right=5)
               payload (f32 splitVal | inline bitset)
               [leftSize:u8..u32 when left child is internal]
               leftSubtree rightSubtree
      nodeType bits: equal = nodeType & 12 (0 numeric, 8 = 32-bit inline
      bitset "fill2", 12 = offset bitset "fill3" [bitoff:u16 nbits:u32
      bytes]); lmask = nodeType & 51 in {0,1,2,3} = width-1 of leftSize,
      48 = left child is a 4-byte leaf; rmask 48<<2 in bits 0xC0 = right
      child is a leaf. Split semantics: d >= splitVal goes RIGHT; bitset
      contains((int)d) goes RIGHT (LSB-first bits,
      hex/genmodel/utils/GenmodelBitSet.java:contains); NaN (or
      out-of-range category) routes by leftward = naSplitDir in {2,4}.

Our engine's thresholds mean "x <= thr goes left"; the adjacent-float
conversion splitVal = nextafter(thr, +inf) (and back) makes write->score
round trips EXACT, not approximate.

In the port: a tree's arrays come off the model's device as numpy, and
`import_h2o_mojo` puts the parsed trees (`TreeArrays`, the go-right
words held in int64) on the cloud's device, where `H2OMojoModel` scores
them through `engine.predict_ensemble`: `predict_tensor` takes the
model-space matrix on the card and leaves its result there. A GBM leaf
is stored as f32(value·learn_rate), as H2O-3 stores it, so an imported
GBM's margins differ from the model's f0 + lr·Σ value by f32
reassociation; the routing (column, threshold, NA direction) is exact. A
GLM of the reduced design exports in the all-levels layout, the dropped
level's coefficient 0 (`mojo.all_levels`). The GLM, KMeans and DL
oracles are the JAX package's numpy score0 re-implementations.
"""

from __future__ import annotations

import math
import struct
import uuid as _uuid
import zipfile
from datetime import datetime, timezone

import numpy as np
import torch

from h2o3_tpu_torch.genmodel.mojo import _np, all_levels, full_coefficients

NA_VS_REST = 1
NA_LEFT = 2
NA_RIGHT = 3


# ===========================================================================
# Tree serialization (CompressedTree byte layout)
def _write_node(out: bytearray, i: int, col, thr, nal, val, catbits,
                col_is_cat, ncat, nodes: int):
    """Append node i (heap layout) to `out`; returns nothing."""
    c = int(col[i]) if i < nodes else -1
    if c < 0:
        # root-is-leaf: full leaf record (nodeType, colId=0xFFFF, float)
        out += b"\x00\xff\xff"
        out += struct.pack("<f", float(val[i]))
        return
    kid_l, kid_r = 2 * i + 1, 2 * i + 2
    l_leaf = kid_l >= nodes or col[kid_l] < 0
    r_leaf = kid_r >= nodes or col[kid_r] < 0

    is_cat = bool(col_is_cat[c]) if col_is_cat is not None else False
    nb = int(ncat[c]) if (is_cat and ncat is not None) else 0
    use_fill2 = is_cat and nb <= 32

    # left subtree bytes (needed for the size field)
    left = bytearray()
    if l_leaf:
        left += struct.pack("<f", float(val[kid_l]) if kid_l < nodes
                            else float(val[i]))
    else:
        _write_node(left, kid_l, col, thr, nal, val, catbits, col_is_cat,
                    ncat, nodes)
    right = bytearray()
    if r_leaf:
        right += struct.pack("<f", float(val[kid_r]) if kid_r < nodes
                             else float(val[i]))
    else:
        _write_node(right, kid_r, col, thr, nal, val, catbits, col_is_cat,
                    ncat, nodes)

    if l_leaf:
        lmask = 48
        lsize_bytes = b""
    else:
        n = len(left)
        width = 1 if n < (1 << 8) else 2 if n < (1 << 16) else \
            3 if n < (1 << 24) else 4
        lmask = width - 1
        lsize_bytes = int(n).to_bytes(width, "little")
    rmask = 48 if r_leaf else 0
    equal = 0 if not is_cat else (8 if use_fill2 else 12)
    node_type = (lmask | equal | (rmask << 2)) & 0xFF
    out.append(node_type)
    out += struct.pack("<H", c)
    out.append(NA_LEFT if nal[i] else NA_RIGHT)
    if not is_cat:
        # ours: x <= thr left; H2O: x >= splitVal right => splitVal is the
        # adjacent float above thr (exact float round trip)
        sv = np.nextafter(np.float32(thr[i]), np.float32(np.inf))
        out += struct.pack("<f", float(sv))
    else:
        bits = _node_bits(catbits, i, nb)
        if use_fill2:
            out += bits[:4].ljust(4, b"\x00")
        else:
            nbits = nb
            out += struct.pack("<H", 0)           # bitoff
            out += struct.pack("<i", nbits)
            out += bits[: (nbits + 7) // 8].ljust((nbits + 7) // 8, b"\x00")
    out += lsize_bytes
    out += left
    out += right


def _node_bits(catbits, i, nb) -> bytes:
    """LSB-first byte string of the go-RIGHT category set for node i."""
    if catbits is None:
        return b"\x00" * ((nb + 7) // 8)
    words = np.asarray(catbits[i], np.uint32)
    return words.astype("<u4").tobytes()


def tree_to_h2o_bytes(ta, t: int, ncat=None, val_scale: float = 1.0,
                      class0: bool = False) -> bytes:
    """Serialize tree t of a TreeArrays into the reference byte format.
    val_scale: GBM MOJO leaves store learn-rate-scaled contributions
    (the reference applies learn_rate during tree building); our
    TreeArrays keep raw Newton values and scale at scoring time.
    class0: a binomial DRF's leaves hold P(class 1) here and P(class 0)
    in H2O-3's trees (DrfMojoModel), so they are written as 1 - value."""
    out = bytearray()
    col = _np(ta.col[t])
    thr = _np(ta.thr[t]).astype(np.float32)
    nal = _np(ta.na_left[t])
    val = _np(ta.value[t]).astype(np.float32) * np.float32(val_scale)
    if class0:
        val = np.float32(1.0) - val
    catbits = None if ta.catbits is None else _np(ta.catbits[t])
    cic = None if ta.col_is_cat is None else np.asarray(ta.col_is_cat)
    _write_node(out, 0, col, thr, nal, val, catbits, cic, ncat,
                col.shape[0])
    return bytes(out)


# ===========================================================================
# Tree deserialization -> dense heap arrays
class _TreeParser:
    def __init__(self, b: bytes):
        self.b = b
        self.pos = 0

    def u1(self):
        v = self.b[self.pos]
        self.pos += 1
        return v

    def u2(self):
        v = struct.unpack_from("<H", self.b, self.pos)[0]
        self.pos += 2
        return v

    def i4(self):
        v = struct.unpack_from("<i", self.b, self.pos)[0]
        self.pos += 4
        return v

    def f4(self):
        v = struct.unpack_from("<f", self.b, self.pos)[0]
        self.pos += 4
        return v

    def skip(self, n):
        self.pos += n


def parse_h2o_tree(b: bytes, max_cat: int = 1024):
    """Decode one compressed tree into node dicts keyed by heap index."""
    nodes = {}

    def rec(p: _TreeParser, i: int, depth: int):
        node_type = p.u1()
        col = p.u2()
        if col == 0xFFFF:
            nodes[i] = ("leaf", p.f4())
            return depth
        nasd = p.u1()
        lmask = node_type & 51
        equal = node_type & 12
        rmask = (node_type & 0xC0) >> 2
        na_vs_rest = nasd == NA_VS_REST
        leftward = nasd in (NA_LEFT, 4)
        split_val = None
        bits = None
        bitoff = 0
        if not na_vs_rest:
            if equal == 0:
                split_val = p.f4()
            elif equal == 8:
                bits = p.b[p.pos: p.pos + 4]
                p.skip(4)
            else:
                bitoff = p.u2()
                nbits = p.i4()
                nbytes = (nbits + 7) // 8
                bits = p.b[p.pos: p.pos + nbytes]
                p.skip(nbytes)
        if lmask <= 3:
            p.skip(lmask + 1)        # left subtree size (recomputed)
        nodes[i] = ("split", col, leftward, na_vs_rest, split_val, bits,
                    bitoff)
        # left child
        if lmask == 48:
            nodes[2 * i + 1] = ("leaf", p.f4())
            dl = depth + 1
        else:
            dl = rec(p, 2 * i + 1, depth + 1)
        if rmask == 48:
            nodes[2 * i + 2] = ("leaf", p.f4())
            dr = depth + 1
        else:
            dr = rec(p, 2 * i + 2, depth + 1)
        return max(dl, dr)

    depth = rec(_TreeParser(b), 0, 0)
    return nodes, depth


def trees_to_arrays(tree_nodes, depth, n_features, cat_width=0):
    """Dense heap TreeArrays from a list of parsed trees, on the cloud's
    device."""
    from h2o3_tpu_torch.models.tree.engine import TreeArrays
    from h2o3_tpu_torch.parallel.mesh import cloud
    device = cloud().device
    T = len(tree_nodes)
    nnodes = 2 ** (depth + 1) - 1
    col = np.full((T, nnodes), -1, np.int32)
    thr = np.zeros((T, nnodes), np.float32)
    nal = np.zeros((T, nnodes), bool)
    val = np.zeros((T, nnodes), np.float32)
    W = max(1, (cat_width + 31) // 32)
    any_cat = False
    catbits = np.zeros((T, nnodes, W), np.uint32)
    col_is_cat = np.zeros(n_features, bool)
    big = np.float32(3.0e38)
    for t, nodes in enumerate(tree_nodes):
        for i, nd in nodes.items():
            if i >= nnodes:
                raise ValueError("tree deeper than declared depth")
            if nd[0] == "leaf":
                val[t, i] = nd[1]
                continue
            _, c, leftward, na_vs_rest, split_val, bits, bitoff = nd
            col[t, i] = c
            nal[t, i] = leftward
            if na_vs_rest:
                # all non-NA go left; NA routes right via nal=False
                thr[t, i] = big
                nal[t, i] = False
            elif split_val is not None:
                # H2O: x >= splitVal right  =>  our thr = prev float
                thr[t, i] = np.nextafter(np.float32(split_val),
                                         np.float32(-np.inf))
            else:
                any_cat = True
                col_is_cat[c] = True
                arr = np.frombuffer(bits.ljust(W * 4, b"\x00"),
                                    dtype="<u4")[:W].copy()
                if bitoff:
                    # shift the category ids up by bitoff
                    full = np.zeros(W * 32, bool)
                    raw = np.unpackbits(
                        np.frombuffer(bits, np.uint8), bitorder="little")
                    n = min(raw.size, W * 32 - bitoff)
                    full[bitoff: bitoff + n] = raw[:n]
                    arr = np.packbits(full, bitorder="little") \
                        .view("<u4")[:W].copy()
                catbits[t, i] = arr
    # leaf values for pruned interior slots stay 0; fill descendant values
    # of leaves so fixed-depth walks that overshoot stop at the leaf value
    for t, nodes in enumerate(tree_nodes):
        for i, nd in nodes.items():
            if nd[0] == "leaf":
                # propagate down the dense heap so a full-depth walk lands
                # on this value regardless of routing below a leaf
                stack = [i]
                while stack:
                    j = stack.pop()
                    if j != i:
                        val[t, j] = val[t, i]
                        col[t, j] = -1
                    kl, kr = 2 * j + 1, 2 * j + 2
                    if kl < nnodes:
                        stack += [kl, kr]
    def t(a):
        return torch.from_numpy(a).to(device)
    return TreeArrays(
        col=t(col), thr=t(thr), na_left=t(nal), value=t(val), depth=depth,
        catbits=t(catbits.astype(np.int64)) if any_cat else None,
        col_is_cat=col_is_cat if any_cat else None)


# ===========================================================================
# Container: write
def export_h2o_mojo(model, path: str) -> str:
    """Write a reference-layout MOJO zip (AbstractMojoWriter.java layout;
    per-algo writers: SharedTreeMojoWriter, GlmMojoWriter,
    KMeansMojoWriter, DeeplearningMojoWriter)."""
    algo = model.algo
    if algo == "glm":
        return _export_glm_mojo(model, path)
    if algo == "kmeans":
        return _export_kmeans_mojo(model, path)
    if algo == "deeplearning":
        return _export_dl_mojo(model, path)
    return _export_tree_mojo(model, path)


def _export_tree_mojo(model, path: str) -> str:
    """GBM/DRF (hex/tree/SharedTreeMojoWriter.java)."""
    di = model._dinfo
    algo = model.algo
    assert algo in ("gbm", "drf"), f"h2o-mojo export supports trees, not {algo}"
    multi = getattr(model, "_trees_k", None) is not None
    tlist = model._trees_k if multi else [model._trees]
    ntrees = tlist[0].ntrees
    tpc = len(tlist)

    feats = list(di.predictors)
    resp = di.response_name
    columns = feats + ([resp] if resp else [])
    domains = {}
    for ci, name in enumerate(columns):
        if name in (di.domains or {}):
            domains[ci] = list(di.domains[name])
    if resp and di.response_domain:
        domains[len(columns) - 1] = list(di.response_domain)
    nclasses = (len(di.response_domain) if di.response_domain else 1)

    dist = getattr(model, "_dist", "gaussian")
    link = {"bernoulli": "logit", "quasibinomial": "logit",
            "multinomial": "multinomial", "poisson": "log", "gamma": "log",
            "tweedie": "log"}.get(dist, "identity")
    f0 = getattr(model, "_f0", 0.0) if not multi else 0.0
    cat_card = np.zeros(len(feats), np.int64)
    for j, name in enumerate(feats):
        if name in (di.cardinalities or {}):
            cat_card[j] = di.cardinalities[name]

    ini = ["[info]"]

    def kv(k, v):
        ini.append(f"{k} = {v}")

    kv("h2o_version", "3.46.0.99999")
    kv("mojo_version", "1.40")
    kv("license", "Apache License Version 2.0")
    kv("algo", algo)
    kv("algorithm", "Gradient Boosting Machine" if algo == "gbm"
        else "Distributed Random Forest")
    kv("endianness", "LITTLE_ENDIAN")
    kv("category", "Regression" if nclasses == 1 else
        ("Binomial" if nclasses == 2 else "Multinomial"))
    kv("uuid", str(_uuid.uuid4().int & ((1 << 63) - 1)))
    kv("supervised", "true")
    kv("n_features", len(feats))
    kv("n_classes", nclasses)
    kv("n_columns", len(columns))
    kv("n_domains", len(domains))
    kv("balance_classes", "false")
    kv("default_threshold", "0.5")
    kv("prior_class_distrib", "null")
    kv("model_class_distrib", "null")
    kv("timestamp", datetime.now(timezone.utc).isoformat())
    kv("n_trees", ntrees)
    kv("n_trees_per_class", tpc)
    kv("distribution", dist)
    kv("link_function", link)
    kv("init_f", float(f0))
    kv("offset_column", "null")

    ini.append("")
    ini.append("[columns]")
    ini += columns
    ini.append("")
    ini.append("[domains]")
    dom_files = []
    for di_idx, (ci, levels) in enumerate(sorted(domains.items())):
        ini.append(f"{ci}: {len(levels)} d{di_idx:03d}.txt")
        dom_files.append((f"domains/d{di_idx:03d}.txt", "\n".join(levels)))

    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("model.ini", "\n".join(ini) + "\n")
        for fn, content in dom_files:
            z.writestr(fn, content + "\n")
        lr = (float(model.params.get("learn_rate") or 1.0)
              if algo == "gbm" else 1.0)
        # the JAX package writes a binomial forest's P(class 1) leaves as
        # they are, which genmodel (and its own reader) reads as P(class 0)
        class0 = algo == "drf" and not multi and nclasses == 2
        for cls, ta in enumerate(tlist):
            for t in range(ta.ntrees):
                b = tree_to_h2o_bytes(ta, t, ncat=cat_card, val_scale=lr,
                                      class0=class0)
                z.writestr(f"trees/t{cls:02d}_{t:03d}.bin", b)
    return path


# ===========================================================================
# Container: read
def _parse_ini(text: str):
    info, columns, domains = {}, [], {}
    section = None
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("["):
            section = line
            continue
        if section == "[info]":
            if "=" in line:
                k, v = line.split("=", 1)
                info[k.strip()] = v.strip()
        elif section == "[columns]":
            columns.append(line)
        elif section == "[domains]":
            ci, rest = line.split(":", 1)
            cnt, fname = rest.strip().split(" ", 1)
            domains[int(ci)] = (int(cnt), fname.strip())
    return info, columns, domains


class H2OMojoModel:
    """A reference-format MOJO loaded for scoring (GbmMojoModel /
    DrfMojoModel analog; scores with the engine's batch walk on the
    trees' device)."""

    def __init__(self, info, columns, domains, trees_k, f0, dist, algo):
        self.info = info
        self.columns = columns
        self.domains = domains          # col index -> [levels]
        self.trees_k = trees_k          # list (per class) of TreeArrays
        self.f0 = f0
        self.dist = dist
        self.algo = algo
        self.n_features = int(info.get("n_features", len(columns) - 1))
        self.n_classes = int(info.get("n_classes", 1))

    @property
    def device(self):
        return self.trees_k[0].col.device

    def predict_raw(self, X: np.ndarray) -> np.ndarray:
        """X (n, n_features) f32 with NaN NAs, categorical as level codes.
        Returns (n,) regression / (n, K) class probabilities."""
        X = torch.as_tensor(np.asarray(X, np.float32), device=self.device)
        return self.predict_tensor(X).cpu().numpy()

    def predict_tensor(self, X: torch.Tensor) -> torch.Tensor:
        """predict_raw of an f32 tensor, on its device."""
        from h2o3_tpu_torch.models.tree import engine as E
        if self.algo == "drf":
            if self.n_classes <= 1:
                ta = self.trees_k[0]
                return E.predict_ensemble(X, ta) / ta.ntrees
            per = [E.predict_ensemble(X, ta) / ta.ntrees
                   for ta in self.trees_k]
            if self.n_classes == 2 and len(per) == 1:
                p1 = 1.0 - per[0]     # DRF stores p(class0) votes
                return torch.stack([1 - p1, p1], 1)
            P = torch.stack(per, 1)
            return P / P.sum(1, keepdim=True).clamp(min=1e-30)
        # GBM margins
        if self.n_classes <= 2:
            F = self.f0 + E.predict_ensemble(X, self.trees_k[0])
            if self.n_classes == 2:
                p1 = 1.0 / (1.0 + torch.exp(-F))
                return torch.stack([1 - p1, p1], 1)
            if self.dist in ("poisson", "gamma", "tweedie"):
                return torch.exp(F)
            return F
        M = torch.stack([E.predict_ensemble(X, ta) for ta in self.trees_k],
                        1)
        P = torch.exp(M - M.max(1, keepdim=True).values)
        return P / P.sum(1, keepdim=True)


def import_h2o_mojo(path: str) -> H2OMojoModel:
    """Load a genuine H2O-3 MOJO zip (tree algos), its trees on the
    cloud's device."""
    with zipfile.ZipFile(path) as z:
        info, columns, domspec = _parse_ini(
            z.read("model.ini").decode("utf-8", "replace"))
        algo = info.get("algo", "gbm")
        if algo not in ("gbm", "drf"):
            raise NotImplementedError(
                f"reference-MOJO import supports tree models, got {algo}")
        mver = float(info.get("mojo_version", "1.40"))
        if mver < 1.2:
            raise NotImplementedError(
                f"mojo_version {mver} predates the v1.2 tree byte format")
        domains = {}
        for ci, (cnt, fname) in domspec.items():
            levels = z.read(f"domains/{fname}").decode(
                "utf-8", "replace").splitlines()
            domains[ci] = levels[:cnt]
        ntrees = int(info["n_trees"])
        tpc = int(info.get("n_trees_per_class", 1))
        n_features = int(info["n_features"])
        max_card = max([len(v) for v in domains.values()], default=0)
        groups = []
        for cls in range(tpc):
            parsed = []
            maxd = 1
            for t in range(ntrees):
                name = f"trees/t{cls:02d}_{t:03d}.bin"
                nodes, d = parse_h2o_tree(z.read(name))
                parsed.append(nodes)
                maxd = max(maxd, d)
            if maxd > 16:
                raise NotImplementedError(f"tree depth {maxd} > 16")
            groups.append(trees_to_arrays(parsed, maxd, n_features,
                                          cat_width=max(max_card, 32)))
    f0 = float(info.get("init_f", 0.0) if info.get("init_f") not in
               (None, "null") else 0.0)
    return H2OMojoModel(info, columns, domains, groups, f0,
                        info.get("distribution", "gaussian"), algo)


# ===========================================================================
# Non-tree writers (GlmMojoWriter / KMeansMojoWriter / DeeplearningMojoWriter)
def _ini_header(algo, algorithm, category, nclasses, columns, n_features,
                supervised=True):
    """Common [info] block (AbstractMojoWriter.writeModelInfo)."""
    ini = ["[info]"]

    def kv(k, v):
        ini.append(f"{k} = {v}")

    kv("h2o_version", "3.46.0.99999")
    kv("mojo_version", "1.00")
    kv("license", "Apache License Version 2.0")
    kv("algo", algo)
    kv("algorithm", algorithm)
    kv("endianness", "LITTLE_ENDIAN")
    kv("category", category)
    kv("uuid", str(_uuid.uuid4().int & ((1 << 63) - 1)))
    kv("supervised", "true" if supervised else "false")
    kv("n_features", n_features)
    kv("n_classes", nclasses)
    kv("n_columns", len(columns))
    kv("balance_classes", "false")
    kv("default_threshold", "0.5")
    kv("timestamp", datetime.now(timezone.utc).isoformat())
    return ini, kv


def _arr(vals):
    """Arrays.toString encoding readkv round-trips: "[a, b, c]"."""
    return "[" + ", ".join(repr(float(v)) if isinstance(v, float)
                           else str(v) for v in vals) + "]"


def _finish_zip(path, ini, columns, domains_by_ci):
    ini.append("")
    ini.append("[columns]")
    ini += columns
    ini.append("")
    ini.append("[domains]")
    dom_files = []
    for di_idx, (ci, levels) in enumerate(sorted(domains_by_ci.items())):
        ini.append(f"{ci}: {len(levels)} d{di_idx:03d}.txt")
        dom_files.append((f"domains/d{di_idx:03d}.txt", "\n".join(levels)))
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("model.ini", "\n".join(ini) + "\n")
        for fn, content in dom_files:
            z.writestr(fn, content + "\n")
    return path


def _glm_layout(model):
    """(columns cats-first, beta per-class in genmodel layout, cat meta).

    GlmMojoModel.glmScore0 applies beta to RAW values: indicator betas by
    catOffsets (use_all_factor_levels=true: a level the reduced design
    dropped gets 0), then raw numerics, intercept last; standardization is
    baked out of the betas exactly like the reference writer does."""
    di = all_levels(model._dinfo)
    assert not (di.inter_pairs or di.inter_catcat or di.inter_catnum), \
        "reference GLM MOJO export does not cover interaction columns"
    cats, nums = list(di.cat_cols), list(di.num_cols)
    cat_offsets = [0]
    for c in cats:
        cat_offsets.append(cat_offsets[-1] + di.cardinalities[c])
    fam = model._state.family
    if fam == "multinomial":
        std = full_coefficients(model._coefficients_std,
                                di.feature_names)    # {name: [K betas]}
        K = len(di.response_domain)
        P = cat_offsets[-1] + len(nums) + 1
        beta = np.zeros(K * P)
        for k in range(K):
            j = 0
            icept = std["Intercept"][k]
            for c in cats:
                for lvl in di.domains[c]:
                    beta[k * P + j] = std[f"{c}.{lvl}"][k]
                    j += 1
            for c in nums:
                b = std[c][k]
                if di.standardize:
                    s = max(di.sigmas[c], 1e-10)
                    beta[k * P + j] = b / s
                    icept -= b * di.means[c] / s
                else:
                    beta[k * P + j] = b
                j += 1
            beta[k * P + P - 1] = icept
    else:
        raw = full_coefficients(model._coefficients, di.feature_names)
        # sparse fits keep STANDARDIZED betas in _coefficients
        # (glm.py skips de-standardization there) — bake the scale out
        # here so the MOJO's raw-space contract holds
        destd = bool(di.standardize) and getattr(model, "_sparse_fit",
                                                 False)
        beta = np.zeros(cat_offsets[-1] + len(nums) + 1)
        j = 0
        icept = raw["Intercept"]
        for c in cats:
            for lvl in di.domains[c]:
                beta[j] = raw[f"{c}.{lvl}"]
                j += 1
        for c in nums:
            b = raw[c]
            if destd:
                s = max(di.sigmas[c], 1e-10)
                beta[j] = b / s
                icept -= b * di.means[c] / s
            else:
                beta[j] = b
            j += 1
        beta[-1] = icept
    return cats, nums, cat_offsets, beta


def _export_glm_mojo(model, path: str) -> str:
    """hex/glm GlmMojoWriter: beta + cat offsets + link in [info]."""
    di = all_levels(model._dinfo)
    st = model._state
    assert st.family in ("gaussian", "binomial", "poisson", "gamma",
                         "tweedie", "multinomial"), \
        f"reference GLM MOJO export: unsupported family {st.family}"
    cats, nums, cat_offsets, beta = _glm_layout(model)
    resp = di.response_name
    columns = cats + nums + ([resp] if resp else [])
    nclasses = len(di.response_domain) if di.response_domain else 1
    category = ("Binomial" if nclasses == 2 else
                "Multinomial" if nclasses > 2 else "Regression")
    ini, kv = _ini_header("glm", "Generalized Linear Model", category,
                          nclasses, columns, len(cats) + len(nums))
    kv("use_all_factor_levels", "true")
    kv("cats", len(cats))
    # NA categoricals: the engine scores them as an all-zero indicator
    # row; imputing the (out-of-range) cardinality makes GlmMojoModel's
    # `ival < catOffsets[i+1]` guard skip the beta — zero contribution,
    # exactly the engine's semantics
    kv("cat_modes", _arr([di.cardinalities[c] for c in cats]))
    kv("cat_offsets", _arr(cat_offsets))
    kv("nums", len(nums))
    kv("num_means", _arr([float(di.means[c]) for c in nums]))
    kv("mean_imputation", "true" if di.impute_missing else "false")
    kv("beta", _arr([float(b) for b in beta]))
    kv("family", st.family)
    kv("link", st.link)
    kv("tweedie_link_power",
       float(model.params.get("tweedie_link_power") or 0.0))
    domains = {ci: list(di.domains[c]) for ci, c in enumerate(cats)}
    if resp and di.response_domain:
        domains[len(columns) - 1] = list(di.response_domain)
    return _finish_zip(path, ini, columns, domains)


def _export_kmeans_mojo(model, path: str) -> str:
    """hex/kmeans KMeansMojoWriter: centers + standardization in [info]."""
    di = model._dinfo
    assert not di.cat_cols, \
        "reference KMeans MOJO export covers numeric frames (categorical " \
        "columns go through the one-hot design here, which the genmodel " \
        "row codec does not mirror)"
    nums = list(di.num_cols)
    centers = _np(model._centroids).astype(np.float64)
    ini, kv = _ini_header("kmeans", "K-means", "Clustering", 1, nums,
                          len(nums), supervised=False)
    std = bool(model.params.get("standardize"))
    kv("standardize", "true" if std else "false")
    if std:
        kv("standardize_means", _arr([float(di.means[c]) for c in nums]))
        kv("standardize_mults",
           _arr([1.0 / max(float(di.sigmas[c]), 1e-10) for c in nums]))
        kv("standardize_modes", _arr([-1] * len(nums)))
    kv("center_num", centers.shape[0])
    for i in range(centers.shape[0]):
        kv(f"center_{i}", _arr([float(v) for v in centers[i]]))
    return _finish_zip(path, ini, nums, {})


def _export_dl_mojo(model, path: str) -> str:
    """hex/deeplearning DeeplearningMojoWriter: per-layer weight/bias
    arrays + input normalization in [info]."""
    di = model._dinfo
    act = str(model.params.get("activation") or "Rectifier")
    assert "Maxout" not in act, \
        "reference DL MOJO export: Maxout weight layout not covered"
    assert not model.params.get("autoencoder"), \
        "reference DL MOJO export covers supervised nets"
    params = [(_np(W).astype(np.float64), _np(b).astype(np.float64))
              for W, b in model._params_net]
    cats, nums = list(di.cat_cols), list(di.num_cols)
    # GenModel.setCats clamps NA (and out-of-range) categories onto the
    # LAST level of each factor; the engine scores NA cats as an all-zero
    # indicator. Export an explicit extra "NA" level per factor with a
    # ZERO weight row so both scorers agree exactly.
    cat_offsets = [0]
    for c in cats:
        cat_offsets.append(cat_offsets[-1] + di.cardinalities[c] + 1)
    if cats:
        W0, b0 = params[0]
        rows = []
        pos = 0
        for c in cats:
            card = di.cardinalities[c]
            rows.append(W0[pos: pos + card])
            rows.append(np.zeros((1, W0.shape[1])))      # the NA slot
            pos += card
        rows.append(W0[pos:])                            # numeric rows
        params[0] = (np.vstack(rows), b0)
    if not di.standardize and nums:
        # no norm arrays means genmodel maps a missing numeric to RAW 0,
        # while the engine imputes the training mean. Shift inputs by the
        # means (norm_sub=mean, norm_mul=1) and fold the shift into the
        # first-layer bias so non-missing rows are untouched and missing
        # ones land on the mean — exact on both sides.
        W0, b0 = params[0]
        means = np.array([float(di.means[c]) for c in nums])
        noff = cat_offsets[-1]
        params[0] = (W0, b0 + means @ W0[noff: noff + len(nums)])
    resp = di.response_name
    columns = cats + nums + ([resp] if resp else [])
    nclasses = len(di.response_domain) if di.response_domain else 1
    category = ("Binomial" if nclasses == 2 else
                "Multinomial" if nclasses > 2 else "Regression")
    ini, kv = _ini_header("deeplearning", "Deep Learning", category,
                          nclasses, columns, len(cats) + len(nums))
    units = [params[0][0].shape[0]] + [b.shape[0] for _, b in params]
    kv("mini_batch_size", 1)
    kv("nums", len(nums))
    kv("cats", len(cats))
    kv("cat_offsets", _arr(cat_offsets))
    if di.standardize:
        kv("norm_sub", _arr([float(di.means[c]) for c in nums]))
        kv("norm_mul",
           _arr([1.0 / max(float(di.sigmas[c]), 1e-10) for c in nums]))
    else:
        # bias-folded mean shift (see above): missing -> post-norm 0 ==
        # the training mean, non-missing values reproduce exactly
        kv("norm_sub", _arr([float(di.means[c]) for c in nums]))
        kv("norm_mul", _arr([1.0] * len(nums)))
    kv("norm_resp_mul", "null")
    kv("norm_resp_sub", "null")
    kv("use_all_factor_levels", "true")
    kv("activation", act)
    kv("mean_imputation", "true" if di.impute_missing else "false")
    kv("cat_modes", _arr([di.cardinalities[c] for c in cats]))
    kv("distribution", "bernoulli" if nclasses == 2 else
       "multinomial" if nclasses > 2 else "gaussian")
    kv("neural_network_sizes", _arr(units))
    kv("hidden_dropout_ratios", _arr([]))
    for li, (W, b) in enumerate(params):
        kv(f"bias_layer{li}", _arr([float(v) for v in b]))
        # genmodel weight layout is (out, in) row-major; ours is (in, out)
        kv(f"weight_layer{li}",
           _arr([float(v) for v in W.T.reshape(-1)]))
    domains = {ci: list(di.domains[c]) for ci, c in enumerate(cats)}
    if resp and di.response_domain:
        domains[len(columns) - 1] = list(di.response_domain)
    return _finish_zip(path, ini, columns, domains)


# ===========================================================================
# Non-tree oracles: bit-faithful score0 re-implementations
def _parse_arr(s, dtype=float):
    s = s.strip()
    if s in ("null", "[]", ""):
        return np.array([], np.float64 if dtype is float else np.int64)
    vals = [x.strip() for x in s.strip("[]").split(",") if x.strip()]
    return np.array([dtype(v) for v in vals],
                    np.float64 if dtype is float else np.int64)


class H2OGlmMojoOracle:
    """GlmMojoModel/GlmMultinomialMojoModel.glmScore0 re-implemented
    exactly (float64, same eta accumulation order per class)."""

    def __init__(self, info):
        self.beta = _parse_arr(info["beta"])
        self.cat_offsets = _parse_arr(info.get("cat_offsets", "[]"), int)
        self.cats = int(info.get("cats", 0))
        self.nums = int(info.get("nums", 0))
        self.num_means = _parse_arr(info.get("num_means", "[]"))
        self.cat_modes = _parse_arr(info.get("cat_modes", "[]"), int)
        self.mean_imputation = info.get("mean_imputation") == "true"
        self.use_all = info.get("use_all_factor_levels", "true") == "true"
        self.family = info.get("family", "gaussian")
        self.link = info.get("link", "identity")
        self.tweedie_link_power = float(
            info.get("tweedie_link_power") or 0.0)
        self.n_classes = int(info.get("n_classes", 1))

    def _link_eval(self, eta):
        if self.link in ("identity", "family_default"):
            return eta
        if self.link == "logit":
            return 1.0 / (1.0 + np.exp(-eta))
        if self.link == "log":
            return np.exp(eta)
        if self.link == "inverse":
            xx = np.where(np.abs(eta) < 1e-5, np.sign(eta) * 1e-5, eta)
            return 1.0 / xx
        if self.link == "ologit":
            return 1.0 / (1.0 + np.exp(-eta))
        if self.link == "tweedie":
            # GenModel.GLM_tweedieInv
            p = self.tweedie_link_power
            if p == 0:
                return np.maximum(2e-16, np.exp(eta))
            return np.power(eta, 1.0 / p)
        raise NotImplementedError(self.link)

    def predict_raw(self, X):
        """X (n, cats+nums): cat level codes then raw numerics."""
        X = np.array(X, np.float64, copy=True)
        if self.mean_imputation:
            for i in range(self.cats):
                X[np.isnan(X[:, i]), i] = self.cat_modes[i]
            for i in range(self.nums):
                j = self.cats + i
                X[np.isnan(X[:, j]), j] = self.num_means[i]
        n = X.shape[0]
        if self.family == "multinomial":
            K = self.n_classes
            P = len(self.beta) // K
            etas = np.zeros((n, K))
            for k in range(K):
                b = self.beta[k * P:(k + 1) * P]
                etas[:, k] = self._eta(X, b)
            m = np.maximum(etas.max(1), 0.0)       # reference max_row
            #                                         starts at 0
            E = np.exp(etas - m[:, None])
            return E / E.sum(1, keepdims=True)
        mu = self._link_eval(self._eta(X, self.beta))
        if self.family in ("binomial", "fractionalbinomial"):
            return np.stack([1.0 - mu, mu], 1)
        return mu

    def _eta(self, X, beta):
        n = X.shape[0]
        eta = np.zeros(n)
        noff = (self.cat_offsets[self.cats] - self.cats
                if self.cats else 0)
        for i in range(self.cats):
            raw = X[:, i]
            # un-imputed NaN contributes nothing (engine zero-row parity)
            raw = np.where(np.isnan(raw), -(1 << 30), raw)
            ival = raw.astype(np.int64) + (0 if self.use_all else -1)
            ival = ival + self.cat_offsets[i]
            ok = (ival < self.cat_offsets[i + 1]) & \
                (ival >= self.cat_offsets[i])
            if not self.use_all:
                ok &= X[:, i] != 0
            eta += np.where(ok, beta[np.clip(ival, 0, len(beta) - 1)], 0.0)
        for i in range(self.cats, len(beta) - 1 - noff):
            eta += beta[noff + i] * X[:, self.cats + (i - self.cats)]
        return eta + beta[-1]


class H2OKMeansMojoOracle:
    """KMeansMojoModel.score0: Kmeans_preprocessData + KMeans_closest."""

    def __init__(self, info):
        self.standardize = info.get("standardize") == "true"
        k = int(info["center_num"])
        self.centers = np.stack([_parse_arr(info[f"center_{i}"])
                                 for i in range(k)])
        if self.standardize:
            self.means = _parse_arr(info["standardize_means"])
            self.mults = _parse_arr(info["standardize_mults"])
            self.modes = _parse_arr(info["standardize_modes"], int)

    def predict_raw(self, X):
        X = np.array(X, np.float64, copy=True)
        if self.standardize:
            for i in range(X.shape[1]):
                if self.modes[i] == -1:
                    na = np.isnan(X[:, i])
                    X[na, i] = self.means[i]
                    X[:, i] = (X[:, i] - self.means[i]) * self.mults[i]
                else:
                    X[np.isnan(X[:, i]), i] = self.modes[i]
        d2 = ((X[:, None, :] - self.centers[None, :, :]) ** 2).sum(-1)
        return d2.argmin(1)


class H2ODlMojoOracle:
    """DeeplearningMojoModel.score0: one-hot cats, normalized nums,
    dense layers with the stored activation, softmax for classifiers."""

    def __init__(self, info):
        self.cats = int(info.get("cats", 0))
        self.nums = int(info.get("nums", 0))
        self.cat_offsets = _parse_arr(info.get("cat_offsets", "[]"), int)
        self.norm_sub = _parse_arr(info.get("norm_sub", "[]"))
        self.norm_mul = _parse_arr(info.get("norm_mul", "[]"))
        self.cat_modes = _parse_arr(info.get("cat_modes", "[]"), int)
        self.mean_imputation = info.get("mean_imputation") == "true"
        self.activation = info.get("activation", "Rectifier")
        self.units = _parse_arr(info["neural_network_sizes"], int)
        self.n_classes = int(info.get("n_classes", 1))
        self.layers = []
        li = 0
        while f"weight_layer{li}" in info:
            W = _parse_arr(info[f"weight_layer{li}"])
            b = _parse_arr(info[f"bias_layer{li}"])
            nin, nout = self.units[li], self.units[li + 1]
            # stored (out, in) row-major -> back to (in, out)
            self.layers.append((W.reshape(nout, nin).T, b))
            li += 1

    def _act(self, z):
        if "Rectifier" in self.activation:
            return np.maximum(z, 0.0)
        if "Tanh" in self.activation:
            return np.tanh(z)
        raise NotImplementedError(self.activation)

    def predict_raw(self, X):
        X = np.array(X, np.float64, copy=True)
        n = X.shape[0]
        ncat_in = int(self.cat_offsets[-1]) if self.cats else 0
        H = np.zeros((n, ncat_in + self.nums))
        for i in range(self.cats):
            codes = X[:, i]
            # GenModel.setCats: NaN -> the extra trailing NA level;
            # out-of-range clamps onto that same last slot
            idx = np.where(np.isnan(codes), self.cat_offsets[i + 1] - 1,
                           np.nan_to_num(codes) + self.cat_offsets[i])
            idx = np.minimum(idx, self.cat_offsets[i + 1] - 1).astype(np.int64)
            H[np.arange(n), idx] = 1.0
        for i in range(self.nums):
            v = X[:, self.cats + i]
            if len(self.norm_sub):
                v = (v - self.norm_sub[i]) * self.norm_mul[i]
            H[:, ncat_in + i] = np.nan_to_num(v)
        for W, b in self.layers[:-1]:
            H = self._act(H @ W + b)
        W, b = self.layers[-1]
        out = H @ W + b
        if self.n_classes >= 2:
            out = out - out.max(1, keepdims=True)
            E = np.exp(out)
            return E / E.sum(1, keepdims=True)
        return out[:, 0]


_ORACLES = {"glm": H2OGlmMojoOracle, "kmeans": H2OKMeansMojoOracle,
            "deeplearning": H2ODlMojoOracle}


def import_h2o_mojo_any(path: str):
    """Dispatch loader: tree MOJOs go through the engine's batch walk
    (import_h2o_mojo); GLM/KMeans/DL go to the exact-score0 oracles."""
    with zipfile.ZipFile(path) as z:
        info, _, _ = _parse_ini(z.read("model.ini").decode("utf-8",
                                                           "replace"))
    algo = info.get("algo", "gbm")
    if algo in _ORACLES:
        return _ORACLES[algo](info)
    return import_h2o_mojo(path)

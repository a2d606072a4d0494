"""POJO export of the port (h2o3_tpu/genmodel/pojo.py): dependency-free
Java scoring source.

Reference: water/util/JCodeGen.java + hex/tree/TreeJCodeGen.java (every model
can emit a compilable Java class implementing `score0(double[] data,
double[] preds)`, downloadable at /3/Models/{id}/java); h2o-py
`model.download_pojo`.

Design: rather than H2O's unrolled if/else per tree node (TreeJCodeGen splits
giant trees into nested classes to stay under javac's 64KB method limit), the
trees are emitted as static data arrays + a 20-line heap-walk loop — same
dense heap-order layout the tree engines train (engine.py TreeArrays), so the
generated Java is tiny, compiles for any ensemble size, and matches device
scoring bit-for-bit at f32. GLM emits coefficients + link; KMeans emits
centroids + nearest-centroid loop.

In the port the arrays come off the model's device; a GLM of the reduced
design is written in the all-levels layout (the dropped level's
coefficient 0, `mojo.all_levels`), and its link is the fitted family's
(the JAX package reads the `family` parameter, which is "AUTO" unless
set, and then writes the identity link for every family)."""

from __future__ import annotations

import numpy as np

from h2o3_tpu_torch.genmodel.mojo import _np, all_levels, full_coefficients


def _jarr(a, fmt="%.9g", per_line=8) -> str:
    vals = [fmt % v for v in _np(a).ravel()]
    lines = [", ".join(vals[i:i + per_line])
             for i in range(0, len(vals), per_line)]
    return ",\n      ".join(lines)


def _class_name(model) -> str:
    raw = model.model_id or f"{model.algo}_pojo"
    return "".join(ch if ch.isalnum() else "_" for ch in raw)


def _header(model, cls):
    names = all_levels(model._dinfo).feature_names
    dom = model._dinfo.response_domain
    return f"""/*
  Licensed under the Apache License, Version 2.0
  POJO scoring class generated by h2o3_tpu (water/util/JCodeGen analog).
  Model: {model.model_id}  algo: {model.algo}
  Usage: double[] preds = new double[{(len(dom) + 1) if dom else 1}];
         new {cls}().score0(row, preds);
*/
public class {cls} {{
  public static final String[] NAMES = {{ {", ".join('"%s"' % n for n in names)} }};
  public static final String[] DOMAIN = {("{ " + ", ".join('"%s"' % d for d in dom) + " }") if dom else "null"};
"""


def _tree_block(trees, prefix):
    col = _np(trees.col).astype(np.int32)
    thr = _np(trees.thr).astype(np.float64)
    nal = _np(trees.na_left).astype(np.int8)
    val = _np(trees.value).astype(np.float64)
    T, nodes = col.shape
    return f"""
  static final int {prefix}_NTREES = {T};
  static final int {prefix}_NODES = {nodes};
  static final int {prefix}_DEPTH = {trees.depth};
  static final int[] {prefix}_COL = {{
      {_jarr(col, "%d")} }};
  static final float[] {prefix}_THR = {{
      {_jarr(thr, "%.9gf")} }};
  static final byte[] {prefix}_NAL = {{
      {_jarr(nal, "%d")} }};
  static final float[] {prefix}_VAL = {{
      {_jarr(val, "%.9gf")} }};

  static double {prefix}_score(double[] data) {{
    double acc = 0.0;
    for (int t = 0; t < {prefix}_NTREES; t++) {{
      int base = t * {prefix}_NODES;
      int node = 0;
      for (int d = 0; d < {prefix}_DEPTH; d++) {{
        int c = {prefix}_COL[base + node];
        if (c < 0) break;
        double x = data[c];
        boolean right = Double.isNaN(x) ? ({prefix}_NAL[base + node] == 0)
                                        : (x > {prefix}_THR[base + node]);
        node = 2 * node + 1 + (right ? 1 : 0);
      }}
      acc += {prefix}_VAL[base + node];
    }}
    return acc;
  }}
"""


def _pojo_tree(model) -> str:
    cls = _class_name(model)
    out = [_header(model, cls)]
    is_drf = model.algo == "drf"
    lr = 1.0 if is_drf else float(model.params["learn_rate"])
    if getattr(model, "_trees_k", None) is not None:     # multinomial
        K = len(model._trees_k)
        for k in range(K):
            out.append(_tree_block(model._trees_k[k], f"T{k}"))
        f0 = (np.zeros(K) if is_drf or model.algo == "xgboost"
              else np.asarray(model._f0, np.float64))
        ntr = model._trees_k[0].ntrees
        out.append(f"""
  static final double[] F0 = {{ {_jarr(f0)} }};
  public double[] score0(double[] data, double[] preds) {{
    double[] f = new double[{K}];
""")
        for k in range(K):
            if is_drf:
                out.append(f"    f[{k}] = T{k}_score(data) / {ntr}.0;\n")
            else:
                out.append(f"    f[{k}] = F0[{k}] + {lr} * T{k}_score(data);\n")
        if is_drf:
            out.append(f"""    double s = 0; for (int k = 0; k < {K}; k++) {{ if (f[k] < 0) f[k] = 0; s += f[k]; }}
    if (s <= 0) s = 1;
    for (int k = 0; k < {K}; k++) preds[1 + k] = f[k] / s;
""")
        else:
            out.append(f"""    double mx = f[0]; for (int k = 1; k < {K}; k++) if (f[k] > mx) mx = f[k];
    double s = 0; for (int k = 0; k < {K}; k++) {{ f[k] = Math.exp(f[k] - mx); s += f[k]; }}
    for (int k = 0; k < {K}; k++) preds[1 + k] = f[k] / s;
""")
        out.append(f"""    int best = 0; for (int k = 1; k < {K}; k++) if (preds[1 + k] > preds[1 + best]) best = k;
    preds[0] = best;
    return preds;
  }}
}}
""")
        return "".join(out)

    out.append(_tree_block(model._trees, "T"))
    dist = getattr(model, "_dist", "gaussian")
    f0 = float(getattr(model, "_f0", 0.0) or 0.0)
    if is_drf:
        ntr = model._trees.ntrees
        if model._is_classifier:
            body = f"""    double p = T_score(data) / {ntr}.0;
    if (p < 0) p = 0; if (p > 1) p = 1;
    preds[1] = 1 - p; preds[2] = p;
    preds[0] = p >= 0.5 ? 1 : 0;"""
        else:
            body = f"    preds[0] = T_score(data) / {ntr}.0;"
    elif dist in ("bernoulli", "quasibinomial"):
        body = f"""    double fx = {f0} + {lr} * T_score(data);
    double p = 1.0 / (1.0 + Math.exp(-fx));
    preds[1] = 1 - p; preds[2] = p;
    preds[0] = p >= 0.5 ? 1 : 0;"""
    elif dist in ("poisson", "gamma", "tweedie"):
        body = f"    preds[0] = Math.exp({f0} + {lr} * T_score(data));"
    else:
        body = f"    preds[0] = {f0} + {lr} * T_score(data);"
    out.append(f"""
  public double[] score0(double[] data, double[] preds) {{
{body}
    return preds;
  }}
}}
""")
    return "".join(out)


def _glm_raw_beta(model):
    """Coefficients in RAW input space ([coefs..., intercept]); GLM stores
    both raw and standardized — raw means score0 takes unscaled rows."""
    di = all_levels(model._dinfo)
    names = list(di.feature_names) + ["Intercept"]
    coefs = full_coefficients(model._coefficients, di.feature_names)
    if isinstance(next(iter(coefs.values())), list):   # multinomial (K per name)
        K = len(next(iter(coefs.values())))
        return np.asarray([[coefs[n][k] for n in names] for k in range(K)],
                          np.float64)
    return np.asarray([coefs[n] for n in names], np.float64)


def _pojo_glm(model) -> str:
    cls = _class_name(model)
    di = all_levels(model._dinfo)
    beta = _glm_raw_beta(model)
    fam = model._state.family
    out = [_header(model, cls)]
    if beta.ndim == 1:
        out.append(f"""
  static final double[] BETA = {{ {_jarr(beta)} }};   // [coefs..., intercept]
  public double[] score0(double[] data, double[] preds) {{
    double eta = BETA[BETA.length - 1];
    for (int j = 0; j < BETA.length - 1; j++) eta += BETA[j] * data[j];
""")
        if fam == "binomial":
            out.append("""    double p = 1.0 / (1.0 + Math.exp(-eta));
    preds[1] = 1 - p; preds[2] = p; preds[0] = p >= 0.5 ? 1 : 0;
""")
        elif fam in ("poisson", "gamma", "tweedie", "negativebinomial"):
            out.append("    preds[0] = Math.exp(eta);\n")
        else:
            out.append("    preds[0] = eta;\n")
        out.append("    return preds;\n  }\n}\n")
    else:  # multinomial: beta (K, P+1), coefficients in standardized space
        K = beta.shape[0]
        mean, sig = _standardization_vectors(di)
        out.append(f"""
  static final double[] BETA = {{ {_jarr(beta)} }};   // (K, P+1) row-major
  static final double[] MEAN = {{ {_jarr(mean)} }};
  static final double[] SIGMA = {{ {_jarr(sig)} }};
  static final int K = {K};
  public double[] score0(double[] data, double[] preds) {{
    int P1 = BETA.length / K;
    double mx = -1e308;
    double[] eta = new double[K];
    for (int k = 0; k < K; k++) {{
      double e = BETA[k * P1 + P1 - 1];
      for (int j = 0; j < P1 - 1; j++)
        e += BETA[k * P1 + j] * (data[j] - MEAN[j]) / SIGMA[j];
      eta[k] = e; if (e > mx) mx = e;
    }}
    double s = 0;
    for (int k = 0; k < K; k++) {{ eta[k] = Math.exp(eta[k] - mx); s += eta[k]; }}
    int best = 0;
    for (int k = 0; k < K; k++) {{
      preds[1 + k] = eta[k] / s;
      if (preds[1 + k] > preds[1 + best]) best = k;
    }}
    preds[0] = best;
    return preds;
  }}
}}
""")
    return "".join(out)


def _standardization_vectors(di):
    """Per-design-column (mean, sigma) — identity for one-hot cat slots,
    DataInfo stats for numerics (only meaningful when di.standardize)."""
    ncat = sum(di.cardinalities.get(c, 0) for c in di.cat_cols)
    P = len(di.feature_names)
    mean = np.zeros(P)
    sig = np.ones(P)
    if di.standardize:
        for j in range(ncat, P):
            cname = di.num_cols[j - ncat]
            mean[j] = di.means[cname]
            sig[j] = max(di.sigmas[cname], 1e-10)
    return mean, sig


def _pojo_kmeans(model) -> str:
    cls = _class_name(model)
    di = model._dinfo
    cent = _np(model._centroids).astype(np.float64)   # standardized space
    mean, sig = _standardization_vectors(di)
    K, P = cent.shape
    out = [_header(model, cls)]
    out.append(f"""
  static final double[] CENTERS = {{ {_jarr(cent)} }};   // (K={K}, P={P}) standardized
  static final double[] MEAN = {{ {_jarr(mean)} }};
  static final double[] SIGMA = {{ {_jarr(sig)} }};
  public double[] score0(double[] data, double[] preds) {{
    int best = 0; double bd = Double.MAX_VALUE;
    for (int k = 0; k < {K}; k++) {{
      double d = 0;
      for (int j = 0; j < {P}; j++) {{
        double diff = (data[j] - MEAN[j]) / SIGMA[j] - CENTERS[k * {P} + j];
        d += diff * diff;
      }}
      if (d < bd) {{ bd = d; best = k; }}
    }}
    preds[0] = best;
    return preds;
  }}
}}
""")
    return "".join(out)


def export_pojo(model, path: str) -> str:
    """model.download_pojo analog: write <ClassName>.java and return path."""
    algo = model.algo
    if algo in ("gbm", "drf", "xgboost", "isolationforest"):
        src = _pojo_tree(model)
    elif algo == "glm":
        src = _pojo_glm(model)
    elif algo == "kmeans":
        src = _pojo_kmeans(model)
    else:
        raise NotImplementedError(f"POJO export not supported for {algo}")
    import os
    if os.path.isdir(path):
        path = os.path.join(path, _class_name(model) + ".java")
    with open(path, "w") as f:
        f.write(src)
    return path

"""GAM of the port (h2o3_tpu/models/gam.py; hex/gam/GAM.java): generalized
additive models as spline basis columns fitted by GLM.

Each of `gam_columns` becomes cubic-regression-spline basis columns in the
value-at-knots parametrization (Wood 2006 §4.1.2; GamSplines/
CubicRegressionSpline), with the exact curvature penalty S = Dᵀ B⁻¹ D
(∫ f″² over the knots' range), centred against the intercept (Σᵢ f(xᵢ) =
0), and the port's GLM fits the design with each block's penalty, times
its `scale`, folded into the normal equations (`quadratic_penalty`).
With one gaussian gam column, knots at the data points and scale = λ,
this is the classical smoothing spline.

The basis is built in float64 on the frame's device; the K×K penalty,
its banded factors and the centring's null space are host-sized and stay
in float64 on the CPU. The knots are the column's quantiles at
linspace(0, 1, k), numpy's linear interpolation, less repeats. The GLM
under GAM takes the port's reduced one-hot design for categorical
predictors beside the basis; multinomial and intercept=False raise there,
as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from h2o3_tpu_torch.core.frame import Frame, Vec
from h2o3_tpu_torch.core.kvstore import DKV
from h2o3_tpu_torch.models.glm import H2OGeneralizedLinearEstimator
from h2o3_tpu_torch.models.model import ModelBase


def crs_design_and_penalty(x: torch.Tensor, knots: torch.Tensor):
    """The cubic regression spline of x (float64, NaN = NA) on `knots`
    (float64, CPU). Returns (X, S): X (n, K) on x's device maps the knot
    values γ to f(xᵢ); S (K, K) on the CPU is the curvature penalty
    ∫ f″(t)² dt = γᵀSγ, S = Dᵀ B⁻¹ D."""
    k = knots.double().cpu()
    K = k.shape[0]
    h = k[1:] - k[:-1]                               # (K-1,)
    # banded D (K-2, K) and B (K-2, K-2)
    D = torch.zeros((K - 2, K), dtype=torch.float64)
    B = torch.zeros((K - 2, K - 2), dtype=torch.float64)
    for i in range(K - 2):
        D[i, i] = 1.0 / h[i]
        D[i, i + 1] = -1.0 / h[i] - 1.0 / h[i + 1]
        D[i, i + 2] = 1.0 / h[i + 1]
        B[i, i] = (h[i] + h[i + 1]) / 3.0
        if i + 1 < K - 2:
            B[i, i + 1] = B[i + 1, i] = h[i + 1] / 6.0
    Binv_D = torch.linalg.solve(B, D)                # (K-2, K)
    S = D.T @ Binv_D
    # F maps the values γ to the second derivatives at every knot
    # (natural ends: zero curvature at the end knots)
    F = torch.zeros((K, K), dtype=torch.float64)
    F[1:-1] = Binv_D
    dev = x.device
    kd, hd, Fd = k.to(dev), h.to(dev), F.to(dev)
    xc = torch.nan_to_num(x.double(), nan=float(k.mean()))
    xc = xc.clamp(float(k[0]), float(k[-1]))         # natural-spline clamp
    j = (torch.searchsorted(kd, xc, right=True) - 1).clamp(0, K - 2)
    hj = hd[j]
    lo, hi = kd[j], kd[j + 1]
    am = (hi - xc) / hj
    ap = (xc - lo) / hj
    cm = ((hi - xc) ** 3 / hj - hj * (hi - xc)) / 6.0
    cp = ((xc - lo) ** 3 / hj - hj * (xc - lo)) / 6.0
    n = xc.shape[0]
    rows = torch.arange(n, device=dev)
    X = torch.zeros((n, K), dtype=torch.float64, device=dev)
    X[rows, j] += am
    X[rows, j + 1] += ap
    X += cm[:, None] * Fd[j] + cp[:, None] * Fd[j + 1]
    return X, S


def _centering_transform(X: torch.Tensor) -> torch.Tensor:
    """The identifiability constraint Σᵢ f(xᵢ) = 0: Z (K, K-1) on the CPU,
    the null space of 1ᵀX from a full SVD of the 1×K constraint."""
    c = X.sum(dim=0, keepdim=True).cpu()
    _, _, vt = torch.linalg.svd(c, full_matrices=True)
    return vt[1:].T.contiguous()


def _nanquantile(x: torch.Tensor, qs) -> torch.Tensor:
    """numpy.nanquantile(x, qs) of the default (linear) method, in float64
    on the CPU: the non-NA values sorted on their device, the virtual
    index (m-1)·q, and numpy's two-sided lerp."""
    v = torch.sort(x[~torch.isnan(x)].double()).values
    m = v.shape[0]
    qs = np.asarray(qs, np.float64)
    virt = (m - 1) * qs
    prev = np.clip(np.floor(virt).astype(np.int64), 0, m - 1)
    nxt = np.clip(prev + 1, 0, m - 1)
    a = v[torch.from_numpy(prev).to(v.device)].cpu().numpy()
    b = v[torch.from_numpy(nxt).to(v.device)].cpu().numpy()
    t = virt - prev
    diff = b - a
    out = a + diff * t
    hi = t >= 0.5
    out[hi] = (b - diff * (1 - t))[hi]
    return torch.from_numpy(out)


class H2OGeneralizedAdditiveEstimator(ModelBase):
    algo = "gam"
    _defaults = dict(H2OGeneralizedLinearEstimator._defaults)
    _defaults.update({"gam_columns": None, "num_knots": None,
                      "scale": None, "bs": None, "spline_orders": None})

    def train(self, x=None, y=None, training_frame=None,
              validation_frame=None, **kw):
        self.params.update(kw)
        gam_cols = self.params.get("gam_columns") or []
        gam_cols = [c[0] if isinstance(c, list) else c for c in gam_cols]
        nk = self.params.get("num_knots") or [6] * len(gam_cols)
        scales = self.params.get("scale") or [1.0] * len(gam_cols)
        frame = training_frame
        self._gam_cols = gam_cols
        self._knots, self._Z, self._S, self._basis_names = {}, {}, {}, {}
        aug = self._augment(frame, gam_cols, nk, fit=True)
        vaug = None
        if validation_frame is not None:
            vaug = self._augment(validation_frame, gam_cols, nk, fit=False)
        xx = list(x) if x is not None else [c for c in frame.names if c != y]
        xx = [c for c in xx if c not in gam_cols] + \
            [n for c in gam_cols for n in self._basis_names[c]]
        glm_params = {k: v for k, v in self.params.items()
                      if k in H2OGeneralizedLinearEstimator._defaults
                      or k in H2OGeneralizedLinearEstimator._COMMON}
        # named penalty blocks: the GLM indexes them into its own design
        # (and rescales them for its standardisation)
        glm_params["quadratic_penalty"] = [
            (self._basis_names[c],
             (float(scales[ci]) if ci < len(scales) else 1.0)
             * (self._Z[c].T @ self._S[c] @ self._Z[c]).numpy())
            for ci, c in enumerate(gam_cols)]
        self._glm = H2OGeneralizedLinearEstimator(**glm_params)
        self._glm.train(x=xx, y=y, training_frame=aug,
                        validation_frame=vaug)
        self.key = self.params.get("model_id") or self._glm.key + "_gam"
        self._output = self._glm._output
        self._dinfo = self._glm._dinfo
        for f in (aug, vaug):
            if f is not None:
                DKV.remove(f.key)
        DKV.put(self.key, self)
        return self

    def _augment(self, frame: Frame, gam_cols, nk, fit: bool) -> Frame:
        """The frame's columns and each gam column's centred basis columns
        (f32 Vecs on the frame's device)."""
        out = Frame(list(frame.names), list(frame.vecs))
        for ci, c in enumerate(gam_cols):
            xcol = frame.vec(c).as_f32().double()
            if fit:
                k = int(nk[ci]) if ci < len(nk) else 6
                knots = torch.unique(_nanquantile(
                    xcol, np.linspace(0.0, 1.0, k)))
                if knots.shape[0] < 3:
                    raise ValueError(
                        f"gam column {c!r} has {knots.shape[0]} distinct "
                        "knot value(s); a cubic regression spline needs "
                        ">= 3 (constant or near-constant column: drop "
                        "it from gam_columns)")
                self._knots[c] = knots
            B, S = crs_design_and_penalty(xcol, self._knots[c])
            if fit:
                self._S[c] = S
                self._Z[c] = _centering_transform(B)
                self._basis_names[c] = [
                    f"{c}_gam{j}" for j in range(self._Z[c].shape[1])]
            Bz = B @ self._Z[c].to(B.device)
            del B
            for j, bn in enumerate(self._basis_names[c]):
                out[bn] = Vec.from_tensor(Bz[:, j])
        return out

    def _score_frame(self, test_data: Frame) -> Frame:
        return self._augment(test_data, self._gam_cols, [], fit=False)

    def predict(self, test_data: Frame) -> Frame:
        aug = self._score_frame(test_data)
        try:
            return self._glm.predict(aug)
        finally:
            DKV.remove(aug.key)

    def model_performance(self, test_data=None):
        if test_data is None:
            return self._output.training_metrics
        aug = self._score_frame(test_data)
        try:
            return self._glm._compute_metrics(aug)
        finally:
            DKV.remove(aug.key)

    def coef(self):
        return self._glm.coef()

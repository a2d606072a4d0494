"""GLM of the port (h2o3_tpu/models/glm.py, hex/glm/GLM.java): IRLS whose
weighted Gram is one matrix product over the rows on the device.

Each IRLS iteration makes three passes over the rows on the device: the
linear predictor (`_eta_pass`), the working weights and response
(`_irls_weights`), and the Gram G = XᵀWX with q = XᵀWz (`_gram_pass`, in
f32; TF32 must stay off, or cuBLAS rounds every product of X to 10
mantissa bits). G and q then go to the host, where the solve runs in
float64 numpy exactly as in the reference: a Cholesky-free
`np.linalg.solve`, or cyclic coordinate descent on the Gram (`_cod_solve`)
for L1, elastic net, lambda search and bounds. Multinomial is per-class
block-coordinate IRLS, one Gram a class a sweep (`_class_gram`). L-BFGS
(`_lbfgs`, on the host) takes the value and gradient of the penalised
negative log-likelihood from one device pass under torch.autograd
(`_nll_value_grad`, `_ordinal_value_grad`).

The design is reduced where the JAX package's is singular: with an
intercept (or the ordinal thresholds, which play its part), each
categorical predictor without NA in the training frame loses its first
level's column (`DataInfo.drop_first`), as in H2O. The JAX package keeps
every level beside the intercept, so at its default lambda 0 it solves a
singular system whose null direction f32 rounding decides; the fitted
probabilities agree on the levels both know, the coefficients do not.

A frame whose predictors are all SparseVecs takes the sparse path
(`_sparse_path_ok`, `_fit_sparse`): L-BFGS on the COO form in raw
feature space, where the linear predictor and the gradient are sums over
the nonzeros and neither the dense design nor the Gram is built
(`_SparseDesign`). Those sums are made deterministic on the card: each is
a float64 prefix sum over a fixed order (the nonzeros by row for η, by
column for the gradient, as `Frame.sparse_coo` returns them, scanned a
block at a time by `_prefix_sums`) differenced at the segment ends,
where `index_add_` would sum in the order its atomics land.
`predict_sparse` and the sparse `_compute_metrics` score the same way.
Each IRLSM iteration (a multinomial sweep) is a `glm.irlsm` span and one
count of `h2o3_glm_irlsm_iterations_total`, as in the JAX package.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from h2o3_tpu_torch.core.frame import Frame
from h2o3_tpu_torch.models.model import ModelBase, _dev_f32
from h2o3_tpu_torch.obs import metrics as _om
from h2o3_tpu_torch.obs.timeline import span as _span

_IRLSM_ITERS = _om.counter("h2o3_glm_irlsm_iterations_total",
                           "IRLSM iterations across all GLM fits")

# ---------------------------------------------------------------------------
# Families and links (hex/glm/GLMModel.GLMParameters.Family)
GAUSSIAN, BINOMIAL, QUASIBINOMIAL, POISSON, GAMMA, TWEEDIE, NEGBINOMIAL, \
    MULTINOMIAL, ORDINAL = ("gaussian", "binomial", "quasibinomial", "poisson",
                            "gamma", "tweedie", "negativebinomial",
                            "multinomial", "ordinal")

_CANONICAL_LINK = {GAUSSIAN: "identity", BINOMIAL: "logit",
                   QUASIBINOMIAL: "logit", POISSON: "log", GAMMA: "inverse",
                   TWEEDIE: "tweedie", NEGBINOMIAL: "log",
                   MULTINOMIAL: "multinomial", ORDINAL: "ologit"}


def _linkinv(link, eta, tweedie_link_power=1.0):
    if link == "identity":
        return eta
    if link == "logit":
        return torch.sigmoid(eta)
    if link == "log":
        return torch.exp(eta)
    if link == "inverse":
        safe = torch.where(eta.abs() < 1e-8, torch.sign(eta) * 1e-8 + 1e-12,
                           eta)
        return 1.0 / safe
    if link == "tweedie":
        lp = tweedie_link_power
        return torch.exp(eta) if lp == 0 else \
            torch.pow(torch.clamp(eta, min=1e-10), 1.0 / lp)
    raise ValueError(link)


# ---------------------------------------------------------------------------
def _gram_pass(X, w, z):
    """GLMIterationTask: G = XᵀWX and q = XᵀWz, f32 on X's device. Xw is
    materialised (one more (n, p) matrix), as in the reference."""
    Xw = X * w[:, None]
    return X.T @ Xw, Xw.T @ z


def _irls_weights(family, link, eta, y, w_obs, tweedie_var_power=1.5,
                  theta=1.0):
    """Working weights and response of one IRLS step (GLMTask
    computeWeights)."""
    mu = _linkinv(link, eta)
    if family == GAUSSIAN:
        return w_obs, y if link == "identity" else eta + (y - mu)
    if family in (BINOMIAL, QUASIBINOMIAL):
        # f32-safe clip: 1-1e-8 rounds to 1.0 in f32 and zeroes the variance
        mu = torch.clamp(mu, 1e-6, 1 - 1e-6)
        d = torch.clamp(mu * (1 - mu), min=1e-6)
        return w_obs * d, eta + (y - mu) / d
    if family == POISSON:
        mu = torch.clamp(mu, min=1e-8)
        return w_obs * mu, eta + (y - mu) / mu
    if family == GAMMA:
        mu = torch.clamp(mu, min=1e-8)
        if link == "log":
            return w_obs, eta + (y - mu) / mu
        return w_obs * mu * mu, eta - (y - mu) / (mu * mu)
    if family == TWEEDIE:
        mu = torch.clamp(mu, min=1e-8)
        return w_obs * torch.pow(mu, 2.0 - tweedie_var_power), \
            eta + (y - mu) / mu
    if family == NEGBINOMIAL:
        mu = torch.clamp(mu, min=1e-8)
        return w_obs * mu / (1.0 + theta * mu), eta + (y - mu) / mu
    raise ValueError(family)


def _eta_pass(X, beta):
    return X @ beta


def _host_gram(G, q):
    """The device Gram and right-hand side as float64 numpy (one copy)."""
    return G.double().cpu().numpy(), q.double().cpu().numpy()


def _soft(x, t):
    return math.copysign(max(abs(x) - t, 0.0), x)


def _cod_solve(G, q, lam, alpha, p_pen, beta0, tol=1e-8, max_sweeps=1000,
               lo=None, hi=None):
    """Cyclic coordinate descent on the Gram (GLM.java:1870 COD solver).

    Minimizes ½βᵀGβ − qᵀβ + λα‖β_pen‖₁ + ½λ(1−α)‖β_pen‖², on the host (p
    is small). Columns from p_pen on (the intercept) are not penalised.
    With lo/hi, each coordinate update is clipped into its box: projected
    coordinate descent, the beta_constraints solver (exact for separable
    boxes).
    """
    p = len(q)
    beta = beta0.copy()
    if lo is not None:
        # a warm start outside the box must not survive (coordinates whose
        # denom <= 0 are never updated below and would keep it)
        beta = np.minimum(np.maximum(beta, lo), hi)
    l1 = lam * alpha
    l2 = lam * (1 - alpha)
    for _ in range(max_sweeps):
        delta = 0.0
        for j in range(p):
            gj = q[j] - G[j] @ beta + G[j, j] * beta[j]
            denom = G[j, j] + (l2 if j < p_pen else 0.0)
            if denom <= 0:
                continue
            nb = _soft(gj, l1) / denom if j < p_pen else gj / denom
            if lo is not None:
                nb = min(max(nb, lo[j]), hi[j])
            delta = max(delta, abs(nb - beta[j]))
            beta[j] = nb
        if delta < tol:
            break
    return beta


# ---------------------------------------------------------------------------
# L-BFGS (hex/optimization/L_BFGS.java): limited-memory quasi-Newton on the
# penalised negative log-likelihood, whose value and gradient are one
# device pass; the two-loop recursion runs on the host over m = 10 pairs
# of p-sized vectors. As in the reference, only the L2 part of the penalty
# is handled (L1 needs the COD path).
def _lbfgs(value_grad, x0, max_iter=200, m=10, tol=1e-7):
    x = np.asarray(x0, np.float64)
    f, g = value_grad(x)
    hs, hy, rho = [], [], []
    for _ in range(max_iter):
        # two-loop recursion
        qv = g.copy()
        al = []
        for s, yv, r in zip(reversed(hs), reversed(hy), reversed(rho)):
            a = r * s.dot(qv)
            al.append(a)
            qv -= a * yv
        gamma = (hs[-1].dot(hy[-1]) / max(hy[-1].dot(hy[-1]), 1e-12)
                 if hs else 1.0)
        qv *= gamma
        for (s, yv, r), a in zip(zip(hs, hy, rho), reversed(al)):
            b = r * yv.dot(qv)
            qv += (a - b) * s
        d = -qv
        gtd = g.dot(d)
        if gtd > -1e-14:        # not a descent direction: restart steepest
            d = -g
            gtd = -g.dot(g)
        # backtracking Armijo line search
        t = 1.0
        for _ls in range(30):
            fn, gn = value_grad(x + t * d)
            if math.isfinite(fn) and fn <= f + 1e-4 * t * gtd:
                break
            t *= 0.5
        else:
            break
        xn = x + t * d
        s = xn - x
        yv = gn - g
        if abs(f - fn) < tol * max(1.0, abs(f)):
            x, f, g = xn, fn, gn
            break
        sy = s.dot(yv)
        if sy > 1e-10:
            hs.append(s)
            hy.append(yv)
            rho.append(1.0 / sy)
            if len(hs) > m:
                hs.pop(0)
                hy.pop(0)
                rho.pop(0)
        x, f, g = xn, fn, gn
        if np.max(np.abs(g)) < tol:
            break
    return x, f


def _value_grad(fn, device):
    """value_grad(x) for L-BFGS: f32 parameters on `device`, the value and
    its gradient by torch.autograd, back as (float, float64 numpy)."""
    def value_grad(x):
        flat = torch.tensor(np.asarray(x, np.float32), device=device,
                            requires_grad=True)
        f = fn(flat)
        (g,) = torch.autograd.grad(f, flat)
        return float(f.detach()), g.double().cpu().numpy()
    return value_grad


def _nll_value_grad(fam, Xi, y, w, *, K=1, l2=0.0, p_pen=0, theta=1.0):
    """The penalised NLL's value and gradient over flat parameters, one
    device pass. Multinomial parameters are (K*p1,); the others (p1,).
    The likelihoods are the canonical and log-link forms: _resolve_solver
    routes only those (family, link) pairs here."""
    p1 = Xi.shape[1]
    yi = y.long()

    def nll(flat):
        if fam == MULTINOMIAL:
            B = flat.reshape(K, p1)
            logits = Xi @ B.T
            lse = torch.logsumexp(logits, dim=1)
            py = logits.gather(1, yi[:, None])[:, 0]
            val = (w * (lse - py)).sum()
            pen = 0.5 * l2 * (B[:, :p_pen] ** 2).sum()
        else:
            eta = Xi @ flat
            if fam in (BINOMIAL, QUASIBINOMIAL):
                val = (w * (torch.logaddexp(eta, torch.zeros_like(eta))
                            - y * eta)).sum()
            elif fam == POISSON:
                val = (w * (torch.exp(eta) - y * eta)).sum()
            elif fam == GAMMA:
                mu = torch.exp(eta)
                val = (w * (y / torch.clamp(mu, min=1e-8) + eta)).sum()
            elif fam == NEGBINOMIAL:
                mu = torch.exp(eta)
                val = (w * ((y + 1.0 / theta) * torch.log1p(theta * mu)
                            - y * eta)).sum()
            else:                       # gaussian / tweedie quad approx
                val = 0.5 * (w * (y - eta) ** 2).sum()
            pen = 0.5 * l2 * (flat[:p_pen] ** 2).sum()
        return val + pen

    return _value_grad(nll, Xi.device)


def _ordinal_cum(eta, thr):
    """(n, K) class probabilities of the cumulative logit: P(y <= k) =
    sigmoid(t_k - eta), differenced."""
    cum = torch.sigmoid(thr[None, :] - eta[:, None])
    n = cum.shape[0]
    cum_full = torch.cat([torch.zeros((n, 1), device=eta.device), cum,
                          torch.ones((n, 1), device=eta.device)], dim=1)
    return torch.diff(cum_full, dim=1)


def _ordinal_value_grad(Xi, yi_np, w, K, l2=0.0, p_pen=0):
    """Cumulative-logit (proportional odds) NLL with ordered thresholds
    t_0 < ... < t_{K-2} parameterised as t_0, t_0 + exp(d_1), ..., so the
    order holds by construction (the ordinal family, an exact MLE by
    L-BFGS)."""
    p = Xi.shape[1] - 1                  # no free intercept: the
    Xb = Xi[:, :p]                       # thresholds play its part
    yi = torch.as_tensor(yi_np.astype(np.int64), device=Xi.device)

    def nll(flat):
        beta = flat[:p]
        steps = torch.exp(torch.clamp(flat[p + 1:], -30, 30))
        thr = flat[p] + torch.cat([torch.zeros(1, device=flat.device),
                                   torch.cumsum(steps, 0)])
        pk = torch.clamp(_ordinal_cum(Xb @ beta, thr), 1e-12, 1.0)
        py = pk.gather(1, yi[:, None])[:, 0]
        return -(w * torch.log(py)).sum() \
            + 0.5 * l2 * (beta[:p_pen] ** 2).sum()

    return _value_grad(nll, Xi.device)


def _class_gram(Xi, w, B, c, yk):
    """One class's Gram of the multinomial sweep: the softmax of Xi·Bᵀ,
    the class's working weights and response, G and q."""
    P = torch.softmax(Xi @ B.T, dim=1)
    pc = torch.clamp(P[:, c], 1e-6, 1 - 1e-6)        # f32-safe
    d = torch.clamp(pc * (1 - pc), min=1e-6)
    wi = w * d
    z = Xi @ B[c] + (yk - pc) / d
    Xw = Xi * wi[:, None]
    return Xi.T @ Xw, Xw.T @ z


def _multinomial_nll(Xi, w, yi, B):
    P = torch.softmax(Xi @ B.T, dim=1)
    py = P.gather(1, yi[:, None])[:, 0]
    return float(-(w * torch.log(torch.clamp(py, 1e-12, 1.0))).sum())


@dataclass
class _GLMState:
    beta: np.ndarray            # (p+1,) or (K, p+1) for multinomial
    link: str
    family: str


def _scalar(v, default):
    """alpha / lambda_: a number, or the first of a list."""
    if isinstance(v, (list, tuple)):
        v = v[0]
    return default if v is None else float(v)


class H2OGeneralizedLinearEstimator(ModelBase):
    algo = "glm"
    _serving_param_attrs = ("_state", "_ord_beta", "_ord_thr")
    _defaults = {
        "family": "AUTO", "link": "family_default", "solver": "AUTO",
        "alpha": None, "lambda_": None, "lambda_search": False, "nlambdas": 30,
        "lambda_min_ratio": 1e-4, "max_iterations": 50,
        "beta_epsilon": 1e-4, "objective_epsilon": 1e-6,
        "gradient_epsilon": 1e-6, "intercept": True,
        "tweedie_variance_power": 0.0, "tweedie_link_power": 1.0,
        "theta": 1e-10, "compute_p_values": False, "remove_collinear_columns": False,
        "missing_values_handling": "MeanImputation", "non_negative": False,
        "standardize": True, "prior": -1.0, "max_active_predictors": -1,
        # beta_constraints: a Frame with names/lower_bounds/upper_bounds, a
        # list of such rows, or a dict {col: (lo, hi)} (GLM.java
        # betaConstraints)
        "beta_constraints": None,
        # interactions: predictors whose pairwise products, crosses and
        # wrapped columns enter the design (DataInfo interactions)
        "interactions": None,
        # quadratic_penalty: (p, p) matrix P adding ½·βᵀPβ to the
        # objective, in expanded-feature order (feature_names), or
        # (feature_names, S) blocks; the intercept row and column are
        # zeros when P is (p_pen, p_pen)
        "quadratic_penalty": None,
    }

    def _reduced_design(self) -> bool:
        return bool(self.params.get("intercept", True))

    def _progress(self, progress, msg):
        if self._job is not None:
            self._job.update(progress, msg)

    # ------------------------------------------------------------------
    def _fit(self, frame: Frame):
        di = self._dinfo
        fam = self._resolve_family()
        self._family = fam
        link = self.params.get("link") or "family_default"
        if link in ("family_default", None, "AUTO"):
            link = _CANONICAL_LINK[fam]
        self._link = link
        self._sparse_fit = False
        # sparse rows (hex/DataInfo.java:23): all-SparseVec predictors
        # never build the dense design; what the sparse L-BFGS cannot do
        # (L1, bounds, lambda search, no intercept, IRLSM) goes dense
        if frame.is_sparse(di.predictors) and fam in (
                GAUSSIAN, BINOMIAL, QUASIBINOMIAL, POISSON) \
                and self._sparse_path_ok():
            self._fit_sparse(frame)
            self._build_output(frame)
            return
        X = di.matrix(frame)                       # standardized, imputed
        y = di.response(frame)
        w = torch.where(torch.isnan(y), 0.0, di.weights(frame))
        yz = torch.where(torch.isnan(y), 0.0, y)
        ones = torch.ones((X.shape[0], 1), dtype=X.dtype, device=X.device)
        Xi = torch.cat([X, ones], dim=1)           # intercept column last
        del X
        solver = self._resolve_solver(fam, Xi.shape[1])
        self._solver = solver
        if fam == ORDINAL:
            self._fit_ordinal(Xi, yz, w)
        elif solver == "L_BFGS":
            self._fit_lbfgs(Xi, yz, w)
        elif fam == MULTINOMIAL:
            self._fit_multinomial(Xi, yz, w)
        else:
            self._fit_irls(Xi, yz, w)
        self._build_output(frame)

    def _sparse_path_ok(self) -> bool:
        """The JAX package's gate of the sparse path: canonical-link
        gaussian, binomial, quasibinomial or poisson, L2 only, with an
        intercept, no bounds, no lambda search, no IRLSM or coordinate
        descent asked for, no interactions or quadratic penalty."""
        if self.params.get("interactions"):
            return False
        if self.params.get("quadratic_penalty") is not None:
            return False
        if (self._family, self._link) not in {
                (GAUSSIAN, "identity"), (BINOMIAL, "logit"),
                (QUASIBINOMIAL, "logit"), (POISSON, "log")}:
            return False
        alpha = _scalar(self.params.get("alpha"), 0.5)
        lam = _scalar(self.params.get("lambda_") or 0.0, 0.0) or 0.0
        s = str(self.params.get("solver") or "AUTO").upper()
        return not ((alpha > 0 and lam > 0)
                    or self.params.get("lambda_search")
                    or self.params.get("beta_constraints") is not None
                    or self.params.get("non_negative")
                    or not self.params.get("intercept", True)
                    or s in ("IRLSM", "COORDINATE_DESCENT",
                             "COORDINATE_DESCENT_NAIVE"))

    def _fit_sparse(self, frame: Frame):
        """Sparse-rows GLM (DataInfo sparse, GLMTask's sparse iterators):
        L-BFGS on `_sparse_objective`; no standardisation (centring would
        densify)."""
        self._dinfo.standardize = False   # scoring sees raw coordinates
        value_grad, x0 = self._sparse_objective(frame)
        x, _ = _lbfgs(value_grad, x0,
                      max_iter=int(self.params["max_iterations"]) * 4,
                      tol=SPARSE_LBFGS_TOL)
        self._state = _GLMState(beta=x, link=self._link, family=self._family)
        self._solver = "L_BFGS"
        self._sparse_fit = True
        self._progress(0.7, "sparse L-BFGS converged")

    def _sparse_objective(self, frame: Frame):
        """(value_grad, x0): the penalised negative log-likelihood of the
        sparse design and its float64 gradient, as L-BFGS takes them, and
        the JAX package's start (the intercept at the link of the
        weighted mean). NAs count as zeros, like the implicit ones."""
        di, fam = self._dinfo, self._family
        sd = _SparseDesign(frame, di.predictors)
        y = di.response(frame)
        w = torch.where(torch.isnan(y), 0.0, di.weights(frame)).double()
        y = torch.where(torch.isnan(y), 0.0, y).double()
        wn = float(w.sum())
        lam = _scalar(self.params.get("lambda_") or 0.0, 0.0) or 0.0
        alpha = _scalar(self.params.get("alpha"), 0.5)
        l2 = float(lam) * (1 - alpha) * wn
        C, dev = sd.C, sd.vals.device

        def value_grad(x):
            xt = torch.as_tensor(np.asarray(x, np.float64), device=dev)
            beta, b0 = xt[:C], xt[C]
            eta = sd.eta(beta, b0)
            if fam in (BINOMIAL, QUASIBINOMIAL):
                ll = w * (torch.nn.functional.softplus(eta) - y * eta)
                r = w * (torch.sigmoid(eta) - y)
            elif fam == POISSON:
                mu = torch.exp(eta)
                ll = w * (mu - y * eta)
                r = w * (mu - y)
            else:
                ll = 0.5 * w * (y - eta) ** 2
                r = w * (eta - y)
            g = torch.cat([sd.col_sums(r) + l2 * beta, r.sum()[None]])
            f = ll.sum() + 0.5 * l2 * (beta * beta).sum()
            return float(f), g.cpu().numpy()

        x0 = np.zeros(C + 1)
        ybar = float((w * y).sum()) / max(wn, 1e-12)
        if fam in (BINOMIAL, QUASIBINOMIAL):
            yb = min(max(ybar, 1e-6), 1 - 1e-6)
            x0[-1] = math.log(yb / (1 - yb))
        elif fam == POISSON:
            x0[-1] = math.log(max(ybar, 1e-8))
        else:
            x0[-1] = ybar
        return value_grad, x0

    def _sparse_mu(self, frame: Frame) -> torch.Tensor:
        st = self._state
        sd = _SparseDesign(frame, self._dinfo.predictors, by_column=False)
        beta = torch.as_tensor(st.beta[:sd.C], dtype=torch.float64,
                               device=sd.vals.device)
        return _linkinv(st.link, sd.eta(beta, float(st.beta[sd.C])))

    def predict_sparse(self, frame: Frame) -> np.ndarray:
        """mu of each row of a sparse frame, without densifying."""
        return self._sparse_mu(frame).cpu().numpy()

    def _compute_metrics(self, frame: Frame):
        # a sparse fit scores sparse frames sparsely: no densify either
        if getattr(self, "_sparse_fit", False) \
                and frame.is_sparse(self._dinfo.predictors):
            di = self._dinfo
            mu = self._sparse_mu(frame).to(torch.float32)
            y = di.response(frame)
            w = torch.where(torch.isnan(y), 0.0, di.weights(frame))
            y = torch.where(torch.isnan(y), 0.0, y)
            out = torch.stack([1.0 - mu, mu], dim=1) \
                if self._is_classifier else mu
            return self._metrics_from_preds(y, out, w)
        return super()._compute_metrics(frame)

    def _resolve_solver(self, fam, p1) -> str:
        """GLM.java defaultSolver: IRLSM for narrow problems, L_BFGS for
        wide ones and multinomial with many predictors; an explicit
        `solver` wins. L-BFGS carries only the L2 penalty, as in the
        reference, so L1 stays on the COD/IRLS path."""
        alpha = _scalar(self.params.get("alpha"), 0.5)
        lam = _scalar(self.params.get("lambda_") or 0.0, 0.0)
        has_l1 = (alpha > 0 and lam > 0) or self.params.get("lambda_search")
        constrained = (has_l1
                       or self.params.get("beta_constraints") is not None
                       or self.params.get("non_negative"))
        # the L-BFGS NLLs are the canonical/log-link likelihoods; other
        # links stay on IRLS (which takes any _irls_weights link)
        lbfgs_link_ok = fam in (MULTINOMIAL,) or (fam, self._link) in {
            (GAUSSIAN, "identity"), (BINOMIAL, "logit"),
            (QUASIBINOMIAL, "logit"), (POISSON, "log"), (GAMMA, "log"),
            (NEGBINOMIAL, "log")}
        s = str(self.params.get("solver") or "AUTO").upper()
        if self.params.get("quadratic_penalty") is not None:
            if s in ("L_BFGS", "LBFGS"):
                raise ValueError(
                    "quadratic_penalty requires the IRLSM solver (the "
                    "L-BFGS NLLs carry only the scalar L2 penalty)")
            if fam in (MULTINOMIAL, ORDINAL):
                raise NotImplementedError(
                    "quadratic_penalty is implemented for the "
                    "single-response IRLS families only; "
                    f"family={fam} would silently drop the penalty")
            if not self.params.get("intercept", True):
                raise NotImplementedError(
                    "quadratic_penalty requires intercept=True (the "
                    "penalty block indexing assumes the appended "
                    "intercept column)")
            return "IRLSM"
        if s in ("L_BFGS", "LBFGS"):
            if constrained:
                raise ValueError(
                    "solver=L_BFGS carries only the L2 penalty: it cannot "
                    "honor L1 (alpha>0 with lambda), beta_constraints or "
                    "non_negative — use IRLSM/COORDINATE_DESCENT "
                    "(GLM.java L_BFGS solver restriction)")
            if fam != ORDINAL and not lbfgs_link_ok:
                raise ValueError(
                    f"solver=L_BFGS does not support family={fam} with "
                    f"link={self._link}; use IRLSM")
            return "L_BFGS"
        if s in ("IRLSM", "COORDINATE_DESCENT", "COORDINATE_DESCENT_NAIVE"):
            return "IRLSM"
        if fam == ORDINAL:
            return "L_BFGS"
        if constrained or not lbfgs_link_ok:
            return "IRLSM"              # L1/bounds need coordinate descent
        K = self.nclasses if fam == MULTINOMIAL else 1
        return "L_BFGS" if p1 * K > 500 else "IRLSM"

    def _beta_bounds(self, p1, p_pen):
        """beta_constraints and non_negative as (lo, hi) arrays, or
        (None, None)."""
        bc = self.params.get("beta_constraints")
        nn = self.params.get("non_negative")
        if bc is None and not nn:
            return None, None
        lo = np.full(p1, -np.inf)
        hi = np.full(p1, np.inf)
        names = self._dinfo.feature_names
        if isinstance(bc, Frame):
            rows = {bc.vec("names").to_numpy()[i]: i
                    for i in range(bc.nrows)}
            lob = (bc.vec("lower_bounds").to_numpy()
                   if "lower_bounds" in bc.names else None)
            hib = (bc.vec("upper_bounds").to_numpy()
                   if "upper_bounds" in bc.names else None)
            for nm, i in rows.items():
                if nm in names:
                    j = names.index(nm)
                    if lob is not None and lob[i] == lob[i]:
                        lo[j] = lob[i]
                    if hib is not None and hib[i] == hib[i]:
                        hi[j] = hib[i]
        elif isinstance(bc, dict):
            for nm, (lo_v, hi_v) in bc.items():
                if nm in names:
                    j = names.index(nm)
                    lo[j], hi[j] = lo_v, hi_v
        elif bc is not None:
            for row in bc:              # list of dicts (h2o-py style)
                nm = row.get("names")
                if nm in names:
                    j = names.index(nm)
                    lo[j] = row.get("lower_bounds", -np.inf)
                    hi[j] = row.get("upper_bounds", np.inf)
        if nn:
            # intersect with the non_negative floor: a user lower bound
            # must not loosen it
            lo[:p_pen] = np.maximum(lo[:p_pen], 0.0)
        return lo, hi

    def _resolve_quadratic_penalty(self, p1, p_pen):
        """`quadratic_penalty` against this fit's expanded design: a list
        of (feature_names, S) blocks indexed into the model's own feature
        order (rescaled by 1/σᵢσⱼ on a standardised design, since
        β_std = σ·β_raw), or a dense (p_pen, p_pen) or (p1, p1) matrix in
        expanded-feature order."""
        P = self.params.get("quadratic_penalty")
        if P is None:
            return None
        if isinstance(P, (list, tuple)):
            feats = self._dinfo.feature_names
            full = np.zeros((p1, p1))
            for names, S in P:
                idx = np.asarray([feats.index(nm) for nm in names])
                S = np.asarray(S, np.float64)
                if self._dinfo.standardize:
                    sig = np.asarray(
                        [max(self._dinfo.sigmas.get(nm, 1.0), 1e-10)
                         for nm in names])
                    S = S / np.outer(sig, sig)
                full[np.ix_(idx, idx)] += S
            return full
        P = np.asarray(P, np.float64)
        if P.shape == (p_pen, p_pen):           # zero intercept block
            Pf = np.zeros((p1, p1))
            Pf[:p_pen, :p_pen] = P
            P = Pf
        if P.shape != (p1, p1):
            raise ValueError(
                f"quadratic_penalty shape {P.shape} does not match the "
                f"expanded design ({p1} columns incl. intercept); pass "
                "(feature_names, S) blocks to let the model index them")
        return P

    # ------------------------------------------------------------------
    def _weighted_means(self, w, y):
        """(Σw, Σw·y / Σw) in float64 on the device."""
        wd = w.double()
        wsum, wysum = torch.stack([wd.sum(), (wd * y.double()).sum()]) \
            .cpu().tolist()
        return wsum, wysum / max(wsum, 1e-12)

    def _class_priors(self, w, y, K):
        """The weighted share of each class, in float64."""
        wd = w.double()
        tot = torch.zeros(K, dtype=torch.float64, device=w.device) \
            .index_add_(0, y.long(), wd)
        return (tot / max(float(wd.sum()), 1e-12)).cpu().numpy()

    def _fit_lbfgs(self, Xi, y, w):
        """hex/optimization/L_BFGS.java: the exact penalised MLE by
        limited-memory quasi-Newton; each gradient is one device pass."""
        fam, link = self._family, self._link
        p1 = Xi.shape[1]
        p_pen = p1 - 1 if self.params.get("intercept", True) else p1
        wsum, ybar = self._weighted_means(w, y)
        lam = _scalar(self.params.get("lambda_") or 0.0, 0.0)
        alpha = _scalar(self.params.get("alpha"), 0.5)
        l2 = lam * (1 - alpha) * wsum
        max_it = int(self.params["max_iterations"]) * 4
        if fam == MULTINOMIAL:
            K = self.nclasses
            vg = _nll_value_grad(fam, Xi, y, w, K=K, l2=l2, p_pen=p_pen)
            x0 = np.zeros(K * p1)
            pcs = self._class_priors(w, y, K)
            for c in range(K):
                x0[c * p1 + p1 - 1] = math.log(max(pcs[c], 1e-6))
            x, _ = _lbfgs(vg, x0, max_iter=max_it)
            self._state = _GLMState(beta=x.reshape(K, p1),
                                    link="multinomial", family=MULTINOMIAL)
        else:
            vg = _nll_value_grad(fam, Xi, y, w, l2=l2, p_pen=p_pen,
                                 theta=float(self.params["theta"] or 1.0))
            x0 = np.zeros(p1)
            if fam in (BINOMIAL, QUASIBINOMIAL):
                yb = min(max(ybar, 1e-6), 1 - 1e-6)
                x0[-1] = math.log(yb / (1 - yb))
            elif link == "log":
                x0[-1] = math.log(max(ybar, 1e-8))
            else:
                x0[-1] = ybar
            x, _ = _lbfgs(vg, x0, max_iter=max_it)
            self._state = _GLMState(beta=x, link=link, family=fam)
            # the Fisher information at the optimum, for p-values
            eta = _eta_pass(Xi, torch.as_tensor(x, dtype=torch.float32,
                                                device=Xi.device))
            wi, _ = _irls_weights(fam, link, eta, y, w,
                                  self.params["tweedie_variance_power"]
                                  or 1.5, self.params["theta"])
            self._Gram, _ = _host_gram(*_gram_pass(Xi, wi,
                                                   torch.zeros_like(eta)))
            self._wsum = wsum
        self._progress(0.7, "L-BFGS converged")

    # ------------------------------------------------------------------
    def _fit_ordinal(self, Xi, y, w):
        """Proportional-odds cumulative-logit model (ordinal family)."""
        K = self.nclasses
        assert K >= 2, "ordinal family needs an ordered factor response"
        p = Xi.shape[1] - 1
        yi = y.long().cpu().numpy()
        lam = _scalar(self.params.get("lambda_") or 0.0, 0.0)
        wsum, _ = self._weighted_means(w, y)
        vg = _ordinal_value_grad(Xi, yi, w, K, l2=lam * wsum, p_pen=p)
        # start: thresholds at the empirical cumulative logits
        pcs = self._class_priors(w, y, K)
        x0 = np.zeros(p + K - 1)
        cum = 0.0
        prev_t = None
        for k in range(K - 1):
            cum += pcs[k]
            cumc = min(max(cum, 1e-6), 1 - 1e-6)
            tk = math.log(cumc / (1 - cumc))
            if k == 0:
                x0[p] = tk
            else:
                x0[p + k] = math.log(max(tk - prev_t, 1e-3))
            prev_t = tk
        x, _ = _lbfgs(vg, x0, max_iter=int(self.params["max_iterations"]) * 4)
        self._ord_beta = x[:p]
        t0 = x[p]
        self._ord_thr = t0 + np.concatenate(
            [[0.0], np.cumsum(np.exp(x[p + 1:]))])
        # beta in the common shape (the intercept slot carries t_0)
        self._state = _GLMState(beta=np.concatenate([x[:p], [t0]]),
                                link="ologit", family=ORDINAL)
        self._progress(0.7, "ordinal converged")

    def _resolve_family(self) -> str:
        fam = self.params.get("family", "AUTO")
        if fam and str(fam).lower() in ("hglm", "fractionalbinomial"):
            raise NotImplementedError(
                f"family={fam} is not implemented (no silent fallback); "
                "supported: gaussian/binomial/quasibinomial/poisson/gamma/"
                "tweedie/negativebinomial/multinomial/ordinal")
        if fam and fam != "AUTO":
            return fam
        if self._dinfo.response_domain is None:
            return GAUSSIAN
        return BINOMIAL if len(self._dinfo.response_domain) == 2 \
            else MULTINOMIAL

    def _alpha_lambda(self, q, p_pen, wsum):
        """alpha and the lambdas to fit: lambda_, or with lambda_search a
        geometric path from lambda_max down to lambda_min_ratio of it.
        lambda_max is the smallest lambda at which every penalised
        coefficient stays 0 under the objective the solvers minimise,
        deviance/Σw + lambda·penalty: the null model's gradient q (a sum
        over the rows) over alpha·Σw. The JAX package leaves out the Σw,
        so its path sits Σw times too high and, above about 10,000 rows,
        holds no active predictor at all (ROADMAP.md §3)."""
        alpha = _scalar(self.params.get("alpha"), 0.5)
        if self.params.get("lambda_search"):
            lam_max = np.abs(q[:p_pen]).max() / max(alpha, 1e-3) \
                / max(wsum, 1e-12)
            lams = np.geomspace(lam_max,
                                lam_max * self.params["lambda_min_ratio"],
                                int(self.params["nlambdas"]))
            return alpha, list(lams)
        return alpha, [_scalar(self.params.get("lambda_"), 0.0)]

    # ------------------------------------------------------------------
    def _fit_irls(self, Xi, y, w):
        fam, link = self._family, self._link
        p1 = Xi.shape[1]
        p_pen = p1 - 1 if self.params.get("intercept", True) else p1
        dev = Xi.device
        tvp = self.params["tweedie_variance_power"] or 1.5
        theta = self.params["theta"]
        beta = np.zeros(p1, np.float64)
        # the intercept starts at the link of the weighted mean
        wsum, ybar = self._weighted_means(w, y)
        if fam in (BINOMIAL, QUASIBINOMIAL):
            yb = min(max(ybar, 1e-6), 1 - 1e-6)
            beta[-1] = math.log(yb / (1 - yb))
        elif fam in (POISSON, GAMMA, TWEEDIE, NEGBINOMIAL):
            beta[-1] = math.log(max(ybar, 1e-8)) if link == "log" else (
                1.0 / max(ybar, 1e-8) if link == "inverse" else ybar)
        else:
            beta[-1] = ybar

        def gram(b):
            eta = _eta_pass(Xi, torch.as_tensor(b, dtype=torch.float32,
                                                device=dev))
            wi, z = _irls_weights(fam, link, eta, y, w, tvp, theta)
            return _host_gram(*_gram_pass(Xi, wi, z))

        # lambda_max needs the null model's Gram
        Gn, qn = gram(beta)
        alpha, lams = self._alpha_lambda(qn - Gn @ beta, p_pen, wsum)
        lo, hi = self._beta_bounds(p1, p_pen)
        P = self._resolve_quadratic_penalty(p1, p_pen)
        max_it = int(self.params["max_iterations"])
        beps = float(self.params["beta_epsilon"])
        path = []
        self._iterations = 0
        for lam in lams:
            for it in range(max(1, max_it)):
                self._iterations += 1
                with _span("glm.irlsm", iter=it, lam=float(lam),
                           family=fam):
                    _IRLSM_ITERS.inc()
                    Gn, qn = gram(beta)
                    # the quadratic (smoothness) penalty: ∇½βᵀPβ = Pβ
                    # folds into the Gram exactly, for both solvers
                    nb = _irls_solve(Gn if P is None else Gn + P, qn, beta,
                                     lam, wsum, alpha, p_pen, lo, hi)
                dmax = float(np.max(np.abs(nb - beta)))
                beta = nb
                if fam == GAUSSIAN and link == "identity":
                    break
                if dmax < beps:
                    break
            path.append((lam, beta.copy()))
            self._progress(0.6, f"lambda {lam:.4g}")
        self._lambda_path = path
        self._state = _GLMState(beta=beta, link=link, family=fam)
        self._Gram = Gn
        self._wsum = wsum

    # ------------------------------------------------------------------
    def _fit_multinomial(self, Xi, y, w):
        """Block-coordinate per-class IRLS (GLM.java:1228), with the
        reference's divergence guard for separable data."""
        K = self.nclasses
        p1 = Xi.shape[1]
        p_pen = p1 - 1
        dev = Xi.device
        beta = np.zeros((K, p1), np.float64)
        wsum, _ = self._weighted_means(w, y)
        pcs = self._class_priors(w, y, K)
        for c in range(K):
            beta[c, -1] = math.log(max(pcs[c], 1e-6))
        alpha = _scalar(self.params.get("alpha"), 0.5)
        lam = _scalar(self.params.get("lambda_") or 0.0, 0.0)
        max_it = int(self.params["max_iterations"])
        beps = float(self.params["beta_epsilon"])
        yi = y.long()

        def as_t(B):
            return torch.as_tensor(B, dtype=torch.float32, device=dev)

        prev_obj = _multinomial_nll(Xi, w, yi, as_t(beta))
        self._iterations = 0
        for sweep in range(max_it):
            self._iterations += 1
            dmax = 0.0
            last_good = beta.copy()
            with _span("glm.irlsm", iter=sweep, family=MULTINOMIAL):
                _IRLSM_ITERS.inc()
                for c in range(K):
                    yk = (yi == c).to(torch.float32)
                    Gn, qn = _host_gram(*_class_gram(Xi, w, as_t(beta), c,
                                                     yk))
                    if alpha > 0 and lam > 0:
                        nb = _cod_solve(Gn, qn, lam * wsum, alpha, p_pen,
                                        beta[c].copy())
                    else:
                        A = Gn + lam * wsum * (1 - alpha) * np.eye(p1)
                        A[p1 - 1, p1 - 1] = Gn[p1 - 1, p1 - 1]
                        nb = np.linalg.solve(A + 1e-8 * np.eye(p1), qn)
                    dmax = max(dmax, float(np.max(np.abs(nb - beta[c]))))
                    beta[c] = nb
            self._progress(0.6, f"multinomial sweep {sweep}")
            obj = _multinomial_nll(Xi, w, yi, as_t(beta))
            if not math.isfinite(obj) or obj > prev_obj + 1e-6 * abs(prev_obj):
                beta = last_good    # separable-data divergence guard
                break
            prev_obj = obj
            if dmax < beps:
                break
        self._state = _GLMState(beta=beta, link="multinomial",
                                family=MULTINOMIAL)

    # ------------------------------------------------------------------
    def _score_matrix(self, X):
        st = self._state
        ones = torch.ones((X.shape[0], 1), dtype=X.dtype, device=X.device)
        Xi = torch.cat([torch.where(torch.isnan(X), 0.0, X), ones], dim=1)

        def t(a):
            return _dev_f32(a, X.device)
        if st.family == ORDINAL:
            pk = _ordinal_cum(Xi[:, :-1] @ t(self._ord_beta),
                              t(self._ord_thr))
            return torch.clamp(pk, 0.0, 1.0)
        if st.family == MULTINOMIAL:
            return torch.softmax(Xi @ t(st.beta).T, dim=1)
        mu = _linkinv(st.link, Xi @ t(st.beta),
                      self.params.get("tweedie_link_power") or 1.0)
        if st.family in (BINOMIAL, QUASIBINOMIAL) and self._is_classifier:
            return torch.stack([1.0 - mu, mu], dim=1)
        # a numeric 0/1 response (quasibinomial style): one column
        return mu

    # ------------------------------------------------------------------
    def _build_output(self, frame):
        di = self._dinfo
        st = self._state
        names = di.feature_names + ["Intercept"]
        self._set_coefficients()
        # variable importances: |standardised coefficient| (multinomial:
        # the largest over classes), GLMOutput.getVariableImportances
        mags = {}
        for j, n in enumerate(di.feature_names):
            b = st.beta[:, j] if st.family == MULTINOMIAL else st.beta[j]
            mags[n] = float(np.max(np.abs(b)))
        order = sorted(mags, key=mags.get, reverse=True)
        top = mags[order[0]] if order else 0.0
        tot = sum(mags.values()) or 1.0
        self._output.variable_importances = [
            {"variable": n, "relative_importance": mags[n],
             "scaled_importance": mags[n] / (top or 1.0),
             "percentage": mags[n] / tot}
            for n in order]
        self._output.model_summary = {
            "family": st.family, "link": st.link,
            "number_of_predictors_total": len(names) - 1,
            "number_of_active_predictors": int(sum(
                1 for v in (st.beta.flatten() if st.family == MULTINOMIAL
                            else st.beta[:-1]) if abs(v) > 1e-10)),
        }
        if self.params.get("compute_p_values") \
                and st.family not in (MULTINOMIAL, ORDINAL) \
                and getattr(self, "_Gram", None) is not None:
            self._compute_p_values()

    def _set_coefficients(self):
        """`_coefficients_std` from beta by feature name, and
        `_coefficients` de-standardised where the design is."""
        di = self._dinfo
        st = self._state
        names = di.feature_names + ["Intercept"]
        if st.family == MULTINOMIAL:
            coefs = {n: st.beta[:, j].tolist() for j, n in enumerate(names)}
        else:
            coefs = dict(zip(names, st.beta.tolist()))
        self._coefficients_std = coefs
        # de-standardised coefficients for the user (H2O reports both);
        # ordinal keeps the standardised ones (its "Intercept" is the
        # threshold t0, de-standardised with the opposite sign)
        if di.standardize and st.family not in (MULTINOMIAL, ORDINAL):
            raw = {}
            icept = st.beta[-1]
            for j, n in enumerate(di.feature_names):
                b = st.beta[j]
                if n in di.means:      # numeric (and interaction) columns
                    s = max(di.sigmas[n], 1e-10)    # were standardised
                    raw[n] = b / s
                    icept -= b * di.means[n] / s
                else:
                    raw[n] = b
            raw["Intercept"] = icept
            self._coefficients = raw
        else:
            self._coefficients = coefs

    def _compute_p_values(self):
        """z-scores and p-values from the inverse Fisher information
        (GLM.java computePValues), valid for lambda = 0."""
        try:
            from scipy import stats as sps  # optional
            have_scipy = True
        except ImportError:
            have_scipy = False
        G = self._Gram
        try:
            cov = np.linalg.inv(G + 1e-10 * np.eye(len(G)))
        except np.linalg.LinAlgError:
            return
        se = np.sqrt(np.clip(np.diag(cov), 0, None))
        z = self._state.beta / np.where(se > 0, se, np.inf)
        self._std_errors = se
        self._z_values = z
        if have_scipy:
            self._p_values = 2 * (1 - sps.norm.cdf(np.abs(z)))
        else:
            self._p_values = 2 * (1 - 0.5 * (1 + np.vectorize(math.erf)(
                np.abs(z) / math.sqrt(2))))

    # ---- public accessors (h2o-py) ----------------------------------------
    def coef(self) -> dict:
        return dict(self._coefficients)

    def coef_norm(self) -> dict:
        return dict(self._coefficients_std)


# The sparse path's L-BFGS stop (relative change of the objective, or the
# largest gradient entry). The JAX package stops at 1e-7, about the
# resolution of its f32 objective, a sum over the rows; the port's is
# float64. At rcv1.binary's size a 1e-7 stop left the gradient at 1e-2 of
# its norm at zero, and at 1e-10 a fit on the card and one on the CPU,
# whose sums round apart in the last bits from the third evaluation on,
# stopped 5e-4 of the largest coefficient apart; at 1e-14 they agree
# within 2e-6 (PERF.md §6, on an H100).
SPARSE_LBFGS_TOL = 1e-14


class _SparseDesign:
    """A frame's sparse predictors as two orders of their nonzeros: by
    row (for η) and by column (for the gradient, the order of
    `Frame.sparse_coo`), each with the offsets of its segments. A
    segment's sum is the difference of a float64 prefix sum at its ends,
    which fixes the order of every addition: the sums are the same bits
    from run to run on the card, where `index_add_` is not."""

    def __init__(self, frame: Frame, cols, by_column: bool = True):
        ri, ci, vals, (n, C) = frame.sparse_coo(cols)
        vals = torch.where(torch.isnan(vals), 0.0, vals)
        self.n, self.C = n, C
        self.row_ptr = _offsets(ri, n)
        order = torch.argsort(ri, stable=True)   # by row, columns sorted
        self.ci_r = ci.index_select(0, order)
        self.vals_r = vals.index_select(0, order)
        if by_column:
            self.ri, self.vals = ri, vals
            self.col_ptr = _offsets(ci, C)
        else:
            self.ri, self.vals, self.col_ptr = None, self.vals_r, None

    def eta(self, beta: torch.Tensor, b0) -> torch.Tensor:
        """(n,) float64 linear predictor."""
        contrib = self.vals_r * beta.index_select(0, self.ci_r)
        return _segment_sums(contrib, self.row_ptr) + b0

    def col_sums(self, r: torch.Tensor) -> torch.Tensor:
        """(C,) float64 Σ over each column's nonzeros of value × r[row]."""
        return _segment_sums(self.vals * r.index_select(0, self.ri),
                             self.col_ptr)


def _offsets(keys: torch.Tensor, k: int) -> torch.Tensor:
    """(k + 1,) int64 segment offsets of sorted keys in [0, k)."""
    counts = torch.bincount(keys.long(), minlength=k)
    return torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])


def _segment_sums(x: torch.Tensor, ptr: torch.Tensor) -> torch.Tensor:
    """Sums of x's segments [ptr[i], ptr[i+1]) in float64, in a fixed
    order of addition."""
    cs = torch.cat([x.new_zeros(1, dtype=torch.float64),
                    _prefix_sums(x.to(torch.float64))])
    return cs.index_select(0, ptr[1:]) - cs.index_select(0, ptr[:-1])


_SCAN_BLOCK = 1024


def _prefix_sums(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums of a 1-D tensor, the same bits from run to
    run: blocks of _SCAN_BLOCK scanned along their rows (one fixed
    in-block order), then each block offset by the prefix of the block
    totals, found the same way. A flat `torch.cumsum` of a long CUDA
    tensor is a decoupled look-back scan, whose order of addition
    depends on which block finished first."""
    n = x.numel()
    if n <= _SCAN_BLOCK:
        return torch.cumsum(x.view(1, n), dim=1).view(n)
    nb = -(-n // _SCAN_BLOCK)
    pad = x.new_zeros(nb * _SCAN_BLOCK)
    pad[:n] = x
    blocks = torch.cumsum(pad.view(nb, _SCAN_BLOCK), dim=1)
    offsets = _prefix_sums(blocks[:, -1].contiguous())
    blocks[1:] += offsets[:-1, None]
    return blocks.view(-1)[:n]


def _irls_solve(Gs, qn, beta, lam, wsum, alpha, p_pen, lo, hi):
    """One IRLS step's solve on the host in float64: COD for an L1 part or
    bounds (λ scaled by Σw: the objective is deviance/N + λ·penalty), else
    the ridge-regularised normal equations."""
    p1 = len(qn)
    if (alpha > 0 and lam > 0) or lo is not None:
        return _cod_solve(Gs, qn, lam * wsum, alpha, p_pen, beta, lo=lo,
                          hi=hi)
    A = Gs + lam * wsum * (1 - alpha) * np.eye(p1)
    if p_pen < p1:
        A[p1 - 1, p1 - 1] = Gs[p1 - 1, p1 - 1]
    return np.linalg.solve(A + 1e-10 * np.eye(p1), qn)

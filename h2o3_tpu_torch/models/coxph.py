"""Cox proportional hazards of the port (h2o3_tpu/models/coxph.py,
hex/coxph/CoxPH.java and EfronMethod.java).

Newton-Raphson on the Cox partial likelihood with Efron or Breslow ties
and `stratify_by` strata (risk sets form within a stratum; beta is
shared). The rows are ordered by (stratum, -time) once on the host, with
the tie groups' ends, each stratum's first row and each event's Efron rank
in its tie group. The negative log-likelihood is then one pass on the
device in float64 (the JAX package's is f32): the linear predictor, and
the risk sets, a cumulative sum of w·exp(η) read at each tie group's
last row less its value before the stratum (the JAX package's segment
max of that cumsum, which is the same number). The gradient and the
Hessian are autograd's of that same function (the Hessian by p backward
passes); the p×p Newton solve and the covariance's inverse run in
float64 numpy on the host, and β itself is kept in f32 as in the JAX
package. The JAX package's f32 objective cannot resolve the 1e-9
relative decrease its loop asks for, so it can stop a Newton step or two
before the port does. The
concordance is the JAX package's, on the same 8,000-row numpy sample
(default_rng(0)).

The design is the one-hot DataInfo with each NA-free categorical's first
level dropped (`DataInfo.drop_first`): the partial likelihood cancels any
constant, so beside every level's column the levels are unidentified. The
JAX package keeps every level and adds 1e-8·I to its Hessian.

`start_column` is dropped from the predictors by the JAX package and
never enters its likelihood; `lre_min` and `use_all_factor_levels` are
never read. Each would change H2O's result, so the port raises when one
is set to anything but its default.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from h2o3_tpu_torch.core.frame import Frame, T_CAT
from h2o3_tpu_torch.models.model import ModelBase


class H2OCoxProportionalHazardsEstimator(ModelBase):
    algo = "coxph"
    _serving_param_attrs = ("_beta",)
    _defaults = {
        "stop_column": None, "start_column": None, "ties": "efron",
        "stratify_by": None, "max_iterations": 20, "lre_min": 9.0,
        "use_all_factor_levels": False,
    }
    _IGNORED_IN_JAX = ModelBase._IGNORED_IN_JAX + (
        ("start_column", None,
         "the JAX CoxPH drops it from the predictors and never reads it "
         "(h2o3_tpu/models/coxph.py:51-52): counting-process intervals "
         "are not ported"),
        ("lre_min", 9.0, "the JAX CoxPH accepts it and never reads it "
         "(h2o3_tpu/models/coxph.py:41)"),
        ("use_all_factor_levels", False,
         "the JAX CoxPH accepts it and never reads it "
         "(h2o3_tpu/models/coxph.py:41)"))

    def train(self, x=None, y=None, training_frame=None, **kw):
        """y is the event column; `stop_column` holds the time."""
        self.params.update(kw)
        return ModelBase.train(self, x=x, y=y, training_frame=training_frame)

    def _resolve_predictors(self, frame, x, y):
        x = ModelBase._resolve_predictors(self, frame, x, y)
        drop = {self.params.get("stop_column"),
                self.params.get("start_column")}
        drop.update(self._strata_cols())
        return [c for c in x if c not in drop]

    def _reduced_design(self) -> bool:
        return True

    def _strata_cols(self):
        s = self.params.get("stratify_by")
        if not s:
            return []
        return [s] if isinstance(s, str) else list(s)

    def _fit(self, frame: Frame):
        di = self._dinfo
        stop_col = self.params["stop_column"]
        if not stop_col:
            raise ValueError("coxph requires stop_column (the event time)")
        ties = str(self.params.get("ties") or "efron").lower()
        if ties not in ("efron", "breslow"):
            raise ValueError(f"ties must be efron|breslow, got {ties!r}")
        t = frame.vec(stop_col).to_numpy()
        ev = frame.vec(di.response_name).to_numpy()
        w = (frame.vec(self.params["weights_column"]).to_numpy()
             if self.params.get("weights_column") else np.ones(frame.nrows))
        # strata: an id a row from the cross of the stratify_by columns
        strat = np.zeros(frame.nrows, np.int64)
        for c in self._strata_cols():
            v = frame.vec(c)
            if v.type != T_CAT:
                raise ValueError(
                    f"stratify_by column {c!r} must be categorical "
                    "(CoxPH strata are enum crosses)")
            codes = np.nan_to_num(v.to_numpy(), nan=-1).astype(np.int64)
            strat = strat * (v.cardinality + 1) + (codes + 1)
        rows = np.flatnonzero(~(np.isnan(t) | np.isnan(ev)))
        t, ev, w, strat = t[rows], ev[rows], w[rows], strat[rows]
        _, strat = np.unique(strat, return_inverse=True)
        order = np.lexsort((-t, strat))
        t, ev, w, strat = t[order], ev[order], w[order], strat[order]
        n = len(t)
        X = di.matrix(frame)
        dev = X.device
        X = torch.nan_to_num(X.index_select(
            0, torch.from_numpy(rows[order]).to(dev)))
        p = X.shape[1]
        nll = _nll_fn(X, t, ev, w, strat, ties)

        def value(b):
            with torch.no_grad():
                return float(nll(b))

        def grad_hess(b):
            b = b.detach().requires_grad_(True)
            g, = torch.autograd.grad(nll(b), b)
            H = torch.autograd.functional.hessian(nll, b.detach())
            return (g.detach().cpu().double().numpy(),
                    H.detach().cpu().double().numpy())

        beta = torch.zeros(p, dtype=torch.float32, device=dev)
        prev = value(beta)
        history = []
        for it in range(int(self.params["max_iterations"])):
            g, H = grad_hess(beta)
            try:
                step = np.linalg.solve(H + 1e-8 * np.eye(p), g)
            except np.linalg.LinAlgError:
                break
            nb = beta - torch.as_tensor(step, dtype=torch.float32,
                                        device=dev)
            cur = value(nb)
            if not math.isfinite(cur) or cur > prev + 1e-9:
                break
            beta = nb
            history.append({"iter": it, "loglik": -cur})
            if abs(prev - cur) < 1e-9 * max(1.0, abs(prev)):
                prev = cur
                break
            prev = cur
        self._beta = beta.cpu().double().numpy()
        try:
            cov = np.linalg.inv(grad_hess(beta)[1] + 1e-8 * np.eye(p))
            self._se = np.sqrt(np.clip(np.diag(cov), 0, None))
        except np.linalg.LinAlgError:
            self._se = np.full(p, np.nan)
        self._output.scoring_history = history
        names = di.feature_names
        self._coefficients = dict(zip(names, self._beta.tolist()))
        lp = (X.double() @ torch.as_tensor(self._beta, device=dev)) \
            .cpu().numpy()
        conc = _concordance(t, ev, strat, lp)
        self._output.model_summary = {
            "loglik": -prev, "iterations": len(history),
            "coefficients": self._coefficients,
            "exp_coef": {k: math.exp(v)
                         for k, v in self._coefficients.items()},
            "se_coef": dict(zip(names, self._se.tolist())),
            "ties": ties, "concordance": conc,
            "strata": self._strata_cols() or None,
            "n_strata": int(strat.max()) + 1 if n else 0,
        }

    def coef(self):
        return dict(self._coefficients)

    def _score_matrix(self, X):
        """The linear predictor."""
        b = torch.as_tensor(self._beta, dtype=torch.float32, device=X.device)
        return torch.where(torch.isnan(X), 0.0, X) @ b

    def _compute_metrics(self, frame):
        return None

    def _score_train_valid(self, frame, valid):
        pass


def _nll_fn(X, t, ev, w, strat, ties):
    """The negative partial log-likelihood of beta over rows sorted by
    (stratum, -time), in float64: host arrays t, ev, w, strat; X on the
    device."""
    dev = X.device
    X = X.to(torch.float64)
    n = len(t)
    new_grp = np.ones(n, bool)
    new_grp[1:] = (strat[1:] != strat[:-1]) | (t[1:] != t[:-1])
    grp = np.cumsum(new_grp) - 1                 # tie group of each row
    n_grp = int(grp[-1]) + 1 if n else 0
    grp_end = np.append(np.flatnonzero(new_grp)[1:], n) - 1
    new_strat = np.ones(n, bool)
    new_strat[1:] = strat[1:] != strat[:-1]
    strat_id = np.cumsum(new_strat) - 1
    first = np.flatnonzero(new_strat)            # each stratum's first row
    # Efron: each event's rank among its tie group's events, and the
    # group's event count
    is_ev = ev > 0
    evcum = np.cumsum(is_ev)
    gs = np.flatnonzero(new_grp)
    before = np.where(gs > 0, evcum[np.maximum(gs - 1, 0)], 0)
    rank = np.where(is_ev, evcum - 1 - before[grp], 0.0)
    dcount = np.bincount(grp[is_ev], minlength=n_grp).astype(np.float64)

    def t64(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=dev)

    def tlong(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=dev)
    grp_t, end_t, sid_t = tlong(grp), tlong(grp_end), tlong(strat_id)
    base_t = tlong(np.maximum(first - 1, 0))
    has_base = torch.as_tensor(first > 0, device=dev)
    rank_t = t64(rank)
    d_t = t64(np.maximum(dcount, 1.0))[grp_t]
    w_t = t64(w)
    evw = t64(ev * w)
    isev = t64(is_ev) * w_t

    def nll(beta):
        eta = X @ beta.to(torch.float64)
        r = w_t * torch.exp(eta)
        csum = torch.cumsum(r, 0)
        sbase = torch.where(has_base, csum[base_t], 0.0)
        risk = csum[end_t][grp_t] - sbase[sid_t]
        if ties == "efron":
            tie_r = torch.zeros(n_grp, dtype=torch.float64, device=dev) \
                .index_add(0, grp_t, r * (isev > 0))[grp_t]
            denom = risk - rank_t / d_t * tie_r
        else:
            denom = risk
        ll = (evw * eta).sum() - (
            isev * torch.log(torch.clamp(denom, min=1e-30))).sum()
        return -ll
    return nll


def _concordance(t, ev, strat, lp, cap: int = 8000) -> float:
    """The JAX package's concordance index: comparable pairs within
    strata, on a numpy sample of `cap` rows (default_rng(0)) beyond it."""
    n = len(t)
    if n == 0:
        return float("nan")
    if n > cap:
        idx = np.random.default_rng(0).choice(n, cap, replace=False)
        t, ev, strat, lp = t[idx], ev[idx], strat[idx], lp[idx]
    comp = (t[:, None] < t[None, :]) & (ev[:, None] > 0) & \
        (strat[:, None] == strat[None, :])
    conc = comp & (lp[:, None] > lp[None, :])
    tied = comp & (lp[:, None] == lp[None, :])
    n_comp = comp.sum()
    if n_comp == 0:
        return float("nan")
    return float((conc.sum() + 0.5 * tied.sum()) / n_comp)

"""PSVM of the port (h2o3_tpu/models/psvm.py, hex/psvm/PSVM.java): a
support vector machine for a binary response.

As in the JAX package, the primal squared-hinge objective
    ½·βᵀβ + C · Σ w·max(0, 1 − y·(Z β + b0))² / max(Σw, 1)
is minimised directly, y in {−1, +1} and w the observation weight times
`positive_weight` or `negative_weight`. `kernel_type="gaussian"` maps the
standardised one-hot design through random Fourier features,
Z = sqrt(2/D)·cos(X W + b), with W ~ N(0, 2γ) (γ = 1/p unless `gamma` is
set) and b ~ U(0, 2π) drawn by numpy's default_rng(seed) exactly as the
JAX package draws them, so both packages use the same feature map; any
other kernel uses X itself. The optimiser is the port's own copy of
`optax.lbfgs()` at its defaults (`_lbfgs.ZoomLBFGS`), for up to
`max_iterations` steps, stopping as the JAX package does once the
objective moves by less than 1e-8 of itself. The feature map is built
once on the device (W and b are fixed); the JAX package rebuilds it in
every evaluation of the objective, to the same numbers. The score is
sigmoid(2·decision).

`rank_ratio` is accepted and never read by the JAX package (its
incomplete Cholesky factorisation is not built); set, it would change
H2O's result, so the port raises.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from h2o3_tpu_torch.core.frame import Frame
from h2o3_tpu_torch.models._lbfgs import ZoomLBFGS
from h2o3_tpu_torch.models.model import ModelBase


class H2OSupportVectorMachineEstimator(ModelBase):
    algo = "psvm"
    # the JAX package's `_params_svm` is the port's feature map and
    # hyperplane
    _serving_param_attrs = ("_rff", "_beta", "_b0")
    _defaults = {
        "hyper_param": 1.0,            # C
        "kernel_type": "gaussian", "gamma": -1.0, "rank_ratio": -1.0,
        "positive_weight": 1.0, "negative_weight": 1.0,
        "max_iterations": 200, "feature_dim": 256,
    }
    _IGNORED_IN_JAX = ModelBase._IGNORED_IN_JAX + (
        ("rank_ratio", -1.0,
         "the JAX PSVM accepts it and never reads it "
         "(h2o3_tpu/models/psvm.py:36): no incomplete Cholesky "
         "factorisation is built"),)

    def _fit(self, frame: Frame):
        di = self._dinfo
        if self.nclasses != 2:
            raise ValueError("psvm requires a binary response")
        X = di.matrix(frame)
        y = di.response(frame)
        w = torch.where(torch.isnan(y), 0.0, di.weights(frame))
        ysvm = torch.where(y > 0.5, 1.0, -1.0)
        w = w * torch.where(ysvm > 0, float(self.params["positive_weight"]),
                            float(self.params["negative_weight"]))
        p = X.shape[1]
        kernel = (self.params.get("kernel_type") or "gaussian").lower()
        seed = int(self.params.get("seed") or -1)
        rng = np.random.default_rng(seed if seed > 0 else 0)
        if kernel == "gaussian":
            gamma = float(self.params.get("gamma") or -1.0)
            if gamma <= 0:
                gamma = 1.0 / max(p, 1)
            D = int(self.params.get("feature_dim") or 256)
            W = rng.normal(0, math.sqrt(2 * gamma), (p, D))
            b = rng.uniform(0, 2 * np.pi, D)
            self._rff = (torch.tensor(W, dtype=torch.float32,
                                      device=X.device),
                         torch.tensor(b, dtype=torch.float32,
                                      device=X.device))
        else:
            self._rff = None
        Z = self._features(X)
        del X
        C = float(self.params["hyper_param"])
        wsum = torch.clamp(w.sum(), min=1.0)

        def loss(theta):
            beta, b0 = theta[:-1], theta[-1]
            hinge = torch.clamp(1.0 - ysvm * (Z @ beta + b0), min=0.0)
            return 0.5 * (beta @ beta) + C * (w * hinge * hinge).sum() / wsum

        def value_and_grad(theta):
            theta = theta.detach().requires_grad_(True)
            v = loss(theta)
            g, = torch.autograd.grad(v, theta)
            return float(v.detach()), g.detach()

        opt = ZoomLBFGS(Z.shape[1] + 1, Z.device)
        theta = torch.zeros(Z.shape[1] + 1, dtype=torch.float32,
                            device=Z.device)
        prev = np.inf
        self._objective = []
        max_it = int(self.params["max_iterations"])
        for it in range(max_it):
            lv, g = value_and_grad(theta)
            theta = opt.step(theta, lv, g, value_and_grad)
            self._objective.append(lv)
            if abs(prev - lv) < 1e-8 * max(1.0, abs(prev)):
                break
            prev = lv
            if it % 20 == 0 and self._job is not None:
                self._job.update(0.1 + 0.8 * it / max_it, f"iter {it}")
        self._beta, self._b0 = theta[:-1].detach(), theta[-1].detach()
        with torch.no_grad():
            m = ysvm * (Z @ self._beta + self._b0)
            svs = int(((m < 1.0) & (w > 0)).sum())
        self._output.model_summary = {
            "svs_count": svs, "kernel": kernel, "C": C,
            "final_objective": prev, "iterations": len(self._objective),
            "linesearch_evaluations": opt.linesearch_steps}

    def _features(self, Xz):
        """The feature map, built in place (one (n, D) tensor)."""
        Xz = torch.where(torch.isnan(Xz), 0.0, Xz)
        if self._rff is None:
            return Xz
        W, b = self._rff
        with torch.no_grad():
            Z = Xz @ W
            Z += b
            return Z.cos_().mul_(math.sqrt(2.0 / W.shape[1]))

    def _score_matrix(self, X):
        dec = self._features(X) @ self._beta + self._b0
        pp = torch.sigmoid(2.0 * dec)
        return torch.stack([1 - pp, pp], dim=1)

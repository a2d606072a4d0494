"""GLRM of the port (h2o3_tpu/models/glrm.py, hex/glrm/GLRM.java): a
low-rank X ≈ A·B by alternating masked ridge solves on the device.

With the quadratic loss each half-step is exact: every row's coefficients
A_r = (B·diag(m_r)·Bᵀ + γ_x·I)⁻¹·B·(m_r·x_r), then every column's
archetype B_i = (Aᵀ·diag(m_i)·A + γ_y·I)⁻¹·Aᵀ·(m_i·x_i), with m the
observed-entry mask (an NA adds no loss; no imputation). Both add 1e-6
to γ, so every k×k system is regular (a row with nothing observed gets
1e-6·I and A_r = 0) and `torch.linalg.solve` never meets a singular one.
The per-row Grams G (n, k, k) are one product M·P with
P[i, (k, l)] = B[k, i]·B[l, i], and the per-column ones Mᵀ·(A⊗A), so no
(n, k, p) intermediate is formed. Iterations stop when the objective
moves by less than min_step_size of itself, and at 300 at most, as in the
JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from h2o3_tpu_torch.core.frame import Frame
from h2o3_tpu_torch.models.model import DataInfo, ModelBase, _matrix_frame

_JAX_FIT = "h2o3_tpu/models/glrm.py:_fit"
_MAX_ITERATIONS = 300


def step_A(Xz, M, B, gamma_x):
    """The rows' half-step: each row's masked ridge coefficients (n, k)
    against the archetypes B (k, p). Xz is 0 wherever M is."""
    k, p = B.shape
    P = (B[:, None, :] * B[None, :, :]).reshape(k * k, p).T
    G = (M @ P).view(-1, k, k) + (gamma_x + 1e-6) * torch.eye(
        k, device=B.device)
    return torch.linalg.solve(G, Xz @ B.T)


def step_B(Xz, M, A, gamma_y):
    """The archetypes' half-step: each column's masked ridge over A."""
    n, k = A.shape
    AA = (A[:, :, None] * A[:, None, :]).view(n, k * k)
    G = (M.T @ AA).view(-1, k, k) + (gamma_y + 1e-6) * torch.eye(
        k, device=A.device)
    return torch.linalg.solve(G, (A.T @ Xz).T).T


def objective(Xz, M, A, B, gamma_x, gamma_y):
    R = (Xz - A @ B) * M
    return (R * R).sum() + gamma_x * (A * A).sum() + gamma_y * (B * B).sum()


def _observed(X, w=None):
    """The observed-entry mask M (f32 0/1) and X with 0 elsewhere; a row
    of weight 0 observes nothing."""
    obs = ~torch.isnan(X)
    if w is not None:
        obs &= w[:, None] > 0
    return obs.to(torch.float32), torch.where(obs, X, 0.0)


class H2OGeneralizedLowRankEstimator(ModelBase):
    algo = "glrm"
    supervised = False
    _defaults = {
        "k": 1, "loss": "Quadratic", "regularization_x": "None",
        "regularization_y": "None", "gamma_x": 0.0, "gamma_y": 0.0,
        "max_iterations": 1000, "init": "PlusPlus", "transform": "NONE",
        "recover_svd": False, "min_step_size": 1e-4,
    }
    _IGNORED_IN_JAX = ModelBase._IGNORED_IN_JAX + tuple(
        (name, default, f"the JAX package accepts it and never reads it "
                        f"({_JAX_FIT}: quadratic loss, L2 ridges, a "
                        f"N(0, 0.1²) start, the raw design)")
        for name, default in (
            ("loss", "Quadratic"), ("regularization_x", "None"),
            ("regularization_y", "None"), ("init", "PlusPlus"),
            ("transform", "NONE"), ("recover_svd", False)))

    def _make_data_info(self, frame, x, y):
        # GLRM trains on the observed entries only: no standardisation
        # and no imputation in the design
        return DataInfo.from_frame(
            frame, x, y, weights=self.params.get("weights_column"),
            cat_mode="onehot", standardize=False, impute_missing=False)

    def _fit(self, frame: Frame):
        di = self._dinfo
        X = di.matrix(frame)
        w = di.weights(frame)
        k = int(self.params["k"])
        max_it = min(int(self.params["max_iterations"]), _MAX_ITERATIONS)
        gx = float(self.params.get("gamma_x") or 0.0)
        gy = float(self.params.get("gamma_y") or 0.0)
        seed = int(self.params.get("seed") or -1)
        rng = np.random.default_rng(seed if seed > 0 else 7)
        M, Xz = _observed(X, w)
        del X
        p = Xz.shape[1]
        B = torch.as_tensor(rng.normal(0, 0.1, (k, p)), dtype=torch.float32,
                            device=Xz.device)
        tol = float(self.params["min_step_size"])
        prev = np.inf
        history = []
        for it in range(max_it):
            A = step_A(Xz, M, B, gx)
            B = step_B(Xz, M, A, gy)
            obj = float(objective(Xz, M, A, B, gx, gy))
            history.append({"iteration": it, "objective": obj})
            if self._job is not None:
                self._job.update(0.1 + 0.8 * (it + 1) / max_it, f"iter {it}")
            if abs(prev - obj) < tol * max(1.0, abs(prev)):
                break
            prev = obj
        self._A = A
        self._B = B.cpu().numpy()
        self._objective = obj
        self._output.scoring_history = history
        self._output.model_summary = {"k": k, "objective": obj,
                                      "iterations": it + 1}

    def _score_matrix(self, X):
        # project new rows onto the archetypes (exact masked ridge per row)
        M, Xz = _observed(X)
        return step_A(Xz, M, torch.as_tensor(self._B, device=X.device),
                      float(self.params.get("gamma_x") or 0.0))

    def predict(self, test_data: Frame) -> Frame:
        A = self._score_matrix(self._dinfo.matrix(test_data))
        return _matrix_frame([f"Arch{j+1}" for j in range(A.shape[1])], A)

    def reconstruct(self, test_data: Frame) -> Frame:
        """Impute/reconstruct: Â·B in the original column space."""
        A = self._score_matrix(self._dinfo.matrix(test_data))
        R = A @ torch.as_tensor(self._B, device=A.device)
        return _matrix_frame(
            [f"reconstr_{c}" for c in self._dinfo.feature_names], R)

    def archetypes(self) -> np.ndarray:
        return self._B

"""PCA of the port (h2o3_tpu/models/pca.py, hex/pca/PCA.java): the
weighted Gram of the transformed design on the device, its
eigendecomposition on the host.

The Gram XᵀWX is one f32 matrix product over the rows (TF32 stays off,
or every product of X would lose 13 mantissa bits); the (p, p) Gram goes
to the host, where numpy's float64 `eigh` gives the rotation and the
variances, and the sign rule makes each component's largest loading
positive. `pca_method` Power and Randomized collapse onto this exact
GramSVD path, as in the JAX package (a p×p eigh is cheaper than
iterating); its GLRM method is the GLRM estimator.
"""

from __future__ import annotations

import numpy as np
import torch

from h2o3_tpu_torch.core.frame import Frame
from h2o3_tpu_torch.models.model import DataInfo, ModelBase, _matrix_frame

def _gram(Xz, w):
    """The weighted Gram XᵀWX, one f32 product."""
    return Xz.T @ (Xz * w[:, None])


def _moments(Xz, w, wsum, mean_den):
    """The weighted column means (over `mean_den`) and sample sigmas as
    the JAX package computes them: f32 sums on the device, finished in
    numpy f32 on the host."""
    mean = (w[:, None] * Xz).sum(dim=0).cpu().numpy() / mean_den
    var = (w[:, None] * (Xz - torch.as_tensor(mean, device=Xz.device)) ** 2
           ).sum(dim=0).cpu().numpy() / max(wsum - 1, 1)
    return mean, np.sqrt(np.maximum(var, 1e-30))


def _transform(Xz, transform, mean, sd):
    """NONE | STANDARDIZE | NORMALIZE | DEMEAN | DESCALE. NORMALIZE
    divides by sd without centring, as the JAX package does."""
    if transform in ("DEMEAN", "STANDARDIZE"):
        Xz = Xz - torch.as_tensor(mean, dtype=torch.float32,
                                  device=Xz.device)
    if transform in ("DESCALE", "STANDARDIZE", "NORMALIZE"):
        Xz = Xz / torch.as_tensor(sd, dtype=torch.float32, device=Xz.device)
    return Xz


def _top_eigen(Gn, k):
    """The k largest eigenpairs of a float64 symmetric matrix, in
    descending order, eigenvalues clipped at 0."""
    evals, evecs = np.linalg.eigh(Gn)
    order = np.argsort(-evals)
    return np.clip(evals[order][:k], 0, None), evecs[:, order][:, :k]


class H2OPrincipalComponentAnalysisEstimator(ModelBase):
    algo = "pca"
    _serving_param_attrs = ("_rotation", "_mean", "_sd")
    supervised = False
    _defaults = {
        "k": 1, "transform": "NONE", "pca_method": "GramSVD",
        "use_all_factor_levels": False, "compute_metrics": True,
        "impute_missing": True, "max_iterations": 1000,
    }
    _IGNORED_IN_JAX = ModelBase._IGNORED_IN_JAX + (
        ("use_all_factor_levels", False,
         "the JAX package's one-hot design keeps every level whatever it "
         "says (h2o3_tpu/models/pca.py:_make_data_info)"),
        ("impute_missing", True,
         "the JAX package always imputes the column mean "
         "(h2o3_tpu/models/pca.py:_make_data_info)"))

    def _make_data_info(self, frame, x, y):
        # PCA owns its `transform`: the design stays raw (mean-imputed)
        return DataInfo.from_frame(
            frame, x, y, weights=self.params.get("weights_column"),
            cat_mode="onehot", standardize=False, impute_missing=True)

    def _fit(self, frame: Frame):
        di = self._dinfo
        transform = (self.params.get("transform") or "NONE").upper()
        X = di.matrix(frame)
        w = di.weights(frame)
        k = int(self.params["k"])
        Xz = torch.where(torch.isnan(X), 0.0, X)
        del X
        wsum = float(w.sum())
        mean, sd = _moments(Xz, w, wsum, wsum)
        Xz = _transform(Xz, transform, mean, sd) * (w[:, None] > 0)
        Gn = _gram(Xz, w).cpu().double().numpy() / max(wsum - 1, 1.0)
        evals, evecs = _top_eigen(Gn, k)
        # sign convention: largest-magnitude loading positive
        for j in range(evecs.shape[1]):
            i = np.argmax(np.abs(evecs[:, j]))
            if evecs[i, j] < 0:
                evecs[:, j] = -evecs[:, j]
        self._mean, self._sd = mean, sd
        self._transform = transform
        self._rotation = evecs
        tot_var = float(np.trace(Gn))
        sdev = np.sqrt(evals)
        self._output.model_summary = {
            "k": k,
            "std_deviation": sdev.tolist(),
            "proportion_of_variance":
                (evals / tot_var).tolist() if tot_var else [],
            "cumulative_proportion":
                np.cumsum(evals / tot_var).tolist() if tot_var else [],
        }
        self._output.variable_importances = [
            {"pc": f"PC{j+1}", "std_dev": float(sdev[j])} for j in range(k)]

    def _apply_transform(self, X):
        return _transform(torch.where(torch.isnan(X), 0.0, X),
                          self._transform, self._mean, self._sd)

    def _score_matrix(self, X):
        R = torch.as_tensor(self._rotation, dtype=torch.float32,
                            device=X.device)
        return self._apply_transform(X) @ R

    def predict(self, test_data: Frame) -> Frame:
        S = self._score_matrix(self._dinfo.matrix(test_data))
        return _matrix_frame([f"PC{j+1}" for j in range(S.shape[1])], S)

    def rotation(self) -> np.ndarray:
        return self._rotation

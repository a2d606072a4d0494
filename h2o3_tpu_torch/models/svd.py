"""SVD of the port (h2o3_tpu/models/svd.py, hex/svd/SVD.java): the Gram
XᵀX of the transformed design on the device, its eigendecomposition on
the host, and U = X·V·d⁻¹ by one more product on the device.

V and d come from numpy's float64 `eigh` of the f32 Gram (TF32 stays
off); `svd_method` Power and Randomized collapse onto this exact GramSVD
path, as in the JAX package. With `keep_u` the left singular vectors stay
on the device as a frame (`u()`). As in the JAX package, the Gram takes
no weights: `weights_column` only leaves its column out of the design.
"""

from __future__ import annotations

import numpy as np
import torch

from h2o3_tpu_torch.core.frame import Frame
from h2o3_tpu_torch.core.kvstore import DKV
from h2o3_tpu_torch.models.model import DataInfo, ModelBase, _matrix_frame
from h2o3_tpu_torch.models.pca import _moments, _top_eigen, _transform


def _gram_xtx(X):
    """The Gram XᵀX, one f32 product."""
    return X.T @ X


class H2OSingularValueDecompositionEstimator(ModelBase):
    algo = "svd"
    _serving_param_attrs = ("_v", "_mean", "_sd")
    supervised = False
    _defaults = {
        "nv": 1, "transform": "NONE", "svd_method": "GramSVD",
        "max_iterations": 1000, "keep_u": True,
    }

    def _make_data_info(self, frame, x, y):
        return DataInfo.from_frame(frame, x, y, cat_mode="onehot",
                                   standardize=False, impute_missing=True)

    def _fit(self, frame: Frame):
        di = self._dinfo
        X = di.matrix(frame)
        w = di.weights(frame)
        k = int(self.params["nv"])
        transform = (self.params.get("transform") or "NONE").upper()
        live = w[:, None] > 0
        Xz = torch.where(torch.isnan(X), 0.0, X) * live
        del X
        wsum = float(w.sum())
        mean, sd = _moments(Xz, w, wsum, max(wsum, 1e-30))
        if transform in ("DEMEAN", "STANDARDIZE"):
            Xz = Xz - torch.as_tensor(mean, device=Xz.device) * live
        Xz = _transform(Xz, "DESCALE" if transform in (
            "DESCALE", "STANDARDIZE", "NORMALIZE") else "NONE", mean, sd)
        Gn = _gram_xtx(Xz).cpu().double().numpy()
        evals, V = _top_eigen(Gn, k)
        d = np.sqrt(evals)
        self._v, self._d = V, d
        self._transform = transform
        self._mean, self._sd = mean, sd
        if self.params.get("keep_u"):
            dinv = np.where(d > 1e-12, 1.0 / np.maximum(d, 1e-12), 0.0)
            U = Xz @ torch.as_tensor(V * dinv[None, :], dtype=torch.float32,
                                     device=Xz.device)
            self._u_key = _matrix_frame([f"u{j+1}" for j in range(k)],
                                        U).key
        self._output.model_summary = {
            "nv": k, "d": d.tolist(), "method": "GramSVD",
        }

    def _score_matrix(self, X):
        Xz = _transform(torch.where(torch.isnan(X), 0.0, X), self._transform,
                        self._mean, self._sd)
        return Xz @ torch.as_tensor(self._v, dtype=torch.float32,
                                    device=X.device)

    def predict(self, test_data: Frame) -> Frame:
        S = self._score_matrix(self._dinfo.matrix(test_data))
        return _matrix_frame([f"svd{j+1}" for j in range(S.shape[1])], S)

    def d(self):
        return self._d

    def v(self):
        return self._v

    def u(self) -> Frame:
        return DKV.get(self._u_key)

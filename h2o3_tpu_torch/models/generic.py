"""Generic model of the port (h2o3_tpu/models/generic.py, hex/generic/):
a MOJO imported as a model that the store holds and `predict` scores.

It takes both artifact families: the native npz zips of genmodel/mojo.py
and genuine H2O-3 MOJO zips (model.ini and trees/*.bin) through
genmodel/h2o_mojo.py.

`predict` builds the model-space matrix a column at a time from the
frame's planes, where the JAX package builds a dict a row and hands the
rows to `MojoModel.predict` (a Python loop that cannot score millions of
rows). A native MOJO's matrix is the one `MojoModel._row_to_matrix`
builds from those rows (`MojoModel.columns_to_matrix`) and is scored by
its numpy scorer; an H2O-3 tree MOJO's matrix is built on the frame's
device and scored there by the engine's batch walk, its prediction
columns left on the device. The prediction frames are the JAX package's:
a native classifier's `predict` is its label column, an H2O-3 MOJO's
`predict` the class index as a number.
"""

from __future__ import annotations

import zipfile

import numpy as np
import torch

from h2o3_tpu_torch.core.frame import Frame, StrVec, T_CAT, Vec
from h2o3_tpu_torch.core.kvstore import DKV
from h2o3_tpu_torch.genmodel.mojo import MojoModel


def _is_reference_mojo(path: str) -> bool:
    try:
        with zipfile.ZipFile(path) as z:
            return "model.ini" in z.namelist()
    except (OSError, zipfile.BadZipFile):
        return False


class H2OGenericEstimator:
    algo = "generic"

    def __init__(self, path: str = None, model_key: str = None):
        self.params = {"path": path}
        self.key = model_key or DKV.make_key("generic")
        self._scorer: MojoModel | None = None
        self._ref = None                 # an H2O-3 MOJO's H2OMojoModel
        if path:
            self._load(path)
            DKV.put(self.key, self)

    def _load(self, path: str):
        if _is_reference_mojo(path):
            from h2o3_tpu_torch.genmodel.h2o_mojo import import_h2o_mojo
            self._ref = import_h2o_mojo(path)
            self._scorer = None
        else:
            self._scorer = MojoModel.load(path)
            self._ref = None

    def train(self, training_frame=None, **kw):
        self._load(kw.get("path") or self.params.get("path"))
        DKV.put(self.key, self)
        return self

    @property
    def model_id(self):
        return self.key

    @property
    def original_algo(self):
        if self._ref is not None:
            return self._ref.algo
        return self._scorer.algo if self._scorer else None

    def predict(self, test_data: Frame) -> Frame:
        if self._ref is not None:
            return self._predict_reference(test_data)
        sc = self._scorer
        X = sc.columns_to_matrix(self._host_columns(test_data),
                                 test_data.nrows)
        out = sc.predict_matrix(X)
        cols = {}
        if "probs" in out:
            cols["predict"] = out["predict"]
            for k, lvl in enumerate(out["domain"]):
                cols[f"p{lvl}"] = out["probs"][:, k]
        elif "cluster" in out:
            cols["predict"] = out["cluster"].astype(np.float64)
        else:
            cols.update(out)
        return Frame.from_dict(cols)

    def _host_columns(self, frame: Frame) -> dict:
        """Each predictor the frame holds as (float64 values with NaN for
        NA, domain): a categorical's level codes and its levels, a string
        column's codes and distinct strings, a number's value (a
        categorical the model reads as a number: each level's float, as
        the row path's float() of the level takes it)."""
        m = self._scorer.meta
        have = set(frame.names)
        cols = {}
        for c in m["predictors"]:
            if c not in have:
                continue
            v = frame.vec(c)
            if isinstance(v, StrVec):
                codes = v.codes.cpu().numpy()[: v.nrows].astype(np.float64)
                codes[codes < 0] = np.nan
                vals, dom = codes, [str(s) for s in v.levels_arr]
            elif v.type == T_CAT:
                vals, dom = v.to_numpy(), list(v.domain)
            else:
                vals, dom = v.to_numpy(), None
            if dom is not None and c not in m["domains"]:
                lut = np.array([float(lvl) for lvl in dom] + [np.nan])
                ok = ~np.isnan(vals)
                vals = lut[np.where(ok, np.nan_to_num(vals), len(dom))
                           .astype(np.int64)]
                dom = None
            cols[c] = (vals, dom)
        return cols

    # ---- the H2O-3 MOJO path, on the frame's device ----------------------
    def _reference_matrix(self, test_data: Frame) -> torch.Tensor:
        """(n, n_features) f32 on the frame's device, NaN for NA, each
        categorical's codes remapped onto the MOJO's domain (an unseen
        level NaN)."""
        mm = self._ref
        n = test_data.nrows
        dev = mm.device
        X = torch.full((n, mm.n_features), float("nan"), dtype=torch.float32,
                       device=dev)
        for j, cname in enumerate(mm.columns[: mm.n_features]):
            if cname not in test_data.names:
                continue
            v = test_data.vec(cname)
            x = v.as_f32().to(dev)
            if v.type == T_CAT and j in mm.domains:
                remap = {lv: k for k, lv in enumerate(mm.domains[j])}
                lut = torch.tensor([remap.get(lv, np.nan) for lv in v.domain]
                                   + [np.nan], dtype=torch.float32,
                                   device=dev)
                na = torch.isnan(x)
                x = lut[torch.where(na, len(v.domain),
                                    torch.nan_to_num(x).long())]
            X[:, j] = x
        return X

    def _predict_reference(self, test_data: Frame) -> Frame:
        mm = self._ref
        out = mm.predict_tensor(self._reference_matrix(test_data))
        resp_dom = mm.domains.get(len(mm.columns) - 1)
        if out.dim() == 2 and resp_dom:
            names = ["predict"] + [f"p{lvl}"
                                   for lvl in resp_dom[: out.shape[1]]]
            vecs = [Vec.from_tensor(out.argmax(dim=1).to(torch.float32))]
            vecs += [Vec.from_tensor(out[:, k].contiguous())
                     for k in range(len(names) - 1)]
            return Frame(names, vecs)
        return Frame(["predict"], [Vec.from_tensor(
            out.reshape(test_data.nrows).to(torch.float32))])
